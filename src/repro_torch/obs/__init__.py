"""repro_torch.obs — task-level tracing, metrics, Perfetto export.

The port's copy of ``repro.obs``: the core, the engine, the runner and
the serving tier record their spans and counters through ``trace`` and
``metrics``; ``export`` renders both as Chrome trace-event JSON.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .trace import (NullTracer, Tracer, disable, enable, get_tracer,
                    set_tracer, span)

_EXPORT_NAMES = ("to_chrome_trace", "validate_chrome_trace",
                 "write_chrome_trace")


def __getattr__(name):
    # lazy so `python -m repro_torch.obs.export` doesn't import the
    # submodule twice (runpy warns when a package __init__ pre-imports it)
    if name in _EXPORT_NAMES:
        from . import export
        return getattr(export, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "NullTracer", "Tracer", "disable", "enable", "get_tracer",
    "set_tracer", "span",
    "to_chrome_trace", "validate_chrome_trace", "write_chrome_trace",
]
