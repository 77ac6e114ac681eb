"""repro_torch.obs — task-level tracing and metrics.

The port's copy of ``repro.obs``'s ``trace`` and ``metrics``: the core,
the engine and the runner record their spans and counters through them.
``export`` (Perfetto JSON) is not ported yet (ROADMAP.md, Queue 1).
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .trace import (NullTracer, Tracer, disable, enable, get_tracer,
                    set_tracer, span)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "NullTracer", "Tracer", "disable", "enable", "get_tracer",
    "set_tracer", "span",
]
