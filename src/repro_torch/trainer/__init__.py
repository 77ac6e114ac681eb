"""Training of the port: the step builders (``steps``) and the
restartable loop (``loop``).  The port of ``repro.trainer``."""

from .steps import make_prefill_step, make_serve_step, make_train_step

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step"]
