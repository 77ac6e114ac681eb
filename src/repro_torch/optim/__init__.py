"""Optimizers of the port: AdamW and Adafactor in place over trees of
tensors (``optimizers``), and the pytree walk they share with the
checkpoints and the train step (``tree``).  The port of ``repro.optim``."""

from .optimizers import (OptState, adafactor_init, adafactor_update,
                         adamw_init, adamw_update, clip_by_global_norm,
                         cosine_schedule, default_optimizer_for, global_norm,
                         make_optimizer)

__all__ = ["OptState", "adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "clip_by_global_norm", "make_optimizer",
           "cosine_schedule", "default_optimizer_for", "global_norm"]
