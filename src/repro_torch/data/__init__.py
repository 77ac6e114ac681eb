"""The port's data pipeline: ``SyntheticTokens``, a copy of the
reference's (``repro.data``), array for array.  ``batch_specs`` (shape
stand-ins for the dry run) comes with the dry run (ROADMAP Queue 1)."""

from .pipeline import SyntheticTokens

__all__ = ["SyntheticTokens"]
