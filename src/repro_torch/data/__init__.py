"""The port's data pipeline: ``SyntheticTokens``, a copy of the
reference's (``repro.data``), array for array, and ``batch_specs``, the
dry run's ``meta`` stand-ins for a step's inputs."""

from .pipeline import SyntheticTokens, batch_specs

__all__ = ["SyntheticTokens", "batch_specs"]
