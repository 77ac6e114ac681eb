"""The pipeline F/B/U walk (K9): plain row functions (``ref``) and the CUDA
walk's binding (``kernel``).  The round function that drives it over a
lowered plan is ``repro_torch.engine.megakernel.pipe_round_fn``."""
