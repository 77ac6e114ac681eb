"""Model stack of the port: the dense GQA family (``config``, ``layers``,
``lm``, ``serving``) and ``convert``, which takes the reference's
parameters into the port's tensors.  MoE, MLA, SSM, hybrid, enc-dec and
VLM come with later slices."""
