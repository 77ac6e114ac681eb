"""Model stack of the port: the dense and MoE families with GQA or MLA
attention and the SSM family (``config``, ``layers``, ``mla``, ``moe``,
``ssm``, ``lm``, ``serving``) and ``convert``, which takes the reference's
parameters into the port's tensors.  Hybrid, enc-dec and VLM come with
later slices."""
