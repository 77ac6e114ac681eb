"""Model stack of the port: the dense and MoE families with GQA or MLA
attention (``config``, ``layers``, ``mla``, ``moe``, ``lm``, ``serving``)
and ``convert``, which takes the reference's parameters into the port's
tensors.  SSM, hybrid, enc-dec and VLM come with later slices."""
