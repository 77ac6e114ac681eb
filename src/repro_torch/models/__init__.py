"""Model stack of the port, every family of the reference: dense, MoE
with GQA or MLA attention, SSM (Mamba1), hybrid (Mamba2 trunk with shared
attention), enc-dec (Whisper backbone) and VLM (InternVL backbone)
(``config``, ``layers``, ``mla``, ``moe``, ``ssm``, ``lm``, ``serving``),
and ``convert``, which takes the reference's parameters into the port's
tensors."""
