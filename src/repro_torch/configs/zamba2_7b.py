"""zamba2-7b — hybrid Mamba2 trunk + shared attention blocks
[arXiv:2411.15242; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_version=2,
    ssm_state=64,
    ssm_headdim=64,
    expand=2,
    d_conv=4,
    shared_attn_every=6,
    n_shared_blocks=2,
    attn_chunk=2048,
)
