"""internvl2-76b — InternLM2 backbone; InternViT frontend is a stub:
input_specs() provides projected patch embeddings
[arXiv:2404.16821; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    n_vis_tokens=256,
    attn_chunk=2048,
)
