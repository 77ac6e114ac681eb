"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2; unverified].  Optimizer: adafactor (EXPERIMENTS §Dry-run
memory note)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=16384,           # dense first layer hidden
    vocab=163840,
    head_dim=128,
    n_experts=384,
    experts_per_tok=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=1,
    attn_chunk=2048,
)
