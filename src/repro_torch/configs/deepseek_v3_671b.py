"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8 experts
[arXiv:2412.19437; hf].  MTP head not implemented (DESIGN.md
§Arch-applicability).  Optimizer: adafactor."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,           # dense first layers hidden
    vocab=129280,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=256,
    experts_per_tok=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    attn_chunk=2048,
)
