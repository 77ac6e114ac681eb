"""whisper-tiny — enc-dec backbone; conv frontend is a stub: input_specs()
provides precomputed frame embeddings [arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    enc_layers=4,
    enc_seq=1500,
    attn_chunk=2048,
)
