"""Model configuration dataclass covering all assigned architecture families
(dense / MoE / MLA / SSM / hybrid / enc-dec / VLM backbones).

Port note: a copy of ``repro.models.config``.  ``repro_torch`` imports
nothing of ``repro`` (not even its jax-free modules), so it keeps its own
copy; ``tests/test_torch_serve.py`` holds every configuration equal to the
reference's.  Every family runs in the port."""


from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 → d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0              # per-expert hidden (d_ff used for dense ffn)
    first_dense_layers: int = 0    # leading dense layers before MoE layers
    capacity_factor: float = 1.25

    # --- MLA (DeepSeek) ------------------------------------------------------
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba) -----------------------------------------------------------
    ssm_version: int = 0           # 0 none, 1 mamba1, 2 mamba2/SSD
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_headdim: int = 64          # mamba2 head dim P
    dt_rank: int = 0               # mamba1; 0 → ceil(d_model/16)

    # --- hybrid (Zamba2) -----------------------------------------------------
    shared_attn_every: int = 0     # apply the shared attention block every k layers
    n_shared_blocks: int = 1       # distinct shared blocks cycled through

    # --- encoder-decoder (Whisper backbone) -----------------------------------
    enc_layers: int = 0
    enc_seq: int = 0               # encoder frames (stub frontend output length)

    # --- VLM backbone (InternVL) ---------------------------------------------
    n_vis_tokens: int = 0          # stub patch embeddings prepended to text

    # --- execution knobs -------------------------------------------------------
    attn_chunk: int = 0            # 0 → full attention; else online-softmax chunk
    remat: bool = True
    seq_shard_activations: bool = True
    scan_layers: bool = True       # False unrolls layer stacks (depth probes)

    # ------------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank or max(1, -(-self.d_model // 16))

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode state: SSM and hybrid families."""
        return self.family in ("ssm", "hybrid")

    @property
    def moe_layer_ids(self) -> Tuple[int, ...]:
        if self.family != "moe":
            return ()
        return tuple(range(self.first_dense_layers, self.n_layers))

    def reduced(self, **over) -> "ModelConfig":
        """Smoke-test scale: same family/topology, tiny dims."""
        base = dict(
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256,
            vocab=512,
            head_dim=32 if self.head_dim else 0,
            dtype="float32",
        )
        if self.family == "moe":
            base.update(n_experts=min(self.n_experts, 8),
                        experts_per_tok=min(self.experts_per_tok, 2),
                        moe_d_ff=64,
                        first_dense_layers=min(self.first_dense_layers, 1))
        if self.mla:
            base.update(q_lora_rank=48, kv_lora_rank=32, qk_rope_dim=16,
                        qk_nope_dim=32, v_head_dim=32, head_dim=0)
        if self.ssm_version:
            base.update(ssm_state=min(self.ssm_state, 16), ssm_headdim=32,
                        dt_rank=8)
        if self.shared_attn_every:
            base.update(shared_attn_every=2, n_layers=4)
        if self.enc_layers:
            base.update(enc_layers=2, enc_seq=32)
        if self.n_vis_tokens:
            base.update(n_vis_tokens=16)
        base.update(over)
        return dataclasses.replace(self, **base)

    # --- analytic parameter / flop model (for roofline §Roofline) -----------
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.mla:
            qk_hd = self.qk_nope_dim + self.qk_rope_dim
            per_attn = (d * self.q_lora_rank
                        + self.q_lora_rank * self.n_heads * qk_hd
                        + d * (self.kv_lora_rank + self.qk_rope_dim)
                        + self.kv_lora_rank * self.n_heads
                        * (self.qk_nope_dim + self.v_head_dim)
                        + self.n_heads * self.v_head_dim * d)
        per_dense_ffn = 3 * d * self.d_ff
        n = emb
        if self.family in ("dense", "vlm"):
            n += self.n_layers * (per_attn + per_dense_ffn)
        elif self.family == "moe":
            per_moe = (3 * d * self.moe_d_ff
                       * (self.n_experts + self.n_shared_experts)
                       + d * self.n_experts)
            n += self.first_dense_layers * (per_attn + per_dense_ffn)
            n += (self.n_layers - self.first_dense_layers) * (per_attn + per_moe)
        elif self.family == "ssm":
            di, N = self.d_inner, self.ssm_state
            per = (2 * d * di + di * self.d_conv
                   + di * (self.dtr + 2 * N) + self.dtr * di
                   + di * N + di + di * d)
            n += self.n_layers * per
        elif self.family == "hybrid":
            di, N = self.d_inner, self.ssm_state
            H, P = self.n_ssm_heads, self.ssm_headdim
            per = (d * (2 * di + 2 * N + H) + di * self.d_conv
                   + 2 * H + di * d)
            n += self.n_layers * per
            d2 = 2 * d
            shared = (4 * d2 * d2 + 3 * d2 * d2)  # attn + ffn on concat width
            n += self.n_shared_blocks * shared
            n_sites = self.n_layers // max(self.shared_attn_every, 1)
            n += n_sites * (d2 * d)               # per-site down-projection
        elif self.family == "encdec":
            n += self.enc_layers * (per_attn + per_dense_ffn)
            n += self.n_layers * (2 * per_attn + per_dense_ffn)  # self+cross
        return int(n)

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top-k + shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        per_moe_active = (3 * d * self.moe_d_ff
                          * (self.experts_per_tok + self.n_shared_experts)
                          + d * self.n_experts)
        per_moe_full = (3 * d * self.moe_d_ff
                        * (self.n_experts + self.n_shared_experts)
                        + d * self.n_experts)
        n_moe_layers = self.n_layers - self.first_dense_layers
        return int(self.param_count()
                   - n_moe_layers * (per_moe_full - per_moe_active))

    def model_flops(self, n_tokens: int, backward: bool = True) -> float:
        """6·N_active·D (2·N·D forward, 4·N·D backward)."""
        mult = 6.0 if backward else 2.0
        return mult * self.active_param_count() * n_tokens
