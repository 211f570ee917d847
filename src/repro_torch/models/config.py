"""Model configuration — one dataclass covering every assigned family.

A copy of ``repro/models/config.py``: the port keeps its own, so it never
imports the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"   # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: Optional[int] = None          # default d_model // n_heads
    qk_norm: bool = False                   # qwen3
    qkv_bias: bool = False                  # qwen2
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0                      # routed experts (0 = dense FFN)
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                       # per-expert hidden
    first_dense_layers: int = 0             # deepseek: layer 0 stays dense
    capacity_factor: float = 1.25
    moe_expert_scan: bool = False           # edge mode: decode 1 expert at a time
    # shard_map local-routing MoE (§Perf DP3): each device routes its LOCAL
    # tokens to its LOCAL expert shard — replaces SPMD's dense global
    # dispatch (token gather + f32 combine all-reduce) with one bf16 psum
    # of the outputs over the model axis.  Capacity becomes per-shard.
    moe_local_dispatch: bool = False

    # --- MLA (deepseek-style latent attention) ------------------------------
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0                    # 0 = dense q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- SSM (mamba2/SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 256

    # --- hybrid (zamba2) -----------------------------------------------------
    attn_period: int = 0                    # shared attn block every N layers

    # --- enc-dec (seamless) ----------------------------------------------------
    encoder_layers: int = 0
    decoder_layers: int = 0

    # --- modality frontend stubs ----------------------------------------------
    frontend: Optional[str] = None          # 'audio' | 'vision'
    n_patches: int = 256                    # vision stub: patches per image

    # --- numerics / compression ----------------------------------------------
    remat: bool = True                      # activation checkpoint scan bodies
    logits_softcap: float = 0.0
    unroll_stack: bool = False              # Python-loop layers (probe compiles)
    # beyond-paper: the paper's int8 quantizer applied to the KV cache —
    # halves decode's dominant bandwidth/capacity term (per-token-per-head
    # absmax scales; see layers.init_kv_cache / _dequant_cache)
    kv_cache_bits: int = 16                 # 16 (bf16) | 8 (int8 + scales)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs only (DESIGN.md §Arch-applicability)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads

        def attn_params():
            if self.mla:
                q = (d * self.q_lora_rank + self.q_lora_rank * nq *
                     (self.qk_nope_head_dim + self.qk_rope_head_dim)) \
                    if self.q_lora_rank else \
                    d * nq * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                kv = d * (self.kv_lora_rank + self.qk_rope_head_dim)
                kv += self.kv_lora_rank * nq * (self.qk_nope_head_dim +
                                                self.v_head_dim)
                o = nq * self.v_head_dim * d
                return q + kv + o
            return d * hd * (nq + 2 * nkv) + nq * hd * d

        def ffn_params(hidden):
            return 3 * d * hidden  # SwiGLU

        def moe_params():
            routed = self.n_experts * ffn_params(self.moe_d_ff)
            shared = self.n_shared_experts * ffn_params(self.moe_d_ff)
            router = d * self.n_experts
            return routed + shared + router

        def mamba_params():
            di, n, g = self.d_inner, self.ssm_state, self.ssm_n_groups
            h = self.ssm_heads
            in_proj = d * (2 * di + 2 * g * n + h)
            conv = (di + 2 * g * n) * self.ssm_conv
            out = di * d
            return in_proj + conv + out + 2 * h + di  # A, dt_bias, D-ish

        # embeddings (+ untied head) + per-layer/final norms
        emb = v * d * (1 if self.tie_embeddings else 2)
        norms = d * (2 * self.n_layers + 1)
        if self.qk_norm:
            norms += 2 * hd * self.n_layers

        if self.family == "encdec":
            enc = self.encoder_layers * (attn_params() + ffn_params(ff))
            dec = self.decoder_layers * (2 * attn_params() + ffn_params(ff))
            return enc + dec + emb + norms
        if self.family == "ssm":
            return self.n_layers * mamba_params() + emb + norms
        if self.family == "hybrid":
            shared = attn_params() + ffn_params(ff)  # one shared block
            return self.n_layers * mamba_params() + shared + emb + norms
        if self.is_moe:
            moe_layers = self.n_layers - self.first_dense_layers
            per = moe_params()
            dense = ffn_params(ff if ff else self.moe_d_ff)
            total = (moe_layers * (attn_params() + per) +
                     self.first_dense_layers * (attn_params() + dense))
            return total + emb + norms
        return self.n_layers * (attn_params() + ffn_params(ff)) + emb + norms

    def n_active_params(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        act_ffn = (self.top_k + self.n_shared_experts) * 3 * d * self.moe_d_ff
        full_ffn = (self.n_experts + self.n_shared_experts) * 3 * d * self.moe_d_ff
        per_layer_delta = full_ffn - act_ffn
        moe_layers = self.n_layers - self.first_dense_layers
        return self.n_params() - moe_layers * per_layer_delta
