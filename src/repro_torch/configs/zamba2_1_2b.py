"""zamba2-1.2b — Mamba2 backbone + shared attention block.

[arXiv:2411.15242; hf] 38L d_model=2048 32H (GQA kv=32 → MHA) d_ff=8192
vocab=32000, ssm_state=64.  One shared attn+MLP block applied every 6
mamba blocks (weights shared, separate KV cache per application).
Sub-quadratic backbone: runs long_500k (attn blocks decode O(L) per step).

A copy of ``repro/configs/zamba2_1_2b.py``.
"""
from repro_torch.models.config import ModelConfig
from .base import ArchEntry, register

FULL = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, head_dim=64, ssm_state=64, ssm_head_dim=64,
    ssm_expand=2, ssm_n_groups=1, ssm_chunk=256, attn_period=6,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=211, head_dim=16, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=8, attn_period=2, remat=False,
)

ENTRY = register(ArchEntry(
    arch_id="zamba2-1.2b", full=FULL, smoke=SMOKE,
    source="arXiv:2411.15242; hf",
    notes="SSD params dense; shared attn block weights compress once, "
          "used 6x.",
))
