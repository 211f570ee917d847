"""llama3-405b — the capacity showcase for Tiny-QMoE serving.

[arXiv:2407.21783; unverified] 126L d_model=16384 128H (GQA kv=8)
d_ff=53248 vocab=128256, head_dim=128, rope 5e5.

A copy of ``repro/configs/llama3_405b.py``.
"""
from repro_torch.models.config import ModelConfig
from .base import ArchEntry, register

FULL = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab_size=128256, head_dim=128, rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke", family="dense",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, d_ff=320,
    vocab_size=211, head_dim=16, remat=False,
)

ENTRY = register(ArchEntry(
    arch_id="llama3-405b", full=FULL, smoke=SMOKE,
    source="arXiv:2407.21783; unverified",
    notes="int8+dict compression is what fits 405B on serving meshes; "
          "long_500k skipped (quadratic).",
))
