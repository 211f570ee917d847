"""qwen3-4b — dense GQA with qk_norm.

[hf:Qwen/Qwen3-8B; hf] 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, head_dim=128, qk_norm.

A copy of ``repro/configs/qwen3_4b.py``.
"""
from repro_torch.models.config import ModelConfig
from .base import ArchEntry, register

FULL = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
    vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=211, head_dim=16, qk_norm=True, remat=False,
)

ENTRY = register(ArchEntry(
    arch_id="qwen3-4b", full=FULL, smoke=SMOKE,
    source="hf:Qwen/Qwen3-8B; hf",
    notes="long_500k skipped (full quadratic attention).",
))
