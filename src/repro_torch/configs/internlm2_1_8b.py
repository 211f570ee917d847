"""internlm2-1.8b — dense GQA.

[arXiv:2403.17297; hf] 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544, head_dim=128.

A copy of ``repro/configs/internlm2_1_8b.py``.
"""
from repro_torch.models.config import ModelConfig
from .base import ArchEntry, register

FULL = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92544, head_dim=128, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="internlm2-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=211, head_dim=16, remat=False,
)

ENTRY = register(ArchEntry(
    arch_id="internlm2-1.8b", full=FULL, smoke=SMOKE,
    source="arXiv:2403.17297; hf",
    notes="long_500k skipped (quadratic).",
))
