"""qwen2-7b — dense GQA with QKV bias.

[arXiv:2407.10671; hf] 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, head_dim=128, qkv_bias.

A copy of ``repro/configs/qwen2_7b.py``.
"""
from repro_torch.models.config import ModelConfig
from .base import ArchEntry, register

FULL = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab_size=152064, head_dim=128, qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=176,
    vocab_size=211, head_dim=16, qkv_bias=True, remat=False,
)

ENTRY = register(ArchEntry(
    arch_id="qwen2-7b", full=FULL, smoke=SMOKE,
    source="arXiv:2407.10671; hf",
    notes="long_500k skipped (quadratic).",
))
