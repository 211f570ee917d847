"""internvl2-2b — InternViT frontend (STUB) + InternLM2-1.8B backbone.

[arXiv:2404.16821; hf] 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553.  Vision frontend provides precomputed patch embeddings
(256 tokens/image) per the assignment.

A copy of ``repro/configs/internvl2_2b.py``.
"""
from repro_torch.models.config import ModelConfig
from .base import ArchEntry, register

FULL = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92553, head_dim=128, rope_theta=1_000_000.0,
    frontend="vision", n_patches=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=211, head_dim=16, frontend="vision", n_patches=8,
    remat=False,
)

ENTRY = register(ArchEntry(
    arch_id="internvl2-2b", full=FULL, smoke=SMOKE,
    source="arXiv:2404.16821; hf",
    notes="text+image prefill; decode is text-only; long_500k skipped "
          "(quadratic).",
))
