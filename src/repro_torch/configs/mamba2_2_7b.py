"""mamba2-2.7b — attention-free SSD (state-space duality) LM.

[arXiv:2405.21060; unverified] 64L d_model=2560 d_ff=0 vocab=50280,
ssm_state=128.  head_dim 64, expand 2 → d_inner 5120, 80 heads, 1 group.
Sub-quadratic: runs long_500k.

A copy of ``repro/configs/mamba2_2_7b.py``.
"""
from repro_torch.models.config import ModelConfig
from .base import ArchEntry, register

FULL = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_n_groups=1, ssm_conv=4, ssm_chunk=256, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=3, d_model=64, d_ff=0, vocab_size=211,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    tie_embeddings=True, remat=False,
)

ENTRY = register(ArchEntry(
    arch_id="mamba2-2.7b", full=FULL, smoke=SMOKE,
    source="arXiv:2405.21060; unverified",
    notes="SSD recurrence params excluded from quant+compress "
          "(DESIGN.md §Arch-applicability); in/out projections compress.",
))
