"""kimi-k2-1t-a32b — trillion-param MoE (paper-table config).

[arXiv:2501.kimi2; unverified] 61L d_model=7168 64H (GQA kv=8)
d_ff(expert)=2048 vocab=163840, MoE 384 routed top-8 (+1 shared),
first layer dense (d_ff 18432), head_dim 128.  NOTE: the real K2 uses
MLA; the assigned table pins GQA kv=8, so we follow the assignment
(DESIGN.md records the deviation).

A copy of ``repro/configs/kimi_k2_1t_a32b.py``.
"""
from repro_torch.models.config import ModelConfig
from .base import ArchEntry, register

FULL = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=18432, vocab_size=163840, head_dim=128,
    n_experts=384, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=1, capacity_factor=1.25,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab_size=211, head_dim=16, n_experts=8, n_shared_experts=1,
    top_k=2, moe_d_ff=48, first_dense_layers=1, remat=False,
)

ENTRY = register(ArchEntry(
    arch_id="kimi-k2-1t-a32b", full=FULL, smoke=SMOKE,
    source="arXiv:2501.kimi2; unverified",
    notes="1T total / ~32B active; EP shards experts on the model axis; "
          "long_500k skipped (quadratic).",
))
