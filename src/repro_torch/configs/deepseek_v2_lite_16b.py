"""deepseek-v2-lite-16b — MLA + fine-grained MoE.

[arXiv:2405.04434; hf] 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, MLA kv_lora=512
(q_lora none in Lite), qk_nope 128 / qk_rope 64 / v 128; first layer
dense FFN (10944).  The assignment bracket's "160 routed" refers to the
non-Lite V2; Lite's checkpoint has 64 routed experts — we follow the
model card + the assignment's "MoE 64e top-6".

A copy of ``repro/configs/deepseek_v2_lite_16b.py``.
"""
from repro_torch.models.config import ModelConfig
from .base import ArchEntry, register

FULL = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1,
    mla=True, kv_lora_rank=512, q_lora_rank=0,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192,
    vocab_size=211, n_experts=8, n_shared_experts=2, top_k=2,
    moe_d_ff=48, first_dense_layers=1,
    mla=True, kv_lora_rank=32, q_lora_rank=0,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, remat=False,
)

ENTRY = register(ArchEntry(
    arch_id="deepseek-v2-lite-16b", full=FULL, smoke=SMOKE,
    source="arXiv:2405.04434; hf",
    notes="closest to original QMoE setting: expert FFNs dominate bytes "
          "and are cold per token; long_500k skipped (quadratic).",
))
