"""The paper's own models: Llama-3.2-1B and -3B (Tiny-QMoE Tables 1-4).

[arXiv:2407.21783 (Llama 3 herd) + meta-llama/Llama-3.2 cards; hf]
1B: 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256, tied.
3B: 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256, tied.
These anchor the paper-fidelity benchmarks (compression ratio table).
"""
from repro_torch.models.config import ModelConfig
from .base import ArchEntry, register

FULL_1B = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab_size=128256, head_dim=64, rope_theta=500_000.0,
    tie_embeddings=True,
)

FULL_3B = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab_size=128256, head_dim=128, rope_theta=500_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=211, head_dim=16, tie_embeddings=True, remat=False,
)

ENTRY_1B = register(ArchEntry(
    arch_id="llama3.2-1b", full=FULL_1B, smoke=SMOKE,
    source="meta-llama/Llama-3.2-1B; hf",
    notes="paper's primary subject (Tables 1-4).",
))
ENTRY_3B = register(ArchEntry(
    arch_id="llama3.2-3b", full=FULL_3B, smoke=SMOKE,
    source="meta-llama/Llama-3.2-3B; hf",
    notes="paper's secondary subject (Tables 1-4).",
))
