"""seamless-m4t-medium — enc-dec multimodal (audio) backbone.

[arXiv:2308.11596; hf] 12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206.  "12L" is read as 12 encoder + 12 decoder layers (the
HF checkpoint's speech-enc/text-dec depths); the audio frontend is a
stand-in: precomputed frame embeddings (B, S, d) go straight to the
encoder (``models.frontends.audio_frame_embeddings``).

A copy of ``repro/configs/seamless_m4t_medium.py``.
"""
from repro_torch.models.config import ModelConfig
from .base import ArchEntry, register

FULL = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=24, encoder_layers=12, decoder_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=256206, head_dim=64, rope_theta=10_000.0,
    frontend="audio",
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke", family="encdec",
    n_layers=4, encoder_layers=2, decoder_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=211, head_dim=16, frontend="audio", remat=False,
)

ENTRY = register(ArchEntry(
    arch_id="seamless-m4t-medium", full=FULL, smoke=SMOKE,
    source="arXiv:2308.11596; hf",
    notes="enc-dec; decode shapes exercise the text decoder with cached "
          "encoder K/V; long_500k skipped (quadratic cross+self attn).",
))
