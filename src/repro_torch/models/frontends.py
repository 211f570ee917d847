"""Modality frontend stand-ins (counterpart of ``repro/models/frontends.py``).

The assigned audio and VLM entries specify the transformer backbone only:
the frontend's output is what the backbone takes — precomputed audio frame
embeddings (``encdec.forward``'s ``enc_embeds``) and precomputed patch
embeddings (``lm.forward``'s and ``generate``'s ``embeds``).  These
helpers draw correctly shaped stand-ins for tests and ``chip_smoke.py``
from an explicit ``torch.Generator``, where the reference draws from a key.
"""
from __future__ import annotations

import torch


def audio_frame_embeddings(gen: torch.Generator, batch: int, n_frames: int,
                           d_model: int, dtype=torch.float32) -> torch.Tensor:
    """Stand-in for a conformer/w2v-BERT audio encoder frontend output:
    (B, S, d) normals × 0.02 on the generator's device.

    Real system: 16 kHz waveform → fbank → conv subsampling → (B, S, d)."""
    return torch.randn((batch, n_frames, d_model), generator=gen,
                       device=gen.device, dtype=dtype) * 0.02


def vision_patch_embeddings(gen: torch.Generator, batch: int, n_patches: int,
                            d_model: int, dtype=torch.float32) -> torch.Tensor:
    """Stand-in for an InternViT patch embedding + projector output: (B, P,
    d) normals × 0.02 on the generator's device.

    Real system: 448×448 image → ViT → pixel-shuffle → MLP projector →
    (B, P, d) tokens prepended to the text sequence."""
    return torch.randn((batch, n_patches, d_model), generator=gen,
                       device=gen.device, dtype=dtype) * 0.02
