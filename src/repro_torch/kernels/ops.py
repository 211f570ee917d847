"""Public kernel entry points of the port — what the model layers call.

Counterpart of ``repro/kernels/ops.py`` (single device).  Dispatch follows
the tensors' device: a CUDA tensor launches the hand-written kernel (or the
wrapper raises), a CPU tensor takes the kernel's plain PyTorch version.
There is no lever that sends CUDA tensors to a plain version.

``DISPATCH_COUNTS`` counts which path each compressed matmul took (the
reference's probe); ``_build.LAUNCH_COUNTS`` counts kernel launches.
"""
from __future__ import annotations

import collections

import torch

from .dequant_matmul import dequant_matmul as _dequant_matmul
from .flash_attention import flash_attention as _flash_attention
from .fused_decode_matmul import fused_decode_matmul as _fused

DISPATCH_COUNTS = collections.Counter()


def dequant_matmul(x, wq, scale, zero, *, out_dtype=torch.float32):
    """y = x @ dequant(wq).T.  x: (..., K); wq: (N, K) uint8; scale/zero:
    (N, 1).  Leading dims of x flatten to M."""
    lead = x.shape[:-1]
    y = _dequant_matmul(x.reshape(-1, x.shape[-1]), wq, scale, zero,
                        out_dtype=out_dtype)
    return y.reshape(*lead, wq.shape[0])


def decode_dequant_matmul(x, packed, lut, *, out_dtype=torch.bfloat16):
    """Compressed-weight matmul, the paper's serving hot path: the fused
    decode→dequant→matmul kernel over a tile-major ``PackedLinear``."""
    if packed.codes.ndim != 2:
        raise ValueError("decode_dequant_matmul takes one layer's 2-D "
                         f"planes, got codes {tuple(packed.codes.shape)}")
    if not packed.tile_n:
        raise NotImplementedError(
            "linear-layout planes (tile_n == 0) need the two-step decode "
            "path, which is not ported; pack with a tile-major layout")
    DISPATCH_COUNTS["fused"] += 1
    n, k = packed.shape
    lead = x.shape[:-1]
    y = _fused(x.reshape(-1, k), packed.codes, packed.literals, lut,
               packed.scale, packed.zero, shape=tuple(packed.shape),
               tile_n=packed.tile_n, tile_k=packed.tile_k,
               out_dtype=out_dtype)
    return y.reshape(*lead, n)


def flash_attention(q, k, v, *, causal=True, sm_scale=None, q_offset=0):
    """(B, Hq, Tq, D) × (B, Hkv, Tk, D) → (B, Hq, Tq, D)."""
    return _flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                            q_offset=q_offset)
