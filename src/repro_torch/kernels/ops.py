"""Public kernel entry points of the port — what the model layers call.

Counterpart of ``repro/kernels/ops.py`` (single device).  Dispatch follows
the tensors' device: a CUDA tensor launches the hand-written kernel (or the
wrapper raises), a CPU tensor takes the kernel's plain PyTorch version.
There is no lever that sends CUDA tensors to a plain version.

``DISPATCH_COUNTS`` counts which path each compressed matmul took (the
reference's probe); ``_build.LAUNCH_COUNTS`` counts kernel launches.  In
the captured decode graph both count at each replay
(``serve.engine.DecodeGraph``).
"""
from __future__ import annotations

import collections

import torch

from .dequant_matmul import dequant_matmul as _dequant_matmul
from .flash_attention import flash_attention as _flash_attention
from .fused_decode_matmul import fused_decode_matmul as _fused
from .fused_decode_matmul import grouped_fused_decode_matmul as _grouped

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
    """(B, Hq, Tq, Dqk) × (B, Hkv, Tk, Dqk), (B, Hkv, Tk, Dv) →
    (B, Hq, Tq, Dv)."""
    return _flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                            q_offset=q_offset)


def grouped_fused_local(xe, packed, lut, *, out_dtype=torch.bfloat16):
    """Grouped expert fused matmul over a stacked tile-major PackedLinear
    (leading expert axis on every plane): xe (E, cap, K) → (E, cap, N), one
    launch of the grouped kernel.  No probe: callers count."""
    if not packed.tile_n or packed.codes.ndim != 3:
        raise ValueError("grouped_fused_local takes a stacked tile-major "
                         f"PackedLinear, got codes {tuple(packed.codes.shape)}"
                         f" tile_n {packed.tile_n}")
    return _grouped(xe, packed.codes, packed.literals, lut, packed.scale,
                    packed.zero, shape=tuple(packed.shape),
                    tile_n=packed.tile_n, tile_k=packed.tile_k,
                    out_dtype=out_dtype)


def grouped_decode_dequant_matmul(xe, packed, lut, *,
                                  out_dtype=torch.bfloat16):
    """Per-expert compressed matmul y[e] = x[e] @ W[e].T — the MoE hot
    path.  ``packed``: a stacked PackedLinear (codes (E, nb, slots), scale
    (E, N, 1), …); ``xe`` the capacity-gathered token blocks (E, cap, K).
    Tile-major stacks run the grouped fused kernel (probe
    'grouped_fused'); linear-layout stacks raise, as 2-D ones do."""
    if lut is None or packed.codes.ndim != 3:
        raise ValueError("grouped_decode_dequant_matmul takes a stacked "
                         "PackedLinear and its LUT, got codes "
                         f"{tuple(packed.codes.shape)}")
    if not packed.tile_n:
        raise NotImplementedError(
            "linear-layout expert stacks (tile_n == 0) need the two-step "
            "decode path, which is not ported; pack with a tile-major "
            "layout")
    DISPATCH_COUNTS["grouped_fused"] += 1
    return grouped_fused_local(xe, packed, lut, out_dtype=out_dtype)
