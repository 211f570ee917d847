"""Fused decode→dequant→matmul: the compressed serving hot path.

Counterpart of ``repro/kernels/fused_decode_matmul.py::fused_decode_matmul``
(the TPU Pallas kernel) for G = 1 tile-major planes.  The CUDA kernel is
``csrc/fused_decode_matmul.cu`` (its header says what bounds it on the H100
and how the design answers that); :func:`fused_decode_matmul_plain` is the
plain PyTorch version the CPU runs and the card's kernel is held against.

    y = s · (Σ_k x·q − z·Σ_k x),  q decoded from (codes, literals, lut)

The kernel rounds x to bf16 before the product, as the TPU kernel does
(``fused_decode_matmul.py:81``); the plain version takes x as given, as
``repro.kernels.ref`` does — for bf16 x the two see the same numbers.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.blocked_codec import decode_blocked
from . import _build

NAME = "fused_decode_matmul"
MAX_TILE_N = 128          # the kernel's block width (csrc: kBN)
MAX_TILE_K = 512          # bounds the tile held in shared memory
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 12 + [_P]


def fused_decode_matmul_plain(x, codes, literals, lut, scale, zero, *,
                              shape, tile_n: int, tile_k: int,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: walk K in ``tile_k`` strips, decode only that strip's
    blocks to an (N, tile_k) uint8 band, accumulate ``x_k @ q_k.T`` and
    the row sums of x in f32, then the affine epilogue once — the strip
    structure of ``repro.kernels.ref.fused_decode_matmul``."""
    n, k = shape
    m = x.shape[0]
    nnt, nkt = n // tile_n, k // tile_k
    nb, slots = codes.shape
    bpt = nb // (nnt * nkt)
    cap, s = literals.shape[1], literals.shape[2]
    codes_s = codes.reshape(nnt, nkt, bpt, slots)
    lits_s = literals.reshape(nnt, nkt, bpt, cap, s)
    xf = x.to(torch.float32)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for kt in range(nkt):
        q = decode_blocked(codes_s[:, kt].reshape(-1, slots),
                           lits_s[:, kt].reshape(-1, cap, s), lut)
        q = q.reshape(n, tile_k).to(torch.float32)
        acc = acc + xf[:, kt * tile_k:(kt + 1) * tile_k] @ q.T
    sumx = xf.sum(dim=1, keepdim=True)
    y = scale.reshape(1, -1) * (acc - sumx * zero.reshape(1, -1))
    return y.to(out_dtype)


def block_rows(m: int, tile_k: int) -> int:
    """Rows per block: 4 or 16 with the SIMT product (decode-sized M), 128
    with the tensor-core product (prefill-sized M; needs 64 | tile_k)."""
    if m <= 4:
        return 4
    if m <= 16 or tile_k % 64:
        return 16
    return 128


def _split_count(blocks: int, steps: int, device) -> int:
    """K splits that put about two blocks on every SM, no split empty."""
    sms = _build.sm_count(device)
    want = max(1, min(steps, -(-2 * sms // blocks)))
    per = -(-steps // want)
    return -(-steps // per)


def fused_decode_matmul(x, codes, literals, lut, scale, zero, *, shape,
                        tile_n: int, tile_k: int,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ dequant(decode(codes, literals)).T without a dense weight.

    x: (M, K) float; codes int16 (uint16 bits) (nb, slots), literals uint8
    (nb, cap, 4), lut uint8 (n_codes + 1, 4): tile-major planes of the
    dense ``shape = (N, K)`` weight; scale/zero (N, 1) f32.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise.
    """
    if x.device.type == "cpu":
        return fused_decode_matmul_plain(
            x, codes, literals, lut, scale, zero, shape=shape,
            tile_n=tile_n, tile_k=tile_k, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {x.device}")
    dev = _build.cuda_args(x, codes, literals, lut, scale, zero)
    n, k = shape
    m = x.shape[0]
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"{NAME}: x {tuple(x.shape)} against weight {shape}")
    if not (0 < tile_n <= MAX_TILE_N and MAX_TILE_N % tile_n == 0
            and 4 <= tile_k <= MAX_TILE_K and tile_k & (tile_k - 1) == 0
            and n % tile_n == 0 and k % tile_k == 0):
        raise ValueError(f"{NAME}: tile {(tile_n, tile_k)} of {shape} is "
                         f"outside the kernel's range (tile_n | 128, "
                         f"tile_k a power of two in [4, 512])")
    nb, slots = codes.shape
    nnt, nkt = n // tile_n, k // tile_k
    bpt = nb // (nnt * nkt)
    if (codes.dtype != torch.int16 or literals.dtype != torch.uint8
            or lut.dtype != torch.uint8 or scale.dtype != torch.float32
            or zero.dtype != torch.float32):
        raise TypeError(f"{NAME}: planes must be int16 codes, uint8 "
                        "literals/lut and f32 scale/zero")
    if (literals.ndim != 3 or literals.shape[0] != nb
            or literals.shape[2] != 4 or lut.ndim != 2 or lut.shape[1] != 4
            or bpt * nnt * nkt != nb or bpt * slots * 4 != tile_n * tile_k
            or scale.numel() != n or zero.numel() != n):
        raise ValueError(f"{NAME}: planes codes {tuple(codes.shape)}, "
                         f"literals {tuple(literals.shape)} do not tile "
                         f"{shape} by {(tile_n, tile_k)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{NAME}: out_dtype must be bf16 or f32")
    for name, t in (("codes", codes), ("literals", literals), ("lut", lut),
                    ("scale", scale), ("zero", zero)):
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if codes.data_ptr() % 16 or literals.data_ptr() % 4 \
            or lut.data_ptr() % 4:
        raise ValueError(f"{NAME}: codes (read 16 bytes at a time), "
                         "literals and lut (read as uint32) must start on "
                         "a 16-, 4- and 4-byte boundary")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:      # the tensor-core path loads x 16 B at a time
        xb = xb.clone()
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    bm = block_rows(m, tile_k)
    blocks = -(-n // MAX_TILE_N) * -(-m // bm)
    splits = _split_count(blocks, nkt, dev)
    part = sx = None
    if splits > 1:
        part = torch.empty(splits * m * n, dtype=torch.float32, device=dev)
        sx = torch.empty(splits * m, dtype=torch.float32, device=dev)
    fn = _build.function(NAME, "qmoe_fused_decode_matmul", _ARGTYPES)
    err = fn(xb.data_ptr(), codes.data_ptr(), literals.data_ptr(),
             lut.data_ptr(), scale.data_ptr(), zero.data_ptr(),
             out.data_ptr(), part.data_ptr() if part is not None else None,
             sx.data_ptr() if sx is not None else None,
             int(out_dtype == torch.bfloat16), m, n, k, tile_n, tile_k,
             slots, literals.shape[1], bpt, splits, bm, dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCH_COUNTS[NAME] += 1
    return out
