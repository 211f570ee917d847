"""W8A16 dequant × matmul against a dense uint8 weight.

Counterpart of ``repro/kernels/dequant_matmul.py::dequant_matmul`` (the TPU
Pallas kernel).  The CUDA kernel is ``csrc/dequant_matmul.cu``;
:func:`dequant_matmul_plain` is the plain PyTorch version the CPU runs and
the card's kernel is held against.  Both compute the kernel's affine form

    y = s · (Σ_k x·q − z·Σ_k x)

with the same epilogue as the fused kernel.  (``repro.kernels.ref`` instead
dequantizes the weight first; the two agree to f32 roundoff.)  On the
compressed main path this is Llama-3.2's tied LM head.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_decode_matmul import _split_count

NAME = "dequant_matmul"
KC = 512                  # K chunk of the kernel (csrc: kKC)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 7 + [_P]


def dequant_matmul_plain(x, wq, scale, zero,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: f32 integer-weight product, row sums of x, affine
    epilogue."""
    xf = x.to(torch.float32)
    acc = xf @ wq.to(torch.float32).T
    sumx = xf.sum(dim=1, keepdim=True)
    y = scale.reshape(1, -1) * (acc - sumx * zero.reshape(1, -1))
    return y.to(out_dtype)


def dequant_matmul(x, wq, scale, zero,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ dequant(wq).T.  x: (M, K) float; wq: (N, K) uint8;
    scale/zero: (N, 1) f32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, wq, scale, zero, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {x.device}")
    dev = _build.cuda_args(x, wq, scale, zero)
    m, k = x.shape
    n = wq.shape[0]
    if wq.ndim != 2 or wq.shape[1] != k or scale.numel() != n \
            or zero.numel() != n:
        raise ValueError(f"{NAME}: x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
                         f"scale {tuple(scale.shape)} do not match")
    if wq.dtype != torch.uint8 or scale.dtype != torch.float32 \
            or zero.dtype != torch.float32:
        raise TypeError(f"{NAME}: wq must be uint8, scale/zero f32")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{NAME}: out_dtype must be bf16 or f32")
    if not (wq.is_contiguous() and scale.is_contiguous()
            and zero.is_contiguous()):
        raise ValueError(f"{NAME}: wq, scale and zero must be contiguous")
    if wq.data_ptr() % 16:
        raise ValueError(f"{NAME}: wq must start on a 16-byte boundary")
    xb = x.to(torch.bfloat16).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    rpt = 2 if m <= 4 else 8
    blocks = -(-n // 128) * -(-m // (2 * rpt))
    splits = _split_count(blocks, -(-k // KC), _build.sm_count(dev))
    part = sx = None
    if splits > 1:
        part = torch.empty(splits * m * n, dtype=torch.float32, device=dev)
        sx = torch.empty(splits * m, dtype=torch.float32, device=dev)
    fn = _build.function(NAME, "qmoe_dequant_matmul", _ARGTYPES)
    err = fn(xb.data_ptr(), wq.data_ptr(), scale.data_ptr(),
             zero.data_ptr(), out.data_ptr(),
             part.data_ptr() if part is not None else None,
             sx.data_ptr() if sx is not None else None,
             int(out_dtype == torch.bfloat16), m, n, k, splits, rpt,
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCH_COUNTS[NAME] += 1
    return out
