"""Blocked dictionary decode to a dense uint8 tensor.

Counterpart of ``repro/kernels/dict_decode.py::dict_decode`` (the TPU
Pallas kernel).  The CUDA kernel is ``csrc/dict_decode.cu`` (its header says
what bounds it on the H100 and how the design answers that);
:func:`dict_decode_plain` is the plain PyTorch version the CPU runs and the
card's kernel is held against.  Decoding is integer work, so the two are
bitwise equal on every input.

On the port's MoE path it decodes MLA's ``wkv_b`` at every forward
(``PackedLinear.materialize_int8`` on a CUDA plane).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.blocked_codec import decode_blocked
from . import _build

NAME = "dict_decode"
MAX_SLOTS = 12288         # the staged rows of 4 warps fit in shared memory
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_L, _I, _I, _I, _P]


def dict_decode_plain(codes, literals, lut) -> torch.Tensor:
    """Plain version: the LUT row gather and the in-block escape-rank
    gather of ``repro.kernels.ref.dict_decode`` (rank clipped to
    [0, cap − 1]).  (nb, slots) → (nb, slots·4) uint8."""
    return decode_blocked(codes, literals, lut)


def dict_decode(codes, literals, lut) -> torch.Tensor:
    """Decode (nb, slots) int16 codes (uint16 bits) with literals uint8
    (nb, cap, 4) and lut uint8 (rows, 4) → (nb, slots·4) uint8.  Any block
    count: the kernel masks the ragged end.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if codes.device.type == "cpu":
        return dict_decode_plain(codes, literals, lut)
    if codes.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {codes.device}")
    dev = _build.cuda_args(codes, literals, lut)
    if codes.ndim != 2 or literals.ndim != 3 or lut.ndim != 2:
        raise ValueError(f"{NAME}: codes {tuple(codes.shape)}, literals "
                         f"{tuple(literals.shape)}, lut {tuple(lut.shape)}: "
                         "want (nb, slots), (nb, cap, 4), (rows, 4)")
    nb, slots = codes.shape
    if (literals.shape[0] != nb or literals.shape[2] != 4
            or literals.shape[1] < 1 or lut.shape[1] != 4):
        raise ValueError(f"{NAME}: literals {tuple(literals.shape)} and lut "
                         f"{tuple(lut.shape)} do not match codes "
                         f"{tuple(codes.shape)} (4-byte grams)")
    if not 0 < slots <= MAX_SLOTS:
        raise ValueError(f"{NAME}: {slots} slots per block; the kernel "
                         f"stages at most {MAX_SLOTS}")
    if (codes.dtype != torch.int16 or literals.dtype != torch.uint8
            or lut.dtype != torch.uint8):
        raise TypeError(f"{NAME}: codes must be int16, literals/lut uint8")
    for what, t in (("codes", codes), ("literals", literals), ("lut", lut)):
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {what} must be contiguous")
    if codes.data_ptr() % 16 or literals.data_ptr() % 4 \
            or lut.data_ptr() % 4:
        raise ValueError(f"{NAME}: codes (read 16 bytes at a time), "
                         "literals and lut (read as uint32) must start on "
                         "a 16-, 4- and 4-byte boundary")
    out = torch.empty((nb, slots * 4), dtype=torch.uint8, device=dev)
    if nb == 0:
        return out
    fn = _build.function(NAME, "qmoe_dict_decode", _ARGTYPES)
    err = fn(codes.data_ptr(), literals.data_ptr(), lut.data_ptr(),
             out.data_ptr(), nb, slots, literals.shape[1], dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, NAME)
    _build.LAUNCH_COUNTS[NAME] += 1
    return out
