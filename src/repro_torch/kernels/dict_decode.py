"""Blocked dictionary decode to a dense uint8 tensor.

Counterpart of ``repro/kernels/dict_decode.py::dict_decode`` (the TPU
Pallas kernel).  The CUDA kernel is ``csrc/dict_decode.cu``: a thread
block per compressed block, a lane per 4 consecutive slots of a 1024-slot
chunk, each code read once, the escape rank from a warp scan and one
block-wide combine, the grams stored straight to device memory (its header
says what bounds it on the H100 and how the design answers that).
:func:`dict_decode_plain` is the plain PyTorch version the CPU runs and the
card's kernel is held against.
Decoding is integer work, so the two are bitwise equal on every input.

On the port's MoE path it decodes MLA's ``wkv_b`` at every forward
(``PackedLinear.materialize_int8`` on a CUDA plane).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.blocked_codec import decode_blocked
from . import _build

NAME = "dict_decode"
MAX_SLOTS = 1 << 30       # slot and literal-row indices are 32-bit
MAX_BLOCKS = (1 << 31) - 1     # a thread block each: the grid's x limit
LANE_SLOTS, MAX_WARPS = 4, 8   # csrc/dict_decode.cu's kLaneSlots, kMaxWarps
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P]


def dict_decode_plain(codes, literals, lut) -> torch.Tensor:
    """Plain version: the LUT row gather and the in-block escape-rank
    gather of ``repro.kernels.ref.dict_decode`` (rank clipped to
    [0, cap − 1]).  (nb, slots) → (nb, slots·4) uint8."""
    return decode_blocked(codes, literals, lut)


def work(nb: int, slots: int, cap: int, lut_rows: int, *,
         literal_rows: int | None = None,
         lut_rows_read: int | None = None) -> tuple:
    """(FLOPs, bytes) of one launch over ``nb`` blocks of ``slots`` codes
    with ``cap`` literal rows each and a LUT of ``lut_rows`` rows: no
    arithmetic; the codes, the literal rows and LUT rows read once, the
    output written once.  ``literal_rows`` (Σ nlit) and ``lut_rows_read``
    (the distinct codes): what the data uses, where it is known; by
    default every literal row and LUT row, as a plan, which has no data,
    counts them.  A dry run's plan (``launch/dryrun.py``) and
    ``chip_smoke.py``'s bounds count by it."""
    lits = nb * cap if literal_rows is None else literal_rows
    rows = lut_rows if lut_rows_read is None else lut_rows_read
    return 0, nb * slots * 2 + lits * 4 + rows * 4 + nb * slots * 4


def launch_shape(nb: int, slots: int, lane_slots: int = LANE_SLOTS,
                 max_warps: int = MAX_WARPS) -> tuple:
    """(thread blocks, threads a block) that :func:`dict_decode` launches:
    a block per compressed block, a lane per ``lane_slots`` slots, at most
    ``max_warps`` warps (a chunk of 1024 slots; larger blocks walk chunks).
    The kernel is correct at any multiple of 32 threads up to its
    kMaxWarps warps; the arguments are the kernel's constants."""
    lanes = -(-slots // lane_slots)
    return nb, 32 * min(max_warps, -(-lanes // 32))


def dict_decode(codes, literals, lut) -> torch.Tensor:
    """Decode (nb, slots) int16 codes (uint16 bits) with literals uint8
    (nb, cap, 4) and lut uint8 (rows, 4) → (nb, slots·4) uint8.  Any block
    count and slot count; codes whose slots are not a multiple of 4, or
    that do not start on a 16-byte boundary, take the kernel's scalar
    path.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
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
    if slots > MAX_SLOTS or literals.shape[1] > MAX_SLOTS:
        raise ValueError(f"{NAME}: {slots} slots and {literals.shape[1]} "
                         f"literal rows per block; the kernel indexes at "
                         f"most {MAX_SLOTS}")
    if nb > MAX_BLOCKS:
        raise ValueError(f"{NAME}: {nb} blocks; the kernel launches a "
                         f"thread block each, at most {MAX_BLOCKS}")
    if (codes.dtype != torch.int16 or literals.dtype != torch.uint8
            or lut.dtype != torch.uint8):
        raise TypeError(f"{NAME}: codes must be int16, literals/lut uint8")
    for what, t in (("codes", codes), ("literals", literals), ("lut", lut)):
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {what} must be contiguous")
    if _build.PLAN is None and (literals.data_ptr() % 4
                                or lut.data_ptr() % 4):
        raise ValueError(f"{NAME}: literals and lut (read as uint32) must "
                         "start on a 4-byte boundary")
    out = torch.empty((nb, slots * 4), dtype=torch.uint8, device=dev)
    if nb == 0 or slots == 0:
        return out
    if _build.PLAN is not None:        # a dry run: planned, not launched
        _build.PLAN.launch(f"{NAME}:decode", work(
            nb, slots, literals.shape[1], lut.shape[0]))
    else:
        _, threads = launch_shape(nb, slots)
        fn = _build.function(NAME, "qmoe_dict_decode", _ARGTYPES)
        err = fn(codes.data_ptr(), literals.data_ptr(), lut.data_ptr(),
                 out.data_ptr(), nb, slots, literals.shape[1], threads,
                 dev.index, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, NAME)
    _build.LAUNCH_COUNTS[NAME] += 1
    return out
