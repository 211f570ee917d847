"""W8A16 dequant × matmul against a dense uint8 weight.

Counterpart of ``repro/kernels/dequant_matmul.py::dequant_matmul`` (the TPU
Pallas kernel).  The CUDA kernels are in ``csrc/dequant_matmul.cu`` (its
note says what bounds them on the H100 and how the design answers that);
:func:`dequant_plan` picks one by shape: the decode kernel at M ≤ 16 (a
warp per 8 weight rows over all of K, the product on the tensor cores; 4
rows a launch, so that above 4 rows one launch a group of 4 gives every
row its bits at M = 1), the tensor-core kernel at larger M (128 × 128
output tiles, K in steps of 64 through a cp.async ring), the SIMT kernel
where K % 16 ≠ 0.
:func:`dequant_matmul_plain` is the plain PyTorch version the CPU runs and
the card's kernels are held against.  All compute the kernel's affine form

    y = s · (Σ_k x·q − z·Σ_k x)

with the same epilogue as the fused kernel.  (``repro.kernels.ref`` instead
dequantizes the weight first; the two agree to f32 roundoff.)  On the
compressed main paths this is the int8 LM head (Llama-3.2's tied one).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .fused_decode_matmul import _split_count

NAME = "dequant_matmul"
KC = 512                  # K chunk of the SIMT kernel (csrc: kKC)
DECODE_M = 4              # rows of x the decode kernel takes (kDecM)
DECODE_ROWS = 8           # weight rows of a decode warp task (kDecRows)
DECODE_WARPS = 8          # warps a decode block (kDecWarps)
DECODE_BLOCKS_PER_SM = 2  # resident: launch bounds cap 128 registers
DECODE_STAGE_COLS = 512   # K columns of one stage (kLoads · kSlice)
MMA_MIN_M = 17            # the tensor-core kernel from this M on (PERF.md)
MMA_BM = MMA_BN = 128     # output tile of a tensor-core block (kMmaBM/BN)
MMA_STEP_K = 64           # K columns a stage (kStepK)
MMA_STAGES = 3            # the cp.async ring (kMmaStages)
MMA_THREADS = 256         # 8 warps (kMmaThreads)
MMA_BLOCKS_PER_SM = 2     # resident: launch bounds cap 128 registers
SMEM_MAX = 232448         # the most shared memory one block may take (H100)
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 7 + [_P]
_DECODE_ARGTYPES = [_P] * 5 + [_I] * 6 + [_P]
_MMA_ARGTYPES = [_P] * 7 + [_I] * 6 + [_P]


class DequantPlan(NamedTuple):
    """How one launch covers (M, N, K): ``kernel`` ``"decode"`` — warp
    tasks of ``DECODE_ROWS`` weight rows over all of K, ``DECODE_WARPS`` to
    a block, ``grid[0]`` blocks — ``"mma"`` — 128 × 128 output tiles,
    (stripes of N, bands of M, K splits of whole 64-column steps) — or
    ``"simt"`` — ``rpt`` rows of x a thread in blocks of 128 columns, K in
    ``splits`` runs; ``grid`` and ``threads`` as the C side launches
    them; ``row_groups`` launches of the decode kernel, one a group of 4
    rows."""
    kernel: str
    grid: tuple
    threads: int
    smem_bytes: int
    rpt: int = 0
    splits: int = 1
    row_groups: int = 1


def decode_smem_bytes(k: int) -> int:
    """Shared memory of one decode block (csrc: ``decode_smem_bytes``): x as
    bf16, 4 rows of K rounded up to whole stages, each row 16 bytes
    longer (banks), and 4 partial sums of Σx a warp."""
    kpad = -(-k // DECODE_STAGE_COLS) * DECODE_STAGE_COLS
    return DECODE_M * (2 * kpad + 16) + DECODE_WARPS * DECODE_M * 4


def mma_smem_bytes() -> int:
    """Shared memory of one tensor-core block (csrc: ``kMmaSmem``): the
    ring's stages of bf16 x (128 rows of 64 columns, each row 16 bytes
    longer) and uint8 weight (128 × 64), the weight stage widened to bf16
    (128 × 72), and 128 row sums."""
    row = (MMA_STEP_K + 8) * 2
    stage = MMA_BM * row + MMA_BN * MMA_STEP_K
    return MMA_STAGES * stage + MMA_BN * row + MMA_BM * 4


def dequant_plan(m: int, n: int, k: int, sms: int,
                 decode: bool = False,
                 plan_n: int | None = None) -> DequantPlan:
    """The launch of (M, K) × (K, N) on a card of ``sms`` SMs, a pure
    function of the shapes and of ``decode``: whether the M rows are a
    decode step's (one token a row, each its own request).

    Decode batch (M ≤ 16, K a positive multiple of 16: rows of 16-byte
    loads): the decode kernel, one warp task per 8 weight rows, 8 warps a
    block.  The grid is persistent: no more warps than the card holds at
    once (2 blocks an SM), and as few as take the tasks in the same number
    of rounds, so that every warp runs the same number of tasks but the
    last few (PERF.md).  It takes 4 rows of x: above 4, ``row_groups`` =
    ⌈M / 4⌉ launches, one a group of 4 rows, so that each row has the
    bits it has alone (the reference's row independence: an engine tick
    of 5–16 slots gives each request generate's tokens), at about the
    price of ⌈M / 4⌉ decode-batch calls (PERF.md).  A decode step's rows
    take this plan at any M, so that above 16 rows too a row has the bits
    it has alone; a prefill of the same M (one request's tokens) takes the
    tensor-core kernel, as the shapes alone cannot tell the two apart.

    From ``MMA_MIN_M`` rows on (K a positive multiple of 16): the
    tensor-core kernel, blocks of 128 × 128 outputs, two resident an SM.  K is split only
    where the output tiles leave SMs without a block: into as many runs
    of whole 64-column steps as keep the grid within one block an SM
    (k_proj at M = 700: 4 × 6 tiles, 5 splits), no run empty.  Splitting
    for both of an SM's block slots instead moved a layer's seven
    projections by −4 % at M = 700 and +1 % at 175 (PERF.md): within
    what the split-K epilogue costs, so the simpler rule stays.

    Otherwise the SIMT kernel: 4 rows a block at M ≤ 4, else 16; K split
    so that about two blocks sit on every SM.

    ``plan_n``: the N whose K splits the launch takes (default N), the
    grid covering N: a mesh rank's out-band of a weight passes the whole
    weight's N, so that each column's products are summed in the order
    the whole weight's launch sums them (the decode kernel's order does
    not depend on N)."""
    if (m < MMA_MIN_M or decode) and k > 0 and k % 16 == 0:
        tasks = -(-n // DECODE_ROWS)
        rounds = -(-tasks // (sms * DECODE_BLOCKS_PER_SM * DECODE_WARPS))
        blocks = -(-tasks // (rounds * DECODE_WARPS))
        return DequantPlan("decode", (blocks, 1, 1), 32 * DECODE_WARPS,
                           decode_smem_bytes(k),
                           row_groups=-(-m // DECODE_M))
    if m >= MMA_MIN_M and k > 0 and k % 16 == 0:
        return mma_plan(m, n, k, sms, plan_n)
    return simt_plan(m, n, k, sms, plan_n)


def mma_plan(m: int, n: int, k: int, sms: int,
             plan_n: int | None = None) -> DequantPlan:
    """The tensor-core kernel's launch at any M (K a positive multiple of
    16): ``dequant_plan``'s choice from MMA_MIN_M rows on; below, what
    tools/profile_decode.py and the tests time and emulate beside the
    decode kernel's row groups."""
    stripes, bands = -(-n // MMA_BN), -(-m // MMA_BM)
    steps = -(-k // MMA_STEP_K)
    want = max(1, min(steps, sms // (-(-(plan_n or n) // MMA_BN) * bands)))
    splits = -(-steps // -(-steps // want))
    return DequantPlan("mma", (stripes, bands, splits), MMA_THREADS,
                       mma_smem_bytes(), splits=splits)


def simt_plan(m: int, n: int, k: int, sms: int,
              plan_n: int | None = None) -> DequantPlan:
    """The SIMT kernel's launch at any shape (``dequant_plan``'s choice
    where K % 16 ≠ 0; tools/profile_decode.py times it beside the others
    at their shapes)."""
    rpt = 2 if m <= 4 else 8
    stripes, bands = -(-n // 128), -(-m // (2 * rpt))
    splits = _split_count(-(-(plan_n or n) // 128) * bands,
                          max(1, -(-k // KC)), sms)
    return DequantPlan("simt", (stripes, bands, splits), 256,
                       128 * (KC + 4) + (2 * rpt * KC + 2 * rpt) * 4,
                       rpt=rpt, splits=splits)


def dequant_matmul_plain(x, wq, scale, zero,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: f32 integer-weight product, row sums of x, affine
    epilogue."""
    xf = x.to(torch.float32)
    acc = xf @ wq.to(torch.float32).T
    sumx = xf.sum(dim=1, keepdim=True)
    y = scale.reshape(1, -1) * (acc - sumx * zero.reshape(1, -1))
    return y.to(out_dtype)


def dequant_matmul(x, wq, scale, zero, out_dtype=torch.bfloat16,
                   decode: bool = False,
                   plan_n: int | None = None) -> torch.Tensor:
    """y = x @ dequant(wq).T.  x: (M, K) float; wq: (N, K) uint8;
    scale/zero: (N, 1) f32.  ``decode``: x's rows are a decode step's
    (:func:`dequant_plan`); ``plan_n``: the N the launch is planned for
    (a mesh rank's out-band passes the whole weight's).  CPU tensors take
    the plain version; CUDA tensors launch the kernel
    :func:`dequant_plan` picks, or raise."""
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
    if xb.data_ptr() % 16:       # decode and mma copy x 16 B at a time
        xb = xb.clone()
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    plan = dequant_plan(m, n, k, _build.sm_count(dev), decode, plan_n)
    if plan.smem_bytes > SMEM_MAX or plan.grid[0] > MAX_GRID_X \
            or max(plan.grid[1:]) > MAX_GRID_YZ:
        raise ValueError(f"{NAME}: ({m}, {n}, {k}) needs a grid "
                         f"{plan.grid} with {plan.smem_bytes} B of shared "
                         "memory a block, past the card's limits")
    _launch(plan, xb, wq, scale, zero, out)
    _build.LAUNCH_COUNTS[NAME] += plan.row_groups
    _build.KERNEL_COUNTS[f"{NAME}:{plan.kernel}"] += plan.row_groups
    return out


def _launch(plan: DequantPlan, xb, wq, scale, zero, out, fn=None):
    """Launch ``plan``'s kernel on checked operands (xb bf16 and wq on
    16-byte boundaries, out allocated); raises on a CUDA error.  ``fn``:
    another build's C entry of ``plan.kernel`` (tools/profile_decode.py's
    design variants)."""
    m, k = xb.shape
    n = wq.shape[0]
    dev = out.device
    bf16 = int(out.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.kernel == "decode":
        fn = fn or _build.function(NAME, "qmoe_dequant_matmul_decode",
                                   _DECODE_ARGTYPES)
        for r in range(0, m, DECODE_M):       # one launch a group of 4 rows
            err = fn(xb[r:].data_ptr(), wq.data_ptr(), scale.data_ptr(),
                     zero.data_ptr(), out[r:].data_ptr(), bf16,
                     min(DECODE_M, m - r), n, k, plan.grid[0], dev.index,
                     stream)
            if err:
                break
    else:
        part = sx = None
        if plan.splits > 1:
            part = torch.empty(plan.splits * m * n, dtype=torch.float32,
                               device=dev)
            sx = torch.empty(plan.splits * m, dtype=torch.float32,
                             device=dev)
        ptrs = (xb.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                zero.data_ptr(), out.data_ptr(),
                part.data_ptr() if part is not None else None,
                sx.data_ptr() if sx is not None else None, bf16, m, n, k,
                plan.splits)
        if plan.kernel == "mma":
            fn = fn or _build.function(NAME, "qmoe_dequant_matmul_mma",
                                       _MMA_ARGTYPES)
            err = fn(*ptrs, dev.index, stream)
        else:
            fn = fn or _build.function(NAME, "qmoe_dequant_matmul",
                                       _ARGTYPES)
            err = fn(*ptrs, plan.rpt, dev.index, stream)
    _build.check(err, NAME)
