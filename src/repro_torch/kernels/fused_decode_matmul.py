"""Fused decode→dequant→matmul: the compressed serving hot path.

Counterpart of two TPU Pallas kernels of
``repro/kernels/fused_decode_matmul.py``: K1 ``fused_decode_matmul``
(tile-major planes, with its column groups: G > 1 for a
``TiledPackedLinear``'s (G, nb, slots) planes, all G in one launch) and K3
``grouped_fused_decode_matmul`` (the same product for every expert of a
stacked MoE weight, in one launch).  Both run the CUDA
kernel ``csrc/fused_decode_matmul.cu`` (its header says what bounds it on
the H100 and how the design answers that; :func:`launch_plan` picks one of
its three kernels: the decode kernel at M ≤ 16, the tensor-core kernel
above, the SIMT kernel only for tiles 1 or 2 weights wide or compressed
blocks past the decode kernel's limits); :func:`fused_decode_matmul_plain`
and :func:`grouped_fused_decode_matmul_plain` are the plain PyTorch
versions the CPU runs and the card's kernel is held against.

    y = s · (Σ_k x·q − z·Σ_k x),  q decoded from (codes, literals, lut)

The kernel rounds x to bf16 before the product, as the TPU kernel does
(``fused_decode_matmul.py:81``); the plain version takes x as given, as
``repro.kernels.ref`` does — for bf16 x the two see the same numbers.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.blocked_codec import decode_blocked
from . import _build

NAME = "fused_decode_matmul"                 # K1; also the CUDA source
GROUPED_NAME = "grouped_fused_decode_matmul"  # K3
MAX_TILE_N = 128          # the kernel's block width (csrc: kBN)
MAX_TILE_K = 512          # bounds the tile held in shared memory
MAX_GRID_Z = 65535        # experts × K splits share gridDim.z
MMA_BM = 128              # rows of a band of the tensor-core kernel
MMA_STEP_K = 64           # K columns of a tensor-core step (csrc: kSubK)
SPAN_COLS = 512           # widest K span the tensor-core kernel decodes
MMA_SMEM_MAX = 232448     # the most shared memory one block may take (H100)
DECODE_M = 4              # rows of x in a row group of the decode kernel
DECODE_MAX_M = 16         # rows it takes: 4 row groups (kDecRG)
DECODE_MAX_SLOTS = 1024   # its blocks: at most 4 steps of 256 slots
DECODE_MAX_WARPS = 16     # K tiles a block's warps take at once
DECODE_ROW_WARPS = 8      # warps a block at M 5–16 (kDecRowWarps)
DECODE_WARPS_PER_SM = 16  # resident at 128 registers a thread
MAX_GRID_X = 2 ** 31 - 1
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 18 + [_P]


def fused_decode_matmul_plain(x, codes, literals, lut, scale, zero, *,
                              shape, tile_n: int, tile_k: int,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: walk K in ``tile_k`` strips, decode only that strip's
    blocks to an (N, tile_k) uint8 band, accumulate ``x_k @ q_k.T`` and
    the row sums of x in f32, then the affine epilogue once — the strip
    structure of ``repro.kernels.ref.fused_decode_matmul``.

    Column groups: planes (G, nb, slots) / (G, nb, cap, 4) hold G
    sub-weights of (N, K/G), group g over x columns [g·K/G, (g+1)·K/G).
    The strips are walked in (g, k) order into the one accumulator, as
    the kernel walks them; 2-D planes are G = 1.  (The reference's CPU
    path adds each group's affine output instead, which rounds
    otherwise.)"""
    n, k = shape
    m = x.shape[0]
    if codes.ndim == 2:
        codes, literals = codes[None], literals[None]
    groups, nb, slots = codes.shape
    nnt, nkt = n // tile_n, k // (groups * tile_k)
    bpt = nb // (nnt * nkt)
    cap, s = literals.shape[2], literals.shape[3]
    codes_s = codes.reshape(groups, nnt, nkt, bpt, slots)
    lits_s = literals.reshape(groups, nnt, nkt, bpt, cap, s)
    xf = x.to(torch.float32)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for g in range(groups):
        for kt in range(nkt):
            q = decode_blocked(codes_s[g, :, kt].reshape(-1, slots),
                               lits_s[g, :, kt].reshape(-1, cap, s), lut)
            q = q.reshape(n, tile_k).to(torch.float32)
            c0 = (g * nkt + kt) * tile_k
            acc = acc + xf[:, c0:c0 + tile_k] @ q.T
    sumx = xf.sum(dim=1, keepdim=True)
    y = scale.reshape(1, -1) * (acc - sumx * zero.reshape(1, -1))
    return y.to(out_dtype)


def check_tiles(name: str, shape, tile_n: int, tile_k: int):
    """Raise unless the kernel takes (tile_n, tile_k) tiles of ``shape``:
    tile_n divides 128, tile_k is a power of two up to 512 (1 and 2
    included: the packer picks them for K odd or 2 mod 4), and both
    divide the weight."""
    n, k = shape
    if not (0 < tile_n <= MAX_TILE_N and MAX_TILE_N % tile_n == 0
            and 0 < tile_k <= MAX_TILE_K and tile_k & (tile_k - 1) == 0
            and n % tile_n == 0 and k % tile_k == 0):
        raise ValueError(f"{name}: tile {(tile_n, tile_k)} of {shape} is "
                         f"outside the kernel's range (tile_n | 128, "
                         f"tile_k a power of two in [1, 512])")


def block_rows(m: int, tile_k: int) -> int:
    """Rows per block: 4 (one row group of the decode kernel, or the SIMT
    kernel's band) at M ≤ 4, 16 (four row groups, or a SIMT band) at M
    5–16 or tile_k 1 and 2, else 128 (the tensor-core kernel's band)."""
    if m <= DECODE_M:
        return 4
    if m <= DECODE_MAX_M or tile_k < 4:
        return 16
    return MMA_BM


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split_count(blocks: int, steps: int, sms: int) -> int:
    """K splits that put about two blocks on every SM, no split empty."""
    want = max(1, min(steps, _cdiv(2 * sms, blocks)))
    return _cdiv(steps, _cdiv(steps, want))


def mma_smem_bytes(span_cols: int) -> int:
    """Shared memory of one tensor-core block decoding ``span_cols``
    columns at once (csrc: ``mma_smem_bytes``): the span in bf16 (its
    columns rounded up to whole 64-column steps), three bf16 stages of x
    (128 × 72) and 128 row sums."""
    def align(b):
        return _cdiv(b, 128) * 128
    cols = _cdiv(span_cols, MMA_STEP_K) * MMA_STEP_K
    return (align(128 * (cols + 8) * 2) + 3 * align(128 * 72 * 2)
            + 128 * 4)


class Plan(NamedTuple):
    """How one launch covers (E, M, N, K): ``kernel`` — ``"decode"`` (M ≤
    16: a warp per compressed block, ``warps`` K tiles at once per row
    group, all of K in the launch), ``"simt"`` or ``"mma"`` — with ``bm``
    rows per block, K cut into ``splits`` runs of ``tiles_per_split``
    tiles (the last may be shorter), decoded ``span`` tiles at a time, and
    — at bm = 128 — ``bands_per_block`` 128-row bands walked by each block
    over each span it decodes."""
    bm: int
    splits: int
    tiles_per_split: int
    span: int
    bands_per_block: int
    kernel: str = "simt"
    warps: int = 0
    row_groups: int = 1


def launch_plan(m: int, n: int, k: int, tile_k: int, e: int,
                sms: int, slots: int = DECODE_MAX_SLOTS,
                decode: bool = False) -> Plan:
    """The launch of E products (M, K) × (K, N) with K tiles of ``tile_k``
    (compressed blocks of ``slots`` codes) on a card of ``sms`` SMs.

    ``decode``: the M rows are a decode step's (one token a row, each its
    own request).  Above 16 such rows the plan is the 16-row plan below
    with ``row_groups`` = ⌈M/16⌉: the wrapper launches it once a group of
    at most 16 rows, so that a row has the bits it has alone at any M (an
    engine tick of 17 or more slots gives each request generate's tokens).
    A prefill of the same M (one request's tokens) takes the tensor-core
    kernel, as the shapes alone cannot tell the two apart.

    Decode batch (M ≤ 16, tile_k ≥ 4, blocks of ≤ 1024 slots, ≤ 512 below
    tile_k 32 — every block the packer makes at those tiles): the decode
    kernel, one block per row group over all of K — no split — whose K
    tiles are dealt to W warps, tile kt to warp kt mod W.  W is the
    largest power of two that keeps the grid's warps within one wave of
    the card (16 a SM), at most the K tiles and 16: a block's fixed costs
    (its barrier, the epilogue) are paid once per row group, so where row
    groups alone fill the card one warp walks all of K (PERF.md: K3's down
    stack went from 11 warps to 1, and its time fell by over a third).
    Its grid is E · N · tile_k / (4 · slots) blocks (:func:`launch_grid`).
    Neither W nor the grid depends on M: W fixes the order in which a
    row's products are summed, so a row has the same bits at every M from
    1 to 16 (above 4 rows the kernel runs 4-row groups, each with the M ≤
    4 arithmetic).

    Prefill-sized M (M > 16, tile_k ≥ 4; bm 128, tensor cores, one block
    per SM): the kernel decodes ``span`` K tiles at once, ``SPAN_COLS``
    columns or all of K if less, which fits a block's shared memory
    (``mma_smem_bytes``).  With one band of rows (M ≤ 128) a tile is
    decoded once whatever the grid, so K is split so that about two blocks
    sit on every SM.  With several bands, a split is one span and a block
    walks ``bands_per_block`` ≥ 2 bands over it, so each tile is decoded
    ⌈bands / bands_per_block⌉ ≤ bands / 2 times: once, where E · stripes
    · splits blocks already cover the SMs; else the fewest bands per block
    that keep the grid within one block per SM.  The price is the split-K
    workspace, written and read once: 8·M·N·K / SPAN_COLS bytes, about
    M·N·K · 4.7e-15 s at 3.35 TB/s, against the decodes saved, at least
    bands/2 decodes of N·K weights at about 4e-12 s each (PERF.md),
    M·N·K · 1.6e-14 s — under a third.  Below tile_k 64 a split is whole
    64-column steps (the kernel's K step; tiles sit side by side in it), so
    only the last split's last span may end inside a step.

    Otherwise (tile_k 1 or 2, or a decode-sized M whose blocks pass the
    decode kernel's limits) the SIMT kernel: one band of 4 or 16 rows per
    block, K split so that about two blocks sit on every SM."""
    if decode and m > DECODE_MAX_M:
        return launch_plan(DECODE_MAX_M, n, k, tile_k, e, sms, slots
                           )._replace(row_groups=_cdiv(m, DECODE_MAX_M))
    bm = block_rows(m, tile_k)
    nkt = k // tile_k
    if (m <= DECODE_MAX_M and tile_k >= 4
            and slots <= (DECODE_MAX_SLOTS if tile_k >= 32 else 512)):
        groups = e * n * tile_k // (4 * slots)
        fit = max(1, sms * DECODE_WARPS_PER_SM // max(groups, 1))
        warps = min(1 << (fit.bit_length() - 1), nkt, DECODE_MAX_WARPS)
        return Plan(bm, 1, nkt, 1, 1, "decode", warps)
    stripes = _cdiv(n, MAX_TILE_N)
    bands = _cdiv(m, bm)
    span = min(nkt, max(1, SPAN_COLS // tile_k))
    if bm < MMA_BM or bands == 1:
        splits = _split_count(e * stripes * bands, nkt, sms)
    else:
        splits = _cdiv(nkt, span)
    per = _cdiv(nkt, splits)
    if bm == MMA_BM and tile_k < MMA_STEP_K:
        step = MMA_STEP_K // tile_k           # tiles of one K step
        per = min(nkt, _cdiv(per, step) * step)
        splits = _cdiv(nkt, per)
    per_block = 1
    if bm == MMA_BM and bands > 1:
        groups = max(1, min(bands // 2, sms // (e * stripes * splits)))
        per_block = _cdiv(bands, groups)
    return Plan(bm, splits, per, span, per_block,
                "mma" if bm == MMA_BM else "simt")


def decode_smem_bytes(tile_k: int, slots: int, warps: int,
                      m: int = DECODE_M) -> int:
    """Shared memory of one decode-kernel block at M = ``m`` (csrc:
    ``launch``): per warp of the plan, its partial sums (rpb rows × H
    column groups × the block's rows of x: 4, or 16 above 4) and Σx (4 ×
    those rows), and at M ≤ 4 and tile_k ≥ 32 per warp its x tile (4 × 8 ×
    16 pieces of 8 bytes; above 4 rows x is read through L1)."""
    rpb = 4 * slots // tile_k
    groups = tile_k // 128 if tile_k >= 128 else 1
    rows = DECODE_M if m <= DECODE_M else DECODE_MAX_M
    xs = DECODE_M * 8 * 16 * 8 if tile_k >= 32 and m <= DECODE_M else 0
    return warps * ((rpb * groups + 4) * rows * 4 + xs)


def decode_threads(warps: int, m: int) -> int:
    """Threads of a decode-kernel block: the plan's warps at M ≤ 4, at
    most DECODE_ROW_WARPS of them at M 5–16 (each then walks the K tiles
    of several of the plan's warps in turn)."""
    return 32 * (warps if m <= DECODE_M else min(warps, DECODE_ROW_WARPS))


def launch_grid(plan: Plan, m: int, n: int, tile_k: int, slots: int,
                e: int) -> dict:
    """The grid and block size the C side launches for ``plan`` (csrc:
    ``launch``): the decode kernel one block per row group (E · N/tile_n ·
    bpt of them), the others (stripes, row bands, E · splits)."""
    if plan.kernel == "decode":
        return {"kernel": "decode", "grid": [e * n * tile_k // (4 * slots),
                                             1, 1],
                "threads": decode_threads(plan.warps, m),
                "smem_bytes": decode_smem_bytes(tile_k, slots, plan.warps,
                                                m)}
    rows = _cdiv(_cdiv(m, plan.bm), plan.bands_per_block)
    return {"kernel": plan.kernel,
            "grid": [_cdiv(n, MAX_TILE_N), rows, e * plan.splits],
            "threads": 512 if plan.kernel == "mma" else 256}


def work(m: int, n: int, k: int, *, codes, literals, lut, scale, zero,
         e: int = 1, out_dtype=torch.bfloat16,
         literal_bytes: int | None = None) -> tuple:
    """(FLOPs, bytes) of one launch over E products (M, K) × (K, N):
    2·E·M·N·K operations; x read once as bf16 (the kernel's operand), the
    codes, the literals, the LUT, scale and zero read once, the output
    written once.  ``literal_bytes``: the literal rows the blocks use,
    where the data is known (4 × Σ nlit); by default the whole literal
    plane, as a plan, which has no data, counts it.  A dry run's plan
    (``launch/dryrun.py``) and ``chip_smoke.py``'s bounds count by it."""
    def nbytes(t):
        return t.numel() * t.element_size()
    lits = nbytes(literals) if literal_bytes is None else literal_bytes
    return (2 * e * m * n * k,
            2 * e * m * k + nbytes(codes) + lits + nbytes(lut)
            + nbytes(scale) + nbytes(zero) + e * m * n * out_dtype.itemsize)


def grouped_fused_decode_matmul_plain(x, codes, literals, lut, scale, zero,
                                      *, shape, tile_n: int, tile_k: int,
                                      out_dtype=torch.float32
                                      ) -> torch.Tensor:
    """Plain version of K3: :func:`fused_decode_matmul_plain`'s strip scan
    for every expert at once (the reference's oracle vmaps K1's strip scan
    over the expert axis, ``repro.kernels.ref.grouped_fused_decode_matmul``).
    x (E, M, K); planes (E, nb, slots) / (E, nb, cap, 4); scale/zero
    (E, N, 1) → (E, M, N)."""
    n, k = shape
    e, m = x.shape[0], x.shape[1]
    nnt, nkt = n // tile_n, k // tile_k
    nb, slots = codes.shape[1], codes.shape[2]
    bpt = nb // (nnt * nkt)
    cap, s = literals.shape[2], literals.shape[3]
    codes_s = codes.reshape(e, nnt, nkt, bpt, slots)
    lits_s = literals.reshape(e, nnt, nkt, bpt, cap, s)
    xf = x.to(torch.float32)
    acc = torch.zeros((e, m, n), dtype=torch.float32, device=x.device)
    for kt in range(nkt):
        q = decode_blocked(codes_s[:, :, kt].reshape(-1, slots),
                           lits_s[:, :, kt].reshape(-1, cap, s), lut)
        q = q.reshape(e, n, tile_k).to(torch.float32)
        acc = acc + torch.bmm(xf[:, :, kt * tile_k:(kt + 1) * tile_k],
                              q.transpose(1, 2))
    sumx = xf.sum(dim=2, keepdim=True)
    y = scale.reshape(e, 1, n) * (acc - sumx * zero.reshape(e, 1, n))
    return y.to(out_dtype)


def _launch(name, x, codes, literals, lut, scale, zero, *, shape, tile_n,
            tile_k, out_dtype, plan_experts=None, groups: int = 1,
            fn=None, decode: bool = False, plan_n: int | None = None):
    """Check the operands and launch the kernel for E = x.shape[0] weights
    of one shape: x (E, M, K), codes (E, nb, slots), literals
    (E, nb, cap, 4), scale/zero E·N values → (E, M, N).  The launch is
    planned for ``plan_experts`` weights (default E), so that a stack
    holding some of a layer's experts sums each expert's rows in the order
    the whole stack would.  ``groups``: K1's column groups, a weight's nb
    blocks being ``groups`` sub-weights' planes of (N, K/groups) one after
    another.  ``fn``: another build's C entry (tools/profile_decode.py's
    design variants).  ``decode``: the rows are a decode step's
    (:func:`launch_plan`); above 16 they run in groups of 16, a launch
    each, straight into ``out`` (K1) or, an expert stack's group being
    strided along M, through a buffer of the group's rows (K3).
    ``plan_n``: the output width the launch is planned for (default N): a
    mesh rank's out-band of a weight passes the whole weight's N, so that
    each column's products are summed in the order the whole weight's
    launch sums them."""
    dev = _build.cuda_args(x, codes, literals, lut, scale, zero)
    n, k = shape
    e, m = x.shape[0], x.shape[1]
    if x.ndim != 3 or x.shape[2] != k:
        raise ValueError(f"{name}: x {tuple(x.shape)} against weight {shape}")
    if groups < 1 or k % groups:
        raise ValueError(f"{name}: {groups} column groups of {shape}")
    check_tiles(name, (n, k // groups), tile_n, tile_k)
    if codes.ndim != 3 or codes.shape[0] != e:
        raise ValueError(f"{name}: codes {tuple(codes.shape)} for {e} "
                         "weight(s)")
    nb, slots = codes.shape[1], codes.shape[2]
    nnt, nkt = n // tile_n, k // tile_k
    bpt = nb // (nnt * nkt)
    if (codes.dtype != torch.int16 or literals.dtype != torch.uint8
            or lut.dtype != torch.uint8 or scale.dtype != torch.float32
            or zero.dtype != torch.float32):
        raise TypeError(f"{name}: planes must be int16 codes, uint8 "
                        "literals/lut and f32 scale/zero")
    if (literals.ndim != 4 or literals.shape[:2] != (e, nb)
            or literals.shape[3] != 4 or lut.ndim != 2 or lut.shape[1] != 4
            or bpt * nnt * nkt != nb or bpt * slots * 4 != tile_n * tile_k
            or scale.numel() != e * n or zero.numel() != e * n):
        raise ValueError(f"{name}: planes codes {tuple(codes.shape)}, "
                         f"literals {tuple(literals.shape)} do not tile "
                         f"{shape} by {(tile_n, tile_k)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: out_dtype must be bf16 or f32")
    for what, t in (("codes", codes), ("literals", literals), ("lut", lut),
                    ("scale", scale), ("zero", zero)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if _build.PLAN is None and (codes.data_ptr() % 16
                                or literals.data_ptr() % 4
                                or lut.data_ptr() % 4):
        raise ValueError(f"{name}: codes (read 16 bytes at a time), "
                         "literals and lut (read as uint32) must start on "
                         "a 16-, 4- and 4-byte boundary")
    xb = x.to(torch.bfloat16).contiguous()
    out = torch.empty((e, m, n), dtype=out_dtype, device=dev)
    if m == 0 or e == 0:
        return out
    pe, sms = plan_experts or e, _build.sm_count(dev)
    pn = plan_n or n
    plan = launch_plan(m, pn, k, tile_k, pe, sms, slots, decode)
    if _build.PLAN is None:
        fn = fn or _build.function(NAME, "qmoe_fused_decode_matmul",
                                   _ARGTYPES)
    rows = DECODE_MAX_M if plan.row_groups > 1 else m
    for r in range(0, m, rows):
        mg = min(rows, m - r)
        xg, og = xb[:, r:r + mg], out[:, r:r + mg]
        strided = mg < m and e > 1    # an expert stack's row group
        if strided:
            xg = xg.contiguous()
            og = torch.empty((e, mg, n), dtype=out_dtype, device=dev)
        # the tensor-core path loads x 16 B at a time
        if _build.PLAN is None and xg.data_ptr() % 16:
            xg = xg.clone()
        _launch_rows(name, fn, plan if mg == m else launch_plan(
            mg, pn, k, tile_k, pe, sms, slots), xg, codes, literals, lut,
            scale, zero, og, e=e, m=mg, n=n, k=k, tile_n=tile_n,
            tile_k=tile_k, bpt=bpt, groups=groups)
        if strided:
            out[:, r:r + mg].copy_(og)
    return out


def _launch_rows(name, fn, plan: Plan, xb, codes, literals, lut, scale, zero,
                 out, *, e, m, n, k, tile_n, tile_k, bpt, groups):
    """One launch of ``plan`` (at most 16 rows where it is a decode step's
    row group) on checked operands: xb (E, m, K) bf16 and out (E, m, N),
    each contiguous."""
    dev, slots = xb.device, codes.shape[2]
    nnt = n // tile_n
    splits = plan.splits
    if e * splits > MAX_GRID_Z:
        raise ValueError(f"{name}: {e} weights × {splits} K splits exceed "
                         f"the grid's z extent {MAX_GRID_Z}")
    if plan.kernel == "decode" and e * nnt * bpt > MAX_GRID_X:
        raise ValueError(f"{name}: {e * nnt * bpt} row groups exceed the "
                         f"grid's x extent {MAX_GRID_X}")
    if plan.kernel == "decode" and (bpt & (bpt - 1)
                                    or (4 * slots // tile_k) & (
                                        4 * slots // tile_k - 1)):
        raise ValueError(f"{name}: the decode kernel takes a power-of-two "
                         f"count of blocks a tile and of columns a block, "
                         f"got {bpt} blocks of {slots} slots at tile_k "
                         f"{tile_k}")
    part = sx = None
    if splits > 1:
        part = torch.empty(e * splits * m * n, dtype=torch.float32,
                           device=dev)
        sx = torch.empty(e * splits * m, dtype=torch.float32, device=dev)
    if _build.PLAN is not None:        # a dry run: planned, not launched
        _build.PLAN.launch(f"{name}:{plan.kernel}", work(
            m, n, k, codes=codes, literals=literals, lut=lut, scale=scale,
            zero=zero, e=e, out_dtype=out.dtype))
    else:
        err = fn(xb.data_ptr(), codes.data_ptr(), literals.data_ptr(),
                 lut.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                 out.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 sx.data_ptr() if sx is not None else None,
                 int(out.dtype == torch.bfloat16), e, m, n, k, tile_n,
                 tile_k, slots, literals.shape[2], bpt, groups, splits,
                 plan.tiles_per_split, plan.bm, plan.span,
                 plan.bands_per_block, plan.warps if plan.kernel == "decode"
                 else 0, dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, name)
    _build.LAUNCH_COUNTS[name] += 1
    _build.KERNEL_COUNTS[f"{name}:{plan.kernel}"] += 1


def fused_decode_matmul(x, codes, literals, lut, scale, zero, *, shape,
                        tile_n: int, tile_k: int,
                        out_dtype=torch.bfloat16,
                        decode: bool = False,
                        plan_n: int | None = None) -> torch.Tensor:
    """K1: y = x @ dequant(decode(codes, literals)).T without a dense
    weight.

    x: (M, K) float; codes int16 (uint16 bits) (nb, slots), literals uint8
    (nb, cap, 4), lut uint8 (n_codes + 1, 4): tile-major planes of the
    dense ``shape = (N, K)`` weight; scale/zero (N, 1) f32.  Column
    groups: codes (G, nb, slots) and literals (G, nb, cap, 4), group g the
    planes of the (N, K/G) sub-weight over x columns [g·K/G, (g+1)·K/G)
    (a ``TiledPackedLinear``), all G in one launch.  ``decode``: x's rows
    are a decode step's, each row its own request (:func:`launch_plan`).
    ``plan_n``: the N the launch is planned for (:func:`_launch`; a mesh
    rank's out-band passes the whole weight's).  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.
    """
    if x.device.type == "cpu":
        return fused_decode_matmul_plain(
            x, codes, literals, lut, scale, zero, shape=shape,
            tile_n=tile_n, tile_k=tile_k, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {x.device}")
    if x.ndim != 2 or codes.ndim not in (2, 3) \
            or literals.ndim != codes.ndim + 1:
        raise ValueError(f"{NAME}: x {tuple(x.shape)}, codes "
                         f"{tuple(codes.shape)}, literals "
                         f"{tuple(literals.shape)}: one weight's 2-D planes "
                         "or (G, ...) column groups, and a 2-D x")
    groups = codes.shape[0] if codes.ndim == 3 else 1
    if not (codes.is_contiguous() and literals.is_contiguous()):
        raise ValueError(f"{NAME}: codes and literals must be contiguous")
    return _launch(NAME, x[None], codes.reshape(1, -1, codes.shape[-1]),
                   literals.reshape((1, -1) + tuple(literals.shape[-2:])),
                   lut, scale, zero, shape=shape, tile_n=tile_n,
                   tile_k=tile_k, out_dtype=out_dtype, groups=groups,
                   decode=decode, plan_n=plan_n)[0]


def grouped_fused_decode_matmul(x, codes, literals, lut, scale, zero, *,
                                shape, tile_n: int, tile_k: int,
                                out_dtype=torch.bfloat16,
                                plan_experts: int | None = None,
                                decode: bool = False) -> torch.Tensor:
    """K3: y[e] = x[e] @ dequant(decode(codes[e], literals[e])).T for every
    expert of a stacked weight, in one launch.

    x: (E, M, K) float (the capacity-gathered token blocks); codes int16
    (E, nb, slots), literals uint8 (E, nb, cap, 4) with one literal
    capacity for the stack, lut shared; scale/zero (E, N, 1) f32.
    → (E, M, N).  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise.

    ``plan_experts``: the expert count the launch is planned for (default
    E).  :func:`launch_plan` picks the decode kernel's warps and the other
    kernels' K splits from E, and those fix the order in which an expert's
    products are summed; a tiered-residency cache stack of C of a layer's
    experts passes the layer's expert count, so each expert's rows are
    bitwise those of the whole stack whatever C and the expert's slot."""
    if x.device.type == "cpu":
        return grouped_fused_decode_matmul_plain(
            x, codes, literals, lut, scale, zero, shape=shape,
            tile_n=tile_n, tile_k=tile_k, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{GROUPED_NAME}: no kernel for device {x.device}")
    return _launch(GROUPED_NAME, x, codes, literals, lut, scale, zero,
                   shape=shape, tile_n=tile_n, tile_k=tile_k,
                   out_dtype=out_dtype, plan_experts=plan_experts,
                   decode=decode)
