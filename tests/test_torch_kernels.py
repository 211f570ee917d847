"""The kernels' plain PyTorch versions against the JAX package.

Each kernel module of the port holds a CUDA kernel and its plain version;
on the CPU the wrapper runs the plain version.  The same inputs, made from
a seed with numpy, go through ``repro.kernels.ref`` and through the Pallas
kernel bodies in interpret mode (``impl="pallas_interpret"``).

Tolerances:
  * the dictionary decode is integer work: bitwise.
  * integer-valued f32 x: every product and partial sum is an exact
    integer in f32, so the affine epilogue sees identical numbers —
    bitwise, except against ``ref.dequant_matmul``, which dequantizes the
    weight before the product (another rounding order): 1e-5.
  * random f32 x: f32 sums in another order, rtol = atol = 1e-5, the atol
    taken relative to the output's largest magnitude for the two matmuls:
    their epilogue s·(Σx·q − z·Σx) subtracts two sums of size ~128·Σ|x|,
    so f32 roundoff there is absolute, not relative to each output.  The
    Pallas kernels round x to bf16 before the product, so x is made
    bf16-representable for those comparisons.
  * the card's tensor-core attention, emulated here (P split into bf16
    hi + lo for P·V), on bf16 inputs with a bf16 output: the card tests'
    1.6e-2.  Its f32 kernel, emulated here too (three TF32 products), on
    f32 inputs: K2's f32 tolerance, 1e-4.
"""
import itertools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import blocked_codec as jbc
from repro.core import codec as jcodec
from repro.core.compressed import pack_expert_stack as jpack_expert_stack
from repro.core.compressed import pack_linear
from repro.core.compressed import quantize_linear as jquantize_linear
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash

from repro_torch.core.blocked_codec import decode_blocked
from repro_torch.kernels import _build, ops
from repro_torch.kernels import dequant_matmul as dqm
from repro_torch.kernels.dequant_matmul import (dequant_matmul,
                                                dequant_matmul_plain)
from repro_torch.kernels import dict_decode as ddc
from repro_torch.kernels.dict_decode import dict_decode, dict_decode_plain
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels import fused_decode_matmul as fdm
from repro_torch.kernels.fused_decode_matmul import (
    fused_decode_matmul, fused_decode_matmul_plain,
    grouped_fused_decode_matmul, grouped_fused_decode_matmul_plain)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def assert_close_scaled(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.fixture(autouse=True)
def _clear_counts():
    _build.LAUNCH_COUNTS.clear()
    yield
    assert not _build.LAUNCH_COUNTS, "a CPU call launched a kernel"


def _x(rng, m, k, kind):
    if kind == "int":
        return rng.integers(-4, 5, (m, k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if kind == "bf16":      # what the Pallas kernels see after their cast
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _packed(shape, seed, block_weights=4096):
    """A tile-major reference PackedLinear with a non-empty table, and the
    same planes as torch tensors."""
    rng = np.random.default_rng(seed)
    w = np.round(rng.standard_normal(shape) * 3).astype(np.float32) / 3
    from repro.core.compressed import quantize_linear
    vals = np.asarray(quantize_linear(jnp.asarray(w)).values)
    table = jcodec.find_frequent_sequences([vals])
    lut = jbc.build_lut(table)
    pl = pack_linear(jnp.asarray(w), table, lut,
                     block_weights=block_weights, tile="auto")
    t = {"codes": torch.from_numpy(np.array(pl.codes).view(np.int16)),
         "literals": torch.from_numpy(np.array(pl.literals)),
         "lut": torch.from_numpy(np.array(lut)),
         "scale": torch.from_numpy(np.array(pl.scale)),
         "zero": torch.from_numpy(np.array(pl.zero))}
    return pl, lut, t


@pytest.mark.parametrize("shape,m,bw", [
    ((64, 64), 3, 4096), ((96, 160), 5, 1024), ((256, 128), 16, 4096),
    ((32, 48), 7, 256),
    ((128, 130), 4, 4096),     # tile_k 2: a gram spans two rows of a tile
    ((128, 131), 5, 4096),     # tile_k 1: a gram spans four
])
@pytest.mark.parametrize("kind", ["int", "float", "bf16"])
def test_fused_decode_matmul_plain(shape, m, bw, kind):
    pl, lut, t = _packed(shape, 0, bw)
    x = _x(np.random.default_rng(1), m, shape[1], kind)
    kw = dict(shape=shape, tile_n=pl.tile_n, tile_k=pl.tile_k,
              out_dtype=torch.float32)
    got = fused_decode_matmul(torch.from_numpy(x), t["codes"],
                              t["literals"], t["lut"], t["scale"],
                              t["zero"], **kw).numpy()
    np.testing.assert_array_equal(
        got, fused_decode_matmul_plain(
            torch.from_numpy(x), t["codes"], t["literals"], t["lut"],
            t["scale"], t["zero"], **kw).numpy())
    ref = np.asarray(jref.fused_decode_matmul(
        jnp.asarray(x), pl.codes, pl.literals, pl.nlit, jnp.asarray(lut),
        pl.scale, pl.zero, shape=shape, tile_n=pl.tile_n, tile_k=pl.tile_k))
    if kind == "int":
        np.testing.assert_array_equal(got, ref)
    else:
        assert_close_scaled(got, ref)
    if kind == "float":
        return                       # the Pallas kernel rounds x to bf16
    pallas = np.asarray(jops.decode_dequant_matmul(
        jnp.asarray(x), pl, jnp.asarray(lut), out_dtype=jnp.float32,
        impl="pallas_interpret"))
    if kind == "int":
        np.testing.assert_array_equal(got, pallas)
    else:
        assert_close_scaled(got, pallas)


@pytest.mark.parametrize("n,k,m", [(211, 64, 5), (130, 520, 3), (64, 64, 16)])
@pytest.mark.parametrize("kind", ["int", "float", "bf16"])
def test_dequant_matmul_plain(n, k, m, kind):
    rng = np.random.default_rng(2)
    wq = rng.integers(0, 256, (n, k)).astype(np.uint8)
    scale = (rng.random((n, 1)) * 0.02 + 1e-3).astype(np.float32)
    zero = rng.integers(0, 256, (n, 1)).astype(np.float32)
    x = _x(rng, m, k, kind)
    args = [torch.from_numpy(a) for a in (x, wq, scale, zero)]
    got = dequant_matmul(*args, out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(
        got, dequant_matmul_plain(*args, torch.float32).numpy())
    ref = np.asarray(jref.dequant_matmul(*map(jnp.asarray,
                                              (x, wq, scale, zero))))
    assert_close_scaled(got, ref)
    if kind == "float":
        return
    pallas = np.asarray(jops.dequant_matmul(
        *map(jnp.asarray, (x, wq, scale, zero)), impl="pallas_interpret"))
    if kind == "int":
        np.testing.assert_array_equal(got, pallas)
    else:
        assert_close_scaled(got, pallas)


# (N, K) of every K5 call in quant mode: Llama-3.2-1B's q/o, k/v,
# gate/up, down and tied head; DeepSeek-V2-Lite's wq, wkv_a, wo, dense
# gate/up and down, shared experts' gate/up and down, and head; each at
# decode (1, 4), the cut (5, 16, 32) and prefill M (175, 700)
K5_MODEL_SHAPES = ((2048, 2048), (512, 2048), (8192, 2048), (2048, 8192),
                   (128256, 2048), (3072, 2048), (576, 2048),
                   (10944, 2048), (2048, 10944), (2816, 2048),
                   (2048, 2816), (102400, 2048))
K5_MODEL_M = (1, 4, 5, 16, 32, 175, 700)


@pytest.mark.parametrize("m,n,k", [
    (4, 128256, 2048),   # Llama-3.2-1B's tied head at decode batch
    (1, 102400, 2048),   # DeepSeek-V2-Lite's head
    (3, 1003, 2048),     # ragged N
    (2, 37, 48),         # K not a whole stage
    (4, 64, 16),         # one 16-column piece
    (4, 8, 28672),       # the widest K a block's shared memory holds
    (4, 130, 100),       # K % 16 != 0: the SIMT kernel
    (5, 128256, 2048),   # M > 4: the decode kernel, 2 row groups
    (17, 128256, 2048),  # the tensor-core kernel (full logits)
    (700, 1000, 512),    # prefill rows
    (40, 130, 100),      # K % 16 != 0 at prefill M: the SIMT kernel
    (4, 211, 0),         # K = 0: the SIMT kernel writes the epilogue
    (9, 211, 0),
    (1, 4096, 10944),
] + [(m, n, k) for n, k in K5_MODEL_SHAPES for m in K5_MODEL_M
     if (m, n, k) not in ((4, 128256, 2048), (1, 102400, 2048),
                          (5, 128256, 2048))])
@pytest.mark.parametrize("sms", [132, 114])      # H100 SXM, H100 PCIe
def test_dequant_plan(m, n, k, sms):
    """K5's launch plan, a pure function of the shapes: the decode kernel
    exactly at M ≤ 16 with K a positive multiple of 16, one launch a group
    of 4 rows (16-byte rows; the
    wrapper refuses a wq off a 16-byte boundary for every kernel), each
    output row in exactly one warp task and each task in exactly one warp
    of the grid, and the grid, block and shared memory within what the
    card takes.  From MMA_MIN_M rows on, the same K: the tensor-core
    kernel, 128 × 128 tiles, K split only where the tiles leave SMs idle
    and then within one block an SM, every 64-column step in exactly one
    split, no split empty.  Else the SIMT kernel: every K chunk in
    exactly one split, no split empty."""
    plan = dqm.dequant_plan(m, n, k, sms)
    vec = k > 0 and k % 16 == 0
    assert plan.kernel == ("decode" if m < dqm.MMA_MIN_M and vec else "mma"
                           if vec else "simt")
    # one decode launch a group of 4 rows, each row's bits those of M = 1
    assert plan.row_groups == (-(-m // 4) if plan.kernel == "decode" else 1)
    assert plan.smem_bytes <= dqm.SMEM_MAX and plan.threads <= 1024
    assert 0 < plan.grid[0] <= dqm.MAX_GRID_X
    assert all(0 < g <= dqm.MAX_GRID_YZ for g in plan.grid[1:])
    if plan.kernel == "decode":
        rpw, warps = dqm.DECODE_ROWS, dqm.DECODE_WARPS
        assert plan.threads == 32 * warps
        assert plan.grid[1:] == (1, 1) and plan.splits == 1
        assert plan.smem_bytes == dqm.decode_smem_bytes(k)
        assert plan.smem_bytes >= 4 * 2 * k        # x, staged once
        # no more warps than the card holds at once, and no fewer than
        # take the tasks in the same number of rounds
        tasks = -(-n // rpw)
        nw = plan.grid[0] * warps
        rounds = -(-tasks // nw)
        assert plan.grid[0] <= sms * dqm.DECODE_BLOCKS_PER_SM
        assert (plan.grid[0] - 1) * warps * rounds < tasks
        owner = np.full(tasks, -1)
        for gw in range(nw):                 # warp gw: tasks gw, gw + nw...
            mine = np.arange(gw, tasks, nw)
            assert (owner[mine] == -1).all()
            owner[mine] = gw
        assert (owner >= 0).all()
        rows = (np.arange(tasks)[:, None] * rpw + np.arange(rpw)).ravel()
        assert np.array_equal(rows[rows < n], np.arange(n))
    elif plan.kernel == "mma":
        stripes, bands, splits = plan.grid
        assert (stripes, bands) == (-(-n // dqm.MMA_BN), -(-m // dqm.MMA_BM))
        assert plan.threads == dqm.MMA_THREADS and plan.splits == splits
        assert plan.smem_bytes == dqm.mma_smem_bytes()
        tiles = stripes * bands
        assert splits == 1 or (tiles * splits <= sms and 2 * tiles <= sms)
        steps = -(-k // dqm.MMA_STEP_K)
        per = -(-steps // splits)
        assert (splits - 1) * per < steps <= splits * per
    else:
        rpt = 2 if m <= 4 else 8
        assert plan.rpt == rpt and plan.threads == 256
        assert plan.grid == (-(-n // 128), -(-m // (2 * rpt)), plan.splits)
        nkc = -(-k // dqm.KC)
        per = -(-nkc // plan.splits)
        assert plan.splits == 1 or (plan.splits - 1) * per < nkc
        assert plan.splits * per >= nkc


def _dequant_decode_emulation(x, wq, scale, zero, sms=132):
    """The work split of the card's K5 decode kernel, emulated in f32
    torch.  Above 4 rows the wrapper launches it once a group of 4 rows
    (the plan's ``row_groups``), so the rows are those groups' outputs one
    after another.  At M ≤ 4, emulated in
    f32 torch.  Warp gw of the grid takes tasks gw, gw + (warps in the
    grid), ...; task t is weight rows 8t .. 8t + 7 over all of K, walked
    in 64-column slices.  In slice sl, lane (gid, tig) holds 16 bytes of
    row 8t + gid at columns 64·sl + 16·tig ..;
    word u of them is its B fragment of mma u: K slots 2·tig, 2·tig + 1,
    2·tig + 8, 2·tig + 9 = the word's 4 columns.  A row r < 4 holds x[r]
    at each slot's column, rows 4–15 zero.  C accumulates over (sl, u) in
    order.  Σx: thread T of a block sums its 16-byte pieces T, T + 256,
    ... of each row (each piece's bf16 pairs in order), the warp by an xor
    butterfly, the warps in order.  Then the affine epilogue."""
    m, k = x.shape
    n = wq.shape[0]
    plan = dqm.dequant_plan(m, n, k, sms)
    assert plan.kernel == "decode" and plan.row_groups == -(-m // 4)
    if m > 4:
        return torch.cat([_dequant_decode_emulation(x[r:r + 4], wq, scale,
                                                    zero, sms)
                          for r in range(0, m, 4)])
    rpw, warps, blocks = dqm.DECODE_ROWS, dqm.DECODE_WARPS, plan.grid[0]
    cols = dqm.DECODE_STAGE_COLS                     # columns a stage
    kpad = -(-k // cols) * cols
    tasks = -(-n // rpw)
    xb = torch.zeros((4, kpad))
    xb[:m, :k] = x.to(torch.bfloat16).float()
    wp = torch.zeros((tasks * rpw, kpad))
    wp[:n, :k] = wq.float()
    wt = wp.reshape(tasks, rpw, kpad)                # (task, row, col)
    # the slot order: slot 2·tig + (c & 1) + 8·(c >> 1) holds column 4u + c
    # of lane tig's word u
    slot_col = torch.empty(16, dtype=torch.long)
    for tig in range(4):
        for c in range(4):
            slot_col[2 * tig + (c & 1) + 8 * (c >> 1)] = 16 * tig + c
    acc = torch.zeros((tasks, 16, 8))
    for sl in range(kpad // 64):
        for u in range(4):
            kc = 64 * sl + 4 * u + slot_col                      # (16,)
            a = torch.zeros((16, 16))
            a[:4] = xb[:, kc]
            b = wt[:, :, kc].transpose(1, 2)                     # (t, 16, 8)
            acc = acc + torch.matmul(a, b)
    # Σx, in the kernel's order
    threads = 32 * warps
    pieces = kpad // 8
    part = torch.zeros((threads, 4))
    for c0 in range(0, pieces, threads):
        cs = torch.arange(c0, min(c0 + threads, pieces))
        v = xb[:, (cs[:, None] * 8 + torch.arange(8)).ravel()].reshape(
            4, -1, 4, 2)
        s = torch.zeros((4, len(cs)))
        for e in range(4):
            s = s + (v[:, :, e, 0] + v[:, :, e, 1])
        part[cs - c0] = part[cs - c0] + s.T
    lanes = part.reshape(warps, 32, 4)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32) ^ off]
    sx = torch.zeros(4)
    for w in range(warps):
        sx = sx + lanes[w, 0]
    # warp gw of the grid runs tasks gw, gw + (warps in the grid), ...;
    # C[gid][col] of task t is y[gid] at row 8t + col
    assert blocks * warps >= min(tasks, 1)
    y = acc[:, :4].permute(1, 0, 2).reshape(4, tasks * rpw)[:m, :n]
    return scale.reshape(1, -1) * (y - sx[:m, None] * zero.reshape(1, -1))


@pytest.mark.parametrize("m,n,k", [
    (1, 37, 64), (2, 203, 512), (3, 130, 1040), (4, 257, 2048),
    (4, 9, 48),
    (5, 203, 512), (8, 37, 64), (13, 130, 1040), (16, 257, 2048),
])
@pytest.mark.parametrize("kind", ["int", "bf16"])
def test_dequant_decode_decomposition(m, n, k, kind):
    """K5's decode-kernel work split (``_dequant_decode_emulation``) is
    bitwise equal to the plain version and to the reference's Pallas
    kernel (interpret mode) on integer-valued x, and within
    assert_close_scaled of both on bf16 x — at M = 1–16 (above 4, one
    launch a group of 4 rows), N ragged against the 8-row tasks, K ragged
    against the stages.  On bf16 x each row is bitwise the emulation of
    that row alone."""
    rng = np.random.default_rng(11)
    wq = rng.integers(0, 256, (n, k)).astype(np.uint8)
    scale = (rng.random((n, 1)) * 0.02 + 1e-3).astype(np.float32)
    zero = rng.integers(0, 256, (n, 1)).astype(np.float32)
    x = _x(rng, m, k, kind)
    args = [torch.from_numpy(a) for a in (x, wq, scale, zero)]
    got = _dequant_decode_emulation(*args).numpy()
    plain = dequant_matmul_plain(*args, torch.float32).numpy()
    pallas = np.asarray(jops.dequant_matmul(
        *map(jnp.asarray, (x, wq, scale, zero)), impl="pallas_interpret"))
    if kind == "int":
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, pallas)
    else:
        assert_close_scaled(got, plain)
        assert_close_scaled(got, pallas)
        for i in range(m):
            np.testing.assert_array_equal(got[i:i + 1], (
                _dequant_decode_emulation(args[0][i:i + 1], *args[1:])
                .numpy()))


def test_ops_flatten_leading_dims():
    pl, lut, t = _packed((64, 64), 3)
    from repro_torch.core.compressed import PackedLinear
    tpl = PackedLinear(t["codes"], t["literals"], None, t["scale"],
                       t["zero"], shape=(64, 64), tile_n=pl.tile_n,
                       tile_k=pl.tile_k)
    x = torch.from_numpy(_x(np.random.default_rng(4), 6, 64, "int"))
    y3 = ops.decode_dequant_matmul(x.reshape(2, 3, 64), tpl, t["lut"],
                                   out_dtype=torch.float32)
    y2 = ops.decode_dequant_matmul(x, tpl, t["lut"], out_dtype=torch.float32)
    assert torch.equal(y3.reshape(6, 64), y2)
    assert ops.DISPATCH_COUNTS["fused"] >= 2
    # the same weight in the linear layout (tile_n == 0) is served by the
    # two-step path (decode, then K5's product): the same exact products
    # on integer x, so the same bits
    w = np.round(np.random.default_rng(3).standard_normal((64, 64)) * 3
                 ).astype(np.float32) / 3
    table = jcodec.find_frequent_sequences([np.asarray(
        jquantize_linear(jnp.asarray(w)).values)])
    lin = pack_linear(jnp.asarray(w), table, jbc.build_lut(table), tile=None)
    assert lin.tile_n == 0
    linear = PackedLinear(torch.from_numpy(np.array(lin.codes).view(np.int16)),
                          torch.from_numpy(np.array(lin.literals)), None,
                          t["scale"], t["zero"], shape=(64, 64))
    y_lin = ops.decode_dequant_matmul(
        x, linear, torch.from_numpy(np.array(jbc.build_lut(table))),
        out_dtype=torch.float32)
    assert torch.equal(y_lin, y2)
    assert ops.DISPATCH_COUNTS["unfused"] == 1


def _planes(pl):
    """A reference PackedLinear's planes as the port's tensors."""
    return (torch.from_numpy(np.array(pl.codes).view(np.int16)),
            torch.from_numpy(np.array(pl.literals)),
            torch.from_numpy(np.array(pl.scale)),
            torch.from_numpy(np.array(pl.zero)))


@pytest.mark.parametrize("e,n,k,m", [
    (3, 64, 128, 8),     # prime E, tile-multiple dims
    (5, 48, 64, 13),     # prime E, odd cap
    (7, 24, 96, 130),    # prime E, cap > 128 with remainder
])
@pytest.mark.parametrize("kind", ["int", "bf16"])
def test_grouped_fused_decode_matmul_plain(e, n, k, m, kind):
    """K3's plain version against the reference's oracle (K1's strip scan
    vmapped over experts) and the grouped Pallas kernel, at the shapes of
    tests/test_moe_fused.py."""
    rng = np.random.default_rng(8)
    ws = [rng.laplace(0.0, 0.02, size=(n, k)).astype(np.float32)
          for _ in range(e)]
    pl, lut = jpack_expert_stack(ws)
    codes, lits, scale, zero = _planes(pl)
    tlut = torch.from_numpy(np.array(lut))
    x = np.stack([_x(rng, m, k, kind) for _ in range(e)])
    kw = dict(shape=tuple(pl.shape), tile_n=pl.tile_n, tile_k=pl.tile_k)
    got = grouped_fused_decode_matmul(torch.from_numpy(x), codes, lits, tlut,
                                      scale, zero, **kw,
                                      out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, grouped_fused_decode_matmul_plain(
        torch.from_numpy(x), codes, lits, tlut, scale, zero, **kw).numpy())
    for j in (0, e - 1):     # each expert is K1's plain version
        np.testing.assert_array_equal(got[j], fused_decode_matmul_plain(
            torch.from_numpy(x[j]), codes[j], lits[j], tlut, scale[j],
            zero[j], **kw).numpy())
    ref = np.asarray(jref.grouped_fused_decode_matmul(
        jnp.asarray(x), pl.codes, pl.literals, pl.nlit, lut, pl.scale,
        pl.zero, **kw))
    if kind == "bf16":
        assert_close_scaled(got, ref)
        return
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(
        jops.grouped_decode_dequant_matmul(
            jnp.asarray(x), pl, lut, impl="pallas_interpret",
            out_dtype=jnp.float32)))


@pytest.mark.parametrize("m,n,k,tile_k,e", [
    (700, 2048, 2048, 512, 1),    # Llama-3.2-1B wq, wo
    (700, 512, 2048, 512, 1),     # wk, wv
    (700, 8192, 2048, 512, 1),    # w_gate, w_up
    (700, 2048, 8192, 512, 1),    # w_down
    (700, 3072, 2048, 512, 1),    # DeepSeek-V2-Lite MLA wq
    (700, 576, 2048, 512, 1),     # MLA wkv_a (tile_n 64)
    (700, 2816, 2048, 512, 1),    # shared experts' gate, up
    (700, 2048, 2816, 256, 1),    # shared experts' down
    (700, 10944, 2048, 512, 1),   # first layer's gate, up
    (700, 2048, 10944, 64, 1),    # first layer's down: 171 tiles of 64
    (83, 1408, 2048, 512, 64),    # expert stack gate/up at prefill cap
    (83, 2048, 1408, 128, 64),    # expert stack down
    (129, 2048, 2048, 512, 1),    # one row past a band
    (129, 2048, 10944, 64, 1),
    (700, 256, 704, 64, 1),       # 11 tiles of 64: no multiple of the span
    (300, 1408, 2048, 512, 64),   # a cap of three bands
    (4, 8192, 2048, 512, 1),      # decode batch
    (83, 1408, 2048, 32, 64),     # tile_k 32 at prefill: tensor cores
    (4, 128, 130, 2, 1),          # tile_k 2 (K 2 mod 4) at decode
    (4, 2048, 10944, 64, 1),      # decode: 171 tiles, warps walk several
    (4, 1408, 2048, 512, 64),     # K3 at decode: 11 264 row groups
    (4, 2048, 1408, 128, 64),     # K3's down stack at decode
    (1, 576, 2048, 512, 1),       # MLA wkv_a (tile_n 64) at M = 1
    (3, 40, 72, 8, 1),            # tile_k 8 at decode: narrow rows
    (129, 128, 130, 2, 1),        # and past 16 rows
    (129, 128, 131, 1, 1),        # tile_k 1 (K odd)
    (83, 1408, 2050, 2, 64),      # an expert stack at tile_k 2
] + [(m, n, k, tile_k, e) for m in (1, 4, 5, 8, 16, 17, 130, 700)
     for n, k, tile_k, e in (
         (2048, 2048, 512, 1),     # Llama wq, wo
         (2048, 8192, 512, 1),     # w_down: 16 tiles
         (2048, 2816, 256, 1),     # DeepSeek shared experts' down
         (2048, 1408, 128, 64),    # expert stack down
         (256, 704, 64, 1),        # 11 tiles of 64
         (2048, 10944, 32, 1),     # the tiled first w_down's tiles (G = 2)
         (2048, 10944, 16, 1),     # ... at G = 4
         (128, 136, 8, 1),         # 17 tiles of 8
         (128, 132, 4, 1),         # K ≡ 4 mod 8
         (64, 2 * 17 * 32, 32, 3))]) # an odd tile count, three experts
@pytest.mark.parametrize("sms", [132, 114])      # H100 SXM, H100 PCIe
def test_launch_plan(m, n, k, tile_k, e, sms):
    """The fused kernels' launch plan: every K tile in exactly one split,
    the grid's z extent, a tensor-core span that fits a block's shared
    memory (and covers its split when a block walks several bands), and
    fewer decodes of each tile than 128-row bands of M; below tile_k 64,
    splits of whole 64-column steps.  At M ≤ 16 (tile_k ≥ 4) the decode
    kernel: one split, every tile in one block, a power of two of warps
    (or all the K tiles, at most 16) that keeps the grid's warps within one
    wave of the card — the same warps and grid at every M from 1 to 16,
    which fix the order of a row's sums — a grid of one block per row
    group within the x extent, and shared memory within what a block may
    take.  Above 16 rows the tensor-core kernel at every tile_k ≥ 4: the
    SIMT kernel only at tile_k 1 and 2 (or blocks past the decode
    kernel's limits)."""
    slots = min(min(n & -n, 128) * tile_k, 4096) // 4   # the packer's
    plan = fdm.launch_plan(m, n, k, tile_k, e, sms, slots)
    nkt = k // tile_k
    runs = [range(s * plan.tiles_per_split,
                  min((s + 1) * plan.tiles_per_split, nkt))
            for s in range(plan.splits)]
    assert all(len(r) for r in runs)
    assert [t for r in runs for t in r] == list(range(nkt))
    assert e * plan.splits <= fdm.MAX_GRID_Z
    assert plan.bm == fdm.block_rows(m, tile_k)
    bands = -(-m // 128)
    if plan.bm == fdm.MMA_BM:
        assert fdm.mma_smem_bytes(plan.span * tile_k) <= fdm.MMA_SMEM_MAX
        assert plan.span * tile_k <= fdm.SPAN_COLS
        if plan.bands_per_block > 1:
            assert plan.tiles_per_split <= plan.span
        # splits, and spans within a split, start on whole 64-column steps
        if plan.splits > 1:
            assert plan.tiles_per_split * tile_k % fdm.MMA_STEP_K == 0
        if plan.tiles_per_split > plan.span:
            assert plan.span * tile_k % fdm.MMA_STEP_K == 0
        if m > 128:             # decodes of each tile in one launch
            assert -(-bands // plan.bands_per_block) < bands
    else:
        assert plan.bands_per_block == 1
    grid = fdm.launch_grid(plan, m, n, tile_k, slots, e)
    if m <= fdm.DECODE_MAX_M and tile_k >= 4:
        assert plan.kernel == "decode" and grid["kernel"] == "decode"
        assert plan.splits == 1 and plan.tiles_per_split == nkt
        groups = grid["grid"][0]          # one block per row group
        fit = max(1, sms * fdm.DECODE_WARPS_PER_SM // groups)
        assert 1 <= plan.warps <= min(nkt, fdm.DECODE_MAX_WARPS)
        assert plan.warps == min(1 << (fit.bit_length() - 1), nkt,
                                 fdm.DECODE_MAX_WARPS)
        assert groups == e * n * tile_k // (4 * slots)
        # the warps and the grid are those of M = 1: no function of M
        one = fdm.launch_plan(1, n, k, tile_k, e, sms, slots)
        assert plan.warps == one.warps and grid["grid"] == fdm.launch_grid(
            one, 1, n, tile_k, slots, e)["grid"]
        assert grid["threads"] == 32 * (plan.warps if m <= fdm.DECODE_M
                                        else min(plan.warps,
                                                 fdm.DECODE_ROW_WARPS))
        assert grid["threads"] <= 512
        assert 0 < grid["grid"][0] <= fdm.MAX_GRID_X
        assert grid["smem_bytes"] == fdm.decode_smem_bytes(
            tile_k, slots, plan.warps, m)
        assert grid["smem_bytes"] <= fdm.MMA_SMEM_MAX
    else:
        assert plan.kernel == ("mma" if tile_k >= 4 and m > fdm.DECODE_MAX_M
                               else "simt")
        assert plan.kernel == ("mma" if plan.bm == fdm.MMA_BM else "simt")
        assert grid["grid"][2] == e * plan.splits <= fdm.MAX_GRID_Z
    assert fdm.launch_plan(m, n, k, tile_k, e, sms, 2048).kernel == (
        "mma" if m > fdm.DECODE_MAX_M and tile_k >= 4 else "simt")


@pytest.mark.parametrize("shape", [(128, 130), (256, 6), (1408, 2050),
                                   (128, 131), (64, 130)])
def test_small_tile_k_is_in_the_kernels_range(shape):
    """The packer gives K odd or 2 mod 4 tiles 1 or 2 weights wide; the
    wrappers' range check takes them (the kernel stages such a tile in 4
    columns), without launching anything."""
    tile_n, tile_k, _ = jbc.choose_fused_tiles(shape)
    assert tile_k in (1, 2)
    fdm.check_tiles(fdm.NAME, shape, tile_n, tile_k)
    assert fdm.launch_plan(4, *shape, tile_k, 1, 132).bm == 4
    # tile_k 1 and 2 stay on the SIMT kernel at every M: the only shapes
    # it still serves; every other tile_k takes the decode kernel (M ≤ 16)
    # or the tensor-core kernel
    for m in (1, 4, 5, 8, 16, 17, 130, 700):
        plan = fdm.launch_plan(m, *shape, tile_k, 1, 132)
        assert plan.kernel == "simt" and plan.bm == (4 if m <= 4 else 16)
    for tk in (4, 8, 16, 32, 64, 128, 256, 512):
        for m in (1, 4, 5, 8, 16, 17, 130, 700):
            assert fdm.launch_plan(m, 128, 4096, tk, 1, 132,
                                   min(32 * tk, 512)
                                   ).kernel == ("decode" if m <= 16
                                                else "mma")
    for bad in (3, 1024):
        with pytest.raises(ValueError, match="range"):
            fdm.check_tiles(fdm.NAME, (128, 3 * 1024), 128, bad)


@pytest.mark.parametrize("shape,block_weights,max_codes", [
    ((13, 256), 256, 40),      # prime block count (13 blocks)
    ((37, 100), 400, 300),     # 100 slots, ragged last block
    ((64, 512), 4096, 65535),  # MLA wkv_b's layout at smoke scale
])
def test_dict_decode_plain(shape, block_weights, max_codes):
    """K4's plain version against the reference's oracle and the Pallas
    kernel (which pads the prime block count to a whole chunk)."""
    rng = np.random.default_rng(9)
    w = rng.integers(0, 256, shape).astype(np.uint8)
    w[: shape[0] // 2] %= 5                    # half the weights hit codes
    table = jcodec.find_frequent_sequences([w], max_codes=max_codes)
    lut = jbc.build_lut(table)
    bc = jbc.encode_blocked(w, table, lut=lut, block_weights=block_weights)
    codes = torch.from_numpy(np.array(bc.codes).view(np.int16))
    lits = torch.from_numpy(np.array(bc.literals))
    got = dict_decode(codes, lits, torch.from_numpy(np.array(lut))).numpy()
    assert got.shape == (codes.shape[0], codes.shape[1] * 4)
    np.testing.assert_array_equal(got, dict_decode_plain(
        codes, lits, torch.from_numpy(np.array(lut))).numpy())
    args = (jnp.asarray(bc.codes), jnp.asarray(bc.literals),
            jnp.asarray(bc.nlit), jnp.asarray(lut))
    np.testing.assert_array_equal(got, np.asarray(jref.dict_decode(*args)))
    np.testing.assert_array_equal(got, np.asarray(jops.dict_decode(
        *args, impl="pallas_interpret")))
    np.testing.assert_array_equal(got.reshape(-1)[: w.size], w.reshape(-1))


def _dict_weights(n, escapes, seed):
    """n uint8 weights and a gram table: "all" — no gram is in the table;
    "none" — every gram is (values 0–3, all 256 grams); "mixed" — half the
    grams, drawn at random, are; "half" — the first half's grams are, the
    second half's escape."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 256, n).astype(np.uint8)
    grams = w.reshape(-1, 4)
    if escapes == "mixed":
        grams[rng.random(len(grams)) < 0.5] %= 4
    elif escapes == "half":
        grams[: len(grams) // 2] %= 4
    elif escapes == "none":
        grams %= 4
    if escapes == "all":
        table = {(1, 2, 3, 4): 0}
        assert not np.all(grams == (1, 2, 3, 4), 1).any()
    else:
        table = {g: i for i, g in enumerate(
            itertools.product(range(4), repeat=4))}
    return w, table


def _dict_decode_emulation(codes, literals, lut):
    """The work split of the card's dictionary decode (csrc/dict_decode.cu),
    emulated in torch: a thread block per compressed block, lane L of its
    launch_shape threads owns slots c0 + 4L .. c0 + 4L + 3 of each chunk of
    threads·4 slots.  A lane counts its escapes; a warp scan gives each
    lane the escapes of the lanes before it in the warp, the warp totals
    (shared memory, one barrier) those of the warps before; the rank of a
    chunk's first slot carries over from the chunk before, and an escape
    takes literal row min(rank, cap − 1)."""
    nb, slots = codes.shape
    cap = literals.shape[1]
    _, threads = ddc.launch_shape(nb, slots)
    chunk = threads * ddc.LANE_SLOTS
    c_all = codes.to(torch.int32) & 0xFFFF
    out = torch.zeros((nb, slots, 4), dtype=torch.uint8)
    lane_slot = (torch.arange(threads)[:, None] * ddc.LANE_SLOTS
                 + torch.arange(ddc.LANE_SLOTS))        # (threads, 4)
    for b in range(nb):
        base = 0
        for c0 in range(0, slots, chunk):
            slot = c0 + lane_slot
            mine = slot < slots
            c = torch.where(mine, c_all[b, slot.clamp(max=slots - 1)], 0)
            esc = mine & (c == 0xFFFF)
            cnt = esc.sum(1).reshape(-1, 32)             # (warps, 32)
            incl = cnt.cumsum(1)                         # the warp scan
            warp_total = incl[:, -1]
            before = warp_total.cumsum(0) - warp_total   # block-wide combine
            first = (base + before[:, None] + incl - cnt).reshape(-1, 1)
            rank = first + esc.cumsum(1) - esc.int()
            grams = torch.where(
                esc[..., None], literals[b, rank.clamp(max=cap - 1)],
                lut[torch.where(esc | ~mine, 0, c).long()])
            out[b, slot[mine]] = grams[mine]
            base += int(warp_total.sum())
    return out.reshape(nb, slots * 4)


@pytest.mark.parametrize("n,block_weights,escapes,cap", [
    (24 * 4096, 4096, "all", None),    # the random-weight path
    (24 * 4096, 4096, "none", None),   # no escapes
    (24 * 4096, 4096, "mixed", None),  # escapes interleaved in a block
    (24 * 4096, 4096, "half", None),   # blocks without escapes beside full
    (37 * 400 - 40, 400, "mixed", None),     # 100 slots, ragged end
    (37 * 408 - 8, 408, "half", None),       # 102 slots: the scalar path
    (5 * 10240, 10240, "mixed", None),  # 2560 slots: 3 chunks, rank carried
    (5 * 10008 - 8, 10008, "all", None),     # 2502: chunks, scalar path
    (24 * 4096, 4096, "all", 300),     # cap below every block's escapes
    (5 * 10240, 10240, "mixed", 700),  # ... clipped from the second chunk on
])
def test_dict_decode_decomposition(n, block_weights, escapes, cap):
    """K4's work split (``_dict_decode_emulation``) is bitwise equal to the
    plain version, the reference's oracle and the Pallas kernel in
    interpret mode, with all, none, some or half the blocks' grams
    escaping, ragged blocks, several chunks and a clipped capacity."""
    w, table = _dict_weights(n, escapes, 7)
    lut = jbc.build_lut(table)
    bc = jbc.encode_blocked(w, table, lut=lut, block_weights=block_weights)
    lits = np.array(bc.literals)
    if cap is not None:
        assert cap < int(np.asarray(bc.nlit).max())
        lits = np.ascontiguousarray(lits[:, :cap])
    codes = torch.from_numpy(np.array(bc.codes).view(np.int16))
    tlits, tlut = torch.from_numpy(lits), torch.from_numpy(np.array(lut))
    got = _dict_decode_emulation(codes, tlits, tlut).numpy()
    np.testing.assert_array_equal(got, dict_decode_plain(
        codes, tlits, tlut).numpy())
    args = (jnp.asarray(bc.codes), jnp.asarray(lits), jnp.asarray(bc.nlit),
            jnp.asarray(lut))
    np.testing.assert_array_equal(got, np.asarray(jref.dict_decode(*args)))
    np.testing.assert_array_equal(got, np.asarray(jops.dict_decode(
        *args, impl="pallas_interpret")))
    if cap is None:
        np.testing.assert_array_equal(got.reshape(-1)[:n], w)


def _qkv(seed, b, hq, hkv, tq, tk, d, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, tq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, tk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, tk, dv or d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,tq,tk,q_offset,causal,dv", [
    (2, 4, 2, 37, 53, 16, True, 16),     # GQA, ragged, offset
    (1, 8, 2, 29, 29, 0, True, 16),      # prime T, full prefill
    (2, 4, 4, 13, 41, 0, False, 16),
    (1, 4, 1, 7, 1300, 1200, True, 16),  # reference's chunked path
    (2, 4, 4, 23, 31, 8, True, 8),       # MLA-like: Dv ≠ Dqk, q_offset
    (1, 4, 4, 19, 1100, 1081, True, 8),  # Dv ≠ Dqk, chunked reference
])
def test_flash_attention_plain_vs_ref(b, hq, hkv, tq, tk, q_offset, causal,
                                      dv):
    q, k, v = _qkv(5, b, hq, hkv, tq, tk, 16, dv)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          q_offset=q_offset).numpy()
    np.testing.assert_array_equal(got, flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)), causal=causal,
        q_offset=q_offset).numpy())
    ref = np.asarray(jref.flash_attention(*map(jnp.asarray, (q, k, v)),
                                          causal=causal, q_offset=q_offset))
    assert got.shape == ref.shape == (b, hq, tq, dv)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("tq,tk,q_offset,bq,bk,dv", [
    (48, 80, 32, 16, 16, 16), (32, 32, 0, 16, 8, 16),
    (24, 64, 40, 8, 32, 16), (16, 48, 32, 8, 16, 8),
])
def test_flash_attention_plain_vs_pallas(tq, tk, q_offset, bq, bk, dv):
    q, k, v = _qkv(6, 2, 4, 2, tq, tk, 16, dv)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                          q_offset=q_offset).numpy()
    pallas = np.asarray(pallas_flash(
        *map(jnp.asarray, (q, k, v)), q_offset=q_offset, bq=bq, bk=bk,
        interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)


def test_flash_attention_strided_views():
    """The layers hand (B, T, H, D) tensors over transposed, not copied."""
    q, k, v = _qkv(7, 2, 4, 2, 9, 11, 16)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  .transpose(1, 2) for a in (q, k, v))
    assert not qt.is_contiguous()
    torch.testing.assert_close(
        flash_attention(qt, kt, vt, q_offset=2),
        flash_attention(*map(torch.from_numpy, (q, k, v)), q_offset=2),
        rtol=0, atol=0)


def _tensor_core_attention(q, k, v, *, causal, q_offset):
    """The numerics of the card's bf16 tensor-core K2 kernel, emulated in
    f32 torch: keys in tiles of 64, scores in log2 units (scale · log2 e,
    masked to −1e30), the running max and sum in f32, P split into bf16
    hi = bf16(p) and lo = bf16(p − hi) before P·V (the kernel feeds both to
    mma.sync), l summed from the unsplit P, and the bf16 output of
    o / max(l, 1e−30)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, tq, d)
    scale = 1.4426950408889634 / math.sqrt(d)
    m = torch.full((b, hkv, hq // hkv, tq, 1), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros((b, hkv, hq // hkv, tq, v.shape[-1]))
    qpos = q_offset + torch.arange(tq)
    for k0 in range(0, tk, 64):
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k[:, :, k0:k0 + 64]) * scale
        if causal:
            kpos = k0 + torch.arange(s.shape[-1])
            s = s.masked_fill(kpos[None, :] > qpos[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        o = o * alpha + torch.einsum("bgrqk,bgkd->bgrqd", hi + lo,
                                     v[:, :, k0:k0 + 64])
        m = m_new
    out = o / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, tq, -1).to(torch.bfloat16)


@pytest.mark.parametrize("hq,hkv,d,dv", [(8, 2, 64, 64),      # Llama: rep 4
                                         (4, 4, 192, 128)])   # MLA
@pytest.mark.parametrize("q_offset,seed", [(0, 11), (32, 12)])
def test_flash_attention_tensor_core_numerics(hq, hkv, d, dv, q_offset,
                                              seed):
    """Splitting P into bf16 hi + lo for P·V, as the card's tensor-core
    kernel does, keeps the bf16 output within the card tests' 1.6e-2 of
    the reference (``repro.kernels.ref`` in f32 on the same bf16 inputs,
    rounded to bf16) at the paths' prefill lengths: 175 queries over 207
    keys.  (P in bf16 alone stays within it too, but at its edge: one
    bf16 ulp for |out| in [2, 4), 0.015625; PERF.md.)"""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float()
               for a in _qkv(seed, 2, hq, hkv, 175, 207, d, dv))
    got = _tensor_core_attention(q, k, v, causal=True, q_offset=q_offset)
    ref = np.asarray(jref.flash_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True,
        q_offset=q_offset))
    ref = torch.from_numpy(ref.copy()).to(torch.bfloat16)
    assert got.shape == ref.shape == (2, hq, 175, dv)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1.6e-2, err


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest on the
    f32 bits with ties away from zero (adding half of the 13 dropped bits'
    range to the sign-magnitude pattern), the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """hi = tf32(x), lo = tf32(x − hi): the card's f32 kernel's split."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32x3(eq, a, b):
    """einsum(eq, a, b) as the card's f32 kernel takes it: both operands
    split, hi·hi + hi·lo + lo·hi, each a TF32 product summed in f32."""
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _tf32x3_attention(q, k, v, *, causal, q_offset, keys):
    """The numerics of the card's f32 K2 kernel (three-term TF32 on the
    tensor cores), emulated in f32 torch: keys in tiles of ``keys``, S =
    Q·Kᵀ in three TF32 products, scores in log2 units (scale · log2 e,
    masked to −1e30), the running max and sum in f32, P·V in three TF32
    products of the split P and V, l summed from the unsplit P, and
    o / max(l, 1e−30)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, tq, d)
    scale = 1.4426950408889634 / math.sqrt(d)
    m = torch.full((b, hkv, hq // hkv, tq, 1), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros((b, hkv, hq // hkv, tq, v.shape[-1]))
    qpos = q_offset + torch.arange(tq)
    for k0 in range(0, tk, keys):
        s = _tf32x3("bgrqd,bgkd->bgrqk", qg, k[:, :, k0:k0 + keys]) * scale
        if causal:
            kpos = k0 + torch.arange(s.shape[-1])
            s = s.masked_fill(kpos[None, :] > qpos[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _tf32x3("bgrqk,bgkd->bgrqd", p,
                                v[:, :, k0:k0 + keys])
        m = m_new
    out = o / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, tq, -1)


@pytest.mark.parametrize("hq,hkv,d,dv,keys", [(8, 2, 64, 64, 64),  # Llama
                                              (4, 4, 192, 128, 64),  # MLA
                                              (4, 4, 192, 128, 32)])
@pytest.mark.parametrize("q_offset,seed", [(0, 13), (32, 14)])
def test_flash_attention_tf32x3_numerics(hq, hkv, d, dv, keys, q_offset,
                                         seed):
    """Three TF32 products (hi·hi + hi·lo + lo·hi), as the card's f32 K2
    kernel takes Q·Kᵀ and P·V, keep f32 attention within K2's f32
    tolerance, 1e-4, of the reference (``repro.kernels.ref`` in f32) at
    the training shapes: 256 queries, causal, over 256 + q_offset keys in
    the kernel's tiles (MLA's in 64 or 32 keys).  One TF32 product alone
    would not: it errs ~1.6e-3 on these inputs, which the test also
    shows."""
    q, k, v = (torch.from_numpy(a)
               for a in _qkv(seed, 2, hq, hkv, 256, 256 + q_offset, d, dv))
    got = _tf32x3_attention(q, k, v, causal=True, q_offset=q_offset,
                            keys=keys)
    ref = torch.from_numpy(np.asarray(jref.flash_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True,
        q_offset=q_offset)).copy())
    assert got.shape == ref.shape == (2, hq, 256, dv)
    err = (got - ref).abs().max().item()
    assert err <= 1e-4, err
    one_pass = flash_attention_plain(_tf32(q), _tf32(k), _tf32(v),
                                     q_offset=q_offset)
    assert (one_pass - ref).abs().max().item() > 1e-4


def test_tf32_split_rebuilds_f32():
    """hi + lo of the split rebuilds x to within 2^-22 of |x|, hi with its
    low 13 bits zero (a TF32 value), over randn values of many scales and
    the values whose dropped bits are exactly half (ties, rounded away
    from zero)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(1 << 16)
                          * 10.0 ** rng.integers(-20, 20, 1 << 16))
                         .astype(np.float32))
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                         1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    x = torch.cat([x, ties])
    hi, lo = _split_tf32(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs())
    assert rel.max().item() <= 2.0 ** -22
    assert hi[-3:].tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                1.0 + 2.0 ** -9]


def test_flash_attention_operand_alignment():
    """The tensor-core kernel copies 16 bytes at a time: an operand whose
    base or (B, H, T) strides are not multiples of 8 elements is passed
    as an aligned contiguous copy; an aligned one (a transposed cache view
    included) as it is."""
    from repro_torch.kernels.flash_attention import _aligned
    cache = torch.zeros((2, 40, 4, 64), dtype=torch.bfloat16)
    view = cache.transpose(1, 2)
    assert _aligned(view) is view
    wide = torch.zeros((2, 4, 40, 68), dtype=torch.bfloat16)[..., :64]
    shifted = torch.zeros(2 * 4 * 40 * 64 + 1, dtype=torch.bfloat16)[1:]
    for t in (wide, shifted.reshape(2, 4, 40, 64)):
        got = _aligned(t)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, t)


def _tile_block(j, kt, nnt, nkt_g, bpt):
    """The first block of weight tile (j, kt), as ``tile_block`` in
    csrc/fused_decode_matmul.cu finds it: K tile kt (of the whole K) lies
    in column group kt // nkt_g."""
    g = kt // nkt_g
    return ((g * nnt + j) * nkt_g + kt - g * nkt_g) * bpt


def _decode_kernel_emulation(x, codes, literals, lut, scale, zero, *, shape,
                             tile_n, tile_k):
    """The work split of the card's decode-batch kernel, emulated in f32
    torch.  Above 4 rows (at most 16) the kernel runs each group of 4
    rows with the M ≤ 4 arithmetic at the same warps, so the rows are
    those groups' outputs one after another.  At M ≤ 4: one block per row
    group of the weight (block position bb of tile row j)
    over all of K; warp w takes K tiles w, w + W, ...; each step of 256
    slots gives lane L slots 8L .. 8L + 7, whose escape ranks are the
    step's base (escapes of the earlier steps), the escapes of the lanes
    before L and of the lane's own earlier slots, clipped to cap − 1.
    tile_k ≥ 32: tile_k / 32 lanes share a row, each 32 columns; the
    tensor-core product sums, per warp, each row's columns in groups of
    128 (H = tile_k / 128 partial sums per row, one when tile_k ≤ 128)
    over the warp's tiles, and Σx the same way.  tile_k 4, 8, 16: a lane
    holds whole rows.  The partials are summed in (warp, group) order,
    then the affine epilogue.  Column groups (codes (G, nb, slots)): the
    K tiles of all groups are walked as one K, each tile's blocks found by
    :func:`_tile_block`."""
    n, k = shape
    m = x.shape[0]
    if m > 4:
        # four row groups at most, each the M ≤ 4 work at the same warps
        plan = fdm.launch_plan(m, n, k, tile_k, 1, 132, codes.shape[-1])
        assert plan.kernel == "decode" and m <= fdm.DECODE_MAX_M
        assert plan.warps == fdm.launch_plan(1, n, k, tile_k, 1, 132,
                                             codes.shape[-1]).warps
        return torch.cat([_decode_kernel_emulation(
            x[r:r + 4], codes, literals, lut, scale, zero, shape=shape,
            tile_n=tile_n, tile_k=tile_k) for r in range(0, m, 4)])
    n_groups = codes.shape[0] if codes.ndim == 3 else 1
    codes = codes.reshape(-1, codes.shape[-1])
    literals = literals.reshape((-1,) + tuple(literals.shape[-2:]))
    nb, slots = codes.shape
    cap = literals.shape[1]
    nnt, nkt = n // tile_n, k // tile_k
    bpt = nb // (nnt * nkt)
    first = torch.tensor([[_tile_block(j, kt, nnt, nkt // n_groups, bpt)
                           for kt in range(nkt)] for j in range(nnt)])
    rows = first[..., None] + torch.arange(bpt)        # (nnt, nkt, bpt)
    plan = fdm.launch_plan(m, n, k, tile_k, 1, 132, slots)
    assert plan.kernel == "decode" and plan.splits == 1
    warps, rpb = plan.warps, 4 * slots // tile_k
    groups = max(tile_k // 128, 1)
    steps = -(-slots // 256)
    xb = torch.zeros((4, k))
    xb[:m] = x.to(torch.bfloat16).float()
    c_all = (codes.to(torch.int32) & 0xFFFF)[rows]
    l_all = literals[rows]
    red = torch.zeros((warps, nnt, bpt, rpb, groups, 4))
    redsx = torch.zeros((warps, groups, 4))
    lane = torch.arange(32)
    slot = (torch.arange(steps)[:, None, None] * 256 + lane[None, :, None] * 8
            + torch.arange(8)[None, None, :])          # (steps, 32, 8)
    valid = slot < slots
    for w in range(warps):
        for kt in range(w, nkt, warps):
            c = c_all[:, kt][..., slot.clamp(max=slots - 1)]
            esc = valid & (c == 0xFFFF)                 # (nnt, bpt, st, L, u)
            cnt = esc.sum(-1)
            lanes_before = cnt.cumsum(-1) - cnt
            total = cnt.sum(-1)
            step_base = total.cumsum(-1) - total
            own_before = esc.cumsum(-1) - esc.int()
            rank = (step_base[..., None, None] + lanes_before[..., None]
                    + own_before).clamp(max=cap - 1)
            lits = l_all[:, kt]                         # (nnt, bpt, cap, 4)
            from_lit = torch.gather(
                lits[:, :, None, None].expand(-1, -1, steps, 32, -1, -1),
                4, rank.clamp(min=0)[..., None].expand(-1, -1, -1, -1, -1, 4)
                .long())
            grams = torch.where(esc[..., None], from_lit,
                                lut[torch.where(esc | ~valid, 0, c).long()])
            q = torch.where(valid[..., None], grams, 0).float()
            xt = xb[:, kt * tile_k:(kt + 1) * tile_k]
            if tile_k >= 32:
                lpr = tile_k // 32
                cols = ((lane % lpr) * 32)[:, None, None] + \
                    4 * torch.arange(8)[None, :, None] + \
                    torch.arange(4)[None, None, :]       # (L, u, b)
                dots = torch.einsum("gbsluj,mluj->gbslm", q, xt[:, cols])
                for st in range(steps):
                    for ln in range(32):
                        row = st * (32 // lpr) + ln // lpr
                        if row < rpb:
                            red[w, :, :, row, (ln % lpr) // 4] += \
                                dots[:, :, st, ln]
                redsx[w] += xt.reshape(4, groups, -1).sum(-1).T
            else:
                gpr = tile_k // 4
                cols = ((lane[:, None] * 8 + torch.arange(8)) % gpr)[
                    ..., None] * 4 + torch.arange(4)    # (L, u, b)
                dots = torch.einsum("gbsluj,mluj->gbslum", q, xt[:, cols])
                rows = (slot // gpr).clamp(max=rpb - 1)
                for st in range(steps):
                    for ln in range(32):
                        for u in range(8):
                            if valid[st, ln, u]:
                                red[w, :, :, rows[st, ln, u], 0] += \
                                    dots[:, :, st, ln, u]
                redsx[w, 0] += xt.sum(1)
    a, sx = torch.zeros((nnt, bpt, rpb, 4)), torch.zeros(4)
    for w in range(warps):
        for h in range(groups):
            a = a + red[w, :, :, :, h]
            sx = sx + redsx[w, h]
    a = a.reshape(n, 4).T[:m]
    y = scale.reshape(1, -1) * (a - sx[:m, None] * zero.reshape(1, -1))
    return y


def _mma_kernel_emulation(x, codes, literals, lut, scale, zero, *, shape,
                          tile_n, tile_k):
    """The K steps of the card's tensor-core kernel (M > 16), emulated in
    f32 torch, as the plan cuts them: K split into ``tiles_per_split``
    tiles a split (below tile_k 64 whole 64-column steps, but for the last
    split); each split decoded ``span`` tiles at a time, the tiles side by
    side; a span's product in 64-column steps of four 16-column mma
    (x rows × the span's weight rows), the last step of a span that ends
    inside a step padded with q = 0 and x = 0 (copied from no source);
    Σx over the same steps; the splits' sums added in split order, then
    the affine epilogue."""
    n, k = shape
    m = x.shape[0]
    nb, slots = codes.shape[-2:]
    cap = literals.shape[-2]
    plan = fdm.launch_plan(m, n, k, tile_k, 1, 132, slots)
    assert plan.kernel == "mma" and plan.bm == fdm.MMA_BM
    nkt = k // tile_k
    if plan.splits > 1:
        assert plan.tiles_per_split * tile_k % fdm.MMA_STEP_K == 0
    # the decoded weight, tile (j, kt) at rows j·tile_n, columns kt·tile_k
    nnt = n // tile_n
    bpt = nb // (nnt * nkt)
    q = decode_blocked(codes.reshape(-1, slots),
                       literals.reshape(-1, cap, 4), lut).float()
    w = q.reshape(nnt, nkt, tile_n, tile_k).permute(0, 2, 1, 3).reshape(
        n, k)
    xb = x.to(torch.bfloat16).float()
    accs, sxs = [], []
    for s in range(plan.splits):
        kt0 = s * plan.tiles_per_split
        kt1 = min(kt0 + plan.tiles_per_split, nkt)
        acc, sx = torch.zeros((m, n)), torch.zeros(m)
        for c0 in range(kt0, kt1, plan.span):
            c1 = min(c0 + plan.span, kt1)
            vc = (c1 - c0) * tile_k
            steps = -(-vc // fdm.MMA_STEP_K)
            qs = torch.zeros((n, steps * 64))
            qs[:, :vc] = w[:, c0 * tile_k:c0 * tile_k + vc]
            xs = torch.zeros((m, steps * 64))
            xs[:, :vc] = xb[:, c0 * tile_k:c0 * tile_k + vc]
            for st in range(steps):
                for u in range(4):
                    cols = slice(64 * st + 16 * u, 64 * st + 16 * u + 16)
                    acc = acc + xs[:, cols] @ qs[:, cols].T
                sx = sx + xs[:, 64 * st:64 * st + 64].sum(dim=1)
        accs.append(acc)
        sxs.append(sx)
    acc, sx = accs[0], sxs[0]
    if plan.splits > 1:      # splitk_epilogue: from 0, in split order
        acc, sx = torch.zeros((m, n)), torch.zeros(m)
        for a, b in zip(accs, sxs):
            acc, sx = acc + a, sx + b
    return scale.reshape(1, -1) * (acc - sx[:, None] * zero.reshape(1, -1))


@pytest.mark.parametrize("shape,m", [
    ((128, 11 * 32), 40),      # tile_k 32, 11 tiles: one span, split
    ((128, 11 * 32), 130),     # two bands: a split is one span
    ((256, 13 * 16), 17),      # tile_k 16, 13 tiles
    ((128, 43 * 16), 300),     # 43 tiles of 16: two spans, the last short
    ((128, 17 * 8), 129),      # tile_k 8, 17 tiles
    ((128, 33 * 4), 129),      # tile_k 4, K ≡ 4 mod 8
])
@pytest.mark.parametrize("kind", ["int", "bf16"])
def test_mma_kernel_decomposition_below_tile_k_64(shape, m, kind):
    """K1's tensor-core kernel at tile_k < 64 (``_mma_kernel_emulation``:
    tiles side by side in 64-column steps, a span that ends inside a step
    padded with zeros) is bitwise equal to the plain version and to the
    reference's oracle on integer-valued x, within assert_close_scaled on
    bf16 x — at odd tile counts."""
    pl, lut, t = _packed(shape, 8)
    assert pl.tile_k < 64 and (shape[1] // pl.tile_k) % 2 == 1
    x = torch.from_numpy(_x(np.random.default_rng(8), m, shape[1],
                            kind).copy())
    kw = dict(shape=shape, tile_n=pl.tile_n, tile_k=pl.tile_k)
    args = (t["codes"], t["literals"], t["lut"], t["scale"], t["zero"])
    got = _mma_kernel_emulation(x, *args, **kw).numpy()
    plain = fused_decode_matmul_plain(x, *args, **kw).numpy()
    ref = np.asarray(jref.fused_decode_matmul(
        jnp.asarray(x.numpy()), pl.codes, pl.literals, pl.nlit,
        jnp.asarray(lut), pl.scale, pl.zero, **kw))
    if kind == "int":
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, ref)
    else:
        assert_close_scaled(got, plain)
        assert_close_scaled(got, ref)


def _packed_escapes(shape, seed, escapes):
    """Planes of a seeded weight where every gram escapes (a table of
    grams the weight lacks) or none does (a two-level weight, every gram
    in the table)."""
    rng = np.random.default_rng(seed)
    from repro.core.compressed import quantize_linear
    if escapes == "all":
        w = rng.standard_normal(shape).astype(np.float32)
        vals = np.asarray(quantize_linear(jnp.asarray(w)).values)
        table = {tuple(int(b) for b in (1, 2, 3, 4)): 0}
        assert not np.any(np.all(vals.reshape(-1, 4) == (1, 2, 3, 4), 1))
    else:
        w = rng.integers(0, 2, shape).astype(np.float32)
        w[:, 0] = 2.0          # per-channel range: values 0, 127 and 255
        vals = np.asarray(quantize_linear(jnp.asarray(w)).values)
        table = jcodec.find_frequent_sequences([vals], min_count=1)
    lut = jbc.build_lut(table)
    pl = pack_linear(jnp.asarray(w), table, lut, tile="auto")
    return pl, lut, {
        "codes": torch.from_numpy(np.array(pl.codes).view(np.int16)),
        "literals": torch.from_numpy(np.array(pl.literals)),
        "lut": torch.from_numpy(np.array(lut)),
        "scale": torch.from_numpy(np.array(pl.scale)),
        "zero": torch.from_numpy(np.array(pl.zero))}


@pytest.mark.parametrize("shape,m,bw,escapes", [
    ((128, 2048), 4, 4096, "mixed"),    # tile_k 512: 16 lanes to a row
    ((128, 768), 3, 4096, "mixed"),     # tile_k 256: 8 lanes, 3 tiles
    ((256, 640), 4, 4096, "mixed"),     # tile_k 128, 5 tiles
    ((128, 1408), 2, 4096, "mixed"),    # tile_k 128, 11 tiles
    ((64, 192), 4, 4096, "mixed"),      # tile_n 64, tile_k 64: 32 rows/block
    ((96, 160), 1, 1024, "mixed"),      # tile_k 32: 256 slots, lane = row
    ((32, 48), 4, 256, "mixed"),        # tile_k 16: 64 slots, narrow
    ((40, 72), 3, 4096, "mixed"),       # tile_k 8: 8 × 8 tiles, 16 slots
    ((24, 36), 4, 4096, "mixed"),       # tile_k 4: 8 × 4 tiles, 8 slots
    ((64, 96), 4, 512, "mixed"),        # 128 slots: half a step
    ((128, 2048), 4, 4096, "all"),      # every gram escapes
    ((128, 2048), 4, 4096, "none"),     # no gram escapes
    ((64, 17 * 64), 4, 4096, "all"),    # 17 tiles: warps take two each
    # 5–16 rows: four row groups at most
    ((128, 2048), 16, 4096, "mixed"),   # tile_k 512
    ((256, 640), 5, 4096, "mixed"),     # tile_k 128, 5 tiles
    ((96, 160), 8, 1024, "mixed"),      # tile_k 32
    ((32, 48), 13, 256, "mixed"),       # tile_k 16: narrow
    ((24, 36), 16, 4096, "mixed"),      # tile_k 4
    ((64, 17 * 64), 9, 4096, "all"),    # 17 tiles, every gram escapes
])
@pytest.mark.parametrize("kind", ["int", "bf16"])
def test_decode_kernel_decomposition(shape, m, bw, escapes, kind):
    """The decode-batch kernel's work split (``_decode_kernel_emulation``)
    is bitwise equal to the plain version and to the reference's oracle on
    integer-valued x, and within assert_close_scaled on bf16 x; above 4
    rows, each row on bf16 x is bitwise the emulation of that row alone
    (M = 1)."""
    if escapes == "mixed":
        pl, lut, t = _packed(shape, 5, bw)
    else:
        pl, lut, t = _packed_escapes(shape, 5, escapes)
    cap = t["literals"].shape[1]
    nlit = np.asarray(pl.nlit)
    if escapes == "all":
        assert (nlit == t["codes"].shape[1]).all()
    if escapes == "none":
        assert (nlit == 0).all()
    x = torch.from_numpy(_x(np.random.default_rng(6), m, shape[1],
                            kind).copy())
    kw = dict(shape=shape, tile_n=pl.tile_n, tile_k=pl.tile_k)
    args = (t["codes"], t["literals"], t["lut"], t["scale"], t["zero"])
    got = _decode_kernel_emulation(x, *args, **kw).numpy()
    plain = fused_decode_matmul_plain(x, *args, **kw).numpy()
    ref = np.asarray(jref.fused_decode_matmul(
        jnp.asarray(x.numpy()), pl.codes, pl.literals, pl.nlit,
        jnp.asarray(lut), pl.scale, pl.zero, **kw))
    assert cap >= 1
    if kind == "int":
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, ref)
    else:
        assert_close_scaled(got, plain)
        assert_close_scaled(got, ref)
        if m > 4:
            for i in range(m):
                np.testing.assert_array_equal(got[i:i + 1], (
                    _decode_kernel_emulation(x[i:i + 1], *args, **kw)
                    .numpy()))


@pytest.mark.parametrize("e,n,k,m", [(3, 128, 1408, 4), (5, 64, 256, 3)])
@pytest.mark.parametrize("kind", ["int", "bf16"])
def test_decode_kernel_decomposition_grouped(e, n, k, m, kind):
    """K3 at decode: the kernel's grid holds every expert's row groups and
    each runs K1's work on its expert's planes, so the emulation per
    expert is the stack's product — bitwise equal to K3's plain version
    and the reference's grouped oracle on integer x, close on bf16 x."""
    rng = np.random.default_rng(10)
    ws = [rng.laplace(0.0, 0.02, size=(n, k)).astype(np.float32)
          for _ in range(e)]
    pl, lut = jpack_expert_stack(ws)
    codes, lits, scale, zero = _planes(pl)
    tlut = torch.from_numpy(np.array(lut))
    x = np.stack([_x(rng, m, k, kind) for _ in range(e)])
    kw = dict(shape=tuple(pl.shape), tile_n=pl.tile_n, tile_k=pl.tile_k)
    assert fdm.launch_plan(m, n, k, pl.tile_k, e, 132,
                           codes.shape[2]).kernel == "decode"
    got = np.stack([_decode_kernel_emulation(
        torch.from_numpy(x[j]), codes[j], lits[j], tlut, scale[j], zero[j],
        **kw).numpy() for j in range(e)])
    plain = grouped_fused_decode_matmul_plain(
        torch.from_numpy(x), codes, lits, tlut, scale, zero, **kw).numpy()
    ref = np.asarray(jref.grouped_fused_decode_matmul(
        jnp.asarray(x), pl.codes, pl.literals, pl.nlit, lut, pl.scale,
        pl.zero, **kw))
    if kind == "int":
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, ref)
    else:
        assert_close_scaled(got, plain)
        assert_close_scaled(got, ref)


@pytest.mark.parametrize("shape,groups,m", [
    ((128, 2048), 2, 4),        # tile_k 512: one K tile a group
    ((128, 2048), 4, 3),        # tile_k 512, 4 groups of one tile
    ((64, 2 * 17 * 64), 2, 4),  # 17 tiles a group: warps cross the boundary
    ((256, 1280), 2, 2),        # tile_k 128, 5 tiles a group
])
@pytest.mark.parametrize("kind", ["int", "bf16"])
def test_decode_kernel_decomposition_column_groups(shape, groups, m, kind):
    """K1 with column groups at decode: the kernel walks the K tiles of
    all G groups as one K, each tile finding its own block
    (``tile_block``), so its work split over (G, nb, slots) planes is
    bitwise equal to the plain version with groups, and to the plain
    version at G = 1 on the untiled planes of the same weight with the
    same tiles, on integer x; close on bf16 x."""
    from repro_torch.core.compressed import pack_linear_tiled
    rng = np.random.default_rng(11)
    w = np.round(rng.standard_normal(shape) * 3).astype(np.float32) / 3
    from repro.core.compressed import quantize_linear
    vals = np.asarray(quantize_linear(jnp.asarray(w)).values)
    table = jcodec.find_frequent_sequences([vals])
    tt = pack_linear_tiled(torch.from_numpy(w), table, groups, tile="auto")
    lut = torch.from_numpy(np.array(jbc.build_lut(table)))
    from repro_torch.core import blocked_codec as tbc
    bc = tbc.encode_blocked_tiled(torch.from_numpy(vals.copy()), table,
                                  tile_n=tt.tile_n, tile_k=tt.tile_k)
    kw = dict(shape=shape, tile_n=tt.tile_n, tile_k=tt.tile_k)
    x = torch.from_numpy(_x(rng, m, shape[1], kind).copy())
    got = _decode_kernel_emulation(x, tt.codes, tt.literals, lut, tt.scale,
                                   tt.zero, **kw).numpy()
    plain = fused_decode_matmul_plain(x, tt.codes, tt.literals, lut,
                                      tt.scale, tt.zero, **kw).numpy()
    untiled = fused_decode_matmul_plain(x, bc.codes, bc.literals, lut,
                                        tt.scale, tt.zero, **kw).numpy()
    if kind == "int":
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, untiled)
    else:
        assert_close_scaled(got, plain)
        assert_close_scaled(got, untiled)
