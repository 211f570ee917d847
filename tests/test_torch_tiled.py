"""Column-group storage (``TiledPackedLinear``) and K1 with G > 1: the port
against the JAX package, on the CPU.

  * Packing: ``encode_tiled_planes`` and ``pack_linear_tiled`` give the
    reference's planes byte for byte, at 2 and 4 groups, in the tile-major
    and the linear layout, and for a weight small enough to shrink the
    block size; ``build_serve_params(tiles=2)`` gives the reference's
    planes for Llama-3.2 and DeepSeek-V2-Lite (expert stacks untiled), and
    the integrity manifest equals the reference's leaf for leaf.
  * K1's plain version with G groups: bitwise against the reference's K1
    (the Pallas kernel in interpret mode) and against the plain K1 at G = 1
    on the same weight's untiled planes, on integer-valued x; against the
    reference's ``ops.tiled_decode_dequant_matmul(impl='ref')`` within
    1e-4 of the output's scale on random x (the reference adds the groups'
    affine outputs, the port sums every strip into one accumulator: the
    same products, rounded in another order).
  * The dispatch rungs (``tiled_fused``, ``tiled_unfused``,
    ``tiled_materialize``) and their probes, MLA's absorb of a tiled wkv_b
    counted as ``'tiled'``, the integrity gate over tiled planes.
  * End to end: tiled greedy tokens equal to the reference's tiled
    ``generate`` on both families (a row may differ only from a step where
    the reference's logits tie exactly, as in ``test_torch_moe.py``), and
    the ``Engine``'s completions equal to the port's tiled ``generate``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.core import blocked_codec as jbc
from repro.core import integrity as JI
from repro.core.codec import find_frequent_sequences as jfind
from repro.core.compressed import TiledPackedLinear as JTiled
from repro.core.compressed import encode_tiled_planes as jencode_tiled
from repro.core.compressed import pack_linear_tiled as jpack_tiled
from repro.core.compressed import quantize_linear as jquantize
from repro.kernels import fused_decode_matmul as jfdm
from repro.kernels import ops as jops
from repro.models import lm as JLM
from repro.serve import engine as JE
from repro.serve.context import ServeContext as JContext
from repro.testing import FaultInjector as JInjector

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core import blocked_codec as tbc
from repro_torch.core import integrity as TI
from repro_torch.core.compressed import (PackedLinear, TiledPackedLinear,
                                         encode_tiled_planes,
                                         pack_linear_tiled)
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import _build, ops
from repro_torch.kernels import fused_decode_matmul as fdm
from repro_torch.models import layers as TL
from repro_torch.serve import engine as TE
from repro_torch.serve import resilience as TR
from repro_torch.serve.context import ServeContext
from repro_torch.serve.resilience import (FALLBACK_COUNTS, ResiliencePolicy,
                                          ResilientEngine)
from repro_torch.serve.scheduler import Engine, Request
from repro_torch.testing import FaultInjector

from test_torch_model import state_to_numpy
from test_torch_serve import _prompts

torch.set_num_threads(2)
ARCHS = ["llama3.2-1b", "deepseek-v2-lite-16b"]


@pytest.fixture(autouse=True)
def _clear_counts():
    FALLBACK_COUNTS.clear()
    ops.DISPATCH_COUNTS.clear()
    _build.LAUNCH_COUNTS.clear()
    TL.MATERIALIZE_COUNTS.clear()
    yield
    assert ops._DEFAULT_IMPL == "auto", "the lever was left set"
    assert not _build.LAUNCH_COUNTS, "a CPU call launched a kernel"


def _u16(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


def _assert_planes_equal(jt, tt):
    for plane in ("codes", "literals", "nlit", "scale", "zero"):
        want = np.asarray(getattr(jt, plane))
        got = _u16(getattr(tt, plane))
        assert got.dtype == want.dtype and got.shape == want.shape, plane
        np.testing.assert_array_equal(got, want, err_msg=plane)
    assert (tt.tile_n, tt.tile_k, tuple(tt.shape)) == \
        (jt.tile_n, jt.tile_k, tuple(jt.shape))


def _weight(n, k, seed=0):
    """A seeded (n, k) f32 weight, its quantized uint8 values and a small
    dictionary over them (so some grams escape)."""
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)
    q = np.asarray(jquantize(jnp.asarray(w)).values, np.uint8)
    table = jfind([q], max_codes=300)
    return w, q, table


# (n, k, tiles, tile): tile-major at 2 and 4 groups, the linear layout, and
# a weight of 8 × 64 whose 256-weight groups shrink the block to 256
PACK_CASES = [(64, 512, 2, "auto"), (96, 256, 4, "auto"),
              (64, 256, 4, None), (8, 64, 2, "auto"), (8, 64, 2, None)]


@pytest.mark.parametrize("n,k,tiles,tile", PACK_CASES)
def test_pack_linear_tiled_byte_equal(n, k, tiles, tile):
    w, q, table = _weight(n, k)
    lut = jbc.build_lut(table)
    jt = jpack_tiled(jnp.asarray(w), table, lut, tiles, tile=tile)
    tt = pack_linear_tiled(torch.from_numpy(w), table, tiles, tile=tile)
    assert isinstance(tt, TiledPackedLinear) and tt.tiles == tiles
    _assert_planes_equal(jt, tt)
    assert tt.payload_nbytes == jt.payload_nbytes
    # the decoded uint8 weight is the quantized one, in both packages
    tw = tt.materialize_int8(tbc.build_lut(table))
    np.testing.assert_array_equal(tw.numpy(), q)
    np.testing.assert_array_equal(
        np.asarray(jt.materialize_int8(jnp.asarray(lut))), q)


@pytest.mark.parametrize("n,k,tiles,tile", PACK_CASES)
def test_encode_tiled_planes_byte_equal(n, k, tiles, tile):
    _, q, table = _weight(n, k, seed=1)
    jbcs, jtn, jtk = jencode_tiled(q, table, jbc.build_lut(table), tiles,
                                   tile=tile)
    tbcs, ttn, ttk = encode_tiled_planes(torch.from_numpy(q.copy()), table,
                                         tiles, tile=tile)
    assert (ttn, ttk) == (jtn, jtk) and len(tbcs) == len(jbcs) == tiles
    for jb, tb in zip(jbcs, tbcs):
        np.testing.assert_array_equal(_u16(tb.codes), np.asarray(jb.codes))
        np.testing.assert_array_equal(tb.literals.numpy(),
                                      np.asarray(jb.literals))
        np.testing.assert_array_equal(tb.nlit.numpy(), np.asarray(jb.nlit))
    if (n, k) == (8, 64):     # 256 weights a group: the block shrinks
        assert tbcs[0].codes.shape[1] * 4 <= 256


def _np_state(st):
    """``state_to_numpy`` with the reference's TiledPackedLinear too."""
    def conv(x):
        if isinstance(x, JTiled):
            return {"kind": "tiled", "codes": np.asarray(x.codes),
                    "literals": np.asarray(x.literals),
                    "nlit": np.asarray(x.nlit), "scale": np.asarray(x.scale),
                    "zero": np.asarray(x.zero), "shape": x.shape,
                    "tile_n": x.tile_n, "tile_k": x.tile_k}
        return x
    tiled = jax.tree_util.tree_map(conv, st.params,
                                   is_leaf=lambda x: isinstance(x, JTiled))
    return state_to_numpy(dataclasses.replace(st, params=tiled))


@pytest.fixture(scope="module", params=ARCHS)
def tiled(request):
    """(reference cfg, port cfg, reference state, port state packed by the
    port, port state carried across from the reference's), tiles=2."""
    cfg = get_config(request.param).smoke
    tcfg = tget_config(request.param).smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    jst = JE.build_serve_params(params, JPolicy(
        mode="compressed", min_weight_size=1024, tiles=2))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    tst = TE.build_serve_params(tparams, CompressionPolicy(
        mode="compressed", min_weight_size=1024, tiles=2), device="cpu")
    carried = convert.serve_state_from_numpy(
        _np_state(jst), np.asarray(jst.lut), tcfg, mode="compressed",
        device="cpu")
    return cfg, tcfg, jst, tst, carried


def _containers(params):
    for name, holders in TI.leaf_groups(params):
        yield name, [h[k] for h, k in holders]


def test_build_serve_params_tiled_byte_equal(tiled):
    cfg, tcfg, jst, tst, _ = tiled
    want = dict(JI._iter_plane_leaves(jst.params))
    got = {leaf.name: leaf for leaf in TI.plane_leaves(tst.params)}
    assert list(got) == list(want)
    for name, leaf in got.items():
        ref = np.asarray(want[name])
        parts = [_u16(p) for p in leaf.parts]
        arr = np.stack(parts) if leaf.stacked else parts[0]
        assert arr.dtype == ref.dtype and arr.shape == ref.shape, name
        np.testing.assert_array_equal(arr, ref, err_msg=name)
    np.testing.assert_array_equal(tst.lut.numpy(), np.asarray(jst.lut))
    assert tst.stats == jst.stats
    kinds = {}
    for name, ws in _containers(tst.params):
        kinds[name] = type(ws[0])
    tiled_names = [n for n, c in kinds.items() if c is TiledPackedLinear]
    assert tiled_names and all("experts" not in n for n in tiled_names)
    for n, c in kinds.items():
        if "experts" in n:
            assert c is PackedLinear
    for _, ws in _containers(tst.params):
        if isinstance(ws[0], TiledPackedLinear):
            assert ws[0].tiles == 2 and ws[0].codes.ndim == 3
            assert len({w.literals.shape[-2] for w in ws}) == 1


def test_manifest_equals_reference(tiled):
    _, _, jst, tst, _ = tiled
    jm, tm = jst.manifest, tst.manifest
    assert list(tm["leaves"]) == list(jm["leaves"])
    assert any(name.endswith(".codes_t") for name in tm["leaves"])
    for name, want in jm["leaves"].items():
        got = tm["leaves"][name]
        for key in ("shape", "nbytes", "crc32", "crc32_fast"):
            assert got[key] == want[key], (name, key)
        assert got["dtype"] == want["dtype"] or \
            (got["dtype"], want["dtype"]) == ("int16", "uint16")
    assert tm["lut"]["crc32"] == jm["lut"]["crc32"]
    assert tm["table_crc32"] == jm["table_crc32"]
    assert tm["total_bytes"] == jm["total_bytes"]


@pytest.mark.parametrize("seed", [0, 3])
def test_tiled_bitflip_named_as_reference(tiled, seed):
    """A seeded flip in a tiled code plane is named by both packages'
    verify and caught by the gate; the invariants cover tiled leaves."""
    _, _, jst, tst, _ = tiled
    jbad, jname = JInjector(seed).flip_bit(jst, "wq", plane="codes_t")
    tbad, tname = FaultInjector(seed).flip_bit(tst, "wq", plane="codes_t")
    assert tname == jname and tname.endswith(".codes_t")
    jrep = JI.verify_serve_state(jbad, level="full")
    trep = TI.verify_serve_state(tbad, level="full")
    assert trep.quarantined == jrep.quarantined == [tname]
    flags = TI.invariant_flags(tst.params, tst.lut)
    assert any("wq" in n for n in flags) and all(bool(v) for v in
                                                 flags.values())
    assert TI.check_invariants(tst).ok


def test_invariants_catch_tiled_out_of_range_code(tiled):
    _, _, _, tst, _ = tiled
    params = TE._copy_tree(tst.params)
    blk = params["blocks"][0]["attn"]
    w = blk["wq"]
    codes = w.codes.clone()
    codes[1, 0, 0] = tst.lut.shape[0] + 3
    blk["wq"] = dataclasses.replace(w, codes=codes)
    rep = TI.check_invariants(dataclasses.replace(tst, params=params))
    assert not rep.ok and rep.quarantined == ["['blocks']['attn']['wq']"]


# -- K1 with column groups ----------------------------------------------

K1_CASES = [(64, 512, 2, 8), (128, 512, 4, 5), (32, 1024, 2, 1)]


def _k1_operands(n, k, groups, seed=2):
    """The same weight as G column groups and untiled, with the same
    tiles, and the LUT."""
    w, q, table = _weight(n, k, seed)
    tt = pack_linear_tiled(torch.from_numpy(w), table, groups, tile="auto")
    tn, tk = tt.tile_n, tt.tile_k
    bc = tbc.encode_blocked_tiled(torch.from_numpy(q.copy()), table,
                                  tile_n=tn, tile_k=tk)
    return w, table, tt, bc, tbc.build_lut(table)


@pytest.mark.parametrize("n,k,groups,m", K1_CASES)
def test_k1_groups_plain_matches_reference_kernel(n, k, groups, m):
    """Bitwise on integer x against the reference's K1 (the Pallas kernel
    body in interpret mode) over the same planes."""
    w, table, tt, _, lut = _k1_operands(n, k, groups)
    jt = jpack_tiled(jnp.asarray(w), table, jbc.build_lut(table), groups,
                     tile="auto")
    x = np.random.default_rng(3).integers(-4, 5, (m, k)).astype(np.float32)
    want = jfdm.fused_decode_matmul(
        jnp.asarray(x), jt.codes, jt.literals, jnp.asarray(lut.numpy()),
        jt.scale, jt.zero, shape=(n, k), tile_n=jt.tile_n, tile_k=jt.tile_k,
        bm=m, interpret=True)
    got = fdm.fused_decode_matmul_plain(
        torch.from_numpy(x), tt.codes, tt.literals, lut, tt.scale, tt.zero,
        shape=(n, k), tile_n=tt.tile_n, tile_k=tt.tile_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,k,groups,m", K1_CASES)
def test_k1_groups_plain_equals_untiled(n, k, groups, m):
    """K1's plain version over G groups equals it at G = 1 on the same
    weight's untiled planes with the same tiles: the same strips in the
    same order (bitwise on integer and on random x)."""
    _, _, tt, bc, lut = _k1_operands(n, k, groups)
    kw = dict(shape=(n, k), tile_n=tt.tile_n, tile_k=tt.tile_k)
    gen = torch.Generator().manual_seed(4)
    for x in (torch.randint(-4, 5, (m, k), generator=gen).float(),
              torch.randn((m, k), generator=gen).to(torch.bfloat16)):
        grouped = fdm.fused_decode_matmul(x, tt.codes, tt.literals, lut,
                                          tt.scale, tt.zero, **kw,
                                          out_dtype=torch.float32)
        single = fdm.fused_decode_matmul(x, bc.codes, bc.literals, lut,
                                         tt.scale, tt.zero, **kw,
                                         out_dtype=torch.float32)
        assert torch.equal(grouped, single)


@pytest.mark.parametrize("n,k,groups,m", K1_CASES)
def test_k1_groups_plain_within_reference_ref(n, k, groups, m):
    """Within 1e-4 of the output's scale of the reference's one-device
    tiled path on its CPU oracle (per-group affine outputs added)."""
    w, table, tt, _, lut = _k1_operands(n, k, groups)
    jt = jpack_tiled(jnp.asarray(w), table, jbc.build_lut(table), groups,
                     tile="auto")
    x = np.random.default_rng(5).standard_normal((m, k)).astype(np.float32)
    jops.DISPATCH_COUNTS.clear()
    want = np.asarray(jops.tiled_decode_dequant_matmul(
        jnp.asarray(x), jt, jnp.asarray(lut.numpy()), impl="ref",
        out_dtype=jnp.float32))
    assert jops.DISPATCH_COUNTS["tiled_fused"] == 1
    got = ops.tiled_decode_dequant_matmul(torch.from_numpy(x), tt, lut,
                                          out_dtype=torch.float32).numpy()
    assert ops.DISPATCH_COUNTS == {"tiled_fused": 1}
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_k1_groups_rejects_groups_that_do_not_tile():
    """The launch's checks, which run before anything reaches the card:
    a group count that does not divide K, or groups narrower than a K
    tile, raise."""
    _, _, tt, _, lut = _k1_operands(64, 512, 2)
    x = torch.zeros((1, 2, 512))
    codes = tt.codes.reshape(1, -1, tt.codes.shape[-1])
    lits = tt.literals.reshape((1, -1) + tuple(tt.literals.shape[-2:]))
    kw = dict(shape=(64, 512), tile_n=tt.tile_n, tile_k=tt.tile_k,
              out_dtype=torch.float32)
    with pytest.raises(ValueError, match="3 column groups"):
        fdm._launch(fdm.NAME, x, codes, lits, lut, tt.scale, tt.zero,
                    groups=3, **kw)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        fdm._launch(fdm.NAME, x, codes, lits, lut, tt.scale, tt.zero,
                    groups=4, **dict(kw, tile_k=256))


# -- the rungs -----------------------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "unfused", "materialize"])
def test_tiled_rungs_and_probes(impl):
    """Each rung on tile-major groups counts its probe and computes the
    same product: fused and unfused bitwise-close (another order of
    sums), materialize in f32."""
    w, table, tt, _, lut = _k1_operands(64, 512, 2)
    x = torch.randn((3, 512), generator=torch.Generator().manual_seed(6))
    dense = tt.materialize(lut, torch.float32)
    want = x @ dense.T
    ops.set_default_impl(impl)
    try:
        got = ops.tiled_decode_dequant_matmul(x, tt, lut,
                                              out_dtype=torch.float32)
    finally:
        ops.set_default_impl("auto")
    probe = {"auto": "tiled_fused", "unfused": "tiled_unfused",
             "materialize": "tiled_materialize"}[impl]
    assert ops.DISPATCH_COUNTS == {probe: 1}
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_linear_layout_groups_take_the_unfused_rung():
    w, _, table = _weight(64, 256)
    tt = pack_linear_tiled(torch.from_numpy(w), table, 4, tile=None)
    lut = tbc.build_lut(table)
    x = torch.randn((2, 256), generator=torch.Generator().manual_seed(7))
    y = TL.linear(x, tt, lut)
    assert ops.DISPATCH_COUNTS == {"tiled_unfused": 1}
    want = x @ tt.materialize(lut, torch.float32).T
    torch.testing.assert_close(y, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_materialize_weight_counts_tiled():
    w, _, table = _weight(64, 256)
    tt = pack_linear_tiled(torch.from_numpy(w), table, 2, tile="auto")
    lut = tbc.build_lut(table)
    dense = TL.materialize_weight(tt, lut)
    assert TL.MATERIALIZE_COUNTS == {"tiled": 1}
    assert dense.dtype == torch.bfloat16 and dense.shape == (64, 256)


# -- end to end ----------------------------------------------------------

def _reference_steps(jp, cfg, jlut, toks, n):
    prefill, decode_step = JE.make_serve_fns(cfg)
    t0 = toks.shape[1]
    caches = JLM.init_caches(cfg, toks.shape[0], t0 + n)
    logits, caches = prefill(jp, jlut, {"tokens": jnp.asarray(toks)}, caches)
    tokens, steps = [], []
    for i in range(n):
        steps.append(np.asarray(logits, np.float32))
        tokens.append(steps[-1].argmax(-1))
        if i < n - 1:
            logits, caches = decode_step(jp, jlut,
                                         jnp.asarray(tokens[-1][:, None]),
                                         caches, t0 + i)
    return np.stack(tokens, axis=1), steps


def test_tiled_generate_matches_reference(tiled):
    """Greedy tokens of the tiled state, on the reference's planes: every
    tiled projection on the tiled_fused rung, MLA's wkv_b absorbed from
    its tiled planes (counted 'tiled'), no expert stack materialized."""
    cfg, tcfg, jst, _, carried = tiled
    toks = _prompts(cfg.vocab_size)
    t0 = toks.shape[1]
    ref = np.asarray(JE.generate(jst.params, cfg, jnp.asarray(toks),
                                 ctx=JContext(cfg=cfg, lut=jst.lut),
                                 max_new=8))
    got = TE.generate(carried.params, tcfg, torch.from_numpy(toks),
                      ctx=ServeContext(tcfg, lut=carried.lut, device="cpu"),
                      max_new=8).numpy()
    assert set(ops.DISPATCH_COUNTS) <= {"tiled_fused", "grouped_fused"}
    assert ops.DISPATCH_COUNTS["tiled_fused"] > 0
    assert "packed" not in TL.MATERIALIZE_COUNTS
    assert "packed_stacked" not in TL.MATERIALIZE_COUNTS
    if tcfg.family == "moe":
        assert TL.MATERIALIZE_COUNTS["tiled"] == 8 * tcfg.n_layers
    np.testing.assert_array_equal(got[:, :t0], toks)
    if np.array_equal(got, ref):
        return
    tokens, steps = _reference_steps(jst.params, cfg, jst.lut, toks, 8)
    np.testing.assert_array_equal(tokens, ref[:, t0:])
    for r in np.nonzero((got != ref).any(axis=1))[0]:
        s = int(np.argmax(got[r, t0:] != ref[r, t0:]))
        logits = steps[s][r]
        assert logits[got[r, t0 + s]] == logits[ref[r, t0 + s]], (
            f"row {r} step {s}: port token {got[r, t0 + s]} is not tied "
            f"with the reference's {ref[r, t0 + s]}")


def test_engine_completions_equal_tiled_generate(tiled):
    _, tcfg, _, tst, _ = tiled
    ctx = ServeContext(tcfg, lut=tst.lut, device="cpu")
    eng = Engine(ctx, tst.params, n_slots=2, max_len=24, page_size=4)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, tcfg.vocab_size, int(rng.randint(4, 12)))
               .astype(np.int32) for _ in range(3)]
    for i, p in enumerate(prompts):
        eng.submit(Request(tokens=p, max_new=6, rid=i))
    eng.drain()
    assert ops.DISPATCH_COUNTS["tiled_fused"] > 0
    assert "tiled_unfused" not in ops.DISPATCH_COUNTS
    by_rid = {c.rid: c for c in eng.completions}
    for i, p in enumerate(prompts):
        want = TE.generate(tst.params, None, torch.from_numpy(p)[None],
                           ctx=ctx, max_new=6,
                           max_len=eng.pool.max_len)[0].numpy()
        np.testing.assert_array_equal(by_rid[i].tokens, want)
    eng.close()


def test_resilient_engine_rungs_on_tiled_state(tiled):
    """The ladder over a tiled state: the gate checks its planes; a fault
    at the request seam walks to unfused (K4 then K5) and to materialize,
    each counted, each rung's greedy tokens the fused rung's."""
    _, tcfg, _, tst, _ = tiled
    toks = _prompts(tcfg.vocab_size)
    reng = ResilientEngine(tcfg, tst, policy=ResiliencePolicy(
        max_retries=0, verify="full"), device="cpu")
    assert reng.verify_report.ok and reng.invariant_report.ok
    fused = reng.generate(toks, max_new=6)
    assert reng.last_rung == "fused"
    orig = TR._generate
    out = {}
    for rung, times in (("unfused", 1), ("materialize", 2)):
        ops.DISPATCH_COUNTS.clear()
        FALLBACK_COUNTS.clear()
        TR._generate = FaultInjector(0).failing(orig, times=times)
        try:
            out[rung] = reng.generate(toks, max_new=6)
        finally:
            TR._generate = orig
        assert reng.last_rung == rung
        assert FALLBACK_COUNTS[rung] == 1
        assert f"tiled_{rung}" in ops.DISPATCH_COUNTS
        assert "tiled_fused" not in ops.DISPATCH_COUNTS
        assert torch.equal(out[rung], fused), rung
    reng.close()
