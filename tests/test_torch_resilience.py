"""The port's degradation ladder and dispatch rungs against the JAX
package's, on the CPU.

  * ``ops.decode_dequant_matmul`` (2-D) and ``grouped_decode_dequant_matmul``
    at the ``unfused`` and ``materialize`` rungs, and on linear-layout
    planes, against the reference's ``impl='unfused'`` / ``'materialize'``
    on the same planes.  Tolerances: x in f32 — the two packages sum the
    same products in another order and the port's ``unfused`` takes K5's
    affine form where the reference dequantizes first, so 1e-5 of the
    output's largest magnitude; x in bf16 at ``materialize`` — the port
    multiplies in f32 where the reference rounds weight and product to
    bf16, so one bf16 ulp (2^-8) of it.
  * The ladder tests of ``tests/test_resilience.py`` on both packages
    under the same injected faults (Llama-3.2 and DeepSeek-V2-Lite at
    smoke width, ``min_weight_size=1024``): the same ``last_rung``, the
    same ``FALLBACK_COUNTS``, and the port's greedy tokens on every rung
    equal to its clean fused run and to the reference's.  Fused and
    unfused logits differ in the order of their sums (K1 in strips, K5 in
    one product): greedy tokens are held equal, and the logits of the
    prefill within 2e-2 (a few bf16 ulps at |logit| ≈ 1).
"""
import contextlib
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.core import blocked_codec as jbc
from repro.core import codec as jcodec
from repro.core.compressed import pack_expert_stack as jpack_expert_stack
from repro.core.compressed import pack_linear
from repro.kernels import ops as jops
from repro.models import lm as JLM
from repro.serve import engine as JE
from repro.serve import resilience as JR
from repro.serve.context import ServeContext as JContext
from repro.testing import FaultInjector as JInjector

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core.compressed import PackedLinear
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import _build, ops
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as TE
from repro_torch.serve import resilience as TR
from repro_torch.serve.resilience import (FALLBACK_COUNTS, DeadlineExceeded,
                                          ResiliencePolicy, ResilientEngine,
                                          ServeRefused)
from repro_torch.testing import FaultInjector

torch.set_num_threads(2)
ARCHS = ["llama3.2-1b", "deepseek-v2-lite-16b"]


@pytest.fixture(autouse=True)
def _clear_counts():
    FALLBACK_COUNTS.clear()
    ops.DISPATCH_COUNTS.clear()
    _build.LAUNCH_COUNTS.clear()
    ops.set_default_impl("auto")
    yield
    assert ops._DEFAULT_IMPL == "auto", "the lever was left set"
    assert not _build.LAUNCH_COUNTS, "a CPU call launched a kernel"


@contextlib.contextmanager
def _lever(impl):
    """Pin the dispatch lever to ``impl``, as the ladder does for a rung."""
    ops.set_default_impl(impl)
    try:
        yield
    finally:
        ops.set_default_impl("auto")


# -- the dispatch lever and its rungs -----------------------------------

def test_impl_enum_is_the_one_home():
    assert ops.Impl("unfused") is ops.Impl.UNFUSED
    assert str(ops.Impl.UNFUSED) == "unfused"
    assert f"x+{ops.Impl.MATERIALIZE}" == "x+materialize"
    assert ops.VALID_IMPLS == frozenset(i.value for i in ops.Impl) \
        == {"auto", "unfused", "materialize"}
    assert ops.VALID_IMPLS < jops.VALID_IMPLS      # no backend selectors
    assert ops.DEFAULT_LADDER == ResiliencePolicy().ladder \
        == jops.DEFAULT_LADDER
    assert ops.FUSED_RUNG == jops.FUSED_RUNG
    assert ops._DEFAULT_IMPL == "auto" and not ops.plain_decode()
    try:
        ops.set_default_impl(ops.Impl.MATERIALIZE)
        assert ops._DEFAULT_IMPL == "materialize" and ops.plain_decode()
        for bad in ("warp-speed", "pallas", "ref"):
            with pytest.raises(ValueError):
                ops.set_default_impl(bad)
    finally:
        ops.set_default_impl("auto")


def _weight(shape, seed):
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal(shape) * 3).astype(np.float32) / 3


def _table(ws):
    from repro.core.compressed import quantize_linear
    vals = [np.asarray(quantize_linear(jnp.asarray(w)).values) for w in ws]
    return jcodec.find_frequent_sequences(vals)


def _port(pl) -> PackedLinear:
    """A reference PackedLinear's planes as the port's container."""
    return PackedLinear(
        torch.from_numpy(np.array(pl.codes).view(np.int16)),
        torch.from_numpy(np.array(pl.literals)),
        torch.from_numpy(np.array(pl.nlit)),
        torch.from_numpy(np.array(pl.scale)),
        torch.from_numpy(np.array(pl.zero)), shape=tuple(pl.shape),
        tile_n=pl.tile_n, tile_k=pl.tile_k)


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    atol = (2.0 ** -8 if dtype == "bf16" else 1e-5) * scale
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("shape,m", [((64, 128), 3), ((96, 160), 5),
                                     ((256, 64), 16)])
@pytest.mark.parametrize("layout", ["tiled", "linear"])
@pytest.mark.parametrize("impl,dtype", [("unfused", "f32"),
                                        ("materialize", "f32"),
                                        ("materialize", "bf16")])
def test_rungs_match_reference(shape, m, layout, impl, dtype):
    """2-D planes at the ladder's rungs, and linear-layout planes at
    'auto' (the unfused path), against the reference's same impl."""
    w = _weight(shape, 1)
    table = _table([w])
    lut = jbc.build_lut(table)
    pl = pack_linear(jnp.asarray(w), table, lut,
                     tile="auto" if layout == "tiled" else None)
    assert bool(pl.tile_n) == (layout == "tiled")
    x = _x((2, m, shape[1]), 2, dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = jops.decode_dequant_matmul(jnp.asarray(x, jdt), pl, lut,
                                      out_dtype=jnp.float32, impl=impl)
    with _lever(impl):
        got = ops.decode_dequant_matmul(torch.tensor(x).to(tdt), _port(pl),
                                        torch.from_numpy(np.array(lut)),
                                        out_dtype=torch.float32)
    assert got.shape == (2, m, shape[0])
    _close(got, want, dtype)
    assert dict(ops.DISPATCH_COUNTS) == {impl: 1}
    if layout == "linear" and impl == "unfused":
        # at 'auto' the linear layout takes the unfused path too
        auto = ops.decode_dequant_matmul(torch.from_numpy(x), _port(pl),
                                         torch.from_numpy(np.array(lut)),
                                         out_dtype=torch.float32)
        assert torch.equal(auto, got)
        assert ops.DISPATCH_COUNTS["unfused"] == 2


@pytest.mark.parametrize("e,n,k,cap", [(3, 64, 128, 4), (5, 48, 64, 7)])
@pytest.mark.parametrize("layout", ["tiled", "linear"])
@pytest.mark.parametrize("impl,dtype", [("unfused", "f32"),
                                        ("materialize", "f32"),
                                        ("materialize", "bf16")])
def test_grouped_rungs_match_reference(e, n, k, cap, layout, impl, dtype):
    ws = [_weight((n, k), 10 + i) for i in range(e)]
    jpl, jlut = jpack_expert_stack([jnp.asarray(w) for w in ws],
                                   tile="auto" if layout == "tiled"
                                   else None)
    assert bool(jpl.tile_n) == (layout == "tiled")
    x = _x((e, cap, k), 3, dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = jops.grouped_decode_dequant_matmul(
        jnp.asarray(x, jdt), jpl, jlut, out_dtype=jnp.float32, impl=impl)
    with _lever(impl):
        got = ops.grouped_decode_dequant_matmul(
            torch.from_numpy(x).to(tdt), _port(jpl),
            torch.from_numpy(np.array(jlut)), out_dtype=torch.float32)
    assert got.shape == (e, cap, n)
    _close(got, want, dtype)
    probe = "grouped_" + impl
    assert dict(ops.DISPATCH_COUNTS) == {probe: 1}
    if layout == "linear" and impl == "unfused":
        auto = ops.grouped_decode_dequant_matmul(
            torch.from_numpy(x), _port(jpl),
            torch.from_numpy(np.array(jlut)), out_dtype=torch.float32)
        assert torch.equal(auto, got)


def test_fused_rung_is_the_default_and_bitwise_on_integer_x():
    """At 'auto' tile-major planes take the fused path; on integer x its
    products are exact, so fused and unfused agree bitwise."""
    w = _weight((128, 256), 4)
    table = _table([w])
    lut = jbc.build_lut(table)
    tpl = _port(pack_linear(jnp.asarray(w), table, lut, tile="auto"))
    tlut = torch.from_numpy(np.array(lut))
    x = torch.randint(-4, 5, (4, 256), generator=torch.Generator()
                      .manual_seed(0)).to(torch.bfloat16)
    fused = ops.decode_dequant_matmul(x, tpl, tlut, out_dtype=torch.float32)
    with _lever("unfused"):
        unfused = ops.decode_dequant_matmul(x, tpl, tlut,
                                            out_dtype=torch.float32)
    assert torch.equal(fused, unfused)
    assert dict(ops.DISPATCH_COUNTS) == {"fused": 1, "unfused": 1}


# -- the ladder, both packages under the same faults ---------------------

@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """(reference cfg, port cfg, reference state, port state, prompts,
    the reference's and the port's clean greedy tokens)."""
    cfg = get_config(request.param).smoke
    tcfg = tget_config(request.param).smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    jst = JE.build_serve_params(params, JPolicy(mode="compressed",
                                                min_weight_size=1024))
    tst = TE.build_serve_params(
        convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  tcfg, device="cpu"),
        CompressionPolicy(mode="compressed", min_weight_size=1024),
        device="cpu")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                         cfg.vocab_size))
    jref = np.asarray(JE.generate(jst.params, cfg, jnp.asarray(toks),
                                  ctx=JContext(cfg=cfg, lut=jst.lut),
                                  max_new=4))
    tref = TE.generate(tst.params, tcfg, torch.from_numpy(toks), lut=tst.lut,
                       max_new=4, device="cpu").numpy()
    np.testing.assert_array_equal(tref, jref)
    return cfg, tcfg, jst, tst, toks, tref


def _renamed(cfg, tag):
    return dataclasses.replace(cfg, name=f"{cfg.name}-{tag}")


def _with_seam(module, wrap, fn):
    """Run fn() with ``module._generate`` replaced by wrap(original)."""
    orig = module._generate
    module._generate = wrap(orig)
    try:
        return fn()
    finally:
        module._generate = orig


def test_ladder_falls_back_to_unfused_on_decode_fault(served):
    """A persistent fault in the fused compressed matmul: both packages
    leave the fused rung for the unfused one, and the port's tokens there
    equal its clean fused run's; its fused rung's graph is dropped."""
    cfg, tcfg, jst, tst, toks, tref = served
    jeng = JR.ResilientEngine(_renamed(cfg, "trl-ladder"), jst,
                              policy=JR.ResiliencePolicy(max_retries=0,
                                                         verify="fast"))
    with JInjector().decode_fault(nth=1):
        jout = np.asarray(jeng.generate(jnp.asarray(toks), max_new=4))
    jcounts = dict(JR.FALLBACK_COUNTS)
    tcfgf = _renamed(tcfg, "ladder")
    eng = ResilientEngine(tcfgf, tst, policy=ResiliencePolicy(
        max_retries=0, verify="fast"), device="cpu")
    with FaultInjector().decode_fault(nth=1) as probe:
        out = eng.generate(torch.from_numpy(toks), max_new=4).numpy()
    assert probe.executions == 1
    np.testing.assert_array_equal(out, tref)
    np.testing.assert_array_equal(jout, tref)
    assert eng.last_rung == jeng.last_rung == "unfused"
    assert dict(FALLBACK_COUNTS) == jcounts == {"unfused": 1}
    assert ops.DISPATCH_COUNTS["unfused"] > 0
    assert "fused" not in ops.DISPATCH_COUNTS
    if tcfg.family == "moe":
        assert ops.DISPATCH_COUNTS["grouped_unfused"] > 0
    h = eng.health()
    assert h["last_rung"] == "unfused" and len(h["recent_errors"]) == 1
    assert "injected decode fault" in h["recent_errors"][0][2]
    kept = {k[0].name for k in TE._GRAPHS}
    assert tcfgf.name not in kept and f"{tcfgf.name}+unfused" in kept


@pytest.mark.parametrize("times,rung", [(2, "materialize"), (1, "unfused")])
def test_ladder_walks_the_rungs(served, times, rung):
    """Faults at the request seam on the first rungs push the request
    down; FALLBACK_COUNTS records each rung entered, in both packages,
    and every rung's tokens equal the fused rung's."""
    cfg, tcfg, jst, tst, toks, tref = served
    jeng = JR.ResilientEngine(_renamed(cfg, f"trl-walk{times}"), jst,
                              policy=JR.ResiliencePolicy(max_retries=0))
    jout = _with_seam(JR, lambda f: JInjector().failing(f, times=times),
                      lambda: jeng.generate(jnp.asarray(toks), max_new=4))
    jcounts = dict(JR.FALLBACK_COUNTS)
    eng = ResilientEngine(_renamed(tcfg, f"walk{times}"), tst,
                          policy=ResiliencePolicy(max_retries=0),
                          device="cpu")
    out = _with_seam(TR, lambda f: FaultInjector().failing(f, times=times),
                     lambda: eng.generate(torch.from_numpy(toks), max_new=4))
    assert eng.last_rung == jeng.last_rung == rung
    assert dict(FALLBACK_COUNTS) == jcounts
    assert FALLBACK_COUNTS[rung] == 1 and len(eng.health()[
        "recent_errors"]) == times
    np.testing.assert_array_equal(out.numpy(), tref)
    assert np.asarray(jout).shape == tref.shape
    probe = {"materialize": "materialize", "unfused": "unfused"}[rung]
    assert ops.DISPATCH_COUNTS[probe] > 0
    assert set(ops.DISPATCH_COUNTS) <= {probe, "grouped_" + probe}


def test_transient_fault_recovers_by_retry(served):
    cfg, tcfg, jst, tst, toks, tref = served
    jeng = JR.ResilientEngine(cfg, jst,
                              policy=JR.ResiliencePolicy(max_retries=1))
    _with_seam(JR, lambda f: JInjector().failing(f, times=1),
               lambda: jeng.generate(jnp.asarray(toks), max_new=4))
    eng = ResilientEngine(tcfg, tst, policy=ResiliencePolicy(max_retries=1),
                          device="cpu")
    out = _with_seam(TR, lambda f: FaultInjector().failing(f, times=1),
                     lambda: eng.generate(torch.from_numpy(toks), max_new=4))
    np.testing.assert_array_equal(out.numpy(), tref)
    assert eng.last_rung == jeng.last_rung == "fused"
    assert dict(FALLBACK_COUNTS) == dict(JR.FALLBACK_COUNTS) \
        == {"retry:fused": 1}


@pytest.mark.parametrize("ladder", [("fused",), ops.DEFAULT_LADDER])
def test_ladder_exhausted_refuses_with_diagnostics(served, ladder):
    """Every rung failing (a sticky fault) ends in ServeRefused with the
    per-rung diagnostics, in both packages, and does not hang."""
    cfg, tcfg, jst, tst, toks, _ = served
    jeng = JR.ResilientEngine(_renamed(cfg, f"trl-refuse{len(ladder)}"),
                              jst, policy=JR.ResiliencePolicy(
                                  max_retries=1, ladder=ladder))
    with pytest.raises(JR.ServeRefused) as jei:
        _with_seam(JR, lambda f: JInjector().failing(f, times=10),
                   lambda: jeng.generate(jnp.asarray(toks), max_new=4))
    eng = ResilientEngine(tcfg, tst, policy=ResiliencePolicy(
        max_retries=1, ladder=ladder), device="cpu")
    with pytest.raises(ServeRefused) as ei:
        _with_seam(TR, lambda f: FaultInjector().failing(f, times=10),
                   lambda: eng.generate(torch.from_numpy(toks), max_new=4))
    assert dict(FALLBACK_COUNTS) == dict(JR.FALLBACK_COUNTS)
    assert FALLBACK_COUNTS["refused"] == 1
    assert [(r, a) for r, a, _ in ei.value.errors] \
        == [(r, a) for r, a, _ in jei.value.errors] \
        == [(r, a) for r in ladder for a in (0, 1)]
    assert eng.last_rung is None


def test_deadline_expires_mid_ladder(served):
    cfg, tcfg, jst, tst, toks, _ = served

    def slow(exc):
        def fail(*a, **kw):
            time.sleep(0.06)
            raise exc("injected slow fault")
        return lambda f: fail

    jeng = JR.ResilientEngine(cfg, jst, policy=JR.ResiliencePolicy(
        max_retries=3, deadline_s=0.05))
    with pytest.raises(JR.DeadlineExceeded):
        _with_seam(JR, slow(jax.errors.JaxRuntimeError),
                   lambda: jeng.generate(jnp.asarray(toks), max_new=4))
    eng = ResilientEngine(tcfg, tst, policy=ResiliencePolicy(
        max_retries=3, deadline_s=0.05), device="cpu")
    with pytest.raises(DeadlineExceeded):
        _with_seam(TR, slow(torch.AcceleratorError),
                   lambda: eng.generate(torch.from_numpy(toks), max_new=4))
    assert dict(FALLBACK_COUNTS) == dict(JR.FALLBACK_COUNTS) \
        == {"deadline": 1}


def test_other_errors_do_not_walk_the_ladder(served):
    """A bare RuntimeError (what a shape bug raises) propagates from the
    fused rung at once: only device faults walk the ladder."""
    _, tcfg, _, tst, toks, _ = served
    eng = ResilientEngine(tcfg, tst, device="cpu")

    def broken(*a, **kw):
        raise RuntimeError("shape mismatch")

    with pytest.raises(RuntimeError, match="shape mismatch"):
        _with_seam(TR, lambda f: broken,
                   lambda: eng.generate(torch.from_numpy(toks), max_new=4))
    assert not FALLBACK_COUNTS and eng.last_rung is None


def test_prefill_walks_the_ladder(served):
    """ResilientEngine.prefill under a decode fault serves on the unfused
    rung; its logits are the clean fused prefill's within 2e-2 and its
    argmax the same."""
    _, tcfg, _, tst, toks, _ = served
    batch = {"tokens": torch.from_numpy(toks)}

    def caches():
        return TLM.init_caches(tcfg, 2, 12, device="cpu")

    prefill, _ = TE.make_serve_fns(tcfg, device="cpu")
    clean, _ = prefill(tst.params, tst.lut, batch, caches())
    eng = ResilientEngine(_renamed(tcfg, "prefill"), tst,
                          policy=ResiliencePolicy(max_retries=0),
                          device="cpu")
    with FaultInjector().decode_fault(nth=3):
        logits, _ = eng.prefill(batch, caches())
    assert eng.last_rung == "unfused" and dict(FALLBACK_COUNTS) == {
        "unfused": 1}
    assert (logits.float() - clean.float()).abs().max().item() <= 2e-2
    assert torch.equal(logits.argmax(-1), clean.argmax(-1))
