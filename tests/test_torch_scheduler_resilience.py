"""The port's continuous-batching engine under faults, against the JAX
package's, on the CPU.

Mirrors the resilient-scheduler tests of ``tests/test_scheduler.py``, on
both packages under the same injected faults (Llama-3.2 smoke,
``min_weight_size=1024``, weights from PRNGKey 0, each package packing
them itself): the same ``last_rung``, the same ``FALLBACK_COUNTS``, the
same refused request, and completions bitwise equal to the clean run's and
to the reference's.  Also: a failed launch raises ``torch.AcceleratorError``
(``kernels._build.check``), which the engine quarantines.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.models import lm as JLM
from repro.serve import engine as JE
from repro.serve import resilience as JR
from repro.serve.context import ServeContext as JContext
from repro.serve.scheduler import Engine as JEngine
from repro.serve.scheduler import Request as JRequest
from repro.testing import FaultInjector as JInjector

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import _build, ops
from repro_torch.serve import engine as TE
from repro_torch.serve import scheduler as TS
from repro_torch.serve.context import ServeContext
from repro_torch.serve.resilience import (FALLBACK_COUNTS, ResiliencePolicy,
                                          ResilientEngine)
from repro_torch.serve.scheduler import Engine, Request
from repro_torch.testing import FaultInjector

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clear_counts():
    FALLBACK_COUNTS.clear()
    ops.DISPATCH_COUNTS.clear()
    yield
    assert ops._DEFAULT_IMPL == "auto", "the lever was left set"


@pytest.fixture(scope="module")
def served():
    """(reference cfg, port cfg, reference state, port state)."""
    cfg = get_config("llama3.2-1b").smoke
    tcfg = tget_config("llama3.2-1b").smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    jst = JE.build_serve_params(params, JPolicy(mode="compressed",
                                                min_weight_size=1024))
    tst = TE.build_serve_params(
        convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  tcfg, device="cpu"),
        CompressionPolicy(mode="compressed", min_weight_size=1024),
        device="cpu")
    return cfg, tcfg, jst, tst


def _prompts(vocab, n, seed):
    """tests/test_scheduler.py's prompts."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, int(rng.randint(4, 12))).astype(np.int32)
            for _ in range(n)]


def _tokens(eng):
    return {c.rid: np.asarray(c.tokens) for c in eng.completions}


def _run(make_engine, request, prompts, max_new, fault=None,
         until_refused=False):
    """Submit ``prompts`` to a fresh engine, step (under ``fault``, a
    context manager factory, if given) and drain.  → (engine, probe)."""
    eng = make_engine()
    for i, p in enumerate(prompts):
        eng.submit(request(tokens=p, max_new=max_new, rid=i))
    probe = None
    if fault is not None:
        with fault() as probe:
            if until_refused:
                while not any(c.finished == "refused"
                              for c in eng.completions):
                    eng.step()
            else:
                eng.drain()
    eng.drain()
    return eng, probe


def _both(served, tag, *, n, max_new, seed, jfault=None, tfault=None,
          until_refused=False, resilient=True, n_slots=None, trim=None):
    """The same trace through the reference's and the port's engine (under
    ``ResilientEngine.scheduler()`` when ``resilient``), each under its own
    package's fault.  → ((reference engine, its ResilientEngine, probe),
    (port engine, its ResilientEngine, probe), reference FALLBACK_COUNTS)."""
    cfg, tcfg, jst, tst = served
    prompts = _prompts(cfg.vocab_size, n, seed)
    if trim:
        prompts = [p[:trim] for p in prompts]
    slots = n_slots or n
    jcfg = dataclasses.replace(cfg, name=f"{cfg.name}-trs-{tag}")
    tcfgr = dataclasses.replace(tcfg, name=f"{tcfg.name}-{tag}")
    out = []
    for pkg, c, st in (("ref", jcfg, jst), ("port", tcfgr, tst)):
        holder = {}
        if pkg == "ref":
            def make():
                if resilient:
                    holder["r"] = JR.ResilientEngine(
                        c, st, policy=JR.ResiliencePolicy(max_retries=0))
                    return holder["r"].scheduler(n_slots=slots, max_len=16)
                return JEngine(JContext.from_state(c, st), st.params,
                               n_slots=slots, max_len=16)
            eng, probe = _run(make, JRequest, prompts, max_new, jfault,
                              until_refused)
        else:
            def make():
                if resilient:
                    holder["r"] = ResilientEngine(
                        c, st, policy=ResiliencePolicy(max_retries=0),
                        device="cpu")
                    return holder["r"].scheduler(n_slots=slots, max_len=16)
                return Engine(ServeContext.from_state(c, st, device="cpu"),
                              st.params, n_slots=slots, max_len=16)
            eng, probe = _run(make, Request, prompts, max_new, tfault,
                              until_refused)
        out.append((eng, holder.get("r"), probe))
        if pkg == "ref":
            jcounts = dict(JR.FALLBACK_COUNTS)
    return out[0], out[1], jcounts


def _generate(tst, tcfg, prompt, max_new, max_len):
    return TE.generate(tst.params, tcfg, torch.from_numpy(prompt)[None],
                       lut=tst.lut, max_new=max_new, max_len=max_len,
                       device="cpu")[0].numpy()


def test_resilient_scheduler_ladder_on_decode_fault(served):
    """A persistent fused-path fault: the guard walks every prefill and
    tick down to the unfused rung, in both packages alike, and the
    completions equal the clean run's and the reference's."""
    clean_j, clean_t, _ = _both(served, "clean", n=2, max_new=4, seed=13)
    (jeng, jr, _), (teng, tr, _), jcounts = _both(
        served, "fault", n=2, max_new=4, seed=13,
        jfault=lambda: JInjector().decode_fault(nth=1),
        tfault=lambda: FaultInjector().decode_fault(nth=1))
    assert tr.last_rung == jr.last_rung == "unfused"
    assert dict(FALLBACK_COUNTS) == jcounts and jcounts["unfused"] >= 1
    want = _tokens(clean_t[0])
    assert _tokens(teng).keys() == want.keys() == {0, 1}
    for rid, toks in _tokens(teng).items():
        np.testing.assert_array_equal(toks, want[rid])
        np.testing.assert_array_equal(toks, _tokens(clean_j[0])[rid])
        np.testing.assert_array_equal(toks, _tokens(jeng)[rid])
    assert tr.health()["fallbacks"] == jcounts


def test_quarantine_refuses_exactly_one_of_mixed_batch(served):
    """A single-slot fault in a 3-request mixed batch (a bare engine): the
    bisection refuses exactly that request; the survivors resume and end
    bitwise equal to the port's generate, and to the reference's."""
    _, tcfg, _, tst = served
    (jeng, _, _), (teng, _, _), jcounts = _both(
        served, "quar", n=3, max_new=4, seed=37, trim=6, resilient=False,
        jfault=lambda: JInjector().slot_fault(slot=1, nth=1),
        tfault=lambda: FaultInjector().slot_fault(slot=1, nth=1),
        until_refused=True)
    by_rid = {c.rid: c for c in teng.completions}
    assert by_rid[1].finished == "refused" and "poisoned" in by_rid[1].error
    assert [c.rid for c in jeng.completions if c.finished == "refused"] \
        == [1]
    assert dict(FALLBACK_COUNTS) == jcounts == {"quarantine": 1}
    for i in (0, 2):
        assert by_rid[i].finished == "max_new" and by_rid[i].resumed == 1
        np.testing.assert_array_equal(
            by_rid[i].tokens, _generate(tst, tcfg, by_rid[i].prompt, 4,
                                        teng.pool.max_len))
        np.testing.assert_array_equal(by_rid[i].tokens,
                                      _tokens(jeng)[i])


def test_quarantine_after_exhausted_ladder(served):
    """Under ResilientEngine the poisoned request first exhausts the
    ladder (the fault follows the request, on every rung); the
    ServeRefused drives the same bisection, in both packages alike."""
    (jeng, _, _), (teng, tr, _), jcounts = _both(
        served, "exhaust", n=3, max_new=3, seed=39, trim=6,
        jfault=lambda: JInjector().slot_fault(slot=1, nth=1),
        tfault=lambda: FaultInjector().slot_fault(slot=1, nth=1),
        until_refused=True)
    refused = [c for c in teng.completions if c.finished == "refused"]
    assert len(refused) == 1 and refused[0].rid == 1
    assert "ServeRefused" in refused[0].error
    assert dict(FALLBACK_COUNTS) == jcounts
    assert FALLBACK_COUNTS["quarantine"] == 1
    assert FALLBACK_COUNTS["refused"] >= 1
    survivors = [c for c in teng.completions if c.rid != 1]
    assert all(c.finished == "max_new" and c.resumed == 1
               for c in survivors)
    for c in survivors:
        np.testing.assert_array_equal(c.tokens, _tokens(jeng)[c.rid])


def test_decode_fault_mid_mixed_batch_walks_ladder(served):
    """A decode fault calibrated on a clean run (FaultProbe) to fire just
    past the first mixed tick: the ladder serves on the unfused rung and
    the completions equal the clean run's; the calibration (executions to
    the first tick) is the reference's, so the fault fires at the same
    execution in both packages."""
    cfg, tcfg, jst, tst = served
    prompts = [p[:6] for p in _prompts(cfg.vocab_size, 2, seed=41)]

    def run(tag, nth, pkg):
        if pkg == "ref":
            r = JR.ResilientEngine(
                dataclasses.replace(cfg, name=f"{cfg.name}-trs-mid-{tag}"),
                jst, policy=JR.ResiliencePolicy(max_retries=0))
            eng, req, inj = r.scheduler(n_slots=2, max_len=16), JRequest, \
                JInjector()
        else:
            r = ResilientEngine(
                dataclasses.replace(tcfg, name=f"{tcfg.name}-mid-{tag}"),
                tst, policy=ResiliencePolicy(max_retries=0), device="cpu")
            eng, req, inj = r.scheduler(n_slots=2, max_len=16), Request, \
                FaultInjector()
        for i, p in enumerate(prompts):
            eng.submit(req(tokens=p, max_new=5, rid=i))
        with inj.decode_fault(nth=nth) as probe:
            eng.step()                  # both admitted; first mixed tick
            at_tick1 = probe.executions
            eng.drain()
        assert eng.health()["occupancy_max"] == 2
        return r, at_tick1, _tokens(eng)

    _, at_tick1, clean = run("clean", 1 << 30, "port")
    _, j_at_tick1, _ = run("clean", 1 << 30, "ref")
    assert at_tick1 == j_at_tick1 == 3 * 7 * tcfg.n_layers
    jr, _, jfaulty = run("fault", at_tick1 + 1, "ref")
    jcounts = dict(JR.FALLBACK_COUNTS)
    r, _, faulty = run("fault", at_tick1 + 1, "port")
    assert r.last_rung == jr.last_rung == "unfused"
    assert dict(FALLBACK_COUNTS) == jcounts and jcounts["unfused"] >= 1
    for rid in clean:
        np.testing.assert_array_equal(faulty[rid], clean[rid])
        np.testing.assert_array_equal(faulty[rid], jfaulty[rid])


def test_launch_error_is_a_device_fault(served):
    """``_build.check`` raises ``torch.AcceleratorError`` on a nonzero
    CUDA error code (nothing on 0), and the engine quarantines it as a
    device fault: a slot whose step hits it is refused alone."""
    _, tcfg, _, tst = served
    assert _build.check(0, "k") is None
    with pytest.raises(torch.AcceleratorError, match="error 700"):
        _build.check(700, "fused_decode_matmul")
    orig = TS._generate_step

    def failing(engine, cfg, mask):
        if mask[1]:
            _build.check(700, "fused_decode_matmul")
        return orig(engine, cfg, mask)

    eng = Engine(ServeContext.from_state(tcfg, tst, device="cpu"),
                 tst.params, n_slots=3, max_len=16)
    prompts = _prompts(tcfg.vocab_size, 3, seed=43)
    for i, p in enumerate(prompts):
        eng.submit(Request(tokens=p[:6], max_new=3, rid=i))
    TS._generate_step = failing
    try:
        while not any(c.finished == "refused" for c in eng.completions):
            eng.step()
    finally:
        TS._generate_step = orig
    eng.drain()
    by_rid = {c.rid: c for c in eng.completions}
    assert by_rid[1].finished == "refused"
    assert "AcceleratorError" in by_rid[1].error
    assert all(by_rid[i].finished == "max_new" for i in (0, 2))
    assert dict(FALLBACK_COUNTS) == {"quarantine": 1}


def test_alloc_failure_injection_both_seams(served):
    _, tcfg, _, tst = served
    p = _prompts(tcfg.vocab_size, 1, seed=33)[0][:6]
    inj = FaultInjector()
    ctx = ServeContext.from_state(tcfg, tst, device="cpu")
    eng = Engine(ctx, tst.params, n_slots=1, max_len=16)
    eng.submit(Request(tokens=p, max_new=2, rid=0))
    with inj.alloc_failure(times=1) as probe:
        eng.step()
        assert eng.health()["queued"] == 1      # blocked, not crashed
    assert probe.executions == 1
    [c] = eng.drain()
    assert c.finished == "max_new"
    eng = Engine(ctx, tst.params, n_slots=1, max_len=16)
    eng.submit(Request(tokens=p, max_new=2, rid=0))
    with inj.alloc_failure(times=1, seam="alloc") as probe:
        eng.step()
        assert eng.health()["queued"] == 1
    assert probe.executions == 1
    [c] = eng.drain()
    assert c.finished == "max_new"
    with pytest.raises(ValueError, match="seam"):
        with inj.alloc_failure(seam="free"):
            pass


def test_drain_error_carries_health_and_slot_state(served):
    _, tcfg, _, tst = served
    [p] = _prompts(tcfg.vocab_size, 1, seed=35)
    eng = Engine(ServeContext.from_state(tcfg, tst, device="cpu"),
                 tst.params, n_slots=1, max_len=16)
    eng.submit(Request(tokens=p, max_new=2, rid=0))
    with FaultInjector().alloc_failure(times=1 << 30):
        with pytest.raises(RuntimeError, match="did not converge") as ei:
            eng.drain(max_steps=3)
    msg = str(ei.value)
    assert "health=" in msg and "queued rids=[0]" in msg


def test_resilient_scheduler_serves_the_state_and_closes(served):
    """ResilientEngine.scheduler() serves the engine's state (its LUT,
    the fused rung on a clean run; on the CPU no graph is captured, the
    step runs eagerly), and leaving the engine drops its graphs."""
    _, tcfg, _, tst = served
    with ResilientEngine(tcfg, tst, policy=ResiliencePolicy(verify="fast"),
                         device="cpu") as reng:
        eng = reng.scheduler(n_slots=2, max_len=16)
        assert eng.ctx.lut is tst.lut and eng.ctx.cfg is tcfg
        eng.submit(Request(tokens=np.arange(1, 6, dtype=np.int32),
                           max_new=3))
        [c] = eng.drain()
        assert c.finished == "max_new" and reng.last_rung == "fused"
    assert not eng._graphs and not eng._resume_graphs
    assert not FALLBACK_COUNTS
