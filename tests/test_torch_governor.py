"""The port's memory-pressure governor and elastic KV pool, on the CPU.

Mirrors ``tests/test_governor.py`` case for case, on the port
(``repro_torch/serve/governor.py``, ``serve/kv_cache.py``'s
``retire_pages`` / ``restore_pages``, the engine's governor hooks): under
any pressure trace (step, spike, ramp, oscillate) the engine reclaims at
the next step fence, ends every request as an accounted ``Completion``,
serves survivors bitwise equal to an unpressured run (the port's
``generate`` of the prompt alone), never thrashes (oscillation inside a
hysteresis band changes no plan), and trims the expert cache before any
KV page goes.  On the card a released or grown page tail moves the page
tensors and the engine captures its tick anew; here there is no capture,
so the tests hold the page moves to the plan changes (the card test
holds ``CAPTURE_COUNTS['generate_step'] <= 1 + plan_changes``).

Against the reference, on the same inputs: ``pressure_trace`` arrays for
every kind and seed, ``DeviceBudget`` / ``device_budget``'s integers, and
the governor's plans over the same budget traces (with and without a
residency manager), step by step.

The port's pool keeps a sink page beside its ``n_pages`` (inactive slots
write there), so its device bytes are ``(usable + 1) * page_nbytes``
where the reference's are ``usable * page_nbytes``.

Llama-3.2's smoke config (and DeepSeek-V2-Lite's for the expert cache),
``CompressionPolicy(min_weight_size=1024)``.
"""
import dataclasses
import itertools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.core import policy as JP
from repro.models import lm as JLM
from repro.serve import engine as JE
from repro.serve import governor as JG
from repro.serve import residency as JRes
from repro.serve.context import ServeContext as JContext
from repro.serve.scheduler import Engine as JEngine
from repro.testing import FaultInjector as JInjector
from repro.testing import pressure_trace as jpressure_trace

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core import policy as TP
from repro_torch.core.policy import CompressionPolicy, device_budget
from repro_torch.kernels import _build
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as TE
from repro_torch.serve.context import ServeContext
from repro_torch.serve.governor import MemoryGovernor
from repro_torch.serve.kv_cache import PagedKVPool, PoolError
from repro_torch.serve.residency import RESIDENCY_COUNTS, ResidencyManager
from repro_torch.serve.resilience import FALLBACK_COUNTS
from repro_torch.serve.scheduler import Engine, Request
from repro_torch.testing import FaultInjector, PRESSURE_KINDS, pressure_trace

from test_torch_scheduler import _ref, _served

torch.set_num_threads(2)
ACCOUNTED = {"eos", "max_new", "shed", "deadline", "refused", "pressure"}
DS = "deepseek-v2-lite-16b"


@pytest.fixture(autouse=True)
def _clear_counts():
    for c in (FALLBACK_COUNTS, RESIDENCY_COUNTS, TE.CAPTURE_COUNTS,
              _build.LAUNCH_COUNTS):
        c.clear()
    yield
    assert not _build.LAUNCH_COUNTS, "a CPU call launched a kernel"


@pytest.fixture(scope="module")
def served():
    """(reference cfg, port cfg, reference state, port params, port ctx)
    for Llama-3.2's smoke config."""
    return _served("llama3.2-1b")


@pytest.fixture(scope="module")
def moe():
    """DeepSeek-V2-Lite's smoke config, dropless, packed by each package
    (byte-equal planes): (reference cfg, port cfg, reference state, port
    state, port ctx)."""
    smoke = get_config(DS).smoke
    cf = float(smoke.n_experts)
    cfg = dataclasses.replace(smoke, name=smoke.name + "-gov-tier",
                              capacity_factor=cf)
    tcfg = dataclasses.replace(tget_config(DS).smoke, name=cfg.name,
                               capacity_factor=cf)
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    jst = JE.build_serve_params(params, JPolicy(mode="compressed",
                                                min_weight_size=1024))
    tst = TE.build_serve_params(
        convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  tcfg, device="cpu"),
        CompressionPolicy(mode="compressed", min_weight_size=1024),
        device="cpu")
    return cfg, tcfg, jst, tst, ServeContext.from_state(tcfg, tst,
                                                        device="cpu")


def _prompts(cfg, n, seed=100):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size,
                        int(rng.randint(4, 10))).astype(np.int32)
            for _ in range(n)]


def _kv_budget(cfg, n_slots=2, max_len=16, page_size=8):
    """(a DeviceBudget of exactly the boot KV pool, page_nbytes): no
    resident, activation or expert reserve, so a budget of k pages'
    bytes plans k usable pages."""
    pool = PagedKVPool(cfg, n_slots, max_len, page_size=page_size,
                       device="cpu")
    pn = pool.page_nbytes()
    boot = pool.n_pages * pn
    return device_budget(boot, expert_bytes=0, kv_bytes=boot), pn


# -- the pressure-trace generator ---------------------------------------

def test_pressure_trace_shapes_and_seeding():
    boot, low = 1000, 400
    for kind in PRESSURE_KINDS:
        tr = pressure_trace(kind, boot_bytes=boot, low_bytes=low,
                            n_steps=32, seed=3)
        assert len(tr) == 32
        assert min(tr) >= low and max(tr) <= boot
        assert tr == pressure_trace(kind, boot_bytes=boot, low_bytes=low,
                                    n_steps=32, seed=3)
    step = pressure_trace("step", boot_bytes=boot, low_bytes=low,
                          n_steps=32, seed=3)
    assert step[0] == boot and step[-1] == low
    spike = pressure_trace("spike", boot_bytes=boot, low_bytes=low,
                           n_steps=32, seed=3)
    assert spike[0] == boot and spike[-1] == boot and low in spike
    ramp = pressure_trace("ramp", boot_bytes=boot, low_bytes=low,
                          n_steps=32, seed=3)
    assert ramp[0] == boot and min(ramp) == low and ramp[-1] == boot
    osc = pressure_trace("oscillate", boot_bytes=boot, low_bytes=low,
                         n_steps=32, period=4, seed=3)
    assert set(osc) == {boot, low}
    with pytest.raises(ValueError, match="kind"):
        pressure_trace("cliff", boot_bytes=boot, low_bytes=low, n_steps=8)


@pytest.mark.parametrize("kind", PRESSURE_KINDS)
def test_pressure_trace_matches_reference(kind):
    """The same arrays as the reference's, for every seed, length and
    period drawn here."""
    rng = np.random.default_rng(7)
    for seed in range(12):
        boot = int(rng.integers(1 << 20, 1 << 34))
        low = int(rng.integers(0, boot))
        n, period = int(rng.integers(1, 80)), int(rng.integers(1, 12))
        kw = dict(boot_bytes=boot, low_bytes=low, n_steps=n, period=period,
                  seed=seed)
        assert pressure_trace(kind, **kw) == jpressure_trace(kind, **kw)


def test_device_budget_matches_reference():
    """DeviceBudget and device_budget give the reference's integers:
    every property, the cache arithmetic, resplit, min_viable and the
    summary, over seeded budgets."""
    rng = np.random.default_rng(11)
    for _ in range(64):
        kw = {k: int(rng.integers(0, 1 << 33)) for k in
              ("resident_bytes", "kv_bytes", "act_bytes", "expert_bytes")}
        total = int(rng.integers(0, 1 << 35))
        budgets = [m.device_budget(total, **kw) for m in (JP, TP)]
        layers, per = int(rng.integers(0, 30)), int(rng.integers(0, 1 << 25))
        new = int(rng.integers(0, 1 << 35))
        kv = int(rng.integers(0, 1 << 30))
        floors = dict(kv_floor_bytes=int(rng.integers(0, 1 << 30)),
                      expert_floor_bytes=int(rng.integers(0, 1 << 30)))
        used = int(rng.integers(0, 1 << 34))
        got = [(b.reserved_bytes, b.expert_cache_bytes, b.fits,
                b.fully_resident, b.cache_experts_per_layer(layers, per),
                dataclasses.astuple(b.resplit(new)),
                dataclasses.astuple(b.resplit(new, kv_bytes=kv)),
                b.min_viable(**floors), b.summary(), b.summary(used))
               for b in budgets]
        assert got[0] == got[1]


# -- the governor's plans against the reference --------------------------

def _plans(engine, gov, trace, injector):
    """Step ``engine`` under ``trace`` through the pressure seam; → each
    step's (plan, plan changes, refusing, usable pages, max_queue)."""
    out = []
    with injector.memory_pressure(trace):
        for _ in trace:
            engine.step()
            out.append((tuple(gov.applied_plan), gov.plan_changes,
                        gov.refusing, engine.pool.n_pages_usable,
                        engine.max_queue))
    return out


@pytest.mark.parametrize("kind", PRESSURE_KINDS)
def test_governor_plans_match_reference(served, kind):
    """Both packages' governors over engines of the same pool, under the
    same trace (down to below the one-slot floor): the same plan, plan
    changes, refusal, usable pages and admission bound at every step."""
    cfg, tcfg, st, tp, ctx = served
    budget, pn = _kv_budget(tcfg, n_slots=3, max_len=24)
    trace = pressure_trace(kind, boot_bytes=budget.budget_bytes,
                           low_bytes=pn, n_steps=40, period=3, seed=5)
    jgov = JG.MemoryGovernor(JP.device_budget(
        budget.budget_bytes, expert_bytes=0, kv_bytes=budget.kv_bytes),
        cooldown_steps=2)
    jeng = JEngine(JContext.from_state(cfg, st), st.params, n_slots=3,
                   max_len=24, governor=jgov)
    assert jeng.pool.page_nbytes() == pn
    gov = MemoryGovernor(budget, cooldown_steps=2)
    eng = Engine(ctx, tp, n_slots=3, max_len=24, governor=gov)
    want = _plans(jeng, jgov, trace, JInjector())
    got = _plans(eng, gov, trace, FaultInjector())
    assert got == want
    assert gov.plan_changes > 0
    assert {e["rung"] for e in gov.events} == {e["rung"] for e in jgov.events}


def test_governor_plans_match_reference_with_residency(moe):
    """With a residency manager in each package: the expert capacity
    absorbs the deficit first, in the same integer steps."""
    cfg, tcfg, jst, tst, ctx = moe
    jm = JRes.ResidencyManager(jst, cfg, capacity=4, prefetch=False)
    tm = ResidencyManager(tst, tcfg, capacity=4, prefetch=False)
    assert jm.bytes_per_expert == tm.bytes_per_expert
    unit = tm.n_layers * tm.bytes_per_expert
    pool = PagedKVPool(tcfg, 2, 16, page_size=8, device="cpu")
    pn = pool.page_nbytes()
    kv_boot = pool.n_pages * pn
    budgets = [m.device_budget(kv_boot + 4 * unit, expert_bytes=8 * unit,
                               kv_bytes=kv_boot) for m in (JP, TP)]
    trace = [kv_boot + 4 * unit - k * unit // 2 for k in range(12)] \
        + [kv_boot + 4 * unit] * 8
    jgov = JG.MemoryGovernor(budgets[0], cooldown_steps=2)
    gov = MemoryGovernor(budgets[1], cooldown_steps=2)
    jeng = JEngine(dataclasses.replace(JContext.from_state(cfg, jst),
                                       residency=jm), jst.params,
                   n_slots=2, max_len=16, governor=jgov)
    eng = Engine(dataclasses.replace(ctx, residency=tm), tst.params,
                 n_slots=2, max_len=16, governor=gov)
    want = _plans(jeng, jgov, trace, JInjector())
    got = _plans(eng, gov, trace, FaultInjector())
    assert got == want
    assert [p[0][0] for p in got][:12] != [4] * 12      # capacity moved
    assert tm.capacity == jm.capacity == 4
    jeng.close()
    eng.close()


# -- the elastic pool ----------------------------------------------------

def test_pool_release_and_regrow(served):
    """Retiring free tail pages releases them from the device (the page
    tensors rebuilt smaller, the sink kept last, ``moves`` counted);
    retiring interior pages leaves every address alone; owned pages keep
    their bytes through both; restore brings retired pages back first,
    then grows zero pages."""
    cfg, tcfg, st, tp, ctx = served
    pool = PagedKVPool(tcfg, 3, 16, page_size=8, device="cpu")
    pn = pool.page_nbytes()
    assert pool.device_bytes() == 7 * pn and pool.n_pages == 6
    row = pool.alloc(0).copy()                   # pages 5, 4 (LIFO)
    gen = torch.Generator().manual_seed(0)
    for leaf in TE._tensors(pool.pages):
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    owned = [leaf.clone() for leaf in TE._tensors(pool.pages)]
    ptrs = [leaf.data_ptr() for leaf in TE._tensors(pool.pages)]
    assert pool.retire_pages(2) == 2             # free 3, 2: not a tail
    assert pool.moves == 0 and pool.n_pages_usable == 4
    assert [leaf.data_ptr() for leaf in TE._tensors(pool.pages)] == ptrs
    pool.free(0)
    assert pool.retire_pages(2) == 2             # 5, 4: tail 2..5 goes
    assert pool.moves == 1 and pool.n_pages == 2 and not pool.retired
    assert pool.device_bytes() == 3 * pn and pool.n_pages_usable == 2
    for a, b in zip(TE._tensors(pool.pages), owned):
        assert torch.equal(a[:2], b[:2])         # pages 0 and 1 kept
    assert pool.restore_pages(3) == 3
    assert pool.moves == 2 and pool.n_pages == 5
    assert sorted(pool.free_pages) == [0, 1, 2, 3, 4]
    for a, b in zip(TE._tensors(pool.pages), owned):
        assert torch.equal(a[:2], b[:2])
        assert not a[2:5].any()                  # fresh zero pages
    assert row.tolist() == [5, 4]
    pool.alloc(1)
    with pytest.raises(PoolError):
        pool.alloc(1)


# -- reclaim ladder ------------------------------------------------------

def test_reclaim_preempts_and_survivors_stay_bitwise(served):
    """The budget halves mid-decode with both slots live and no free page:
    the ladder preempts a victim, retires its pages (the tail is released
    from the device), and the victim resumes bitwise equal once the other
    finishes."""
    cfg, tcfg, st, tp, ctx = served
    budget, pn = _kv_budget(tcfg)
    gov = MemoryGovernor(budget)
    eng = Engine(ctx, tp, n_slots=2, max_len=16, governor=gov)
    p0, p1 = [p[:6] for p in _prompts(cfg, 2, seed=51)]
    eng.submit(Request(tokens=p0, max_new=8, rid=0))
    eng.submit(Request(tokens=p1, max_new=8, rid=1))
    eng.step()                      # both in flight; every page owned
    gov.set_budget(2 * pn)          # room for exactly one slot
    eng.step()
    assert eng.pool.n_pages_usable == 2
    assert eng.pool.device_bytes() <= (2 + 1) * pn    # tail gone (+ sink)
    assert FALLBACK_COUNTS["pressure_kv_retire"] >= 1
    assert FALLBACK_COUNTS["pressure_preempt"] == 1
    assert eng.health()["pressure"]["plan"]["pages"] == 2
    eng.drain()
    by_rid = {c.rid: c for c in eng.completions}
    assert by_rid[0].finished == "max_new" and by_rid[1].finished == "max_new"
    assert {by_rid[0].resumed, by_rid[1].resumed} == {0, 1}
    for rid, p in ((0, p0), (1, p1)):
        np.testing.assert_array_equal(
            by_rid[rid].tokens, _ref(tp, ctx, p, 8, eng.pool.max_len),
            err_msg=f"request {rid} diverged under pressure")


def test_reclaim_tightens_admission(served):
    """With the pool shrunk to one slot's pages the governor caps
    max_queue at the backed slots; the overflow sheds."""
    cfg, tcfg, st, tp, ctx = served
    budget, pn = _kv_budget(tcfg)
    gov = MemoryGovernor(budget)
    eng = Engine(ctx, tp, n_slots=2, max_len=16, governor=gov)
    gov.set_budget(2 * pn)
    eng.step()
    assert eng.max_queue == 1
    assert FALLBACK_COUNTS["pressure_tighten"] == 1
    p = _prompts(cfg, 1, seed=53)[0][:6]
    eng.submit(Request(tokens=p, max_new=2, rid=0))
    eng.step()                                        # rid 0 admitted
    eng.submit(Request(tokens=p, max_new=2, rid=1))   # queued (1/1)
    eng.submit(Request(tokens=p, max_new=2, rid=2))   # overflow: sheds
    eng.drain()
    by_rid = {c.rid: c for c in eng.completions}
    assert by_rid[2].finished == "shed"
    assert all(by_rid[i].finished == "max_new" for i in (0, 1))


def test_refuse_below_floor_then_recover(served):
    """Below min_viable the governor holds the floors and refuses new
    submissions as finished='pressure'; admitted work drains.  A
    sustained recovery regrows the boot plan and admission."""
    cfg, tcfg, st, tp, ctx = served
    budget, pn = _kv_budget(tcfg)
    gov = MemoryGovernor(budget, cooldown_steps=3)
    eng = Engine(ctx, tp, n_slots=2, max_len=16, governor=gov)
    p = _prompts(cfg, 1, seed=55)[0][:6]
    eng.submit(Request(tokens=p, max_new=3, rid=0))
    gov.set_budget(pn)               # below the one-slot KV floor
    eng.step()
    assert gov.refusing
    assert eng.pool.n_pages_usable == eng.pool.pages_per_slot
    rid = eng.submit(Request(tokens=p, max_new=3, rid=9))
    refused = [c for c in eng.completions if c.rid == rid]
    assert len(refused) == 1 and refused[0].finished == "pressure"
    assert refused[0].n_generated == 0
    assert FALLBACK_COUNTS["pressure_refused"] == 1
    assert eng.health()["pressure"]["refusing"]
    eng.drain()
    assert {c.rid: c.finished for c in eng.completions}[0] == "max_new"
    gov.set_budget(budget.budget_bytes)
    for _ in range(gov.cooldown_steps + 1):
        eng.step()
    assert not gov.refusing
    assert eng.pool.n_pages_usable == eng.pool.n_pages == 4
    assert eng.max_queue is None
    assert FALLBACK_COUNTS["pressure_regrow"] >= 1
    eng.submit(Request(tokens=p, max_new=3, rid=10))
    [c] = eng.drain()
    assert c.finished == "max_new"
    np.testing.assert_array_equal(c.tokens,
                                  _ref(tp, ctx, p, 3, eng.pool.max_len))


# -- hysteresis ----------------------------------------------------------

def test_oscillation_never_thrashes(served):
    """A square wave of period 2 under a cooldown of 4: after the first
    reclaim the band swallows every flip, so plan changes (and the page
    moves, each of which costs the card a capture of the tick) are
    bounded by band crossings, not steps."""
    cfg, tcfg, st, tp, ctx = served
    budget, pn = _kv_budget(tcfg)
    gov = MemoryGovernor(budget, cooldown_steps=4)
    eng = Engine(ctx, tp, n_slots=2, max_len=16, governor=gov)
    prompts = [p[:6] for p in _prompts(cfg, 3, seed=57)]
    for i, p in enumerate(prompts):
        eng.submit(Request(tokens=p, max_new=6, rid=i))
    trace = pressure_trace("oscillate", boot_bytes=budget.budget_bytes,
                           low_bytes=2 * pn, n_steps=64, period=2, seed=9)
    with FaultInjector().memory_pressure(trace) as probe:
        eng.drain()
        steps_under_trace = probe.executions
    assert steps_under_trace >= 8
    assert gov.plan_changes <= 2, gov.snapshot()
    assert eng.pool.moves <= gov.plan_changes
    assert all(c.finished in ACCOUNTED for c in eng.completions)
    by_rid = {c.rid: c for c in eng.completions}
    for i, p in enumerate(prompts):
        if by_rid[i].finished == "max_new":
            np.testing.assert_array_equal(
                by_rid[i].tokens, _ref(tp, ctx, p, 6, eng.pool.max_len),
                err_msg=f"survivor {i} diverged under oscillation")


def test_ramp_reclaims_then_regrows_to_boot(served):
    """A ramp down and back up: reclaim follows the descent at once,
    regrow climbs behind hysteresis, and the engine ends at the boot
    envelope, its device bytes the boot pool's."""
    cfg, tcfg, st, tp, ctx = served
    budget, pn = _kv_budget(tcfg)
    gov = MemoryGovernor(budget, cooldown_steps=2)
    eng = Engine(ctx, tp, n_slots=2, max_len=16, governor=gov)
    boot_bytes = eng.pool.device_bytes()
    trace = pressure_trace("ramp", boot_bytes=budget.budget_bytes,
                           low_bytes=2 * pn, n_steps=30, seed=13)
    low = boot_bytes
    with FaultInjector().memory_pressure(trace):
        for _ in range(len(trace) + 10):
            eng.step()
            low = min(low, eng.pool.device_bytes())
    assert low == (2 + 1) * pn
    assert eng.pool.n_pages_usable == eng.pool.n_pages
    assert eng.pool.device_bytes() == boot_bytes
    assert not gov.refusing
    assert 0 < gov.plan_changes < len(trace)
    assert eng.pool.moves <= gov.plan_changes
    assert FALLBACK_COUNTS["pressure_regrow"] >= 1
    lat = gov.snapshot()["rung_latency_s"]
    assert "retire_kv" in lat and lat["retire_kv"] >= 0.0


@pytest.mark.parametrize("kind", PRESSURE_KINDS)
def test_every_trace_kind_drains_fully_accounted(served, kind):
    """Any trace kind under staggered arrivals: the engine drains, every
    request ends as an accounted Completion, the usable pages follow the
    applied plan, and survivors equal generate."""
    cfg, tcfg, st, tp, ctx = served
    budget, pn = _kv_budget(tcfg)
    gov = MemoryGovernor(budget, cooldown_steps=3)
    eng = Engine(ctx, tp, n_slots=2, max_len=16, governor=gov)
    prompts = [p[:6] for p in _prompts(cfg, 4, seed=59)]
    trace = pressure_trace(kind, boot_bytes=budget.budget_bytes,
                           low_bytes=2 * pn, n_steps=48)
    with FaultInjector().memory_pressure(trace):
        submitted = 0
        while submitted < 4 or eng.health()["occupied"] \
                or eng.health()["queued"]:
            if submitted < 4 and eng.steps >= 2 * submitted:
                eng.submit(Request(tokens=prompts[submitted], max_new=5,
                                   rid=submitted))
                submitted += 1
            eng.step()
    reasons = {c.rid: c.finished for c in eng.completions}
    assert set(reasons) == {0, 1, 2, 3}, reasons
    assert all(r in ACCOUNTED for r in reasons.values()), reasons
    assert eng.pool.n_pages_usable == gov.applied_plan.pages
    by_rid = {c.rid: c for c in eng.completions}
    for i, p in enumerate(prompts):
        if by_rid[i].finished == "max_new":
            np.testing.assert_array_equal(
                by_rid[i].tokens, _ref(tp, ctx, p, 5, eng.pool.max_len),
                err_msg=f"survivor {i} diverged under {kind} trace")


# -- injection seam ------------------------------------------------------

def test_memory_pressure_seam_drives_governor(served):
    cfg, tcfg, st, tp, ctx = served
    budget, pn = _kv_budget(tcfg)
    gov = MemoryGovernor(budget)
    eng = Engine(ctx, tp, n_slots=2, max_len=16, governor=gov)
    with FaultInjector().memory_pressure([3 * pn, 2 * pn]) as probe:
        eng.step()
        assert gov.target_bytes == 3 * pn
        eng.step()
        assert gov.target_bytes == 2 * pn
        eng.step()                           # hold_last repeats the tail
        assert gov.target_bytes == 2 * pn
    assert probe.executions == 3
    eng.step()                               # seam restored: no signal
    assert gov.target_bytes == 2 * pn
    snap = eng.health()["pressure"]
    assert snap["applied_bytes"] == 2 * pn
    assert snap["kv_pages_usable"] == 2
    assert snap["kv_device_bytes"] == (2 + 1) * pn


# -- tiered residency: experts absorb the deficit first -----------------

def test_governor_trims_expert_cache_before_kv(moe):
    """MoE under tiered residency: a deficit smaller than the expert cache
    trims the capacity and pauses prefetch, the KV pool untouched;
    recovery regrows the capacity and resumes prefetch; completions stay
    bitwise equal to generate throughout; close leaves no worker."""
    cfg, tcfg, jst, tst, ctx = moe
    prompts = [p[:6] for p in _prompts(cfg, 2, seed=61)]
    refs = [_ref(tst.params, ctx, p, 4, 16) for p in prompts]
    mgr = ResidencyManager(tst, tcfg, capacity=3)
    unit = mgr.n_layers * mgr.bytes_per_expert
    pool = PagedKVPool(tcfg, 2, 16, page_size=8, device="cpu")
    kv_boot = pool.n_pages * pool.page_nbytes()
    budget = device_budget(kv_boot + 3 * unit, expert_bytes=unit * 3,
                           kv_bytes=kv_boot)
    gov = MemoryGovernor(budget, cooldown_steps=2)
    eng = Engine(dataclasses.replace(ctx, residency=mgr), tst.params,
                 n_slots=2, max_len=16, governor=gov)
    eng.submit(Request(tokens=prompts[0], max_new=4, rid=0))
    eng.step()
    gov.set_budget(kv_boot + unit)       # a deficit of 2 experts a layer
    eng.step()
    assert mgr.capacity == 1
    assert mgr.cache_device_bytes() == unit
    assert not mgr.prefetch_enabled
    assert eng.pool.n_pages_usable == eng.pool.n_pages
    assert eng.pool.moves == 0
    assert FALLBACK_COUNTS["pressure_trim"] == 1
    assert FALLBACK_COUNTS["pressure_kv_retire"] == 0
    eng.drain()
    gov.set_budget(budget.budget_bytes)
    for _ in range(gov.cooldown_steps + 1):
        eng.step()
    assert mgr.capacity == 3
    assert mgr.prefetch_enabled
    eng.submit(Request(tokens=prompts[1], max_new=4, rid=1))
    eng.drain()
    by_rid = {c.rid: c for c in eng.completions}
    for i in range(2):
        np.testing.assert_array_equal(by_rid[i].tokens, refs[i],
                                      err_msg=f"request {i} diverged")
    assert eng.health()["residency"]["capacity"] == 3
    eng.close()
    assert not any(t.name == "residency-prefetch" and t.is_alive()
                   for t in threading.enumerate())


# -- teardown ------------------------------------------------------------

def test_engine_close_is_idempotent_and_context_managed(served):
    cfg, tcfg, st, tp, ctx = served
    with Engine(ctx, tp, n_slots=1, max_len=16) as eng:
        eng.submit(Request(tokens=_prompts(cfg, 1, seed=63)[0][:6],
                           max_new=2))
        eng.drain()
    eng.close()
    assert list(itertools.chain(eng._graphs, eng._resume_graphs)) == []
