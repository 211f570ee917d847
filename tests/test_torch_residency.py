"""The port's tiered expert residency, on the CPU.

Mirrors ``tests/test_residency.py`` case for case, on the port
(``repro_torch/serve/residency.py``):

  * **bitwise parity**: at cache capacities {all, half, 1}, the port's
    ``generate`` (greedy and sampled) and its ``Engine`` under a
    ``ResidencyManager`` equal the port's fully resident serving bit for
    bit, and no expert plane is materialized;
  * LRU eviction, the transient overflow and its trim, prefetch-hit
    accounting, a corrupt backing plane caught at fetch and named, the
    manifest checked at construction, bad wiring refused, ``health`` and
    ``reset_stats``, cache bytes against capacity and budget, shrink and
    regrow, the too-small-budget warning, no prefetch thread after
    ``close``;

and against the reference on the same inputs (the same dense weights,
packed by each package into byte-equal planes):

  * the host logic: both managers' ``step`` over the same seeded
    sequences of per-layer expert sets give the same slot tables,
    ``RESIDENCY_COUNTS`` and evictions, exactly (transient growth, trims,
    ``set_capacity`` down and up, prefetch);
  * greedy tokens of both packages' ``tiered_generate`` at {all, half, 1},
    equal except where the reference's own logits tie exactly (the rule
    of ``test_torch_moe.py``'s generate test, ROADMAP.md queue 3);
  * ``moe_expert_scan`` (experts decoded one at a time) against the
    reference's, within one bf16 ulp of the output's largest magnitude.

And the port's own: a replayed step leaves the caches (generate's, and
the engine's pages) bitwise equal to a one-pass step; a fault at
``_transfer`` walks ``ResilientEngine``'s ladder, and a persistent one
ends in refused requests, never a hang.

DeepSeek-V2-Lite's smoke config (2 MoE layers of 8 experts, top-2), in the
dropless regime (``capacity_factor = n_experts``) so that token-for-token
parity is exact, ``CompressionPolicy(min_weight_size=1024)``.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serve import engine as JE
from repro.serve import residency as JRes
from repro.serve.context import ServeContext as JContext

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core.integrity import IntegrityError
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import _build, ops
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as TE
from repro_torch.serve import residency as res
from repro_torch.serve.context import ServeContext
from repro_torch.serve.residency import (RESIDENCY_COUNTS, ResidencyError,
                                         ResidencyManager)
from repro_torch.serve.resilience import (FALLBACK_COUNTS, ResiliencePolicy,
                                          ResilientEngine, ServeRefused)
from repro_torch.serve.scheduler import Engine, Request
from repro_torch.testing import FaultInjector

from test_torch_moe import _block_input, _layer, _ulps
from test_torch_scheduler import _equal_or_tied

torch.set_num_threads(2)
ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(autouse=True)
def _clear_counts():
    for c in (RESIDENCY_COUNTS, FALLBACK_COUNTS, TL.MATERIALIZE_COUNTS,
              ops.DISPATCH_COUNTS, TE.CAPTURE_COUNTS, _build.LAUNCH_COUNTS):
        c.clear()
    yield
    assert not _build.LAUNCH_COUNTS, "a CPU call launched a kernel"


@pytest.fixture(scope="module")
def served():
    """(reference cfg, port cfg, reference state, port state, port ctx):
    the smoke model, dropless, PRNGKey(0) weights packed by each package
    (byte-equal planes, each with its own manifest)."""
    smoke = get_config(ARCH).smoke
    cf = float(smoke.n_experts)
    cfg = dataclasses.replace(smoke, capacity_factor=cf)
    tcfg = dataclasses.replace(tget_config(ARCH).smoke, capacity_factor=cf)
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    jst = JE.build_serve_params(params, JPolicy(mode="compressed",
                                                min_weight_size=1024))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    tst = TE.build_serve_params(tparams, CompressionPolicy(
        mode="compressed", min_weight_size=1024), device="cpu")
    return cfg, tcfg, jst, tst, ServeContext.from_state(tcfg, tst,
                                                        device="cpu")


def _prompt(cfg, n=8, seed=3):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab_size, n).astype(np.int32)


def _tiered(ctx, mgr):
    return dataclasses.replace(ctx, residency=mgr)


def _generate(tst, ctx, prompt, **kw):
    return TE.generate(tst.params, None, torch.from_numpy(prompt), ctx=ctx,
                       **kw).numpy()


def _prefetch_threads():
    return {t for t in threading.enumerate()
            if t.name == "residency-prefetch" and t.is_alive()}


# -- bitwise parity inside the port --------------------------------------

def test_generate_parity_at_all_capacities(served):
    """Tiered generate equals the fully resident one bit for bit at
    capacities {all, half, 1}, with no expert plane materialized; the
    constrained capacities miss, replay and hit prefetched slots."""
    cfg, tcfg, jst, tst, ctx = served
    prompt = _prompt(cfg)[None, :]
    ref = _generate(tst, ctx, prompt, max_new=8, max_len=32)
    assert TL.MATERIALIZE_COUNTS["packed_stacked"] == 0
    for cap in (cfg.n_experts, cfg.n_experts // 2, 1):
        RESIDENCY_COUNTS.clear()
        mgr = ResidencyManager(tst, tcfg, capacity=cap)
        out = _generate(tst, _tiered(ctx, mgr), prompt, max_new=8,
                        max_len=32)
        mgr.close()
        np.testing.assert_array_equal(out, ref,
                                      err_msg=f"parity broke at {cap}")
        assert TL.MATERIALIZE_COUNTS["packed_stacked"] == 0
        if cap < cfg.n_experts:
            assert RESIDENCY_COUNTS["miss"] > 0
            assert RESIDENCY_COUNTS["replay"] > 0
            assert RESIDENCY_COUNTS["prefetch_hit"] > 0
        assert RESIDENCY_COUNTS["sync_fetch"] >= RESIDENCY_COUNTS["miss"]
        assert RESIDENCY_COUNTS["bytes_fetched"] > 0


def test_generate_parity_sampled(served):
    """Sampling draws from the caller's generator once a decode step, in
    the tiered loop as in the resident one: the same tokens, and the
    generator left in the same state."""
    cfg, tcfg, jst, tst, ctx = served
    prompt = np.stack([_prompt(cfg, seed=11), _prompt(cfg, seed=12)])
    gens = [torch.Generator().manual_seed(42) for _ in range(2)]
    ref = _generate(tst, ctx, prompt, max_new=6, max_len=32,
                    temperature=0.8, generator=gens[0])
    mgr = ResidencyManager(tst, tcfg, capacity=2)
    out = _generate(tst, _tiered(ctx, mgr), prompt, max_new=6, max_len=32,
                    temperature=0.8, generator=gens[1])
    mgr.close()
    np.testing.assert_array_equal(out, ref)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_scheduler_trace_parity(served):
    """A staggered trace through the engine under tiered residency
    finishes bitwise equal to the resident engine on the same trace."""
    cfg, tcfg, jst, tst, ctx = served
    rng = np.random.RandomState(17)
    prompts = [rng.randint(0, cfg.vocab_size,
                           int(rng.randint(4, 10))).astype(np.int32)
               for _ in range(4)]

    def run_trace(residency):
        with ResilientEngine(tcfg, tst, residency=residency,
                             device="cpu") as reng:
            eng = reng.scheduler(n_slots=2, max_len=32, page_size=8)
            for i, p in enumerate(prompts):     # > n_slots: queue + join
                eng.submit(Request(tokens=p, max_new=6, rid=i))
                eng.step()
            done = {c.rid: c for c in eng.drain() + eng.completions}
        return [np.asarray(done[i].tokens) for i in range(len(prompts))]

    ref = run_trace(None)
    got = run_trace(ResidencyManager(tst, tcfg, capacity=3))
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(r, g, err_msg=f"rid {i} diverged")
    assert RESIDENCY_COUNTS["miss"] > 0
    assert TL.MATERIALIZE_COUNTS["packed_stacked"] == 0


# -- cache mechanics -----------------------------------------------------

def test_lru_eviction_order(served):
    """Vacant slots fill first; evictions then take the least recently
    used expert, and a hit reorders the queue."""
    cfg, tcfg, jst, tst, ctx = served
    mgr = ResidencyManager(tst, tcfg, capacity=2, prefetch=False)
    tail = [set()] * (mgr.n_layers - 1)
    mgr.step([{0}] + tail)
    mgr.step([{1}] + tail)
    assert set(mgr.resident(0)) == {0, 1}
    mgr.step([{0}] + tail)              # touch 0: the LRU is now 1
    mgr.step([{2}] + tail)              # evicts 1, not 0
    assert set(mgr.resident(0)) == {0, 2}
    assert RESIDENCY_COUNTS["evict"] == 1
    gens = {r.expert: r.gen for r in mgr.slot_table(0) if r.expert >= 0}
    assert gens[2] > gens[0]


def test_transient_overflow_trims_back(served):
    """A step's working set beyond the capacity grows the cache for the
    step; the commit trims it back, evicting least recently used first."""
    cfg, tcfg, jst, tst, ctx = served
    mgr = ResidencyManager(tst, tcfg, capacity=1, prefetch=False)
    tail = [set()] * (mgr.n_layers - 1)
    mgr.step([{3, 4, 5}] + tail)
    assert mgr.c_alloc == 1
    assert len(mgr.resident(0)) == 1
    assert RESIDENCY_COUNTS["evict"] == 2
    stack = mgr.device_params()["blocks"][0]["moe"]["experts"]["w_gate"]
    assert stack.codes.shape[0] == 1


def test_demand_fetch_lands_in_its_slot_and_is_measured(served):
    """A demand fetch copies an expert's host planes straight into its
    slot; the CRC's seconds, the largest slot count and the prefetched
    bytes that waited for an install show in the snapshot, and
    reset_stats clears them.  A copy that fails leaves its slot vacant:
    the evicted expert is gone and the failed one is not resident."""
    cfg, tcfg, jst, tst, ctx = served
    mgr = ResidencyManager(tst, tcfg, capacity=1)
    tail = [set()] * (mgr.n_layers - 1)
    mgr.step([{3, 4, 5}] + tail)
    slot = mgr.resident(0)[5]
    for (k, pl), dst in mgr._slot_views(0, slot).items():
        assert torch.equal(dst, mgr._host[k][pl][0, 5]), (k, pl)
    mgr.step([{5}] + tail)               # the prefetches land here
    snap = mgr.snapshot()
    assert snap["crc_s"] > 0 and snap["crc_s"] <= snap["stall_s"]
    assert snap["prefetch_crc_s"] > 0
    assert snap["peak_slots"] == 3 and mgr.c_alloc == 1
    assert snap["peak_ready_bytes"] >= mgr.bytes_per_expert
    mgr.close()
    mgr.reset_stats()
    snap = mgr.snapshot()
    assert (snap["crc_s"], snap["prefetch_crc_s"], snap["peak_slots"],
            snap["peak_ready_bytes"]) == (0, 0, 1, 0)
    with FaultInjector().fetch_fault(times=1):
        with pytest.raises(torch.AcceleratorError):
            mgr.step([{6}] + tail)
    assert mgr.resident(0) == {}
    assert [r.expert for r in mgr.slot_table(0)] == [-1]
    assert mgr.stats["fetch"] == 0 and mgr.stats["evict"] == 1
    mgr.step([{6}] + tail)
    assert mgr.resident(0) == {6: 0}
    mgr.close()


def test_prefetch_hit_accounting(served):
    """Layer l's routing prefetches layer l+1; the next step's first touch
    of those slots counts prefetch_hit, the second a plain hit."""
    cfg, tcfg, jst, tst, ctx = served
    mgr = ResidencyManager(tst, tcfg, capacity=cfg.n_experts)
    tail = [set()] * (mgr.n_layers - 1)
    mgr.step([{1, 2}] + tail)            # predicts {1, 2} at layer 1
    before = RESIDENCY_COUNTS["prefetch_hit"]
    mgr.step([set(), {1, 2}] + tail[1:])
    assert RESIDENCY_COUNTS["prefetch_hit"] - before == 2
    assert RESIDENCY_COUNTS["prefetch_issued"] >= 2
    assert RESIDENCY_COUNTS["prefetch_installed"] >= 2
    before_hit = RESIDENCY_COUNTS["hit"]
    mgr.step([set(), {1, 2}] + tail[1:])
    assert RESIDENCY_COUNTS["hit"] - before_hit == 2
    mgr.close()


@pytest.mark.parametrize("capacity,prefetch", [(1, False), (1, True),
                                               (3, True), (None, True)])
def test_host_logic_matches_reference(served, capacity, prefetch):
    """Both packages' managers step through the same seeded sequence of
    per-layer expert sets (some larger than the capacity: transient
    growth and trims), with set_capacity down to 1 and back up mid-way:
    the same slot tables (expert, LRU tick, generation, source, fresh),
    residency, allocated slots and RESIDENCY_COUNTS after every step."""
    cfg, tcfg, jst, tst, ctx = served
    rng = np.random.default_rng(100 + (capacity or 0) + prefetch)
    jm = JRes.ResidencyManager(jst, cfg, capacity=capacity,
                               prefetch=prefetch)
    tm = ResidencyManager(tst, tcfg, capacity=capacity, prefetch=prefetch)
    e = cfg.n_experts
    for i in range(20):
        needed = [set(rng.choice(e, int(rng.integers(0, 5)),
                                 replace=False).tolist())
                  for _ in range(tm.n_layers)]
        if i in (7, 13):
            want = 1 if i == 7 else (capacity or e)
            jm.set_capacity(want)
            tm.set_capacity(want)
        jm.step(needed)
        tm.step(needed)
        for l in range(tm.n_layers):
            rows = [[(r.expert, r.last_used, r.gen, r.source, r.fresh)
                     for r in m.slot_table(l)] for m in (jm, tm)]
            assert rows[0] == rows[1], f"step {i} layer {l}"
            assert jm.resident(l) == tm.resident(l)
        assert jm.c_alloc == tm.c_alloc and jm.capacity == tm.capacity
        jc = {k: v for k, v in JRes.RESIDENCY_COUNTS.items() if v}
        tc = {k: v for k, v in RESIDENCY_COUNTS.items() if v}
        assert jc == tc, f"step {i}"
    assert RESIDENCY_COUNTS["evict"] > 0
    assert jm.bytes_per_expert == tm.bytes_per_expert
    jm.close()
    tm.close()


# -- integrity -----------------------------------------------------------

def test_corrupt_backing_plane_caught_at_fetch(served):
    """Backing-store rot after construction is caught by the per-slice CRC
    at fetch time, naming (layer, expert, plane); the corrupt bytes never
    reach a cache slot."""
    cfg, tcfg, jst, tst, ctx = served
    mgr = ResidencyManager(tst, tcfg, capacity=2, prefetch=False)
    raw = mgr._host["w_up"]["codes"][1, 5].reshape(-1).view(torch.uint8)
    raw[:1].bitwise_xor_(0x40)
    tail = [set()] * (mgr.n_layers - 1)
    mgr.step([{5}] + tail)               # layer 0, expert 5: clean
    with pytest.raises(IntegrityError) as ei:
        mgr.step([set(), {5}] + tail[1:])
    msg = str(ei.value)
    assert "w_up" in msg and "layer 1" in msg and "expert 5" in msg \
        and "codes" in msg
    assert 5 not in mgr.resident(1)


def test_manifest_verify_at_init(served):
    """Construction hashes the backing planes against the pack-time
    manifest: a pre-corrupted state builds no backing store;
    verify=False skips the gate (the slice CRCs are then taken from the
    corrupt planes, so fetches agree with them)."""
    cfg, tcfg, jst, tst, ctx = served
    bad, leaf = FaultInjector(seed=5).flip_bit(tst, "experts", "codes")
    with pytest.raises(IntegrityError, match="experts"):
        ResidencyManager(bad, tcfg, capacity=2)
    ResidencyManager(bad, tcfg, capacity=2, verify=False)


# -- wiring --------------------------------------------------------------

def test_residency_rejects_bad_wiring(served):
    cfg, tcfg, jst, tst, ctx = served
    dense = tget_config("llama3.2-1b").smoke
    dst = TE.build_serve_params(
        TLM.init_lm(dense, device="cpu"),
        CompressionPolicy(mode="compressed", min_weight_size=1024),
        manifest=False, device="cpu")
    with pytest.raises(ResidencyError):
        ResidencyManager(dst, dense, capacity=1)
    with pytest.raises(ResidencyError):
        ResidencyManager(tst, dataclasses.replace(tcfg,
                                                  moe_expert_scan=True))
    mgr = ResidencyManager(tst, tcfg, capacity=2)
    with pytest.raises(ResidencyError):
        res.make_tiered_serve_fns(ctx)      # no manager on the context
    prefill, _ = res.make_tiered_serve_fns(_tiered(ctx, mgr))
    with pytest.raises(ResidencyError):     # another params tree
        prefill({"blocks": []}, tst.lut, {"tokens": None}, None)


def test_health_and_reset_stats(served):
    """Engine.health() shows the residency snapshot beside the lifecycle
    counters; reset_stats() clears RESIDENCY_COUNTS and the manager's."""
    cfg, tcfg, jst, tst, ctx = served
    mgr = ResidencyManager(tst, tcfg, capacity=2)
    reng = ResilientEngine(tcfg, tst, residency=mgr, device="cpu")
    eng = reng.scheduler(n_slots=2, max_len=32, page_size=8)
    eng.submit(Request(tokens=_prompt(cfg, 6), max_new=4, rid=0))
    eng.drain()
    h = eng.health()
    assert h["residency"]["miss"] > 0
    assert h["residency"]["bytes_fetched"] > 0
    assert reng.health()["residency"]["capacity"] == 2
    eng.reset_stats()
    assert sum(RESIDENCY_COUNTS.values()) == 0
    assert eng.health()["residency"]["miss"] == 0
    assert eng.health()["residency"]["stall_s"] == 0
    reng.close()


def test_cache_bytes_capacity_and_budget(served):
    """cache_bytes sizes the capacity in whole experts a layer; the
    device bytes of the stacks follow the capacity; device_budget does
    the edge budget's arithmetic."""
    cfg, tcfg, jst, tst, ctx = served
    probe = ResidencyManager(tst, tcfg, capacity=1)
    per = probe.bytes_per_expert
    assert probe.cache_device_bytes() == probe.n_layers * per
    mgr = ResidencyManager(tst, tcfg,
                           cache_bytes=3 * probe.n_layers * per + 1)
    assert mgr.capacity == 3
    assert mgr.cache_device_bytes() == 3 * probe.n_layers * per
    from repro_torch.core.policy import device_budget
    b = device_budget(10 * probe.n_layers * per,
                      expert_bytes=probe.n_layers * probe.n_experts * per,
                      resident_bytes=3 * probe.n_layers * per)
    assert b.cache_experts_per_layer(probe.n_layers, per) == 7
    assert not b.fully_resident and b.fits
    assert "tiered" in b.summary()
    assert device_budget(1 << 40, expert_bytes=1 << 20).fully_resident


def test_runtime_capacity_shrink_and_regrow_bitwise(served):
    """set_capacity mid-stream, down to 1 and back up, keeps the engine's
    completions bitwise equal to an undisturbed run; set_capacity clamps
    to [1, n_experts]."""
    cfg, tcfg, jst, tst, ctx = served
    rng = np.random.RandomState(43)
    prompts = [rng.randint(0, cfg.vocab_size,
                           int(rng.randint(4, 10))).astype(np.int32)
               for _ in range(3)]

    def run_trace(capacities):
        mgr = ResidencyManager(tst, tcfg, capacity=3)
        eng = ResilientEngine(tcfg, tst, residency=mgr,
                              device="cpu").scheduler(
            n_slots=2, max_len=32, page_size=8)
        for i, p in enumerate(prompts):
            eng.submit(Request(tokens=p, max_new=6, rid=i))
        while eng.health()["occupied"] or eng.health()["queued"]:
            if eng.steps in capacities:
                mgr.set_capacity(capacities[eng.steps])
                assert mgr.cache_device_bytes() == \
                    mgr.capacity * mgr.n_layers * mgr.bytes_per_expert
            eng.step()
        eng.close()
        return {c.rid: np.asarray(c.tokens) for c in eng.completions}

    ref = run_trace({})
    got = run_trace({2: 1, 6: 3})
    for i in range(len(prompts)):
        np.testing.assert_array_equal(ref[i], got[i], err_msg=f"rid {i}")
    assert TL.MATERIALIZE_COUNTS["packed_stacked"] == 0
    mgr = ResidencyManager(tst, tcfg, capacity=2, prefetch=False)
    mgr.set_capacity(0)
    assert mgr.capacity == 1 and mgr.overshoot_bytes > 0
    mgr.set_capacity(cfg.n_experts + 5)
    assert mgr.capacity == cfg.n_experts


def test_too_small_budget_warns_and_surfaces_overshoot(served):
    """A budget below one expert a layer warns, records the overshoot in
    the snapshot, and DeviceBudget.summary shows it."""
    cfg, tcfg, jst, tst, ctx = served
    probe = ResidencyManager(tst, tcfg, capacity=1)
    floor = probe.n_layers * probe.bytes_per_expert
    with pytest.warns(RuntimeWarning, match="overshoot"):
        mgr = ResidencyManager(tst, tcfg, cache_bytes=floor // 2)
    assert mgr.capacity == 1
    assert mgr.overshoot_bytes == floor - floor // 2
    assert mgr.snapshot()["overshoot_bytes"] == mgr.overshoot_bytes
    assert probe.overshoot_bytes == 0
    from repro_torch.core.policy import device_budget
    b = device_budget(floor // 2, expert_bytes=10 * floor)
    assert "OVERSHOOT" in b.summary(expert_cache_used=floor)
    assert "OVERSHOOT" not in b.summary(expert_cache_used=0)


def test_close_stops_prefetch_worker_no_leaked_threads(served):
    """Engine and ResilientEngine teardown stops the prefetch worker;
    close is idempotent, and a ResilientEngine without a scheduler still
    closes its manager."""
    cfg, tcfg, jst, tst, ctx = served
    before = _prefetch_threads()
    mgr = ResidencyManager(tst, tcfg, capacity=2)
    with ResilientEngine(tcfg, tst, residency=mgr, device="cpu") as reng:
        eng = reng.scheduler(n_slots=2, max_len=32, page_size=8)
        eng.submit(Request(tokens=_prompt(cfg, 6, seed=47), max_new=3,
                           rid=0))
        eng.drain()
        assert len(_prefetch_threads() - before) == 1
    assert _prefetch_threads() - before == set()
    mgr.close()
    mgr2 = ResidencyManager(tst, tcfg, capacity=2)
    mgr2._start_worker()
    reng2 = ResilientEngine(tcfg, tst, residency=mgr2, device="cpu")
    assert len(_prefetch_threads() - before) == 1
    reng2.close()
    assert _prefetch_threads() - before == set()


# -- against the reference -----------------------------------------------

def test_tiered_tokens_match_reference(served):
    """Greedy tokens of both packages' tiered generate at {all, half, 1}:
    equal, or first differing where the reference's logits tie exactly."""
    cfg, tcfg, jst, tst, ctx = served
    prompt = _prompt(cfg)
    jctx = JContext.from_state(cfg, jst)
    for cap in (cfg.n_experts, cfg.n_experts // 2, 1):
        jm = JRes.ResidencyManager(jst, cfg, capacity=cap)
        want = np.asarray(JE.generate(
            jst.params, cfg, jnp.asarray(prompt[None]),
            ctx=dataclasses.replace(jctx, residency=jm), max_new=8,
            max_len=32))[0]
        jm.close()
        tm = ResidencyManager(tst, tcfg, capacity=cap)
        got = _generate(tst, _tiered(ctx, tm), prompt[None], max_new=8,
                        max_len=32)[0]
        tm.close()
        _equal_or_tied(jst, cfg, prompt, got, want, 32)


def test_expert_scan_matches_reference(served):
    """moe_expert_scan decodes one expert's three weights at a time (K4
    and the dequantize, then dense products): against the reference's
    scan on the same input, within one bf16 ulp of the largest output;
    each expert weight decoded once, never a stacked one."""
    cfg, tcfg, jst, tst, ctx = served
    scfg = dataclasses.replace(cfg, moe_expert_scan=True)
    tscfg = dataclasses.replace(tcfg, moe_expert_scan=True)
    jx, tx = _block_input(cfg, "compressed", 2)
    jbp = _layer(jst.params["blocks"], 1)["moe"]
    tbp = tst.params["blocks"][1]["moe"]
    jy, _ = jax.jit(lambda p, x, lut: JL.apply_moe(p, x, scfg, lut=lut))(
        jbp, jx, jst.lut)
    ty, _ = TL.apply_moe(tbp, tx, tscfg, lut=tst.lut)
    _ulps(ty, jy, 1)
    assert TL.MATERIALIZE_COUNTS["packed"] == 3 * cfg.n_experts
    assert TL.MATERIALIZE_COUNTS["packed_stacked"] == 0
    assert not ops.DISPATCH_COUNTS["grouped_fused"]


# -- replay with in-place caches ----------------------------------------

def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert torch.equal(a, b)


def test_replayed_step_leaves_caches_bitwise(served):
    """The port's steps write their caches in place.  A decode step that
    misses (capacity 1, no prefetch) and replays leaves every layer's
    cache and its logits bitwise equal to a one-pass step at full
    capacity (every routed expert resident) and to the resident step;
    the engine's pages and next tokens after a replayed admission and
    tick equal the resident engine's."""
    cfg, tcfg, jst, tst, ctx = served
    prompt = torch.from_numpy(np.stack([_prompt(cfg, seed=21),
                                        _prompt(cfg, seed=22)]))
    prefill, decode = TE.make_serve_fns(ctx=ctx)
    caches = TLM.init_caches(tcfg, 2, 16, device="cpu")
    logits, caches = prefill(tst.params, tst.lut, {"tokens": prompt},
                             caches)
    tok = TE.sample_tokens(logits)[:, None]
    pos = torch.tensor(prompt.shape[1])
    runs = {}
    for name, cap in (("resident", None), ("one_pass", cfg.n_experts),
                      ("replayed", 1)):
        c = _clone(caches)
        if cap is None:
            runs[name] = decode(tst.params, tst.lut, tok, c, pos)
            continue
        mgr = ResidencyManager(tst, tcfg, capacity=cap, prefetch=False)
        if cap == cfg.n_experts:
            mgr.step([set(range(cap))] * mgr.n_layers)
        RESIDENCY_COUNTS.clear()
        _, tdecode = res.make_tiered_serve_fns(_tiered(ctx, mgr))
        runs[name] = tdecode(tst.params, tst.lut, tok, c, pos)
        replays = RESIDENCY_COUNTS["replay"]
        assert (replays > 0) == (cap == 1), (name, replays)
    for name in ("one_pass", "replayed"):
        assert torch.equal(runs[name][0], runs["resident"][0]), name
        _assert_trees_equal(runs[name][1], runs["resident"][1])

    pages = {}
    for name, mgr in (("resident", None),
                      ("replayed", ResidencyManager(tst, tcfg, capacity=1,
                                                    prefetch=False))):
        eng = Engine(_tiered(ctx, mgr), tst.params, n_slots=2, max_len=16)
        for i in range(2):
            eng.submit(Request(tokens=prompt[i].numpy(), max_new=4, rid=i))
        RESIDENCY_COUNTS.clear()
        eng.step()
        eng.step()
        if mgr is not None:
            assert RESIDENCY_COUNTS["replay"] > 0
        pages[name] = (_clone(eng.pool.pages), eng._nxt.clone(),
                       [list(s.out) for s in eng._slots])
    _assert_trees_equal(pages["replayed"][0], pages["resident"][0])
    assert torch.equal(pages["replayed"][1], pages["resident"][1])
    assert pages["replayed"][2] == pages["resident"][2]


# -- a fault at the transfer seam ---------------------------------------

def test_fetch_fault_walks_the_ladder(served):
    """A demand fetch that fails raises torch.AcceleratorError out of the
    protocol, and ResilientEngine's ladder serves the request on the
    unfused rung (K4 decodes the cache stacks there; its greedy tokens
    equal the fused rung's on this model).  A persistent fault refuses
    the request after the whole ladder, and an engine drain under it ends
    with every request refused, never a hang."""
    cfg, tcfg, jst, tst, ctx = served
    before = _prefetch_threads()
    prompt = _prompt(cfg, seed=31)[None, :]
    clean = _generate(tst, ctx, prompt, max_new=4, max_len=16)
    mgr = ResidencyManager(tst, tcfg, capacity=2, prefetch=False)
    reng = ResilientEngine(tcfg, tst, residency=mgr, device="cpu",
                           policy=ResiliencePolicy(max_retries=0))
    with FaultInjector().fetch_fault(times=1) as probe:
        out = reng.generate(prompt, max_new=4, max_len=16).numpy()
    assert probe.executions == 1
    assert reng.last_rung == "unfused"
    assert FALLBACK_COUNTS["unfused"] == 1
    assert ops.DISPATCH_COUNTS["grouped_unfused"] > 0
    np.testing.assert_array_equal(out, clean)
    with FaultInjector().fetch_fault(times=1 << 30):
        mgr.set_capacity(1)
        with pytest.raises(ServeRefused):
            reng.generate(_prompt(cfg, seed=32)[None, :], max_new=4,
                          max_len=16)
    reng.close()

    mgr2 = ResidencyManager(tst, tcfg, capacity=1)
    reng2 = ResilientEngine(tcfg, tst, residency=mgr2, device="cpu",
                            policy=ResiliencePolicy(max_retries=0))
    eng = reng2.scheduler(n_slots=2, max_len=16)
    with FaultInjector().fetch_fault(times=1 << 30):
        for i in range(3):
            eng.submit(Request(tokens=_prompt(cfg, 6, seed=40 + i),
                               max_new=3, rid=i))
        eng.drain(max_steps=20)
    assert sorted(c.rid for c in eng.completions) == [0, 1, 2]
    assert {c.finished for c in eng.completions} == {"refused"}
    reng2.close()
    assert _prefetch_threads() - before == set()


def test_prefetch_workers_under_thread_stress(served):
    """Twelve managers (more prefetch threads than this host's cores)
    stepped in turns with a 1 µs switch interval: each ends with the slot
    tables of the same sequence stepped alone, every issued prefetch
    installed or counted as an error, nothing in flight, and every worker
    joined."""
    import sys
    cfg, tcfg, jst, tst, ctx = served
    rng = np.random.default_rng(5)
    seq = [[set(rng.choice(cfg.n_experts, int(rng.integers(0, 5)),
                           replace=False).tolist()) for _ in range(2)]
           for _ in range(20)]

    def tables(mgr):
        return [[(r.expert, r.last_used, r.gen, r.source)
                 for r in mgr.slot_table(l)] for l in range(mgr.n_layers)]

    alone = ResidencyManager(tst, tcfg, capacity=2)
    for needed in seq:
        alone.step(needed)
    alone.join_prefetches()
    alone.close()
    before = _prefetch_threads()
    interval = sys.getswitchinterval()
    mgrs = [ResidencyManager(tst, tcfg, capacity=2, verify=False)
            for _ in range(12)]
    try:
        sys.setswitchinterval(1e-6)
        for needed in seq:
            for m in mgrs:
                m.step(needed)
        for m in mgrs:
            m.join_prefetches()
    finally:
        sys.setswitchinterval(interval)
        for m in mgrs:
            m.close()
    for m in mgrs:
        assert tables(m) == tables(alone)
        s = m.stats
        assert s["prefetch_issued"] == (s["prefetch_installed"]
                                        + s["prefetch_error"]) > 0
        assert s["fetch"] == s["sync_fetch"] + s["prefetch_installed"]
        assert not m._inflight
    assert _prefetch_threads() - before == set()
