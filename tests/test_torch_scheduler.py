"""The port's continuous-batching engine, on the CPU.

Mirrors ``tests/test_scheduler.py``.  The acceptance contract:

  * every request served through ``repro_torch.serve.Engine``, whenever it
    arrived and whichever slot and co-tenants it had, yields tokens
    **bitwise-equal** to the port's one-shot ``generate`` of its prompt
    alone at ``max_len=engine.pool.max_len``;
  * on the same weights (the reference's state, crossed as numpy) and the
    same trace, its greedy tokens equal the reference ``Engine``'s, except
    from a step where the reference's own logits tie exactly between the
    two tokens (the rule of ``test_torch_moe.py``'s generate test);
  * requests join a running decode, finish on EOS or budget, and free
    their pages, with no stale KV across page reuse;
  * overload is accounted (shed, TTL expiry), page pressure preempts
    strictly-lower-priority work, a poisoned request is quarantined alone,
    and preempted or quarantine-surviving requests resume bitwise-equal,
    sampled ones included (each row's stream folds in its position).

Llama-3.2's smoke config with ``min_weight_size=1024``, so every
projection is compressed; the MoE family is in test_torch_scheduler_moe.py.
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
from repro.serve.context import ServeContext as JContext
from repro.serve.scheduler import Engine as JEngine
from repro.serve.scheduler import Request as JRequest

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops
from repro_torch.serve import engine as TE
from repro_torch.serve.context import ServeContext
from repro_torch.serve.resilience import FALLBACK_COUNTS, ServeRefused
from repro_torch.serve.scheduler import Engine, Request

from test_torch_model import state_to_numpy

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clear_counts():
    FALLBACK_COUNTS.clear()
    TE.CAPTURE_COUNTS.clear()


def _served(arch, **overrides):
    """(reference cfg, port cfg, reference state, port params, port ctx)
    for ``arch``'s smoke config, compressed, weights from PRNGKey 0."""
    cfg = dataclasses.replace(get_config(arch).smoke, **overrides)
    tcfg = dataclasses.replace(tget_config(arch).smoke, **overrides)
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    st = JE.build_serve_params(
        params, JPolicy(mode="compressed", min_weight_size=1024),
        manifest=False)
    ts = convert.serve_state_from_numpy(
        state_to_numpy(st), np.asarray(st.lut), tcfg, mode="compressed",
        device="cpu")
    return cfg, tcfg, st, ts.params, ServeContext(tcfg, lut=ts.lut,
                                                  device="cpu")


@pytest.fixture(scope="module")
def served():
    return _served("llama3.2-1b")


def _prompts(vocab, n, seed=100):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, int(rng.randint(4, 12))).astype(np.int32)
            for _ in range(n)]


def _ref(tp, ctx, prompt, max_new, max_len):
    """The port's one-shot generate of ``prompt`` alone."""
    return TE.generate(tp, None, torch.from_numpy(prompt)[None], ctx=ctx,
                       max_new=max_new, max_len=max_len)[0].numpy()


def _by_rid(eng):
    return {c.rid: c for c in eng.completions}


def _staggered(eng, submit, n, seed=0, lo=3, hi=9):
    """Submit ``n`` requests at cumulative Poisson(1.5) ticks while
    stepping, then drain; ``submit(i, max_new)`` submits request i.
    → the max_news."""
    rng = np.random.RandomState(seed)
    max_news = rng.randint(lo, hi, n)
    arrivals = np.concatenate([[0], np.cumsum(rng.poisson(1.5, n - 1))])
    done = 0
    while done < n or eng.health()["occupied"] or eng.health()["queued"]:
        while done < n and eng.steps >= arrivals[done]:
            submit(done, int(max_news[done]))
            done += 1
        eng.step()
    return max_news


def _reference_logits(jp, cfg, jlut, prompt, n, max_len):
    """The reference's greedy tokens and each step's logits for one prompt
    at cache length ``max_len`` (what its Engine and generate run)."""
    prefill, decode_step = JE.make_serve_fns(cfg)
    caches = JLM.init_caches(cfg, 1, max_len)
    logits, caches = prefill(jp, jlut, {"tokens": jnp.asarray(prompt[None])},
                             caches)
    tokens, steps = [], []
    for i in range(n):
        steps.append(np.asarray(logits, np.float32)[0])
        tokens.append(int(steps[-1].argmax()))
        if i < n - 1:
            logits, caches = decode_step(
                jp, jlut, jnp.asarray([[tokens[-1]]], jnp.int32), caches,
                len(prompt) + i)
    return np.array(tokens), steps


def _equal_or_tied(st, cfg, prompt, got, want, max_len):
    """``got`` equals ``want`` (the reference's tokens for ``prompt``), or
    differs first at a step where the reference's logits give both tokens
    the same value (an exact bf16 tie, which a one-ulp difference in the
    port's logits resolves the other way)."""
    if np.array_equal(got, want):
        return
    t0 = len(prompt)
    tokens, steps = _reference_logits(st.params, cfg, st.lut, prompt,
                                      len(want) - t0, max_len)
    np.testing.assert_array_equal(tokens, want[t0:])
    s = int(np.argmax(got[t0:] != want[t0:]))
    assert steps[s][got[t0 + s]] == steps[s][want[t0 + s]], (
        f"step {s}: port token {got[t0 + s]} is not tied with the "
        f"reference's {want[t0 + s]}")


# -- parity ------------------------------------------------------------

def test_single_request_bitwise_parity(served):
    cfg, tcfg, st, tp, ctx = served
    eng = Engine(ctx, tp, n_slots=2, max_len=24)
    [p] = _prompts(cfg.vocab_size, 1)
    eng.submit(Request(tokens=p, max_new=5))
    comps = eng.drain()
    assert len(comps) == 1 and comps[0].finished == "max_new"
    np.testing.assert_array_equal(comps[0].tokens,
                                  _ref(tp, ctx, p, 5, eng.pool.max_len))


def test_mixed_trace_staggered_arrivals_bitwise_parity(served):
    """8 overlapping requests, staggered arrivals, varied prompt and
    decode lengths, 3 slots: every output bitwise-equal to one-shot
    generate, with occupancy > 1 and mid-decode admissions."""
    cfg, tcfg, st, tp, ctx = served
    eng = Engine(ctx, tp, n_slots=3, max_len=20)
    prompts = _prompts(cfg.vocab_size, 8)
    max_news = _staggered(eng, lambda i, m: eng.submit(
        Request(tokens=prompts[i], max_new=m, rid=i)), 8)
    h = eng.health()
    assert h["completed"] == 8 and h["occupancy_max"] == 3
    assert h["joined_mid_decode"] >= 1
    by_rid = _by_rid(eng)
    for i, p in enumerate(prompts):
        assert by_rid[i].finished == "max_new"
        np.testing.assert_array_equal(
            by_rid[i].tokens,
            _ref(tp, ctx, p, int(max_news[i]), eng.pool.max_len),
            err_msg=f"request {i} diverged from one-shot generate")


def test_engine_matches_reference_engine(served):
    """The same trace through the reference's Engine on the same weights:
    greedy tokens equal, under the exact-tie rule."""
    cfg, tcfg, st, tp, ctx = served
    prompts = _prompts(cfg.vocab_size, 8)
    engines = {"port": Engine(ctx, tp, n_slots=3, max_len=20),
               "ref": JEngine(JContext.from_state(cfg, st), st.params,
                              n_slots=3, max_len=20)}
    make = {"port": Request, "ref": JRequest}
    out = {}
    for name, eng in engines.items():
        _staggered(eng, lambda i, m: eng.submit(
            make[name](tokens=prompts[i], max_new=m, rid=i)), 8)
        out[name] = _by_rid(eng)
        assert eng.health()["joined_mid_decode"] >= 1
    for i, p in enumerate(prompts):
        _equal_or_tied(st, cfg, p, out["port"][i].tokens,
                       np.asarray(out["ref"][i].tokens), 20)


def test_cpu_ticks_run_the_step_eagerly(served):
    """On the CPU nothing is captured: each tick runs one eager generate
    step (one decode step's matmuls) on the engine's buffers, and each
    admission one prefill."""
    cfg, tcfg, st, tp, ctx = served
    eng = Engine(ctx, tp, n_slots=2, max_len=16)
    for i, p in enumerate(_prompts(cfg.vocab_size, 3, seed=1)):
        eng.submit(Request(tokens=p, max_new=4, rid=i))
    ops.DISPATCH_COUNTS.clear()
    eng.drain()
    ticks = sum(1 for o in eng.stats["occupancy"] if o)
    assert ops.DISPATCH_COUNTS["fused"] == (7 * tcfg.n_layers
                                            * (ticks + 3))
    assert TE.CAPTURE_COUNTS["generate_step"] == 0 and not eng._graphs
    assert eng.capture_ms is None


# -- slot lifecycle ----------------------------------------------------

def test_completion_frees_slot_and_queue_refills(served):
    """More requests than slots: early finishers free their slot, queued
    requests join the running loop, pages recycle, outputs stay exact."""
    cfg, tcfg, st, tp, ctx = served
    eng = Engine(ctx, tp, n_slots=2, max_len=16)
    prompts = _prompts(cfg.vocab_size, 5, seed=7)
    max_news = [2, 6, 3, 5, 4]
    for i, p in enumerate(prompts):
        eng.submit(Request(tokens=p, max_new=max_news[i], rid=i))
    n_pages0 = len(eng.pool.free_pages)
    eng.drain()
    h = eng.health()
    assert h["completed"] == 5 and h["joined_mid_decode"] >= 1
    assert len(eng.pool.free_pages) == n_pages0
    by_rid = _by_rid(eng)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            by_rid[i].tokens,
            _ref(tp, ctx, p, max_news[i], eng.pool.max_len),
            err_msg=f"request {i}: stale KV after page reuse?")


def test_page_reuse_no_stale_kv(served):
    """The same prompt before and after other tenants churned through the
    pool's pages (LIFO reuse): identical outputs."""
    cfg, tcfg, st, tp, ctx = served
    eng = Engine(ctx, tp, n_slots=2, max_len=16)
    [p0, p1, p2] = _prompts(cfg.vocab_size, 3, seed=11)
    eng.submit(Request(tokens=p0, max_new=5, rid=0))
    first = eng.drain()[0].tokens
    eng.submit(Request(tokens=p1, max_new=6, rid=1))
    eng.submit(Request(tokens=p2, max_new=4, rid=2))
    eng.drain()
    eng.submit(Request(tokens=p0, max_new=5, rid=3))
    again = eng.drain()[0].tokens
    np.testing.assert_array_equal(first, again)


def test_eos_stops_early_and_frees_slot(served):
    cfg, tcfg, st, tp, ctx = served
    [p] = _prompts(cfg.vocab_size, 1, seed=3)
    full = Engine(ctx, tp, n_slots=1, max_len=24)
    full.submit(Request(tokens=p, max_new=6))
    ref = full.drain()[0].tokens
    eos = int(ref[len(p) + 2])             # a token generated mid-stream
    eng = Engine(ctx, tp, n_slots=2, max_len=24)
    eng.submit(Request(tokens=p, max_new=6, eos_id=eos))
    [c] = eng.drain()
    assert c.finished == "eos"
    assert c.n_generated <= 3 and c.tokens[-1] == eos
    np.testing.assert_array_equal(c.tokens, ref[:len(p) + c.n_generated])
    assert eng.health()["occupied"] == 0
    assert len(eng.pool.free_pages) == eng.pool.n_pages


# -- sampling ----------------------------------------------------------

def test_row_draw_is_a_pure_function_of_key_position_and_logits():
    """Per-row mode: rows at temperature 0 take the argmax exactly; a row's
    draw depends on its key, position and logits only (alone or in any
    batch, in any order); the host's and the tensors' hashes agree."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(6, 300, generator=g) * 3
    temp = torch.tensor([0.0, 0.8, 1.0, 0.0, 2.0, 0.5])
    seeds = [TE.seed_key(s) for s in (0, 1, 2, 3, 2 ** 40, -5)]
    keys = torch.tensor(seeds)
    pos = torch.tensor([3, 3, 9, 0, 17, 250])
    rk = TE.fold_in(keys, pos)
    out = TE.sample_tokens(logits, temp, keys=rk)
    greedy = torch.argmax(logits, dim=-1)
    assert torch.equal(out[temp == 0], greedy[temp == 0])
    assert torch.equal(TE.sample_tokens(logits, temp, keys=rk), out)
    for r in range(6):
        assert torch.equal(TE.sample_tokens(logits[r:r + 1], temp[r:r + 1],
                                            keys=rk[r:r + 1]), out[r:r + 1])
    perm = torch.tensor([5, 2, 0, 4, 1, 3])
    assert torch.equal(TE.sample_tokens(logits[perm], temp[perm],
                                        keys=rk[perm]), out[perm])
    # the fold on the host (ints) and on tensors: the same 32-bit keys
    assert rk.tolist() == [int(TE.fold_in(s, p)) for s, p in
                           zip(seeds, pos.tolist())]
    assert all(0 <= k < 2 ** 32 for k in seeds + rk.tolist())
    # another position or seed draws anew
    many = TE.sample_tokens(logits[4:5].expand(64, -1), temp[4:5].expand(64),
                            keys=TE.fold_in(keys[4:5].expand(64),
                                            torch.arange(64)))
    assert len(set(many.tolist())) > 32


def test_row_draw_follows_the_softmax():
    """Over 40 000 (key, position) pairs the draws' frequencies are the
    softmax's within 0.01 (three standard deviations of a fair draw)."""
    n = 40_000
    logits = torch.tensor([0.0, 1.0, 2.0, 2.5]).expand(n, 4)
    temp = torch.full((n,), 1.5)
    keys = TE.fold_in(torch.full((n,), TE.seed_key(7)), torch.arange(n))
    draws = TE.sample_tokens(logits, temp, keys=keys)
    freq = torch.bincount(draws, minlength=4).double() / n
    want = torch.softmax(logits[0].double() / 1.5, dim=-1)
    assert (freq - want).abs().max().item() < 0.01, (freq, want)


def test_sampling_deterministic_and_independent_of_slot(served):
    """A sampled request gives the same tokens run to run, alone in slot 0
    or in slot 2 beside co-tenants of other temperatures, and not the
    greedy ones."""
    cfg, tcfg, st, tp, ctx = served
    ps = _prompts(cfg.vocab_size, 3, seed=5)

    def run(cotenants):
        eng = Engine(ctx, tp, n_slots=3, max_len=20)
        if cotenants:
            eng.submit(Request(tokens=ps[1], max_new=6, rid=1))
            eng.submit(Request(tokens=ps[2], max_new=3, temperature=1.3,
                               seed=9, rid=2))
        eng.submit(Request(tokens=ps[0], max_new=8, temperature=0.8,
                           seed=42, rid=0))
        eng.drain()
        return _by_rid(eng)

    alone, again, shared = run(False), run(False), run(True)
    np.testing.assert_array_equal(alone[0].tokens, again[0].tokens)
    np.testing.assert_array_equal(alone[0].tokens, shared[0].tokens)
    np.testing.assert_array_equal(
        shared[1].tokens, _ref(tp, ctx, ps[1], 6, 24))
    greedy = _ref(tp, ctx, ps[0], 8, 24)
    assert not np.array_equal(alone[0].tokens, greedy)
    np.testing.assert_array_equal(alone[0].tokens[:len(ps[0]) + 1],
                                  greedy[:len(ps[0]) + 1])


def test_preempted_sampled_request_resumes_bitwise(served):
    """Overcommitted pool (2 pages back 1 of 2 slots): a priority-1
    arrival evicts a temperature-0.8 request, which resumes and draws
    exactly what an uninterrupted run draws."""
    cfg, tcfg, st, tp, ctx = served
    p0, p1 = (p[:6] for p in _prompts(cfg.vocab_size, 2, seed=29))
    solo = Engine(ctx, tp, n_slots=1, max_len=16)
    solo.submit(Request(tokens=p0, max_new=8, temperature=0.8, seed=3))
    [want] = solo.drain()
    eng = Engine(ctx, tp, n_slots=2, max_len=16, page_size=8, n_pages=2)
    eng.submit(Request(tokens=p0, max_new=8, temperature=0.8, seed=3,
                       rid=0))
    eng.step()
    eng.step()
    eng.submit(Request(tokens=p1, max_new=3, rid=1, priority=1))
    eng.drain()
    c = _by_rid(eng)[0]
    assert c.resumed == 1 and eng.health()["preempted"] == 1
    np.testing.assert_array_equal(c.tokens, want.tokens)


# -- admission control -------------------------------------------------

def test_submit_validates(served):
    cfg, tcfg, st, tp, ctx = served
    eng = Engine(ctx, tp, n_slots=1, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(tokens=np.arange(10), max_new=10))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(tokens=np.zeros((0,), np.int32)))
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(Request(tokens=np.arange(3), max_new=0))
    with pytest.raises(ValueError, match="shed_policy"):
        Engine(ctx, tp, shed_policy="drop-newest")


def test_rid_collision_rejected(served):
    cfg, tcfg, st, tp, ctx = served
    [p] = _prompts(cfg.vocab_size, 1, seed=27)
    eng = Engine(ctx, tp, n_slots=2, max_len=16)
    eng.submit(Request(tokens=p, max_new=1, rid=7))
    with pytest.raises(ValueError, match="rid 7 already in flight"):
        eng.submit(Request(tokens=p, max_new=1, rid=7))
    assert eng.submit(Request(tokens=p, max_new=1)) == 8
    eng.drain()
    assert eng.submit(Request(tokens=p, max_new=1, rid=7)) == 7
    eng.drain()


@pytest.mark.parametrize("policy", ["reject-new", "drop-oldest"])
def test_bounded_queue_sheds_per_policy(served, policy):
    cfg, tcfg, st, tp, ctx = served
    [p] = _prompts(cfg.vocab_size, 1, seed=23)
    eng = Engine(ctx, tp, n_slots=1, max_len=16, max_queue=1,
                 shed_policy=policy)
    r0 = eng.submit(Request(tokens=p, max_new=1))
    r1 = eng.submit(Request(tokens=p, max_new=1))
    shed, kept = (r1, r0) if policy == "reject-new" else (r0, r1)
    assert [c.rid for c in eng.completions] == [shed]
    assert eng.completions[0].finished == "shed"
    assert eng.completions[0].n_generated == 0
    assert [q.req.rid for q in eng._queue] == [kept]
    assert eng.health()["shed"] == 1 and FALLBACK_COUNTS["shed"] == 1
    eng.drain()
    assert {c.rid: c.finished for c in eng.completions} == {
        shed: "shed", kept: "max_new"}


def test_request_ttl_expires_queued_and_inflight(served):
    cfg, tcfg, st, tp, ctx = served
    p = _prompts(cfg.vocab_size, 1, seed=25)[0][:6]
    eng = Engine(ctx, tp, n_slots=1, max_len=16)
    eng.submit(Request(tokens=p, max_new=4, rid=0))
    eng.submit(Request(tokens=p, max_new=4, rid=1, ttl_steps=1))
    eng.step()                    # r0 takes the only slot; r1 queued
    eng.step()                    # r1's TTL passes while queued
    by_rid = _by_rid(eng)
    assert by_rid[1].finished == "deadline" and by_rid[1].n_generated == 0
    eng.drain()
    eng.submit(Request(tokens=p, max_new=10, rid=2, ttl_steps=3))
    eng.drain()
    c = _by_rid(eng)[2]
    assert c.finished == "deadline" and 0 < c.n_generated < 10
    np.testing.assert_array_equal(c.tokens[:len(p)], p)
    assert len(eng.pool.free_pages) == eng.pool.n_pages
    eng = Engine(ctx, tp, n_slots=1, max_len=16, request_ttl=0)
    eng.submit(Request(tokens=p, max_new=4, rid=3))
    eng.step()
    assert eng.completions[0].finished == "deadline"
    assert FALLBACK_COUNTS["expired"] == 3


# -- preemption + page pressure ----------------------------------------

def test_preempt_under_page_pressure_resumes_bitwise(served):
    """Overcommitted pool: a priority-1 arrival evicts the in-flight
    priority-0 request, which later resumes and matches one-shot generate;
    equal priority waits instead (no livelock-swap)."""
    cfg, tcfg, st, tp, ctx = served
    p0 = _prompts(cfg.vocab_size, 1, seed=29)[0][:6]
    p1 = _prompts(cfg.vocab_size, 1, seed=31)[0][:6]
    eng = Engine(ctx, tp, n_slots=2, max_len=16, page_size=8, n_pages=2)
    eng.submit(Request(tokens=p0, max_new=8, rid=0))
    eng.step()
    eng.submit(Request(tokens=p1, max_new=3, rid=1, priority=1))
    eng.drain()
    h = eng.health()
    assert h["preempted"] == 1 and h["resumed"] == 1
    assert FALLBACK_COUNTS["preempt"] == 1
    by_rid = _by_rid(eng)
    assert by_rid[0].resumed == 1 and by_rid[0].finished == "max_new"
    np.testing.assert_array_equal(by_rid[0].tokens,
                                  _ref(tp, ctx, p0, 8, eng.pool.max_len))
    np.testing.assert_array_equal(by_rid[1].tokens,
                                  _ref(tp, ctx, p1, 3, eng.pool.max_len))
    eng = Engine(ctx, tp, n_slots=2, max_len=16, page_size=8, n_pages=2)
    eng.submit(Request(tokens=p0, max_new=4, rid=0))
    eng.step()
    eng.submit(Request(tokens=p1, max_new=2, rid=1))
    eng.step()
    assert eng.health()["preempted"] == 0 and eng.health()["queued"] == 1
    eng.drain()
    assert all(c.finished == "max_new" for c in eng.completions)


def test_preempt_lowest_requeues_at_the_front(served):
    cfg, tcfg, st, tp, ctx = served
    ps = [p[:6] for p in _prompts(cfg.vocab_size, 3, seed=43)]
    eng = Engine(ctx, tp, n_slots=2, max_len=16)
    eng.submit(Request(tokens=ps[0], max_new=5, rid=0, priority=1))
    eng.submit(Request(tokens=ps[1], max_new=5, rid=1))
    eng.submit(Request(tokens=ps[2], max_new=5, rid=2))
    eng.step()
    assert eng.preempt_lowest()
    assert [q.req.rid for q in eng._queue] == [1, 2]
    assert FALLBACK_COUNTS["pressure_preempt"] == 1
    eng.drain()
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(_by_rid(eng)[i].tokens,
                                      _ref(tp, ctx, p, 5, eng.pool.max_len))


def test_drain_error_carries_health_and_slot_state(served):
    """A drain that cannot converge (no pages ever) raises with the health
    snapshot and the queue's rids."""
    cfg, tcfg, st, tp, ctx = served
    [p] = _prompts(cfg.vocab_size, 1, seed=35)
    eng = Engine(ctx, tp, n_slots=1, max_len=16)
    eng.submit(Request(tokens=p, max_new=2, rid=0))
    eng.pool.can_alloc = lambda: False
    with pytest.raises(RuntimeError, match=r"(?s)did not converge after 3 "
                       r"steps; health=\{.*queued rids=\[0\]"):
        eng.drain(max_steps=3)


# -- poisoned-request quarantine ---------------------------------------

def _guard_faulting(tcfg, slot, armed):
    """A guard that raises ServeRefused for a decode or replay call
    running ``slot`` while ``armed[0]``."""
    def guard(call, kind):
        if armed[0] and kind != "prefill" and call.active[slot]:
            raise ServeRefused([("fused", 0, f"poisoned slot {slot}")])
        return call(tcfg)
    return guard


def test_quarantine_refuses_exactly_one_of_mixed_batch(served):
    """A fault while slot 1 is active in a 3-request batch refuses exactly
    that request; the survivors resume and finish bitwise-equal to an
    uninterrupted run."""
    cfg, tcfg, st, tp, ctx = served
    armed = [True]
    eng = Engine(ctx, tp, n_slots=3, max_len=16,
                 guard=_guard_faulting(tcfg, 1, armed))
    prompts = [p[:6] for p in _prompts(cfg.vocab_size, 3, seed=37)]
    for i, p in enumerate(prompts):
        eng.submit(Request(tokens=p, max_new=4, rid=i))
    while not any(c.finished == "refused" for c in eng.completions):
        eng.step()
    armed[0] = False
    eng.drain()
    by_rid = _by_rid(eng)
    assert by_rid[1].finished == "refused"
    assert "poisoned slot 1" in by_rid[1].error
    assert FALLBACK_COUNTS["quarantine"] == 1
    for i in (0, 2):
        assert by_rid[i].finished == "max_new" and by_rid[i].resumed == 1
        np.testing.assert_array_equal(
            by_rid[i].tokens, _ref(tp, ctx, prompts[i], 4, eng.pool.max_len),
            err_msg=f"survivor {i} diverged after quarantine resume")


def test_prefill_fault_refuses_that_request_alone(served):
    cfg, tcfg, st, tp, ctx = served
    calls = []

    def guard(call, kind):
        if kind == "prefill":
            calls.append(kind)
            if len(calls) == 2:
                raise ServeRefused([("fused", 0, "bad prompt")])
        return call(tcfg)

    eng = Engine(ctx, tp, n_slots=2, max_len=16, guard=guard)
    prompts = _prompts(cfg.vocab_size, 3, seed=45)
    for i, p in enumerate(prompts):
        eng.submit(Request(tokens=p, max_new=3, rid=i))
    eng.drain()
    by_rid = _by_rid(eng)
    assert by_rid[1].finished == "refused" and by_rid[1].n_generated == 0
    for i in (0, 2):
        np.testing.assert_array_equal(
            by_rid[i].tokens, _ref(tp, ctx, prompts[i], 3, eng.pool.max_len))


def test_other_errors_are_not_quarantined(served):
    """Only ServeRefused and device faults are quarantined: another error
    (a shape bug, say) propagates."""
    cfg, tcfg, st, tp, ctx = served

    def guard(call, kind):
        if kind == "decode":
            raise RuntimeError("shape mismatch")
        return call(tcfg)

    eng = Engine(ctx, tp, n_slots=2, max_len=16, guard=guard)
    eng.submit(Request(tokens=_prompts(cfg.vocab_size, 1)[0], max_new=3))
    with pytest.raises(RuntimeError, match="shape mismatch"):
        eng.drain()
    assert FALLBACK_COUNTS["quarantine"] == 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b"])
def test_quant_mode_engine_matches_generate(arch):
    """Quant mode (every projection a QuantLinear through K5): 6 staggered
    requests through 2 slots, each completion bitwise equal to one-shot
    generate of its prompt alone.  On Llama nothing is materialized (the
    embedding gathers rows, the tied head multiplies through K5); on
    DeepSeek only MLA's wkv_b and the expert stacks, as the reference."""
    from repro_torch.core.compressed import QuantLinear
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    tcfg = tget_config(arch).smoke
    st = TE.build_serve_params(
        LM.init_lm(tcfg, seed=0, device="cpu"),
        CompressionPolicy(mode="quant", min_weight_size=1024), device="cpu")
    assert isinstance(st.params["embed"], QuantLinear)
    ctx = ServeContext(tcfg, lut=st.lut, device="cpu")
    eng = Engine(ctx, st.params, n_slots=2, max_len=20)
    prompts = _prompts(tcfg.vocab_size, 6)
    L.MATERIALIZE_COUNTS.clear()
    max_news = _staggered(eng, lambda i, m: eng.submit(
        Request(tokens=prompts[i], max_new=m, rid=i)), 6)
    assert set(L.MATERIALIZE_COUNTS) <= (
        set() if tcfg.family == "dense" else {"quant"})
    assert eng.health()["joined_mid_decode"] >= 1
    by_rid = _by_rid(eng)
    for i, p in enumerate(prompts):
        assert by_rid[i].finished == "max_new"
        np.testing.assert_array_equal(
            by_rid[i].tokens,
            _ref(st.params, ctx, p, int(max_news[i]), eng.pool.max_len),
            err_msg=f"request {i} diverged from one-shot generate")
