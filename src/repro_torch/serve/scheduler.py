"""Continuous-batching scheduler: the request-level serving API.

Counterpart of ``repro/serve/scheduler.py`` for one device.  One-shot
``engine.generate`` serves a fixed batch: no request can join or leave its
decode phase.  This module is the serving front door built on the split
prefill → insert → generate step:

  * ``Request`` / ``Completion``: the public dataclasses.  A request is a
    prompt, a decode budget (``max_new``), an optional ``eos_id``,
    sampling controls, a ``priority`` (preemption rank) and an optional
    TTL or wall-clock deadline counted from ``submit()``; a completion
    carries the ``generate``-shaped token sequence and how it ended.
  * ``Engine.submit(request)``: queue a request (returns its rid).  With
    ``max_queue`` set the queue is bounded, and an overflow sheds a
    request by ``shed_policy`` as a ``Completion(finished='shed')``.
  * ``Engine.step()``: one tick.  Expire queued and in-flight requests
    whose TTL or deadline passed; admit queued requests into free slots
    (an eager batch-1 prefill into a cache fragment, then
    ``kv_cache.insert_fragment`` into the slot's pages); advance every
    occupied slot one token with the generate step; retire slots that hit
    EOS or their budget, freeing their pages.  Returns the tick's
    completions.
  * ``Engine.drain()``: step until queue and slots are empty.

The generate step (``Engine._step``: ``paged_view``, the model's decode
step at per-slot positions, the per-row draw, ``write_token``, the store
of the next tokens) reads only buffers the engine owns at fixed addresses:
the page table, tokens, positions, active mask, temperatures and keys.  On
the card it runs eagerly once and is then captured as one CUDA graph per
engine (the counterpart of the reference's ``_generate_step``, jitted once
per config); every later tick fills the buffers by one host-to-device
copy, replays, and reads the (B,) next tokens, the one synchronization a
tick needs.  On the CPU the same step runs eagerly on the same buffers.
Vacant slots compute garbage that ``write_token`` sends to the pool's sink
page.

Fault isolation: when a tick fails with ``ServeRefused`` (raised by the
``guard`` hook) or a device fault, the engine bisects the active slots by
replaying masked sub-batches through the same step, refuses only the
culprits (``finished='refused'``) and requeues the survivors, which resume
through a fresh prefill of the prompt and a decode step for each token
generated before but the last (on the card, replays of one captured
batch-1 step).  A device fault
inside a graph replay leaves the CUDA context unusable, so on the card the
bisection can isolate only faults raised by the guard or by host code.
Under page pressure (an overcommitted ``n_pages``), the lowest-priority,
youngest in-flight request is evicted back to the queue for a
strictly-higher-priority arrival and resumes the same way.

Parity (the acceptance bar): a request served here, preempted or resumed
or not, yields tokens bitwise equal to ``engine.generate`` of its prompt
alone with ``max_len=engine.pool.max_len``, under greedy decoding.  The
prefill is ``generate``'s closure over the same cache shape, and a resume
rebuilds its cache by the same prefill and decode steps ``generate`` ran
(a prefill over the generated tokens would sum them in the prefill
kernels' order, which on the card is not the decode kernels'); masked cache
entries (−1e30, whose exp is 0) add nothing whatever stale pages hold;
and a row's sampling stream folds in its absolute position, so a resume
at position P draws what the uninterrupted run drew at P.  MoE configs
need the dropless regime (``capacity_factor >= n_experts / top_k``), since
expert capacity depends on the batch.  Sampled tokens are the port's own:
``generate`` samples from a ``torch.Generator``, the engine from per-row
counter-based streams (``engine.sample_tokens``), as the reference's
engine and its ``generate`` draw differently too.

Under ``serve.resilience.ResilientEngine.scheduler()`` the guard walks
the degradation ladder: each rung runs under its own config, so it gets a
graph of its own, captured under its own dispatch lever.

Memory: with a ``serve.governor.MemoryGovernor`` attached
(``Engine(governor=...)``), every ``step()`` first lets it trim or regrow
the residency cache, retire or restore KV pages (a released or grown tail
moves the page tensors, and the engine captures its tick anew), preempt,
tighten ``max_queue`` or refuse new work (``finished='pressure'``).  With
a ``ResidencyManager`` on the context (tiered expert residency), the
prefill and every tick run eagerly through the manager's fetch/replay
protocol (``serve/residency.py``); completions stay bitwise equal to the
resident engine's.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Any, List, Optional

import numpy as np
import torch

from .._device import resolve_device, upload
from ..models import lm as LM
from ..sharding import partition as PT
from . import engine as _engine
from .context import ServeContext
from .kv_cache import (PagedKVPool, PoolExhausted, _leaves, paged_view,
                       write_token)
from .resilience import FALLBACK_COUNTS, ServeRefused

# What the robustness layer treats as "this call faulted": an exhausted
# ladder (a guard's ServeRefused) or a device fault.  Not a bare
# RuntimeError: a shape bug would then be quarantined as a poisoned
# request.
_FAULTS = (ServeRefused, torch.AcceleratorError)

SHED_POLICIES = ("reject-new", "drop-oldest")


def _generate_step(engine, cfg, mask: np.ndarray) -> torch.Tensor:
    """The seam every decode tick and bisection probe crosses, the
    counterpart of the reference's jitted ``_generate_step`` (which
    ``testing.faults.FaultInjector.slot_fault`` wraps): ``engine``'s
    generate step under ``cfg`` for the slots in ``mask``, eager or a
    replay of its graph.  → the (B,) next tokens on the device."""
    return engine._launch(cfg, mask)


def _unguarded(cfg, call, kind):
    """The default ``guard`` (bound to the engine's config): run the call."""
    return call(cfg)


@dataclasses.dataclass
class Request:
    """One generation request.

    tokens: (T,) int prompt.  max_new: decode budget, generated tokens
    including the one the prefill emits.  eos_id: stop token (the emitted
    sequence includes it).  temperature / seed: sampling controls; each
    row's stream folds in the absolute position, so tokens do not depend
    on the slot, the co-tenants or a preempt and resume.  priority:
    preemption rank (higher wins; a queued request may evict a
    strictly-lower-priority in-flight one under page pressure).
    ttl_steps / deadline_s: expiry counted from ``submit()`` in engine
    steps / wall-clock seconds (ttl_steps None defers to the engine's
    ``request_ttl``)."""
    tokens: Any
    max_new: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0
    seed: int = 0
    rid: Optional[int] = None          # assigned by submit() when None
    priority: int = 0
    ttl_steps: Optional[int] = None
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class Completion:
    """A finished request: ``tokens`` is prompt + generated (for 'eos' and
    'max_new' exactly what one-shot ``generate`` returns for the prompt;
    for overload and fault outcomes, what was produced before the end)."""
    rid: int
    prompt: np.ndarray
    tokens: np.ndarray
    n_generated: int
    finished: str        # 'eos' | 'max_new' | 'shed' | 'deadline' |
                         # 'refused' | 'pressure'
    submitted_step: int
    finished_step: int
    resumed: int = 0     # preempt / quarantine-survivor re-prefills taken
    error: Optional[str] = None        # diagnostics when finished='refused'


@dataclasses.dataclass
class _Pending:
    """A queued request: fresh (``out`` empty) or awaiting resume after a
    preemption or a quarantine (``out`` holds the tokens generated
    before)."""
    req: Request
    submitted_step: int
    submit_time: float
    out: List[int] = dataclasses.field(default_factory=list)
    resumed: int = 0


@dataclasses.dataclass
class _Slot:
    """Host-side record of an occupied decode slot."""
    req: Request
    out: List[int]                     # generated tokens so far
    pos: int                           # next cache write position
    key: int                           # the request's 32-bit sampling key
    submitted_step: int
    submit_time: float
    resumed: int = 0

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def prompt(self) -> np.ndarray:
        return self.req.tokens


class Engine:
    """Continuous-batching serve engine over a paged KV pool.

    ctx: ``ServeContext`` (cfg, lut, device: the card unless it names
    another).  params: served weights (``ServeState.params``).  n_slots ×
    max_len sizes the pool (max_len rounds up to a page multiple: read it
    back from ``engine.pool.max_len``); ``n_pages`` below ``n_slots *
    pages_per_slot`` overcommits it (the preemption regime).  ``guard``
    hooks every call: ``guard(call, kind)`` with ``call(cfg) -> result``
    and kind in {'prefill', 'decode', 'replay'}; a decode or replay call
    carries the (B,) bool mask of the slots it runs as ``call.active``.

    Overload: ``max_queue`` bounds the queue (None = unbounded);
    ``shed_policy`` picks who sheds on overflow ('reject-new' |
    'drop-oldest'); ``request_ttl`` is the default ``ttl_steps``.
    Requeues from preemption or quarantine are exempt from ``max_queue``.
    ``governor``: an optional ``serve.governor.MemoryGovernor``, run at
    the top of every ``step()``.
    """

    def __init__(self, ctx: ServeContext, params, *, n_slots: int = 4,
                 max_len: int = 64, page_size: int = 8,
                 dtype=torch.bfloat16, guard=None,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject-new",
                 request_ttl: Optional[int] = None,
                 n_pages: Optional[int] = None, governor=None):
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES}, "
                             f"got {shed_policy!r}")
        self.ctx = ctx
        self.params = params
        self.device = resolve_device(ctx.device)
        self.pool = PagedKVPool(ctx.cfg, n_slots, max_len,
                                page_size=page_size, dtype=dtype,
                                n_pages=n_pages, device=self.device)
        self.guard = guard or functools.partial(_unguarded, ctx.cfg)
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.request_ttl = request_ttl
        self._queue: collections.deque = collections.deque()
        self._slots: List[Optional[_Slot]] = [None] * n_slots
        self._next_rid = 0
        self.steps = 0
        self.completions: List[Completion] = []
        self._init_buffers(dtype)
        self.governor = governor
        self.reset_stats()
        if governor is not None:
            governor.attach(self)

    def _init_buffers(self, dtype) -> None:
        """The step's inputs as views of one int64 device buffer, filled
        from one host buffer (pinned on the card) per tick: page table,
        tokens, positions, active mask, keys and temperatures (f32 bits).
        Then the next tokens, the prefill's fragment and the graphs."""
        b, npr = self.pool.n_slots, self.pool.pages_per_slot
        n = b * npr + 5 * b
        self._host = torch.zeros(n, dtype=torch.int64)
        if self.device.type == "cuda":
            self._host = self._host.pin_memory()
        self._dev = torch.zeros(n, dtype=torch.int64, device=self.device)
        shapes = ((b, npr), (b, 1), (b,), (b,), (b,), (b,))
        sizes = [int(np.prod(shape)) for shape in shapes]
        host = [t.view(shape) for t, shape in
                zip(self._host.split(sizes), shapes)]
        dev = [t.view(shape) for t, shape in
               zip(self._dev.split(sizes), shapes)]
        (self._h_pt, self._h_tok, self._h_pos, self._h_act, self._h_key,
         self._h_temp) = (h.numpy() for h in host)
        (self._pt, self._tok, self._pos, self._act, self._key,
         self._temp) = dev
        self._nxt = torch.zeros(b, dtype=torch.int64, device=self.device)
        self._frag = LM.init_caches(self.ctx.cfg, 1, self.pool.max_len,
                                    dtype, device=self.device)
        # a resume's decode steps on the fragment: their token and position
        self._rtok = torch.zeros((1, 1), dtype=torch.int64,
                                 device=self.device)
        self._rpos = torch.zeros((), dtype=torch.int64, device=self.device)
        self._graphs: dict = {}        # cfg -> (CUDA graph, step counts)
        self._graphs_moves = self.pool.moves   # the pages _graphs read
        self._resume_graphs: dict = {}     # the same, for the resume step
        self.capture_ms = None

    def reset_stats(self) -> None:
        """Zero the lifecycle counters (after a warm-up drain, say); under
        tiered residency also the manager's counters and
        ``RESIDENCY_COUNTS``."""
        self.stats = {"admitted": 0, "joined_mid_decode": 0,
                      "occupancy": [], "shed": 0, "expired": 0,
                      "preempted": 0, "quarantined": 0, "resumed": 0,
                      "queue_peak": 0, "pressure_refused": 0,
                      "pressure_preempted": 0}
        mgr = self.ctx.residency
        if mgr is not None:
            from .residency import RESIDENCY_COUNTS
            RESIDENCY_COUNTS.clear()
            mgr.reset_stats()

    # -- public API ----------------------------------------------------
    def submit(self, request: Request) -> int:
        """Queue a request; returns its rid.  Admission happens on a later
        ``step()`` once a slot and its pages free up.  When the bounded
        queue is full, this submission or the queue's head sheds by
        ``shed_policy``, as a ``Completion(finished='shed')`` on
        ``engine.completions``, never a silent drop."""
        toks = np.asarray(request.tokens, np.int32).reshape(-1)
        if toks.size == 0:
            raise ValueError("empty prompt")
        if request.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if toks.size + request.max_new > self.pool.max_len:
            raise ValueError(
                f"prompt ({toks.size}) + max_new ({request.max_new}) "
                f"exceeds pool max_len ({self.pool.max_len})")
        if request.rid is not None:
            rid = request.rid
            live = ({p.req.rid for p in self._queue}
                    | {s.rid for s in self._slots if s is not None})
            if rid in live:
                raise ValueError(
                    f"rid {rid} already in flight (queued or decoding); "
                    "caller-supplied rids must be unique among live "
                    "requests")
            # keep the auto counter ahead of caller-supplied rids
            self._next_rid = max(self._next_rid, rid + 1)
        else:
            rid = self._next_rid
            self._next_rid += 1
        pending = _Pending(req=dataclasses.replace(request, tokens=toks,
                                                   rid=rid),
                           submitted_step=self.steps,
                           submit_time=time.monotonic())
        if self.governor is not None and self.governor.refusing:
            # the reclaim ladder's last rung: the budget is below what the
            # engine can run under, so new work is refused, never queued
            FALLBACK_COUNTS["pressure_refused"] += 1
            self.stats["pressure_refused"] += 1
            self.completions.append(self._completion(
                pending.req.rid, pending.req.tokens, [], "pressure",
                pending.submitted_step))
            return rid
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            if self.shed_policy == "reject-new":
                self._shed(pending)
                return rid
            self._shed(self._queue.popleft())       # drop-oldest
        self._queue.append(pending)
        self.stats["queue_peak"] = max(self.stats["queue_peak"],
                                       len(self._queue))
        return rid

    def step(self) -> List[Completion]:
        """One tick: expire → admit → decode one token → retire.  Returns
        the completions this tick produced.  An attached governor runs
        first: the step boundary is the fence where no step is in flight,
        so it may rebuild the cache stacks and the page tensors."""
        if self.governor is not None:
            self.governor.on_step(self)
        done = self._expire()
        with PT.active_mesh(self.ctx.mesh):
            done.extend(self._admit())
            occ = [i for i, s in enumerate(self._slots) if s is not None]
            self.stats["occupancy"].append(len(occ))
            if occ:
                done.extend(self._decode_tick())
        self.steps += 1
        self.completions.extend(done)
        return done

    def drain(self, max_steps: int = 100_000) -> List[Completion]:
        """Step until the queue and all slots are empty; returns the
        completions produced while draining."""
        out: List[Completion] = []
        budget = max_steps
        while self._queue or any(s is not None for s in self._slots):
            out.extend(self.step())
            budget -= 1
            if budget <= 0:
                slots = [(i, s.rid, s.pos, len(s.out))
                         for i, s in enumerate(self._slots) if s is not None]
                raise RuntimeError(
                    f"drain did not converge after {max_steps} steps; "
                    f"health={self.health()}; "
                    f"slots (slot, rid, pos, n_out)={slots}; "
                    f"queued rids={[p.req.rid for p in self._queue]}")
        return out

    def health(self) -> dict:
        occ = self.stats["occupancy"]
        out = {
            "steps": self.steps,
            "queued": len(self._queue),
            "queue_peak": self.stats["queue_peak"],
            "occupied": sum(s is not None for s in self._slots),
            "admitted": self.stats["admitted"],
            "joined_mid_decode": self.stats["joined_mid_decode"],
            "occupancy_mean": float(np.mean(occ)) if occ else 0.0,
            "occupancy_max": int(np.max(occ)) if occ else 0,
            "completed": len(self.completions),
            "free_pages": len(self.pool.free_pages),
            "shed": self.stats["shed"],
            "expired": self.stats["expired"],
            "preempted": self.stats["preempted"],
            "quarantined": self.stats["quarantined"],
            "resumed": self.stats["resumed"],
        }
        if self.ctx.residency is not None:
            out["residency"] = self.ctx.residency.snapshot()
        if self.governor is not None:
            out["pressure"] = self.governor.snapshot()
        return out

    def close(self) -> None:
        """Drop the captured step graphs and their memory pools, and stop
        the residency prefetch worker (idempotent); a later tick captures
        again."""
        self._graphs.clear()
        self._resume_graphs.clear()
        if self.ctx.residency is not None:
            self.ctx.residency.close()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- overload internals --------------------------------------------
    def _shed(self, p: _Pending) -> None:
        FALLBACK_COUNTS["shed"] += 1
        self.stats["shed"] += 1
        self.completions.append(self._completion(
            p.req.rid, p.req.tokens, p.out, "shed", p.submitted_step,
            resumed=p.resumed))

    def _is_expired(self, ttl_steps, deadline_s, submitted_step,
                    submit_time) -> bool:
        ttl = ttl_steps if ttl_steps is not None else self.request_ttl
        if ttl is not None and self.steps - submitted_step >= ttl:
            return True
        return (deadline_s is not None
                and time.monotonic() - submit_time > deadline_s)

    def _expire(self) -> List[Completion]:
        """Retire queued and in-flight requests whose TTL or deadline has
        passed: ``Completion(finished='deadline')`` with whatever tokens
        exist, ``FALLBACK_COUNTS['expired']`` per request."""
        done: List[Completion] = []
        keep: collections.deque = collections.deque()
        for p in self._queue:
            if self._is_expired(p.req.ttl_steps, p.req.deadline_s,
                                p.submitted_step, p.submit_time):
                FALLBACK_COUNTS["expired"] += 1
                self.stats["expired"] += 1
                done.append(self._completion(
                    p.req.rid, p.req.tokens, p.out, "deadline",
                    p.submitted_step, resumed=p.resumed))
            else:
                keep.append(p)
        self._queue = keep
        for i, s in enumerate(self._slots):
            if s is not None and self._is_expired(
                    s.req.ttl_steps, s.req.deadline_s, s.submitted_step,
                    s.submit_time):
                FALLBACK_COUNTS["expired"] += 1
                self.stats["expired"] += 1
                done.append(self._completion(
                    s.rid, s.prompt, s.out, "deadline", s.submitted_step,
                    resumed=s.resumed))
                self._vacate(i)
        return done

    def _victim(self) -> Optional[int]:
        """The lowest-priority (tie: youngest) occupied slot, or None."""
        occ = [(s.req.priority, -s.submitted_step, i)
               for i, s in enumerate(self._slots) if s is not None]
        return min(occ)[2] if occ else None

    def _requeue(self, s: _Slot) -> _Pending:
        return _Pending(req=s.req, submitted_step=s.submitted_step,
                        submit_time=s.submit_time, out=list(s.out),
                        resumed=s.resumed + 1)

    def _preempt_for(self, head: _Pending) -> bool:
        """Evict the lowest-priority (tie: youngest) in-flight request to
        reclaim pages for ``head``, only if the victim ranks *strictly*
        below it (equal priorities must not livelock-swap)."""
        i = self._victim()
        if i is None or self._slots[i].req.priority >= head.req.priority:
            return False
        FALLBACK_COUNTS["preempt"] += 1
        self.stats["preempted"] += 1
        # requeue right behind the head that displaced it; it resumes by
        # re-prefill once pages free up
        self._queue.insert(1, self._requeue(self._slots[i]))
        self._vacate(i)
        return True

    def preempt_lowest(self) -> bool:
        """Evict the lowest-priority (tie: youngest) in-flight request to
        give its pages back under memory pressure: no displacing head, so
        no priority precondition.  The victim requeues at the front and
        resumes bitwise-equal by re-prefill.  Returns whether one was."""
        i = self._victim()
        if i is None:
            return False
        FALLBACK_COUNTS["pressure_preempt"] += 1
        self.stats["preempted"] += 1
        self.stats["pressure_preempted"] += 1
        self._queue.appendleft(self._requeue(self._slots[i]))
        self._vacate(i)
        return True

    def _vacate(self, i: int) -> None:
        self.pool.free(i)
        self._slots[i] = None

    # -- admission -----------------------------------------------------
    def _read(self, t: torch.Tensor) -> np.ndarray:
        """A device result on the host: the engine's only host reads (a
        tick's next tokens, an admission's first token), each a
        synchronization."""
        return t.cpu().numpy().copy()

    def _prefill(self, toks: np.ndarray, replay=()):
        """Prefill a 1-D prompt into the engine's fragment (zeroed first:
        batch 1, ``pool.max_len`` long), through the same prefill and
        cache shape one-shot ``generate`` uses, then run one decode step
        for each token of ``replay`` (a resumed request's tokens but its
        last), as generate's decode phase ran them: so the fragment holds
        what generate's cache would, bit for bit.  On the card those steps
        are replays of one captured batch-1 step.  → (greedy first token
        of the prompt, fragment)."""
        ids = upload(np.asarray(toks, np.int64)[None, :], self.device)
        rep = (upload(np.asarray(replay, np.int64).reshape(-1, 1, 1),
                      self.device) if len(replay) else None)

        def call(cfg):
            for t in _leaves(self._frag):
                t.zero_()
            prefill, decode_step = _engine.make_serve_fns(
                ctx=self.ctx.with_cfg(cfg))
            logits, _ = prefill(self.params, self.ctx.lut, {"tokens": ids},
                                self._frag)

            def step():
                decode_step(self.params, self.ctx.lut, self._rtok,
                            self._frag, self._rpos)
                self._rpos.add_(1)

            self._rpos.fill_(len(toks))
            for i in range(len(replay)):
                self._rtok.copy_(rep[i])
                self._graphed(self._resume_graphs, cfg, step, "resume_step")
            return _engine.sample_tokens(logits)

        tok0 = int(self._read(self.guard(call, "prefill"))[0])
        return tok0, self._frag

    def _admit(self) -> List[Completion]:
        """Move queued requests into free slots (prefill → insert).

        Fresh requests prefill their prompt; resumes prefill the prompt
        and decode out[:-1], so the cache holds what the uninterrupted
        run's held, and continue from their last token at the same
        position.  A request whose prefill itself faults is refused
        alone."""
        done: List[Completion] = []
        while self._queue:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                break
            if not self.pool.can_alloc():
                if not self._preempt_for(self._queue[0]):
                    break
                free = [i for i, s in enumerate(self._slots) if s is None]
            p = self._queue.popleft()
            req = p.req
            resume = bool(p.out)
            try:
                tok0, frag = self._prefill(req.tokens, p.out[:-1])
            except _FAULTS as e:
                FALLBACK_COUNTS["quarantine"] += 1
                self.stats["quarantined"] += 1
                done.append(self._completion(
                    req.rid, req.tokens, p.out, "refused", p.submitted_step,
                    resumed=p.resumed, error=repr(e)))
                continue
            self.stats["admitted"] += 1
            if resume:
                self.stats["resumed"] += 1
            if any(s is not None for s in self._slots):
                self.stats["joined_mid_decode"] += 1
            if not resume:
                eos = req.eos_id is not None and tok0 == req.eos_id
                if req.max_new == 1 or eos:
                    done.append(self._completion(
                        req.rid, req.tokens, [tok0],
                        "eos" if eos else "max_new", p.submitted_step))
                    continue
                out = [tok0]
            else:
                out = list(p.out)      # resume: the probe token is dropped
            slot = free[0]
            try:
                self.pool.alloc(slot)
            except PoolExhausted:
                # requeue at the head and retry next tick: the prefill is
                # pure, so nothing is lost
                self._queue.appendleft(p)
                break
            self.pool.insert(frag, slot)
            self._slots[slot] = _Slot(
                req=req, out=out, pos=len(req.tokens) + len(out) - 1,
                key=_engine.seed_key(req.seed),
                submitted_step=p.submitted_step, submit_time=p.submit_time,
                resumed=p.resumed)
        return done

    # -- decode --------------------------------------------------------
    def _step(self, cfg, params=None):
        """The generate step on the engine's buffers: what a CUDA graph
        captures.  Writes each active slot's new cache entry into its page
        and the (B,) next tokens into ``_nxt``.  ``params``: a residency
        manager's served tree, for which the step also returns its
        routing."""
        pool = self.pool
        view = paged_view(cfg, pool.pages, self._pt)
        _, decode_step = _engine.serve_fns(cfg, self.device,
                                           routing=params is not None)
        logits, _, *routing = decode_step(
            self.params if params is None else params, self.ctx.lut,
            self._tok, view, self._pos)
        temp = self._temp.to(torch.int32).view(torch.float32)
        nxt = _engine.sample_tokens(
            logits, temp, keys=_engine.fold_in(self._key, self._pos))
        write_token(cfg, pool.page_size, pool.pages, view, self._pt,
                    self._pos, self._act != 0)
        self._nxt.copy_(nxt)
        return routing[0] if routing else None

    def _launch(self, cfg, mask: np.ndarray) -> torch.Tensor:
        """Fill the buffers for the slots in ``mask`` and run the step:
        on the card, a replay of its graph (after one eager step and the
        capture, the first time, or the first time after the pool's pages
        moved); on the CPU, eagerly.  Under tiered residency, eagerly
        through the manager's fetch/replay protocol, the active slots'
        routing driving the fetches (a replayed pass rewrites each slot's
        row at its position before reading it, and ``_nxt``).  → next
        tokens."""
        self._h_pt[:] = self.pool.page_table
        self._h_act[:] = mask
        for i, s in enumerate(self._slots):
            if s is not None:
                self._h_tok[i, 0] = s.out[-1]
                self._h_pos[i] = s.pos
                self._h_key[i] = s.key
                self._h_temp[i] = np.float32(
                    max(s.req.temperature, 0.0)).view(np.int32)
        self._dev.copy_(self._host, non_blocking=True)
        mgr = self.ctx.residency
        if mgr is not None:
            mgr.check_params(self.params)
            mgr.run(lambda dp: (None, self._step(cfg, dp)), active=mask)
            return self._nxt
        if self._graphs_moves != self.pool.moves:
            self._graphs.clear()       # they read the pages' old addresses
            self._graphs_moves = self.pool.moves
        ms = self._graphed(self._graphs, cfg, lambda: self._step(cfg),
                           "generate_step")
        if ms is not None:
            self.capture_ms = ms
        return self._nxt

    def _graphed(self, graphs: dict, cfg, step, kind: str):
        """Run ``step()``: on the card, a replay of ``graphs[cfg]`` (after
        one eager step and the capture, counted as ``kind``, the first
        time); on the CPU, under tiered residency (whose steps read
        their routing on the host) or on a mesh (whose collectives over
        gloo are not captured), eagerly.  → the capture's host ms, or
        None."""
        if (self.device.type != "cuda" or self.ctx.residency is not None
                or self.ctx.mesh is not None):
            step()
        elif cfg in graphs:
            _engine.replay_step(*graphs[cfg])
        else:
            step()
            graph, counts, ms = _engine.capture_step(step)
            graphs[cfg] = (graph, counts)
            _engine.CAPTURE_COUNTS[kind] += 1
            return ms
        return None

    def _call_with(self, mask: np.ndarray):
        def call(cfg):
            return _generate_step(self, cfg, mask)
        call.active = mask
        return call

    def _decode_tick(self) -> List[Completion]:
        active = np.array([s is not None for s in self._slots])
        try:
            nxt = self._read(self.guard(self._call_with(active), "decode"))
        except _FAULTS as e:
            return self._quarantine(active, e)
        done: List[Completion] = []
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            t = int(nxt[i])
            s.out.append(t)
            s.pos += 1
            eos = s.req.eos_id is not None and t == s.req.eos_id
            if len(s.out) >= s.req.max_new or eos:
                done.append(self._completion(
                    s.rid, s.prompt, s.out, "eos" if eos else "max_new",
                    s.submitted_step, resumed=s.resumed))
                self._vacate(i)
        return done

    def _quarantine(self, active: np.ndarray, exc) -> List[Completion]:
        """Bisect the active slots to isolate the poisoned request(s).

        Runs masked sub-batches through the same step: a subset that
        faults is split, one that succeeds is cleared whole.  Culprits
        are refused (``finished='refused'``), survivors requeued at the
        front with their tokens for a resume re-prefill.  If no single
        culprit reproduces the fault, the original error re-raises:
        refusing everyone blindly would be worse than failing loudly."""
        occupied = [i for i in range(len(self._slots)) if active[i]]

        def faults(subset) -> bool:
            mask = np.zeros_like(active)
            mask[list(subset)] = True
            try:
                # read, so the next probe refills the buffers after this
                # one's copy
                self._read(self.guard(self._call_with(mask), "replay"))
                return False
            except _FAULTS:
                return True

        def bisect(group, known_faulty) -> List[int]:
            if not known_faulty and not faults(group):
                return []
            if len(group) == 1:
                return list(group)
            mid = len(group) // 2
            return bisect(group[:mid], False) + bisect(group[mid:], False)

        culprits = set(bisect(occupied, True))
        if not culprits:
            raise exc
        done: List[Completion] = []
        survivors: List[_Pending] = []
        for i in occupied:
            s = self._slots[i]
            if i in culprits:
                FALLBACK_COUNTS["quarantine"] += 1
                self.stats["quarantined"] += 1
                done.append(self._completion(
                    s.rid, s.prompt, s.out, "refused", s.submitted_step,
                    resumed=s.resumed, error=repr(exc)))
            else:
                # resume from the host's tokens by a fresh prefill: the
                # probes wrote into the survivors' pages
                survivors.append(self._requeue(s))
            self._vacate(i)
        self._queue.extendleft(reversed(survivors))
        return done

    def _completion(self, rid, prompt, out, reason, submitted, *,
                    resumed: int = 0, error: Optional[str] = None
                    ) -> Completion:
        return Completion(
            rid=rid, prompt=np.asarray(prompt),
            tokens=np.concatenate([np.asarray(prompt, np.int32),
                                   np.asarray(out, np.int32)]),
            n_generated=len(out), finished=reason,
            submitted_step=submitted, finished_step=self.steps,
            resumed=resumed, error=error)
