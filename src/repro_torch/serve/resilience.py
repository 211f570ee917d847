"""Resilient serving — bounded retry, deadlines and a degradation ladder.

Counterpart of ``repro/serve/resilience.py`` for one device.  A request
against a compressed model must neither die on the first device fault nor
serve from a corrupt artifact.  ``ResilientEngine`` wraps
``engine.generate`` and the prefill with:

  * **Integrity gate**: per ``ResiliencePolicy.verify`` ('off' | 'fast' |
    'full') the artifact is re-hashed against its pack-time manifest
    (``core.integrity.verify_serve_state``) and the device-side invariants
    run (``check_invariants``) before any decode; quarantined leaves abort
    serving with ``IntegrityError`` naming them.
  * **Bounded retry**: each rung is tried up to ``max_retries + 1`` times
    on ``torch.AcceleratorError`` (the port's counterpart of the
    reference's ``JaxRuntimeError``: a failed launch, an error the CUDA
    runtime reports, or the fault injector's).  Nothing else is caught: a
    shape bug raises a bare ``RuntimeError`` or ``ValueError`` and must
    not walk the ladder.
  * **Degradation ladder**: ``fused`` (K1/K3) → ``unfused`` (K4 decodes
    the dense weight, K5 multiplies) → ``materialize`` (the plain decode
    and a dense ``torch.matmul``: no port kernel for a compressed weight)
    → refuse with ``ServeRefused`` carrying the per-rung diagnostics.
    Each fallback ticks ``FALLBACK_COUNTS``; the rung's lever is
    ``ops.set_default_impl``, set only here.  The materialize rung is the
    one place where plain code runs on CUDA tensors, and it is reached
    only through this ladder, counted each time (``FALLBACK_COUNTS``,
    ``ops.DISPATCH_COUNTS``, ``health()``).  A rung serves under a
    suffixed config name, so its decode graph (keyed by config) is
    captured under its own lever and a faulty rung's capture is never
    replayed by another; a rung the ladder leaves has its graphs dropped.
    Each rung ends with ``torch.cuda.synchronize`` so that an asynchronous
    fault surfaces in the rung that caused it.
  * **Per-request deadline**: ``deadline_s`` bounds the whole walk;
    expiry raises ``DeadlineExceeded``.

A real device fault inside a kernel (an illegal address, say) leaves the
CUDA context unusable: every later rung fails too, and the ladder ends in
``ServeRefused`` — it does not degrade, and it does not hang.  The ladder
recovers from launch failures, from errors raised before a launch and from
the injector's faults (``testing/faults.py``).

``ResilientEngine.scheduler()`` returns a continuous-batching
``scheduler.Engine`` whose every prefill and generate step walks the
ladder through its ``guard`` hook; when even the last rung fails for a
batched tick, the engine's quarantine bisects the slots.

``ResilientEngine(residency=...)`` serves under tiered expert residency:
the manager rides in every context this engine builds, so ``generate``,
the prefill, the scheduler and every rung share one cache (the unfused and
materialize rungs decode the fetched cache slots).  A fetch fault raises
``torch.AcceleratorError`` on the host and walks the same ladder.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import torch

from .._device import resolve_device
from ..core.integrity import (IntegrityError, check_invariants,
                              verify_serve_state)
from ..kernels import ops
from ..sharding.partition import place_params
from . import engine as _engine
from .context import ServeContext

# Event -> count.  'unfused' / 'materialize' tick when the ladder falls
# back onto that rung; 'retry:<rung>' per in-rung retry; 'deadline' on
# expiry; 'refused' when the ladder is exhausted; 'integrity_refused' when
# the gate quarantines the artifact.  The scheduler ticks 'quarantine' per
# poisoned request refused out of a batch, 'preempt' per in-flight request
# evicted under page pressure, 'shed' per request shed by the bounded
# queue and 'expired' per TTL or deadline expiry, under the reference's
# names.  The memory-pressure governor (serve/governor.py) ticks
# 'pressure_trim' per expert-cache trim, 'pressure_kv_retire' per page
# retirement, 'pressure_preempt' per request evicted to shrink the pool,
# 'pressure_tighten' per admission tightening, 'pressure_refused' per
# submission refused at its last rung and 'pressure_regrow' per regrow.
FALLBACK_COUNTS: collections.Counter = collections.Counter()


class DeadlineExceeded(TimeoutError):
    """The per-request wall-clock budget expired mid retry/ladder walk."""


class ServeRefused(RuntimeError):
    """Serving a call was refused; carries the diagnostics, a list of
    (rung, attempt, repr(exception))."""

    def __init__(self, errors):
        self.errors = list(errors)
        super().__init__(
            "degradation ladder exhausted: "
            + "; ".join(f"{r}#{a}: {e}" for r, a, e in self.errors))


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    max_retries: int = 1                  # per rung, on AcceleratorError
    deadline_s: float = 0.0               # 0 = no per-request deadline
    ladder: tuple = ops.DEFAULT_LADDER
    verify: str = "off"                   # off | fast | full (boot gate)


def _generate(params, cfg, tokens, **kw):
    """Seam for fault injection and tests: ``engine.generate``."""
    return _engine.generate(params, cfg, tokens, **kw)


def _prefill(cfg, params, lut, batch, caches, device=None, residency=None,
             mesh=None):
    """Seam mirroring :func:`_generate` for the prefill."""
    prefill, _ = _engine.make_serve_fns(ctx=ServeContext(
        cfg=cfg, lut=lut, device=device, residency=residency, mesh=mesh))
    return prefill(params, lut, batch, caches)


class ResilientEngine:
    """Fault-covered front door over (ServeState, cfg) serving on
    ``device`` (the card unless the caller passes another).

    ``state`` is an ``engine.ServeState`` (or any object with ``params``,
    ``lut``, ``table`` and ``manifest``).  The integrity gate runs once at
    construction per ``policy.verify``; ``generate`` and ``prefill`` then
    walk the retry, deadline and ladder machinery per request.
    ``residency``: an optional ``serve.residency.ResidencyManager`` built
    on ``state``, shared by every call and rung.  ``mesh``: a
    ``launch.mesh.Mesh`` to serve on; ``state`` is then the whole artifact,
    which the integrity gate checks before each rank keeps its share
    (``sharding.partition.place_params``).  Tiered residency is
    single-device: a mesh beside it is refused, as in the reference."""

    def __init__(self, cfg, state, *, policy: ResiliencePolicy | None = None,
                 device=None, residency=None, mesh=None):
        if residency is not None and mesh is not None:
            raise ValueError("tiered residency is single-device — "
                             "mesh must be None")
        self.cfg = cfg
        self.state = state
        self.device = resolve_device(device)
        self.residency = residency
        self.mesh = mesh
        self.policy = policy or ResiliencePolicy()
        self.verify_report = None
        self.invariant_report = None
        self.requests = 0
        self.last_rung: Optional[str] = None
        self._history: list = []          # [(rung, attempt, repr(exc))]
        self._scheduler = None
        if self.policy.verify != "off":
            self._integrity_gate()
        if mesh is not None:
            self.state = dataclasses.replace(
                state, params=place_params(state.params, mesh))

    # -- integrity -----------------------------------------------------
    def _integrity_gate(self):
        """Host re-hash, then the device-side invariants, before any
        decode."""
        self.verify_report = verify_serve_state(self.state,
                                                level=self.policy.verify)
        if not self.verify_report.ok:
            FALLBACK_COUNTS["integrity_refused"] += 1
            raise IntegrityError(self.verify_report)
        self.invariant_report = check_invariants(self.state)
        if not self.invariant_report.ok:
            FALLBACK_COUNTS["integrity_refused"] += 1
            raise IntegrityError(self.invariant_report)

    # -- rung plumbing -------------------------------------------------
    def _rung_cfg(self, rung: str):
        """A fallback rung serves under a suffixed config name: graphs are
        kept by config, so the rung captures its own under its lever (also
        when a ladder starts below 'fused')."""
        if rung == ops.FUSED_RUNG:
            return self.cfg
        return dataclasses.replace(self.cfg, name=f"{self.cfg.name}+{rung}")

    def _run_rung(self, rung: str, fn):
        """``fn()`` with the lever pinned to ``rung`` ('fused' serves with
        it unset)."""
        prev = ops._DEFAULT_IMPL
        try:
            if rung != ops.FUSED_RUNG:
                ops.set_default_impl(rung)
            out = fn()
            if self.device.type == "cuda":    # surface faults in the rung
                torch.cuda.synchronize(self.device)
            return out
        finally:
            ops.set_default_impl(prev)

    def _deadline_check(self, t0: float, deadline: float):
        if deadline and time.monotonic() - t0 > deadline:
            FALLBACK_COUNTS["deadline"] += 1
            raise DeadlineExceeded(
                f"request exceeded {deadline:.3f}s "
                f"(elapsed {time.monotonic() - t0:.3f}s; "
                f"history {self._history[-4:]})")

    def _with_ladder(self, make_call, *, deadline_s: Optional[float]):
        """The retry/ladder walk shared by generate, prefill and the
        scheduler's guard.  ``make_call(rung)`` returns a zero-argument
        callable for that rung."""
        deadline = (self.policy.deadline_s if deadline_s is None
                    else deadline_s)
        t0 = time.monotonic()
        errors = []
        self.requests += 1
        for i, rung in enumerate(self.policy.ladder):
            if i > 0:
                FALLBACK_COUNTS[rung] += 1
            for attempt in range(self.policy.max_retries + 1):
                self._deadline_check(t0, deadline)
                if attempt > 0:
                    FALLBACK_COUNTS[f"retry:{rung}"] += 1
                try:
                    out = self._run_rung(rung, make_call(rung))
                    self.last_rung = rung
                    return out
                except torch.AcceleratorError as e:
                    rec = (rung, attempt, f"{type(e).__name__}: {e}"[:200])
                    errors.append(rec)
                    self._history.append(rec)
            _engine.drop_graphs(self._rung_cfg(rung))
        FALLBACK_COUNTS["refused"] += 1
        raise ServeRefused(errors)

    # -- public API ----------------------------------------------------
    def generate(self, tokens, *, max_new: int = 16,
                 temperature: float = 0.0,
                 generator: torch.Generator | None = None,
                 max_len: int | None = None,
                 deadline_s: float | None = None):
        """``engine.generate`` under the ladder."""
        def make_call(rung):
            cfg = self._rung_cfg(rung)
            ctx = self._context(cfg)
            return lambda: _generate(self.state.params, cfg, tokens,
                                     ctx=ctx, max_new=max_new,
                                     max_len=max_len,
                                     temperature=temperature,
                                     generator=generator)
        return self._with_ladder(make_call, deadline_s=deadline_s)

    def prefill(self, batch, caches, *, deadline_s: float | None = None):
        """The prefill of ``make_serve_fns`` under the ladder."""
        def make_call(rung):
            cfg = self._rung_cfg(rung)
            return lambda: _prefill(cfg, self.state.params, self.state.lut,
                                    batch, caches, device=self.device,
                                    residency=self.residency,
                                    mesh=self.mesh)
        return self._with_ladder(make_call, deadline_s=deadline_s)

    def _guard(self, call, kind: str):
        """The scheduler's guard hook: one engine call (``call(cfg)``,
        kind 'prefill' | 'decode' | 'replay') under the ladder, each rung
        with its suffixed config.  'replay' calls are the quarantine
        bisection's masked probes: they walk the same ladder, so a probe
        reports a subset faulty only when no rung can serve it."""
        return self._with_ladder(
            lambda rung: (lambda: call(self._rung_cfg(rung))),
            deadline_s=None)

    def scheduler(self, **engine_kw):
        """A continuous-batching ``scheduler.Engine`` whose every prefill
        and generate step walks this engine's ladder.  Keyword arguments
        (``n_slots``, ``max_len``, ``page_size``, ...) pass through; the
        engine is remembered so that :meth:`close` covers it."""
        from .scheduler import Engine
        self._scheduler = Engine(self._context(self.cfg), self.state.params,
                                 guard=self._guard, **engine_kw)
        return self._scheduler

    def _context(self, cfg) -> ServeContext:
        return ServeContext(cfg=cfg, lut=self.state.lut, device=self.device,
                            residency=self.residency, mesh=self.mesh)

    def close(self) -> None:
        """Drop the scheduler's graphs and stop the residency prefetch
        worker (idempotent)."""
        if self._scheduler is not None:
            self._scheduler.close()
        elif self.residency is not None:
            self.residency.close()

    def __enter__(self) -> "ResilientEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def health(self) -> dict:
        """Snapshot for operators and CI: the gate's reports, the probe
        counters, the last rung and the recent errors; under tiered
        residency the manager's snapshot, and with a governor its own."""
        out = {
            "requests": self.requests,
            "last_rung": self.last_rung,
            "fallbacks": dict(FALLBACK_COUNTS),
            "dispatch": dict(ops.DISPATCH_COUNTS),
            "verify": (self.verify_report.summary()
                       if self.verify_report else None),
            "invariants": (self.invariant_report.summary()
                           if self.invariant_report else None),
            "recent_errors": self._history[-8:],
        }
        if self.residency is not None:
            out["residency"] = self.residency.snapshot()
        sched = self._scheduler
        if sched is not None and sched.governor is not None:
            out["pressure"] = sched.governor.snapshot()
        return out
