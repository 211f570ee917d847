"""Memory-pressure governor — runtime budget adaptation for serving.

Counterpart of ``repro/serve/governor.py`` for one device.  The
deployment regime is a 4–8 GB unified-memory edge device: the model shares
memory with the OS and other apps, so the device budget
``core/policy.py::DeviceBudget`` splits at boot is not a constant.
``MemoryGovernor`` drives the elastic resources when the budget moves.

Reclaim ladder (the budget fell; applied at the next step fence, where no
step is in flight):

  1. **Trim the expert cache**: pause residency prefetch and shrink
     ``ResidencyManager.capacity`` toward one expert per layer.
  2. **Shrink the KV pool**: retire free pages (highest ids first, so a
     contiguous tail is released from the device and the engine's tick
     is captured anew); if the free list cannot cover the shortfall,
     preempt the lowest-priority in-flight request
     (``Engine.preempt_lowest``) and retire its pages.  Victims resume
     bitwise-equal by re-prefill.  Floor: one slot's pages.
  3. **Tighten admission**: cap ``max_queue`` at the slots the shrunken
     pool can back; the overflow sheds through the bounded queue.
  4. **Refuse new work**: below ``min_viable`` new submissions complete
     as ``finished='pressure'``; queued and in-flight work still drains.

The regrow ladder is the same plan in reverse (admission loosens, pages
restore, capacity regrows, prefetch resumes), gated by **hysteresis**:
the surplus must exceed the applied budget by ``hysteresis`` (or reach
the boot budget) and hold for ``cooldown_steps`` steps.  The budget→plan
map is quantized to integers (capacity, usable pages, admission bound),
so a signal oscillating inside one band changes no plan, and the tick's
captures are bounded by the plan changes the trace sustains.  Survivors
stay bitwise equal to an unpressured run: pressure moves where KV lives
and when requests run, never what they compute.

Pressure sources, in order each ``on_step``: ``_os_pressure()`` (a seam,
``None`` unless ``testing.faults.FaultInjector.memory_pressure`` patches
it to replay a trace; the port reads no OS or CUDA memory signal), the
``poll`` callback given to the constructor, and ``set_budget`` calls.
"""
from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional

from ..core.policy import DeviceBudget
from .resilience import FALLBACK_COUNTS


def _os_pressure() -> Optional[int]:
    """Pressure seam: the current total budget in bytes, or None for no
    signal.  ``FaultInjector.memory_pressure`` patches this to replay a
    seeded trace."""
    return None


class Plan(NamedTuple):
    """One integer-quantized resource split.  ``capacity`` is experts
    per layer in the residency cache (None = no tiered residency);
    ``pages`` is usable KV pages in circulation; ``max_queue`` the
    admission bound (None = engine boot value / unbounded); ``refusing``
    flips rung 4."""
    capacity: Optional[int]
    pages: int
    max_queue: Optional[int]
    refusing: bool


class MemoryGovernor:
    """Walks the reclaim/regrow ladder when the device budget moves.

    budget: the boot ``DeviceBudget``.  poll: optional zero-arg callable
    returning the current budget in bytes (or None).  hysteresis:
    fractional surplus required before regrowing.  cooldown_steps:
    consecutive steps the surplus must hold.  min_budget_bytes: operator
    floor — below ``max(min_viable, min_budget_bytes)`` the governor
    refuses new work instead of reclaiming further.

    Attach via ``Engine(..., governor=gov)``; the engine calls
    ``on_step`` at the top of every tick (the fence where no step is in
    flight, so the cache stacks and the page tensors may be rebuilt).
    """

    def __init__(self, budget: DeviceBudget, *,
                 poll: Optional[Callable[[], Optional[int]]] = None,
                 hysteresis: float = 0.1, cooldown_steps: int = 4,
                 min_budget_bytes: Optional[int] = None):
        self.budget = budget              # current (re-split) view
        self.boot_bytes = int(budget.budget_bytes)
        self.poll = poll
        self.hysteresis = float(hysteresis)
        self.cooldown_steps = int(cooldown_steps)
        self.min_budget_bytes = min_budget_bytes
        self.target_bytes = int(budget.budget_bytes)
        self.applied_bytes = int(budget.budget_bytes)
        self.refusing = False
        self.engine = None
        self.events: List[dict] = []      # bounded: last _MAX_EVENTS
        self.rung_latency: dict = {}      # rung -> last apply seconds
        self.plan_changes = 0
        self._grow_streak = 0

    _MAX_EVENTS = 256

    # -- wiring --------------------------------------------------------
    def attach(self, engine) -> None:
        """Called by ``Engine.__init__``; captures the boot envelope the
        regrow ladder restores toward."""
        self.engine = engine
        pool = engine.pool
        self._pages_per_slot = pool.pages_per_slot
        self._page_nbytes = pool.page_nbytes()
        self._boot_pages = pool.n_pages
        self._boot_kv_bytes = self._boot_pages * self._page_nbytes
        self._boot_max_queue = engine.max_queue
        mgr = getattr(engine.ctx, "residency", None)
        self._mgr = mgr
        if mgr is not None:
            self._boot_capacity = mgr.capacity
            self._unit = mgr.n_layers * mgr.bytes_per_expert
        else:
            self._boot_capacity = None
            self._unit = 0
        kv_floor = self._pages_per_slot * self._page_nbytes
        self.refuse_below = max(
            self.budget.min_viable(kv_floor_bytes=kv_floor,
                                   expert_floor_bytes=self._unit),
            self.min_budget_bytes or 0)
        self.applied_plan = self._plan(self.applied_bytes)

    def set_budget(self, budget_bytes: int) -> None:
        """Record a new total budget; applied at the next step fence."""
        self.target_bytes = max(0, int(budget_bytes))

    # -- plan ----------------------------------------------------------
    def _plan(self, budget_bytes: int) -> Plan:
        """Map a budget to an integer resource split (monotone in the
        budget, so any single move shrinks-or-grows every dimension the
        same way).  Experts absorb the deficit first — they are the
        cheapest to restore (a refetch from host RAM) — then KV pages,
        then admission, then refusal."""
        b = max(0, int(budget_bytes))
        avail = b - self.budget.resident_bytes - self.budget.act_bytes
        cap = self._boot_capacity
        exp_bytes = 0
        if self._unit > 0:
            cap = (avail - self._boot_kv_bytes) // self._unit
            cap = max(1, min(int(cap), self._boot_capacity))
            exp_bytes = cap * self._unit
        pages = self._boot_pages
        if self._page_nbytes > 0:
            pages = (avail - exp_bytes) // self._page_nbytes
            pages = max(self._pages_per_slot,
                        min(int(pages), self._boot_pages))
        slots_backed = pages // self._pages_per_slot
        max_queue = self._boot_max_queue
        if slots_backed < self.engine.pool.n_slots:
            bound = max(1, slots_backed)
            max_queue = (bound if max_queue is None
                         else min(max_queue, bound))
        return Plan(capacity=cap, pages=pages, max_queue=max_queue,
                    refusing=b < self.refuse_below)

    @staticmethod
    def _shrinks(new: Plan, old: Plan) -> bool:
        inf = float("inf")
        return ((new.capacity or 0) < (old.capacity or 0)
                or new.pages < old.pages
                or (inf if new.max_queue is None else new.max_queue)
                < (inf if old.max_queue is None else old.max_queue)
                or (new.refusing and not old.refusing))

    # -- the ladder ----------------------------------------------------
    def on_step(self, engine) -> None:
        """Step-fence hook: read the pressure signal, re-plan, and apply
        a reclaim at once or a regrow behind hysteresis."""
        sig = _os_pressure()
        if sig is None and self.poll is not None:
            sig = self.poll()
        if sig is not None:
            self.set_budget(sig)
        target = self._plan(self.target_bytes)
        if target == self.applied_plan:
            self._grow_streak = 0
            self.applied_bytes = min(self.applied_bytes, self.target_bytes)
            return
        if self._shrinks(target, self.applied_plan):
            self._apply(target, regrow=False)
            return
        # regrow: demand a sustained, hysteresis-sized surplus (or full
        # recovery to the boot budget) so band-oscillation never thrashes
        floor = self.applied_bytes * (1.0 + self.hysteresis)
        if (self.target_bytes >= floor
                or self.target_bytes >= self.boot_bytes):
            self._grow_streak += 1
        else:
            self._grow_streak = 0
            return
        if self._grow_streak >= self.cooldown_steps:
            self._apply(target, regrow=True)
            self._grow_streak = 0

    def _apply(self, plan: Plan, *, regrow: bool) -> None:
        engine = self.engine
        old = self.applied_plan
        if regrow:
            FALLBACK_COUNTS["pressure_regrow"] += 1
        # rung 3/4 first on regrow, last on reclaim — but both are pure
        # host state, so ordering only matters for the elastic tiers:
        # reclaim trims experts before KV, regrow restores KV before
        # experts (experts are the cheapest to give and the last to get
        # back; KV directly gates in-flight progress).
        if plan.refusing != old.refusing:
            self.refusing = plan.refusing
        if plan.max_queue != old.max_queue:
            engine.max_queue = (plan.max_queue if plan.max_queue is not None
                                else self._boot_max_queue)
            if not regrow:
                FALLBACK_COUNTS["pressure_tighten"] += 1
                self._event("tighten", f"max_queue={plan.max_queue}", 0.0)
        tiers = ("kv", "experts") if regrow else ("experts", "kv")
        for tier in tiers:
            if tier == "experts":
                self._apply_experts(plan, old, regrow)
            else:
                self._apply_kv(plan, old, regrow)
        # prefetch rides the pressure state: paused under any trim,
        # resumed only at full recovery (mid-band prefetch would fight
        # the next reclaim for cache slots)
        if self._mgr is not None:
            if plan == self._plan(self.boot_bytes) \
                    and plan.capacity == self._boot_capacity:
                self._mgr.resume_prefetch()
            else:
                self._mgr.pause_prefetch()
        self.applied_plan = plan
        self.applied_bytes = self.target_bytes
        self.plan_changes += 1
        self.budget = self.budget.resplit(
            self.target_bytes, kv_bytes=plan.pages * self._page_nbytes)

    def _apply_experts(self, plan: Plan, old: Plan, regrow: bool) -> None:
        if self._mgr is None or plan.capacity == old.capacity:
            return
        t0 = time.perf_counter()
        if not regrow:
            self._mgr.pause_prefetch()
        self._mgr.set_capacity(plan.capacity)
        dt = time.perf_counter() - t0
        rung = "regrow_experts" if regrow else "trim_experts"
        if not regrow:
            FALLBACK_COUNTS["pressure_trim"] += 1
        self.rung_latency[rung] = dt
        self._event(rung, f"capacity {old.capacity}->{plan.capacity}", dt)

    def _apply_kv(self, plan: Plan, old: Plan, regrow: bool) -> None:
        pool = self.engine.pool
        if plan.pages == old.pages:
            return
        t0 = time.perf_counter()
        if plan.pages > pool.n_pages_usable:
            pool.restore_pages(plan.pages - pool.n_pages_usable)
            rung = "regrow_kv"
        else:
            rung = "retire_kv"
            FALLBACK_COUNTS["pressure_kv_retire"] += 1
            # free pages first; if the free list cannot cover the
            # shortfall, preempt the lowest-priority tenant (its pages
            # return to the free list) and retire again
            while pool.n_pages_usable > plan.pages:
                pool.retire_pages(pool.n_pages_usable - plan.pages)
                if pool.n_pages_usable <= plan.pages:
                    break
                if not self.engine.preempt_lowest():
                    break                 # nothing left to evict
        dt = time.perf_counter() - t0
        self.rung_latency[rung] = dt
        self._event(rung, f"pages {old.pages}->{pool.n_pages_usable}", dt)

    # -- observability -------------------------------------------------
    def _event(self, rung: str, detail: str, dt: float) -> None:
        self.events.append({"step": getattr(self.engine, "steps", -1),
                            "rung": rung, "detail": detail,
                            "seconds": dt})
        del self.events[:-self._MAX_EVENTS]

    def snapshot(self) -> dict:
        """For ``health()['pressure']`` — the applied plan, signal state,
        per-rung reclaim latency, and the event tail."""
        plan = getattr(self, "applied_plan", None)
        pool = self.engine.pool if self.engine is not None else None
        return {
            "target_bytes": self.target_bytes,
            "applied_bytes": self.applied_bytes,
            "boot_bytes": self.boot_bytes,
            "refusing": self.refusing,
            "refuse_below": getattr(self, "refuse_below", None),
            "plan": (plan._asdict() if plan is not None else None),
            "plan_changes": self.plan_changes,
            "grow_streak": self._grow_streak,
            "rung_latency_s": dict(self.rung_latency),
            "kv_device_bytes": (pool.device_bytes()
                                if pool is not None else None),
            "kv_pages_usable": (pool.n_pages_usable
                                if pool is not None else None),
            "events": self.events[-8:],
        }
