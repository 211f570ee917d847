"""Fault injection — makes every resilience path provable in tests.

Counterpart of ``repro/testing/faults.py`` for the port:

  * **Artifact corruption**: ``flip_bit`` / ``flip_lut_bit`` flip a seeded
    bit inside a named plane (codes, literals, nlit, scale, zero) or the
    model-wide LUT of a ``ServeState``; ``verify_serve_state`` must name
    the leaf.  The bit is drawn over the reference's leaf (a stacked leaf:
    all its layers' bytes), so one seed flips the same bit in both
    packages.
  * **Runtime errors**: ``failing(fn, times)`` wraps a callable to raise
    ``torch.AcceleratorError`` on its first calls (a transient fault at a
    request seam).  ``decode_fault(nth)`` raises on the nth execution of
    a fused compressed matmul (``ops.decode_dequant_matmul`` at the fused
    rung), counted as ``ops.DISPATCH_COUNTS`` counts it: a call at an
    eager step, and every call of a captured step at each replay.  In an
    eager step the error is raised in the call; a replay in which the nth
    execution falls is refused on the host before it is launched.  So
    ``FaultProbe.executions`` reads the same on the CPU and on the card
    for the same run, and an ``nth`` calibrated on one fires at the same
    step on the other.  Calls made while the lever pins 'unfused' or
    'materialize' are neither counted nor failed: the fused path is
    broken, the fallback rungs are not.
  * **Scheduler faults**: ``slot_fault(slot, nth)``, a poisoned request:
    the scheduler's generate step (``serve.scheduler._generate_step``)
    raises whenever the target slot is active, on every rung, so only the
    quarantine bisection can isolate it.  ``alloc_failure(times)``: page
    pool exhaustion at ``PagedKVPool.can_alloc`` or ``alloc``.

  * **Memory pressure**: ``pressure_trace(kind, ...)`` builds a seeded
    per-step budget trace (step, spike, ramp, oscillate), the same arrays
    as the reference's for the same seed, and ``memory_pressure(trace)``
    replays it through the ``serve.governor._os_pressure`` seam.
  * **Residency faults**: ``fetch_fault(times, delay_s)`` breaks (raises
    ``torch.AcceleratorError``) or slows ``serve.residency._transfer``,
    the host-to-device seam of every expert fetch and prefetch.

  * **Checkpoint damage** (``train/checkpoint.py``'s layout):
    ``uncommit_step`` (a torn write: no COMMIT), ``truncate_step`` (every
    shard cut short: an unreadable archive) and ``corrupt_step`` (seeded
    bit rot inside a shard's payload: only the checksums catch it).

Seeded from ``REPRO_FAULT_SEED``, as the reference's injector is.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.compressed import PackedLinear, QuantLinear, TiledPackedLinear
from ..core.integrity import leaf_groups, plane_keys
from ..serve.engine import _copy_tree


def _default_seed() -> int:
    return int(os.environ.get("REPRO_FAULT_SEED", "0"))


PRESSURE_KINDS = ("step", "spike", "ramp", "oscillate")


def pressure_trace(kind: str, *, boot_bytes: int, low_bytes: int,
                   n_steps: int, period: int = 8,
                   seed: Optional[int] = None) -> list:
    """A seeded per-step device-budget trace (bytes), one value per engine
    step, the reference's arrays for the same arguments:

      * 'step': the budget drops to ``low_bytes`` at a seeded step and
        stays there;
      * 'spike': a short seeded window at ``low_bytes``, then recovery;
      * 'ramp': linear descent to ``low_bytes`` over the first half,
        linear recovery over the second;
      * 'oscillate': a square wave between the two levels with period
        ``period`` and a seeded phase (hysteresis must keep the plan
        changes bounded by band crossings, not steps).

    Seeded from ``REPRO_FAULT_SEED`` by default."""
    if kind not in PRESSURE_KINDS:
        raise ValueError(f"kind must be one of {PRESSURE_KINDS}, "
                         f"got {kind!r}")
    rng = np.random.default_rng(_default_seed() if seed is None else seed)
    boot, low, n = int(boot_bytes), int(low_bytes), int(n_steps)
    t = np.arange(n)
    if kind == "step":
        at = int(rng.integers(1, max(2, n // 4)))
        vals = np.where(t < at, boot, low)
    elif kind == "spike":
        width = max(1, period // 2)
        at = int(rng.integers(1, max(2, n - width)))
        vals = np.where((t >= at) & (t < at + width), low, boot)
    elif kind == "ramp":
        half = max(1, n // 2)
        vals = np.concatenate([
            np.linspace(boot, low, half),
            np.linspace(low, boot, n - half)]).astype(np.int64)
    else:                                              # oscillate
        phase = int(rng.integers(max(1, period)))
        vals = np.where(((t + phase) // max(1, period)) % 2 == 0,
                        boot, low)
    return [int(v) for v in vals]


class FaultProbe:
    """Execution-count handle yielded by the injection context managers.

    ``executions`` is the number of guarded calls observed so far; tests
    use a never-firing probe (``nth`` huge) on a clean run to calibrate a
    fault at step N for a later faulty run of the same trace."""

    def __init__(self):
        self.counts = collections.Counter()

    @property
    def executions(self) -> int:
        return self.counts["executions"]


def _flipped(t: torch.Tensor, byte: int, bit: int) -> torch.Tensor:
    """A copy of ``t`` with bit ``bit`` of byte ``byte`` flipped."""
    out = t.clone().contiguous()
    raw = out.reshape(-1).view(torch.uint8)
    raw[byte:byte + 1].bitwise_xor_(1 << bit)
    return out


class FaultInjector:
    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(
            _default_seed() if seed is None else seed)

    def _draw(self, nbytes: int, bit: Optional[int]) -> int:
        if nbytes == 0:
            raise ValueError("cannot flip a bit in an empty plane")
        return int(self.rng.integers(nbytes * 8)) if bit is None else bit

    # -- artifact corruption -------------------------------------------
    def flip_bit(self, state, leaf_substr: str, plane: str = "codes",
                 bit: Optional[int] = None):
        """Return ``(copy of state, leaf name)`` with one bit flipped in
        the first plane (in the reference's flatten order) whose keyed
        path contains ``leaf_substr`` and ends in ``plane`` ('codes' |
        'literals' | 'nlit' | 'scale' | 'zero' | 'values', and a
        TiledPackedLinear's 'codes_t' | 'literals_t' | 'nlit_t').  The
        manifest is deliberately not rebuilt."""
        params = _copy_tree(state.params)
        for name, holders in leaf_groups(params):
            first = holders[0][0][holders[0][1]]
            if not isinstance(first, (PackedLinear, TiledPackedLinear,
                                      QuantLinear)):
                continue
            field = {v: k for k, v in plane_keys(first).items()}.get(plane,
                                                                     plane)
            full = f"{name}.{plane}"
            if (leaf_substr not in full
                    or plane_keys(first).get(field, field) != plane
                    or not isinstance(getattr(first, field, None),
                                      torch.Tensor)):
                continue
            parts = [getattr(h[k], field) for h, k in holders]
            sizes = [p.numel() * p.element_size() for p in parts]
            b = self._draw(sum(sizes), bit)
            byte, off = b // 8, 0
            for (h, k), size in zip(holders, sizes):
                if byte < off + size:
                    h[k] = dataclasses.replace(h[k], **{field: _flipped(
                        getattr(h[k], field), byte - off, b % 8)})
                    break
                off += size
            return dataclasses.replace(state, params=params), full
        raise KeyError(f"no leaf matching {leaf_substr!r} plane {plane!r} "
                       "in params")

    def flip_lut_bit(self, state, bit: Optional[int] = None):
        """Flip one bit in the model-wide decode LUT."""
        if state.lut is None:
            raise ValueError("state has no LUT")
        b = self._draw(state.lut.numel(), bit)
        return dataclasses.replace(state,
                                   lut=_flipped(state.lut, b // 8, b % 8))

    # -- runtime errors ------------------------------------------------
    # -- checkpoint damage ---------------------------------------------
    @staticmethod
    def _step_dir(ckpt_dir: str, step: int) -> str:
        return os.path.join(ckpt_dir, f"step_{step:08d}")

    def uncommit_step(self, ckpt_dir: str, step: int):
        """Torn write: the COMMIT marker never landed."""
        os.remove(os.path.join(self._step_dir(ckpt_dir, step), "COMMIT"))

    def truncate_step(self, ckpt_dir: str, step: int, keep_bytes: int = 64):
        """Chop every shard file to ``keep_bytes`` (unreadable archive)."""
        d = self._step_dir(ckpt_dir, step)
        for fn in os.listdir(d):
            if fn.startswith("shard_"):
                with open(os.path.join(d, fn), "r+b") as f:
                    f.truncate(keep_bytes)

    def corrupt_step(self, ckpt_dir: str, step: int, nbits: int = 8):
        """Post-commit bit rot inside the first shard's payload (a
        readable archive, wrong bytes): ``nbits`` seeded bits of its back
        half, past the archive's header."""
        d = self._step_dir(ckpt_dir, step)
        for fn in sorted(os.listdir(d)):
            if fn.startswith("shard_"):
                path = os.path.join(d, fn)
                with open(path, "rb") as f:
                    data = bytearray(f.read())
                lo = len(data) // 2
                for _ in range(nbits):
                    b = int(self.rng.integers(lo * 8, len(data) * 8))
                    data[b // 8] ^= 1 << (b % 8)
                with open(path, "wb") as f:
                    f.write(bytes(data))
                return

    def failing(self, fn: Callable, times: int = 1,
                message: str = "injected device fault") -> Callable:
        """Wrap ``fn`` to raise ``torch.AcceleratorError`` on its first
        ``times`` calls, then delegate: the transient-fault model at a
        call seam."""
        counter = itertools.count()

        def wrapped(*args: Any, **kw: Any):
            if next(counter) < times:
                raise torch.AcceleratorError(message)
            return fn(*args, **kw)

        return wrapped

    @contextlib.contextmanager
    def decode_fault(self, nth: int = 1, times: int = 1 << 30,
                     message: str = "injected decode fault"):
        """Fail executions [nth, nth + times) of the fused compressed
        matmul (see the module docstring).  Patches
        ``ops.decode_dequant_matmul``, and ``serve.engine.replay_step``
        with a check before each replay; the probe's counter joins the
        step counters (``serve.engine._STEP_COUNTERS``), so a step
        captured while armed adds its executions at each replay.  A step
        captured before the fault was armed carries no fault, as a
        reference trace cached before it does not."""
        from ..kernels import ops
        from ..serve import engine as _engine

        probe = FaultProbe()
        orig = ops.decode_dequant_matmul
        orig_replay = _engine.replay_step
        counters = _engine._STEP_COUNTERS
        slot = len(counters)
        last = nth + times - 1

        def fire(n):
            probe.counts["executions"] = n
            raise torch.AcceleratorError(f"{message} (execution {n})")

        def wrapped(x, packed, lut, **kw):
            if ops._DEFAULT_IMPL in (ops.Impl.UNFUSED.value,
                                     ops.Impl.MATERIALIZE.value):
                return orig(x, packed, lut, **kw)
            n = probe.executions + 1
            probe.counts["executions"] = n
            capturing = (x.device.type == "cuda"
                         and torch.cuda.is_current_stream_capturing())
            if nth <= n <= last and not capturing:
                fire(n)
            return orig(x, packed, lut, **kw)

        def replay(graph, counts):
            step = counts[slot]["executions"] if len(counts) > slot else 0
            first = max(probe.executions + 1, nth)
            if step and first <= min(probe.executions + step, last):
                fire(first)
            return orig_replay(graph, counts)

        ops.decode_dequant_matmul = wrapped
        _engine.replay_step = replay
        _engine._STEP_COUNTERS = counters + (probe.counts,)
        try:
            yield probe
        finally:
            ops.decode_dequant_matmul = orig
            _engine.replay_step = orig_replay
            _engine._STEP_COUNTERS = counters

    # -- memory pressure -----------------------------------------------
    @contextlib.contextmanager
    def memory_pressure(self, trace, *, hold_last: bool = True):
        """Replay a budget trace through ``serve.governor._os_pressure``.

        Each governor poll (one per engine step) takes the next value of
        ``trace`` (bytes); past the end the last value holds unless
        ``hold_last=False``, after which the seam reports no signal.
        Yields a :class:`FaultProbe` counting the polls served."""
        from ..serve import governor as _gov

        orig = _gov._os_pressure
        probe = FaultProbe()
        seq = [int(v) for v in trace]

        def patched():
            i = probe.executions
            probe.counts["executions"] += 1
            if i < len(seq):
                return seq[i]
            return seq[-1] if (hold_last and seq) else None

        _gov._os_pressure = patched
        try:
            yield probe
        finally:
            _gov._os_pressure = orig

    # -- residency faults ----------------------------------------------
    @contextlib.contextmanager
    def fetch_fault(self, times: int = 1, delay_s: float = 0.0,
                    message: str = "injected fetch fault"):
        """Break or slow the host-to-device expert transfer.

        Patches ``serve.residency._transfer``, the seam every demand fetch
        and prefetch crosses, to raise ``torch.AcceleratorError`` for its
        first ``times`` crossings (or, with ``delay_s`` > 0, to sleep and
        then copy: a saturated link, not a dead one).  A demand fetch's
        fault leaves ``ResidencyManager.run`` and walks the ladder; a
        prefetch's is counted as ``prefetch_error`` and becomes a later
        demand miss.  A persistent fault (``times`` huge) ends in refused
        requests, never a hang.  Yields a :class:`FaultProbe` counting the
        injected crossings."""
        from ..serve import residency as _res

        orig = _res._transfer
        counter = itertools.count()
        probe = FaultProbe()

        def wrapped(arrays, dst):
            n = next(counter)
            if n < times:
                probe.counts["executions"] += 1
                if delay_s > 0:
                    time.sleep(delay_s)
                    return orig(arrays, dst)
                raise torch.AcceleratorError(
                    f"{message} (transfer {n + 1} of {times})")
            return orig(arrays, dst)

        _res._transfer = wrapped
        try:
            yield probe
        finally:
            _res._transfer = orig

    # -- scheduler faults ----------------------------------------------
    @contextlib.contextmanager
    def slot_fault(self, slot: int, nth: int = 1, times: int = 1 << 30,
                   message: str = "injected poisoned-request fault"):
        """A poisoned request in decode slot ``slot``: the scheduler's
        generate step (``serve.scheduler._generate_step``) raises
        ``torch.AcceleratorError`` whenever the slot is active in the
        step's mask, from its ``nth`` such call for ``times`` calls, on
        every rung, before the step runs.  The bisection's masked probes
        cross the same seam: sub-batches without the slot run clean.
        Yields a :class:`FaultProbe` counting the slot's calls."""
        from ..serve import scheduler as _sched

        probe = FaultProbe()
        orig = _sched._generate_step

        def wrapped(engine, cfg, mask):
            if bool(mask[slot]):
                probe.counts["executions"] += 1
                n = probe.executions
                if nth <= n < nth + times:
                    raise torch.AcceleratorError(
                        f"{message} (slot {slot}, active call {n})")
            return orig(engine, cfg, mask)

        _sched._generate_step = wrapped
        try:
            yield probe
        finally:
            _sched._generate_step = orig

    @contextlib.contextmanager
    def alloc_failure(self, times: int = 1, seam: str = "can_alloc"):
        """Page-pool exhaustion for the next ``times`` admissions.
        seam='can_alloc': ``PagedKVPool.can_alloc`` reports False (the
        scheduler sees pressure before the prefill).  seam='alloc':
        ``alloc`` raises ``PoolExhausted`` (the post-prefill requeue
        path).  Yields a :class:`FaultProbe` counting the failures."""
        if seam not in ("can_alloc", "alloc"):
            raise ValueError(f"seam must be 'can_alloc' or 'alloc', "
                             f"got {seam!r}")
        from ..serve import kv_cache as _kv

        probe = FaultProbe()
        counter = itertools.count()
        orig = getattr(_kv.PagedKVPool, seam)

        if seam == "can_alloc":
            def fake(pool):
                if next(counter) < times:
                    probe.counts["executions"] += 1
                    return False
                return orig(pool)
        else:
            def fake(pool, slot):
                if next(counter) < times:
                    probe.counts["executions"] += 1
                    raise _kv.PoolExhausted(
                        f"injected alloc failure ({probe.executions} of "
                        f"{times})")
                return orig(pool, slot)

        setattr(_kv.PagedKVPool, seam, fake)
        try:
            yield probe
        finally:
            setattr(_kv.PagedKVPool, seam, orig)
