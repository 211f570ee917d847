"""Fault tolerance — the checkpoint/restart loop, preemption, the straggler
flag, and restore after a failure.

Counterpart of ``repro/train/fault.py``:

  * ``FaultTolerantLoop``: periodic and on-signal atomic checkpoints,
    resume from the newest committed step that loads, bounded retry of a
    step that fails with a device fault (``torch.AcceleratorError``).
  * ``PreemptionGuard``: SIGTERM (a scheduler's preemption) and SIGINT
    (an operator's ^C) set a flag; the loop checkpoints at the next step
    boundary and stops.
  * Stragglers: with ``step_timeout_s`` a step that takes longer is
    flagged in its metrics (``straggler``, ``step_time_s``) for the
    launcher to act on; nothing in the step changes (that would change
    the numbers).
  * ``elastic_restore`` restores the newest checkpoint onto another mesh
    (the specs ``make_shardings`` gives for it), or onto one device.

On a mesh of ranks (``state_shardings`` and ``mesh``: the state is this
rank's shards) every control decision is collective: at each step
boundary the guard's flag is OR-ed over the ranks (``Mesh.agree``), so a
signal that reaches one rank stops all of them at the same committed
step, and a step that failed on any rank is retried on all.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable, Optional

import torch

from ..sharding import partition as PT
from . import checkpoint as ckpt
from . import tree as T


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    keep: int = 3
    max_step_retries: int = 2
    step_timeout_s: float = 0.0      # 0 = disabled
    handle_sigterm: bool = True      # preemption checkpoint


class PreemptionGuard:
    """Flags SIGTERM/SIGINT so the loop checkpoints before exiting;
    ``restore()`` puts back the handlers that were there before."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, enable: bool = True):
        self.fired = False
        self._prev = {}
        if enable:
            for sig in self.SIGNALS:
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:
                    pass  # not the main thread

    def _handler(self, signum, frame):
        self.fired = True

    def restore(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev = {}


def _block(t):
    """Wait for a step's work so that its failure raises here."""
    if torch.is_tensor(t) and t.is_cuda:
        torch.cuda.synchronize(t.device)


class FaultTolerantLoop:
    def __init__(self, train_step: Callable, state: Any, data,
                 fcfg: FaultConfig, *, state_shardings: Any = None,
                 mesh=None, on_metrics: Optional[Callable] = None):
        self.train_step = train_step
        self.state = state
        self.data = data
        self.fcfg = fcfg
        self.state_shardings = state_shardings
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.on_metrics = on_metrics
        self.guard = PreemptionGuard(fcfg.handle_sigterm)
        self.start_step = 0

    def _agree(self, flag: bool) -> bool:
        return self.mesh.agree(flag) if self.mesh is not None else flag

    def maybe_resume(self) -> int:
        """Restore the newest loadable committed checkpoint, if any (a
        damaged newest step falls back to the one before), onto the
        devices of the state's leaves (on a mesh: this rank's shards);
        → the step to start from (0: a cold start)."""
        try:
            self.state, self.start_step = ckpt.restore_latest(
                self.fcfg.ckpt_dir, self.state,
                shardings=self.state_shardings, mesh=self.mesh)
        except FileNotFoundError:
            pass
        return self.start_step

    def _checkpoint(self, step: int):
        ckpt.save(self.fcfg.ckpt_dir, step, self.state,
                  specs=self.state_shardings, mesh=self.mesh)
        if self.mesh is None or self.mesh.rank == 0:
            ckpt.prune_old(self.fcfg.ckpt_dir, self.fcfg.keep)

    def run(self, num_steps: int) -> Any:
        step = self.start_step
        while step < num_steps:
            batch = self.data.batch_at(step)
            t0 = time.monotonic()
            for attempt in range(self.fcfg.max_step_retries + 1):
                try:
                    new_state, metrics = self.train_step(self.state, batch)
                    _block(metrics["loss"])
                    failed = None
                except torch.AcceleratorError as e:
                    failed = e
                if not self._agree(failed is not None):
                    self.state = new_state
                    break
                if attempt == self.fcfg.max_step_retries:
                    # persistent: keep what we have, let the launcher
                    # restart
                    self._checkpoint(step)
                    raise failed or torch.AcceleratorError(
                        f"step {step} failed on another rank")
            dt = time.monotonic() - t0
            if self.fcfg.step_timeout_s and dt > self.fcfg.step_timeout_s:
                metrics = {**metrics, "straggler": True, "step_time_s": dt}
            step += 1
            if self.on_metrics:
                self.on_metrics(step, metrics)
            stop = self._agree(self.guard.fired)
            if step % self.fcfg.ckpt_every == 0 or stop:
                self._checkpoint(step)
                if stop:
                    break
        self._checkpoint(step)      # so that a restart is seamless
        return self.state


def elastic_restore(ckpt_dir: str, like_state: Any, new_mesh=None,
                    make_shardings: Callable | None = None, *, device=None):
    """Restore the newest committed checkpoint → (state, step).  With
    ``new_mesh`` (of any shape: the checkpoint holds whole leaves) and
    ``make_shardings(state, mesh)`` → a spec tree
    (``sharding.partition.make_train_state_specs``), each rank gets its
    shards of ``like_state`` (the whole state's structure) under those
    specs; without, the whole state on ``device``, else on the devices of
    ``like_state``'s leaves."""
    last = ckpt.latest_step(ckpt_dir)
    if last is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    if new_mesh is None:
        return ckpt.restore(ckpt_dir, last, like_state, device=device), last
    if make_shardings is None:
        raise ValueError("elastic_restore onto a mesh takes make_shardings "
                         "(sharding.partition.make_train_state_specs)")
    specs = make_shardings(like_state, new_mesh)
    if device is None:
        device = T.leaves(like_state)[0].device
    like = T.unflatten(like_state, [
        torch.empty(PT.shard_shape(x.shape, s, new_mesh), dtype=x.dtype,
                    device="meta")
        for x, s in zip(T.leaves(like_state),
                        PT.flat_specs(specs, like_state))])
    return ckpt.restore(ckpt_dir, last, like, device=device, shardings=specs,
                        mesh=new_mesh), last
