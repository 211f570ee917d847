"""Fault tolerance — the checkpoint/restart loop, preemption, the straggler
flag, and restore after a failure.

Counterpart of ``repro/train/fault.py`` on one device:

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
  * ``elastic_restore`` restores the newest checkpoint onto one device.
    Its other case, a different mesh of devices, waits for
    multi-device training (ROADMAP queue 1 item 3) and is refused.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable, Optional

import torch

from . import checkpoint as ckpt


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
                 fcfg: FaultConfig, *, on_metrics: Optional[Callable] = None):
        self.train_step = train_step
        self.state = state
        self.data = data
        self.fcfg = fcfg
        self.on_metrics = on_metrics
        self.guard = PreemptionGuard(fcfg.handle_sigterm)
        self.start_step = 0

    def maybe_resume(self) -> int:
        """Restore the newest loadable committed checkpoint, if any (a
        damaged newest step falls back to the one before), onto the
        devices of the state's leaves; → the step to start from (0: a
        cold start)."""
        try:
            self.state, self.start_step = ckpt.restore_latest(
                self.fcfg.ckpt_dir, self.state)
        except FileNotFoundError:
            pass
        return self.start_step

    def _checkpoint(self, step: int):
        ckpt.save(self.fcfg.ckpt_dir, step, self.state)
        ckpt.prune_old(self.fcfg.ckpt_dir, self.fcfg.keep)

    def run(self, num_steps: int) -> Any:
        step = self.start_step
        while step < num_steps:
            batch = self.data.batch_at(step)
            t0 = time.monotonic()
            for attempt in range(self.fcfg.max_step_retries + 1):
                try:
                    self.state, metrics = self.train_step(self.state, batch)
                    _block(metrics["loss"])
                    break
                except torch.AcceleratorError:
                    if attempt == self.fcfg.max_step_retries:
                        # persistent: keep what we have, let the launcher
                        # restart
                        self._checkpoint(step)
                        raise
            dt = time.monotonic() - t0
            if self.fcfg.step_timeout_s and dt > self.fcfg.step_timeout_s:
                metrics = {**metrics, "straggler": True, "step_time_s": dt}
            step += 1
            if self.on_metrics:
                self.on_metrics(step, metrics)
            if step % self.fcfg.ckpt_every == 0 or self.guard.fired:
                self._checkpoint(step)
                if self.guard.fired:
                    break
        self._checkpoint(step)      # so that a restart is seamless
        return self.state


def elastic_restore(ckpt_dir: str, like_state: Any, new_mesh=None,
                    make_shardings: Callable | None = None, *, device=None):
    """Restore the newest committed checkpoint onto one device (``device``,
    else the devices of ``like_state``'s leaves) → (state, step).  A mesh
    (``new_mesh``) is refused: restoring onto several devices waits for
    multi-device training (ROADMAP queue 1 item 3)."""
    if new_mesh is not None or make_shardings is not None:
        raise NotImplementedError(
            "elastic_restore onto a mesh is not ported: the port restores "
            "onto one device (multi-device training is ROADMAP queue 1 "
            "item 3)")
    last = ckpt.latest_step(ckpt_dir)
    if last is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return ckpt.restore(ckpt_dir, last, like_state, device=device), last
