"""Checkpoint/restart and fault tolerance of the port (``repro_torch.train
.checkpoint``, ``.fault``, ``testing.FaultInjector``'s checkpoint damage):
the reference's tests/test_checkpoint.py on the port, the damage walked
back past, and the on-disk layout against the reference's.

Comparisons are exact (restored bytes, steps, CRCs) except the resumed
run against an uninterrupted one, which is bitwise as well: the same
eager ops on the same CPU in the same order.
"""
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as JLM
from repro.train import checkpoint as jckpt
from repro.train.steps import TrainConfig as JTrainConfig
from repro.train.steps import init_train_state as jinit

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm as LM
from repro_torch.sharding import partition as PT
from repro_torch.testing import FaultInjector
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import tree as T
from repro_torch.train.data import DataConfig, DataPipeline
from repro_torch.train.fault import (FaultConfig, FaultTolerantLoop,
                                     PreemptionGuard, elastic_restore)
from repro_torch.train.steps import (TrainConfig, init_train_state,
                                     make_train_step)

torch.set_num_threads(2)


def _state():
    cfg = tget_config("llama3.2-1b").smoke
    tcfg = TrainConfig()
    return cfg, tcfg, init_train_state(LM.init_lm(cfg, seed=0,
                                                  device="cpu"), tcfg)


def _equal(a, b) -> bool:
    la, lb = T.leaves(a), T.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_save_restore_roundtrip(tmp_path):
    cfg, tcfg, state = _state()
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, state)
    assert ckpt.latest_step(d) == 7
    zeroed = T.map_leaves(torch.zeros_like, state)
    assert _equal(ckpt.restore(d, 7, zeroed), state)


def test_uncommitted_checkpoint_skipped(tmp_path):
    cfg, tcfg, state = _state()
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, state)
    ckpt.save(d, 9, state)
    os.remove(os.path.join(d, "step_00000009", ckpt.COMMIT))  # torn write
    assert ckpt.latest_step(d) == 3


def test_prune_keeps_newest(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, {"x": torch.zeros(2)})
    ckpt.prune_old(d, keep=2)
    assert sorted(int(p.split("_")[1]) for p in os.listdir(d)
                  if p.startswith("step_")) == [4, 5]


def test_restore_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError):
        ckpt.restore(d, 1, {"x": torch.zeros(5)})


def _loop_setup():
    cfg, tcfg, state0 = _state()
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=4,
                                   seq_len=8, seed=5))
    return cfg, state0, data, make_train_step(cfg, tcfg)


def test_fault_loop_resume(tmp_path):
    """Stop after 4 steps (commits at 2 and 4); a fresh loop resumes at 4
    and ends at 6 on the uninterrupted run's state, bit for bit."""
    cfg, state0, data, step = _loop_setup()
    ref = state0
    for i in range(6):
        ref, _ = step(ref, data.batch_at(i))
    fcfg = FaultConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                       handle_sigterm=False)
    FaultTolerantLoop(step, state0, data, fcfg).run(4)
    loop2 = FaultTolerantLoop(step, state0, data, fcfg)
    assert loop2.maybe_resume() == 4
    assert _equal(loop2.run(6), ref)


def test_elastic_restore_onto_one_device_and_refuses_a_mesh(tmp_path):
    cfg, tcfg, state = _state()
    d = str(tmp_path / "ck")
    ckpt.save(d, 11, state)
    restored, at = elastic_restore(d, state, device="cpu")
    assert at == 11 and _equal(restored, state)
    # onto a mesh (here the one-device host mesh: every spec replicates)
    # through the specs make_shardings gives for it; a mesh without them
    # is refused (tests/test_torch_mesh_train.py restores onto ranks)
    restored, at = elastic_restore(d, state, make_host_mesh(),
                                   PT.make_train_state_specs)
    assert at == 11 and _equal(restored, state)
    with pytest.raises(ValueError, match="make_shardings"):
        elastic_restore(d, state, new_mesh=(2, 2))


def test_fault_loop_straggler_flag(tmp_path):
    cfg, state0, data, step = _loop_setup()
    seen = []
    fcfg = FaultConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=100,
                       step_timeout_s=1e-9, handle_sigterm=False)
    FaultTolerantLoop(step, state0, data, fcfg,
                      on_metrics=lambda s, m: seen.append(m)).run(2)
    assert any(m.get("straggler") for m in seen)


def test_preemption_guard_flags_sigterm_and_sigint():
    before = {s: signal.getsignal(s) for s in PreemptionGuard.SIGNALS}
    guard = PreemptionGuard()
    try:
        assert not guard.fired
        signal.raise_signal(signal.SIGTERM)
        assert guard.fired
        guard.fired = False
        signal.raise_signal(signal.SIGINT)   # no KeyboardInterrupt
        assert guard.fired
    finally:
        guard.restore()
    for s in PreemptionGuard.SIGNALS:
        assert signal.getsignal(s) is before[s]


def test_preemption_guard_triggers_checkpoint(tmp_path):
    """A signal mid-run: the loop commits and stops at the next step
    boundary."""
    cfg, state0, data, step = _loop_setup()
    d = str(tmp_path / "ck")
    loop = FaultTolerantLoop(step, state0, data,
                             FaultConfig(ckpt_dir=d, ckpt_every=100))
    fired_at = []

    def on_metrics(s, m):
        if s == 2 and not fired_at:
            fired_at.append(s)
            signal.raise_signal(signal.SIGINT)

    loop.on_metrics = on_metrics
    try:
        loop.run(10)
    finally:
        loop.guard.restore()
    assert fired_at == [2] and ckpt.latest_step(d) == 2


# -- the injector's damage, walked back past --------------------------------

@pytest.mark.parametrize("damage", ["uncommit", "truncate", "corrupt"])
def test_damaged_newest_step_walks_back(tmp_path, damage):
    """Steps 2 and 4 saved; step 4 damaged by the injector.  An
    uncommitted step is not a candidate; a truncated or bit-rotted one
    raises ``CheckpointCorruptError`` (bit rot naming the leaf whose
    checksum fails) and ``restore_latest`` restores step 2, reporting
    the skip."""
    cfg, tcfg, state = _state()
    d = str(tmp_path / "ck")
    other = T.map_leaves(lambda t: t + 1 if t.is_floating_point() else t,
                         state)
    ckpt.save(d, 2, state)
    ckpt.save(d, 4, other)
    inj = FaultInjector(seed=0)
    getattr(inj, f"{damage}_step")(d, 4)
    like = T.map_leaves(torch.zeros_like, state)
    if damage == "uncommit":
        assert ckpt.latest_step(d) == 2
    else:
        with pytest.raises(ckpt.CheckpointCorruptError) as err:
            ckpt.restore(d, 4, like)
        if damage == "corrupt":
            names = [n for n, _ in T.flatten(state)]
            assert any(n in str(err.value) for n in names), err.value
    skipped = []
    restored, at = ckpt.restore_latest(
        d, like, on_skip=lambda s, e: skipped.append(s))
    assert at == 2 and _equal(restored, state)
    assert skipped == ([] if damage == "uncommit" else [4])


def test_no_loadable_step_raises(tmp_path):
    cfg, tcfg, state = _state()
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, state)
    FaultInjector(seed=1).truncate_step(d, 1)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_latest(d, state)
    loop = FaultTolerantLoop(lambda s, b: (s, {"loss": 0.0}), state, None,
                             FaultConfig(ckpt_dir=d, handle_sigterm=False))
    assert loop.maybe_resume() == 0          # a cold start


def test_layout_matches_the_reference(tmp_path):
    """The same state saved by both packages: the same files and
    manifest fields; leaves the two trees share by name (no layer axis)
    have the same shape, dtype and CRC32; a blocks leaf's layers in the
    port are the rows of the reference's stacked leaf, byte for byte."""
    cfg = get_config("llama3.2-1b").smoke
    tcfg = tget_config("llama3.2-1b").smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    jstate = jinit(params, JTrainConfig())
    tstate = init_train_state(convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu"),
        TrainConfig())
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save(jd, 3, jstate)
    ckpt.save(td, 3, tstate)
    jdir, tdir = os.path.join(jd, "step_00000003"), os.path.join(
        td, "step_00000003")
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == [
        "COMMIT", "manifest.json", "shard_00000.npz"]
    jm = json.load(open(os.path.join(jdir, "manifest.json")))
    tm = json.load(open(os.path.join(tdir, "manifest.json")))
    assert set(jm) == set(tm) and jm["step"] == tm["step"] == 3
    jleaf = {n: (s, d, c) for n, s, d, c in zip(jm["names"], jm["shapes"],
                                                jm["dtypes"], jm["crc32"])}
    tleaf = {n: (s, d, c) for n, s, d, c in zip(tm["names"], tm["shapes"],
                                                tm["dtypes"], tm["crc32"])}
    shared = [n for n in tleaf if n in jleaf]
    assert "['params']['embed']" in shared and "['opt']['step']" in shared
    for n in shared:
        assert tleaf[n] == jleaf[n], n
    with np.load(os.path.join(jdir, "shard_00000.npz")) as jz, \
            np.load(os.path.join(tdir, "shard_00000.npz")) as tz:
        stacked = jz["['params']['blocks']['attn']['wq']"]
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(
                tz[f"['params']['blocks'][{i}]['attn']['wq']"], stacked[i])
