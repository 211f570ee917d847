"""What each rank of ``tests/test_torch_mesh_train.py``'s meshes runs.

The ranks that ``repro_torch.launch.mesh.spawn`` starts import this module
by name, so it imports the port alone (no JAX): each rank joins the mesh,
shards the train states it is given (``make_train_state_specs``), runs
every case on its shards, and returns what the test compares in the
parent process with one process's and with the reference's: whole states
gathered from the shards, losses, gradients, the MoE's kept choices,
checkpoints, and the training loop's and launcher's runs."""
import os
import signal

import torch

from repro_torch.kernels import _build
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import partition as PT
from repro_torch.testing import routes as R
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import tree as T
from repro_torch.train.fault import (FaultConfig, FaultTolerantLoop,
                                     elastic_restore)
from repro_torch.train.optimizer import adamw_update
from repro_torch.train.steps import (compress_grads_int8, grads_of,
                                     loss_and_grads_on_mesh, make_train_step)


def _whole(mesh, shards, specs):
    return PT.gather_tree(shards, specs, mesh)


def _steps(mesh, cfg, tcfg, state, batches, with_grads=False):
    """The mesh's step over ``batches`` from the whole ``state``: → (every
    whole state, before and after each step; each step's metrics; with
    ``with_grads``, each step's whole gradients)."""
    specs = PT.make_train_state_specs(state, mesh)
    shards = PT.shard_tree(state, specs, mesh)
    step = make_train_step(cfg, tcfg, mesh=mesh, specs=specs)
    states, metrics, grads = [state], [], []
    for b in batches:
        if with_grads:
            grads.append(T.leaves(_whole(mesh, loss_and_grads_on_mesh(
                shards["params"], cfg, tcfg, b, mesh, specs["params"])[1],
                specs["params"])))
        shards, m = step(shards, b)
        states.append(_whole(mesh, shards, specs))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics, grads


def _grads_against_one(mesh, cfg, tcfg, state, batch):
    """The mesh's loss and whole gradients beside one process's on the
    same rows, computed in this process: → ((loss, grads), (one process's
    loss, grads))."""
    specs = PT.make_train_state_specs(state, mesh)
    shards = PT.shard_tree(state, specs, mesh)
    loss, grads = loss_and_grads_on_mesh(shards["params"], cfg, tcfg, batch,
                                         mesh, specs["params"])
    grads = _whole(mesh, grads, specs["params"])
    one_loss, one = grads_of(state["params"], cfg, tcfg, batch)
    return (float(loss), grads), (float(one_loss), one)


def _stepwise(mesh, cfg, tcfg, states, grads, batches):
    """From each given state (the reference's, step by step): the mesh's
    loss and whole gradients on the batch, and its compression and update
    on its shards given ``grads`` (the reference's gradients)."""
    out = []
    for state, g, b in zip(states, grads, batches):
        specs = PT.make_train_state_specs(state, mesh)
        shards = PT.shard_tree(state, specs, mesh)
        loss, mesh_grads = loss_and_grads_on_mesh(
            shards["params"], cfg, tcfg, b, mesh, specs["params"])
        mesh_grads = T.leaves(_whole(mesh, mesh_grads, specs["params"]))
        gs = PT.shard_tree(g, specs["params"], mesh)
        new = {}
        if "grad_error" in shards:
            gs, new["grad_error"] = compress_grads_int8(
                gs, shards["grad_error"], specs=specs["params"], mesh=mesh)
        new["params"], new["opt"], _ = adamw_update(
            shards["params"], gs, shards["opt"], tcfg.optimizer, specs=specs,
            mesh=mesh)
        out.append({"loss": float(loss), "grads": mesh_grads,
                    "state": _whole(mesh, new, specs)})
    return out


def _routes(mesh, cfg, tcfg, state, batch):
    """The kept (token, expert) choices of every MoE layer in the mesh
    step's forward on this rank's rows: [(expert ids, kept)] a layer."""
    specs = PT.make_train_state_specs(state, mesh)
    shards = PT.shard_tree(state, specs, mesh)
    with R.recording() as routes:
        loss_and_grads_on_mesh(shards["params"], cfg, tcfg, batch, mesh,
                               specs["params"])
    return routes


class _Data:
    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, i):
        return self.batches[i]


def _loop(mesh, cfg, tcfg, state, batches, root, *, stop_rank=None,
          stop_at=None, fail_rank=None, fail_at=None, steps=None,
          ckpt_every=100):
    """``FaultTolerantLoop`` on the mesh from ``state`` (whole), resumed
    from ``root`` where it holds a checkpoint; rank ``stop_rank`` raises
    SIGTERM after step ``stop_at``; rank ``fail_rank``'s step ``fail_at``
    raises ``torch.AcceleratorError`` at the end of its first attempt.
    → (losses by step, the step it started from, the whole state at the
    end, each step's calls)."""
    specs = PT.make_train_state_specs(state, mesh)
    step = make_train_step(cfg, tcfg, mesh=mesh, specs=specs)
    calls = {}

    def flaky(s, b):
        i = next(k for k, x in enumerate(batches) if x is b)
        calls[i] = calls.get(i, 0) + 1
        out = step(s, b)
        if mesh.rank == fail_rank and i == fail_at and calls[i] == 1:
            raise torch.AcceleratorError("injected device fault")
        return out

    losses = {}

    def on_metrics(s, m):
        losses[s] = float(m["loss"])
        if mesh.rank == stop_rank and s == stop_at:
            signal.raise_signal(signal.SIGTERM)

    loop = FaultTolerantLoop(
        flaky, PT.shard_tree(state, specs, mesh), _Data(batches),
        FaultConfig(ckpt_dir=root, ckpt_every=ckpt_every),
        state_shardings=specs, mesh=mesh, on_metrics=on_metrics)
    try:
        start = loop.maybe_resume()
        loop.run(len(batches) if steps is None else steps)
    finally:
        loop.guard.restore()
    return losses, start, _whole(mesh, loop.state, specs), calls


def run(rank: int, shape: tuple, cases: dict) -> dict:
    """``cases``: {kind: {key: inputs}} (``test_torch_mesh_train._cases``)."""
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"))
    out = {"coords": dict(mesh.coords)}
    for key, args in cases.get("steps", {}).items():
        out[key] = _steps(mesh, *args)
    for key, (cfg, tcfg, state, batch) in cases.get("grads", {}).items():
        out[key] = _grads_against_one(mesh, cfg, tcfg, state, batch)
    for key, args in cases.get("stepwise", {}).items():
        out[key] = _stepwise(mesh, *args)
    for key, (cfg, tcfg, state, batch) in cases.get("routes", {}).items():
        out[key] = _routes(mesh, cfg, tcfg, state, batch)
    for key, (cfg, tcfg, state, batches, root, kw) in cases.get(
            "loop", {}).items():
        out[key] = _loop(mesh, cfg, tcfg, state, batches, root, **kw)
    for key, (tcfg, state, root) in cases.get("save0", {}).items():
        specs = PT.make_train_state_specs(state, mesh)
        ckpt.save(root, 0, PT.shard_tree(state, specs, mesh), specs=specs,
                  mesh=mesh)
        out[key] = os.path.isdir(os.path.join(root, "step_00000000"))
    for key, (like, root, step) in cases.get("damaged", {}).items():
        specs = PT.make_train_state_specs(like, mesh)
        try:
            ckpt.restore(root, step, PT.shard_tree(like, specs, mesh),
                         shardings=specs, mesh=mesh)
            out[key] = None
        except ckpt.CheckpointCorruptError as e:
            out[key] = str(e)
    for key, (cfg, tcfg, like, batches, root) in cases.get(
            "elastic", {}).items():
        restored, at = elastic_restore(root, like, mesh,
                                       PT.make_train_state_specs)
        specs = PT.make_train_state_specs(like, mesh)
        step = make_train_step(cfg, tcfg, mesh=mesh, specs=specs)
        losses = []
        for b in batches[at:]:
            restored, m = step(restored, b)
            losses.append(float(m["loss"]))
        out[key] = (at, losses, _whole(mesh, restored, specs))
    for key, (argv, params, stop) in cases.get("launcher", {}).items():
        def on_metrics(s, m, stop=stop):
            if stop is not None and mesh.rank == stop[0] and s == stop[1]:
                signal.raise_signal(signal.SIGTERM)
        runs = [launch_train.main(argv, params=params, mesh=mesh,
                                  on_metrics=on_metrics)]
        if stop is not None:
            runs.append(launch_train.main(argv, params=params, mesh=mesh))
        out[key] = runs
    out["traffic"] = dict(mesh.traffic)
    out["launches"] = dict(_build.KERNEL_COUNTS)
    return out
