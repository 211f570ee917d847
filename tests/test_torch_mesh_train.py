"""Training on a device mesh: the port's ZeRO-3 train step on
``torch.distributed`` ranks against one process and against the JAX
package, on the CPU.

The reference trains on a mesh as one program: its jitted
``make_train_step`` under ``make_train_state_specs`` shardings computes
the single-device function.  The port's ranks each store a shard of the
train state, gather each block's leaves over the data axes where they are
used, compute their data rank's share of each microbatch tensor-parallel
over model and sum the gradients over the data axes; they are held to
that function:

  * Specs: ``make_train_state_specs`` against the reference's on every
    config's smoke state (f32 moments; int8 moments at ``qblock`` 256 and
    32; ``grad_error``) on the (2, 8), (16, 16) and (2, 16, 16) stand-in
    meshes, and on the port's own per-layer states.
  * Spawned gloo ranks (``launch.mesh.spawn``, one spawn per mesh shape:
    (2, 1), (2, 2), (1, 2)) running ``tests/torch_mesh_train_worker.py``
    (the port alone):
      - (1, 2): the loss and gradients within the step bounds of one
        process's (tensor-parallel over model: the row-parallel sums add
        in another order);
      - every mesh: each step's state and loss, from the same state,
        within STEP_PARAM_RTOL / STEP_LOSS_RTOL of one process's step
        (a tensor-parallel first step as :func:`hold_steps` says);
      - (2, 1) and (2, 2): 5 steps end to end within
        ``test_torch_train.py``'s bounds of the reference's jitted step
        (Llama smoke; DeepSeek smoke with ``accum_steps`` 2), and
        ``int8_ef`` and int8 moments step by step from the reference's
        state on (2, 2), as that file holds them;
      - DeepSeek's kept (token, expert) choices at capacity 1.25, in a
        batch that drops some, equal one process's, and its aux loss;
      - checkpoints: a step-0 checkpoint written from (2, 2) has one
        process's CRC32s; 2 steps on (2, 2), restored onto (1, 2) and
        into one process by ``elastic_restore``, continue within bound of
        an uninterrupted run;
      - the loop: SIGTERM on one rank stops every rank at the same
        committed step, a resume continues with the uninterrupted run's
        losses, a step that fails on one rank is retried on all;
      - the launcher: ``main(mesh=...)`` on (2, 2) trains, is stopped by
        one rank's SIGTERM and resumes, within bound of ``--mesh host``.
"""
import dataclasses
import functools
import json
import os
import shutil
import tempfile
import types

import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import all_archs as jall_archs
from repro.configs import get_config
from repro.models import encdec as JED
from repro.models import lm as JLM
from repro.sharding import partition as JPT
from repro.train import steps as JS
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import QMoment as JQMoment

from repro_torch.configs import get_config as tget_config
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as TLM
from repro_torch.sharding import partition as PT
from repro_torch.testing import routes as R
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import tree as T
from repro_torch.train.data import DataConfig, DataPipeline
from repro_torch.train.fault import elastic_restore
from repro_torch.train.optimizer import (AdamWConfig, QMoment, _mu_list,
                                         adamw_update)
from repro_torch.train.steps import (TrainConfig, compress_grads_int8,
                                     grads_of, init_train_state,
                                     make_train_step)

import torch_mesh_train_worker
from test_torch_mesh import STAND_IN, _ref_flat
from test_torch_train import (_configs, init_params, port_state, port_tree,
                              rel)

torch.set_num_threads(2)
LLAMA, DEEPSEEK = "llama3.2-1b", "deepseek-v2-lite-16b"
STEPS, BATCH, SEQ = 5, 4, 16
# One step from the same state, the mesh against one process (measured on
# this host: loss within 9e-8 relative; parameters, as one vector, within
# 1.7e-7; at most 4 elements of ~90k beyond 1e-6 absolute).  Gradients sum
# over the data ranks in another order (f32 roundoff, ~3e-8 absolute);
# AdamW sends an element by lr · m / (√v + eps), which for a gradient near
# eps (1e-8) turns that roundoff into up to lr, so the 1e-6 absolute bound
# holds for all but STEP_BEYOND_SHARE of the elements, and the whole
# vector within STEP_PARAM_RTOL.
STEP_LOSS_RTOL = 1e-5
STEP_PARAM_ATOL = 1e-6
STEP_PARAM_RTOL = 1e-6
STEP_BEYOND_SHARE = 1e-4
# against the reference, end to end and step by step: test_torch_train's
REF_RTOL, REF_MU_RTOL = 1e-5, 1e-4
# the launcher's losses on (2, 2) against --mesh host over its 6 steps
LAUNCH_RTOL = 1e-5
LAUNCH_ARGV = ["--device", "cpu", "--steps", "6", "--batch", "4", "--seq",
               "16", "--ckpt-every", "100"]


# -- specs -----------------------------------------------------------------

MOMENTS = {"f32": dict(quantized_state=False),
           "int8": dict(quantized_state=True, qblock=256),
           "int8_qblock32": dict(quantized_state=True, qblock=32)}


@functools.lru_cache(maxsize=None)
def _ref_state_shapes(arch, moments):
    cfg = get_config(arch).smoke
    tcfg = JS.TrainConfig(optimizer=JAdamW(**MOMENTS[moments]),
                          grad_compression="int8_ef")
    init = JED.init_encdec if cfg.family == "encdec" else JLM.init_lm
    return jax.eval_shape(lambda: JS.init_train_state(
        init(jax.random.PRNGKey(0), cfg, jnp.float32), tcfg))


def _port_like(tree):
    """The reference's state of shapes in the port's containers (dicts,
    lists, QMoments of shape stand-ins)."""
    if isinstance(tree, JQMoment):
        return QMoment(*(_port_like(x) for x in tree))
    if isinstance(tree, dict):
        return {k: _port_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_port_like(v) for v in tree]
    return types.SimpleNamespace(shape=tuple(tree.shape))


def _flat(specs, prefix="") -> dict:
    """{path: spec} of a port spec tree (a QMoment's planes by name)."""
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return {f"{prefix}/{f}": getattr(specs, f) for f in specs._fields}
    if isinstance(specs, (dict, list)):
        items = specs.items() if isinstance(specs, dict) else enumerate(specs)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: specs}


@pytest.mark.parametrize("moments", list(MOMENTS))
@pytest.mark.parametrize("shape,axes", STAND_IN)
@pytest.mark.parametrize("arch", jall_archs())
def test_train_state_specs_equal_reference(arch, shape, axes, moments):
    state = _ref_state_shapes(arch, moments)
    mesh = M.AbstractMesh(shape, axes)
    want = _ref_flat(JPT.make_train_state_specs(state, mesh))
    got = _flat(PT.make_train_state_specs(_port_like(state), mesh))
    assert got == want
    assert want["opt/step"] == ()
    if moments != "f32":
        assert any(p.endswith("/m/q") for p in got)


@pytest.mark.parametrize("moments", list(MOMENTS))
@pytest.mark.parametrize("arch", [LLAMA, DEEPSEEK])
def test_train_state_specs_on_port_state(arch, moments):
    """The port's own per-layer state: a layer's leaf (and its moments'
    planes) takes the reference's spec of the stacked leaf without its
    layer dim."""
    want_state = _ref_state_shapes(arch, moments)
    tcfg = TrainConfig(optimizer=AdamWConfig(**MOMENTS[moments]),
                       grad_compression="int8_ef")
    state = init_train_state(
        TLM.init_lm(tget_config(arch).smoke, seed=0, device="cpu"), tcfg)
    for shape, axes in STAND_IN:
        mesh = M.AbstractMesh(shape, axes)
        want = _ref_flat(JPT.make_train_state_specs(want_state, mesh))
        got = _flat(PT.make_train_state_specs(state, mesh))
        for path, spec in got.items():
            parts = path.split("/")
            i = parts.index("blocks") if "blocks" in parts else -1
            if i >= 0:
                ref = want["/".join(parts[:i + 1] + parts[i + 2:])]
                assert spec == ref[1:], path
            else:
                assert spec == want[path], path
        assert len(PT.flat_specs(PT.make_train_state_specs(state, mesh),
                                 state)) == len(T.leaves(state))


def test_shard_helpers_cut_and_count():
    """``shard_leaf`` on every rank of a (2, 2) mesh (no ranks started:
    it reads the coordinates only), put back in rank order, is the whole
    leaf; ``whole_shape`` / ``shard_shape`` invert each other."""
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    for spec in [("model", "data"), (("data", "model"), None),
                 (None, "model"), (None, None)]:
        bands = {}
        for r in range(4):
            mesh = M.Mesh((2, 2), ("data", "model"), r, {})
            s = PT.shard_leaf(t, spec, mesh)
            assert PT.whole_shape(s.shape, spec, mesh) == tuple(t.shape)
            assert PT.shard_shape(t.shape, spec, mesh) == tuple(s.shape)
            bands[tuple(mesh.coords.values())] = s
        if spec == ("model", "data"):
            rows = [torch.cat([bands[(d, m)] for d in range(2)], 1)
                    for m in range(2)]
            assert torch.equal(torch.cat(rows, 0), t)
        elif spec[0] == ("data", "model"):
            assert torch.equal(torch.cat([bands[(d, m)] for d in range(2)
                                          for m in range(2)], 0), t)
        elif spec == (None, None):
            assert all(b is t for b in bands.values())
    assert PT.spec_axes((("pod", "data"), None, "model")) == (
        "pod", "data", "model")


# -- meshes of spawned ranks -----------------------------------------------

def _batches(cfg, n=STEPS):
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=BATCH,
                                   seq_len=SEQ, seed=1))
    return [data.batch_at(i) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _root() -> str:
    return tempfile.mkdtemp(prefix="repro_mesh_train_")


@pytest.fixture(scope="module", autouse=True)
def _cleanup():
    yield
    shutil.rmtree(_root(), ignore_errors=True)


@functools.lru_cache(maxsize=None)
def _setup(arch, variant):
    """(reference cfg, port cfg, reference init params, reference and
    port train configs) of ``arch``'s smoke model; ``variant`` as
    ``test_torch_train._configs``, or "int8" for int8_ef and int8
    moments together."""
    cfg, tcfg = get_config(arch).smoke, tget_config(arch).smoke
    if variant == "int8":
        jt, tt = _configs("quantized_state")
        jt = dataclasses.replace(jt, grad_compression="int8_ef")
        tt = dataclasses.replace(tt, grad_compression="int8_ef")
    else:
        jt, tt = _configs(variant)
    return cfg, tcfg, init_params(cfg), jt, tt


def _init_state(arch, variant):
    _, tcfg, params, _, tt = _setup(arch, variant)
    return init_train_state(port_tree(params, tcfg), tt)


@functools.lru_cache(maxsize=None)
def _reference_steps(arch, variant):
    """The reference's jitted step, STEPS steps from its init: → (each
    step's loss, the state after them)."""
    cfg, _, params, jt, _ = _setup(arch, variant)
    js = JS.init_train_state(params, jt)
    step = jax.jit(JS.make_train_step(cfg, jt))
    data = _batches(cfg)
    losses = []
    for b in data:
        js, m = step(js, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, js


@functools.lru_cache(maxsize=None)
def _reference_stepwise(arch, variant):
    """The reference's states and gradients step by step (its jitted
    gradient and update, as ``test_torch_train``'s step-by-step test)."""
    cfg, tcfg, params, jt, _ = _setup(arch, variant)
    js = JS.init_train_state(params, jt)
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: JS._loss_fn(p, cfg, jt, b)[0]))

    @jax.jit
    def jupdate(state, grads):
        new = {}
        if "grad_error" in state:
            grads, new["grad_error"] = JS.compress_grads_int8(
                grads, state["grad_error"])
        new["params"], new["opt"], _ = JS.adamw_update(
            state["params"], grads, state["opt"], jt.optimizer)
        return new

    states, grads, losses = [], [], []
    for b in _batches(cfg):
        jl, jg = jgrad(js["params"], {k: jnp.asarray(v.numpy())
                                      for k, v in b.items()})
        states.append(js)
        grads.append(jg)
        losses.append(float(jl))
        js = jupdate(js, jg)
    states.append(js)
    return states, grads, losses


def _cases(shape):
    """What every rank of ``shape`` runs (see the module docstring)."""
    lcfg, ltcfg = _setup(LLAMA, "plain")[1], _setup(LLAMA, "plain")[4]
    dcfg = _setup(DEEPSEEK, "accum2")[1]
    lb, db = _batches(lcfg), _batches(dcfg)
    root = _root()
    if shape == (2, 1):
        return {"steps": {
            "llama plain": (lcfg, ltcfg, _init_state(LLAMA, "plain"), lb),
            "deepseek accum2": (dcfg, _setup(DEEPSEEK, "accum2")[4],
                                _init_state(DEEPSEEK, "accum2"), db)},
            "routes": {"deepseek": (dcfg, _setup(DEEPSEEK, "plain")[4],
                                    _init_state(DEEPSEEK, "plain"), db[0])},
            "loop": {
                "preempt": (lcfg, ltcfg, _init_state(LLAMA, "plain"), lb[:4],
                            f"{root}/preempt", dict(stop_rank=1, stop_at=2)),
                "resume": (lcfg, ltcfg, _init_state(LLAMA, "plain"), lb[:4],
                           f"{root}/preempt", {}),
                "uninterrupted": (lcfg, ltcfg, _init_state(LLAMA, "plain"),
                                  lb[:4], f"{root}/whole", {}),
                "retry": (lcfg, ltcfg, _init_state(LLAMA, "plain"), lb[:4],
                          f"{root}/retry", dict(fail_rank=1, fail_at=1))}}
    if shape == (2, 2):
        stepwise = {}
        for v in ("int8_ef", "quantized_state"):
            _, tt = _configs(v)
            states, grads, _ = _reference_stepwise(LLAMA, v)
            stepwise[f"llama {v}"] = (
                lcfg, tt, [port_state(s, lcfg) for s in states[:-1]],
                [port_tree(g, lcfg) for g in grads], lb)
        return {"steps": {
            "llama plain": (lcfg, ltcfg, _init_state(LLAMA, "plain"), lb,
                            True),
            "llama int8": (lcfg, _setup(LLAMA, "int8")[4],
                           _init_state(LLAMA, "int8"), lb[:3], True)},
            "stepwise": stepwise,
            "save0": {"save0": (None, _init_state(LLAMA, "int8"),
                                f"{root}/save0_mesh")},
            "loop": {"elastic": (lcfg, ltcfg, _init_state(LLAMA, "plain"),
                                 lb[:2], f"{root}/elastic",
                                 dict(ckpt_every=2))},
            "launcher": {"launcher": (LAUNCH_ARGV + [
                "--ckpt-dir", f"{root}/launcher"], None, (2, 3))}}
    damaged = f"{root}/damaged"
    shutil.copytree(f"{root}/save0_mesh", damaged, dirs_exist_ok=True)
    path = os.path.join(damaged, "step_00000000", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["crc32"][DAMAGED_LEAF] ^= 1
    with open(path, "w") as f:
        json.dump(manifest, f)
    return {"grads": {
        "llama": (lcfg, ltcfg, _init_state(LLAMA, "plain"), lb[0]),
        "deepseek accum2": (dcfg, _setup(DEEPSEEK, "accum2")[4],
                            _init_state(DEEPSEEK, "accum2"), db[0])},
        "steps": {"llama plain": (lcfg, ltcfg, _init_state(LLAMA, "plain"),
                                  lb[:3], True)},
        "elastic": {"elastic": (lcfg, ltcfg, _init_state(LLAMA, "plain"),
                                lb[:4], f"{root}/elastic")},
        "damaged": {"damaged": (_init_state(LLAMA, "int8"), damaged, 0)}}


@functools.lru_cache(maxsize=None)
def _run(shape):
    if shape == (1, 2):
        _run((2, 2))            # its checkpoint is what (1, 2) restores
    return M.spawn(torch_mesh_train_worker.run, shape[0] * shape[1], shape,
                   _cases(shape), device="cpu")


def _close_step(got, want, where, count=True):
    """One step's state from the mesh against one process's (the bounds
    above); int8 moments' codes within one (an element's moment moves by
    the norm's roundoff across a rounding boundary), the error feedback
    bitwise.  ``count=False`` leaves out the count of elements beyond
    STEP_PARAM_ATOL (:func:`hold_steps`' first step)."""
    a, b = T.leaves(got["params"]), T.leaves(want["params"])
    assert rel(got["params"], want["params"]) <= STEP_PARAM_RTOL, where
    beyond = sum(int(((x - y).abs() > STEP_PARAM_ATOL).sum())
                 for x, y in zip(a, b))
    assert not count or beyond <= STEP_BEYOND_SHARE * sum(
        x.numel() for x in b), where
    for (path, x), y in zip(T.flatten(got["opt"]["mu"]),
                            T.leaves(want["opt"]["mu"])):
        if path.endswith(".q"):
            assert int((x.to(torch.int16) - y.to(torch.int16)).abs().max()
                       ) <= 1, (where, path)
        elif not path.endswith((".scale", ".zero")):
            assert rel(x, y) <= REF_RTOL, (where, path)
    for x, y in zip(T.leaves(got.get("grad_error", [])),
                    T.leaves(want.get("grad_error", []))):
        assert torch.equal(x, y), where
    assert int(got["opt"]["step"]) == int(want["opt"]["step"])


def _error64(got, exact) -> float:
    """‖got − exact‖ / ‖exact‖ over all leaves as one vector, in float64."""
    a, b = T.leaves(got), T.leaves(exact)
    num = sum(float(((x.double() - y) ** 2).sum()) for x, y in zip(a, b))
    return (num / sum(float((y ** 2).sum()) for y in b)) ** 0.5


def hold_steps(cfg, tcfg, states, metrics, grads, key):
    """From each state the mesh reached, one process's step: the loss and
    the state within the step bounds.

    Where the mesh computes tensor-parallel over model (``grads``: the
    mesh's whole gradients of each step), its roundoff is its own: a
    row-parallel product is a sum over model of partial products, which
    adds in another order than one device's product.  AdamW's first step
    (zero second moments) moves an element by lr · g / (|g| + eps), which
    turns a roundoff of a gradient near eps into up to lr: one process's
    own float32 first step lies beyond STEP_PARAM_ATOL of the float64 step
    at more elements than STEP_BEYOND_SHARE allows (11 of 87 552 for Llama
    smoke), so two first steps that do not share their roundoff cannot
    meet that count.  At that step the mesh's gradients are held within
    STEP_PARAM_RTOL of one process's and no farther than one process's
    from one process's float64 gradients, one process's update of the
    mesh's gradients within the step bounds of the mesh's state, and one
    process's whole step within them but the count; every later step is
    held to one process's whole step in full."""
    one = make_train_step(cfg, tcfg)
    for i, b in enumerate(_batches(cfg, len(metrics))):
        new, m = one(states[i], b)
        assert metrics[i]["loss"] == pytest.approx(float(m["loss"]),
                                                   rel=STEP_LOSS_RTOL), i
        assert metrics[i]["lr"] == float(m["lr"])
        params, opt = states[i]["params"], states[i]["opt"]
        if grads and "grad_error" in states[i]:
            # int8_ef: a gradient's roundoff across a code's rounding
            # boundary moves it a whole step (test_torch_train.py), so
            # one process compresses and updates the mesh's gradients
            g = T.unflatten(params, grads[i])
            g, err = compress_grads_int8(g, states[i]["grad_error"])
            p, o, _ = adamw_update(params, g, opt, tcfg.optimizer)
            new = {"params": p, "opt": o, "grad_error": err}
        elif grads and int(opt["step"]) == 0:
            g = T.unflatten(params, grads[i])
            one_g = grads_of(params, cfg, tcfg, b)[1]
            assert rel(g, one_g) <= STEP_PARAM_RTOL, (key, i)
            exact = grads_of(T.unflatten(params, [
                x.double() for x in T.leaves(params)]), cfg, tcfg, b)[1]
            assert _error64(g, exact) <= _error64(one_g, exact), (key, i)
            p, o, _ = adamw_update(params, g, opt, tcfg.optimizer)
            _close_step(states[i + 1], {"params": p, "opt": o},
                        (key, i, "the mesh's gradients"))
            _close_step(states[i + 1], new, (key, i), count=False)
            continue
        _close_step(states[i + 1], new, (key, i))


@pytest.mark.parametrize("shape,key", [
    ((2, 1), "llama plain"), ((2, 1), "deepseek accum2"),
    ((2, 2), "llama plain"), ((2, 2), "llama int8"), ((1, 2), "llama plain")])
def test_step_against_one_process(shape, key):
    """From each state the mesh reached, one process's step
    (:func:`hold_steps`); every rank reports the same metrics and the
    same whole state."""
    outs = _run(shape)
    arch = DEEPSEEK if key.startswith("deepseek") else LLAMA
    variant = key.split()[1]
    cfg, tcfg = _setup(arch, variant)[1], _setup(arch, variant)[4]
    states, metrics, grads = outs[0][key]
    hold_steps(cfg, tcfg, states, metrics, grads, key)
    for out in outs[1:]:
        assert out[key][1] == metrics
        for a, b in zip(T.leaves(out[key][0][-1]), T.leaves(states[-1])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape,key", [
    ((2, 1), "llama plain"), ((2, 1), "deepseek accum2"),
    ((2, 2), "llama plain")])
def test_steps_against_reference(shape, key):
    """5 steps end to end against the reference's jitted step from the
    same init: each loss within 1e-5, the parameters within 1e-5 and the
    moments within 1e-4 (``test_torch_train``'s bounds)."""
    arch = DEEPSEEK if key.startswith("deepseek") else LLAMA
    variant = key.split()[1]
    losses, js = _reference_steps(arch, variant)
    states, metrics, _ = _run(shape)[0][key]
    tcfg = _setup(arch, variant)[1]
    for i, (m, want) in enumerate(zip(metrics, losses)):
        assert m["loss"] == pytest.approx(want, rel=REF_RTOL), i
    assert rel(states[-1]["params"], port_tree(js["params"], tcfg)) <= \
        REF_RTOL
    assert rel(states[-1]["opt"]["mu"], port_tree(js["opt"]["mu"], tcfg)) \
        <= REF_MU_RTOL


@pytest.mark.parametrize("variant", ["int8_ef", "quantized_state"])
def test_int8_step_by_step_against_reference(variant):
    """On (2, 2), from the reference's state each step: the mesh's loss and
    gathered gradients within 1e-5 of the reference's; given the
    reference's gradients, the mesh's compression (each leaf's range
    reduced over its shards) and update on its shards give the
    reference's error feedback bitwise, its parameters within 1e-5 and
    its int8 moments within one code (``test_torch_train``'s
    step-by-step bounds)."""
    states, grads, losses = _reference_stepwise(LLAMA, variant)
    tcfg = _setup(LLAMA, "plain")[1]
    outs = _run((2, 2))
    got = outs[0][f"llama {variant}"]
    assert len(got) == STEPS
    for i, g in enumerate(got):
        assert g["loss"] == pytest.approx(losses[i], rel=REF_RTOL), i
        want_g = port_tree(grads[i], tcfg)
        assert rel(T.unflatten(want_g, g["grads"]), want_g) <= REF_RTOL, i
        want = port_state(states[i + 1], tcfg)
        if "grad_error" in want:
            for a, b in zip(T.leaves(g["state"]["grad_error"]),
                            T.leaves(want["grad_error"])):
                assert torch.equal(a, b), i
        assert rel(g["state"]["params"], want["params"]) <= REF_RTOL, i
        for (path, a), b in zip(T.flatten(g["state"]["opt"]["mu"]),
                                T.leaves(want["opt"]["mu"])):
            if path.endswith(".q"):
                diff = (a.to(torch.int16) - b.to(torch.int16)).abs()
                assert int(diff.max()) <= 1, (i, path)
            elif not path.endswith((".scale", ".zero")):
                assert rel(a, b) <= REF_RTOL, (i, path)
    if variant == "quantized_state":
        assert any(p.endswith(".q") for p, _ in
                   T.flatten(got[-1]["state"]["opt"]["mu"]))
        # a leaf whose parameter splits on its last dim while the guard
        # keeps its moment's block-count dim whole (64 columns, one block
        # of 64, split over data): updated on the gathered leaf
        st = _init_state(LLAMA, "int8")
        mesh = M.AbstractMesh((2, 2), ("data", "model"))
        specs = PT.make_train_state_specs(st, mesh)
        assert any(isinstance(ms["m"], QMoment) and ms["m"].q[:-1] != p
                   for p, ms in zip(
                       PT.flat_specs(specs["params"], st["params"]),
                       _mu_list(specs["opt"]["mu"], st["params"])))


def test_grads_bitwise_with_one_data_rank():
    """(1, 2): both ranks compute every row, tensor-parallel over model
    (their heads, FFN columns and experts, the row-parallel products
    summed over model in rank order, as the reference's SPMD program adds
    them in another order than one device): the loss within
    STEP_LOSS_RTOL and the gradients, as one vector, within
    STEP_PARAM_RTOL of one process's on the same rows (Llama; DeepSeek
    with accum_steps 2, its experts on model); every rank the same."""
    outs = _run((1, 2))
    for key in ("llama", "deepseek accum2"):
        (loss, grads), (one_loss, one) = outs[0][key]
        assert loss == pytest.approx(one_loss, rel=STEP_LOSS_RTOL), key
        assert rel(grads, one) <= STEP_PARAM_RTOL, key
        for out in outs[1:]:
            assert out[key][0][0] == loss, key


def test_moe_kept_choices_equal_one_process():
    """DeepSeek smoke on (2, 1), capacity factor 1.25, a batch whose
    routing drops choices: each data rank routes its half of the rows with
    the whole microbatch's capacity and global slot ranks, and the two
    halves' kept (token, expert) choices are one process's exactly; the
    aux loss is the whole batch's."""
    cfg, tcfg = _setup(DEEPSEEK, "plain")[1], _setup(DEEPSEEK, "plain")[4]
    assert cfg.capacity_factor == 1.25
    state = _init_state(DEEPSEEK, "plain")
    batch = _batches(cfg, 1)[0]
    with R.recording() as one:
        grads_of(state["params"], cfg, tcfg, batch)
    assert len(one) == cfg.n_layers - cfg.first_dense_layers
    assert any(not bool(keep.all()) for _, keep, _ in one), "nothing dropped"
    outs = _run((2, 1))
    for layer, (ids, keep, aux) in enumerate(one):
        got_ids = torch.cat([o["deepseek"][layer][0] for o in outs])
        got_keep = torch.cat([o["deepseek"][layer][1] for o in outs])
        assert torch.equal(got_ids, ids), layer
        assert torch.equal(got_keep, keep), layer
        for o in outs:
            assert float(o["deepseek"][layer][2]) == pytest.approx(
                float(aux), rel=STEP_LOSS_RTOL), layer


def test_checkpoint_from_a_mesh_equals_one_process(tmp_path):
    """The step-0 state written from (2, 2) (gathered, rank 0 writing)
    and from one process: the same leaves, shapes, dtypes and CRC32s."""
    outs = _run((2, 2))
    assert all(o["save0"] for o in outs)
    ckpt.save(str(tmp_path), 0, _init_state(LLAMA, "int8"))
    read = [json.load(open(os.path.join(d, "step_00000000",
                                        "manifest.json")))
            for d in (f"{_root()}/save0_mesh", str(tmp_path))]
    for k in ("names", "shapes", "dtypes", "crc32", "hosts"):
        assert read[0][k] == read[1][k], k


# the leaf whose manifest CRC32 the damaged checkpoint flips
DAMAGED_LEAF = 3


def test_damaged_checkpoint_raises_on_every_rank():
    """The step-0 checkpoint written from (2, 2), one leaf's manifest
    CRC32 flipped: restoring it onto (1, 2) raises
    ``CheckpointCorruptError`` naming that leaf on every rank."""
    outs = _run((1, 2))
    with open(os.path.join(_root(), "damaged", "step_00000000",
                           "manifest.json")) as f:
        name = json.load(f)["names"][DAMAGED_LEAF]
    for out in outs:
        assert out["damaged"] is not None
        assert name in out["damaged"] and "checksum" in out["damaged"]


def _one_process(arch, variant, n):
    """One process's ``n`` steps from the init: (losses, state)."""
    cfg, tcfg = _setup(arch, variant)[1], _setup(arch, variant)[4]
    state, losses = _init_state(arch, variant), []
    step = make_train_step(cfg, tcfg)
    for b in _batches(cfg, n):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, state


def test_elastic_restore_onto_another_mesh_and_one_process():
    """2 steps on (2, 2) with a checkpoint at step 2; restored onto (1, 2)
    and into one process (``elastic_restore``), 2 more steps each: within
    the end-to-end bounds of an uninterrupted one-process run of 4."""
    losses, want = _one_process(LLAMA, "plain", 4)
    first, start, _, _ = _run((2, 2))[0]["elastic"]
    assert start == 0 and sorted(first) == [1, 2]
    assert ckpt.latest_step(f"{_root()}/elastic") == 2
    cfg, tcfg = _setup(LLAMA, "plain")[1], _setup(LLAMA, "plain")[4]
    like = _init_state(LLAMA, "plain")
    for out in _run((1, 2)):
        at, more, state = out["elastic"]
        assert at == 2
        for a, b in zip(more, losses[2:]):
            assert a == pytest.approx(b, rel=REF_RTOL)
        assert rel(state["params"], want["params"]) <= REF_RTOL
    restored, at = elastic_restore(f"{_root()}/elastic", like, device="cpu")
    assert at == 2
    step = make_train_step(cfg, tcfg)
    for i, b in enumerate(_batches(cfg, 4)[2:]):
        restored, m = step(restored, b)
        assert float(m["loss"]) == pytest.approx(losses[2 + i], rel=REF_RTOL)
    assert rel(restored["params"], want["params"]) <= REF_RTOL


def test_sigterm_on_one_rank_stops_every_rank():
    """Rank 1 alone gets SIGTERM after step 2: both ranks commit step 2
    and stop; started again on the same checkpoints they resume at 2 and
    end with the uninterrupted mesh run's losses and state, bit for
    bit."""
    outs = _run((2, 1))
    for out in outs:
        stopped, start, _, _ = out["preempt"]
        assert start == 0 and sorted(stopped) == [1, 2]
        resumed, start, state, _ = out["resume"]
        assert start == 2 and sorted(resumed) == [3, 4]
        whole, _, want, _ = out["uninterrupted"]
        assert {**stopped, **resumed} == whole
        for a, b in zip(T.leaves(state), T.leaves(want)):
            assert torch.equal(a, b)
    assert ckpt.latest_step(f"{_root()}/preempt") == 4


def test_failed_step_on_one_rank_is_retried_on_all():
    """Rank 1's step 1 raises ``torch.AcceleratorError`` once, at the
    step's end (where a device fault surfaces: the loop's sync, after the
    step's collectives): every rank retries it (the decision is agreed)
    and the run's losses are the uninterrupted run's."""
    for out in _run((2, 1)):
        losses, _, _, calls = out["retry"]
        assert calls[1] == 2 and calls[0] == 1
        assert losses == out["uninterrupted"][0]


def test_launcher_on_a_mesh():
    """``main(mesh=)`` on a spawned (2, 2): rank 2's SIGTERM at step 3
    stops every rank there, the second run resumes at 3 and ends at 6;
    every rank returns the same losses, within LAUNCH_RTOL of
    ``--mesh host``'s."""
    outs = _run((2, 2))
    host = launch_train.main(LAUNCH_ARGV + ["--ckpt-dir",
                                            f"{_root()}/launch_host"])
    for out in outs:
        first, second = out["launcher"]
        assert first["end_step"] == 3 and second["start_step"] == 3
        assert second["end_step"] == 6
        losses = {**first["losses"], **second["losses"]}
        assert losses == {**outs[0]["launcher"][0]["losses"],
                          **outs[0]["launcher"][1]["losses"]}
        for s, want in host["losses"].items():
            assert losses[s] == pytest.approx(want, rel=LAUNCH_RTOL), s


@pytest.mark.parametrize("flag,need", [("single", 256), ("multi", 512)])
def test_launcher_refuses_a_mesh_past_the_ranks(flag, need, capsys):
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--mesh", flag])
    assert f"needs {need} devices, have 1" in capsys.readouterr().err


def test_mesh_traffic_is_counted():
    """Each rank counts the bytes it received: the parameter gathers, the
    gradients' reduce-scatter (with two data ranks: the peer's half of
    each leaf split over data, every step; with one, none) and the
    flags."""
    n = sum(x.numel() * 4 for x in T.leaves(_init_state(LLAMA, "plain")[
        "params"]))
    for shape in ((2, 1), (1, 2)):
        for out in _run(shape):
            traffic = out["traffic"]
            assert traffic["all_gather"] > n and traffic["all_reduce"] > 0
            assert (traffic.get("all_to_all", 0) > n) == (shape[0] > 1), \
                traffic
