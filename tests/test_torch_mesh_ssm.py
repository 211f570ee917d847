"""Mamba2's blocks and state on ``model``: each model rank serves and trains
on its own SSM heads, on the CPU, held against the port's one process and
against the JAX package.

  * The row map (``partition.ssm_rows``), with no model built: for
    Mamba2-2.7B and Zamba2-1.2B at 2, 4 and 16 model ranks, each rank's
    rows of ``in_proj`` (z, x, B, C, dt) and channels of the conv (x, B,
    C) are the m-th 1/ms of every segment, the ranks' rows together a
    permutation of the whole, each as many as the reference's contiguous
    share; ``shard_leaf`` cuts them under the segmented spec and
    ``assemble`` puts every rank's back into the reference's row order.
  * The gated norm's mean of squares from a rank's channels
    (``ssm.gated_mean_square``) at 2, 4 and 32 model ranks, against one
    process's.
  * Spawned gloo ranks running ``tests/torch_mesh_ssm_worker.py`` (the
    port alone), the Mamba2 and Zamba2 smoke models from the reference's
    init (vocab 212 for serving):
      - serving on (1, 2), (1, 4) and (2, 2), on the reference's
        compressed planes: greedy tokens of ``generate`` and of the eager
        loop equal one process's, every step's logits within LOGIT_ATOL,
        the prefill's logits within ``test_torch_model.ATOL`` of the
        reference's ``forward``; each rank's SSM state holds its heads
        (B, H/ms, P, N) and its conv window its channels, all its caches
        exactly the bytes of ``make_cache_specs``' share, its conv
        weights the reference's share (its channels of x, B, C) and its
        in_proj/out_proj planes an out band (1/ms);
      - training (remat) on (1, 2) and (2, 2), 5 steps: each within
        ``test_torch_mesh_train.hold_steps``' bounds of one process's step
        (the first as :func:`_hold_first_step` says: one process's own
        float32 first step lies too far from float64 for the whole-step
        bound), and end to end within ``test_torch_train``'s bounds of
        the reference's jitted step; no ``mamba/*`` leaf gathered over
        ``model`` (the gather on use's plans), each rank's shards of them
        its rows under the row map;
      - a checkpoint written from (1, 2)'s shards: every leaf byte-equal
        to one process's save of the same state (the reference's row
        order), restored onto (1, 2) as the shards, into one process as
        the state, onto (2, 1) as its cut, and a step there within bound.
"""
import dataclasses
import functools
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.core import CompressionPolicy as JPolicy
from repro.models import lm as JLM
from repro.serve import engine as JE

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M
from repro_torch.launch.dryrun import sharded_bytes
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import ssm as SSM
from repro_torch.serve import engine as TE
from repro_torch.sharding import partition as PT
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import tree as T
from repro_torch.train.fault import elastic_restore
from repro_torch.train.steps import grads_of, make_train_step
from repro_torch.train.optimizer import adamw_update

import torch_mesh_serve_worker as SW
import torch_mesh_ssm_worker as W
from test_torch_mesh_tp_train import _tp
from test_torch_mesh_train import (REF_MU_RTOL, REF_RTOL, STEP_LOSS_RTOL,
                                   STEP_PARAM_RTOL, _batches, _close_step,
                                   _error64, _reference_steps)
from test_torch_model import ATOL, state_to_numpy
from test_torch_train import port_tree, rel

torch.set_num_threads(2)
ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
VOCAB = 212                 # divides 2 and 4 model ranks
BATCH, T0, MAX_NEW = 4, 6, 6
# every step's logits of a mesh against one process: the ranks' gated
# norm adds the mean of squares' pieces in another order than the CPU's
# torch.mean, and the chunked scan runs on H/ms heads (f32 roundoff
# through 3-5 bf16 blocks; measured at most 7.9e-3); the card-vs-CPU
# bound of chip_smoke.py and tests/test_torch_mesh_serve.py
LOGIT_ATOL = 5e-2


def _sizes(cfg) -> tuple:
    """(in_proj rows, conv channels, d_inner, B/C width, heads)."""
    di, gn, h = cfg.d_inner, cfg.ssm_n_groups * cfg.ssm_state, cfg.ssm_heads
    return 2 * di + 2 * gn + h, di + 2 * gn, di, gn, h


# -- the row map, no model built -------------------------------------------

@pytest.mark.parametrize("ms", [2, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_row_map_is_a_permutation_of_head_bands(arch, ms):
    """Each rank's rows are its heads' z, x and dt and its 1/ms of B and
    C, in segment order; the ranks' rows are a permutation of the whole;
    each holds as many rows as the reference's contiguous share."""
    cfg = get_config(arch).full
    assert PT.ssm_split(cfg, ms)
    rows, chans, di, gn, h = _sizes(cfg)
    for conv, whole, segs in ((False, rows, (di, di, gn, gn, h)),
                              (True, chans, (di, gn, gn))):
        got = [PT.ssm_rows(cfg, ms, m, conv=conv) for m in range(ms)]
        assert sorted(sum(got, [])) == list(range(whole))
        for m, r in enumerate(got):
            assert len(r) == whole // ms
            want, start = [], 0
            for s in segs:
                want += list(range(start + m * s // ms,
                                   start + (m + 1) * s // ms))
                start += s
            assert r == want


def _mamba_leaves(cfg, lead=()):
    """A Mamba2 block's dense leaves at ``cfg``'s shapes, every element its
    own value (arange), with a leading ``lead`` of stacked dims."""
    rows, chans, di, _, h = _sizes(cfg)
    shapes = {"in_proj": (rows, 8), "conv_w": (chans, cfg.ssm_conv),
              "conv_b": (chans,), "a_log": (h,), "dt_bias": (h,),
              "d_skip": (h,), "gate_norm": (di,), "out_proj": (8, di)}
    out, base = {}, 0
    for k, s in shapes.items():
        n = int(np.prod(lead + s))
        out[k] = torch.arange(base, base + n, dtype=torch.float32).reshape(
            lead + s)
        base += n
    return out


@pytest.mark.parametrize("ms", [2, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_and_assemble_follow_the_row_map(arch, ms):
    """Under ``make_param_specs`` on (2, ms) a rank's shard of in_proj is
    its rows of the map cut over data, of conv_w/conv_b its channels, of
    out_proj its contiguous heads' columns (one segment); ``assemble`` of
    every rank's shards gives each leaf back; the specs equal the bare
    axis names."""
    cfg = get_config(arch).full
    leaves = _mamba_leaves(cfg)
    shape = (2, ms)
    tree = {"blocks": [{"mamba": leaves}]}
    specs = PT.make_param_specs(tree, M.AbstractMesh(shape, ("data", "model")))
    sp = specs["blocks"][0]["mamba"]
    assert sp["in_proj"] == ("model", "data")
    assert isinstance(sp["in_proj"][0], PT.SegmentedAxis)
    assert isinstance(sp["conv_b"][0], PT.SegmentedAxis)
    assert sp["out_proj"][1].sizes == (cfg.d_inner,)     # one segment
    meshes = [M.Mesh(shape, ("data", "model"), r, {})
              for r in range(shape[0] * shape[1])]
    for name, t in leaves.items():
        parts = [PT.shard_leaf(t, sp[name], m) for m in meshes]
        for m, part in zip(meshes, parts):
            mi, d = m.coords["model"], m.coords["data"]
            if name == "in_proj":
                want = t[PT.ssm_rows(cfg, ms, mi)][:, d * 4:(d + 1) * 4]
            elif name in ("conv_w", "conv_b"):
                want = t[PT.ssm_rows(cfg, ms, mi, conv=True)]
            elif name == "out_proj":
                per = t.shape[1] // ms
                want = t[d * 4:(d + 1) * 4, mi * per:(mi + 1) * per]
            else:
                want = t
            assert torch.equal(part, want), (name, m.coords)
        assert torch.equal(PT.assemble(parts, sp[name], meshes[0]), t), name


def test_segments_need_heads_and_bc_to_divide():
    """Where the model ranks do not divide the heads (Mamba2's 80 on 32)
    or the B/C width, in_proj keeps the guard's plain spec and the block
    stays whole on every model rank (``tp_keeps_band`` False)."""
    cfg = get_config("mamba2-2.7b").full
    assert not PT.ssm_split(cfg, 32) and not PT.ssm_split(cfg, 1)
    tree = {"blocks": [{"mamba": _mamba_leaves(cfg)}]}
    mesh = M.AbstractMesh((1, 32), ("data", "model"))
    sp = PT.make_param_specs(tree, mesh)["blocks"][0]["mamba"]
    assert not any(isinstance(a, PT.SegmentedAxis)
                   for s in sp.values() for a in s)
    assert not PT.tp_keeps_band("blocks/0/mamba/in_proj", sp["in_proj"],
                                cfg, mesh)
    assert not PT.tp_keeps_band("blocks/0/mamba/out_proj", sp["out_proj"],
                                cfg, mesh)


class _ModelRanks:
    """The model axis of ``len(bands)`` ranks as rank ``rank`` sees it:
    its all-gather puts the other ranks' piece sums of their bands of a
    row (``layers.square_pieces``) beside its own, its sum adds the
    ranks' sums of squares in rank order."""

    def __init__(self, bands, rank):
        self.bands, self.rank = bands, rank

    def all_gather(self, t, axes, dim):
        k = 16 // len(self.bands)
        return torch.cat([t if i == self.rank else L.square_pieces(b, k)
                          for i, b in enumerate(self.bands)], dim)

    def psum(self, t, axes):
        parts = [t if i == self.rank else (b * b).sum(-1, keepdim=True)
                 for i, b in enumerate(self.bands)]
        out = parts[0]
        for x in parts[1:]:
            out = out + x
        return out


@pytest.mark.parametrize("ms", [2, 4, 32])
def test_gated_mean_square_over_the_ranks(ms):
    """Each rank's mean of squares over the whole row from its 1/ms of the
    channels (``ssm.gated_mean_square``: the 16 pieces gathered where ms
    divides 16, at 32 ranks the ranks' sums) is every rank's same value,
    within f32 roundoff of one process's mean (the card holds it bitwise:
    ``tests/test_torch_cuda.py``)."""
    g = torch.Generator().manual_seed(4)
    xf = torch.randn((3, 5, 128), generator=g)
    bands = list(xf.split(128 // ms, dim=-1))
    got = [SSM.gated_mean_square(bands[r], _ModelRanks(bands, r), ms, 128,
                                 False) for r in range(ms)]
    want = L._mean_square(xf)
    for v in got:
        assert torch.equal(v, got[0])
    torch.testing.assert_close(got[0], want, rtol=1e-6, atol=0)


# -- meshes of spawned ranks -----------------------------------------------

@functools.lru_cache(maxsize=None)
def _root() -> str:
    return tempfile.mkdtemp(prefix="repro_mesh_ssm_")


@pytest.fixture(scope="module", autouse=True)
def _cleanup():
    yield
    shutil.rmtree(_root(), ignore_errors=True)


@functools.lru_cache(maxsize=None)
def _served(arch, ms):
    """(port cfg, port serve state, the reference's cfg and serve state):
    the reference's PRNGKey(0) weights at vocab 212, compressed for
    ``ms`` model shards by the reference and converted (the same
    planes)."""
    jcfg = dataclasses.replace(jget_config(arch).smoke, vocab_size=VOCAB)
    cfg = dataclasses.replace(get_config(arch).smoke, vocab_size=VOCAB)
    jst = JE.build_serve_params(
        JLM.init_lm(jax.random.PRNGKey(0), jcfg, jnp.float32),
        JPolicy(mode="compressed", min_weight_size=1024), model_shards=ms,
        manifest=False)
    st = convert.serve_state_from_numpy(
        state_to_numpy(jst), np.asarray(jst.lut), cfg, mode="compressed",
        device="cpu")
    return cfg, st, jcfg, jst


@functools.lru_cache(maxsize=None)
def _trained(arch):
    """(port cfg with remat, train config, train state) of ``arch``'s
    smoke model from the reference's init
    (``test_torch_mesh_tp_train._tp``)."""
    return _tp(arch, "plain")


def _tokens():
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(1, VOCAB, (BATCH, T0)))


def _cases(shape):
    cases = {"serve": {}}
    for arch in ARCHS:
        cfg, st = _served(arch, shape[1])[:2]
        cases["serve"][arch] = (cfg, st.params, st.lut, _tokens(), MAX_NEW)
    if shape in ((1, 2), (2, 2)):
        cases["train"] = {}
        for arch in ARCHS:
            cfg, tcfg, state = _trained(arch)
            cases["train"][arch] = (cfg, tcfg, state, _batches(cfg))
    if shape == (1, 2):
        cfg, tcfg, state = _trained(ARCHS[0])
        cases["checkpoint"] = (cfg, tcfg, state, _batches(cfg, 1)[0],
                               _root())
    return cases


@functools.lru_cache(maxsize=None)
def _run(shape):
    return M.spawn(W.run, shape[0] * shape[1], shape, _cases(shape),
                   device="cpu")


SHAPES = [(1, 2), (1, 4), (2, 2)]
SERVE = [(s, a) for s in SHAPES for a in ARCHS]
TRAIN = [(s, a) for s in ((1, 2), (2, 2)) for a in ARCHS]


@functools.lru_cache(maxsize=None)
def _one(arch, ms):
    """One process's greedy tokens and eager loop on the same planes."""
    cfg, st = _served(arch, ms)[:2]
    toks = _tokens()
    return (TE.generate(st.params, cfg, toks, lut=st.lut, device="cpu",
                        max_new=MAX_NEW),
            SW.eager(cfg, st.params, st.lut, toks, MAX_NEW))


@pytest.mark.parametrize("shape,arch", SERVE)
def test_serving_on_the_ranks_heads_matches_one_process(shape, arch):
    """Greedy tokens of ``generate`` and of the eager loop equal one
    process's; every step's logits within LOGIT_ATOL; every rank the same
    tokens."""
    one_toks, (eager_toks, eager_logits) = _one(arch, shape[1])
    outs = _run(shape)
    for out in outs:
        o = out[arch]
        assert torch.equal(o["tokens"], one_toks), out["coords"]
        assert torch.equal(o["eager"][0], eager_toks), out["coords"]
        np.testing.assert_allclose(o["eager"][1].float().numpy(),
                                   eager_logits.float().numpy(), rtol=0,
                                   atol=LOGIT_ATOL)
        assert torch.equal(o["tokens"], outs[0][arch]["tokens"])


@pytest.mark.parametrize("shape,arch", SERVE)
def test_serving_prefill_against_reference(shape, arch):
    """Every rank's prefill logits, on its heads, within ATOL["compressed"]
    (``test_torch_model``'s bound of the port against the reference) of
    the reference's ``forward`` on the same planes, at the prompt's last
    position."""
    _, _, jcfg, jst = _served(arch, shape[1])
    ref = np.asarray(JLM.forward(jst.params, jcfg, jnp.asarray(
        _tokens().numpy(), jnp.int32), lut=jst.lut)[0][:, -1], np.float32)
    for out in _run(shape):
        np.testing.assert_allclose(out[arch]["eager"][1][0].float().numpy(),
                                   ref, rtol=0, atol=ATOL["compressed"],
                                   err_msg=str(out["coords"]))


@pytest.mark.parametrize("shape,arch", SERVE)
def test_serving_rank_holds_the_reference_share(shape, arch):
    """Each rank's SSM state is (B/data, H/ms, P, N) and its conv window
    (B/data, K−1, (d_inner + 2gn)/ms); its caches total exactly
    ``make_cache_specs``' share; its conv_w/conv_b are its channels of x,
    B and C (the reference's share of bytes), its in_proj/out_proj planes
    an out band of 1/ms of the whole."""
    cfg, st = _served(arch, shape[1])[:2]
    ms, dp = shape[1], shape[0]
    _, chans, _, _, h = _sizes(cfg)
    mesh = M.AbstractMesh(shape, ("data", "model"))
    whole = LM.init_caches(cfg, BATCH, T0 + MAX_NEW, device="meta")
    want = sharded_bytes(whole, PT.make_cache_specs(whole, mesh), mesh)
    ssm_want = sharded_bytes(whole["blocks"], PT.make_cache_specs(
        whole["blocks"], mesh), mesh)
    block = st.params["blocks"][0]["mamba"]
    for out in _run(shape):
        o = out[arch]
        for c in o["cache_shapes"]:
            assert c["ssm"] == (BATCH // dp, h // ms, cfg.ssm_head_dim,
                                cfg.ssm_state)
            assert c["conv"] == (BATCH // dp, cfg.ssm_conv - 1, chans // ms)
        assert o["cache_bytes"] == want
        assert o["ssm_cache_bytes"] == ssm_want
        rows = PT.ssm_rows(cfg, ms, out["coords"]["model"], conv=True)
        assert torch.equal(o["conv"][0], block["conv_w"][rows])
        assert torch.equal(o["conv"][1], block["conv_b"][rows])
        for k in W.MAMBA_LEAVES:
            assert o["leaf_bytes"][k] * ms == SW.nbytes(block[k]), k


def _double(tree):
    return T.unflatten(tree, [x.double() if x.is_floating_point() else x
                              for x in T.leaves(tree)])


def _first_step(cfg, tcfg, state, grads, batch):
    """At the first step from ``state``: (the mesh's gradients ``grads``
    as a tree, one process's, the float64 gradients, the parameters after
    the float64 step from them)."""
    params, opt = state["params"], state["opt"]
    exact = grads_of(_double(params), cfg, tcfg, batch)[1]
    return (T.unflatten(params, grads), grads_of(params, cfg, tcfg, batch)[1],
            exact, adamw_update(_double(params), exact, _double(opt),
                                tcfg.optimizer)[0])


def _hold_first_step(cfg, tcfg, states, metrics, grads, key):
    """``hold_steps`` with its first step held to what float32 allows.

    AdamW's first step (zero moments) moves an element by lr · g / (|g| +
    eps), so a gradient's roundoff near eps moves it by up to lr.  On the
    Mamba2 and Zamba2 smoke models from the reference's init, one
    process's own float32 first step lies 9.3e-7 and 3.3e-6 (relative)
    from the step taken in float64 from float64 gradients, so two first
    steps whose gradients do not share their roundoff lie about √2 times
    that apart, beyond STEP_PARAM_RTOL (the mesh's measured 1.1e-6 to
    1.3e-6 and 3.4e-6 to 3.7e-6); Zamba2's float32 gradients themselves lie
    1.6e-6 from float64, beyond it too.  So at the first step (each of
    these asserted): the mesh's gradients within STEP_PARAM_RTOL of one
    process's where one process's own lie within it of float64, and no
    farther than one process's from float64; one process's update of the
    mesh's gradients within every step bound of the mesh's state.  Every
    later step is held to one process's step from the mesh's state in
    full, as ``hold_steps`` holds it."""
    one = make_train_step(cfg, tcfg)
    for i, b in enumerate(_batches(cfg, len(metrics))):
        new, m = one(states[i], b)
        assert metrics[i]["loss"] == pytest.approx(float(m["loss"]),
                                                   rel=STEP_LOSS_RTOL), i
        assert metrics[i]["lr"] == float(m["lr"])
        if i:
            _close_step(states[i + 1], new, (key, i))
            continue
        g, one_g, exact, step64 = _first_step(cfg, tcfg, states[0],
                                              grads[0], b)
        if rel(one_g, exact) <= STEP_PARAM_RTOL:
            assert rel(g, one_g) <= STEP_PARAM_RTOL, key
        assert _error64(g, exact) <= _error64(one_g, exact), key
        p, o, _ = adamw_update(states[0]["params"], g, states[0]["opt"],
                               tcfg.optimizer)
        _close_step(states[1], {"params": p, "opt": o},
                    (key, 0, "the mesh's gradients"))
        assert 2 ** 0.5 * _error64(new["params"], step64) > \
            STEP_PARAM_RTOL, ("hold_steps applies", key)


@pytest.mark.parametrize("shape,arch", TRAIN)
def test_tp_steps_on_the_ranks_heads(shape, arch):
    """5 steps: from each state the mesh reached, one process's step
    within ``hold_steps``' bounds, its first step as
    :func:`_hold_first_step` says (one process's own float32 first step
    lies too far from float64 for the whole-step bound); every rank the
    same metrics and state."""
    outs = _run(shape)
    states, metrics, _, _, _, grads = outs[0]["train " + arch][:6]
    cfg, tcfg, _ = _trained(arch)
    assert len(metrics) == len(_batches(cfg))
    _hold_first_step(cfg, tcfg, states, metrics, grads, (shape, arch))
    for out in outs[1:]:
        assert out["train " + arch][1] == metrics
        for a, b in zip(T.leaves(out["train " + arch][0][-1]),
                        T.leaves(states[-1])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape,arch", TRAIN)
def test_tp_steps_against_reference(shape, arch):
    """The mesh's steps end to end against the reference's jitted step on
    one device from the same init (``test_torch_mesh_train.
    _reference_steps``): each loss within REF_RTOL, the parameters within
    REF_RTOL and the first moments within REF_MU_RTOL
    (``test_torch_train``'s bounds)."""
    losses, js = _reference_steps(arch, "plain")
    states, metrics = _run(shape)[0]["train " + arch][:2]
    cfg = _trained(arch)[0]
    assert len(metrics) == len(losses)
    for i, (m, want) in enumerate(zip(metrics, losses)):
        assert m["loss"] == pytest.approx(want, rel=REF_RTOL), i
    assert rel(states[-1]["params"], port_tree(js["params"], cfg)) <= \
        REF_RTOL
    assert rel(states[-1]["opt"]["mu"], port_tree(js["opt"]["mu"], cfg)) \
        <= REF_MU_RTOL


@pytest.mark.parametrize("shape,arch", TRAIN)
def test_no_mamba_leaf_is_gathered_over_model(shape, arch):
    """The gather on use keeps every ``mamba/*`` leaf that model splits on
    the rank's band (in_proj, out_proj, conv_w, conv_b) and gathers none
    over ``model``; the rank's shards of them at step 0 are its rows of
    the row map (cut over data) and its heads' columns."""
    cfg, _, state = _trained(arch)
    ms = shape[1]
    for out in _run(shape):
        o = out["train " + arch]
        plans, first = o[7], o[8]
        mamba = {p: v for p, v in plans.items() if "/mamba/" in p}
        assert mamba and not any(whole for whole, _ in mamba.values())
        for p, (_, band) in mamba.items():
            assert band == p.endswith(W.MAMBA_LEAVES), p
        leaves = state["params"]["blocks"][0]["mamba"]
        d, m = out["coords"]["data"], out["coords"]["model"]
        rows = leaves["in_proj"]
        per = rows.shape[1] // shape[0]
        assert torch.equal(first["in_proj"], rows[PT.ssm_rows(cfg, ms, m)][
            :, d * per:(d + 1) * per])
        conv = PT.ssm_rows(cfg, ms, m, conv=True)
        assert torch.equal(first["conv_w"], leaves["conv_w"][conv])
        assert torch.equal(first["conv_b"], leaves["conv_b"][conv])
        # a data-axes gather gives the rank its model band
        assert o[6]


def test_checkpoint_from_the_ranks_heads():
    """The step-0 state written from (1, 2)'s shards: every leaf
    byte-equal to one process's save of the state, in the reference's
    row order; restored onto (1, 2) it is the shards again, into one
    process the state, onto (2, 1) each rank's cut of it; one step there
    within STEP_LOSS_RTOL of one process's."""
    cfg, tcfg, state = _trained(ARCHS[0])
    outs = _run((1, 2))
    ckpt.save(os.path.join(_root(), "one"), 0, state)
    manifests, arrays = [], []
    for d in ("mesh", "one"):
        step_dir = os.path.join(_root(), d, "step_00000000")
        with open(os.path.join(step_dir, "manifest.json")) as f:
            manifests.append(json.load(f))
        arrays.append(np.load(os.path.join(step_dir, "shard_00000.npz")))
    for k in ("names", "shapes", "dtypes", "crc32"):
        assert manifests[0][k] == manifests[1][k], k
    for name in manifests[1]["names"]:
        assert arrays[0][name].tobytes() == arrays[1][name].tobytes(), name
    restored, at = elastic_restore(os.path.join(_root(), "mesh"), state,
                                   device="cpu")
    assert at == 0
    for a, b in zip(T.leaves(restored), T.leaves(state)):
        assert torch.equal(a, b)
    batch = _batches(cfg, 1)[0]
    want = float(make_train_step(cfg, tcfg)(state, batch)[1]["loss"])
    other = M.AbstractMesh((2, 1), ("data", "model"))
    specs = PT.flat_specs(PT.make_train_state_specs(state, other), state)
    for out in outs:
        o = out["checkpoint"]
        assert o["at"] == (0, 0) and o["same"]
        m = M.Mesh((2, 1), ("data", "model"), o["coords"]["data"], {})
        for a, t, s in zip(o["restored"], T.leaves(state), specs):
            assert torch.equal(a, PT.shard_leaf(t, s, m))
        assert o["loss"] == pytest.approx(want, rel=STEP_LOSS_RTOL)


def _first_step_readings():
    """Print, for each training case, the first step's distances (relative,
    as one vector) behind :func:`_hold_first_step`: the mesh's gradients
    from one process's, each from float64, and the whole steps from each
    other and from the float64 step."""
    for shape in ((1, 2), (2, 2)):
        outs = _run(shape)
        for arch in ARCHS:
            cfg, tcfg, _ = _trained(arch)
            states, _, _, _, _, grads = outs[0]["train " + arch][:6]
            b = _batches(cfg, 1)[0]
            g, one_g, exact, step64 = _first_step(cfg, tcfg, states[0],
                                                  grads[0], b)
            new = make_train_step(cfg, tcfg)(states[0], b)[0]["params"]
            print(shape, arch, json.dumps({
                "grads mesh-one": rel(g, one_g),
                "grads mesh-f64": _error64(g, exact),
                "grads one-f64": _error64(one_g, exact),
                "step mesh-one": rel(states[1]["params"], new),
                "step mesh-f64": _error64(states[1]["params"], step64),
                "step one-f64": _error64(new, step64)}))


if __name__ == "__main__":      # PYTHONPATH=src:tests python tests/<this>
    _first_step_readings()
