"""Training on a mesh at the reference's shardings: the per-block remat,
the gather on use over the data axes and tensor-parallel compute over
``model``, on the CPU.

  * Remat (in process): every family's smoke config with ``remat=True``
    gives the loss and every gradient of ``remat=False`` bit for bit
    (Llama, DeepSeek's MLA + MoE, Mamba2, Zamba2, InternVL2, seamless;
    also through the chunked loss), and what autograd holds
    (``saved_tensors_hooks``) falls to the blocks' inputs plus one block's
    saved tensors beyond what lies outside the blocks.
  * Spawned gloo ranks running ``tests/torch_mesh_tp_train_worker.py``
    (the port alone), the smoke configs with ``remat=True``:
      - (1, 2), Llama (the heads path), DeepSeek with ``accum_steps`` 2
        (experts on model) and Llama at a vocab of 212 (the embedding,
        head and loss on the vocab band, chunked and not): each step's
        loss, gradients and state within ``test_torch_mesh_train``'s
        step bounds of one process's step from the same state; Llama's
        and DeepSeek's 5 steps within ``test_torch_train``'s bounds of
        the reference's jitted step;
      - (1, 4), Llama (its 2 kv heads whole on 4 model ranks) and (2, 2),
        Llama: the same;
      - (2, 1): each rank's gradient shards bit for bit the rank-order
        sum of the data ranks' whole gradients, each computed alone in
        one process on its rows, cut to the shard;
      - memory: the most gathered-parameter bytes a rank held at once,
        counted by the gather on use, at most the largest block's band
        plus the embedding/head band, and far below the whole tree;
      - K2: each rank's attention calls see n_heads / model q heads.
"""
import dataclasses
import functools

import pytest
import torch

from repro_torch.configs import get_config as tget_config
from repro_torch.launch import mesh as M
from repro_torch.models import encdec as ED
from repro_torch.models import lm as TLM
from repro_torch.sharding import partition as PT
from repro_torch.train import tree as T
from repro_torch.models import layers as L
from repro_torch.train.steps import (TrainConfig, data_rows, grads_of,
                                     init_train_state, make_train_step)
from repro_torch.train.optimizer import _recip

import torch_mesh_tp_train_worker
from test_torch_mesh_train import (DEEPSEEK, LLAMA, REF_MU_RTOL, REF_RTOL,
                                   _batches, _init_state, _reference_steps,
                                   _setup, hold_steps)
from test_torch_train import port_tree, rel

torch.set_num_threads(2)

REMAT_ARCHS = [LLAMA, DEEPSEEK, "mamba2-2.7b", "zamba2-1.2b", "internvl2-2b",
               "seamless-m4t-medium"]


# -- remat, in process -----------------------------------------------------

def _remat_batch(cfg, b=2, t=16):
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, t), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (b, t), generator=g)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn(b, 12, cfg.d_model, generator=g)
    if cfg.family == "vlm":
        batch["embeds"] = torch.randn(b, 4, cfg.d_model, generator=g)
    return batch


def _init(cfg):
    init = ED.init_encdec if cfg.family == "encdec" else TLM.init_lm
    return init(cfg, seed=0, device="cpu")


def _saved(fn, monkeypatch):
    """Run ``fn``: → (its result, bytes autograd saved through the outer
    hooks, each block's saved bytes where it ran without remat, the
    blocks' input bytes).  A checkpointed block's own hooks hold its saved
    tensors, so with remat the outer hooks see only its input."""
    outside, per_block, inputs = [0], [], [0]
    block = L.block

    def count(acc):
        def pack(t):
            acc[0] += t.numel() * t.element_size()
            return t
        return pack

    def counted_block(f, *args, remat):
        inputs[0] += args[0].numel() * args[0].element_size()
        if remat:
            return block(f, *args, remat=True)
        acc = [0]
        with torch.autograd.graph.saved_tensors_hooks(count(acc),
                                                      lambda t: t):
            out = f(*args)
        per_block.append(acc[0])
        return out

    monkeypatch.setattr(L, "block", counted_block)
    with torch.autograd.graph.saved_tensors_hooks(count(outside),
                                                  lambda t: t):
        out = fn()
    monkeypatch.setattr(L, "block", block)
    return out, outside[0], per_block, inputs[0]


def _blocks(cfg) -> int:
    """The checkpointed blocks of one forward (an encoder–decoder's cross
    K/V projections, one a decoder layer, included)."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.decoder_layers
    if cfg.family == "hybrid":
        return cfg.n_layers + len(TLM._hybrid_segments(cfg)) - 1
    return cfg.n_layers


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_is_bitwise_and_saves_less(arch, chunk, monkeypatch):
    """``remat=True``: the loss and every gradient of ``remat=False`` bit
    for bit.  Without remat autograd holds what the blocks save; with it,
    the same bytes outside the blocks and none inside them (each block
    keeps its input, and its saved tensors come back one block at a time
    in the backward), so at most the blocks' inputs plus one block's
    saved tensors beyond what lies outside them."""
    cfg = tget_config(arch).smoke
    assert not cfg.remat
    params, batch = _init(cfg), _remat_batch(cfg)
    tcfg = TrainConfig(logits_chunk=chunk)
    off, out_off, blocks, inputs = _saved(
        lambda: grads_of(params, cfg, tcfg, batch), monkeypatch)
    on, out_on, none, inputs_on = _saved(
        lambda: grads_of(params, dataclasses.replace(cfg, remat=True),
                         tcfg, batch), monkeypatch)
    assert torch.equal(on[0], off[0])
    for (path, a), b in zip(T.flatten(on[1]), T.leaves(off[1])):
        assert torch.equal(a, b), path
    assert len(blocks) == _blocks(cfg) and not none
    assert inputs_on == inputs
    # the checkpoint keeps each block's input (saved through the outer
    # hooks), and the blocks' own saved tensors are gone
    assert out_on <= out_off + inputs
    assert out_on + max(blocks) < out_off + sum(blocks)


# -- meshes of spawned ranks -----------------------------------------------

def _tp(arch, variant, **over):
    """(port cfg with remat, its train config, the reference's init
    state) of ``arch``'s smoke model; ``over`` replaces config fields (a
    port-only config, held against one process)."""
    cfg, tcfg = _setup(arch, variant)[1], _setup(arch, variant)[4]
    cfg = dataclasses.replace(cfg, remat=True, **over)
    if over:
        state = init_train_state(TLM.init_lm(cfg, seed=0, device="cpu"),
                                 tcfg)
    else:
        state = _init_state(arch, variant)
    return cfg, tcfg, state


V212 = dict(vocab_size=212)


def _cases(shape):
    lcfg, ltcfg, lstate = _tp(LLAMA, "plain")
    lb = _batches(lcfg)
    if shape == (2, 1):
        return {"shards": {"llama": (lcfg, ltcfg, lstate, lb[0])}}
    steps = {"llama": (lcfg, ltcfg, lstate, lb)}
    if shape in ((1, 2), (2, 2)):
        dcfg, dtcfg, dstate = _tp(DEEPSEEK, "accum2")
        steps["deepseek accum2"] = (dcfg, dtcfg, dstate, _batches(dcfg))
    if shape == (1, 2):
        for key, chunk in (("llama v212", 0), ("llama v212 chunked", 8)):
            vcfg, _, vstate = _tp(LLAMA, "plain", **V212)
            steps[key] = (vcfg, dataclasses.replace(ltcfg, logits_chunk=chunk),
                          vstate, _batches(vcfg, 2))
    return {"steps": steps}


@functools.lru_cache(maxsize=None)
def _run(shape):
    return M.spawn(torch_mesh_tp_train_worker.run, shape[0] * shape[1],
                   shape, _cases(shape), device="cpu")


STEP_CASES = [((1, 2), "llama"), ((1, 2), "deepseek accum2"),
              ((1, 2), "llama v212"), ((1, 2), "llama v212 chunked"),
              ((1, 4), "llama"), ((2, 2), "llama"),
              ((2, 2), "deepseek accum2")]


@pytest.mark.parametrize("shape,key", STEP_CASES)
def test_tp_step_against_one_process(shape, key):
    """From each state the mesh reached, one process's step: the loss and
    the state within the step bounds; at the first step the mesh's
    gradients within STEP_PARAM_RTOL of one process's and no farther than
    them from the float64 gradients (``test_torch_mesh_train.hold_steps``);
    every rank the same metrics and state."""
    states, metrics, _, _, _, grads, _ = _run(shape)[0][key]
    cfg, tcfg = _cases(shape)["steps"][key][:2]
    hold_steps(cfg, tcfg, states, metrics, grads, (shape, key))
    for out in _run(shape)[1:]:
        assert out[key][1] == metrics
        for a, b in zip(T.leaves(out[key][0][-1]), T.leaves(states[-1])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape,key", [
    ((1, 2), "llama"), ((1, 4), "llama"), ((2, 2), "llama"),
    ((1, 2), "deepseek accum2"), ((2, 2), "deepseek accum2")])
def test_tp_steps_against_reference(shape, key):
    """5 steps end to end against the reference's jitted step from the
    same init: each loss within 1e-5, the parameters within 1e-5 and the
    moments within 1e-4 (``test_torch_train``'s bounds)."""
    arch = DEEPSEEK if key.startswith("deepseek") else LLAMA
    variant = "accum2" if arch == DEEPSEEK else "plain"
    losses, js = _reference_steps(arch, variant)
    states, metrics, _, _, _, _, _ = _run(shape)[0][key]
    tcfg = _setup(arch, variant)[1]
    assert len(metrics) == len(losses)
    for i, (m, want) in enumerate(zip(metrics, losses)):
        assert m["loss"] == pytest.approx(want, rel=REF_RTOL), i
    assert rel(states[-1]["params"], port_tree(js["params"], tcfg)) <= \
        REF_RTOL
    assert rel(states[-1]["opt"]["mu"], port_tree(js["opt"]["mu"], tcfg)) \
        <= REF_MU_RTOL


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_gathered_bytes_stay_within_a_block(shape):
    """A rank's most gathered-parameter bytes alive at once, each step:
    above zero where it gathers, at most the largest block's band plus the
    embedding/head band, which is less than the whole tree.  A shard
    gathered over the data axes alone (``partition.gather_leaf_data``) is
    the rank's model band of the leaf."""
    for out in _run(shape):
        for key in ("llama", "deepseek accum2"):
            if key not in out:
                continue
            _, _, peaks, _, (bound, whole), _, data_band = out[key]
            assert data_band, key   # partition.gather_leaf_data
            assert bound < whole, (key, bound, whole)
            for p in peaks:
                assert p <= bound, (shape, key, p, bound)
            assert (max(peaks) > 0) == (bound > 0), (shape, key)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_k2_sees_the_ranks_heads(shape):
    """Every attention call of a rank (forward and recompute) sees
    n_heads / model q heads, where the model ranks divide the q heads."""
    ms = shape[1]
    for out in _run(shape):
        for key in ("llama", "deepseek accum2"):
            if key not in out:
                continue
            heads = out[key][3]
            cfg, tcfg = _cases(shape)["steps"][key][:2]
            assert heads and set(heads) == {cfg.n_heads // ms}, (key, heads)
            # forward and recompute: twice a layer, each step's microbatch
            per = 2 * cfg.n_layers * tcfg.accum_steps
            assert len(heads) == per * len(out[key][1]), (key, len(heads))


def test_data_ranks_shards_are_the_rank_order_sum():
    """(2, 1): each rank's gradient shards are bit for bit the sum, in
    data-rank order, of the data ranks' whole gradients each computed
    alone in one process on its rows, averaged, cut to the shard."""
    outs = _run((2, 1))
    cfg, tcfg, state, batch = _cases((2, 1))["shards"]["llama"]
    mesh = M.AbstractMesh((2, 1), ("data", "model"))
    specs = PT.flat_specs(PT.make_train_state_specs(state, mesh)["params"],
                          state["params"])
    whole = []
    for d in range(2):
        m = M.Mesh((2, 1), ("data", "model"), d, {})
        rows, split = data_rows(batch, tcfg.accum_steps, m)
        assert split
        whole.append(T.leaves(grads_of(state["params"], cfg, tcfg, rows)[1]))
    inv = _recip(2, torch.device("cpu"))
    for out in outs:
        _, shards, coords = out["llama"]
        m = M.Mesh((2, 1), ("data", "model"), coords["data"], {})
        for g0, g1, spec, got in zip(*whole, specs, shards):
            want = PT.shard_leaf((g0 + g1) * inv, spec, m)
            assert torch.equal(got, want)
