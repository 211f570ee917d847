"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: its
counters, its planned mesh, and its plans held against real runs.

  * The counters on a hand-made step (as the reference tests ``hlo_cost``
    on a hand-made HLO): a matmul's 2·M·N·K FLOPs, its operands' and
    result's bytes, a known peak of temporaries, the four collective
    measures of an ``all_gather``, ``psum`` and ``all_to_all`` on a 16×16
    ``PlannedMesh``, and a planned K1 launch's ``work``.
  * ``PlannedMesh`` against a real ``Mesh`` of four spawned gloo ranks on
    (2, 2): the results' shapes and dtypes and every rank's ``traffic``.
  * Plan equals run: on the same spawned ranks, a Llama smoke train step
    (2 layers, f32) on (2, 2) and serving decode steps of the Llama smoke
    model on (1, 2) and of the DeepSeek smoke model (local-routing MoE) on
    (2, 2).  Each rank's bytes received by collective (``Mesh.traffic``)
    equal its plan's ``received_bytes_by_kind`` and the bytes it held
    before the step equal the plan's ``argument_size_in_bytes``, byte for
    byte.  The decode steps are planned on fake CUDA tensors (the card's
    branches) and run on the CPU; the train step is planned on the CPU
    (autograd on fake CUDA tensors needs a CUDA build of torch).
  * ZeRO-3: a smoke train cell's planned argument bytes on a 16×16
    ``PlannedMesh`` equal the per-device bytes of the reference's
    ``make_train_state_specs`` on the same mesh shape.
  * ``run_cell``'s records of a cell the reference skips and of one the
    port refuses.  The full-size plans and the CLI are in
    ``tests/test_torch_dryrun_full.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import lm as JLM
from repro.sharding import partition as JPT
from repro.train import steps as JS
from repro.train.optimizer import AdamWConfig as JAdamW

from repro_torch.configs import get_config
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import _build
from repro_torch.kernels import fused_decode_matmul as fdm
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import op_stats
from repro_torch.launch.specs import train_state_specs
from repro_torch.models import lm as TLM
from repro_torch.serve.engine import build_serve_params
from repro_torch.sharding import partition as PT
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.steps import (TrainConfig, init_train_state,
                                     make_train_step)

import torch_dryrun_worker

torch.set_num_threads(2)
AXES = ("data", "model")


# -- the counters on a hand-made step ---------------------------------------

def test_counters_on_a_hand_made_step():
    """y = (2a + 1) @ b: FLOPs 2·M·N·K; bytes each op's operands plus its
    result; temporaries peak while 2a and 2a + 1 both live."""
    m, k, n = 64, 32, 16

    def step(a, b):
        x1 = a * 2                      # m·k f32
        x2 = x1 + 1
        del x1
        return x2 @ b                   # m·n f32

    with D.fake_tensors("cpu"):
        a, b = torch.empty(m, k), torch.empty(k, n)
        got = D.plan_step(step, a, b, mesh=M.PlannedMesh((1, 1), AXES))
    ak, kn, mn = 4 * m * k, 4 * k * n, 4 * m * n
    assert got["cost"]["flops"] == 2 * m * n * k
    # mul: a → x1; add: x1 → x2; mm: x2, b → y
    assert got["cost"]["bytes accessed"] == (ak + ak) + (ak + ak) + (
        ak + kn + mn)
    mem = got["memory"]
    assert mem["argument_size_in_bytes"] == ak + kn
    assert mem["output_size_in_bytes"] == mn
    assert mem["alias_size_in_bytes"] == 0
    # the peak is x1 and x2 together (x1 is freed before y is made), less
    # the output y the step leaves
    assert mem["temp_size_in_bytes"] == 2 * ak - mn
    assert mem["total_hbm_bytes"] == ak + kn + 2 * ak
    assert got["kernels"] == {} and got["launches"] == {}


def test_in_place_write_counts_the_written_slice():
    def step(cache, new):
        cache[:, 3:4] = new
        return cache

    with D.fake_tensors("cpu"):
        cache, new = torch.empty(8, 100), torch.empty(8, 1)
        got = D.plan_step(step, cache, new, mesh=M.PlannedMesh((1, 1), AXES))
    assert got["memory"]["alias_size_in_bytes"] == 8 * 100 * 4
    assert got["memory"]["temp_size_in_bytes"] == 0
    assert got["cost"]["bytes accessed"] == 2 * 8 * 4   # read, write 8 f32


def test_planned_collectives_on_16x16():
    mesh = M.PlannedMesh((16, 16), AXES, rank=17)
    assert mesh.coords == {"data": 1, "model": 1}
    t = torch.empty(4, 8)                       # 128 B
    assert mesh.all_gather(t, "model", dim=0).shape == (64, 8)
    assert mesh.psum(t, "data").shape == (4, 8)
    assert mesh.all_to_all(torch.empty(16, 8), "data").shape == (16, 8)
    assert mesh.pmax(t, ("data", "model")).shape == (4, 8)
    assert mesh.agree(True) is True
    got = op_stats.collective_stats(mesh)
    assert got["ops"] == {"all-gather": 1, "all-reduce": 3, "all-to-all": 1}
    assert got["bytes_by_kind"] == {"all-gather": 16 * 128,
                                    "all-reduce": 128 + 128 + 4,
                                    "all-to-all": 512}
    assert got["operand_bytes_by_kind"] == {"all-gather": 128,
                                            "all-reduce": 128 + 128 + 4,
                                            "all-to-all": 512}
    assert got["total_bytes"] == 16 * 128 + 260 + 512
    assert got["received_bytes_by_kind"] == {
        "all_gather": 15 * 128, "psum": 15 * 128, "all_reduce": 128 + 4,
        "all_to_all": 15 * 32}


def test_planned_k1_launch_counts_its_work():
    """A K1 call on fake CUDA tensors under a plan: counted as a launch,
    its work recorded by ``fused_decode_matmul.work``, nothing built or
    called through ctypes (this host has no nvcc)."""
    n, k, tn, tk, slots = 256, 512, 128, 512, 1024
    nb = n * k // (4 * slots)
    _build.LAUNCH_COUNTS.clear()
    _build.KERNEL_COUNTS.clear()
    with D.fake_tensors("cuda"):
        dev = D.planned_device("cuda")
        args = (torch.empty(4, k, dtype=torch.bfloat16, device=dev),
                torch.empty(nb, slots, dtype=torch.int16, device=dev),
                torch.empty(nb, 256, 4, dtype=torch.uint8, device=dev),
                torch.empty(65537, 4, dtype=torch.uint8, device=dev),
                torch.empty(n, 1, device=dev), torch.empty(n, 1, device=dev))

        def step(*a):
            return fdm.fused_decode_matmul(*a, shape=(n, k), tile_n=tn,
                                           tile_k=tk, decode=True)

        got = D.plan_step(step, *args, mesh=M.PlannedMesh((1, 1), AXES))
    flops, nbytes = fdm.work(4, n, k, codes=args[1], literals=args[2],
                             lut=args[3], scale=args[4], zero=args[5])
    assert flops == 2 * 4 * n * k
    assert nbytes == (2 * 4 * k + nb * slots * 2 + nb * 256 * 4 + 65537 * 4
                      + 2 * n * 4 + 4 * n * 2)
    assert got["kernels"] == {"fused_decode_matmul:decode": {
        "launches": 1, "flops": flops, "bytes": nbytes}}
    assert dict(_build.KERNEL_COUNTS) == {"fused_decode_matmul:decode": 1}
    assert got["launches"] == {"fused_decode_matmul": 1}
    assert _build.PLAN is None
    _build.LAUNCH_COUNTS.clear()
    _build.KERNEL_COUNTS.clear()


# -- plan against run on spawned gloo ranks ----------------------------------

def _llama_smoke(layers=2):
    return dataclasses.replace(get_config("llama3.2-1b").smoke,
                               n_layers=layers)


def _tokens(shape, vocab, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape))


def _decode_case(cfg, shards):
    params = TLM.init_lm(cfg, seed=0, device="cpu")
    st = build_serve_params(params, CompressionPolicy(min_weight_size=1024),
                            model_shards=shards, device="cpu",
                            manifest=False)
    return {"cfg": cfg, "params": st.params, "lut": st.lut,
            "tokens": _tokens((4, 1), cfg.vocab_size, 1),
            "caches": TLM.init_caches(cfg, 4, 24, device="cpu"),
            "pos": torch.tensor(7)}


@pytest.fixture(scope="module")
def ran():
    cfg = _llama_smoke()
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3))
    tokens = _tokens((4, 17), cfg.vocab_size, 0)
    train = {"cfg": cfg, "tcfg": tcfg,
             "state": init_train_state(TLM.init_lm(cfg, seed=0,
                                                   device="cpu"), tcfg),
             "batch": {"tokens": tokens[:, :-1].contiguous(),
                       "labels": tokens[:, 1:].contiguous()}}
    ds = dataclasses.replace(get_config("deepseek-v2-lite-16b").smoke,
                             moe_local_dispatch=True)
    cases = {"train": train,
             "llama_decode": _decode_case(_llama_smoke(), 2),
             "deepseek_decode": _decode_case(ds, 2)}
    outs = M.spawn(torch_dryrun_worker.run, 4, cases, device="cpu")
    return cases, outs


def test_planned_mesh_matches_real_collectives(ran):
    _, outs = ran
    for rank, out in enumerate(outs):
        mesh = M.PlannedMesh((2, 2), AXES, rank)
        want = torch_dryrun_worker.collectives(mesh, rank)
        assert mesh.coords == dict(zip(AXES, divmod(rank, 2)))
        # a plan is one rank's view: its flag is its own, not the OR
        assert out["collectives"].pop("agree") is True
        assert want.pop("agree") is (rank == 1)
        assert out["collectives"] == want
        assert out["collectives_traffic"] == dict(mesh.traffic)


def _received(plan):
    return plan["collectives"]["received_bytes_by_kind"]


def test_train_step_plan_equals_run(ran):
    cases, outs = ran
    case = cases["train"]
    for rank, out in enumerate(outs):
        mesh = M.PlannedMesh((2, 2), AXES, rank)
        with D.fake_tensors("cpu"):
            state = D.fake_like(case["state"], "cpu")
            specs = PT.make_train_state_specs(state, mesh)
            shards = PT.shard_tree(state, specs, mesh)
            plan = D.plan_step(make_train_step(case["cfg"], case["tcfg"],
                                               mesh=mesh, specs=specs),
                               shards, D.fake_like(case["batch"], "cpu"),
                               mesh=mesh, grad=True)
        assert _received(plan) == out["train"]["traffic"], rank
        assert plan["memory"]["argument_size_in_bytes"] == \
            out["train"]["holds"], rank
        assert set(out["train"]["traffic"]) == {"all_gather", "psum",
                                                "all_to_all"}


@pytest.mark.parametrize("name,shape", [("llama_decode", (1, 2)),
                                        ("deepseek_decode", (2, 2))])
def test_decode_step_plan_equals_run(ran, name, shape):
    cases, outs = ran
    case = cases[name]
    dev = D.planned_device("cuda")
    for rank in range(shape[0] * shape[1]):
        mesh = M.PlannedMesh(shape, AXES, rank)
        _build.KERNEL_COUNTS.clear()
        with D.fake_tensors(dev):
            params = PT.place_params(D.fake_like(case["params"], dev), mesh)
            lut, tokens, caches, pos = [D.fake_like(case[k], dev) for k in
                                        ("lut", "tokens", "caches", "pos")]
            rows = PT.batch_rows(mesh, tokens.shape[0])
            tokens = tokens if rows is None else tokens[rows]
            caches = PT.place_caches(caches, mesh)
            plan = D.plan_step(D.serve_step(case["cfg"], "decode", mesh,
                                            dev, rows), params, lut, tokens,
                               caches, pos, mesh=mesh)
        got = outs[rank][name]
        assert _received(plan) == got["traffic"], (name, rank)
        assert plan["memory"]["argument_size_in_bytes"] == got["holds"]
        # the card's kernels were planned, not their plain versions
        assert plan["kernels"].get("fused_decode_matmul:decode", {}).get(
            "launches", 0) > 0
        assert set(plan["kernels"]) == set(_build.KERNEL_COUNTS) | (
            {"dict_decode:decode"} if case["cfg"].mla else set())
    _build.LAUNCH_COUNTS.clear()
    _build.KERNEL_COUNTS.clear()


# -- ZeRO-3 on the production mesh shape ------------------------------------

def _ref_per_device_bytes(arch, opt, mesh):
    cfg = jget_config(arch).smoke
    state = jax.eval_shape(lambda: JS.init_train_state(
        JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32),
        JS.TrainConfig(optimizer=JAdamW(**opt))))
    specs = JPT.make_train_state_specs(state, mesh)
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(state),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec))):
        split = 1
        for ax in spec:
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                split *= mesh.shape[a]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // split
    return total


@pytest.mark.parametrize("arch,opt", [
    ("llama3.2-1b", {}),
    ("kimi-k2-1t-a32b", {"quantized_state": True, "qblock": 32})])
def test_zero3_plan_argument_bytes_equal_reference(arch, opt):
    """A smoke train cell on the 16×16 mesh: what rank 0's plan holds of
    the train state (its argument bytes less the batch's) is the
    per-device bytes of the reference's specs (f32 moments; int8 moments
    at Kimi-K2's qblock)."""
    cfg = get_config(arch).smoke
    mesh = M.PlannedMesh((16, 16), AXES)
    tcfg = TrainConfig(optimizer=AdamWConfig(**opt))
    with D.fake_tensors("cpu"):
        state = train_state_specs(cfg, tcfg.optimizer, torch.float32, "cpu")
        specs = PT.make_train_state_specs(state, mesh)
        shards = PT.shard_tree(state, specs, mesh)
        tokens = torch.empty(32, 8, dtype=torch.int32)
        batch = {"tokens": tokens, "labels": tokens.clone()}
        plan = D.plan_step(make_train_step(cfg, tcfg, mesh=mesh,
                                           specs=specs),
                           shards, batch, mesh=mesh, grad=True)
    held = plan["memory"]["argument_size_in_bytes"] - 2 * 32 * 8 * 4
    assert held == _ref_per_device_bytes(arch, opt,
                                         M.AbstractMesh((16, 16), AXES))


# -- cells that do not plan --------------------------------------------------

def test_run_cell_records_the_reference_skip():
    """The reference's skip is an ok record, with its reason."""
    rec = D.run_cell("qwen3-4b", "long_500k", multi_pod=False)
    assert rec["ok"] and rec["skipped"].startswith("long_500k skipped")
    assert _build.PLAN is None


def test_run_cell_records_the_train_refusal():
    """On a CPU-only build of torch a train cell on fake CUDA tensors is
    refused before it runs, with the port's message."""
    if torch.backends.cuda.is_built():
        pytest.skip("torch is a CUDA build: train cells plan here")
    rec = D.run_cell("internlm2-1.8b", "train_4k", multi_pod=False)
    assert not rec["ok"] and rec["error"].startswith(
        "RuntimeError: planning a train step on fake CUDA tensors needs a "
        "CUDA build of torch")
    assert _build.PLAN is None
