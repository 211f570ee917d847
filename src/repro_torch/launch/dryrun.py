"""The dry run: plan every (arch × shape × mesh) cell at full size on fake
tensors — what one rank holds, computes and moves.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for the 16×16 and 2×16×16 TPU meshes and reads the compiled
program.  Here each cell runs the port's own step once, eagerly, on
``FakeTensorMode`` tensors on the ``cuda`` device, so it takes the card's
branches (``ROW_PAD``, the 16-piece norm sum, ``launch_plan`` and
``dequant_plan`` split by the planned card's SM count) and allocates
nothing; no GPU is needed.  The mesh is a ``launch.mesh.PlannedMesh``:
one rank's coordinates (rank 0), its collectives counted, not made.  The
kernel wrappers plan their launches (``kernels._build.planning``) and
``launch/op_stats.py`` reads the memory, the work and the collectives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

A serve cell places the planned tree on its rank
(``sharding.partition.place_params``), gives it its share of the caches
(``partition.place_caches``: batch rows on (pod, data), K/V by heads or
by positions on model, MLA's latents by positions, the Mamba2 state by
heads and its conv window by channels where the model ranks divide its
heads and B/C width, else whole on model) and of the batch's rows (``partition.batch_rows``), and
runs the eager prefill, or one decode step at ``pos``, as ``generate``
runs them on a mesh (``serve.engine.on_mesh``); each record holds the
rank's ``cache_bytes`` beside ``reference_cache_bytes``, its share under
the reference's ``make_cache_specs``.  A train cell runs one
``make_train_step`` on the rank's ZeRO-3 shards.  The plan is what the port does, not what the
reference compiles: eager ops, no fusion, the kernels counted by their
``work`` formulas.  A cell the port cannot plan (a refusal, or a host read
that fake tensors cannot answer) is recorded with ``ok: false`` and the
port's own error.  Autograd on fake CUDA tensors needs a CUDA build of
torch (it asks the CUDA runtime for a stream), so on a CPU-only build a
train cell is refused before it runs; plan those on the card's host.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import ASSIGNED_ARCHS, get_config
from ..core.policy import CompressionPolicy, device_budget
from ..kernels import _build
from ..serve.engine import on_mesh, serve_fns
from ..sharding import partition as PT
from ..train.optimizer import AdamWConfig
from ..train.steps import TrainConfig, make_train_step
from . import op_stats
from .mesh import PlannedMesh
from .specs import (SHAPES, input_specs, serve_param_specs,
                    shape_applicable, train_state_specs)

# Per-arch training knobs (the reference's: activation memory and the
# optimizer's state).
GIANT = {"llama3-405b", "kimi-k2-1t-a32b"}
ACCUM = {"llama3-405b": 64, "kimi-k2-1t-a32b": 32,
         "qwen2-7b": 2, "qwen3-4b": 2, "deepseek-v2-lite-16b": 4,
         "seamless-m4t-medium": 4, "mamba2-2.7b": 4, "zamba2-1.2b": 4}
# int8-moment block: must divide each param's (per-shard) last dim
QBLOCK = {"kimi-k2-1t-a32b": 32}
# chunked CE: never materialize (B, T, V) logits
LOGITS_CHUNK = 512
# serve: the giants' weights FSDP-sharded under the reference's specs, and
# stored as 16 column groups at decode
FSDP_SERVE = GIANT
MOE_LOCAL_DISPATCH = {"deepseek-v2-lite-16b", "kimi-k2-1t-a32b"}
OUT_DIR = "results/dryrun_torch"
# The card a plan is made for: an H100 SXM (NVIDIA data sheet); its SM
# count, which the wrappers' launch plans split by, is ``_build.PLAN_SMS``.
PLAN_CARD = "H100 SXM"
PLAN_HBM_BYTES = 80 * 10 ** 9


def _train_cfgs(arch_id: str) -> TrainConfig:
    giant = arch_id in GIANT
    return TrainConfig(
        optimizer=AdamWConfig(quantized_state=giant,
                              qblock=QBLOCK.get(arch_id, 256)),
        accum_steps=ACCUM.get(arch_id, 1), logits_chunk=LOGITS_CHUNK,
        accum_dtype=torch.bfloat16 if giant else torch.float32)


def planned_card(device) -> dict:
    """The card a plan is made for, stated in every record."""
    return {"device": str(device), "card": PLAN_CARD,
            "sms": _build.PLAN_SMS, "hbm_bytes": PLAN_HBM_BYTES}


def _residency_budget(pspecs, lut, caches, budget_mib: int = 4096):
    """The tiered-residency budget of one serve cell from its whole
    (unplaced) spec trees: what the paper's 4 GiB edge budget leaves for
    the expert cache once the other weights, the KV cache and 64 MiB of
    activations are pinned.  None for a model without experts."""
    blocks = pspecs.get("blocks") or []
    if not blocks or "moe" not in blocks[0]:
        return None
    experts = [b["moe"]["experts"] for b in blocks]
    expert_bytes = op_stats.tree_bytes(experts)
    resident = op_stats.tree_bytes(pspecs, lut) - expert_bytes
    return device_budget(budget_mib * 2**20, expert_bytes=expert_bytes,
                         resident_bytes=resident,
                         kv_bytes=op_stats.tree_bytes(caches),
                         act_bytes=64 * 2**20)


def _setitem(x, idx, value):
    view = _index(x, idx)
    if isinstance(value, torch.Tensor):
        torch.ops.aten.copy_.default(view, value)
    else:
        view.fill_(value)


def _contiguous(x, memory_format=torch.contiguous_format):
    if x.is_contiguous(memory_format=memory_format):
        return x
    return torch.ops.aten.clone.default(x, memory_format=memory_format)


# The Tensor methods whose Python bindings ask for a CUDA device guard,
# which a CPU-only build of torch lacks, and the ops they run.
_FAKE_CUDA_METHODS = {
    "__getitem__": lambda x, idx: _index(x, idx),
    "__setitem__": _setitem,
    "contiguous": _contiguous,
    "copy_": lambda x, src, non_blocking=False: torch.ops.aten.copy_.default(
        x, src, non_blocking),
}


@contextlib.contextmanager
def _fake_cuda_methods():
    """Tensor methods on fake CUDA tensors where torch is a CPU-only build:
    indexing (``x[i]``, ``x[i] = v``), ``contiguous`` and ``copy_`` ask
    for a CUDA device guard in their Python bindings, which that build
    lacks (the ops themselves plan without one).  While the block runs,
    each is swapped, on CUDA tensors, for the op it runs
    (``_FAKE_CUDA_METHODS``)."""
    own = {k: torch.Tensor.__dict__[k] for k in _FAKE_CUDA_METHODS
           if k in torch.Tensor.__dict__}
    for name, fn in _FAKE_CUDA_METHODS.items():
        orig = getattr(torch.Tensor, name)

        def method(x, *a, _fn=fn, _orig=orig, **kw):
            # a fake tensor's device, read without dispatching an op
            dev = getattr(x, "fake_device", None)
            return (_fn if dev is not None and dev.type == "cuda"
                    else _orig)(x, *a, **kw)

        setattr(torch.Tensor, name, method)
    try:
        yield
    finally:
        for name in _FAKE_CUDA_METHODS:
            if name in own:
                setattr(torch.Tensor, name, own[name])
            else:
                delattr(torch.Tensor, name)


def _index(x: torch.Tensor, idx):
    """``x[idx]`` by the ops torch's indexing runs: ``unsqueeze`` for None,
    ``select`` for an int, ``slice`` for a slice, then ``aten.index`` with
    the tensor indices at the dims they stand on.  A boolean mask
    raises."""
    aten = torch.ops.aten
    idx = idx if isinstance(idx, tuple) else (idx,)
    # the dims an Ellipsis stands for
    spread = x.ndim - sum(1 for i in idx if i is not None
                          and i is not Ellipsis)
    at, dim = {}, 0
    for i in idx:
        if i is None:
            x = aten.unsqueeze.default(x, dim)
            dim += 1
        elif i is Ellipsis:
            dim += spread
        elif isinstance(i, torch.Tensor):
            if i.dtype == torch.bool:
                raise NotImplementedError("a boolean mask's result shape "
                                          "depends on the data")
            at[dim] = i
            dim += 1
        elif isinstance(i, slice):
            if i != slice(None):
                start, stop, step = i.indices(x.shape[dim])
                x = aten.slice.Tensor(x, dim, start, stop, step)
            dim += 1
        else:
            x = aten.select.int(x, dim, int(i))
    if not at:
        return x
    return aten.index.Tensor(x, [at.get(j) for j in range(max(at) + 1)])


def planned_device(device) -> torch.device:
    """``device`` as the port names it: ``cuda`` is ``cuda:0``, as
    ``resolve_device`` gives it on a card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)
    return device


@contextlib.contextmanager
def fake_tensors(device):
    """The block's tensors are fake (``FakeTensorMode``): make the cell's
    trees in it and plan its step (:func:`plan_step`).  On fake CUDA
    tensors and a CPU-only build of torch, the Tensor methods whose
    bindings want the CUDA runtime are swapped for their ops
    (:func:`_fake_cuda_methods`)."""
    shim = (_fake_cuda_methods() if planned_device(device).type == "cuda"
            and not torch.backends.cuda.is_built()
            else contextlib.nullcontext())
    with FakeTensorMode(allow_non_fake_inputs=True), shim:
        yield


def fake_like(tree, device):
    """``tree`` (dicts, lists, tuples, NamedTuples, weight containers) with
    each tensor an empty one of its shape and dtype on ``device`` — fake
    inside :func:`fake_tensors`: a plan of a run's own state."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: fake_like(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(fake_like(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(fake_like(v, device) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: fake_like(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree


def plan_step(step, *args, mesh, grad: bool = False) -> dict:
    """Run ``step(*args)`` once, on fake tensors (inside
    :func:`fake_tensors`), under an ``op_stats.Recording``: → {"memory",
    "cost", "kernels", "collectives" (``mesh``'s, a ``PlannedMesh``; none
    for one process, ``mesh`` None), "launches" (the wrappers'
    ``LAUNCH_COUNTS`` in the step)}.  ``args``
    are what the rank holds before the step; ``grad``: the step runs
    autograd (a train step), else it runs under ``torch.no_grad`` as
    serving does."""
    launches0 = collections.Counter(_build.LAUNCH_COUNTS)
    rec = op_stats.Recording(*args)
    with (contextlib.nullcontext() if grad else torch.no_grad()), rec:
        res = step(*args)
    rec.finish(res)
    return {"memory": rec.memory_stats(), "cost": rec.cost_stats(),
            "kernels": rec.kernel_stats(),
            "collectives": (op_stats.collective_stats(mesh)
                            if mesh is not None else {}),
            "launches": dict(_build.LAUNCH_COUNTS - launches0)}


def serve_step(cfg, kind: str, mesh, device, rows=None):
    """The eager step of a serve cell on ``mesh``, as ``generate`` runs it
    there: the prefill(params, lut, batch, caches), or one decode step as
    step(params, lut, tokens, caches, pos), over the rank's ``rows`` of
    the batch (a slice, or None for all) and its caches, under
    ``engine.on_mesh``."""
    fn = serve_fns(cfg, device)[0 if kind == "prefill" else 1]

    def step(*args):
        with on_mesh(mesh, rows):
            return fn(*args)
    return step


def cache_leaves_whole_on_model(caches, mesh) -> dict:
    """{leaf path: bytes a rank holds beyond the reference's share} of the
    cache leaves the port keeps whole on ``model`` where the reference
    splits them (``partition.serve_cache_specs``: the Mamba2 state and
    conv window where the model ranks do not divide its heads or B/C
    width; empty where they do)."""
    ref = PT.make_cache_specs(caches, mesh)
    own = PT.serve_cache_specs(caches, mesh)
    out = {}

    def walk(node, r, o, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], r[k], o[k], f"{path}/{k}" if path else k)
        elif isinstance(node, list):
            for i, (v, a, b) in enumerate(zip(node, r, o)):
                walk(v, a, b, f"{path}/{i}")
        elif tuple(r) != tuple(o):
            extra = sharded_bytes(node, o, mesh) - sharded_bytes(node, r,
                                                                 mesh)
            key = "/".join(p for p in path.split("/") if not p.isdigit())
            out[key] = out.get(key, 0) + extra

    walk(caches, ref, own, "")
    return out


def sharded_bytes(tree, specs, mesh) -> int:
    """Bytes one rank holds of ``tree`` cut by ``specs`` (the partition
    rules' spec tree of it: each dim split over its axes' product), as the
    reference's shardings place its arguments on a device."""
    if isinstance(tree, dict):
        return sum(sharded_bytes(tree[k], specs[k], mesh) for k in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return sum(sharded_bytes(t, s, mesh) for t, s in zip(tree, specs))
    if isinstance(tree, (list, tuple)):
        return sum(sharded_bytes(t, s, mesh) for t, s in zip(tree, specs))
    planes = PT._planes(tree)
    if planes is not None:
        return sum(sharded_bytes(v, specs[k], mesh)
                   for k, v in planes.items())
    if not isinstance(tree, torch.Tensor):
        return 0
    split = 1
    for ax in specs:
        split *= PT._axis_total(mesh, ax)
    return tree.numel() * tree.element_size() // split


def plan_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
              mode: str = "compressed", device="cuda",
              param_dtype=torch.bfloat16) -> dict:
    """Plan one cell on fake tensors on ``device``, as rank 0 of the
    production mesh: → the record's ``kind``, ``rank``, ``memory``,
    ``cost``, ``kernels``, ``collectives``, ``launches`` and, for a
    compressed serve cell of an MoE model, ``residency_budget``; or
    ``{"skipped": why}``.  ``place_params`` and ``shard_leaf`` cut equal
    bands (or keep a leaf whole), so every rank holds rank 0's bytes.
    ``reference_specs_argument_bytes``: what a device holds of the same
    trees under the reference's shardings (its partition rules, which
    ``sharding.partition`` reproduces: FSDP-sharded serving weights for
    the giants, caches and batch rows split), beside what the port's rank
    holds."""
    cfg = get_config(arch_id).full
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        return {"skipped": why}
    mesh = PlannedMesh.production(multi_pod=multi_pod)
    kind = SHAPES[shape_name]["kind"]
    device = planned_device(device)
    if (kind == "train" and device.type == "cuda"
            and not torch.backends.cuda.is_built()):
        raise RuntimeError(
            f"planning a train step on fake CUDA tensors needs a CUDA build "
            f"of torch (autograd asks the CUDA runtime for a stream); this "
            f"torch {torch.__version__} is CPU-only: plan train cells on the "
            "card's host")
    if arch_id in MOE_LOCAL_DISPATCH and kind != "train":
        cfg = dataclasses.replace(cfg, moe_local_dispatch=True)
    out = {"kind": kind, "rank": mesh.rank}
    with fake_tensors(device):
        cell = input_specs(arch_id, shape_name, device=device)
        if kind == "train":
            tcfg = _train_cfgs(arch_id)
            state = train_state_specs(cfg, tcfg.optimizer, param_dtype,
                                      device)
            specs = PT.make_train_state_specs(state, mesh)
            out["reference_specs_argument_bytes"] = sharded_bytes(
                state, specs, mesh) + sharded_bytes(
                cell["batch"], PT.make_data_specs(cell["batch"], mesh), mesh)
            shards = PT.shard_tree(state, specs, mesh)
            del state
            out.update(plan_step(make_train_step(cfg, tcfg, mesh=mesh,
                                                 specs=specs),
                                 shards, cell["batch"], mesh=mesh,
                                 grad=True))
        else:
            tiles = 16 if (arch_id in FSDP_SERVE and mode == "compressed"
                           and kind == "decode") else 0
            pspecs, lut = serve_param_specs(
                cfg, CompressionPolicy(mode=mode, tiles=tiles), param_dtype,
                model_shards=mesh.axis_size(("pod", "model")),
                device=device)
            if mode == "compressed":
                budget = _residency_budget(pspecs, lut, cell["caches"])
                if budget is not None:
                    out["residency_budget"] = budget.summary()
            pos = cell.get("pos")
            scfg = PT.ShardingConfig(mode="serve",
                                     fsdp_weights=arch_id in FSDP_SERVE)
            out["reference_specs_argument_bytes"] = (
                sharded_bytes(pspecs, PT.make_param_specs(pspecs, mesh,
                                                          scfg), mesh)
                + op_stats.tree_bytes(lut, cell.get("pos"))
                + sharded_bytes(cell["caches"], PT.make_cache_specs(
                    cell["caches"], mesh), mesh)
                + sharded_bytes(cell["batch"], PT.make_data_specs(
                    cell["batch"], mesh), mesh))
            params = PT.place_params(pspecs, mesh)
            del pspecs
            rows = PT.batch_rows(mesh, cell["batch"]["tokens"].shape[0])
            batch = {k: v if rows is None else v[rows]
                     for k, v in cell["batch"].items()}
            caches = PT.place_caches(cell["caches"], mesh)
            out["cache_bytes"] = op_stats.tree_bytes(caches)
            out["reference_cache_bytes"] = sharded_bytes(
                cell["caches"], PT.make_cache_specs(cell["caches"], mesh),
                mesh)
            out["cache_whole_on_model"] = cache_leaves_whole_on_model(
                cell["caches"], mesh)
            out["batch_rows"] = (None if rows is None
                                 else rows.stop - rows.start)
            del cell
            step = serve_step(cfg, kind, mesh, device, rows)
            if kind == "prefill":
                out.update(plan_step(step, params, lut, batch, caches,
                                     mesh=mesh))
            else:
                out.update(plan_step(step, params, lut, batch["tokens"],
                                     caches, pos, mesh=mesh))
    return out


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             mode: str = "compressed", device="cuda") -> dict:
    """One cell's record: the reference's keys (``arch``, ``shape``,
    ``mesh``, ``mode``, ``ok``, ``skipped``, ``memory``, ``cost``,
    ``collectives``, ``residency_budget``, ``wall_s``, ``error``,
    ``traceback``), with ``kernels`` and the planned card (``planned``).
    ``wall_s``: this host's seconds to plan the cell."""
    t0 = time.monotonic()
    rec = {"arch": arch_id, "shape": shape_name,
           "mesh": "multi" if multi_pod else "single", "mode": mode,
           "planned": planned_card(planned_device(device))}
    try:
        rec.update(plan_cell(arch_id, shape_name, multi_pod=multi_pod,
                             mode=mode, device=device))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.monotonic() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mode", default="compressed",
                    choices=["dense", "quant", "compressed"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                fn = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_kind}__{args.mode}.json")
                if os.path.exists(fn):
                    with open(fn) as f:
                        if json.load(f).get("ok"):
                            print(f"[skip cached] {fn}")
                            continue
                rec = run_cell(arch, shape, multi_pod=(mesh_kind == "multi"),
                               mode=args.mode)
                with open(fn, "w") as f:
                    json.dump(rec, f, indent=1)
                status = ("OK" if rec.get("ok") else "FAIL") + \
                    (" (skipped: " + rec["skipped"] + ")"
                     if "skipped" in rec else "")
                mem = rec.get("memory", {}).get("total_hbm_bytes", 0)
                print(f"[{status}] {arch} {shape} {mesh_kind} planned "
                      f"bytes a rank={mem / 1e9:.2f} GB (card "
                      f"{PLAN_HBM_BYTES / 1e9:.0f} GB) host "
                      f"wall={rec['wall_s']}s", flush=True)
                if rec.get("residency_budget"):
                    print("  " + rec["residency_budget"], flush=True)
                if not rec.get("ok"):
                    print(rec.get("error"), flush=True)


if __name__ == "__main__":
    main()
