"""What each rank of ``tests/test_torch_mesh_ssm.py``'s meshes runs.

The ranks that ``repro_torch.launch.mesh.spawn`` starts import this module
by name, so it imports the port alone (no JAX).  Each rank joins the mesh
and, for the Mamba2 and Zamba2 smoke models: serves its share (greedy
tokens through ``generate``, every step's logits through the eager loop,
the shapes and bytes of its caches and of its Mamba2 leaves); trains
tensor-parallel over ``model`` (whole states, losses, gradients, and which
leaves the gather on use kept on the rank's band or gathered whole over
``model``); and writes a checkpoint from its shards, restores it onto the
same mesh and onto (2, 1), and steps there."""
import torch

from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm as LM
from repro_torch.serve.context import ServeContext
from repro_torch.serve.engine import generate
from repro_torch.sharding import partition as PT
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import tree as T
from repro_torch.train.fault import elastic_restore
from repro_torch.train.steps import make_train_step

from torch_mesh_serve_worker import eager, nbytes
from torch_mesh_tp_train_worker import _steps

MAMBA_LEAVES = ("in_proj", "out_proj", "conv_w", "conv_b")


def _serve(mesh, cfg, params, lut, toks, max_new) -> dict:
    placed = PT.place_params(params, mesh)
    ctx = ServeContext(cfg, lut=lut, device="cpu", mesh=mesh)
    caches = LM.init_caches(cfg, toks.shape[0], toks.shape[1] + max_new,
                            device="cpu", mesh=mesh)
    block = placed["blocks"][0]["mamba"]
    return {"tokens": generate(placed, cfg, toks, ctx=ctx, max_new=max_new),
            "eager": eager(cfg, placed, lut, toks, max_new, mesh),
            "cache_shapes": [{k: tuple(v.shape) for k, v in c.items()}
                             for c in caches["blocks"]],
            "cache_bytes": nbytes(caches),
            "ssm_cache_bytes": nbytes(caches["blocks"]),
            "leaf_bytes": {k: nbytes(block[k]) for k in MAMBA_LEAVES},
            "conv": (block["conv_w"], block["conv_b"])}


class _Plans:
    """The gather on use's plan of each leaf it bound, by path: (gathered
    over model too, kept on the rank's band)."""

    def __init__(self):
        self.seen: dict = {}
        self._bind = PT._Gathering.bind

    def __enter__(self):
        plans = self

        def bind(ctx, tree):
            plans._bind(ctx, tree)
            for path, t in T.flatten(tree):
                plan = ctx.plans[id(t)]
                plans.seen[PT.clean_keystr(path)] = (plan[2] is not None,
                                                     plan[3])

        PT._Gathering.bind = bind
        return self

    def __exit__(self, *exc):
        PT._Gathering.bind = self._bind


def _train(mesh, cfg, tcfg, state, batches) -> tuple:
    with _Plans() as plans:
        out = _steps(mesh, cfg, tcfg, state, batches)
    specs = PT.make_train_state_specs(state, mesh)["params"]
    first = {k: PT.shard_leaf(state["params"]["blocks"][0]["mamba"][k],
                              specs["blocks"][0]["mamba"][k], mesh)
             for k in MAMBA_LEAVES}
    return out + (plans.seen, first, dict(mesh.traffic))


def _checkpoint(mesh, cfg, tcfg, state, batch, root) -> dict:
    """The step-0 state written from this mesh's shards, restored onto the
    same mesh and onto (2, 1) (a second mesh of the same ranks), and one
    step there."""
    specs = PT.make_train_state_specs(state, mesh)
    shards = PT.shard_tree(state, specs, mesh)
    ckpt.save(f"{root}/mesh", 0, shards, specs=specs, mesh=mesh)
    back, at = elastic_restore(f"{root}/mesh", state, mesh,
                               PT.make_train_state_specs, device="cpu")
    same = all(torch.equal(a, b) for a, b in zip(T.leaves(back),
                                                 T.leaves(shards)))
    other = make_mesh((2, 1), ("data", "model"))
    restored, at2 = elastic_restore(f"{root}/mesh", state, other,
                                    PT.make_train_state_specs, device="cpu")
    step = make_train_step(cfg, tcfg, mesh=other,
                           specs=PT.make_train_state_specs(state, other))
    _, m = step(restored, batch)
    return {"at": (at, at2), "same": same, "restored": T.leaves(restored),
            "coords": dict(other.coords), "loss": float(m["loss"])}


def run(rank: int, shape: tuple, cases: dict) -> dict:
    """``cases``: {kind: {key: inputs}} (``test_torch_mesh_ssm._cases``)."""
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"))
    out = {"coords": dict(mesh.coords)}
    for key, args in cases.get("serve", {}).items():
        out[key] = _serve(mesh, *args)
    for key, args in cases.get("train", {}).items():
        out["train " + key] = _train(mesh, *args)
    if "checkpoint" in cases:
        out["checkpoint"] = _checkpoint(mesh, *cases["checkpoint"])
    return out
