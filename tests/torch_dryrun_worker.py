"""What each rank of ``tests/test_torch_dryrun.py``'s spawned mesh runs.

The ranks that ``repro_torch.launch.mesh.spawn`` starts import this module
by name, so it imports the port alone (no JAX).  Four gloo ranks on the
CPU: a set of collectives on (2, 2) (each result's shape and dtype), then
one step of each case on its mesh — a Llama smoke train step on (2, 2), a
serving decode step of the Llama smoke model on (1, 2) and of the
DeepSeek smoke model (local-routing MoE) on (2, 2), each on the rank's
share of the params, caches and batch rows — each with the bytes
the rank received by collective (``Mesh.traffic``) and the bytes it held
before the step, which the test holds its plan to."""
import collections

import torch

from repro_torch.launch import op_stats
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve.engine import on_mesh, serve_fns
from repro_torch.sharding import partition as PT
from repro_torch.train.steps import make_train_step

AXES = ("data", "model")


def collectives(mesh, rank: int) -> dict:
    """Every collective a step uses, on this rank's (4, 6) f32: {name:
    (shape, dtype) of the result}, with the agreed flag."""
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) + rank
    out = {"all_gather_data": mesh.all_gather(x, "data", dim=0),
           "all_gather_both": mesh.all_gather(x, AXES, dim=1),
           "psum_model": mesh.psum(x, "model"),
           "pmax_data": mesh.pmax(x, "data"),
           "all_to_all_data": mesh.all_to_all(x, "data")}
    res = {k: (tuple(v.shape), str(v.dtype)) for k, v in out.items()}
    res["agree"] = mesh.agree(rank == 1)
    return res


def _traffic(mesh, fn):
    before = collections.Counter(mesh.traffic)
    out = fn()
    return out, dict(mesh.traffic - before)


def train_case(mesh, case: dict) -> dict:
    state, batch = case["state"], case["batch"]
    specs = PT.make_train_state_specs(state, mesh)
    shards = PT.shard_tree(state, specs, mesh)
    step = make_train_step(case["cfg"], case["tcfg"], mesh=mesh,
                           specs=specs)
    holds = op_stats.tree_bytes(shards, batch)
    _, traffic = _traffic(mesh, lambda: step(shards, batch))
    return {"traffic": traffic, "holds": holds}


def decode_case(mesh, case: dict) -> dict:
    """One decode step as ``generate`` runs it on ``mesh``: the rank's
    share of the params, of the caches and of the batch's rows."""
    params = PT.place_params(case["params"], mesh)
    lut, tokens, caches, pos = (case[k] for k in ("lut", "tokens",
                                                  "caches", "pos"))
    rows = PT.batch_rows(mesh, tokens.shape[0])
    tokens = tokens if rows is None else tokens[rows]
    caches = PT.place_caches(caches, mesh)
    _, decode = serve_fns(case["cfg"], torch.device("cpu"))
    holds = op_stats.tree_bytes(params, lut, tokens, caches, pos)
    with torch.no_grad(), on_mesh(mesh, rows):
        _, traffic = _traffic(mesh, lambda: decode(params, lut, tokens,
                                                   caches, pos))
    return {"traffic": traffic, "holds": holds}


def run(rank: int, cases: dict) -> dict:
    out = {}
    mesh = make_mesh((2, 2), AXES)
    out["collectives"], out["collectives_traffic"] = _traffic(
        mesh, lambda: collectives(mesh, rank))
    out["train"] = train_case(mesh, cases["train"])
    out["llama_decode"] = None
    small = make_mesh((1, 2), AXES)          # ranks 0 and 1; None past it
    if small is not None:
        out["llama_decode"] = decode_case(small, cases["llama_decode"])
    out["deepseek_decode"] = decode_case(mesh, cases["deepseek_decode"])
    return out
