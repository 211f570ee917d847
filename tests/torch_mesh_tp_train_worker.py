"""What each rank of ``tests/test_torch_mesh_tp_train.py``'s meshes runs.

The ranks that ``repro_torch.launch.mesh.spawn`` starts import this module
by name, so it imports the port alone (no JAX): each rank joins the mesh,
shards the train states it is given (``make_train_state_specs``), trains
on its shards tensor-parallel over ``model`` and returns what the test
compares in the parent process: whole states gathered from the shards,
losses, its own gradient shards, the most gathered-parameter bytes alive
at once in each step, the bytes that bound them, and the q heads each of
its attention calls saw."""
import torch

from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import partition as PT
from repro_torch.train import tree as T
from repro_torch.train.steps import loss_and_grads_on_mesh, make_train_step

_HEADS: list = []
_flash = ops.flash_attention


def _recording_flash(q, *args, **kwargs):
    _HEADS.append(int(q.shape[1]))
    return _flash(q, *args, **kwargs)


def _leaf_bytes(t, spec, path, cfg, mesh) -> int:
    """Bytes of what the gather on use gives a rank of one leaf, where it
    gathers at all (0 where the rank reads its shard as it is)."""
    split = PT.data_split(spec, mesh)
    dim = PT.model_dim(spec, mesh)
    band = dim is not None and PT.tp_keeps_band(path, spec, cfg, mesh)
    if split is None and (dim is None or band):
        return 0
    n = t.numel() * t.element_size()
    return n // mesh.shape["model"] if band else n


def gathered_bound(params, cfg, mesh) -> tuple:
    """(the largest block's gathered bytes plus the embedding's and the
    head's, the whole tree's bytes) on ``mesh``: what a rank may hold of
    gathered parameters at once when each block gathers its own leaves
    inside its checkpointed body."""
    specs = PT.make_param_specs(params, mesh, PT.ShardingConfig(mode="train"))
    blocks, top = {}, 0
    for (path, t), spec in zip(T.flatten(params),
                               PT.flat_specs(specs, params)):
        name = PT.clean_keystr(path)
        n = _leaf_bytes(t, spec, name, cfg, mesh)
        parts = name.split("/")
        if parts[0] in ("blocks", "first_blocks", "encoder", "decoder"):
            key = "/".join(parts[:2])
            blocks[key] = blocks.get(key, 0) + n
        elif parts[0] == "shared_attn":
            blocks["shared_attn"] = blocks.get("shared_attn", 0) + n
        else:
            top += n
    whole = sum(t.numel() * t.element_size() for t in T.leaves(params))
    return max(blocks.values()) + top, whole


def _data_gathers(mesh, params, specs) -> bool:
    """Whether ``gather_leaf_data`` gives every leaf's model band: the
    whole leaf cut on its ``model`` dim alone (under the spec's entry of
    that dim: Mamba2's rows and channels by their segments)."""
    for t, spec in zip(T.leaves(params), PT.flat_specs(specs, params)):
        dim = PT.model_dim(spec, mesh)
        band = tuple(spec[i] if i == dim else None for i in range(len(spec)))
        got = PT.gather_leaf_data(PT.shard_leaf(t, spec, mesh), spec, mesh)
        if not torch.equal(got, PT.shard_leaf(t, band, mesh)):
            return False
    return True


def _steps(mesh, cfg, tcfg, state, batches):
    """``len(batches)`` steps from the whole ``state``: → (every whole
    state, each step's metrics, each step's most gathered bytes alive,
    the q heads each of its attention calls saw, the bound and the whole
    tree's bytes, each step's whole gradients, whether the data-axes
    gather gives each leaf's model band)."""
    specs = PT.make_train_state_specs(state, mesh)
    shards = PT.shard_tree(state, specs, mesh)
    step = make_train_step(cfg, tcfg, mesh=mesh, specs=specs)
    states, metrics, peaks, grads, heads = [state], [], [], [], []
    for b in batches:
        g = loss_and_grads_on_mesh(shards["params"], cfg, tcfg, b, mesh,
                                   specs["params"])[1]
        grads.append(T.leaves(PT.gather_tree(g, specs["params"], mesh)))
        _HEADS.clear()
        shards, m = step(shards, b)
        heads += _HEADS
        peaks.append(PT.GATHER_STATS["peak"])
        states.append(PT.gather_tree(shards, specs, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return (states, metrics, peaks, heads,
            gathered_bound(state["params"], cfg, mesh), grads,
            _data_gathers(mesh, state["params"], specs["params"]))


def _shards(mesh, cfg, tcfg, state, batch):
    """This rank's shards of the gradients of one microbatch, and its
    coordinates."""
    specs = PT.make_train_state_specs(state, mesh)
    shards = PT.shard_tree(state, specs, mesh)
    loss, grads = loss_and_grads_on_mesh(shards["params"], cfg, tcfg, batch,
                                         mesh, specs["params"])
    return float(loss), T.leaves(grads), dict(mesh.coords)


def run(rank: int, shape: tuple, cases: dict) -> dict:
    """``cases``: {kind: {key: inputs}} (``test_torch_mesh_tp_train``)."""
    torch.set_num_threads(1)
    ops.flash_attention = _recording_flash
    mesh = make_mesh(shape, ("data", "model"))
    out = {"coords": dict(mesh.coords)}
    for key, args in cases.get("steps", {}).items():
        out[key] = _steps(mesh, *args)
    for key, args in cases.get("shards", {}).items():
        out[key] = _shards(mesh, *args)
    out["traffic"] = dict(mesh.traffic)
    return out
