"""Partition rules — param path → spec, divisibility-guarded.

Counterpart of ``repro/sharding/partition.py``.  A spec is a tuple with
one entry per dim: a mesh axis name, a tuple of names (the dim split over
their product, major first) or ``None`` (replicated) — the reference's
``PartitionSpec`` as a tuple.  The rule table, the guard (an axis the dim
does not divide is dropped) and the plane rules are the reference's, so
the specs equal its specs for the same tree and mesh shape; the rules
read only ``mesh.shape`` and ``mesh.axis_names``, so they run on an
``launch.mesh.AbstractMesh`` as well.

A tree is nested dicts and lists with tensors (or anything with a
``shape``) and weight containers at the leaves; a container's planes are
named as in the reference (``codes``, ``literals``, ``nlit``, ``scale``,
``zero``; a ``TiledPackedLinear``'s ``codes_t``, ``literals_t``,
``nlit_t``; a ``QuantLinear``'s ``values``), and its spec is a dict of
plane specs.  The port keeps a model's layers as a list, so a layer's
leaf has no stacked dim: its spec is the reference's for the stacked leaf
without the leading ``None``.

Serving: what a rank holds is not this table alone.  The port places
the planes that the sharded kernels read as their ``shard_map`` in-specs
give them, and the int8 embedding and head as vocab-row bands on
``model`` (:func:`place_params`); every other weight leaf stays
replicated.  A rank's caches are its share under
:func:`make_cache_specs` (:func:`serve_cache_specs`,
:func:`place_caches`; ``models/lm.py::init_caches(mesh=)`` allocates
it): batch rows on (pod, data), K/V (and their int8 scales) by heads on
``model`` where the kv heads divide it, else by a contiguous block of
positions, MLA's latents by positions, an encoder–decoder's cross K/V by
heads; the Mamba2 state and conv window split over the batch axes only.
A served batch's rows are split over (pod, data) where they divide it
(:func:`batch_rows`, under :func:`rows_split`), else every rank serves
all of them, as the reference's ``drow`` guard does.  Column-parallel
activations stay on their ``model`` band (q/k/v by heads, the MLP's
gate and up projections) until the row-parallel weight after them, as
the reference's ``out_specs`` leave them (``models/layers.py``).
``constrain`` is a no-op outside a mesh, as in the reference, and inside
one too: the layers hold each activation on the rank as its spec says.

Training (``train/steps.py``) is the port's ZeRO-3: each rank stores its
shard of every leaf of the train state under
:func:`make_train_state_specs` (:func:`shard_leaf`: major-first over a
tuple of axes, as :func:`place_params` cuts bands) and computes the rows
of its data rank (:func:`rows_split` marks them split for the MoE's global
statistics).  A step gathers each block's leaves where the block uses
them (:func:`gathering`, :func:`use`), over the data axes alone, and
computes tensor-parallel on the rank's ``model`` band (:func:`tp_mesh`,
:func:`tp_keeps_band`: heads, FFN columns, experts, vocab rows); a leaf
whose band is not a head (Mamba2's, kv heads that do not divide the
model ranks) is gathered over ``model`` too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import weakref
from typing import Any

import torch

from ..launch.mesh import (AXIS_DATA, AXIS_MODEL, AXIS_POD, _unravel,
                           data_axes, gather_model, gather_on_use)


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    mode: str = "train"            # train | serve
    fsdp_weights: bool = True      # shard non-TP weight dim on data axis
    shard_embed_vocab: bool = True
    # serve-only: also use the pod axis for FSDP weight sharding
    pod_in_fsdp: bool = True


# Rule table: (path regex, axis tags), written for the *unstacked*
# weight; a leading None is prepended per stacked dim.  'M' = model/TP
# axis, 'F' = fsdp(data) axis placeholder, 'V' = vocab (TP on model).
_RULES: list[tuple[str, tuple]] = [
    # --- attention ---------------------------------------------------------
    (r"attn/(wq|wk|wv)$",        ("M", "F")),
    (r"attn/(bq|bk|bv)$",        ("M",)),
    (r"attn/wo$",                ("F", "M")),
    (r"attn/(q_norm|k_norm)$",   (None,)),
    # --- MLA ---------------------------------------------------------------
    (r"attn/wq_a$",              (None, "F")),
    (r"attn/wq_b$",              ("M", None)),
    (r"attn/wkv_a$",             (None, "F")),
    (r"attn/wkv_b$",             ("M", None)),
    (r"attn/(q_a_norm|kv_a_norm)$", (None,)),
    # --- cross attention (same shapes as attn) ------------------------------
    (r"cross/(wq|wk|wv)$",       ("M", "F")),
    (r"cross/wo$",               ("F", "M")),
    # --- dense FFN -----------------------------------------------------------
    (r"mlp/(w_gate|w_up)$",      ("M", "F")),
    (r"mlp/w_down$",             ("F", "M")),
    (r"shared/(w_gate|w_up)$",   ("M", "F")),
    (r"shared/w_down$",          ("F", "M")),
    # --- MoE -----------------------------------------------------------------
    (r"moe/router$",             (None, None)),
    (r"experts/(w_gate|w_up)$",  ("M", None, "F")),   # (E, ffe, d): EP on E
    (r"experts/w_down$",         ("M", None, "F")),   # (E, d, ffe)
    # --- mamba2 ---------------------------------------------------------------
    (r"mamba/in_proj$",          ("M", "F")),
    (r"mamba/out_proj$",         ("F", "M")),
    (r"mamba/conv_w$",           ("M", None)),
    (r"mamba/conv_b$",           ("M",)),
    (r"mamba/(a_log|dt_bias|d_skip)$", (None,)),
    (r"mamba/gate_norm$",        (None,)),
    # --- embeddings / head ------------------------------------------------------
    (r"(embed|dec_embed|lm_head)$", ("V", "F")),
    # --- norms -------------------------------------------------------------------
    (r"norm$",                   (None,)),
]

_PLANE_SUFFIX = re.compile(
    r"/(values|codes_t|literals_t|nlit_t|codes|literals|nlit|scale|zero)$")


def _resolve_axis(tag, scfg: ShardingConfig, mesh_axes: tuple):
    if tag is None:
        return None
    if tag in ("M", "V"):
        return AXIS_MODEL if AXIS_MODEL in mesh_axes else None
    if tag == "F":
        if not scfg.fsdp_weights:
            return None
        axes = []
        if scfg.mode == "train" or scfg.pod_in_fsdp:
            if AXIS_POD in mesh_axes:
                axes.append(AXIS_POD)
        if AXIS_DATA in mesh_axes:
            axes.append(AXIS_DATA)
        # a single axis is its bare name, as the reference collapses it
        if len(axes) == 1:
            return axes[0]
        return tuple(axes) if axes else None
    raise ValueError(tag)


def _axis_total(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _guarded_spec(dims: tuple, shape: tuple, mesh) -> tuple:
    """Drop any axis the dim doesn't divide; trim/extend to rank.  A tuple
    of one axis is its bare name, as a ``PartitionSpec`` holds it."""
    spec = []
    for i, d in enumerate(shape):
        axis = dims[i] if i < len(dims) else None
        if axis is not None and (d == 0 or d % _axis_total(mesh, axis) != 0):
            axis = None
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        spec.append(axis)
    return tuple(spec)


def _spec_for_dense(path_str: str, shape: tuple, scfg: ShardingConfig,
                    mesh, stacked: int) -> tuple:
    for pat, tags in _RULES:
        if re.search(pat, path_str):
            dims = tuple(_resolve_axis(t, scfg, mesh.axis_names)
                         for t in tags)
            return _guarded_spec((None,) * stacked + dims, shape, mesh)
    return _guarded_spec((), shape, mesh)  # replicate unknowns


def _plane_rank(plane: str) -> int:
    return {"values": 2, "codes": 2, "literals": 3, "nlit": 1,
            "scale": 2, "zero": 2,
            "codes_t": 3, "literals_t": 4, "nlit_t": 2}[plane]


def _spec_for_plane(path_str: str, plane: str, shape: tuple,
                    scfg: ShardingConfig, mesh) -> tuple:
    """Compressed planes shard along their leading (out-block) axis exactly
    when the dense weight's out dim is TP-sharded, with the FSDP axes
    stacked onto the same block axis; expert planes keep the stacked E dim
    on model; a TiledPackedLinear's group axis goes on data and its block
    axis on model (the reference's ``_spec_for_plane``)."""
    base = _PLANE_SUFFIX.sub("", path_str)
    for pat, tags in _RULES:
        if not re.search(pat, base):
            continue
        axis = _resolve_axis(tags[0], scfg, mesh.axis_names)
        fsdp = _resolve_axis("F", scfg, mesh.axis_names)
        stacked = len(shape) - _plane_rank(plane)
        m_axis = AXIS_MODEL if AXIS_MODEL in mesh.axis_names else None
        if stacked and re.search(r"experts/", base) and plane in (
                "codes", "literals", "nlit", "scale", "zero"):
            blk = fsdp if plane in ("codes", "literals", "nlit") else None
            dims = ((None,) * (stacked - 1) + (m_axis, blk) +
                    (None,) * (_plane_rank(plane) - 1))
            return _guarded_spec(dims, shape, mesh)
        if plane in ("codes_t", "literals_t", "nlit_t"):
            d_axis = AXIS_DATA if AXIS_DATA in mesh.axis_names else None
            dims = ((None,) * stacked + (d_axis, m_axis) +
                    (None,) * (_plane_rank(plane) - 2))
            return _guarded_spec(dims, shape, mesh)
        if plane in ("codes", "literals", "nlit") and fsdp is not None:
            parts = list(fsdp if isinstance(fsdp, tuple) else (fsdp,))
            for a in (axis if isinstance(axis, tuple)
                      else (axis,) if axis else ()):
                if a not in parts:       # wo/w_down have out_tag == F
                    parts.append(a)
            axis = tuple(parts)
        dims = (None,) * stacked + (axis,) + (None,) * (
            _plane_rank(plane) - 1)
        return _guarded_spec(dims, shape, mesh)
    return _guarded_spec((), shape, mesh)


def clean_keystr(name: str) -> str:
    """A keyed path "['blocks']['mlp']['w_down']" -> "blocks/mlp/w_down"."""
    return re.sub(r"[\[\]']+", "/", name).strip("/")


def is_row_parallel(path_str: str) -> bool:
    """True for weights whose matmul contracts the model-sharded dim (wo /
    w_down: tags ("F", "M"))."""
    for pat, tags in _RULES:
        if re.search(pat, path_str):
            return len(tags) >= 2 and tags[0] == "F" and tags[1] == "M"
    return False


def _planes(node) -> dict | None:
    """{plane name: tensor} of a weight container (the reference's names),
    or None for anything else."""
    if not dataclasses.is_dataclass(node) or isinstance(node, type):
        return None
    names = getattr(node, "PLANE_KEYS", {})
    return {names.get(f.name, f.name): getattr(node, f.name)
            for f in dataclasses.fields(node)
            if hasattr(getattr(node, f.name), "shape")}


def _map_tree(node, fn, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and containers (whose
    planes are leaves ``path/plane``); the same structure back, a
    container as a dict of its planes' results."""
    if isinstance(node, dict):
        return {k: _map_tree(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map_tree(v, fn, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(node)]
    planes = _planes(node)
    if planes is not None:
        return {k: fn(f"{path}/{k}", v) for k, v in planes.items()}
    return fn(path, node)


def make_param_specs(params: Any, mesh, scfg: ShardingConfig | None = None
                     ) -> Any:
    """Spec tree matching ``params``: a container's planes by the plane
    rules, a dense leaf by the rule its path matches (leading dims beyond
    the rule's rank are stacked and replicate), anything else
    replicated."""
    scfg = scfg or ShardingConfig()

    def one(path_str, leaf):
        shape = tuple(leaf.shape)
        m = _PLANE_SUFFIX.search(path_str)
        if m:
            return _spec_for_plane(path_str, m.group(1), shape, scfg, mesh)
        for pat, tags in _RULES:
            if re.search(pat, path_str):
                stacked = max(0, len(shape) - len(tags))
                return _spec_for_dense(path_str, shape, scfg, mesh, stacked)
        return _guarded_spec((), shape, mesh)

    return _map_tree(params, one)


def _stacked_cache(path_str: str) -> int:
    """1 where the reference stacks the layers of a cache leaf ('blocks'
    caches and an encoder–decoder's cross K/V and self caches) and the
    path holds no layer index after that key (the port's per-layer list),
    else 0."""
    parts = path_str.split("/")
    for i, p in enumerate(parts):
        if (p == "blocks" and i == 0) or p in ("enc_k", "enc_v", "self"):
            nxt = parts[i + 1] if i + 1 < len(parts) else ""
            return 0 if nxt.isdigit() else 1
    return 0


def make_cache_specs(caches: Any, mesh, batch_axis=None) -> Any:
    """KV/SSM cache specs: batch on data axes when divisible, heads/state
    dims on model when divisible (the reference's rules).  The port keeps
    a list of per-layer caches (an encoder–decoder's cross K/V a list of
    tensors), which have no stacked dim."""
    batch_axes = batch_axis if batch_axis is not None else (
        tuple(a for a in (AXIS_POD, AXIS_DATA) if a in mesh.axis_names)
        or None)
    msize = mesh.shape[AXIS_MODEL] if AXIS_MODEL in mesh.axis_names else 1

    def one(path_str, leaf):
        shape = tuple(leaf.shape)
        stacked = _stacked_cache(path_str)
        dims: list = [None] * len(shape)
        if stacked < len(shape):
            dims[stacked] = batch_axes
        if re.search(r"(^|/)(k|v|enc_k|enc_v)$|(^|/)(enc_k|enc_v)/\d+$",
                     path_str) and \
                len(shape) >= stacked + 4:
            if shape[stacked + 2] % msize == 0:
                dims[stacked + 2] = AXIS_MODEL
            elif shape[stacked + 1] % msize == 0:
                dims[stacked + 1] = AXIS_MODEL
            else:
                dims[stacked + 3] = AXIS_MODEL
        if re.search(r"/(k|v)_scale$", path_str) and \
                len(shape) >= stacked + 4:
            if shape[stacked + 2] % msize == 0:
                dims[stacked + 2] = AXIS_MODEL
            elif shape[stacked + 1] % msize == 0:
                dims[stacked + 1] = AXIS_MODEL
        if re.search(r"/ssm$", path_str) and len(shape) >= stacked + 4:
            if shape[stacked + 1] % msize == 0:
                dims[stacked + 1] = AXIS_MODEL
            else:
                dims[stacked + 3] = AXIS_MODEL
        if re.search(r"/conv$", path_str) and len(shape) >= stacked + 3:
            dims[stacked + 2] = AXIS_MODEL
        if re.search(r"/(ckv|krope)$", path_str) and \
                len(shape) >= stacked + 3:
            if shape[stacked + 1] % msize == 0:
                dims[stacked + 1] = AXIS_MODEL
            else:
                dims[stacked + 2] = AXIS_MODEL
        return _guarded_spec(tuple(dims), shape, mesh)

    return _map_tree(caches, one)


def make_data_specs(batch_like: Any, mesh) -> Any:
    """Token/label/embedding inputs: batch dim on (pod, data)."""
    axes = tuple(a for a in (AXIS_POD, AXIS_DATA) if a in mesh.axis_names)
    baxis = axes if axes else None

    def one(_, leaf):
        shape = tuple(leaf.shape)
        dims = [None] * len(shape)
        if shape:
            dims[0] = baxis
        return _guarded_spec(tuple(dims), shape, mesh)

    return _map_tree(batch_like, one)


def _is_qmoment(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def make_train_state_specs(state: Any, mesh,
                           scfg: ShardingConfig | None = None) -> Any:
    """Specs for {"params", "opt": {"mu", "step"}[, "grad_error"]} (the
    reference's ZeRO-3): f32 moments take their parameter's spec; an int8
    moment's planes (``optimizer.QMoment``: the parameter reshaped to
    (*lead, last // b, b)) take it with the last dim's axis moved onto
    the block-count dim, each plane through the guard; ``grad_error``
    takes the parameter specs and ``step`` is replicated."""
    scfg = scfg or ShardingConfig(mode="train")
    pspecs = make_param_specs(state["params"], mesh, scfg)

    def moment(pspec, leaf):
        if not _is_qmoment(leaf):
            return pspec
        pdims = list(pspec) + [None] * (len(leaf.q.shape) - 1 - len(pspec))
        qdims = tuple(pdims[:-1]) + (pdims[-1] if pdims else None, None)
        return type(leaf)(*(_guarded_spec(qdims, tuple(x.shape), mesh)
                            for x in leaf))

    def walk(ps, mu):
        if isinstance(ps, tuple):
            return {"m": moment(ps, mu["m"]), "v": moment(ps, mu["v"])}
        if isinstance(ps, dict):
            return {k: walk(ps[k], mu[k]) for k in ps}
        return [walk(p, m) for p, m in zip(ps, mu)]

    out = {"params": pspecs,
           "opt": {"mu": walk(pspecs, state["opt"]["mu"]), "step": ()}}
    if "grad_error" in state:
        out["grad_error"] = pspecs
    return out


# ---------------------------------------------------------------------------
# What a training rank holds: its shard of every leaf under its spec.
# ---------------------------------------------------------------------------

def spec_axes(spec) -> tuple:
    """The mesh axes a spec splits over, dim by dim."""
    out = []
    for ax in spec:
        out.extend((ax,) if isinstance(ax, str) else tuple(ax or ()))
    return tuple(out)


def whole_shape(shape, spec, mesh) -> tuple:
    """The whole leaf's shape, from a shard's ``shape`` and its spec."""
    return tuple(d * _axis_total(mesh, ax) for d, ax in zip(shape, spec))


def shard_shape(shape, spec, mesh) -> tuple:
    return tuple(d // _axis_total(mesh, ax) for d, ax in zip(shape, spec))


def shard_leaf(t, spec, mesh, coords: dict | None = None):
    """The shard of the whole leaf ``t`` under ``spec`` of this rank (or
    of the rank at ``coords``): each split dim cut into the band of the
    rank's index along its axes (a copy, so the whole can be freed);
    ``t`` itself where nothing is split."""
    cut = t
    for dim, ax in enumerate(spec):
        if ax is not None and _axis_total(mesh, ax) > 1:
            per = cut.shape[dim] // _axis_total(mesh, ax)
            cut = cut.narrow(dim, mesh.axis_index(ax, coords) * per, per)
    return t if cut is t else cut.clone(memory_format=torch.contiguous_format)


def assemble(parts: list, spec, mesh):
    """The whole leaf from every rank's shard (``parts`` in rank order,
    as ``Mesh.gather_host`` gives them)."""
    whole = parts[0].new_empty(whole_shape(parts[0].shape, spec, mesh))
    for rank, part in enumerate(parts):
        coords = dict(zip(mesh.axis_names,
                          _unravel(rank, tuple(mesh.shape.values()))))
        view = whole
        for dim, ax in enumerate(spec):
            if ax is not None:
                view = view.narrow(dim, mesh.axis_index(ax, coords)
                                   * part.shape[dim], part.shape[dim])
        view.copy_(part)
    return whole


def gather_leaf(t, spec, mesh):
    """The whole leaf from this rank's shard ``t``: gathered over exactly
    the axes its spec names, dim by dim."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            t = mesh.all_gather(t, ax, dim=dim)
    return t


def data_split(spec, mesh) -> tuple | None:
    """(dim, axes) of the dim a parameter's spec splits over the data axes
    (pod, data), or None: a ZeRO-3 leaf has at most one ("F")."""
    for dim, ax in enumerate(spec):
        names = (ax,) if isinstance(ax, str) else tuple(ax or ())
        axes = tuple(a for a in names if a in (AXIS_POD, AXIS_DATA)
                     and mesh.shape.get(a, 1) > 1)
        if axes:
            return dim, axes
    return None


def model_dim(spec, mesh=None) -> int | None:
    """The dim of a leaf that is on ``model`` once its shard is gathered
    over the data axes alone (:func:`gather_leaf_data`): the dim its spec
    puts on ``model``, or None (the leaf is whole over ``model`` there:
    the rule does not split it, or ``_guarded_spec`` dropped ``M``)."""
    for dim, ax in enumerate(spec):
        names = (ax,) if isinstance(ax, str) else tuple(ax or ())
        if AXIS_MODEL in names and (mesh is None
                                    or mesh.shape.get(AXIS_MODEL, 1) > 1):
            return dim
    return None


def gather_leaf_data(t, spec, mesh):
    """This rank's shard ``t`` gathered over the data axes only: the rank
    keeps its ``model`` band of each ``(M, F)`` leaf (:func:`model_dim`)."""
    split = data_split(spec, mesh)
    return t if split is None else mesh.all_gather(t, split[1], split[0])


# Leaves whose ``model`` band a tensor-parallel training rank computes on:
# the rule's ("M", ...) dim is heads (q heads, kv heads) and must cut whole
# heads; FFN columns, experts and vocab rows are a band at any cut.
_TP_Q_HEADS = re.compile(r"(^|/)(attn|cross)/(wq|bq|wo|wq_b|wkv_b)$")
_TP_KV_HEADS = re.compile(r"(^|/)(attn|cross)/(wk|wv|bk|bv)$")
_TP_BAND = re.compile(r"(^|/)((mlp|shared)/(w_gate|w_up|w_down)"
                      r"|experts/(w_gate|w_up|w_down)"
                      r"|embed|dec_embed|lm_head)$")


def tp_keeps_band(path: str, spec, cfg, mesh) -> bool:
    """Whether a tensor-parallel training rank computes on its ``model``
    band of the leaf at ``path`` (a ``clean_keystr`` path) rather than on
    the leaf gathered whole over ``model`` too: heads where the model
    ranks divide them (wq/bq/wo and MLA's wq_b/wkv_b by q heads, wk/wv/bk/
    bv by kv heads), the FFN's columns, experts and vocab rows wherever
    the spec splits them.  Mamba2's in_proj/out_proj/conv are not: their
    output concatenates z, x, B, C and dt, so a band is not a head."""
    if model_dim(spec, mesh) is None:
        return False
    ms = mesh.shape[AXIS_MODEL]
    if _TP_Q_HEADS.search(path):
        return cfg.n_heads % ms == 0
    if _TP_KV_HEADS.search(path):
        return cfg.n_kv_heads % ms == 0
    return bool(_TP_BAND.search(path))


def flat_specs(specs: Any, like: Any) -> list:
    """The specs of ``like``'s leaves, in ``train.tree.flatten``'s order
    (``specs`` has ``like``'s structure, a spec tuple at each leaf)."""
    out: list = []

    def walk(s, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(s[k], node[k])
        elif _is_qmoment(node):
            for f in node._fields:
                walk(getattr(s, f), getattr(node, f))
        elif isinstance(node, (list, tuple)):
            for a, b in zip(s, node):
                walk(a, b)
        else:
            out.append(s)

    walk(specs, like)
    return out


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf of ``tree`` (whole) cut to this rank's shard."""
    from ..train import tree as T
    return T.unflatten(tree, [shard_leaf(x, s, mesh) for x, s in zip(
        T.leaves(tree), flat_specs(specs, tree))])


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf of ``tree`` (this rank's shards) gathered whole."""
    from ..train import tree as T
    return T.unflatten(tree, [gather_leaf(x, s, mesh) for x, s in zip(
        T.leaves(tree), flat_specs(specs, tree))])


# ---------------------------------------------------------------------------
# Gather on use: a training step's parameters, one block at a time.
# ---------------------------------------------------------------------------

class _Gathering:
    """One training step's gather-on-use state (:func:`gathering`)."""

    def __init__(self, mesh, specs, cfg, reduce: bool):
        self.mesh, self.specs, self.cfg, self.reduce = mesh, specs, cfg, reduce
        # id(shard) -> (shard, its data split, the dim gathered over model
        # too or None, whether the rank computes on its model band)
        self.plans: dict = {}
        self.memo: dict = {}        # id(shard) -> gathered, kept the step
        self.live = self.peak = 0   # gathered bytes alive, and their most

    def bind(self, tree) -> None:
        from ..train import tree as T
        self.plans, self.memo = {}, {}
        for (path, t), spec in zip(T.flatten(tree),
                                   flat_specs(self.specs, tree)):
            dim = model_dim(spec, self.mesh)
            band = dim is not None and tp_keeps_band(
                clean_keystr(path), spec, self.cfg, self.mesh)
            self.plans[id(t)] = (t, data_split(spec, self.mesh),
                                 None if band else dim, band)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def keeps_band(self, t) -> bool:
        """Whether :meth:`gather` gives the rank its model band of the
        bound shard ``t``."""
        plan = self.plans.get(id(t))
        return plan is not None and plan[0] is t and plan[3]

    def gather(self, t):
        plan = self.plans.get(id(t))
        if plan is None or plan[0] is not t:
            return t
        _, split, whole, _ = plan
        out = t
        if split is not None:
            out = gather_on_use(out, self.mesh, split[1], split[0],
                                  self.reduce)
        elif self.reduce:        # a leaf whole over data: its grads summed
            out = gather_on_use(out, self.mesh, data_axes(self.mesh),
                                  None)
        if whole is not None:
            out = gather_model(out, self.mesh, whole)
        if split is not None or whole is not None:   # a gathered copy
            nbytes = out.numel() * out.element_size()
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(out, self._free, nbytes)
        return out


_GATHERING: list = []
# the last step's most gathered-parameter bytes alive at once (a rank's)
GATHER_STATS = {"peak": 0}


@contextlib.contextmanager
def gathering(mesh, specs, cfg, *, reduce: bool = True):
    """While the block runs, a training rank's parameters are its ZeRO-3
    shards under ``specs`` (the parameters' spec tree), gathered where
    they are used (:func:`use`): over the data axes alone, keeping the
    rank's ``model`` band of each leaf that tensor-parallel compute reads
    as a band (:func:`tp_keeps_band`), gathered over ``model`` too
    otherwise.  The gradients reach the shards through the gathers'
    backward (``launch.mesh.gather_on_use``: reduce-scattered over the
    data ranks, or with ``reduce=False``, where every data rank computed
    the same rows, cut).  ``train.steps.loss_and_grads`` binds the leaves
    it differentiates (:func:`bind_gathering`).  → the state, whose
    ``peak`` (kept in ``GATHER_STATS`` when the block ends) is the most
    gathered-parameter bytes alive at once."""
    ctx = _Gathering(mesh, specs, cfg, reduce)
    _GATHERING.append(ctx)
    try:
        yield ctx
    finally:
        _GATHERING.pop()
        GATHER_STATS["peak"] = ctx.peak


def bind_gathering(tree) -> None:
    """Register ``tree`` (a tree of the parameters' structure, this rank's
    shards) with the enclosing :func:`gathering`, if any."""
    if _GATHERING:
        _GATHERING[-1].bind(tree)


class _Used(dict):
    """A block's parameters whose leaves are gathered at their first
    read (:func:`use`) and kept for the reads after it within the block."""

    def __init__(self, node, ctx):
        super().__init__(node)
        self._ctx, self._raw = ctx, node

    def __getitem__(self, k):
        v = super().__getitem__(k)
        if isinstance(v, dict) and not isinstance(v, _Used):
            v = _Used(v, self._ctx)
        elif isinstance(v, torch.Tensor):
            v = self._ctx.gather(v)
        else:
            return v
        super().__setitem__(k, v)
        return v

    def get(self, k, default=None):
        return self[k] if k in self else default


def use(node, *, keep: bool = False):
    """``node`` (a block's parameter dict, or one leaf) as the computation
    reads it inside :func:`gathering`: a leaf gathered at its first read
    (a dict's leaves lazily, so a leaf the block does not read is not
    gathered); ``node`` itself outside one.  Called inside a block's
    checkpointed body, the gathered band lives through that block's
    forward and again through its recompute and backward.  ``keep``: a
    leaf read in several places of the step (a tied embedding and head)
    is gathered once and kept for the step."""
    if not _GATHERING:
        return node
    ctx = _GATHERING[-1]
    if isinstance(node, dict):
        return _Used(node, ctx)
    if not isinstance(node, torch.Tensor):
        return node
    if keep:
        if id(node) not in ctx.memo:
            ctx.memo[id(node)] = ctx.gather(node)
        return ctx.memo[id(node)]
    return ctx.gather(node)


def kept_band(node, key) -> bool:
    """Whether the gather on use gives this training rank its ``model``
    band of ``node[key]`` (:func:`tp_keeps_band`, from the config and the
    mesh), read off the bound shard's plan without gathering it; False
    outside :func:`gathering`.  ``node``: a block's parameters as
    :func:`use` gives them, or the bound tree's dict that holds the leaf
    (the embedding, the head)."""
    if not _GATHERING:
        return False
    raw = node._raw if isinstance(node, _Used) else node
    return _GATHERING[-1].keeps_band(raw[key])


def tp_mesh():
    """(mesh, model ranks, this rank's model index) where a training step
    computes tensor-parallel over ``model`` (autograd records inside
    :func:`gathering` on a mesh of more than one model rank), else
    (None, 1, 0)."""
    if not _GATHERING or not torch.is_grad_enabled():
        return None, 1, 0
    mesh = _GATHERING[-1].mesh
    ms = mesh.shape.get(AXIS_MODEL, 1)
    if ms <= 1:
        return None, 1, 0
    return mesh, ms, mesh.axis_index(AXIS_MODEL)


# ---------------------------------------------------------------------------
# The mesh that the kernels' dispatch sees.
# ---------------------------------------------------------------------------

_ACTIVE_MESH: list = []


@contextlib.contextmanager
def active_mesh(mesh):
    """Make ``mesh`` (a ``launch.mesh.Mesh``, or None for none) the one
    :func:`current_mesh` returns while the block runs: the compressed
    matmuls then take their sharded branches (``kernels.ops``) and MoE
    its local routing."""
    if mesh is None:
        yield None
        return
    _ACTIVE_MESH.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.pop()


def current_mesh():
    """(axis_sizes, mesh) of the active mesh, or ({}, None)."""
    if _ACTIVE_MESH:
        m = _ACTIVE_MESH[-1]
        return dict(m.shape), m
    return {}, None


def constrain(x, *dims):
    """The reference's sharding constraint.  Outside a mesh a no-op, as
    there; inside one a no-op too: the layers hold each activation on the
    rank as its spec places it (see the module docstring)."""
    return x


_ROW_SPLIT: list = []


@contextlib.contextmanager
def rows_split(mesh, axes):
    """Mark the rows this block computes as one data rank's share of the
    batch, split over ``axes`` of ``mesh`` (a training step's microbatch,
    ``train/steps.py``; a served batch, ``serve/engine.py``): the global
    MoE then takes its capacity, slot ranks and aux loss over the whole
    batch (``layers.apply_moe``), and the local-routing MoE routes the
    rows it is given (``layers.apply_moe_local``).  A no-op where
    ``axes`` hold one rank."""
    if mesh is None or mesh.axis_size(axes) <= 1:
        yield None
        return
    _ROW_SPLIT.append((mesh, tuple(axes)))
    try:
        yield mesh
    finally:
        _ROW_SPLIT.pop()


def row_split():
    """(mesh, data axes) of the enclosing :func:`rows_split`, or None."""
    return _ROW_SPLIT[-1] if _ROW_SPLIT else None



# ---------------------------------------------------------------------------
# What each rank holds: the sharded kernels' in-specs.
# ---------------------------------------------------------------------------

def weight_axes(mesh) -> tuple:
    """The (pod, model) axes of size > 1: a weight's out-tile bands split
    over them (the reference's ``waxes``)."""
    return tuple(a for a in (AXIS_POD, AXIS_MODEL)
                 if mesh.shape.get(a, 1) > 1)


def placement_ok(w, mesh) -> bool:
    """Whether the reference's gates send this container through a
    ``shard_map`` branch on ``mesh`` (more than one rank): a tile-major
    ``PackedLinear`` whose out tiles split evenly over the weight axes,
    a ``TiledPackedLinear`` whose groups split over data and out tiles
    over model, an expert stack whose experts split over model (more than
    one model rank)."""
    from ..core.compressed import PackedLinear, TiledPackedLinear
    if mesh is None or mesh.size <= 1 or not getattr(w, "tile_n", 0):
        return False
    n = w.shape[0]
    msize = mesh.shape.get(AXIS_MODEL, 1)
    if isinstance(w, TiledPackedLinear):
        return (w.codes.ndim == 3
                and w.tiles % mesh.shape.get(AXIS_DATA, 1) == 0
                and (n // w.tile_n) % msize == 0)
    if isinstance(w, PackedLinear) and w.codes.ndim == 2:
        wsize = 1
        for a in weight_axes(mesh):
            wsize *= mesh.shape[a]
        return (n // w.tile_n) % wsize == 0
    if isinstance(w, PackedLinear) and w.codes.ndim == 3:
        return msize > 1 and w.codes.shape[0] % msize == 0
    return False


def batch_rows(mesh, b: int):
    """This rank's rows of a batch of ``b`` over (pod, data): a slice, or
    None where those axes hold one rank or do not divide ``b`` (every
    rank then serves all rows, as the reference's ``drow`` guard keeps
    them whole)."""
    if mesh is None:
        return None
    axes = data_axes(mesh)
    n = mesh.axis_size(axes)
    if n <= 1 or b % n:
        return None
    per = b // n
    i = mesh.axis_index(axes)
    return slice(i * per, (i + 1) * per)


def _model_size(mesh) -> int:
    return mesh.shape.get(AXIS_MODEL, 1) if mesh is not None else 1


def cache_positions_split(cfg, mesh) -> bool:
    """Whether a rank's attention caches hold a block of positions (MLA's
    latents, or K/V whose kv heads do not divide the model axis) rather
    than whole positions, on ``mesh``."""
    ms = _model_size(mesh)
    return ms > 1 and (bool(getattr(cfg, "mla", False))
                       or cfg.n_kv_heads % ms != 0)


def cache_len(cfg, max_len: int, mesh) -> int:
    """The positions a serving cache of ``max_len`` holds on ``mesh``:
    rounded up to a multiple of the model ranks where the ranks split the
    positions (each holds one contiguous block; the tail is masked as
    every cache's unwritten tail is)."""
    ms = _model_size(mesh)
    if cache_positions_split(cfg, mesh):
        return -(-max_len // ms) * ms
    return max_len


_SSM_LEAF = re.compile(r"(^|/)(ssm|conv)$")


def serve_cache_specs(caches: Any, mesh, *, rows: bool = True,
                      positions: bool = True) -> Any:
    """The share of each cache leaf a serving rank holds: the reference's
    :func:`make_cache_specs`, less what the port does not cut — the
    Mamba2 state and conv window stay whole on ``model`` (split over the
    batch axes only: their heads and channels are not a column band of
    ``in_proj``), an encoder–decoder's cross K/V split by heads or not at
    all, K/V (and their scales) by heads or positions and MLA's latents
    by positions, never by ``head_dim`` or latent width (kept whole where
    those alone divide).  ``rows=False`` keeps the batch axis whole (the
    engine's slots and pages, which every data rank holds);
    ``positions=False`` keeps the positions axis whole (the engine's
    pages, each already a rank's positions: ``serve/kv_cache.py``)."""
    specs = make_cache_specs(caches, mesh)

    def fix(path, spec):
        spec = list(spec)
        if not rows and spec:
            spec[0] = None
        if _SSM_LEAF.search(path):
            keep = ()
        elif re.search(r"(^|/)(enc_k|enc_v)(/\d+)?$", path):
            keep = (2,)
        elif re.search(r"(^|/)(k|v|k_scale|v_scale)$", path):
            keep = (1, 2)
        elif re.search(r"(^|/)(ckv|krope)$", path):
            keep = (1,)
        else:
            keep = ()
        if not positions:
            keep = tuple(i for i in keep if i != 1)
        return tuple(None if (ax == AXIS_MODEL and i not in keep) else ax
                     for i, ax in enumerate(spec))

    def walk(node, sp, path=""):
        if isinstance(node, dict):
            return {k: walk(node[k], sp[k], f"{path}/{k}" if path else k)
                    for k in node}
        if isinstance(node, list):
            return [walk(v, s, f"{path}/{i}" if path else str(i))
                    for i, (v, s) in enumerate(zip(node, sp))]
        return fix(path, sp)

    return walk(caches, specs)


def place_caches(caches: Any, mesh, *, rows: bool = True) -> Any:
    """Each rank's share of whole serving caches (:func:`serve_cache_specs`),
    as copies; the caches themselves where the mesh is one rank."""
    if mesh is None or mesh.size <= 1:
        return caches
    specs = serve_cache_specs(caches, mesh, rows=rows)

    def walk(node, sp):
        if isinstance(node, dict):
            return {k: walk(node[k], sp[k]) for k in node}
        if isinstance(node, list):
            return [walk(v, s) for v, s in zip(node, sp)]
        return shard_leaf(node, sp, mesh)

    return walk(caches, specs)


def zeros_share(caches: Any, mesh, device, *, rows: bool = True,
                positions: bool = True) -> Any:
    """Zero tensors of each rank's share of ``caches`` (whole caches on
    the ``meta`` device: shapes and dtypes alone), on ``device``."""
    specs = serve_cache_specs(caches, mesh, rows=rows, positions=positions)

    def walk(node, sp):
        if isinstance(node, dict):
            return {k: walk(node[k], sp[k]) for k in node}
        if isinstance(node, list):
            return [walk(v, s) for v, s in zip(node, sp)]
        return torch.zeros(shard_shape(tuple(node.shape), sp, mesh),
                           dtype=node.dtype, device=device)

    return walk(caches, specs)


_VOCAB_LEAVES = ("embed", "lm_head", "dec_embed")


def place_vocab(w, mesh):
    """An int8 embedding or head's vocab-row band on ``model`` (the
    reference's serve spec ``("V", ...)``: rows over model where they
    divide), as copies of ``values``, ``scale`` and ``zero``; ``w`` itself
    where the rows do not divide or ``w`` is not a ``QuantLinear``."""
    from ..core.compressed import QuantLinear
    ms = _model_size(mesh)
    if (not isinstance(w, QuantLinear) or w.mesh_axes is not None
            or ms <= 1 or w.values.ndim != 2 or w.values.shape[0] % ms):
        return w
    m = mesh.coords[AXIS_MODEL]
    return dataclasses.replace(
        w, **{p: _band(getattr(w, p), 0, m, ms)
              for p in ("values", "scale", "zero")},
        mesh_axes=(AXIS_MODEL,))


def _band(t, dim: int, index: int, count: int):
    per = t.shape[dim] // count
    return t.narrow(dim, index * per, per).contiguous().clone()


def place_container(w, mesh):
    """This rank's share of one weight container (see :func:`place_params`),
    or ``w`` itself where the gates keep it whole."""
    from ..core.compressed import TiledPackedLinear
    if not placement_ok(w, mesh):
        return w
    planes = ("codes", "literals", "nlit")
    n, k = w.shape
    if isinstance(w, TiledPackedLinear):
        axes = tuple(a for a in (AXIS_DATA, AXIS_MODEL)
                     if a in mesh.axis_names)
        dsize = mesh.shape.get(AXIS_DATA, 1)
        msize = mesh.shape.get(AXIS_MODEL, 1)
        d = mesh.coords.get(AXIS_DATA, 0)
        m = mesh.coords.get(AXIS_MODEL, 0)
        new = {p: _band(_band(getattr(w, p), 0, d, dsize), 1, m, msize)
               for p in planes}
        new.update({p: _band(getattr(w, p), 0, m, msize)
                    for p in ("scale", "zero")})
        return dataclasses.replace(w, **new, shape=(n // msize, k // dsize),
                                   mesh_axes=axes)
    if w.codes.ndim == 3:            # an expert stack: experts on model
        msize = mesh.shape[AXIS_MODEL]
        m = mesh.coords[AXIS_MODEL]
        return dataclasses.replace(
            w, **{p: _band(getattr(w, p), 0, m, msize)
                  for p in planes + ("scale", "zero")},
            mesh_axes=(AXIS_MODEL,))
    waxes = weight_axes(mesh)
    wsize = mesh.axis_size(waxes)
    i = mesh.axis_index(waxes)
    return dataclasses.replace(
        w, **{p: _band(getattr(w, p), 0, i, wsize)
              for p in planes + ("scale", "zero")},
        shape=(n // wsize, k), mesh_axes=waxes)


def place_params(params: Any, mesh) -> Any:
    """Each rank's share of a served tree on ``mesh``: the planes the
    sharded kernels read, as the reference's ``shard_map`` in-specs give
    them to a device — a ``PackedLinear``'s out-tile bands over the
    (pod, model) ranks (the rows of codes, literals, nlit, scale and
    zero), a ``TiledPackedLinear``'s column groups over data and out-tile
    bands over model, an expert stack's experts over model — and the
    int8 ``embed``, ``lm_head`` and ``dec_embed`` as their vocab-row band
    on model (:func:`place_vocab`, the serve specs' rows; K5 reads the
    stored band).  A placed container records the axes in ``mesh_axes``
    and holds the rank's ``shape``; the planes are copies, so the whole
    ones can be freed.  Every other leaf (dense weights, norms, the other
    int8 weights, whose K5 bands are views taken at each call, and the
    LUT) stays replicated."""
    if mesh is None or mesh.size <= 1:
        return params

    def walk(node, top=False):
        if isinstance(node, dict):
            return {k: (place_vocab(v, mesh) if top and k in _VOCAB_LEAVES
                        else walk(v)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return place_container(node, mesh)

    return walk(params, top=True)


def gather_container(w, dense, mesh):
    """A placed container's dense weight (``dense``: its local one)
    gathered back to the whole: rows over the weight axes, experts over
    model, a tiled weight's columns over data and rows over model."""
    from ..core.compressed import TiledPackedLinear
    if mesh is None:
        raise ValueError("a mesh rank's share of a weight needs its mesh "
                         "active (sharding.partition.active_mesh)")
    if isinstance(w, TiledPackedLinear):
        dense = mesh.all_gather(dense, AXIS_DATA, dim=-1)
        return mesh.all_gather(dense, AXIS_MODEL, dim=-2)
    if w.codes.ndim == 3:
        return mesh.all_gather(dense, w.mesh_axes, dim=0)
    return mesh.all_gather(dense, w.mesh_axes, dim=-2)
