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

Serving: what a rank holds is not this table.  The port places the
planes that the sharded kernels read as their ``shard_map`` in-specs give
them (:func:`place_params`), and keeps every other leaf replicated.
``constrain`` is a no-op outside a mesh, as in the reference, and inside
one too: served activations stay replicated over ``model`` and their rows
are not split over ``data`` (by design: ROADMAP.md queue 3, "Not port
faults", serving on a mesh — a plain product's bits follow its row
count).

Training (``train/steps.py``) is the port's ZeRO-3: each rank stores its
shard of every leaf of the train state under
:func:`make_train_state_specs` (:func:`shard_leaf`: major-first over a
tuple of axes, as :func:`place_params` cuts bands), gathers the whole
parameters for a step (:func:`gather_leaf`), and computes the rows of its
data rank (:func:`rows_split` marks them split for the MoE's global
statistics); the ``model`` axis splits storage only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any

import torch

from ..launch.mesh import AXIS_DATA, AXIS_MODEL, AXIS_POD, _unravel


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
    a list of per-layer caches, which have no stacked dim."""
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
        if re.search(r"(^|/)(k|v|enc_k|enc_v)$", path_str) and \
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
    there; inside one a no-op too: the port keeps activations replicated
    on every rank of a serving mesh (see the module docstring)."""
    return x


_ROW_SPLIT: list = []


@contextlib.contextmanager
def rows_split(mesh, axes):
    """Mark the rows this block computes as one data rank's share of each
    microbatch, split over ``axes`` of ``mesh`` (a training step on a
    mesh, ``train/steps.py``): the MoE then takes its capacity, slot
    ranks and aux loss over the whole microbatch (``layers.apply_moe``).
    A no-op where ``axes`` hold one rank."""
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
    bands over model, an expert stack's experts over model.  A placed
    container records the axes in ``mesh_axes`` and holds the rank's
    ``shape``; the planes are copies, so the whole ones can be freed.
    Every other leaf (dense weights, norms, embeddings, int8 weights,
    whose K5 bands are views taken at each call, and the LUT) stays
    replicated in this slice."""
    if mesh is None or mesh.size <= 1:
        return params

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return place_container(node, mesh)

    return walk(params)


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
