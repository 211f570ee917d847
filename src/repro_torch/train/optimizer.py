"""AdamW with an int8-quantized-state variant.

Counterpart of ``repro/train/optimizer.py``, in plain tensor code with
explicit dtypes.  The int8 variant quantizes each Adam moment per block
of ``moment_block`` values along the parameter's last dim (affine uint8,
the paper's quantizer pointed at training state), re-quantized from fresh
f32 values each step.

The reference stacks ``params['blocks']``' layers (an encoder–decoder's
``encoder`` and ``decoder``) on a leading axis and decides by that stacked
shape which leaves take weight decay (≥ 2-D) and which have int8 moments
(:func:`quantizable`); the port, which keeps lists of layers, decides by
the same stacked shape (``tree.stacked_shape``), so the two make the same
choices leaf for leaf (a layer's norm weight is decayed, the final norm's
is not).  The
reference runs the update jitted, where XLA turns a division by a
constant into a product by its f32 reciprocal and a dequantize's
q·scale + zero into one fused multiply-add; the port computes those the
same way (``_recip``, ``_fma``), so that int8 codes, which flip at a
rounding boundary, see the reference's bits.

On a mesh of ranks (``train/steps.py``) each rank passes its shards of
the parameters, gradients and moments with their specs
(``sharding.partition.make_train_state_specs``): the norm counts each
element of the whole tree once, every per-leaf decision reads the whole
leaf's stacked shape, and a leaf updates on its shard wherever its
moment's blocks stay whole there (:func:`adamw_update`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..sharding import partition as PT
from . import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized_state: bool = False    # int8 moments
    qblock: int = 256
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class QMoment(NamedTuple):
    """int8 moment payload + per-block affine params, blocked along the
    parameter's last dim: ``q`` (*lead, last // block, block) uint8,
    ``scale`` and ``zero`` (*lead, last // block, 1) f32."""
    q: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor


def moment_block(last_dim: int, block: int) -> int:
    """Largest block ≤ ``block`` dividing ``last_dim`` (power-of-2 search)."""
    b = min(block, last_dim)
    while last_dim % b:
        b //= 2
    return max(b, 1)


def quantizable(p, cfg: AdamWConfig, shape: tuple | None = None) -> bool:
    """Whether a parameter of ``shape`` (default its own; the tree walks
    pass the stacked shape) keeps int8 moments."""
    shape = tuple(p.shape) if shape is None else tuple(shape)
    return (cfg.quantized_state and len(shape) >= 2 and shape[-1] >= 8
            and math.prod(shape) >= cfg.qblock)


def _recip(c: float, device) -> torch.Tensor:
    return torch.reciprocal(torch.tensor(float(c), dtype=torch.float32,
                                         device=device))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once to f32: the fused multiply-add XLA emits for
    the reference's jitted dequantize (q·scale + zero), formed in f64,
    where the product of an 8-bit code and an f32 scale is exact."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def _q_moment(x: torch.Tensor, b: int) -> QMoment:
    """``x`` in blocks of ``b`` along its last dim (``moment_block`` of
    the whole leaf's last dim)."""
    *lead, last = x.shape
    rows = x.reshape(*lead, last // b, b).to(torch.float32)
    mn = rows.amin(dim=-1, keepdim=True)
    mx = rows.amax(dim=-1, keepdim=True)
    scale = torch.clamp((mx - mn) * _recip(255.0, x.device), min=1e-12)
    q = torch.clamp(torch.round((rows - mn) / scale), 0, 255)
    return QMoment(q.to(torch.uint8), scale, mn)


def _dq_moment(qm: QMoment, shape) -> torch.Tensor:
    return _fma(qm.q, qm.scale, qm.zero).reshape(shape)


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    """{"mu": a {"m", "v"} per parameter (f32, or QMoments), "step": 0}."""
    nb = T.stack_counts(params)
    mus = []
    for path, p in T.flatten(params):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if quantizable(p, cfg, T.stacked_shape(path, p, nb)):
            b = moment_block(p.shape[-1], cfg.qblock)
            mus.append({"m": _q_moment(z, b), "v": _q_moment(z, b)})
        else:
            mus.append({"m": z, "v": z.clone()})
    flat = T.leaves(params)
    return {"mu": T.unflatten(params, mus),
            "step": torch.zeros((), dtype=torch.int32,
                                device=flat[0].device if flat else "cpu")}


def lr_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_frac``, in f32 (``step``
    an int or a 0-d tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    dev = step.device
    warm = torch.clamp(step * _recip(max(cfg.warmup_steps, 1), dev),
                       max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) * _recip(
        max(cfg.total_steps - cfg.warmup_steps, 1), dev), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Any, specs: Any = None, mesh=None) -> torch.Tensor:
    """‖tree‖₂ over all leaves in f32.  On a mesh (``tree`` this rank's
    shards, ``specs`` their spec tree) each leaf's sum of squares over its
    shard is added over exactly the ranks the leaf is split over, in rank
    order, so every element of the whole tree counts once (a replica not
    again) and every rank gets the same bits."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in T.leaves(tree)]
    if mesh is not None and mesh.size > 1:
        groups: dict = {}
        for i, spec in enumerate(PT.flat_specs(specs, tree)):
            groups.setdefault(PT.spec_axes(spec), []).append(i)
        for axes, idx in groups.items():
            if axes:
                whole = mesh.psum(torch.stack([sq[i] for i in idx]), axes)
                for j, i in enumerate(idx):
                    sq[i] = whole[j]
    return torch.sqrt(sum(sq))


def _leaf_update(p, g, mu, *, b, decay, clip, lr, b1c, b2c,
                 cfg: AdamWConfig):
    """One leaf's AdamW update (whole, or a shard whose moment blocks are
    whole) → (new parameter, new {"m", "v"})."""
    gf = g.to(torch.float32) * clip
    quantized = isinstance(mu["m"], QMoment)
    m_prev = _dq_moment(mu["m"], p.shape) if quantized else mu["m"]
    v_prev = _dq_moment(mu["v"], p.shape) if quantized else mu["v"]
    m = cfg.b1 * m_prev + (1 - cfg.b1) * gf
    v = cfg.b2 * v_prev + (1 - cfg.b2) * gf * gf
    upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    if decay:
        # decoupled weight decay on matrices (stacked shapes) only
        upd = upd + cfg.weight_decay * p.to(torch.float32)
    new_p = (p.to(torch.float32) - lr * upd).to(p.dtype)
    if quantized:
        return new_p, {"m": _q_moment(m, b), "v": _q_moment(v, b)}
    return new_p, {"m": m, "v": v}


def _planes(mu: dict, specs: dict, fn) -> dict:
    """``fn(plane, spec)`` over each QMoment plane of {"m", "v"}."""
    return {k: QMoment(*(fn(x, s) for x, s in zip(mu[k], specs[k])))
            for k in ("m", "v")}


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                 *, specs: Any = None, mesh=None):
    """One AdamW step → (new_params, new_state, metrics); nothing is
    updated in place (the caller's state stays as it was).

    On ``mesh`` (more than one rank), ``params``, ``grads`` and ``state``
    are this rank's shards under ``specs`` (the train state's): the norm
    is the whole tree's (:func:`global_norm`); weight decay, int8 moments
    and the moment block follow the whole leaf's stacked shape; a leaf
    updates on its shard (elementwise, and an int8 moment whose
    block-count dim is split as its parameter's last dim keeps whole
    blocks), except where the guard split the parameter but not its
    int8 moment: that leaf is gathered, updated as one device would, and
    the rank keeps its part."""
    sharded = mesh is not None and mesh.size > 1
    step = state["step"] + 1
    gnorm = global_norm(grads, specs["params"] if sharded else None,
                        mesh if sharded else None)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    lr = lr_schedule(step, cfg)
    stepf = step.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=stepf.device)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, **f32), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, **f32), stepf)
    nb = T.stack_counts(params)
    flat_p = T.flatten(params)
    flat_g = T.leaves(grads)
    mus = _mu_list(state["mu"], params)
    pspecs = PT.flat_specs(specs["params"], params) if sharded else None
    mspecs = _mu_list(specs["opt"]["mu"], params) if sharded else None
    new_p, new_mu = [], []
    for i, ((path, p), g, mu) in enumerate(zip(flat_p, flat_g, mus)):
        shape = (PT.whole_shape(p.shape, pspecs[i], mesh) if sharded
                 else tuple(p.shape))
        kw = dict(b=moment_block(shape[-1], cfg.qblock) if shape else 1,
                  decay=len(T.stacked_shape(path, shape, nb)) >= 2,
                  clip=clip, lr=lr, b1c=b1c, b2c=b2c, cfg=cfg)
        if (sharded and isinstance(mu["m"], QMoment)
                and tuple(mspecs[i]["m"].q[:-1]) != tuple(pspecs[i])):
            spec, ms = pspecs[i], mspecs[i]
            p_new, mu_new = _leaf_update(
                PT.gather_leaf(p, spec, mesh), PT.gather_leaf(g, spec, mesh),
                _planes(mu, ms, lambda x, s: PT.gather_leaf(x, s, mesh)),
                **kw)
            p_new = PT.shard_leaf(p_new, spec, mesh)
            mu_new = _planes(mu_new, ms,
                             lambda x, s: PT.shard_leaf(x, s, mesh))
        else:
            p_new, mu_new = _leaf_update(p, g, mu, **kw)
        new_p.append(p_new)
        new_mu.append(mu_new)
    return (T.unflatten(params, new_p),
            {"mu": T.unflatten(params, new_mu), "step": step},
            {"grad_norm": gnorm, "lr": lr})


def _mu_list(mu_tree: Any, params: Any) -> list:
    """The {"m", "v"} dicts of ``mu_tree`` in ``params``' leaf order."""
    out = []

    def walk(mu, p):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(mu[k], p[k])
        elif isinstance(p, (list, tuple)):
            for a, b in zip(mu, p):
                walk(a, b)
        else:
            out.append(mu)

    walk(mu_tree, params)
    return out
