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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

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


def _q_moment(x: torch.Tensor, block: int) -> QMoment:
    *lead, last = x.shape
    b = moment_block(last, block)
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
            mus.append({"m": _q_moment(z, cfg.qblock),
                        "v": _q_moment(z, cfg.qblock)})
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


def global_norm(tree: Any) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in T.leaves(tree)]
    return torch.sqrt(sum(sq))


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig):
    """One AdamW step → (new_params, new_state, metrics); nothing is
    updated in place (the caller's state stays as it was)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
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
    new_p, new_mu = [], []
    for (path, p), g, mu in zip(flat_p, flat_g, mus):
        gf = g.to(torch.float32) * clip
        quantized = isinstance(mu["m"], QMoment)
        m_prev = _dq_moment(mu["m"], p.shape) if quantized else mu["m"]
        v_prev = _dq_moment(mu["v"], p.shape) if quantized else mu["v"]
        m = cfg.b1 * m_prev + (1 - cfg.b1) * gf
        v = cfg.b2 * v_prev + (1 - cfg.b2) * gf * gf
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if len(T.stacked_shape(path, p, nb)) >= 2:
            # decoupled weight decay on matrices (stacked shapes) only
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * upd).to(p.dtype))
        new_mu.append({"m": _q_moment(m, cfg.qblock),
                       "v": _q_moment(v, cfg.qblock)} if quantized
                      else {"m": m, "v": v})
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
