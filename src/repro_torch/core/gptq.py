"""GPTQ — data-dependent post-training quantization (paper §3, ref [3]).

Counterpart of ``repro/core/gptq.py``, the same solver:

  * accumulate the layer Hessian H = 2 Σ x xᵀ over calibration batches,
  * dampen (H += λ·mean(diag)·I), invert, and take the upper Cholesky
    factor U of the inverse (Hinv = Uᵀ U),
  * walk the columns one at a time: quantize the column on the per-row
    grid, and move its error, weighted by U's row, onto the columns not
    yet quantized.

The walk runs as torch ops on the weight's device (the reference's
``lax.fori_loop`` body, column by column); the inverse and the Cholesky
factor are ``torch.linalg`` calls, as the reference's are ``jnp.linalg``,
taken in f64: in f32 the inverse's roundoff can leave a near-singular
Hessian's short of positive definite (torch's factorization then raises;
JAX's returns NaN).
Weights are quantized row-wise (a per-channel grid fixed before the walk).
"""
from __future__ import annotations

import torch

from .quant import QuantConfig, QuantizedTensor, dequantize


def init_hessian(in_features: int, device=None) -> torch.Tensor:
    return torch.zeros((in_features, in_features), dtype=torch.float32,
                       device=device)


def accumulate_hessian(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Streaming Hessian update.  x: (..., in_features) activations."""
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    return h + 2.0 * (x2.T @ x2)


def _find_grid(w: torch.Tensor, maxq: int, symmetric: bool):
    """Per-row (scale, zero) over the whole weight (GPTQ keeps the grid
    fixed while the values move).  The range is multiplied by maxq's f32
    reciprocal: the reference's solver runs jitted, and XLA turns its
    division by the constant maxq into that product (an ulp apart from
    the quotient, which moves a code at a rounding boundary)."""
    xmin = torch.clamp(w.amin(dim=1), max=0.0)
    xmax = torch.clamp(w.amax(dim=1), min=0.0)
    if symmetric:
        m = torch.maximum(xmin.abs(), xmax.abs())
        xmin, xmax = -m, m
    scale = (xmax - xmin) * torch.reciprocal(torch.tensor(
        float(maxq), dtype=torch.float32, device=w.device))
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    return scale[:, None], torch.round(-xmin / scale)[:, None]


@torch.no_grad()
def gptq_quantize(w: torch.Tensor, hessian: torch.Tensor, cfg: QuantConfig,
                  percdamp: float = 0.01) -> QuantizedTensor:
    """Run the GPTQ solver on one (out_features, in_features) weight with
    its (in, in) Hessian (:func:`accumulate_hessian`).  ``cfg``: bits and
    symmetric are honoured; the grid is per channel (rows).  → a
    :class:`QuantizedTensor` laid out as ``QuantConfig(granularity=
    'per_channel')``'s."""
    out_f, in_f = w.shape
    maxq = cfg.maxq
    wf = w.to(torch.float32).clone()
    hessian = hessian.to(torch.float32)

    # dead columns (no calibration signal): a unit diagonal, a zero weight
    dead = torch.diagonal(hessian) == 0.0
    h = hessian + torch.diag(dead.to(torch.float32))
    wf = wf * (~dead)[None, :]
    damp = percdamp * torch.mean(torch.diagonal(h))
    h = h + damp * torch.eye(in_f, dtype=torch.float32, device=h.device)

    # the upper factor U of Hinv = Uᵀ U is the lower factor's transpose;
    # inverted and factorized in f64: a Hessian of fewer calibration
    # tokens than columns is singular but for the damping, and in f32
    # the inverse's roundoff can leave it short of positive definite
    # (Llama-3.2-1B's layer 0 on the H100 did, at order 2046 of 2048)
    u = torch.linalg.cholesky(torch.linalg.inv(h.to(torch.float64))
                              ).T.to(torch.float32)
    scale, zero = _find_grid(wf, maxq, cfg.symmetric)
    s, z = scale[:, 0], zero[:, 0]
    q = torch.empty_like(wf)
    for i in range(in_f):
        col = wf[:, i]
        qi = torch.clamp(torch.round(col / s) + z, 0, maxq)
        dq = s * (qi - z)
        err = (col - dq) / u[i, i]
        # w[:, j > i] -= err ⊗ u[i, j > i]; column i frozen at dq
        wf[:, i + 1:] -= err[:, None] * u[i, i + 1:][None, :]
        wf[:, i] = dq
        q[:, i] = qi
    return QuantizedTensor(q.to(cfg.storage_dtype), scale, zero,
                           tuple(w.shape), w.dtype, cfg.bits,
                           ("per_channel", 0, cfg.group_size, (out_f, in_f)))


def gptq_layer_error(w: torch.Tensor, qt: QuantizedTensor,
                     hessian: torch.Tensor) -> torch.Tensor:
    """The proxy objective GPTQ minimizes: tr((W − Ŵ) H (W − Ŵ)ᵀ)."""
    dw = w.to(torch.float32) - dequantize(qt).to(torch.float32)
    return torch.trace(dw @ hessian.to(torch.float32) @ dw.T)


def calibrate_and_quantize(w: torch.Tensor, xs: list, cfg: QuantConfig,
                           percdamp: float = 0.01) -> QuantizedTensor:
    """Stream calibration activations into the Hessian, then solve."""
    h = init_hessian(w.shape[1], device=w.device)
    for x in xs:
        h = accumulate_hessian(h, x)
    return gptq_quantize(w, h, cfg, percdamp)
