"""Training step functions — loss, gradients, optimizer, gradient
compression.

Counterpart of ``repro/train/steps.py`` for every family the port serves:
dense, MoE (with the load-balance aux loss), SSM, hybrid, VLM (the logits
past the batch's ``embeds`` prefix) and the encoder–decoder (the batch's
``enc_embeds`` through the encoder; ``models/encdec.py``).  The
step is eager PyTorch: gradients by ``torch.autograd`` through the model's
forward, where the attention is K2 under its ``autograd.Function`` (the
kernel forward, the plain version's backward: ``kernels/flash_attention
.py``).  ``chunked_cross_entropy`` recomputes each chunk's logits in the
backward (``torch.utils.checkpoint``, the port's ``jax.checkpoint``);
``compress_grads_int8`` is the int8 + error-feedback wire format;
``accum_steps`` accumulates the gradients of microbatches.

State is ``{"params", "opt", ["grad_error"]}``; a step returns a new state
and leaves the one it was given as it was.  Parameters live where the
caller put them (the card unless the caller asked for the CPU:
``models.lm.init_lm``); each batch moves to their device.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..models import encdec as ED
from ..models import lm as LM
from . import tree as T
from .optimizer import AdamWConfig, _fma, _recip, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    z_loss: float = 1e-4
    moe_aux_weight: float = 1e-2
    grad_compression: str = "none"      # none | int8_ef
    param_dtype: Any = torch.float32
    logits_chunk: int = 0               # 0 = no chunking
    accum_steps: int = 1                # gradient-accumulation microbatches
    accum_dtype: Any = torch.float32    # the gradient accumulator's dtype


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean CE with optional z-loss; logits (B, T, V), labels
    (B, T)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    ce = torch.mean(lse - ll)
    if z_loss:
        ce = ce + z_loss * torch.mean(lse ** 2)
    return ce


def _chunk_sums(h, head, lab, softcap: float):
    """Σ(lse − ll) and Σ lse² over one (B, c) chunk."""
    logits = torch.einsum("bcd,vd->bcv", h.to(torch.float32),
                          head.to(torch.float32))
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
    return torch.sum(lse - ll), torch.sum(lse ** 2)


def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int,
                          z_loss: float = 0.0,
                          softcap: float = 0.0) -> torch.Tensor:
    """CE without materializing (B, T, V) logits: sequence chunks of
    ``chunk`` (the largest divisor of T not above it), each one's (B, c,
    V) logits reduced to two sums and recomputed in the backward
    (``torch.utils.checkpoint``).  hidden (B, T, d); head (V, d); labels
    (B, T)."""
    b, t, _ = hidden.shape
    c = min(chunk, t)
    while t % c:
        c -= 1
    ce_sum = hidden.new_zeros((), dtype=torch.float32)
    z_sum = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, t, c):
        args = (hidden[:, i:i + c], head, labels[:, i:i + c], softcap)
        if torch.is_grad_enabled():
            ce, z = checkpoint(_chunk_sums, *args, use_reentrant=False)
        else:
            ce, z = _chunk_sums(*args)
        ce_sum, z_sum = ce_sum + ce, z_sum + z
    n = _recip(b * t, hidden.device)
    out = ce_sum * n
    if z_loss:
        out = out + z_loss * (z_sum * n)
    return out


def _loss_fn(params, cfg, tcfg: TrainConfig, batch):
    fam = cfg.family
    chunked = tcfg.logits_chunk > 0
    if fam == "encdec":
        out, _ = ED.forward(params, cfg, batch["enc_embeds"],
                            batch["tokens"], return_hidden=chunked)
        aux = 0.0
    else:
        out, _, aux = LM.forward(params, cfg, batch["tokens"],
                                 embeds=batch.get("embeds"),
                                 return_hidden=chunked)
        if fam == "vlm" and batch.get("embeds") is not None:
            out = out[:, batch["embeds"].shape[1]:]
    if chunked:
        head = params["lm_head"] if "lm_head" in params else params["embed"]
        loss = chunked_cross_entropy(out, head, batch["labels"],
                                     chunk=tcfg.logits_chunk,
                                     z_loss=tcfg.z_loss,
                                     softcap=cfg.logits_softcap)
    else:
        loss = cross_entropy(out, batch["labels"], tcfg.z_loss)
    if cfg.is_moe:
        loss = loss + tcfg.moe_aux_weight * aux
    return loss


def compress_grads_int8(grads, error_fb):
    """int8 gradient compression with error feedback (per-tensor affine):
    quantize g + e to uint8, dequantize for the update, keep the residual
    as the next step's feedback.  → (dequantized grads, new feedback).

    A tensor is a leaf of the reference's layout, where a ``blocks`` leaf
    (an encoder–decoder's ``encoder`` and ``decoder`` leaves too) stacks
    every layer: the port's layers of one such leaf share one (min, max),
    so the codes are the reference's."""
    flat, errs = T.flatten(grads), T.leaves(error_fb)
    gfs = [g.to(torch.float32) + e for (_, g), e in zip(flat, errs)]
    groups: dict = {}
    for i, (path, _) in enumerate(flat):
        groups.setdefault(re.sub(r"^\['(blocks|encoder|decoder)'\]\[\d+\]",
                                 r"['\1']", path), []).append(i)
    dq, fb = [None] * len(gfs), [None] * len(gfs)
    for idx in groups.values():
        mn = torch.stack([torch.min(gfs[i]) for i in idx]).min()
        mx = torch.stack([torch.max(gfs[i]) for i in idx]).max()
        scale = torch.clamp((mx - mn) * _recip(255.0, mn.device), min=1e-12)
        for i in idx:
            q = torch.clamp(torch.round((gfs[i] - mn) / scale), 0, 255)
            d = _fma(q, scale, mn)
            dq[i], fb[i] = d.to(flat[i][1].dtype), gfs[i] - d
    return T.unflatten(grads, dq), T.unflatten(grads, fb)


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_and_grads(params, cfg, tcfg: TrainConfig, batch):
    """The loss of one (micro)batch and its gradients, a list in the
    parameters' leaf order (``tree.leaves``); a parameter the loss does
    not reach gets zeros.  The counterpart of ``jax.value_and_grad``
    over the reference's loss."""
    flat = T.leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = _loss_fn(T.unflatten(params, live), cfg, tcfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(flat, grads)]


def make_train_step(cfg, tcfg: TrainConfig):
    """→ ``train_step(state, batch) -> (state, metrics)``; metrics
    {"loss", "grad_norm", "lr"} are 0-d tensors on the parameters'
    device (nothing is read on the host)."""
    use_ef = tcfg.grad_compression == "int8_ef"

    def grads_of(params, batch):
        """Loss and gradients; with ``accum_steps`` > 1 the batch splits
        on its leading dim and the microbatches' gradients are summed in
        ``accum_dtype``, then averaged (one microbatch's activations live
        at a time)."""
        a = tcfg.accum_steps
        if a <= 1:
            loss, grads = loss_and_grads(params, cfg, tcfg, batch)
            return loss, T.unflatten(params, grads)
        b = batch["tokens"].shape[0]
        if b % a:
            raise ValueError(f"batch {b} does not split into {a} "
                             "microbatches")
        acc = [torch.zeros(p.shape, dtype=tcfg.accum_dtype, device=p.device)
               for p in T.leaves(params)]
        lsum = None
        for i in range(a):
            mb = {k: v[i * (b // a):(i + 1) * (b // a)]
                  for k, v in batch.items()}
            loss, grads = loss_and_grads(params, cfg, tcfg, mb)
            acc = [x + g.to(x.dtype) for x, g in zip(acc, grads)]
            lsum = loss if lsum is None else lsum + loss
        inv = _recip(a, lsum.device)
        return lsum * inv, T.unflatten(params, [x * inv for x in acc])

    def train_step(state, batch):
        params = state["params"]
        device = T.leaves(params)[0].device
        loss, grads = grads_of(params, _on(batch, device))
        if use_ef:
            grads, new_err = compress_grads_int8(grads, state["grad_error"])
        new_params, new_opt, om = adamw_update(params, grads, state["opt"],
                                               tcfg.optimizer)
        new_state = {"params": new_params, "opt": new_opt}
        if use_ef:
            new_state["grad_error"] = new_err
        return new_state, {"loss": loss, **om}

    return train_step


def init_train_state(params, tcfg: TrainConfig) -> dict:
    state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
    if tcfg.grad_compression == "int8_ef":
        state["grad_error"] = T.map_leaves(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state
