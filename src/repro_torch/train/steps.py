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

On a mesh of ranks (``make_train_step(cfg, tcfg, mesh, specs)``, the
reference's jitted step under ``make_train_state_specs`` shardings) each
rank stores its shard of every leaf of the state (ZeRO-3) and, each step,
runs forward and backward on its data rank's share of each microbatch
(:func:`data_rows`) with each block's leaves gathered over the data axes
where they are used (``sharding.partition.gathering``), computes
tensor-parallel over ``model`` on its bands (heads, FFN columns, experts,
the vocab of the embedding, head and loss), gets its shard of the
gradients summed over the data axes from the gathers' backward (a
reduce-scatter) and updates it (``optimizer.adamw_update`` on shards).
The loss and the metrics are the global ones, the same bits on every
rank.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..launch import mesh as M
from ..models import encdec as ED
from ..models import lm as LM
from ..sharding import partition as PT
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


def _lse_ll(logits: torch.Tensor, labels: torch.Tensor, band):
    """(lse, the label's logit) over the last dim of f32 ``logits``.
    ``band`` (mesh, this rank's model index), where ``logits`` are a
    tensor-parallel rank's vocab band: lse from the max over model and the
    sum of exps over model (``reduce_from_model``), the label's logit
    from the rank whose band holds it (zeros elsewhere, summed)."""
    if band is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return lse, ll
    mesh, m = band
    vl = logits.shape[-1]
    mx = mesh.pmax(logits.detach().amax(dim=-1), M.AXIS_MODEL)
    s = M.reduce_from_model(torch.exp(logits - mx[..., None]).sum(dim=-1),
                            mesh)
    lse = mx + torch.log(s)
    local = labels.long() - m * vl
    mine = (local >= 0) & (local < vl)
    ll = torch.gather(logits, -1, torch.where(
        mine, local, torch.zeros_like(local))[..., None])[..., 0]
    ll = M.reduce_from_model(torch.where(mine, ll, torch.zeros_like(ll)),
                             mesh)
    return lse, ll


def _vocab_band(params, key):
    """(mesh, model index) where ``params[key]`` (the LM head, or the tied
    embedding) is given to a tensor-parallel training rank as its vocab
    band (``partition.kept_band``), else None."""
    mesh, _, m = PT.tp_mesh()
    return (mesh, m) if PT.kept_band(params, key) else None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0, band=None) -> torch.Tensor:
    """Token-mean CE with optional z-loss; logits (B, T, V), labels
    (B, T).  ``band``: the logits are a tensor-parallel rank's vocab band
    (:func:`_lse_ll`)."""
    lse, ll = _lse_ll(logits.to(torch.float32), labels, band)
    ce = torch.mean(lse - ll)
    if z_loss:
        ce = ce + z_loss * torch.mean(lse ** 2)
    return ce


def _chunk_sums(h, head, lab, softcap: float, band=None):
    """Σ(lse − ll) and Σ lse² over one (B, c) chunk (``band``: ``head`` is
    a tensor-parallel rank's vocab band, ``h`` its input)."""
    if band is not None:
        h = M.copy_to_model(h, band[0])
    logits = torch.einsum("bcd,vd->bcv", h.to(torch.float32),
                          head.to(torch.float32))
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    lse, ll = _lse_ll(logits, lab, band)
    return torch.sum(lse - ll), torch.sum(lse ** 2)


def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int,
                          z_loss: float = 0.0, softcap: float = 0.0,
                          band=None) -> torch.Tensor:
    """CE without materializing (B, T, V) logits: sequence chunks of
    ``chunk`` (the largest divisor of T not above it), each one's (B, c,
    V) logits reduced to two sums and recomputed in the backward
    (``torch.utils.checkpoint``).  hidden (B, T, d); head (V, d); labels
    (B, T).  ``band`` (mesh, model index): ``head`` is a tensor-parallel
    training rank's vocab band (:func:`_vocab_band`), each chunk's logits
    then (B, c, V/model), the reference's logits slice pinned to the vocab
    band (:func:`_lse_ll`)."""
    b, t, _ = hidden.shape
    c = min(chunk, t)
    while t % c:
        c -= 1
    ce_sum = hidden.new_zeros((), dtype=torch.float32)
    z_sum = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, t, c):
        args = (hidden[:, i:i + c], head, labels[:, i:i + c], softcap, band)
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
    key = "lm_head" if "lm_head" in params else "embed"
    head, band = PT.use(params[key], keep=True), _vocab_band(params, key)
    if chunked:
        loss = chunked_cross_entropy(out, head, batch["labels"],
                                     chunk=tcfg.logits_chunk,
                                     z_loss=tcfg.z_loss,
                                     softcap=cfg.logits_softcap, band=band)
    else:
        loss = cross_entropy(out, batch["labels"], tcfg.z_loss, band=band)
    if cfg.is_moe:
        loss = loss + tcfg.moe_aux_weight * aux
    return loss


def compress_grads_int8(grads, error_fb, *, specs=None, mesh=None):
    """int8 gradient compression with error feedback (per-tensor affine):
    quantize g + e to uint8, dequantize for the update, keep the residual
    as the next step's feedback.  → (dequantized grads, new feedback).

    A tensor is a leaf of the reference's layout, where a ``blocks`` leaf
    (an encoder–decoder's ``encoder`` and ``decoder`` leaves too) stacks
    every layer: the port's layers of one such leaf share one (min, max),
    so the codes are the reference's.  On ``mesh`` (``grads`` and
    ``error_fb`` this rank's shards, ``specs`` the parameters' spec
    tree) the (min, max) is the whole leaf's: reduced over the axes the
    leaf is split over before the rank quantizes its shard."""
    flat, errs = T.flatten(grads), T.leaves(error_fb)
    gfs = [g.to(torch.float32) + e for (_, g), e in zip(flat, errs)]
    groups: dict = {}
    for i, (path, _) in enumerate(flat):
        groups.setdefault(re.sub(r"^\['(blocks|encoder|decoder)'\]\[\d+\]",
                                 r"['\1']", path), []).append(i)
    idxs = list(groups.values())
    mins = [torch.stack([torch.min(gfs[i]) for i in idx]).min()
            for idx in idxs]
    maxs = [torch.stack([torch.max(gfs[i]) for i in idx]).max()
            for idx in idxs]
    if mesh is not None and mesh.size > 1:
        axes = [PT.spec_axes(s) for s in PT.flat_specs(specs, grads)]
        by_axes: dict = {}
        for gi, idx in enumerate(idxs):
            by_axes.setdefault(axes[idx[0]], []).append(gi)
        for ax, gis in by_axes.items():
            if ax:
                mn = mesh.pmin(torch.stack([mins[g] for g in gis]), ax)
                mx = mesh.pmax(torch.stack([maxs[g] for g in gis]), ax)
                for j, g in enumerate(gis):
                    mins[g], maxs[g] = mn[j], mx[j]
    dq, fb = [None] * len(gfs), [None] * len(gfs)
    for idx, mn, mx in zip(idxs, mins, maxs):
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
    tree = T.unflatten(params, live)
    PT.bind_gathering(tree)
    with torch.enable_grad():
        loss = _loss_fn(tree, cfg, tcfg, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(flat, grads)]


def grads_of(params, cfg, tcfg: TrainConfig, batch):
    """Loss and gradients (a tree of ``params``' structure); with
    ``accum_steps`` > 1 the batch splits on its leading dim and the
    microbatches' gradients are summed in ``accum_dtype``, then averaged
    (one microbatch's activations live at a time)."""
    a = tcfg.accum_steps
    if a <= 1:
        loss, grads = loss_and_grads(params, cfg, tcfg, batch)
        return loss, T.unflatten(params, grads)
    b = batch["tokens"].shape[0]
    if b % a:
        raise ValueError(f"batch {b} does not split into {a} microbatches")
    acc = [torch.zeros(p.shape, dtype=tcfg.accum_dtype, device=p.device)
           for p in T.leaves(params)]
    lsum = None
    for i in range(a):
        mb = {k: v[i * (b // a):(i + 1) * (b // a)] for k, v in batch.items()}
        loss, grads = loss_and_grads(params, cfg, tcfg, mb)
        acc = [x + g.to(x.dtype) for x, g in zip(acc, grads)]
        lsum = loss if lsum is None else lsum + loss
    inv = _recip(a, lsum.device)
    return lsum * inv, T.unflatten(params, [x * inv for x in acc])


def data_rows(batch: dict, accum: int, mesh):
    """This data rank's rows of ``batch`` → (rows, split).  The reference
    splits the global batch into ``accum`` contiguous microbatches; data
    rank d of D takes the d-th of D equal slices of each, so every
    microbatch keeps its rows, its mean and its MoE capacity.  Where a
    microbatch does not split into D rows each (the reference's
    ``make_data_specs`` guard leaves such rows whole) every data rank
    takes all rows, and ``split`` is False."""
    axes = M.data_axes(mesh)
    nd = mesh.axis_size(axes)
    a = max(accum, 1)
    b = batch["tokens"].shape[0]
    if b % a:
        raise ValueError(f"batch {b} does not split into {a} microbatches")
    m = b // a
    if nd <= 1 or m % nd:
        return batch, False
    per, d = m // nd, mesh.axis_index(axes)
    return {k: torch.cat([v[i * m + d * per:i * m + (d + 1) * per]
                          for i in range(a)]) for k, v in batch.items()}, True


def loss_and_grads_on_mesh(params, cfg, tcfg: TrainConfig, batch, mesh,
                           specs):
    """One rank's loss and gradients on ``mesh``, from this rank's shards
    (``params`` under ``specs``, the parameters' spec tree): forward and
    backward on its data rank's rows (:func:`data_rows`, the MoE's
    statistics taken over the whole microbatch:
    ``sharding.partition.rows_split``), each block's leaves gathered over
    the data axes where the block uses them (``partition.gathering``,
    inside its checkpointed body under ``cfg.remat``), the compute
    tensor-parallel over ``model`` on the rank's bands (heads, FFN columns,
    experts, vocab rows).  The gradients come out of the gathers'
    backward as this rank's shards, summed over the data ranks in rank
    order (each microbatch's, accumulated in ``accum_dtype``), and are
    averaged with the loss over the data ranks.  → (loss, this rank's
    shards of the gradients, a tree of ``params``' structure); every rank
    gets the same loss bits."""
    device = T.leaves(params)[0].device
    rows, split = data_rows(_on(batch, device), tcfg.accum_steps, mesh)
    axes = M.data_axes(mesh)
    with PT.rows_split(mesh if split else None, axes), \
            PT.gathering(mesh, specs, cfg, reduce=split):
        loss, grads = grads_of(params, cfg, tcfg, rows)
    if split:
        inv = _recip(mesh.axis_size(axes), device)
        loss = mesh.psum(loss, axes) * inv
        grads = T.map_leaves(lambda g: g * inv, grads)
    return loss, grads


def make_train_step(cfg, tcfg: TrainConfig, mesh=None, specs=None):
    """→ ``train_step(state, batch) -> (state, metrics)``; metrics
    {"loss", "grad_norm", "lr"} are 0-d tensors on the parameters'
    device (nothing is read on the host).

    On ``mesh`` (more than one rank) the state is this rank's shards
    under ``specs`` (``sharding.partition.make_train_state_specs`` of the
    whole state), ``batch`` the global batch: the step computes its rows
    on its bands, gathering each block's leaves on use, and gets its
    shard of the summed gradients
    (:func:`loss_and_grads_on_mesh`), compresses them against each whole
    leaf's range (``int8_ef``) and updates its shards
    (``optimizer.adamw_update``)."""
    use_ef = tcfg.grad_compression == "int8_ef"
    sharded = mesh is not None and mesh.size > 1
    if sharded and specs is None:
        raise ValueError("a train step on a mesh takes the state's specs "
                         "(sharding.partition.make_train_state_specs)")

    def train_step(state, batch):
        params = state["params"]
        if sharded:
            loss, grads = loss_and_grads_on_mesh(
                params, cfg, tcfg, batch, mesh, specs["params"])
        else:
            device = T.leaves(params)[0].device
            loss, grads = grads_of(params, cfg, tcfg, _on(batch, device))
        if use_ef:
            grads, new_err = compress_grads_int8(
                grads, state["grad_error"],
                specs=specs["params"] if sharded else None,
                mesh=mesh if sharded else None)
        new_params, new_opt, om = adamw_update(
            params, grads, state["opt"], tcfg.optimizer,
            specs=specs if sharded else None, mesh=mesh if sharded else None)
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
