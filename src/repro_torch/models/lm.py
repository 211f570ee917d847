"""Decoder-only LM assembly — the dense (Llama) family.

Counterpart of ``repro/models/lm.py`` (``init_lm``, ``forward``,
``init_caches`` for ``family='dense'``).  The reference stacks layers on a
leading axis and runs them under ``lax.scan``; here ``params["blocks"]`` is
a list of per-layer dicts and a Python loop runs them.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .._device import resolve_device
from . import layers as L

Params = Any


def _check_family(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported; "
                                  "only 'dense' (Llama) is")


def init_lm(cfg, *, seed: int = 0, device=None,
            dtype=torch.float32) -> Params:
    """Random weights from ``seed``, drawn on ``device`` (the card unless
    the caller passes another).  Same shapes and scales as the reference's
    init; the numbers differ (torch and jax generators differ)."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    params: dict = {
        "embed": L._normal((v, d), gen, device, dtype, 0.02),
        "final_norm": torch.ones(d, dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal((v, d), gen, device, dtype, 0.02)
    params["blocks"] = [{
        "attn_norm": torch.ones(d, dtype=dtype, device=device),
        "attn": L.init_attention(cfg, gen, device, dtype),
        "mlp_norm": torch.ones(d, dtype=dtype, device=device),
        "mlp": L.init_mlp(d, cfg.d_ff, gen, device, dtype),
    } for _ in range(cfg.n_layers)]
    return params


def _dense_block(bp, x, cfg, lut, cache, pos, rope):
    h = L.rms_norm(x, bp["attn_norm"], cfg.norm_eps)
    a, new_cache = L.apply_attention(bp["attn"], h, cfg, lut=lut,
                                     cache=cache, pos=pos, rope=rope)
    # The reference's XLA program fuses this residual add into the next
    # norm and normalizes the unrounded f32 sum, while the residual stream
    # itself is rounded to x's dtype; the port does the same, so bf16
    # activations stay equal.
    h = L.rms_norm(x.to(torch.float32) + a.to(torch.float32), bp["mlp_norm"],
                   cfg.norm_eps).to(x.dtype)
    x = x + a
    x = x + L.apply_mlp(bp["mlp"], h, lut=lut)
    return x, new_cache


def forward(params: Params, cfg, tokens: torch.Tensor, *, caches=None,
            pos: Optional[int] = None, lut=None,
            return_hidden: bool = False):
    """tokens (B, T) int → (logits, caches, aux_loss).

    ``return_hidden=True`` skips the LM head and returns the final normed
    hidden states.  Caches are updated in place and returned."""
    _check_family(cfg)
    x = L.embed(params["embed"], tokens, lut)
    pos0 = 0 if pos is None else int(pos)
    rope = L.rope_tables(pos0 + torch.arange(tokens.shape[1],
                                             device=x.device),
                         cfg.resolved_head_dim, cfg.rope_theta)
    blk_caches = (caches or {}).get("blocks")
    new_caches = []
    for i, bp in enumerate(params["blocks"]):
        cache = blk_caches[i] if blk_caches is not None else None
        x, nc = _dense_block(bp, x, cfg, lut, cache, pos, rope)
        new_caches.append(nc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    out_caches = {"blocks": new_caches if blk_caches is not None else None}
    if return_hidden:
        return x, out_caches, 0.0
    head = params.get("lm_head", params["embed"])
    logits = L.linear(x, head, lut)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits, out_caches, 0.0


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device=None) -> Params:
    """Per-layer KV caches for serving, on ``device`` (the card unless the
    caller passes another)."""
    _check_family(cfg)
    device = resolve_device(device)
    return {"blocks": [L.init_kv_cache(cfg, batch, max_len, dtype, device)
                       for _ in range(cfg.n_layers)]}
