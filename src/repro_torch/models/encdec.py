"""Encoder–decoder backbone (the seamless-m4t family).

Counterpart of ``repro/models/encdec.py``.  The audio frontend is a
stand-in: precomputed frame embeddings (B, S, d) go straight to the
bidirectional encoder (``frontends.audio_frame_embeddings``).  The decoder
is a causal stack with cross-attention over the encoder's output; each
decoder layer's cross K/V are projected once, at the prefill, and kept for
the decode steps.

The reference stacks each stack's layers on a leading axis and runs them
under ``lax.scan``; here ``params["encoder"]`` and ``params["decoder"]``
are lists of per-layer dicts run by a Python loop, and the cross K/V are
per-layer lists (B, S, kv heads, hd).  As in ``lm.py``, the KV caches are
updated in place; serving caches (:func:`init_caches`) also hold buffers
for the cross K/V, which :func:`forward` fills in place, so a captured
decode step reads the K/V of the frames last prefilled.

Every attention runs K2 (``ops.flash_attention``): the encoder's without
the causal mask, the decoder's causal (over its cache at a prefill), the
cross-attention without the mask at any query length, a decode step's
single row included.  The frames' dtype is the encoder's: f32 frames give
f32 activations and cross K/V.
"""
from __future__ import annotations

from typing import Any

import torch

from .._device import generator, resolve_device
from . import layers as L

Params = Any


def init_encdec(cfg, *, seed: int = 0, device=None,
                dtype=torch.float32) -> Params:
    """Random weights from ``seed``, drawn on ``device`` (the card unless
    the caller passes another).  Same shapes and scales as the reference's
    ``init_encdec``; the numbers differ (torch and jax generators)."""
    device = resolve_device(device)
    gen = generator(device, seed)
    d, v = cfg.d_model, cfg.vocab_size

    def ones():
        return torch.ones(d, dtype=dtype, device=device)

    params = {
        "dec_embed": L._normal((v, d), gen, device, dtype, 0.02),
        "lm_head": L._normal((v, d), gen, device, dtype, 0.02),
        "enc_final_norm": ones(),
        "dec_final_norm": ones(),
    }
    params["encoder"] = [{
        "attn_norm": ones(),
        "attn": L.init_attention(cfg, gen, device, dtype),
        "mlp_norm": ones(),
        "mlp": L.init_mlp(d, cfg.d_ff, gen, device, dtype),
    } for _ in range(cfg.encoder_layers)]
    params["decoder"] = [{
        "attn_norm": ones(),
        "attn": L.init_attention(cfg, gen, device, dtype),
        "cross_norm": ones(),
        "cross": L.init_attention(cfg, gen, device, dtype),
        "mlp_norm": ones(),
        "mlp": L.init_mlp(d, cfg.d_ff, gen, device, dtype),
    } for _ in range(cfg.decoder_layers)]
    return params


def _norm_of_sum(x, a, w, cfg):
    """rms_norm(x + a) of the unrounded f32 sum, in x's dtype: the
    reference's XLA program fuses a residual add into the next norm, as in
    ``lm._dense_block``."""
    return L.rms_norm(x.to(torch.float32) + a.to(torch.float32), w,
                      cfg.norm_eps).to(x.dtype)


def _rope(cfg, pos, t: int, device):
    return L.rope_tables(L.positions(0 if pos is None else pos, t, device),
                         cfg.resolved_head_dim, cfg.rope_theta)


def encode(params: Params, cfg, embeds: torch.Tensor, *,
           lut=None) -> torch.Tensor:
    """Bidirectional encoder over precomputed frame embeddings (B, S, d),
    in their dtype."""
    x = embeds
    rope = _rope(cfg, 0, x.shape[1], x.device)
    for bp in params["encoder"]:
        h = L.rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        a, _ = L.apply_attention(bp["attn"], h, cfg, lut=lut, causal=False,
                                 rope=rope)
        h = _norm_of_sum(x, a, bp["mlp_norm"], cfg)
        x = x + a
        x = x + L.apply_mlp(bp["mlp"], h, lut=lut)
    return L.rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def project_enc_kv_all(params: Params, cfg, enc_out: torch.Tensor, *,
                       lut=None):
    """Cross-attention K/V of every decoder layer: two lists of (B, S, kv
    heads, hd), the reference's stacked (L, B, S, H, hd) by layer."""
    kv = [L.project_enc_kv(bp["cross"], enc_out, cfg, lut=lut)
          for bp in params["decoder"]]
    return [k for k, _ in kv], [v for _, v in kv]


def decode_stack(params: Params, cfg, x: torch.Tensor, enc_k, enc_v, *,
                 caches=None, pos=None, lut=None):
    """Decoder stack: causal self-attention (cached when ``caches``, a
    list of per-layer KV caches, is given) + cross-attention + MLP.
    → (x, the caches, updated in place, or None)."""
    rope = _rope(cfg, pos, x.shape[1], x.device)
    for i, bp in enumerate(params["decoder"]):
        cache = caches[i] if caches is not None else None
        h = L.rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        a, _ = L.apply_attention(bp["attn"], h, cfg, lut=lut, cache=cache,
                                 pos=pos, causal=True, rope=rope)
        h = _norm_of_sum(x, a, bp["cross_norm"], cfg)
        x = x + a
        c = L.apply_cross_attention(bp["cross"], h, enc_k[i], enc_v[i], cfg,
                                    lut=lut)
        h = _norm_of_sum(x, c, bp["mlp_norm"], cfg)
        x = x + c
        x = x + L.apply_mlp(bp["mlp"], h, lut=lut)
    return x, caches


def forward(params: Params, cfg, enc_embeds: torch.Tensor,
            dec_tokens: torch.Tensor, *, caches=None, pos=None, lut=None,
            return_hidden: bool = False):
    """Full encoder–decoder forward (training / prefill): encode, project
    the cross K/V, decode.  → (logits or, with ``return_hidden``, the
    final normed hidden states; caches).

    ``caches``: {"self": per-layer KV caches, written in place at ``pos``;
    "enc_k", "enc_v": per-layer buffers (B, S, kv heads, hd) of the
    projected K/V's dtype, which take them in place} — or None.  The
    returned caches hold the cross K/V for the decode steps."""
    enc_out = encode(params, cfg, enc_embeds, lut=lut)
    enc_k, enc_v = project_enc_kv_all(params, cfg, enc_out, lut=lut)
    caches = caches or {}
    if caches.get("enc_k") is not None:
        for bufs, new in ((caches["enc_k"], enc_k), (caches["enc_v"], enc_v)):
            for buf, t in zip(bufs, new):
                if buf.shape != t.shape or buf.dtype != t.dtype:
                    raise ValueError(
                        f"cross K/V {tuple(t.shape)} {t.dtype} do not fit "
                        f"the cache's buffers {tuple(buf.shape)} {buf.dtype}")
                buf.copy_(t)
        enc_k, enc_v = caches["enc_k"], caches["enc_v"]
    x = L.embed(params["dec_embed"], dec_tokens, lut)
    x, new_self = decode_stack(params, cfg, x, enc_k, enc_v,
                               caches=caches.get("self"), pos=pos, lut=lut)
    x = L.rms_norm(x, params["dec_final_norm"], cfg.norm_eps)
    new_caches = {"self": new_self, "enc_k": enc_k, "enc_v": enc_v}
    if return_hidden:
        return x, new_caches
    return L.linear(x, params["lm_head"], lut), new_caches


def decode_step(params: Params, cfg, token: torch.Tensor, caches, pos, *,
                lut=None):
    """One decoder step against the cached self K/V and the cross K/V.
    ``pos``: an int, a 0-d tensor or per-row (B,).  → (logits (B, 1, V),
    caches)."""
    x = L.embed(params["dec_embed"], token, lut)
    x, _ = decode_stack(params, cfg, x, caches["enc_k"], caches["enc_v"],
                        caches=caches["self"], pos=pos, lut=lut)
    x = L.rms_norm(x, params["dec_final_norm"], cfg.norm_eps)
    return L.linear(x, params["lm_head"], lut), caches


def init_dec_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                    device=None) -> list:
    """The decoder's per-layer KV caches, on ``device`` (the card unless
    the caller passes another)."""
    device = resolve_device(device)
    return [L.init_kv_cache(cfg, batch, max_len, dtype, device)
            for _ in range(cfg.decoder_layers)]


def init_caches(cfg, batch: int, max_len: int, enc_len: int,
                dtype=torch.bfloat16, enc_dtype=torch.bfloat16,
                device=None, *, mesh=None, rows: bool = True) -> dict:
    """Serving caches: {"self": :func:`init_dec_caches`, "enc_k", "enc_v":
    per-layer zero buffers (B, ``enc_len``, kv heads, hd) in ``enc_dtype``
    (the frames' dtype), which a prefill fills}.  ``mesh``: this rank's
    share, as ``lm.init_caches(mesh=)`` gives it (the cross K/V by
    heads)."""
    if mesh is not None and mesh.size > 1:
        from ..sharding import partition as PT
        whole = init_caches(cfg, batch, PT.cache_len(cfg, max_len, mesh),
                            enc_len, dtype, enc_dtype, device="meta")
        return PT.zeros_share(whole, mesh, resolve_device(device),
                              rows=rows)
    device = resolve_device(device)
    shape = (batch, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)

    def bufs():
        return [torch.zeros(shape, dtype=enc_dtype, device=device)
                for _ in range(cfg.decoder_layers)]

    return {"self": init_dec_caches(cfg, batch, max_len, dtype, device),
            "enc_k": bufs(), "enc_v": bufs()}
