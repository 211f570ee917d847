"""Model primitives — functional layers over plain parameter dicts.

Counterpart of ``repro/models/layers.py`` for the dense Llama family.
Activations keep the reference's (B, T, H, hd) layout and weights its
(out, in) layout.  A linear weight is a dense tensor, a ``QuantLinear`` or
a ``PackedLinear``; ``linear`` routes the last two to the hand-written
kernels through ``kernels.ops`` (CUDA tensors) or their plain versions
(CPU tensors).

Unlike the reference, the KV cache is updated in place (``_kv_write``):
the cache is the largest activation buffer and a functional copy per token
would double it.
"""
from __future__ import annotations

import collections
import math
from typing import Any, Optional

import torch

from ..core.compressed import PackedLinear, QuantLinear
from ..kernels import ops

Params = Any  # nested dict of tensors / weight containers


# ---------------------------------------------------------------------------
# Linear dispatch — dense | int8 | compressed.
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, w, lut=None, bias=None) -> torch.Tensor:
    """y = x @ W.T (+ bias) for any weight container."""
    if isinstance(w, PackedLinear):
        y = ops.decode_dequant_matmul(x, w, lut, out_dtype=x.dtype)
    elif isinstance(w, QuantLinear):
        y = ops.dequant_matmul(x, w.values, w.scale, w.zero,
                               out_dtype=x.dtype)
    else:
        y = x @ w.to(x.dtype).T
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


# Materialization probe: how often a PackedLinear was decoded to a dense
# tensor ('packed').  The compressed serving path keeps it at zero; tests
# and chip_smoke.py assert on it.
MATERIALIZE_COUNTS = collections.Counter()


def embed(w, ids: torch.Tensor, lut=None) -> torch.Tensor:
    """Embedding lookup from dense or int8 tables (rows = vocab)."""
    if isinstance(w, QuantLinear):
        rows = w.values[ids].to(torch.float32)
        return ((rows - w.zero[ids, 0][..., None])
                * w.scale[ids, 0][..., None]).to(torch.bfloat16)
    if isinstance(w, PackedLinear):  # decode then gather (rare path)
        MATERIALIZE_COUNTS["packed"] += 1
        return w.materialize(lut, torch.bfloat16)[ids]
    return w[ids]


# ---------------------------------------------------------------------------
# Norms + RoPE.
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables (T, hd/2) for the given positions."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, T, H, hd) — rotate pairs (split-half convention); cos/sin
    (T, hd/2) shared across the batch."""
    half = x.shape[-1] // 2
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (llama family).
# ---------------------------------------------------------------------------

def _normal(shape, gen, device, dtype, std):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=dtype) * std


def init_attention(cfg, gen: torch.Generator, device,
                   dtype=torch.float32) -> Params:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError("qkv_bias / qk_norm are not ported")
    s = 1.0 / math.sqrt(d)
    return {
        "wq": _normal((nq * hd, d), gen, device, dtype, s),
        "wk": _normal((nkv * hd, d), gen, device, dtype, s),
        "wv": _normal((nkv * hd, d), gen, device, dtype, s),
        "wo": _normal((d, nq * hd), gen, device, dtype,
                      1.0 / math.sqrt(nq * hd)),
    }


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cpu") -> Params:
    if getattr(cfg, "kv_cache_bits", 16) != 16:
        raise NotImplementedError("the int8 KV cache is not ported")
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _kv_write(dst: torch.Tensor, src: torch.Tensor, pos: int):
    """Write ``src`` (B, T, ...) into the cache ``dst`` (B, L, ...) at one
    shared offset ``pos``, in place."""
    if not isinstance(pos, int):
        raise NotImplementedError("per-slot (vector) cache positions are "
                                  "not ported")
    dst[:, pos:pos + src.shape[1]] = src
    return dst


def _attend_full(q, k, v, causal: bool):
    """Prefill attention over the fresh k/v: (B, T, H, hd) in and out."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2)


def _attend_cache_flash(q, cache_k, cache_v, pos: int):
    """Chunked-prefill attention over the (updated) cache with
    ``q_offset = pos``: the cache may be longer than what is written; its
    tail is masked by causality."""
    o = ops.flash_attention(q.transpose(1, 2), cache_k.transpose(1, 2),
                            cache_v.transpose(1, 2), causal=True,
                            q_offset=pos)
    return o.transpose(1, 2)


def _attend_cached(q, cache_k, cache_v, pos: int, t_new: int):
    """Decode attention over a cache (plain torch, as the reference's is
    plain jnp): positions past ``pos + t_new − 1`` get −1e30, whose exp is
    exactly 0."""
    b, t, hq, hd = q.shape
    hkv = cache_k.shape[2]
    rep = hq // hkv
    lmax = cache_k.shape[1]
    qf = q.to(torch.float32).reshape(b, t, hkv, rep, hd)
    kf = cache_k.to(torch.float32)
    vf = cache_v.to(torch.float32)
    logits = torch.einsum("btgrd,blgd->btgrl", qf, kf) / math.sqrt(hd)
    kpos = torch.arange(lmax, device=q.device)
    qpos = pos + torch.arange(t, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]                  # (t, L)
    logits = torch.where(mask[None, :, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("btgrl,blgd->btgrd", p, vf)
    return out.reshape(b, t, hq, hd).to(q.dtype)


def apply_attention(p: Params, x: torch.Tensor, cfg, *, lut=None,
                    cache: Optional[Params] = None, pos: int | None = None,
                    causal: bool = True, rope=None):
    """Returns (y, cache). ``cache=None`` → full attention; with a cache:
    writes k/v at ``pos`` (in place) then attends ≤ pos.  ``rope``: the
    (cos, sin) tables of these positions, when the caller shares one pair
    across layers."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads

    q = linear(x, p["wq"], lut, p.get("bq")).reshape(b, t, nq, hd)
    k = linear(x, p["wk"], lut, p.get("bk")).reshape(b, t, nkv, hd)
    v = linear(x, p["wv"], lut, p.get("bv")).reshape(b, t, nkv, hd)

    pos0 = 0 if pos is None else int(pos)
    if rope is None:
        rope = rope_tables(pos0 + torch.arange(t, device=x.device), hd,
                           cfg.rope_theta)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        o = _attend_full(q, k, v, causal)
    else:
        ck = _kv_write(cache["k"], k.to(cache["k"].dtype), pos0)
        cv = _kv_write(cache["v"], v.to(cache["v"].dtype), pos0)
        if t == 1:
            o = _attend_cached(q, ck, cv, pos0, t)
        elif t == ck.shape[1]:
            # full prefill: the fresh k/v are the cache's whole content
            o = _attend_full(q, k, v, causal)
        else:  # chunked prefill: flash over the cache
            o = _attend_cache_flash(q, ck, cv, pos0)
    y = linear(o.reshape(b, t, nq * hd), p["wo"], lut)
    return y, cache


# ---------------------------------------------------------------------------
# SwiGLU MLP.
# ---------------------------------------------------------------------------

def init_mlp(d: int, ff: int, gen: torch.Generator, device,
             dtype=torch.float32) -> Params:
    return {
        "w_gate": _normal((ff, d), gen, device, dtype, 1.0 / math.sqrt(d)),
        "w_up": _normal((ff, d), gen, device, dtype, 1.0 / math.sqrt(d)),
        "w_down": _normal((d, ff), gen, device, dtype, 1.0 / math.sqrt(ff)),
    }


def apply_mlp(p: Params, x: torch.Tensor, *, lut=None) -> torch.Tensor:
    g = linear(x, p["w_gate"], lut)
    u = linear(x, p["w_up"], lut)
    # silu(g)·u op by op in g's dtype, as the reference's XLA program
    # computes it (logistic = 1 / (1 + exp(−g)), each op rounded to bf16 in
    # the quantized modes); a fused F.silu rounds differently and moves
    # bf16 activations by an ulp.
    sig = 1.0 / (1.0 + torch.exp(-g))
    return linear(g * sig * u, p["w_down"], lut)
