"""Model primitives — functional layers over plain parameter dicts.

Counterpart of ``repro/models/layers.py``: GQA attention (with Qwen2's QKV
bias, Qwen3's qk-norm and the int8 KV cache), the encoder–decoder's
cross-attention, DeepSeek-V2's MLA attention and MoE (global dispatch).
Activations keep the reference's (B, T, H, hd) layout and weights its (out,
in) layout.  A linear weight is a dense tensor, a ``QuantLinear``, a
``PackedLinear`` or a ``TiledPackedLinear`` (column groups); ``linear``
routes the containers to the hand-written kernels through ``kernels.ops``
(CUDA tensors) or their plain versions (CPU tensors), and a stacked expert
``PackedLinear`` runs the grouped kernel.  The port keeps a list of
per-layer dicts, so a container reaches a layer with that layer's planes
alone.

Unlike the reference, the KV cache is updated in place (``_kv_write``):
the cache is the largest activation buffer and a functional copy per token
would double it.

Positions, as in the reference, are a Python int (prefill: the flash
kernel takes its ``q_offset`` as a launch argument), a 0-d tensor (one
offset shared by the batch) or a (B,) tensor (one offset a row, decode
only).  A tensor position stays on the device: a decode step reads no
tensor on the host, so it can be captured in a CUDA graph.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Optional

import torch

from ..core.compressed import PackedLinear, QuantLinear, TiledPackedLinear
from ..kernels import ops
from ..sharding import partition as PT

Params = Any  # nested dict of tensors / weight containers


# ---------------------------------------------------------------------------
# Linear dispatch — dense | int8 | compressed.
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, w, lut=None, bias=None,
           decode: bool | None = None) -> torch.Tensor:
    """y = x @ W.T (+ bias) for any weight container.

    ``decode``: x's rows are a decode step's, one token of its own request
    each; ``None`` reads it from x, (B, 1, K) being a decode step's.  The
    kernels then plan every row as they plan it alone, at any batch
    (``fused_decode_matmul.launch_plan``, ``dequant_matmul.dequant_plan``),
    and a dense weight on the card (MoE's router; dense mode) multiplies
    them in GEMMs of ROW_PAD rows (``_dense_decode``)."""
    if decode is None:
        decode = x.ndim == 3 and x.shape[1] == 1
    if isinstance(w, (PackedLinear, TiledPackedLinear)):
        y = ops.decode_dequant_matmul(x, w, lut, out_dtype=x.dtype,
                                      decode=decode)
    elif isinstance(w, QuantLinear):
        y = ops.dequant_matmul(x, w.values, w.scale, w.zero,
                               out_dtype=x.dtype, decode=decode)
    elif decode and x.is_cuda:
        y = _dense_decode(x, w.to(x.dtype))
    else:
        y = x @ w.to(x.dtype).T
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _dense_decode(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T for a decode step's rows on the card: GEMMs of exactly
    ROW_PAD rows, the last piece padded with zero rows, so that cuBLAS
    sums a row in one order at any batch, alone included (see ROW_PAD)."""
    xf = x.reshape(-1, x.shape[-1])
    m = xf.shape[0]
    xf = torch.nn.functional.pad(xf, (0, 0, 0, -m % ROW_PAD))
    y = torch.cat([c @ w.T for c in xf.split(ROW_PAD)])
    return y[:m].reshape(*x.shape[:-1], w.shape[0])


# Materialization probe: how often a weight container was decoded to a
# dense tensor, by kind: 'packed' (one weight), 'packed_stacked' (a stacked
# expert weight — the grouped kernel keeps these at zero), 'tiled' (a
# TiledPackedLinear: MLA's absorb of a tiled wkv_b), 'quant'.  MLA's
# absorb decodes wkv_b ('packed') at every call, as the reference does;
# tests and chip_smoke.py assert on the counts.  A captured decode step
# counts once per replay (``serve.engine.DecodeGraph``).
MATERIALIZE_COUNTS = collections.Counter()


def materialize_weight(w, lut=None, dtype=None):
    """Dense view of any weight container (the MLA absorb, dense or
    int8 expert stacks).  ``dtype=None`` decodes containers to bf16 and
    leaves dense weights as they are.  A CUDA ``PackedLinear`` or
    ``TiledPackedLinear`` decodes with the dict-decode kernel, unless the
    dispatch lever pins the ``materialize`` rung (``ops.plain_decode``)."""
    if isinstance(w, (PackedLinear, TiledPackedLinear)):
        kind = "tiled" if w.GROUP_AXES else "packed"
        if w.codes.ndim > 2 + w.GROUP_AXES:
            kind += "_stacked"
        MATERIALIZE_COUNTS[kind] += 1
        dense = w.materialize(lut, torch.bfloat16 if dtype is None else dtype,
                              plain=ops.plain_decode())
        if w.mesh_axes is not None:     # a mesh rank's share: gather it
            return PT.gather_container(w, dense, PT.current_mesh()[1])
        return dense
    if isinstance(w, QuantLinear):
        MATERIALIZE_COUNTS["quant"] += 1
        return w.materialize(torch.bfloat16 if dtype is None else dtype)
    return w if dtype is None else w.to(dtype)


def embed(w, ids: torch.Tensor, lut=None) -> torch.Tensor:
    """Embedding lookup from dense or int8 tables (rows = vocab)."""
    if isinstance(w, QuantLinear):
        rows = w.values[ids].to(torch.float32)
        return ((rows - w.zero[ids, 0][..., None])
                * w.scale[ids, 0][..., None]).to(torch.bfloat16)
    if isinstance(w, PackedLinear):  # decode then gather (rare path)
        MATERIALIZE_COUNTS["packed"] += 1
        return w.materialize(lut, torch.bfloat16,
                             plain=ops.plain_decode())[ids]
    return w[ids]


# ---------------------------------------------------------------------------
# Norms + RoPE.
# ---------------------------------------------------------------------------

def _mean_square(xf: torch.Tensor) -> torch.Tensor:
    """The mean of squares over the last dim, (..., 1).

    On the card a row's value must not depend on how many rows share the
    call (an engine tick's row against ``generate``'s batch of one).
    PyTorch's CUDA reduction sizes its threads along a row by the number
    of rows when there are fewer than 16, so it would sum one row alone
    in another order than the same row in a batch.  So the row is summed
    in 16 pieces of d/16 first (16 or more outputs: one layout for any
    number of rows), then its 16 partial sums (16 threads along a row for
    any number of rows)."""
    d = xf.shape[-1]
    if not xf.is_cuda or d % 16:
        return torch.mean(xf * xf, dim=-1, keepdim=True)
    part = (xf * xf).reshape(*xf.shape[:-1], 16, d // 16).sum(dim=-1)
    return part.sum(dim=-1, keepdim=True) * (1.0 / d)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = _mean_square(xf)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def positions(pos, t: int, device) -> torch.Tensor:
    """The positions of ``t`` new tokens at ``pos``: (t,) for an int or a
    0-d tensor, (B, t) for a per-row (B,) tensor (``t`` must then be 1)."""
    if not torch.is_tensor(pos):
        return int(pos) + torch.arange(t, device=device)
    if pos.ndim == 1 and t != 1:
        raise ValueError("vector (per-slot) pos supports single-token "
                         f"decode only; got T={t}")
    return pos.to(device)[..., None] + torch.arange(t, device=device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables (..., hd/2) for the given positions: (T,) shared by
    the batch, or (B, T) per row."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # theta filled on the device: a tensor made from a host scalar would
    # be a copy, which a captured step cannot hold
    base = torch.full((), theta, dtype=torch.float32,
                      device=positions.device)
    freqs = 1.0 / torch.pow(base, exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, T, H, hd) — rotate pairs (split-half convention); cos/sin
    (T, hd/2) shared across the batch or (B, T, hd/2) per row."""
    half = x.shape[-1] // 2
    if cos.ndim == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (llama / qwen / internlm family).
# ---------------------------------------------------------------------------

def _normal(shape, gen, device, dtype, std):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=dtype) * std


def init_attention(cfg, gen: torch.Generator, device,
                   dtype=torch.float32) -> Params:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal((nq * hd, d), gen, device, dtype, s),
        "wk": _normal((nkv * hd, d), gen, device, dtype, s),
        "wv": _normal((nkv * hd, d), gen, device, dtype, s),
        "wo": _normal((d, nq * hd), gen, device, dtype,
                      1.0 / math.sqrt(nq * hd)),
    }
    if cfg.qkv_bias:           # Qwen2: biases on q, k and v, kept dense
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros(n * hd, dtype=dtype, device=device)
    if cfg.qk_norm:            # Qwen3: RMS norm of q and k over head_dim
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    return p


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cpu") -> Params:
    """K/V caches (B, L, kv heads, hd) in ``dtype``; with
    ``cfg.kv_cache_bits == 8``, int8 codes with an f32 scale per (token,
    head), (B, L, kv heads, 1), as the reference's int8 cache."""
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    if getattr(cfg, "kv_cache_bits", 16) == 8:
        scale = shape[:3] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale, dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(scale, dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


_RECIP_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def _quant_kv(x: torch.Tensor):
    """(B, T, H, hd) → (int8 codes, f32 scales (B, T, H, 1)) per (token,
    head): scale max(|x|)/127 clamped at 1e-12, codes rounded half to even
    and clipped to ±127, as the reference's ``_quant_kv``."""
    xf = x.to(torch.float32)
    # the reference's XLA program divides by the constant 127 as a
    # multiply by its f32 reciprocal
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True)
                        * _RECIP_127, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequant_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def _kv_write(dst: torch.Tensor, src: torch.Tensor, pos):
    """Write ``src`` (B, T, ...) into the cache ``dst`` (B, L, ...) at
    ``pos``, in place.  An int: a slice at one shared offset (prefill).  A
    0-d tensor: the T rows at ``pos + arange(T)`` by ``index_copy_``, the
    same bytes.  A (B,) tensor (every row at its own offset): a per-row
    scatter, which requires T == 1."""
    t = src.shape[1]
    if not torch.is_tensor(pos):
        dst[:, int(pos):int(pos) + t] = src
    elif pos.ndim == 0:
        dst.index_copy_(1, pos + torch.arange(t, device=dst.device), src)
    else:
        if t != 1:
            raise ValueError("per-slot (vector pos) cache writes decode "
                             f"one token at a time; got T={t}")
        dst.index_put_((torch.arange(dst.shape[0], device=dst.device), pos),
                       src[:, 0])
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


def _decode_mask(pos, t: int, lmax: int, device) -> torch.Tensor:
    """Which of ``lmax`` cache positions each of ``t`` queries at ``pos``
    sees: (t, L) for a shared offset, (B, t, L) per row."""
    return (torch.arange(lmax, device=device)
            <= positions(pos, t, device)[..., None])


# Rows the decode step's f32 attention einsums and its dense-weight matmuls
# run at on the card, whatever the batch (above ROW_PAD rows, in pieces of
# ROW_PAD rows, each padded).  cuBLAS picks a GEMM by its shape, and the
# einsums' GEMMs have B batches (GQA: B · kv heads; MLA's absorb: M = B),
# so one row would be summed in another order alone (generate's batch of
# one) than beside others (an engine tick of n_slots rows): on the H100
# MLA's attention of a row moved by ~1e-3 between 4 rows and 1, and
# Llama-3.2-1B's engine at 8 slots left generate's tokens.  Padded to
# ROW_PAD rows, every batch up to ROW_PAD runs the same GEMMs, and a
# larger batch runs them piece by piece (``_by_row_pieces``,
# ``_dense_decode``), so a row has one set of bits at any batch, as the
# fused matmuls' decode plans give it.
ROW_PAD = 16


def _by_row_pieces(fn, b: int, x: torch.Tensor, *rows, pos):
    """``fn(*rows, pos)`` on the card in pieces of ROW_PAD rows of the
    batch, concatenated, where the batch ``b`` is larger; else one call.
    ``rows`` are (B, ...) tensors; ``pos`` an int, a 0-d tensor or (B,)."""
    if not x.is_cuda or b <= ROW_PAD:
        return fn(*rows, pos)
    return torch.cat([fn(*(r[i:i + ROW_PAD] for r in rows),
                         pos[i:i + ROW_PAD] if torch.is_tensor(pos)
                         and pos.ndim == 1 else pos)
                      for i in range(0, b, ROW_PAD)])


def _row_pad(b: int, x: torch.Tensor):
    """A function taking a (b, ...) tensor to f32 (or ``dtype``) and, on
    the card below ROW_PAD rows, to ROW_PAD rows: its own, then rows left
    unwritten.  Every output row of the einsums below comes from its own
    input rows alone, so the pad rows reach no row that is kept, and the
    padded copy costs what the f32 copy did."""
    if not x.is_cuda or b >= ROW_PAD:
        return lambda a, dtype=torch.float32: a.to(dtype)

    def pad(a, dtype=torch.float32):
        out = a.new_empty((ROW_PAD,) + tuple(a.shape[1:]), dtype=dtype)
        out[:b] = a
        return out
    return pad


def _attend_cached(q, cache_k, cache_v, pos, t_new: int):
    """Decode attention over a cache (plain torch, as the reference's is
    plain jnp): positions past a row's ``pos + t_new − 1`` get −1e30, whose
    exp is exactly 0.  ``pos``: an int, a 0-d tensor or per-row (B,).  In
    f32; on the card the batch padded to ROW_PAD rows (above)."""
    b = q.shape[0]
    if q.is_cuda and b > ROW_PAD:
        return _by_row_pieces(
            lambda qq, kk, vv, p: _attend_cached(qq, kk, vv, p, t_new),
            b, q, q, cache_k, cache_v, pos=pos)
    b, t, hq, hd = q.shape
    hkv = cache_k.shape[2]
    rep = hq // hkv
    lmax = cache_k.shape[1]
    pad = _row_pad(b, q)
    qf = pad(q.reshape(b, t, hkv, rep, hd))
    kf, vf = pad(cache_k), pad(cache_v)
    logits = torch.einsum("btgrd,blgd->btgrl", qf, kf) / math.sqrt(hd)
    mask = _decode_mask(pos, t, lmax, q.device)     # (t, L) or (B, t, L)
    mask = (mask[None, :, None, None, :] if mask.ndim == 2
            else pad(mask[:, :, None, None, :], torch.bool))
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("btgrl,blgd->btgrd", p, vf)[:b]
    return out.reshape(b, t, hq, hd).to(q.dtype)


def apply_attention(p: Params, x: torch.Tensor, cfg, *, lut=None,
                    cache: Optional[Params] = None, pos=None,
                    causal: bool = True, rope=None):
    """Returns (y, cache). ``cache=None`` → full attention; with a cache:
    writes k/v at ``pos`` (in place) then attends ≤ pos.  ``pos``: an int,
    a 0-d tensor or, for T == 1, per-row (B,).  ``rope``: the (cos, sin)
    tables of these positions, when the caller shares one pair across
    layers."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads

    q = linear(x, p["wq"], lut, p.get("bq")).reshape(b, t, nq, hd)
    k = linear(x, p["wk"], lut, p.get("bk")).reshape(b, t, nkv, hd)
    v = linear(x, p["wv"], lut, p.get("bv")).reshape(b, t, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    pos0 = 0 if pos is None else pos
    if rope is None:
        rope = rope_tables(positions(pos0, t, x.device), hd, cfg.rope_theta)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        o = _attend_full(q, k, v, causal)
    else:
        if cache["k"].dtype == torch.int8:
            # int8 cache: codes and scales written in place; attention
            # reads the whole cache dequantized to q's dtype
            for name, val in (("k", k), ("v", v)):
                codes, scale = _quant_kv(val)
                _kv_write(cache[name], codes, pos0)
                _kv_write(cache[name + "_scale"], scale, pos0)
            ck = _dequant_kv(cache["k"], cache["k_scale"], q.dtype)
            cv = _dequant_kv(cache["v"], cache["v_scale"], q.dtype)
        else:
            ck = _kv_write(cache["k"], k.to(cache["k"].dtype), pos0)
            cv = _kv_write(cache["v"], v.to(cache["v"].dtype), pos0)
        if t == 1:
            o = _attend_cached(q, ck, cv, pos0, t)
        elif t == ck.shape[1]:
            # full prefill: the fresh k/v are the cache's whole content
            o = _attend_full(q, k, v, causal)
        else:  # chunked prefill: flash over the cache (q_offset, a
            # launch argument, read on the host)
            o = _attend_cache_flash(q, ck, cv, int(pos0))
    y = linear(o.reshape(b, t, nq * hd), p["wo"], lut)
    return y, cache


def apply_cross_attention(p: Params, x: torch.Tensor, enc_k, enc_v, cfg, *,
                          lut=None) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (B, S, H, hd):
    no rope, no mask, the flash kernel at any T (a decode step's q is one
    row a request)."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    nq = cfg.n_heads
    q = linear(x, p["wq"], lut, p.get("bq")).reshape(b, t, nq, hd)
    o = _attend_full(q, enc_k, enc_v, causal=False)
    return linear(o.reshape(b, t, nq * hd), p["wo"], lut)


def project_enc_kv(p: Params, enc_out: torch.Tensor, cfg, *, lut=None):
    """A decoder layer's cross-attention K/V of the encoder's output:
    (B, S, kv heads, hd) each."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    nkv = cfg.n_kv_heads
    k = linear(enc_out, p["wk"], lut, p.get("bk")).reshape(b, s, nkv, hd)
    v = linear(enc_out, p["wv"], lut, p.get("bv")).reshape(b, s, nkv, hd)
    return k, v


# ---------------------------------------------------------------------------
# MLA — DeepSeek latent attention (compressed KV cache).
# ---------------------------------------------------------------------------

def init_mla(cfg, gen: torch.Generator, device,
             dtype=torch.float32) -> Params:
    d = cfg.d_model
    nq = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    s = 1.0 / math.sqrt(d)
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = _normal((cfg.q_lora_rank, d), gen, device, dtype, s)
        p["q_a_norm"] = torch.ones(cfg.q_lora_rank, dtype=dtype,
                                   device=device)
        p["wq_b"] = _normal((nq * (dn + dr), cfg.q_lora_rank), gen, device,
                            dtype, 1.0 / math.sqrt(cfg.q_lora_rank))
    else:
        p["wq"] = _normal((nq * (dn + dr), d), gen, device, dtype, s)
    p["wkv_a"] = _normal((r + dr, d), gen, device, dtype, s)
    p["kv_a_norm"] = torch.ones(r, dtype=dtype, device=device)
    p["wkv_b"] = _normal((nq * (dn + dv), r), gen, device, dtype,
                         1.0 / math.sqrt(r))
    p["wo"] = _normal((d, nq * dv), gen, device, dtype,
                      1.0 / math.sqrt(nq * dv))
    return p


def init_mla_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cpu") -> Params:
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                             dtype=dtype, device=device),
    }


def _mla_q(p, x, cfg, lut):
    b, t, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        qa = rms_norm(linear(x, p["wq_a"], lut), p["q_a_norm"], cfg.norm_eps)
        q = linear(qa, p["wq_b"], lut)
    else:
        q = linear(x, p["wq"], lut)
    q = q.reshape(b, t, cfg.n_heads, dn + dr)
    return q[..., :dn], q[..., dn:]


def apply_mla(p: Params, x: torch.Tensor, cfg, *, lut=None,
              cache: Optional[Params] = None, pos=None, rope=None):
    """MLA attention; returns (y, cache).  Without a cache, or at a
    prefill (T > 1), per-head K/V are built from the latents and attention
    runs the flash kernel (q/k head dim qk_nope + qk_rope, v head dim
    v_head_dim); a decode step (T = 1) runs the *absorbed* form over the
    cached latents in f32 plain torch, as the reference does in plain jnp.
    The cache is updated in place.  ``pos``: an int, a 0-d tensor or, for
    T == 1, per-row (B,).  ``rope``: the (cos, sin) tables of these
    positions at qk_rope_head_dim, when the caller shares them."""
    b, t, _ = x.shape
    nq = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    pos0 = 0 if pos is None else pos

    q_nope, q_rope = _mla_q(p, x, cfg, lut)
    if rope is None:
        rope = rope_tables(positions(pos0, t, x.device), dr, cfg.rope_theta)
    cos, sin = rope
    q_rope = apply_rope(q_rope, cos, sin)

    kv_a = linear(x, p["wkv_a"], lut)                       # (b, t, r + dr)
    ckv = rms_norm(kv_a[..., :r], p["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., r:].reshape(b, t, 1, dr), cos, sin
                        ).reshape(b, t, dr)

    wkv_b = materialize_weight(p["wkv_b"], lut, x.dtype
                               ).reshape(nq, dn + dv, r)
    w_k, w_v = wkv_b[:, :dn], wkv_b[:, dn:]                 # (nq, dn|dv, r)

    def attend_latents(kv, kr, flash):
        """Per-head K/V of latents kv (b, L, r) and rope keys kr (b, L, dr),
        then ``flash(q_full, k_full, v)``; → (b, t, nq·dv) in x's dtype."""
        lmax = kv.shape[1]
        k_nope = torch.einsum("blr,hdr->blhd", kv.to(x.dtype), w_k)
        v = torch.einsum("blr,hdr->blhd", kv.to(x.dtype), w_v)
        k_full = torch.cat([k_nope, kr[:, :, None].to(x.dtype).expand(
            b, lmax, nq, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        # the flash kernel's default scale 1/sqrt(dn + dr) is MLA's
        return flash(q_full, k_full, v).to(x.dtype).reshape(b, t, nq * dv)

    if cache is None:
        o = attend_latents(ckv, k_rope,
                           lambda q, k, v: _attend_full(q, k, v, True))
        return linear(o, p["wo"], lut), None

    cckv = _kv_write(cache["ckv"], ckv.to(cache["ckv"].dtype), pos0)
    ckrope = _kv_write(cache["krope"], k_rope.to(cache["krope"].dtype), pos0)
    new_cache = {"ckv": cckv, "krope": ckrope}
    if t > 1:
        if t == cckv.shape[1]:
            # full prefill: the fresh latents are the cache's whole content
            o = attend_latents(ckv, k_rope,
                               lambda q, k, v: _attend_full(q, k, v, True))
        else:  # chunked prefill: flash over the cache (q_offset, a
            # launch argument, read on the host)
            o = attend_latents(cckv, ckrope, lambda q, k, v:
                               _attend_cache_flash(q, k, v, int(pos0)))
        return linear(o, p["wo"], lut), new_cache

    o = _by_row_pieces(
        lambda qn, qr, kv, kr, p: _mla_absorbed(qn, qr, kv, kr, w_k, w_v, p,
                                                dn + dr),
        b, x, q_nope, q_rope, cckv, ckrope, pos=pos0).to(x.dtype)
    return linear(o.reshape(b, t, nq * dv), p["wo"], lut), new_cache


def _mla_absorbed(q_nope, q_rope, cckv, ckrope, w_k, w_v, pos, d_qk: int):
    """MLA's decode (absorbed) over the cached latents: score =
    (q_nope·W_k)·ckv + q_rope·krope, in f32; on the card the batch padded
    to ROW_PAD rows (above).  → (b, t, nq, dv) f32."""
    f32 = torch.float32
    b, t = q_nope.shape[:2]
    pad = _row_pad(b, q_nope)
    qn, qr, kv, kr = pad(q_nope), pad(q_rope), pad(cckv), pad(ckrope)
    qc = torch.einsum("bthd,hdr->bthr", qn, w_k.to(f32))
    s_nope = torch.einsum("bthr,blr->bthl", qc, kv)
    s_rope = torch.einsum("bthd,bld->bthl", qr, kr)
    logits = (s_nope + s_rope) / math.sqrt(d_qk)
    mask = _decode_mask(pos, t, cckv.shape[1], q_nope.device)
    mask = mask[None, :, None, :] if mask.ndim == 2 else pad(
        mask[:, :, None, :], torch.bool)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    attn = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bthl,blr->bthr", attn, kv)
    return torch.einsum("bthr,hdr->bthd", o_lat, w_v.to(f32))[:b]


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


def _silu(g: torch.Tensor) -> torch.Tensor:
    """silu(g) op by op in g's dtype, as the reference's XLA program
    computes it (logistic = 1 / (1 + exp(−g)), each op rounded to bf16 in
    the quantized modes); a fused F.silu rounds differently and moves bf16
    activations by an ulp."""
    return g * (1.0 / (1.0 + torch.exp(-g)))


def _silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g)·u, each op in g's dtype (:func:`_silu`)."""
    return _silu(g) * u


def apply_mlp(p: Params, x: torch.Tensor, *, lut=None,
              decode: bool | None = None) -> torch.Tensor:
    g = linear(x, p["w_gate"], lut, decode=decode)
    u = linear(x, p["w_up"], lut, decode=decode)
    return linear(_silu_mul(g, u), p["w_down"], lut, decode=decode)


def init_moe(cfg, gen: torch.Generator, device,
             dtype=torch.float32) -> Params:
    d, e, ffe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": _normal((e, d), gen, device, dtype, 1.0 / math.sqrt(d)),
        "experts": {
            "w_gate": _normal((e, ffe, d), gen, device, dtype,
                              1.0 / math.sqrt(d)),
            "w_up": _normal((e, ffe, d), gen, device, dtype,
                            1.0 / math.sqrt(d)),
            "w_down": _normal((e, d, ffe), gen, device, dtype,
                              1.0 / math.sqrt(ffe)),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(d, ffe * cfg.n_shared_experts, gen, device,
                               dtype)
    return p


def _capacity(n_tokens: int, top_k: int, n_experts: int,
              factor: float) -> int:
    c = int(math.ceil(n_tokens * top_k / n_experts * factor))
    return max(4, min(c, n_tokens))


def expert_slots(expert_ids: torch.Tensor,
                 onehot: torch.Tensor) -> torch.Tensor:
    """The position of each (token, k) choice in its expert's queue,
    token-major: ``expert_ids`` (n_tok, k) and their one-hot (n_tok, k, E)
    → (n_tok · k,).  A choice at position ≥ the capacity is dropped."""
    flat_e = expert_ids.reshape(-1)
    oh = onehot.reshape(flat_e.shape[0], -1)
    return (torch.cumsum(oh, dim=0) - oh).gather(1, flat_e[:, None])[:, 0]


def dispatch_tables(expert_ids: torch.Tensor, slot: torch.Tensor,
                    gates: torch.Tensor, cap: int, n_experts: int):
    """The (E, cap) dispatch tables: the token each slot holds (n_tok
    where none: the zero row) and its gate, from each (token, k) choice's
    expert ``expert_ids`` (n_tok, k), its slot (:func:`expert_slots`) and
    its gate (n_tok, k).  A choice at a slot ≥ cap is dropped.  As in the
    reference, a dropped choice is scattered to a column ``cap`` that is
    cut off, so no shape depends on the routing (no mask, no nonzero)."""
    n_tok, k = expert_ids.shape
    dev = expert_ids.device
    where = (expert_ids.reshape(-1), torch.where(slot < cap, slot, cap))
    tok_idx = torch.arange(n_tok * k, device=dev) // k
    table = torch.full((n_experts, cap + 1), n_tok, dtype=torch.long,
                       device=dev).index_put_(where, tok_idx)
    gtable = torch.zeros((n_experts, cap + 1), dtype=torch.float32,
                         device=dev).index_put_(where, gates.reshape(-1))
    return table[:, :cap], gtable[:, :cap]


def _expert_ffn(experts: Params, xe: torch.Tensor, lut=None, *,
                plan_experts: int | None = None,
                decode: bool = False) -> torch.Tensor:
    """SwiGLU over the capacity-gathered token blocks xe (E, cap, d).  A
    compressed stack runs the grouped fused kernel (three launches, dense
    expert weights never exist), planned for ``plan_experts`` experts (a
    tiered cache stack passes the layer's count); dense and int8 stacks
    are materialized and multiplied, as in the reference.  ``decode``:
    the capacity rows are a decode step's tokens.  A mesh rank's share
    of a stack with xe of its own experts (the local-routing MoE) stays
    on the rank (``ops.grouped_decode_dequant_matmul``)."""
    def mm(h, w):
        if isinstance(w, PackedLinear) and w.codes.ndim == 3 \
                and lut is not None:
            return ops.grouped_decode_dequant_matmul(
                h, w, lut, out_dtype=h.dtype, plan_experts=plan_experts,
                decode=decode)
        return torch.einsum("ecx,eyx->ecy", h,
                            materialize_weight(w, lut, h.dtype))

    g = mm(xe, experts["w_gate"])
    u = mm(xe, experts["w_up"])
    return mm(_silu_mul(g, u), experts["w_down"])


def _grouped_ok(w, lut) -> bool:
    """A stack the grouped fused kernel takes at the lever's auto rung."""
    return (isinstance(w, PackedLinear) and bool(w.tile_n)
            and w.codes.ndim == 3 and lut is not None
            and ops._DEFAULT_IMPL == ops.Impl.AUTO.value)


def _expert_weight(w, i):
    """Expert ``i`` (an index, or a slice of experts) of a stacked expert
    weight (dense, int8 or packed)."""
    if getattr(w, "mesh_axes", None) is not None:
        raise ValueError("expert-by-expert decode (moe_expert_scan) takes "
                         "whole stacks, not a mesh rank's share")
    if isinstance(w, (PackedLinear, QuantLinear)):
        return dataclasses.replace(w, **{
            f.name: getattr(w, f.name)[i] for f in dataclasses.fields(w)
            if isinstance(getattr(w, f.name), torch.Tensor)})
    return w[i]


def _expert_scan(experts: Params, xe: torch.Tensor, lut=None) -> torch.Tensor:
    """The reference's ``moe_expert_scan``: experts one at a time, each
    one's three weights decoded to dense (``materialize_weight``: the
    dict-decode kernel, then the dequantize) and multiplied, so at most
    one expert is dense at once: peak memory is the compressed stacks plus
    one expert's dense weights."""
    out = []
    for i in range(xe.shape[0]):
        w = {k: materialize_weight(_expert_weight(experts[k], i), lut,
                                   xe.dtype)
             for k in ("w_gate", "w_up", "w_down")}
        g, u = xe[i] @ w["w_gate"].T, xe[i] @ w["w_up"].T
        out.append(_silu_mul(g, u) @ w["w_down"].T)
    return torch.stack(out)


def apply_moe(p: Params, x: torch.Tensor, cfg, *, lut=None,
              with_routing: bool = False,
              expert_ids: torch.Tensor | None = None):
    """Capacity-based top-k MoE with global dispatch; returns (y, aux) or,
    with ``with_routing``, (y, aux, expert_ids (n_tok, k)).  Given
    ``expert_ids`` (n_tok, k), each token goes to those experts instead of
    its top-k, gated by the router's probabilities of them, renormalized:
    two runs then share one routing and capacity slots.

    Routing follows the reference: softmax over the router logits (the
    router runs in x's dtype, as ``linear`` casts it), top-k with the lower
    expert first on ties (a stable descending sort, as ``lax.top_k``),
    gates renormalized, capacity slots in token-major order with slots ≥
    cap dropped.  The combine adds each token's gated expert outputs in
    ascending expert order in x's dtype, as the reference's scatter-add
    does; it is a fixed-order gather and add, never an atomic scatter.

    Inside ``sharding.partition.rows_split`` (a training step on a mesh
    whose data ranks each take a share of the microbatch's rows) the
    capacity, the slots and the aux loss are the whole microbatch's, as
    the reference's global program computes them.

    ``p["residency"]`` (per-layer ``slot_of_expert`` (E,) and
    ``expert_of_slot`` (C,) index tensors, set by the tiered-residency
    manager) marks ``p["experts"]`` as C-slot cache stacks.  With
    ``cfg.moe_expert_scan`` and no residency, experts are decoded and
    multiplied one at a time."""
    if (getattr(cfg, "moe_local_dispatch", False) and not with_routing
            and expert_ids is None and p.get("residency") is None):
        _, mesh = PT.current_mesh()
        if mesh is not None:
            msize = mesh.shape.get("model", 1)
            bsize = mesh.axis_size(("pod", "data"))
            if (msize > 1 and cfg.n_experts % msize == 0
                    and x.shape[0] % bsize == 0):
                return apply_moe_local(p, x, cfg, lut=lut)
        # no mesh / non-divisible batch: global dispatch below
    b, t, d = x.shape
    n_tok = b * t
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(n_tok, d)

    decode = t == 1       # one token a row: a decode step's rows
    router_logits = linear(xf, p["router"], lut, decode=decode
                           ).to(torch.float32)
    probs = torch.softmax(router_logits, dim=-1)
    if expert_ids is None:
        srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, expert_ids = srt[:, :k], order[:, :k]    # (n_tok, k)
    else:
        gate_vals = probs.gather(1, expert_ids)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # Load-balance aux loss (Switch-style): e · Σ_e f_e · P_e.
    onehot = torch.nn.functional.one_hot(expert_ids, e)     # (n, k, e)
    flat_e = expert_ids.reshape(-1)                         # (n·k,)
    slot = expert_slots(expert_ids, onehot)
    split = PT.row_split()
    if split is None:
        f = onehot.to(torch.float32).sum(dim=1).mean(dim=0)
        aux = e * torch.sum(f * probs.mean(dim=0))
        cap = _capacity(n_tok, k, e, cfg.capacity_factor)
        keep = slot < cap
    else:
        # A training rank's share of the microbatch's rows: the aux loss,
        # the capacity and each choice's slot are the whole microbatch's.
        # f and P are means over all its tokens (a sum whose backward
        # sums over the data ranks); a choice's slot is its global
        # token-major rank, the lower data ranks' counts for its expert
        # before it; the table holds the rank's kept choices.
        mesh, axes = split
        n_all = n_tok * mesh.axis_size(axes)
        sums = mesh.psum_diff(torch.cat([
            onehot.to(torch.float32).sum(dim=1).sum(dim=0),
            probs.sum(dim=0)]), axes)
        f, pm = sums[:e] / n_all, sums[e:] / n_all
        aux = e * torch.sum(f * pm)
        cap = _capacity(n_all, k, e, cfg.capacity_factor)
        counts = mesh.all_gather(onehot.sum(dim=(0, 1))[None], axes, dim=0)
        before = counts[:mesh.axis_index(axes)].sum(dim=0)
        keep = slot + before[flat_e] < cap
        slot = torch.where(keep, slot, cap)
    # at call time: the testing package imports the serving stack
    from ..testing import routes
    routes.record(expert_ids, keep.reshape(n_tok, k), aux)
    table, gtable = dispatch_tables(expert_ids, slot, gate_vals, cap, e)

    xpad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    res = p.get("residency")
    if getattr(cfg, "moe_expert_scan", False) and res is None:
        ye = _expert_scan(p["experts"], xpad[table], lut)
    elif res is not None:
        # Tiered residency: the stacks hold the C cached slots.  Gather
        # the tokens into slot order (a vacant slot's sentinel e reads the
        # pad row of the table, whose tokens are the zero row), run the
        # grouped kernel over the C slots, scatter back to expert order
        # (an absent expert's sentinel C reads a zero row).  The combine
        # reads only routed experts, all of them resident when a step
        # commits (serve/residency.py), so y is the fully resident one.
        tpad = torch.cat([table, table.new_full((1, cap), n_tok)], dim=0)
        ye_c = _expert_ffn(p["experts"],
                           xpad[tpad.index_select(0,
                                                  res["expert_of_slot"])],
                           lut, plan_experts=e, decode=decode)  # (C, cap, d)
        ye = torch.cat([ye_c, ye_c.new_zeros((1, cap, d))], dim=0
                       ).index_select(0, res["slot_of_expert"])
    else:
        ye = _expert_ffn(p["experts"], xpad[table], lut, plan_experts=e,
                         decode=decode)                     # (e, cap, d)
    contrib = ye.to(x.dtype) * gtable[..., None].to(x.dtype)
    contrib = torch.cat([contrib.reshape(e * cap, d),
                         contrib.new_zeros((1, d))], dim=0)  # last: dropped
    where = torch.where(keep, flat_e * cap + slot, e * cap).reshape(n_tok, k)
    where = where.gather(1, torch.argsort(expert_ids, dim=1))  # by expert
    y = torch.zeros((n_tok, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + contrib[where[:, j]]

    if "shared" in p:
        y = y + apply_mlp(p["shared"], xf, lut=lut, decode=decode)
    y = y.reshape(b, t, d)
    if with_routing:
        return y, aux, expert_ids
    return y, aux


def apply_moe_local(p: Params, x: torch.Tensor, cfg, *, lut=None):
    """Local-routing MoE on the active mesh (the reference's
    ``apply_moe_local``, its ``shard_map`` over ranks).  → (y, aux).

    Each rank takes its (pod, data) shard of the batch's rows and the
    E/model experts of its model shard: the router runs in f32 over the
    whole expert set (so every rank has the same gates), a choice of an
    expert outside the rank's range is left to its owner, and the rank's
    tokens go to its experts at the reference's per-(token shard, expert)
    capacity — dropless, the global path's outputs; where the capacity
    drops, another drop than the global path's, as in the reference.
    Compressed stacks (placed on the ranks by ``place_params``) run K3
    over the rank's experts, planned for all E ('grouped_fused_shard_map',
    counted once a call as in the reference); other stacks are decoded
    to the rank's dense experts.  The partial outputs are summed over
    model in x's dtype (``Mesh.psum``: rank order, the same bits on every
    rank), ``aux`` is averaged over model and the batch axes, and the
    rows are gathered back over the batch axes (activations stay
    replicated in this slice).  The shared experts run on all rows."""
    _, mesh = PT.current_mesh()
    e_full, k = cfg.n_experts, cfg.top_k
    b, t, d = x.shape
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    bsize = mesh.axis_size(batch_axes)
    bl = b // bsize
    bi = mesh.axis_index(batch_axes)
    msize = mesh.shape["model"]
    e_loc = e_full // msize
    offset = mesh.axis_index("model") * e_loc
    experts = p["experts"]
    names = ("w_gate", "w_up", "w_down")
    local = {name: experts[name] if getattr(experts[name], "mesh_axes",
                                            None) is not None
             else _expert_weight(experts[name], slice(offset, offset + e_loc))
             for name in names}
    grouped = all(_grouped_ok(local[n], lut) for n in names)
    if grouped:
        ops.DISPATCH_COUNTS["grouped_fused_shard_map"] += 1
    router_w = materialize_weight(p["router"], lut, torch.float32)

    x_loc = x[bi * bl:(bi + 1) * bl]
    n_tok = bl * t
    xf = x_loc.reshape(n_tok, d)
    probs = torch.softmax(xf.to(torch.float32) @ router_w.T, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = srt[:, :k], order[:, :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(expert_ids, e_full)
    f = onehot.to(torch.float32).sum(dim=1).mean(dim=0)
    aux = e_full * torch.sum(f * probs.mean(dim=0))

    cap = _capacity(n_tok, k, e_full, cfg.capacity_factor)
    local_ids = expert_ids - offset
    owned = (local_ids >= 0) & (local_ids < e_loc)
    lid = torch.where(owned, local_ids, e_loc)          # e_loc: not ours
    oh = torch.nn.functional.one_hot(lid, e_loc + 1)[..., :e_loc]
    slot = expert_slots(torch.where(owned, local_ids, 0), oh)
    slot = torch.where(owned.reshape(-1), slot, cap)    # unowned: dropped
    table, gtable = dispatch_tables(torch.where(owned, local_ids, 0), slot,
                                    gate_vals, cap, e_loc)
    keep = slot < cap
    xpad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    ye = _expert_ffn(local, xpad[table], lut, plan_experts=e_full,
                     decode=t == 1)                      # (e_loc, cap, d)
    contrib = ye.to(x.dtype) * gtable[..., None].to(x.dtype)
    contrib = torch.cat([contrib.reshape(e_loc * cap, d),
                         contrib.new_zeros((1, d))], dim=0)
    flat = torch.where(owned, local_ids, 0).reshape(-1)
    where = torch.where(keep, flat * cap + slot, e_loc * cap
                        ).reshape(n_tok, k)
    where = where.gather(1, torch.argsort(expert_ids, dim=1))  # by expert
    y = torch.zeros((n_tok, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + contrib[where[:, j]]
    y = mesh.psum(y, "model")
    aux = mesh.pmean(mesh.pmean(aux, "model"), batch_axes)
    y = mesh.all_gather(y.reshape(bl, t, d), batch_axes, dim=0)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x.reshape(b * t, d), lut=lut,
                          decode=t == 1).reshape(b, t, d)
    return y, aux
