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
from ..launch.mesh import copy_to_model, reduce_from_model
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
                               out_dtype=x.dtype, decode=decode,
                               mesh_axes=w.mesh_axes)
    elif decode and x.is_cuda:
        y = _dense_decode(x, w.to(x.dtype))
    else:
        y = x @ w.to(x.dtype).T
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _model_axis():
    """(mesh, model ranks, this rank's model index) of the active mesh
    where its model axis has more than one rank, else (None, 1, 0)."""
    mesh = PT.current_mesh()[1]
    ms = mesh.shape.get("model", 1) if mesh is not None else 1
    if ms <= 1 or mesh.size <= 1:
        return None, 1, 0
    return mesh, ms, mesh.axis_index("model")


def _heads_axis(cache=None):
    """(training, mesh, model ranks, model index) that a layer computes its
    heads on: a tensor-parallel training rank's (``partition.tp_mesh``; a
    layer given no cache), whose weights are its bands already and whose
    row-parallel outputs are summed over model; else the serving mesh's
    (:func:`_model_axis`), whose weights are whole and whose column-
    parallel outputs are gathered before a row-parallel weight."""
    mesh, ms, m = PT.tp_mesh()
    if mesh is not None and cache is None:
        return True, mesh, ms, m
    return (False,) + _model_axis()


def _copier(train: bool, mesh):
    """``copy_to_model`` on a training rank (a tensor every model rank
    holds whole and reads in part: its gradient sums the ranks' parts),
    else the identity."""
    if not train:
        return lambda t: t
    return lambda t: copy_to_model(t, mesh)


def _row_parallel(o, w, lut, train: bool, band: bool, mesh):
    """``linear(o, w)`` where ``o`` holds the rank's band of ``w``'s input
    (``band``): a training rank sums its partial product over model
    (``reduce_from_model``); a serving rank gathers ``o`` over model
    first (the x gather of a row-parallel weight)."""
    if band and not train:
        o = mesh.all_gather(o, "model", dim=-1)
    y = linear(o, w, lut)
    return reduce_from_model(y, mesh) if band and train else y


# ---------------------------------------------------------------------------
# The reference's per-block remat (``jax.checkpoint`` on the scan body).
# ---------------------------------------------------------------------------

_RECOMPUTING = [0]


def remat_on(cfg, w) -> bool:
    """Whether a stack's blocks run checkpointed: ``cfg.remat`` where
    autograd records (a train step: grad enabled and the model's weights,
    of which ``w`` is one, require it), as the reference wraps its scan
    body in ``jax.checkpoint``; serving never."""
    return (bool(getattr(cfg, "remat", False)) and torch.is_grad_enabled()
            and bool(getattr(w, "requires_grad", False)))


def recomputing() -> bool:
    """Whether a checkpointed block is being recomputed in the backward
    (its forward ran before): a recorder of the forward's decisions
    (``testing.routes``) then records nothing again."""
    return _RECOMPUTING[0] > 0


def block(fn, *args, remat: bool):
    """``fn(*args)``; with ``remat``, under ``torch.utils.checkpoint``
    (non-reentrant): the block keeps its inputs alone, and its saved
    tensors are recomputed in the backward.  The recompute runs the same
    ops on the same inputs, so losses and gradients are those without
    remat, bit for bit."""
    if not remat:
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    calls = [0]

    def body(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        _RECOMPUTING[0] += 1
        try:
            return fn(*a)
        finally:
            _RECOMPUTING[0] -= 1

    return checkpoint(body, *args, use_reentrant=False,
                      preserve_rng_state=False)


def linear_band(x: torch.Tensor, w, lut=None, bias=None,
                decode: bool | None = None) -> torch.Tensor:
    """The rank's ``model`` band of ``linear(x, w, lut, bias)``'s output
    columns on the active mesh (a column-parallel product left on its
    band, the reference's ``out_specs``): K1 or K5 on the rank's own band
    of the weight, no gather; a weight the rank holds whole (dense, or
    left whole by the placement gates) gives the whole product, cut."""
    mesh, ms, m = _model_axis()
    if mesh is None:
        return linear(x, w, lut, bias, decode)
    if decode is None:
        decode = x.ndim == 3 and x.shape[1] == 1
    if isinstance(w, (PackedLinear, TiledPackedLinear)):
        y = ops.decode_dequant_matmul(x, w, lut, out_dtype=x.dtype,
                                      decode=decode, gather=False)
    elif isinstance(w, QuantLinear):
        y = ops.dequant_matmul(x, w.values, w.scale, w.zero,
                               out_dtype=x.dtype, decode=decode,
                               gather=False, mesh_axes=w.mesh_axes)
    else:
        y = ops._model_cols(linear(x, w, lut, decode=decode), mesh)
    if bias is not None:
        per = bias.shape[0] // ms
        y = y + bias[m * per:(m + 1) * per].to(y.dtype)
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


def materialize_band(w, lut=None, dtype=None):
    """The rank's ``model`` band of the rows of ``w``'s dense weight on
    the active mesh (MLA's ``wkv_b``: the rank's heads), decoded from the
    rank's own band of the planes where it holds one over the model axis
    alone (no gather); else the whole weight decoded, then cut."""
    mesh, ms, m = _model_axis()
    if mesh is None:
        return materialize_weight(w, lut, dtype)
    if (isinstance(w, (PackedLinear, TiledPackedLinear)) and not
            w.GROUP_AXES and tuple(w.mesh_axes or ()) == ("model",)):
        MATERIALIZE_COUNTS["packed"] += 1
        return w.materialize(lut, torch.bfloat16 if dtype is None else dtype,
                             plain=ops.plain_decode())
    dense = materialize_weight(w, lut, dtype)
    per = dense.shape[-2] // ms
    return dense[..., m * per:(m + 1) * per, :]


def embed(w, ids: torch.Tensor, lut=None, band: bool = False
          ) -> torch.Tensor:
    """Embedding lookup from dense or int8 tables (rows = vocab).  A mesh
    rank's vocab band (``partition.place_vocab``) is looked up vocab-
    parallel: an id outside the band reads a zero row, and each row is
    taken from the one rank whose band holds it (every rank's rows
    gathered over model, in rank order: exact).  ``band``: ``w`` is a
    training rank's dense vocab band (``partition.kept_band``), looked up
    the same way under autograd: ids outside the band read zero rows,
    summed over model (``launch.mesh.reduce_from_model``: one rank's row
    and zeros, exact)."""
    mesh, _, m = PT.tp_mesh()
    if band and mesh is not None:
        per = w.shape[0]
        local = ids - m * per
        mine = (local >= 0) & (local < per)
        rows = w[torch.where(mine, local, torch.zeros_like(local))]
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return reduce_from_model(rows, mesh)
    if isinstance(w, QuantLinear) and w.mesh_axes is not None:
        mesh = PT.current_mesh()[1]
        if mesh is None:
            raise ValueError("embed: a mesh rank's vocab band needs its "
                             "mesh active (sharding.partition.active_mesh)")
        per = w.values.shape[0]
        owner = torch.div(ids, per, rounding_mode="floor")
        local = ids - owner * per
        mine = owner == mesh.axis_index(w.mesh_axes)
        rows = embed(dataclasses.replace(w, mesh_axes=None),
                     torch.where(mine, local, torch.zeros_like(local)))
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        parts = mesh.all_gather(rows[None], w.mesh_axes, dim=0)
        return torch.gather(parts, 0, owner[None, ..., None].expand(
            (1,) + tuple(rows.shape)))[0]
    if isinstance(w, QuantLinear):
        rows = w.values[ids].to(torch.float32)
        return ((rows - w.zero[ids, 0][..., None])
                * w.scale[ids, 0][..., None]).to(torch.bfloat16)
    if isinstance(w, PackedLinear):  # decode then gather (rare path)
        MATERIALIZE_COUNTS["packed"] += 1
        return w.materialize(lut, torch.bfloat16,
                             plain=ops.plain_decode())[ids]
    return w[ids]


def head_logits(x: torch.Tensor, head, lut=None,
                band: bool = False) -> torch.Tensor:
    """The LM head's logits; ``band``: ``head`` is a tensor-parallel
    training rank's vocab band (``partition.kept_band``), which gives its
    band of the vocab (a column-parallel product: ``train/steps.py``'s
    loss reduces it over model)."""
    mesh, _, _ = PT.tp_mesh()
    if band and mesh is not None:
        return linear(copy_to_model(x, mesh), head)
    return linear(x, head, lut)


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


def square_pieces(xf: torch.Tensor, pieces: int) -> torch.Tensor:
    """The sums of squares of ``pieces`` equal pieces of ``xf``'s last dim,
    (..., pieces): a model rank's share of :func:`_mean_square`'s 16
    pieces of a row it holds 16/ms of (``ssm.apply_mamba2``'s gated norm).
    Rows are padded with zero rows to 16 outputs or more, the layout
    ``_mean_square``'s 16 pieces a row have at any number of rows."""
    lead, d = xf.shape[:-1], xf.shape[-1]
    sq = (xf * xf).reshape(-1, pieces, d // pieces)
    rows = sq.shape[0]
    need = -(-16 // pieces)
    if rows < need:
        sq = torch.nn.functional.pad(sq, (0, 0, 0, 0, 0, need - rows))
    return sq.sum(dim=-1)[:rows].reshape(*lead, pieces)


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


def _decode_mask(pos, t: int, lmax: int, device,
                 start: int = 0) -> torch.Tensor:
    """Which of ``lmax`` cache positions (from position ``start``: a
    rank's block) each of ``t`` queries at ``pos`` sees: (t, L) for a
    shared offset, (B, t, L) per row."""
    return (start + torch.arange(lmax, device=device)
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

# The most a mesh rank's decode attention may add, in padded f32 K and V
# of one layer, to run its einsums' GEMMs at one process's batch count
# (``_attend_cached``'s ``kv_heads``).  The pad costs a rank one process's
# transient (ROW_PAD rows of every kv head), so at long contexts or many
# model ranks it is not taken: a rank's heads then keep their rows'
# padding alone, within 2 bf16 ulps of one process (``PERF.md`` §6, the
# dry run: Zamba2's ``long_500k`` would hold 208 GB of it on 16 ranks).
KV_PAD_BYTES = 256 * 2 ** 20


def _by_row_pieces(fn, b: int, x: torch.Tensor, *rows, pos):
    """``fn(*rows, pos)`` on the card in pieces of ROW_PAD rows of the
    batch, concatenated, where the batch ``b`` is larger; else one call.
    ``rows`` are (B, ...) tensors; ``pos`` an int, a 0-d tensor or (B,)."""
    if not x.is_cuda or b <= ROW_PAD:
        return fn(*rows, pos)
    outs = [fn(*(r[i:i + ROW_PAD] for r in rows),
               pos[i:i + ROW_PAD] if torch.is_tensor(pos)
               and pos.ndim == 1 else pos)
            for i in range(0, b, ROW_PAD)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(z) for z in zip(*outs))
    return torch.cat(outs)


def _row_pad(b: int, x: torch.Tensor, rows: int = ROW_PAD):
    """A function taking a (b, ...) tensor to f32 (or ``dtype``) and, on
    the card below ``rows`` (ROW_PAD) rows, to ``rows`` rows: its own,
    then rows left unwritten.  Every output row of the einsums below comes
    from its own input rows alone, so the pad rows reach no row that is
    kept, and the padded copy costs what the f32 copy did."""
    if not x.is_cuda or b >= rows:
        return lambda a, dtype=torch.float32: a.to(dtype)

    def pad(a, dtype=torch.float32):
        out = a.new_empty((rows,) + tuple(a.shape[1:]), dtype=dtype)
        out[:b] = a
        return out
    return pad


def _attend_cached(q, cache_k, cache_v, pos, t_new: int,
                   start: int | None = None, kv_heads: int | None = None):
    """Decode attention over a cache (plain torch, as the reference's is
    plain jnp): positions past a row's ``pos + t_new − 1`` get −1e30, whose
    exp is exactly 0.  ``pos``: an int, a 0-d tensor or per-row (B,).  In
    f32; on the card the batch padded to ROW_PAD rows (above).

    ``start``: the cache is a mesh rank's block of positions from
    ``start``; → the block's partials (:func:`_softmax_parts`), which
    :func:`_merge_parts` merges over the model ranks.  ``kv_heads``: the
    model's kv heads, of which the cache holds a mesh rank's share; on
    the card the rows are then padded to ROW_PAD · kv_heads / its heads
    where the padded f32 K and V fit KV_PAD_BYTES, so the einsums' GEMMs
    run (ROW_PAD · kv heads) batches, as one process runs them over every
    head: cuBLAS picks a batched GEMM by its batch count too, and a
    head's bits would otherwise follow the rank's head count
    (``tools/mesh_bits.py``)."""
    b = q.shape[0]
    if q.is_cuda and b > ROW_PAD:
        return _by_row_pieces(
            lambda qq, kk, vv, p: _attend_cached(qq, kk, vv, p, t_new, start,
                                                 kv_heads),
            b, q, q, cache_k, cache_v, pos=pos)
    b, t, hq, hd = q.shape
    hkv = cache_k.shape[2]
    rep = hq // hkv
    lmax = cache_k.shape[1]
    rows = ROW_PAD * (kv_heads or hkv) // hkv
    if rows * lmax * hkv * (hd + cache_v.shape[-1]) * 4 > KV_PAD_BYTES:
        rows = ROW_PAD
    pad = _row_pad(b, q, rows)
    qf = pad(q.reshape(b, t, hkv, rep, hd))
    kf, vf = pad(cache_k), pad(cache_v)
    logits = torch.einsum("btgrd,blgd->btgrl", qf, kf) / math.sqrt(hd)
    mask = _decode_mask(pos, t, lmax, q.device, start or 0)
    mask = (mask[None, :, None, None, :] if mask.ndim == 2
            else pad(mask[:, :, None, None, :], torch.bool))
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    if start is not None:
        mx, s, e = _softmax_parts(logits)
        out = torch.einsum("btgrl,blgd->btgrd", e, vf)[:b]
        return (mx[:b].reshape(b, t, hq, 1), s[:b].reshape(b, t, hq, 1),
                out.reshape(b, t, hq, hd))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("btgrl,blgd->btgrd", p, vf)[:b]
    return out.reshape(b, t, hq, hd).to(q.dtype)


def _softmax_parts(logits):
    """One block's share of a softmax over its last dim: its running max,
    its sum of exp(logit − max) and those exps (f32)."""
    mx = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - mx)
    return mx, e.sum(dim=-1, keepdim=True), e


def _merge_parts(mesh, mx, s, o):
    """Flash-decoding's merge of the model ranks' blocks: each rank's
    (max, sum, unnormalized f32 output) gathered over model and combined
    in rank order, → the normalized output, the same bits on every rank.
    Rank 0's block holds position 0, so every row sees a position."""
    parts = mesh.all_gather(torch.cat([o, mx, s], dim=-1)[None], "model",
                            dim=0)
    d = o.shape[-1]
    po, pm, ps = parts[..., :d], parts[..., d:d + 1], parts[..., d + 1:]
    big = pm.amax(dim=0)
    w = torch.exp(pm - big)
    num, den = po[0] * w[0], ps[0] * w[0]
    for r in range(1, parts.shape[0]):
        num = num + po[r] * w[r]
        den = den + ps[r] * w[r]
    return num / den


def _kv_write_block(dst: torch.Tensor, src: torch.Tensor, pos, start: int):
    """Write the entries of ``src`` (B, T, ...) at positions ``pos`` ..
    ``pos + T − 1`` that fall in a mesh rank's block of the cache ``dst``
    (B, L_block, ...), positions ``start`` .. ``start + L_block − 1``, in
    place; the others belong to another rank.  ``pos``: an int, a 0-d
    tensor (T = 1) or per-row (B,) (T = 1).  A tensor position stays on
    the device: an entry outside the block writes back what its clamped
    slot holds."""
    t, lb = src.shape[1], dst.shape[1]
    if not torch.is_tensor(pos):
        lo, hi = max(int(pos), start), min(int(pos) + t, start + lb)
        if lo < hi:
            dst[:, lo - start:hi - start] = src[:, lo - int(pos):hi - int(pos)]
        return dst
    if t != 1:
        raise ValueError("a tensor position writes one token at a time "
                         f"into a rank's block of positions; got T={t}")
    local = pos - start
    ok = (local >= 0) & (local < lb)
    idx = torch.clamp(local, 0, lb - 1)
    if pos.ndim == 0:
        cur = dst.index_select(1, idx[None])
        keep = ok.reshape((1,) * cur.ndim)
        dst.index_copy_(1, idx[None], torch.where(keep, src, cur))
    else:
        rows = torch.arange(dst.shape[0], device=dst.device)
        cur = dst[rows, idx]
        keep = ok.reshape((-1,) + (1,) * (cur.ndim - 1))
        dst.index_put_((rows, idx), torch.where(keep, src[:, 0], cur))
    return dst


def _q_heads_kv(k, v, nq: int, first: int, count: int):
    """The K/V heads that q heads ``first`` .. ``first + count − 1`` of
    ``nq`` read (GQA), from whole K/V (B, T, kv heads, hd): a contiguous
    run where the heads' groups align with it, else one K/V head per q
    head."""
    rep = nq // k.shape[2]
    if count % rep == 0 and first % rep == 0:
        sl = slice(first // rep, (first + count) // rep)
        return k[:, :, sl], v[:, :, sl]
    idx = torch.div(first + torch.arange(count, device=k.device), rep,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def apply_attention(p: Params, x: torch.Tensor, cfg, *, lut=None,
                    cache: Optional[Params] = None, pos=None,
                    causal: bool = True, rope=None):
    """Returns (y, cache). ``cache=None`` → full attention; with a cache:
    writes k/v at ``pos`` (in place) then attends ≤ pos.  ``pos``: an int,
    a 0-d tensor or, for T == 1, per-row (B,).  ``rope``: the (cos, sin)
    tables of these positions, when the caller shares one pair across
    layers.

    On a mesh whose model axis has more than one rank (the reference's
    ``_attend_full`` / ``_attend_cache_flash`` placements, ``cache`` the
    rank's share, ``partition.serve_cache_specs``):
      * kv heads divide the model ranks: q/k/v come from the rank's bands
        of wq/wk/wv (:func:`linear_band`, no gather), the rank's heads
        attend over its cache of those heads, and ``o`` is gathered over
        model just before ``wo`` (the x gather of a row-parallel weight);
      * they do not, at a prefill (or without a cache): k/v are made
        whole (a transient, as the reference replicates them), q keeps
        the rank's heads where the q heads divide, K2 runs on them, and
        only the rank's block of positions is written into its cache;
      * they do not, at a decode step: every head attends over the
        rank's block of positions (``_attend_cached``'s f32 math,
        ``ROW_PAD`` and mask), and the blocks' partials are merged over
        model in rank order (:func:`_merge_parts`), the same on every
        rank.
    An int8 cache's scales follow their k/v.

    A tensor-parallel training rank (no cache, ``partition.tp_mesh``)
    holds its bands of wq/wk/wv/bq/bk/bv/wo already (the gather on use):
    q/k/v are column-parallel on them, K2 runs on the rank's q heads, and
    wo is row-parallel, its product summed over model (the reference's
    SPMD placement).  Where the kv heads do not divide the model ranks,
    wk/wv are whole on every rank, k/v are computed whole and the rank's
    q heads read theirs.  A tensor every model rank holds whole and reads
    in part (x before its bands, whole k/v, the qk-norm weights on its
    heads) passes ``copy_to_model``, so its gradient sums the ranks'
    parts."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    train, mesh, ms, m = _heads_axis(cache)
    heads = ms > 1 and nkv % ms == 0
    spread = ms > 1 and not heads and cache is not None
    qband = ms > 1 and nq % ms == 0 and not (spread and t == 1)
    nq_l = nq // ms if qband else nq
    nkv_l = nkv // ms if heads else nkv
    cm = _copier(train, mesh)
    xb = cm(x) if qband else x

    def proj(name, n, band):
        fn = linear_band if band and not train else linear
        return fn(xb if band else x, p["w" + name], lut,
                  p.get("b" + name)).reshape(b, t, n, hd)

    q, k, v = proj("q", nq_l, qband), proj("k", nkv_l, heads), \
        proj("v", nkv_l, heads)
    if cfg.qk_norm:
        q = rms_norm(q, cm(p["q_norm"]) if qband else p["q_norm"],
                     cfg.norm_eps)
        k = rms_norm(k, cm(p["k_norm"]) if heads else p["k_norm"],
                     cfg.norm_eps)

    pos0 = 0 if pos is None else pos
    if rope is None:
        rope = rope_tables(positions(pos0, t, x.device), hd, cfg.rope_theta)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if qband and not heads:          # the K/V heads the rank's q heads read
        k_q, v_q = _q_heads_kv(cm(k), cm(v), nq, m * nq_l, nq_l)
    else:
        k_q, v_q = k, v
    if cache is None:
        o = _attend_full(q, k_q, v_q, causal)
    elif spread:
        o = _attend_spread(q, k, v, k_q, v_q, cache, pos0, mesh, m, nq,
                           nq_l)
    else:
        if cache["k"].shape[2] != nkv_l:
            raise ValueError(
                f"a cache of {cache['k'].shape[2]} kv heads on a rank that "
                f"computes {nkv_l}: on a mesh the cache is the rank's share "
                "(lm.init_caches(..., mesh=), partition.place_caches)")
        ck, cv = _store_kv(cache, k, v, pos0, _kv_write, q.dtype)
        if t == 1:
            o = _attend_cached(q, ck, cv, pos0, t, kv_heads=nkv)
        elif t == ck.shape[1]:
            # full prefill: the fresh k/v are the cache's whole content
            o = _attend_full(q, k, v, causal)
        else:  # chunked prefill: flash over the cache (q_offset, a
            # launch argument, read on the host)
            o = _attend_cache_flash(q, ck, cv, int(pos0))
    o = o.reshape(b, t, nq_l * hd)
    return _row_parallel(o, p["wo"], lut, train, qband, mesh), cache


def _store_kv(cache, k, v, pos, write, dtype):
    """Write ``k``/``v`` into ``cache`` with ``write(dst, src, pos)`` (an
    int8 cache: their codes and scales) → the cache's K/V to attend over
    (an int8 cache's dequantized to ``dtype``)."""
    if cache["k"].dtype == torch.int8:
        # int8 cache: codes and scales written in place; attention reads
        # the whole cache dequantized to q's dtype
        for name, val in (("k", k), ("v", v)):
            codes, scale = _quant_kv(val)
            write(cache[name], codes, pos)
            write(cache[name + "_scale"], scale, pos)
        return (_dequant_kv(cache["k"], cache["k_scale"], dtype),
                _dequant_kv(cache["v"], cache["v_scale"], dtype))
    return (write(cache["k"], k.to(cache["k"].dtype), pos),
            write(cache["v"], v.to(cache["v"].dtype), pos))


def _attend_spread(q, k, v, k_q, v_q, cache, pos, mesh, m: int, nq: int,
                   nq_l: int):
    """Attention on a mesh whose model ranks each hold a block of the
    cache's positions (:func:`apply_attention`): the rank's block of the
    new k/v written in place; a decode step's partials over the block
    merged over model; a prefill's q heads over the fresh k/v (from
    position 0) or over the blocks gathered whole."""
    t = q.shape[1]
    start = m * cache["k"].shape[1]
    ck, cv = _store_kv(cache, k, v, pos, lambda d, s, p: _kv_write_block(
        d, s, p, start), q.dtype)
    if t == 1:
        mx, s, o = _attend_cached(q, ck, cv, pos, t, start=start)
        return _merge_parts(mesh, mx, s, o).to(q.dtype)
    if not torch.is_tensor(pos) and int(pos) == 0:
        # the fresh k/v are everything before and at these positions
        return _attend_full(q, k_q, v_q, True)
    ck = mesh.all_gather(ck, "model", dim=1)
    cv = mesh.all_gather(cv, "model", dim=1)
    ck, cv = _q_heads_kv(ck, cv, nq, m * nq_l, nq_l) if nq_l < nq \
        else (ck, cv)
    return _attend_cache_flash(q, ck, cv, int(pos))


def apply_cross_attention(p: Params, x: torch.Tensor, enc_k, enc_v, cfg, *,
                          lut=None) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (B, S, H, hd):
    no rope, no mask, the flash kernel at any T (a decode step's q is one
    row a request).  On a mesh whose model ranks divide the kv heads,
    ``enc_k``/``enc_v`` are the rank's heads (:func:`project_enc_kv`), q
    its band, and ``o`` is gathered over model before ``wo``.  A
    tensor-parallel training rank computes its q heads wherever the model
    ranks divide them (reading its heads' K/V from whole ones where the
    kv heads do not divide), and wo is row-parallel, summed over model
    (:func:`apply_attention`)."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    nq = cfg.n_heads
    train, mesh, ms, m = _heads_axis()
    heads = ms > 1 and cfg.n_kv_heads % ms == 0
    qband = heads or (train and ms > 1 and nq % ms == 0)
    nq_l = nq // ms if qband else nq
    cm = _copier(train, mesh)
    fn = linear_band if qband and not train else linear
    q = fn(cm(x) if qband else x, p["wq"], lut, p.get("bq")).reshape(
        b, t, nq_l, hd)
    if qband and not heads:       # whole K/V: the rank's q heads read theirs
        enc_k, enc_v = _q_heads_kv(cm(enc_k), cm(enc_v), nq, m * nq_l, nq_l)
    o = _attend_full(q, enc_k, enc_v, causal=False).reshape(b, t, nq_l * hd)
    return _row_parallel(o, p["wo"], lut, train, qband, mesh)


def project_enc_kv(p: Params, enc_out: torch.Tensor, cfg, *, lut=None):
    """A decoder layer's cross-attention K/V of the encoder's output:
    (B, S, kv heads, hd) each; on a mesh whose model ranks divide the kv
    heads, the rank's heads (its bands of wk/wv; a training rank's input
    through ``copy_to_model``)."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    train, mesh, ms, _ = _heads_axis()
    heads = ms > 1 and cfg.n_kv_heads % ms == 0
    nkv = cfg.n_kv_heads // ms if heads else cfg.n_kv_heads
    fn = linear_band if heads and not train else linear
    xin = _copier(train, mesh)(enc_out) if heads else enc_out
    k = fn(xin, p["wk"], lut, p.get("bk")).reshape(b, s, nkv, hd)
    v = fn(xin, p["wv"], lut, p.get("bv")).reshape(b, s, nkv, hd)
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


def _mla_latents(p, x, cfg, lut, pos, rope, band: bool = False, cm=None):
    """MLA's q (nope and roped parts; with ``band`` the rank's heads) and
    the new latents (normed ckv, roped k_rope) at ``pos``.  ``cm``: a
    training rank's ``copy_to_model`` (:func:`_mla_q`), which the latents
    its heads read pass too."""
    b, t, _ = x.shape
    dr, r = cfg.qk_rope_head_dim, cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(p, x, cfg, lut, band, cm)
    if rope is None:
        rope = rope_tables(positions(pos, t, x.device), dr, cfg.rope_theta)
    cos, sin = rope
    q_rope = apply_rope(q_rope, cos, sin)
    kv_a = linear(x, p["wkv_a"], lut)                       # (b, t, r + dr)
    ckv = rms_norm(kv_a[..., :r], p["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., r:].reshape(b, t, 1, dr), cos, sin
                        ).reshape(b, t, dr)
    if band and cm is not None:
        ckv, k_rope = cm(ckv), cm(k_rope)
    return q_nope, q_rope, ckv, k_rope


def _mla_q(p, x, cfg, lut, band: bool = False, cm=None):
    """q's nope and rope parts, (B, T, heads, dn) and (…, dr): every head,
    or with ``band`` the rank's heads (its band of wq_b / wq: cut from the
    whole weight, or with ``cm`` a training rank's band, its input through
    ``cm``)."""
    b, t, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if band and cm is not None:
        def fn(z, w, lut_):
            return linear(cm(z), w, lut_)
    else:
        fn = linear_band if band else linear
    if cfg.q_lora_rank:
        qa = rms_norm(linear(x, p["wq_a"], lut), p["q_a_norm"], cfg.norm_eps)
        q = fn(qa, p["wq_b"], lut)
    else:
        q = fn(x, p["wq"], lut)
    q = q.reshape(b, t, -1, dn + dr)
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
    if _heads_axis(cache)[1] is not None:
        return _apply_mla_mesh(p, x, cfg, lut=lut, cache=cache, pos=pos,
                               rope=rope)
    b, t, _ = x.shape
    nq = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    pos0 = 0 if pos is None else pos
    q_nope, q_rope, ckv, k_rope = _mla_latents(p, x, cfg, lut, pos0, rope)

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


def _apply_mla_mesh(p: Params, x: torch.Tensor, cfg, *, lut=None,
                    cache: Optional[Params] = None, pos=None, rope=None):
    """:func:`apply_mla` on a mesh whose model axis has more than one rank
    (the reference's placements): wq_b (or wq) gives the rank's heads
    where they divide the ranks, and ``wkv_b`` is decoded for those heads
    alone (:func:`materialize_band`, from the rank's band of its planes);
    the latent cache is the rank's block of positions.  A prefill builds
    its heads' K/V from the whole fresh latents (or, past position 0, the
    blocks gathered) and runs K2 on them; a decode step absorbs its q
    heads into the latent space, gathers that (small) q over model, takes
    each block's partials over every head and merges them over model in
    rank order (:func:`_merge_parts`), then applies its heads' W_v.  ``o``
    is gathered over model before ``wo``.  A tensor-parallel training rank
    (no cache) holds its heads' bands of wq_b (or wq) and wkv_b already,
    wq_a, wkv_a and the norms whole; the latents its heads read pass
    ``copy_to_model``, and wo is row-parallel, summed over model."""
    train, mesh, ms, m = _heads_axis(cache)
    b, t, _ = x.shape
    nq = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    pos0 = 0 if pos is None else pos
    heads = nq % ms == 0
    nq_l = nq // ms if heads else nq
    q_nope, q_rope, ckv, k_rope = _mla_latents(
        p, x, cfg, lut, pos0, rope, band=heads,
        cm=_copier(True, mesh) if train else None)
    wkv_b = (materialize_band if heads and not train else materialize_weight)(
        p["wkv_b"], lut, x.dtype).reshape(nq_l, dn + dv, r)
    w_k, w_v = wkv_b[:, :dn], wkv_b[:, dn:]

    def out(o):
        return _row_parallel(o.to(x.dtype).reshape(b, t, nq_l * dv),
                             p["wo"], lut, train, heads, mesh)

    def prefill(kv, kr, flash):
        lmax = kv.shape[1]
        k_nope = torch.einsum("blr,hdr->blhd", kv.to(x.dtype), w_k)
        v = torch.einsum("blr,hdr->blhd", kv.to(x.dtype), w_v)
        k_full = torch.cat([k_nope, kr[:, :, None].to(x.dtype).expand(
            b, lmax, nq_l, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        return out(flash(q_full, k_full, v))

    full = (lambda q, k, v: _attend_full(q, k, v, True))
    if cache is None:
        return prefill(ckv, k_rope, full), None
    lb = cache["ckv"].shape[1]
    start = m * lb
    cckv = _kv_write_block(cache["ckv"], ckv.to(cache["ckv"].dtype), pos0,
                           start)
    ckrope = _kv_write_block(cache["krope"],
                             k_rope.to(cache["krope"].dtype), pos0, start)
    new_cache = {"ckv": cckv, "krope": ckrope}
    if t > 1:
        if not torch.is_tensor(pos0) and int(pos0) == 0:
            o = prefill(ckv, k_rope, full)
        else:
            o = prefill(mesh.all_gather(cckv, "model", dim=1),
                        mesh.all_gather(ckrope, "model", dim=1),
                        lambda q, k, v: _attend_cache_flash(q, k, v,
                                                            int(pos0)))
        return o, new_cache

    f32 = torch.float32

    def absorb(qn, _):
        pad = _row_pad(qn.shape[0], qn)
        return torch.einsum("bthd,hdr->bthr", pad(qn), w_k.to(f32)
                            )[:qn.shape[0]]

    qc = _by_row_pieces(absorb, b, x, q_nope, pos=None)
    qr = q_rope.to(f32)
    if heads:
        qc = mesh.all_gather(qc, "model", dim=2)
        qr = mesh.all_gather(qr, "model", dim=2)
    mx, s, o_lat = _by_row_pieces(
        lambda qc_, qr_, kv, kr, p_: _mla_parts(qc_, qr_, kv, kr, p_,
                                                dn + dr, start),
        b, x, qc, qr, cckv, ckrope, pos=pos0)
    o_lat = _merge_parts(mesh, mx, s, o_lat)          # (b, t, nq, r) f32
    if heads:
        o_lat = o_lat[:, :, m * nq_l:(m + 1) * nq_l]

    def value(ol, _):
        pad = _row_pad(ol.shape[0], ol)
        return torch.einsum("bthr,hdr->bthd", pad(ol), w_v.to(f32)
                            )[:ol.shape[0]]

    o = _by_row_pieces(value, b, x, o_lat, pos=None)
    return out(o), new_cache


def _mla_parts(qc, qr, cckv, ckrope, pos, d_qk: int, start: int):
    """One rank's block of MLA's absorbed decode: the scores of the
    absorbed q ``qc`` (b, t, nq, r) and the rope q ``qr`` over the
    block's latents (from position ``start``), in f32, on the card the
    batch padded to ROW_PAD rows; → (max, sum, unnormalized latent
    output) of the block (:func:`_softmax_parts`)."""
    b, t = qc.shape[:2]
    pad = _row_pad(b, qc)
    kv, kr = pad(cckv), pad(ckrope)
    s_nope = torch.einsum("bthr,blr->bthl", pad(qc), kv)
    s_rope = torch.einsum("bthd,bld->bthl", pad(qr), kr)
    logits = (s_nope + s_rope) / math.sqrt(d_qk)
    mask = _decode_mask(pos, t, cckv.shape[1], qc.device, start)
    mask = mask[None, :, None, :] if mask.ndim == 2 else pad(
        mask[:, :, None, :], torch.bool)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    mx, s, e = _softmax_parts(logits)
    return mx[:b], s[:b], torch.einsum("bthl,blr->bthr", e, kv)[:b]


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
    """SwiGLU.  On a mesh whose model ranks divide d_ff, w_gate and w_up
    give the rank's band (:func:`linear_band`), silu·up runs on it, and
    the band is gathered over model just before w_down (elementwise on
    the band, so the bits are the whole product's).  A tensor-parallel
    training rank whose gather on use gave it its bands of the three
    (``partition.kept_band``): gate/up column-parallel on them, w_down
    row-parallel, its product summed over model."""
    train, mesh, ms, _ = _heads_axis()
    if train and PT.kept_band(p, "w_gate"):
        xc = copy_to_model(x, mesh)
        g = linear(xc, p["w_gate"], lut, decode=decode)
        u = linear(xc, p["w_up"], lut, decode=decode)
        return reduce_from_model(
            linear(_silu_mul(g, u), p["w_down"], lut, decode=decode), mesh)
    if not train and mesh is not None and _out_dim(p["w_gate"]) % ms == 0:
        g = linear_band(x, p["w_gate"], lut, decode=decode)
        u = linear_band(x, p["w_up"], lut, decode=decode)
        h = mesh.all_gather(_silu_mul(g, u), "model", dim=-1)
        return linear(h, p["w_down"], lut, decode=decode)
    g = linear(x, p["w_gate"], lut, decode=decode)
    u = linear(x, p["w_up"], lut, decode=decode)
    return linear(_silu_mul(g, u), p["w_down"], lut, decode=decode)


def _out_dim(w) -> int:
    """A weight's whole out features (a placed container's whole N)."""
    if isinstance(w, (PackedLinear, TiledPackedLinear)):
        n = w.shape[0]
        mesh = PT.current_mesh()[1]
        if w.mesh_axes is not None and mesh is not None:
            n *= mesh.axis_size(tuple(a for a in w.mesh_axes
                                      if a != "data"))
        return n
    if isinstance(w, QuantLinear):
        return w.values.shape[-2]
    return w.shape[-2]


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
                    and (x.shape[0] % bsize == 0 or _rows_local(mesh))):
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
    if not recomputing():
        routes.record(expert_ids, keep.reshape(n_tok, k), aux)
    table, gtable = dispatch_tables(expert_ids, slot, gate_vals, cap, e)

    xpad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    res = p.get("residency")
    mesh, ms, m = PT.tp_mesh()
    tp_experts = mesh is not None and PT.kept_band(p["experts"], "w_gate")
    if tp_experts:
        y = _moe_experts_tp(p["experts"], xpad, table, gtable, keep,
                            expert_ids, slot, cap, x.dtype, mesh, ms, m)
    elif getattr(cfg, "moe_expert_scan", False) and res is None:
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
    if not tp_experts:
        y = _combine(ye, gtable, keep, expert_ids, slot, cap, x.dtype)

    if "shared" in p:
        y = y + apply_mlp(p["shared"], xf, lut=lut, decode=decode)
    y = y.reshape(b, t, d)
    if with_routing:
        return y, aux, expert_ids
    return y, aux


def _combine(ye, gtable, keep, expert_ids, slot, cap: int, dtype,
             first: int = 0):
    """Each token's gated outputs of experts ``first`` .. ``first + E −
    1`` (``ye`` (E, cap, d) from their dispatch tables), added in
    ascending expert order in ``dtype``; a choice dropped, or of another
    expert, reads the zero row."""
    e, _, d = ye.shape
    n_tok, k = expert_ids.shape
    contrib = ye.to(dtype) * gtable[..., None].to(dtype)
    contrib = torch.cat([contrib.reshape(e * cap, d),
                         contrib.new_zeros((1, d))], dim=0)  # last: dropped
    local = expert_ids.reshape(-1) - first
    keep = keep & (local >= 0) & (local < e)
    where = torch.where(keep, local * cap + slot, e * cap).reshape(n_tok, k)
    where = where.gather(1, torch.argsort(expert_ids, dim=1))  # by expert
    y = torch.zeros((n_tok, d), dtype=dtype, device=ye.device)
    for j in range(k):
        y = y + contrib[where[:, j]]
    return y


def _moe_experts_tp(experts, xpad, table, gtable, keep, expert_ids, slot,
                    cap: int, dtype, mesh, ms: int, m: int):
    """A tensor-parallel training rank's experts (expert-parallel over
    ``model``): its E/model experts on the dispatch table every model rank
    computed alike (capacity, slots and aux the whole microbatch's), the
    tokens and gates read through ``copy_to_model``, the combine of its
    experts' gated outputs summed over model."""
    el = table.shape[0] // ms
    lo = m * el
    xc, gc = copy_to_model(xpad, mesh), copy_to_model(gtable, mesh)
    ye = _expert_ffn(experts, xc[table[lo:lo + el]])
    y = _combine(ye, gc[lo:lo + el], keep, expert_ids, slot,
                 cap, dtype, first=lo)
    return reduce_from_model(y, mesh)


def _rows_local(mesh) -> bool:
    """Whether the rows being computed are a (pod, data) shard of the
    batch on ``mesh`` (``partition.rows_split``)."""
    split = PT.row_split()
    return split is not None and split[0] is mesh


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
    rows are gathered back over the batch axes.  The shared experts run
    on all rows.

    Served on a mesh whose batch rows are split over (pod, data)
    (``partition.rows_split``), ``x`` is already the rank's shard: it is
    routed as it is, with no cut and no gather, which is the reference's
    ``shard_map`` itself; the cut and the gather remain for a batch that
    every rank holds whole (the engine's slots)."""
    _, mesh = PT.current_mesh()
    e_full, k = cfg.n_experts, cfg.top_k
    b, t, d = x.shape
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    local_rows = _rows_local(mesh)
    bsize = 1 if local_rows else mesh.axis_size(batch_axes)
    bl = b // bsize
    bi = 0 if local_rows else mesh.axis_index(batch_axes)
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
    xpad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    ye = _expert_ffn(local, xpad[table], lut, plan_experts=e_full,
                     decode=t == 1)                      # (e_loc, cap, d)
    y = _combine(ye, gtable, slot < cap, expert_ids, slot, cap, x.dtype,
                 first=offset)
    y = mesh.psum(y, "model")
    aux = mesh.pmean(mesh.pmean(aux, "model"), batch_axes)
    y = y.reshape(bl, t, d)
    if not local_rows:
        y = mesh.all_gather(y, batch_axes, dim=0)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x.reshape(b * t, d), lut=lut,
                          decode=t == 1).reshape(b, t, d)
    return y, aux
