"""Mamba2 / SSD (state-space duality) layers — the attention-free backbone.

Counterpart of ``repro/models/ssm.py``: the chunked SSD algorithm (Dao &
Gu, arXiv:2405.21060) — within a chunk the quadratic "attention" form,
across chunks a linear state recurrence (a Python loop over the chunks,
where the reference runs ``lax.scan``) — and the one-token recurrent step
of decode.  The recurrence parameters (``a_log``, ``dt_bias``, ``conv_*``,
``d_skip``) stay dense by the compression policy; ``in_proj`` and
``out_proj`` are linears like any other (K1 when compressed).

Differences from the reference, each for the card:
  * the cache is updated in place (``apply_mamba2`` copies the new conv
    ring and SSM state into the cache tensors), so a captured decode step
    replays on the state the last replay left;
  * the SSD contractions run pairwise in a fixed order (no tensor of
    (B, chunks, Q, K, H, P) forms: at Mamba2-2.7B's width one would be
    1.3 GB a batch row and chunk), where ``jnp.einsum`` lets opt_einsum
    choose; f32 sums in another order, within 1e-4 of the reference;
  * the decode step's state update is elementwise and its read-out a
    product summed over the state dim by one reduction of ≥ 16 outputs a
    call, so a row's bits do not depend on the batch (as ``layers.
    _mean_square``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .layers import _normal, _silu, linear, rms_norm


def init_mamba2(cfg, gen: torch.Generator, device,
                dtype=torch.float32) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    n = cfg.ssm_state
    g = cfg.ssm_n_groups
    h = cfg.ssm_heads
    kw = cfg.ssm_conv
    conv_dim = di + 2 * g * n
    # in_proj emits [z(di), x(di), B(g·n), C(g·n), dt(h)]
    d_in_proj = 2 * di + 2 * g * n + h
    return {
        "in_proj": _normal((d_in_proj, d), gen, device, dtype,
                           1.0 / math.sqrt(d)),
        "conv_w": _normal((conv_dim, kw), gen, device, dtype, 0.1),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=device
                                          ).to(dtype)),
        "dt_bias": torch.zeros(h, dtype=dtype, device=device),
        "d_skip": torch.ones(h, dtype=dtype, device=device),
        "gate_norm": torch.ones(di, dtype=dtype, device=device),
        "out_proj": _normal((d, di), gen, device, dtype,
                            1.0 / math.sqrt(di)),
    }


def init_ssm_cache(cfg, batch: int, device="cpu") -> dict:
    """Decode state: the conv ring (B, K−1, conv dim) and the SSM state
    (B, H, P, N), both f32 whatever the KV dtype (constant in T)."""
    di = cfg.d_inner
    g, n, h = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n),
                           dtype=torch.float32, device=device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  xbc: (B, T, C); w: (C, K).  With
    ``state`` (B, K−1, C) prepended (decode / chunked prefill).  An f32
    window sum in j order, then the bias, then silu, cast to x's dtype.
    → (y, new_state: the last K−1 inputs, in x's dtype)."""
    bsz, t, c = xbc.shape
    kw = w.shape[1]
    if state is None:
        pad = xbc.new_zeros((bsz, kw - 1, c))
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                    # (B, T+K-1, C)
    wf = w.to(torch.float32)
    y = torch.zeros((bsz, t, c), dtype=torch.float32, device=xbc.device)
    for j in range(kw):
        y = y + xp[:, j:j + t].to(torch.float32) * wf[:, j]
    y = y + b.to(torch.float32)
    new_state = xp[:, xp.shape[1] - (kw - 1):]
    return _silu(y).to(xbc.dtype), new_state


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """segsum(x)[..., i, j] = Σ_{j<k<=i} x[..., k]; −inf above the
    diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, torch.full_like(d, -math.inf))


def _repeat_groups(z: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, T, G, N) → (B, T, G·rep, N), each group repeated ``rep`` times
    in place (``jnp.repeat`` on axis 2)."""
    return z.repeat_interleave(rep, dim=2) if rep > 1 else z


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x:  (B, T, H, P)   inputs per head
    dt: (B, T, H)      positive step sizes (softplus applied by caller)
    a:  (H,)           negative decay rates
    b_in, c_in: (B, T, G, N) with H % G == 0
    → (y (B, T, H, P) f32, final_state (B, H, P, N) f32)."""
    bsz, t, h, p = x.shape
    n = b_in.shape[3]
    rep = h // b_in.shape[2]
    nchunks = -(-t // chunk)
    pad = nchunks * chunk - t
    if pad:   # zero steps (dt = 0): no decay, no input
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b_in = torch.nn.functional.pad(b_in, (0, 0, 0, 0, 0, pad))
        c_in = torch.nn.functional.pad(c_in, (0, 0, 0, 0, 0, pad))
    f32 = torch.float32

    def to_chunks(z):
        return z.reshape((bsz, nchunks, chunk) + tuple(z.shape[2:])).to(f32)

    xc = to_chunks(x)                                     # (B,c,Q,H,P)
    dtc = to_chunks(dt)                                   # (B,c,Q,H)
    bc = to_chunks(_repeat_groups(b_in, rep))             # (B,c,Q,H,N)
    cc = to_chunks(_repeat_groups(c_in, rep))

    da = dtc * a.to(f32)                                  # ≤ 0
    da_cum = torch.cumsum(da, dim=2)                      # within-chunk
    xdt = xc * dtc[..., None]

    # Intra-chunk (quadratic within the chunk): (C·B) ∘ L, then · xdt
    lmat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))     # (B,c,H,Q,K)
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc) * lmat
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xdt)

    # Chunk-final states: Σ_k exp(da_cum[-1] − da_cum[k]) B_k xdt_k
    decay_states = torch.exp(da_cum[:, :, -1:, :] - da_cum)   # (B,c,Q,H)
    states = torch.einsum("bckhn,bckhp->bchpn", bc,
                          xdt * decay_states[..., None])

    # Inter-chunk recurrence over the chunks: the state entering each.
    chunk_decay = torch.exp(da_cum[:, :, -1, :])          # (B,c,H)
    s = (init_state.to(f32) if init_state is not None
         else x.new_zeros((bsz, h, p, n), dtype=f32))
    prev = []
    for ci in range(nchunks):
        prev.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                # (B,c,H,P,N)

    # Off-diagonal contribution from the carried state.
    y_off = (torch.einsum("bcqhn,bchpn->bcqhp", cc, prev_states)
             * torch.exp(da_cum)[..., None])
    y = (y_diag + y_off).reshape(bsz, nchunks * chunk, h, p)[:, :t]
    return y, s


def ssd_decode_step(x, dt, a, b_in, c_in, state):
    """One-token recurrent update (decode).

    x: (B, 1, H, P); dt: (B, 1, H); b_in/c_in: (B, 1, G, N);
    state: (B, H, P, N) → (y (B, 1, H, P) f32, new_state)."""
    f32 = torch.float32
    h = x.shape[2]
    rep = h // b_in.shape[2]
    bh = _repeat_groups(b_in, rep)[:, 0].to(f32)          # (B,H,N)
    ch = _repeat_groups(c_in, rep)[:, 0].to(f32)
    dt0 = dt[:, 0].to(f32)                                # (B,H)
    da = torch.exp(dt0 * a)
    xdt = x[:, 0].to(f32) * dt0[..., None]                # (B,H,P)
    s_new = state * da[:, :, None, None] + xdt[..., None] * bh[:, :, None]
    y = (s_new * ch[:, :, None]).sum(dim=-1)              # (B,H,P)
    return y[:, None], s_new


def apply_mamba2(p, x: torch.Tensor, cfg, *, lut=None, cache=None):
    """The Mamba2 block: in_proj → softplus(dt + dt_bias) → conv → SSD →
    the D skip → the gated norm rms_norm(y·silu(z)) → out_proj.

    ``cache=None``: from scratch (prefill or training, no state kept).
    With a cache ({"conv", "ssm"}, :func:`init_ssm_cache`): T == 1 runs
    the recurrent step, T > 1 the chunked scan from the cached state; the
    new conv ring and state are copied into the cache tensors.  → (y,
    cache)."""
    bsz, t, _ = x.shape
    di = cfg.d_inner
    g, n, h = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_heads
    hp = cfg.ssm_head_dim
    f32 = torch.float32

    zxbcdt = linear(x, p["in_proj"], lut)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * n]
    dt = zxbcdt[..., -h:].to(f32) + p["dt_bias"].to(f32)
    dt = torch.logaddexp(dt, torch.zeros_like(dt))        # softplus, as jax's

    conv_state = cache["conv"] if cache is not None else None
    xbc_c, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs = xbc_c[..., :di].reshape(bsz, t, h, hp)
    b_in = xbc_c[..., di:di + g * n].reshape(bsz, t, g, n)
    c_in = xbc_c[..., di + g * n:].reshape(bsz, t, g, n)

    a = -torch.exp(p["a_log"].to(f32))
    if cache is not None and t == 1:
        y, new_state = ssd_decode_step(xs, dt, a, b_in, c_in, cache["ssm"])
    else:
        y, new_state = ssd_chunked(
            xs, dt, a, b_in, c_in, cfg.ssm_chunk,
            cache["ssm"] if cache is not None else None)

    y = y + xs.to(f32) * p["d_skip"].to(f32)[:, None]
    y = y.reshape(bsz, t, di).to(x.dtype)
    # the gated norm: the reference's XLA program normalizes the product
    # y·silu(z) in f32, unrounded (silu itself rounded op by op)
    y = rms_norm(y.to(f32) * _silu(z).to(f32), p["gate_norm"],
                 cfg.norm_eps).to(x.dtype)
    out = linear(y, p["out_proj"], lut)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(new_state)
    return out, cache
