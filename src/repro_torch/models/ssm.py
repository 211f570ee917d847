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

On a mesh whose model ranks divide the SSM heads and the B/C width
(``partition.ssm_split``), a model rank computes the block on its own
heads, as the reference's shardings place it (``in_proj`` and the conv on
``M``, the state by heads, the window by channels):
  * serving: ``in_proj`` is K1 on the rank's stored out-tile band, its
    product gathered whole (as for any weight); the rank takes its heads'
    z, x and dt and its 1/ms of B and C, convolves those channels over
    its window (``partition.serve_cache_specs``), gathers the convolved B
    and C over model, scans its heads from its state (B, H/ms, P, N), and
    gathers ``y`` over model before ``out_proj``;
  * training: the rank's rows of ``in_proj`` and channels of the conv are
    its bands already (``partition.tp_keeps_band``: z, x, B, C and dt of
    its heads, ``partition.ssm_rows``); the B and C rows of both are
    gathered over model as weights (2·g·n rows, never the B and C
    activations), the rest read as they are, and ``out_proj`` is
    row-parallel, summed over model;
  * the gated norm's mean of squares over d_inner is the ranks' pieces
    gathered over model and added in one process's order
    (``layers.square_pieces``: on the card bitwise ``layers.
    _mean_square`` where ms divides 16); a training rank's gather sums
    the pieces' gradients over model in the backward;
  * ``a_log``, ``dt_bias``, ``d_skip`` and ``gate_norm`` stay whole, read
    on the rank's heads (a training rank's through ``copy_to_model``).
Where the model ranks do not divide them, every rank computes the whole
block, as on one device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..launch.mesh import gather_model_summed
from ..sharding import partition as PT
from .layers import (_copier, _heads_axis, _mean_square, _normal,
                     _row_parallel, _silu, linear, square_pieces)


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


def _rank_groups(z: torch.Tensor, h: int, hl: int, m: int) -> torch.Tensor:
    """B or C (B, T, G, N) → the groups that heads m·hl … (m+1)·hl − 1
    read (head i reads group i // (h/G), as ``jnp.repeat``), as (B, T,
    G', N) whose repeat over hl/G' heads each (:func:`_repeat_groups`)
    gives those heads theirs."""
    rep = h // z.shape[2]
    first = m * hl // rep
    if hl % rep == 0:
        return z[:, :, first:first + hl // rep]
    if rep % hl == 0:
        return z[:, :, first:first + 1]
    idx = torch.div(m * hl + torch.arange(hl, device=z.device), rep,
                    rounding_mode="floor")
    return z.index_select(2, idx)


def gated_mean_square(prod: torch.Tensor, mesh, ms: int, d: int,
                      train: bool) -> torch.Tensor:
    """The mean of squares over the whole row of ``d`` channels from this
    rank's ``d``/ms of them, (..., 1): ``layers._mean_square``'s 16 pieces
    (the rank's 16/ms from ``layers.square_pieces``) gathered over model
    and added in one process's order where ms divides 16, else the
    ranks' sums added in rank order; ``layers._mean_square`` itself with
    no mesh.  ``train``: under autograd, the backward sums the gradient
    over model (each rank's share of it)."""
    if mesh is None:
        return _mean_square(prod)
    if d % 16 == 0 and 16 % ms == 0:
        part = square_pieces(prod, 16 // ms)
        parts = (gather_model_summed(part, mesh, -1) if train
                 else mesh.all_gather(part, "model", dim=-1))
        return parts.sum(dim=-1, keepdim=True) * (1.0 / d)
    total = (prod * prod).sum(dim=-1, keepdim=True)
    total = (mesh.psum_diff(total, "model") if train
             else mesh.psum(total, "model"))
    return total * (1.0 / d)


def apply_mamba2(p, x: torch.Tensor, cfg, *, lut=None, cache=None):
    """The Mamba2 block: in_proj → softplus(dt + dt_bias) → conv → SSD →
    the D skip → the gated norm rms_norm(y·silu(z)) → out_proj.

    ``cache=None``: from scratch (prefill or training, no state kept).
    With a cache ({"conv", "ssm"}, :func:`init_ssm_cache`): T == 1 runs
    the recurrent step, T > 1 the chunked scan from the cached state; the
    new conv ring and state are copied into the cache tensors.  On a mesh
    whose model ranks divide the heads, the rank's heads alone (see the
    module's note; ``cache`` the rank's share); elsewhere model rank 0 of
    one, the whole block.  → (y, cache)."""
    train, mesh, ms, m = _heads_axis(cache)
    if mesh is None or not PT.ssm_split(cfg, ms) or (
            train and not PT.kept_band(p, "in_proj")):
        train, mesh, ms, m = False, None, 1, 0
    bsz, t, _ = x.shape
    di, hp = cfg.d_inner, cfg.ssm_head_dim
    g, n, h = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_heads
    gn = g * n
    hl, dl, gl = h // ms, di // ms, gn // ms
    f32 = torch.float32
    bc_axis = PT.SegmentedAxis("model", (gn, gn))   # B_m, C_m → B, C
    cm = _copier(train, mesh)
    heads = slice(m * hl, (m + 1) * hl)
    if train:
        # the rank's rows (z, x, B, C, dt of its heads) and conv channels
        # (x, B, C): B's and C's rows gathered whole, as weights
        wz, wx, wbc, wdt = p["in_proj"].split([dl, dl, 2 * gl, hl])
        wbc = PT.unband(gather_model_summed(wbc, mesh, 0), 0, bc_axis, ms)
        proj = linear(cm(x), torch.cat([wz, wx, wbc, wdt]))
        z, xbc, dt = proj.split([dl, dl + 2 * gn, hl], dim=-1)
        conv = []
        for w in (p["conv_w"], p["conv_b"]):
            w_x, w_bc = w.split([dl, 2 * gl])
            conv.append(torch.cat([w_x, PT.unband(
                gather_model_summed(w_bc, mesh, 0), 0, bc_axis, ms)]))
        xbc_c, _ = _causal_conv(xbc, *conv)
        xs, bc = xbc_c.split([dl, 2 * gn], dim=-1)
    else:
        if cache is not None and cache["ssm"].shape[1] != hl:
            raise ValueError(
                f"an SSM state of {cache['ssm'].shape[1]} heads on a rank "
                f"that computes {hl}: on a mesh the cache is the rank's share "
                "(lm.init_caches(..., mesh=), partition.place_caches)")
        # K1 on the (rank's out band of the) whole in_proj; the rank's
        # heads' z, x and dt and its 1/ms of B and C
        zxbcdt = linear(x, p["in_proj"], lut)
        ax = PT.SegmentedAxis("model", (di, gn, gn))
        z = zxbcdt[..., m * dl:(m + 1) * dl]
        xbc = PT.cut_band(zxbcdt[..., di:2 * di + 2 * gn], -1, ax, ms, m)
        dt = zxbcdt[..., 2 * di + 2 * gn:][..., heads]
        conv_w, conv_b = (
            w if w.shape[0] == dl + 2 * gl else PT.cut_band(w, 0, ax, ms, m)
            for w in (p["conv_w"], p["conv_b"]))
        xbc_c, new_conv = _causal_conv(
            xbc, conv_w, conv_b, cache["conv"] if cache is not None else None)
        xs, bc = xbc_c.split([dl, 2 * gl], dim=-1)
        if mesh is not None:    # the convolved B and C, gathered whole
            bc = PT.unband(mesh.all_gather(bc, "model", dim=-1), -1,
                           bc_axis, ms)
    dt = dt.to(f32) + cm(p["dt_bias"])[heads].to(f32)
    dt = torch.logaddexp(dt, torch.zeros_like(dt))        # softplus, as jax's
    xs = xs.reshape(bsz, t, hl, hp)
    b_in = _rank_groups(bc[..., :gn].reshape(bsz, t, g, n), h, hl, m)
    c_in = _rank_groups(bc[..., gn:].reshape(bsz, t, g, n), h, hl, m)

    a = -torch.exp(cm(p["a_log"])[heads].to(f32))
    if cache is not None and t == 1:
        y, new_state = ssd_decode_step(xs, dt, a, b_in, c_in, cache["ssm"])
    else:
        y, new_state = ssd_chunked(
            xs, dt, a, b_in, c_in, cfg.ssm_chunk,
            cache["ssm"] if cache is not None else None)

    y = y + xs.to(f32) * cm(p["d_skip"])[heads].to(f32)[:, None]
    y = y.reshape(bsz, t, dl).to(x.dtype)
    # the gated norm: the reference's XLA program normalizes the product
    # y·silu(z) in f32, unrounded (silu itself rounded op by op); rms_norm's
    # ops, its mean of squares over the model ranks
    prod = y.to(f32) * _silu(z).to(f32)
    var = gated_mean_square(prod, mesh, ms, di, train)
    y = (prod * torch.rsqrt(var + cfg.norm_eps)
         * cm(p["gate_norm"])[m * dl:(m + 1) * dl].to(f32)).to(x.dtype)
    out = _row_parallel(y, p["out_proj"], lut, train, mesh is not None, mesh)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(new_state)
    return out, cache
