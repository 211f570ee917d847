"""Decoder-only LM assembly — the dense (Llama, Qwen, InternLM), MoE
(DeepSeek-V2, Kimi-K2), SSM (Mamba2), hybrid (Zamba2) and VLM (InternVL2)
families.

Counterpart of ``repro/models/lm.py`` (``init_lm``, ``forward``,
``init_caches``, ``cache_batch_time_axes``).  The reference stacks
layers on a leading axis and runs them under ``lax.scan``; here
``params["blocks"]`` is a list of per-layer dicts and a Python loop runs
them.  An MoE model's first ``first_dense_layers`` layers (attention + a
dense MLP) are the list ``params["first_blocks"]``, as in the reference.
The hybrid applies one ``params["shared_attn"]`` block (attention + MLP,
weights shared, a KV cache of its own at each application) after every
``attn_period`` Mamba2 blocks.  A VLM is the dense stack with patch
embeddings prepended to the token embeddings (``forward``'s ``embeds``).
The encoder–decoder family is ``models/encdec.py``'s: here, as in the
reference, ``init_lm`` and ``init_caches`` raise ``ValueError`` for it.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .._device import generator, resolve_device
from ..sharding import partition as PT
from . import layers as L
from . import ssm as S

Params = Any


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a decoder-only LM's "
                         f"{FAMILIES}"
                         + ("; models/encdec.py serves it"
                            if cfg.family == "encdec" else ""))


def _init_attn(cfg, gen, device, dtype):
    if cfg.mla:
        return L.init_mla(cfg, gen, device, dtype)
    return L.init_attention(cfg, gen, device, dtype)


def init_lm(cfg, *, seed: int = 0, device=None,
            dtype=torch.float32) -> Params:
    """Random weights from ``seed``, drawn on ``device`` (the card unless
    the caller passes another).  Same shapes and scales as the reference's
    init; the numbers differ (torch and jax generators differ)."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = generator(device, seed)
    d, v = cfg.d_model, cfg.vocab_size
    params: dict = {
        "embed": L._normal((v, d), gen, device, dtype, 0.02),
        "final_norm": torch.ones(d, dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal((v, d), gen, device, dtype, 0.02)
    def dense_block():
        return {
            "attn_norm": torch.ones(d, dtype=dtype, device=device),
            "attn": L.init_attention(cfg, gen, device, dtype),
            "mlp_norm": torch.ones(d, dtype=dtype, device=device),
            "mlp": L.init_mlp(d, cfg.d_ff, gen, device, dtype),
        }

    if cfg.family in ("dense", "vlm"):
        params["blocks"] = [dense_block() for _ in range(cfg.n_layers)]
        return params
    if cfg.family in ("ssm", "hybrid"):
        params["blocks"] = [{
            "norm": torch.ones(d, dtype=dtype, device=device),
            "mamba": S.init_mamba2(cfg, gen, device, dtype),
        } for _ in range(cfg.n_layers)]
        if cfg.family == "hybrid":
            params["shared_attn"] = dense_block()
        return params
    nd = cfg.first_dense_layers
    ff = cfg.d_ff or cfg.moe_d_ff * (cfg.top_k + cfg.n_shared_experts)
    if nd:
        params["first_blocks"] = [{
            "attn_norm": torch.ones(d, dtype=dtype, device=device),
            "attn": _init_attn(cfg, gen, device, dtype),
            "mlp_norm": torch.ones(d, dtype=dtype, device=device),
            "mlp": L.init_mlp(d, ff, gen, device, dtype),
        } for _ in range(nd)]
    params["blocks"] = [{
        "attn_norm": torch.ones(d, dtype=dtype, device=device),
        "attn": _init_attn(cfg, gen, device, dtype),
        "mlp_norm": torch.ones(d, dtype=dtype, device=device),
        "moe": L.init_moe(cfg, gen, device, dtype),
    } for _ in range(nd, cfg.n_layers)]
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


def _ssm_block(bp, x, cfg, lut, cache):
    h = L.rms_norm(x, bp["norm"], cfg.norm_eps)
    y, new_cache = S.apply_mamba2(bp["mamba"], h, cfg, lut=lut, cache=cache)
    return x + y, new_cache


def _hybrid_segments(cfg):
    """Zamba2: the shared attention block follows every ``attn_period``
    Mamba2 blocks.  → [(start, end), ...] Mamba2 segments; an application
    of the shared block follows every segment but the last."""
    per, n = cfg.attn_period, cfg.n_layers
    bounds = list(range(per, n, per))
    return list(zip([0] + bounds, bounds + [n]))


def _moe_block(bp, x, cfg, lut, cache, pos, rope, expert_ids=None,
               with_routing: bool = False):
    """An MoE-family layer (MLA or GQA attention, then the MoE or, in the
    first layers, a dense MLP).  Returns (x, cache, aux, expert_ids or
    None); ``expert_ids`` routes the MoE's tokens (``apply_moe``);
    ``with_routing`` returns the top-k ids (which, as in the reference,
    keeps the MoE on its global dispatch)."""
    h = L.rms_norm(x, bp["attn_norm"], cfg.norm_eps)
    attn = L.apply_mla if cfg.mla else L.apply_attention
    a, new_cache = attn(bp["attn"], h, cfg, lut=lut, cache=cache, pos=pos,
                        rope=rope)
    # Unlike _dense_block, the norm reads the residual sum rounded to x's
    # dtype: the reference's MoE layers do (compared layer by layer, in
    # eager and in jitted runs).
    x = x + a
    h = L.rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
    if "moe" in bp:
        out = L.apply_moe(bp["moe"], h, cfg, lut=lut,
                          with_routing=with_routing, expert_ids=expert_ids)
        return x + out[0], new_cache, out[1], (out[2] if with_routing
                                               else None)
    return x + L.apply_mlp(bp["mlp"], h, lut=lut), new_cache, 0.0, None


def forward(params: Params, cfg, tokens: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None, caches=None, pos=None,
            lut=None, return_hidden: bool = False,
            return_routing: bool = False,
            routing: Optional[torch.Tensor] = None):
    """tokens (B, T) int → (logits, caches, aux_loss).

    ``embeds`` (B, T', d): a modality frontend's outputs (the VLM's patch
    embeddings), prepended to the token embeddings in their dtype; the
    logits then cover T' + T positions, from ``pos``.

    ``pos``: the first new token's position, an int (prefill), a 0-d
    tensor or, for T == 1, a per-row (B,) tensor; a tensor stays on the
    device (no host read, so a decode step can be captured).

    ``return_hidden=True`` skips the LM head and returns the final normed
    hidden states.  ``return_routing=True`` (MoE family) appends the top-k
    expert ids of the MoE layers, (L_moe, B·T, k); ``routing``, ids of that
    shape (another run's), routes the MoE layers' tokens to those experts
    instead.  Caches (attention and SSM state) are updated in place and
    returned."""
    _check_family(cfg)
    fam = cfg.family
    if (return_routing or routing is not None) and fam != "moe":
        raise ValueError(f"routing needs family 'moe', got {fam!r}")
    if tokens is not None:
        x = L.embed(PT.use(params["embed"], keep=True), tokens, lut,
                    band=PT.kept_band(params, "embed"))
        if embeds is not None:
            x = torch.cat([embeds.to(x.dtype), x], dim=1)
    else:
        x = embeds
    rope = None
    if fam != "ssm":
        rope = L.rope_tables(L.positions(0 if pos is None else pos,
                                         x.shape[1], x.device),
                             cfg.qk_rope_head_dim if cfg.mla
                             else cfg.resolved_head_dim, cfg.rope_theta)
    caches = caches or {}
    out_caches: dict = {}
    aux = 0.0
    routed = []
    remat = L.remat_on(cfg, params["final_norm"])

    def run(fn, bp, *args):
        """One block: its leaves gathered on use inside the checkpointed
        body (``partition.use``), so they live through its forward and
        again through its recompute and backward."""
        return L.block(lambda x_: fn(PT.use(bp), x_, *args), x, remat=remat)

    if "first_blocks" in params:
        fb_caches = caches.get("first")
        ncs = []
        for i, bp in enumerate(params["first_blocks"]):
            cache = fb_caches[i] if fb_caches is not None else None
            x, nc, _, _ = run(_moe_block, bp, cfg, lut, cache, pos, rope)
            ncs.append(nc)
        out_caches["first"] = ncs if fb_caches is not None else None
    blk_caches = caches.get("blocks")
    new_caches = []
    if fam == "hybrid":
        attn_caches = caches.get("attn")
        new_attn = []
        segs = _hybrid_segments(cfg)
        for si, (s, e) in enumerate(segs):
            for i in range(s, e):
                x, nc = run(_ssm_block, params["blocks"][i], cfg, lut,
                            blk_caches[i] if blk_caches is not None
                            else None)
                new_caches.append(nc)
            if si < len(segs) - 1:
                x, nac = run(_dense_block, params["shared_attn"], cfg, lut,
                             attn_caches[si] if attn_caches
                             is not None else None, pos, rope)
                new_attn.append(nac)
        out_caches["attn"] = new_attn if attn_caches is not None else None
    else:
        for i, bp in enumerate(params["blocks"]):
            cache = blk_caches[i] if blk_caches is not None else None
            if fam in ("dense", "vlm"):
                x, nc = run(_dense_block, bp, cfg, lut, cache, pos, rope)
            elif fam == "ssm":
                x, nc = run(_ssm_block, bp, cfg, lut, cache)
            else:
                x, nc, a, ids = run(
                    _moe_block, bp, cfg, lut, cache, pos, rope,
                    None if routing is None else routing[i],
                    return_routing)
                aux = aux + a
                routed.append(ids)
            new_caches.append(nc)
    x = L.rms_norm(x, PT.use(params["final_norm"]), cfg.norm_eps)
    out_caches["blocks"] = new_caches if blk_caches is not None else None
    extra = (torch.stack(routed),) if return_routing else ()
    if return_hidden:
        return (x, out_caches, aux) + extra
    key = "lm_head" if "lm_head" in params else "embed"
    logits = L.head_logits(x, PT.use(params[key], keep=True), lut,
                           band=PT.kept_band(params, key))
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return (logits, out_caches, aux) + extra


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                device=None, *, mesh=None, rows: bool = True,
                positions: bool = True) -> Params:
    """Per-layer caches for serving, on ``device`` (the card unless the
    caller passes another).  MLA layers cache the latents; an MoE model's
    first dense layers have theirs under ``"first"``; Mamba2 blocks their
    f32 conv ring and SSM state (``ssm.init_ssm_cache``), and the hybrid's
    shared attention a KV cache per application under ``"attn"``.

    ``mesh`` (a ``launch.mesh.Mesh`` of more than one rank): this rank's
    share of the caches of ``batch`` rows (``partition.serve_cache_specs``;
    ``rows=False`` keeps every row, ``positions=False`` every position),
    allocated alone; where the ranks split the positions, ``max_len`` is
    rounded up to a multiple of the model ranks (``partition.cache_len``)."""
    _check_family(cfg)
    if mesh is not None and mesh.size > 1:
        from ..sharding import partition as PT
        if positions:
            max_len = PT.cache_len(cfg, max_len, mesh)
        whole = init_caches(cfg, batch, max_len, dtype, device="meta")
        return PT.zeros_share(whole, mesh, resolve_device(device),
                              rows=rows, positions=positions)
    device = resolve_device(device)

    def one():
        if cfg.mla:
            return L.init_mla_cache(cfg, batch, max_len, dtype, device)
        return L.init_kv_cache(cfg, batch, max_len, dtype, device)

    if cfg.family in ("dense", "vlm"):
        return {"blocks": [one() for _ in range(cfg.n_layers)]}
    if cfg.family in ("ssm", "hybrid"):
        out = {"blocks": [S.init_ssm_cache(cfg, batch, device)
                          for _ in range(cfg.n_layers)]}
        if cfg.family == "hybrid":
            out["attn"] = [one()
                           for _ in range(len(_hybrid_segments(cfg)) - 1)]
        return out
    nd = cfg.first_dense_layers
    out = {"blocks": [one() for _ in range(cfg.n_layers - nd)]}
    if nd:
        out["first"] = [one() for _ in range(nd)]
    return out


def cache_batch_time_axes(cfg):
    """Per-leaf ``(batch_axis, time_axis)`` of this config's serving cache,
    as a tree of the caches' structure with a tuple at each leaf.

    The paged KV pool (``serve/kv_cache.py``) gathers and scatters cache
    leaves along these axes.  They are found from the structure, as the
    reference finds them: :func:`init_caches` on the ``meta`` device at
    two batches and two lengths, and the axis that moves with each is the
    answer.  A leaf without exactly one of each, or whose time axis does
    not follow its batch axis, raises ``ValueError``: so do the Mamba2
    caches of the ``ssm`` and ``hybrid`` families, whose state has no time
    axis to page."""
    a = init_caches(cfg, 2, 7, device="meta")
    b = init_caches(cfg, 3, 7, device="meta")
    c = init_caches(cfg, 2, 9, device="meta")

    def axes(sa, sb, sc):
        if isinstance(sa, dict):
            return {k: axes(sa[k], sb[k], sc[k]) for k in sa}
        if isinstance(sa, list):
            return [axes(x, y, z) for x, y, z in zip(sa, sb, sc)]
        batch = [i for i, (x, y) in enumerate(zip(sa.shape, sb.shape))
                 if x != y]
        time = [i for i, (x, y) in enumerate(zip(sa.shape, sc.shape))
                if x != y]
        if len(batch) != 1 or len(time) != 1:
            raise ValueError(
                f"cache leaf {tuple(sa.shape)} has no unambiguous (batch, "
                f"time) axes: family {cfg.family!r} cannot back a paged KV "
                "pool")
        if time[0] != batch[0] + 1:
            raise ValueError(
                f"cache leaf {tuple(sa.shape)}: time axis {time[0]} is not "
                f"adjacent to batch axis {batch[0]}")
        return (batch[0], time[0])

    return axes(a, b, c)
