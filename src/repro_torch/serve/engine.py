"""Serving runtime — compressed-weight inference, the paper's system.

Counterpart of ``repro/serve/engine.py`` for one device:
  1. ``build_serve_params``: quantize every policy-selected weight to int8
     per channel, build ONE model-wide dictionary over the quantized byte
     streams, and encode each tensor in the tile-major blocked layout; a
     stacked expert leaf (E, N, K) is quantized and encoded expert by
     expert into one stacked container.  It runs on the card by default
     (quantization, counting and encoding are tensor ops on the weights'
     device).
  2. ``generate``: one prefill, then a greedy (or sampled) decode loop in
     Python.  Every compressed projection runs the fused
     decode→dequant→matmul kernel, every compressed expert stack the
     grouped one, an int8 LM head the dequant-matmul kernel, prefill
     attention the flash-attention kernel, and MLA's absorbed wkv_b the
     dict-decode kernel.

Not ported yet: ``TiledPackedLinear`` column tiles, ``model_shards``, the
integrity manifest, the resilience rungs and the continuous-batching
scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .._device import resolve_device
from ..core.blocked_codec import (TableIndex, build_lut, choose_fused_tiles,
                                  encode_blocked, encode_blocked_tiled)
from ..core.codec import find_frequent_sequences
from ..core.compressed import (PackedLinear, QuantLinear, stack_packed,
                               quantize_linear)
from ..core.policy import CompressionPolicy
from ..core.quant import QuantConfig
from ..models import layers as L
from ..models import lm as LM
from .context import ServeContext


@dataclasses.dataclass
class ServeState:
    params: Any
    lut: Optional[torch.Tensor]
    table: Optional[dict]
    mode: str
    stats: dict

    def to(self, device) -> "ServeState":
        """The same artifact with every tensor on ``device``."""
        return dataclasses.replace(
            self, params=_map_leaves(self.params, lambda t: t.to(device)),
            lut=self.lut.to(device) if self.lut is not None else None)


def _map_leaves(node, fn):
    if isinstance(node, dict):
        return {k: _map_leaves(v, fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_leaves(v, fn) for v in node]
    return fn(node)


def _leaf_groups(params) -> list:
    """[(name, [(holder, key), ...]), ...] in the reference's flatten order.

    The reference stacks the layers of ``params["blocks"]``, so each
    per-layer leaf (e.g. ``['blocks']['attn']['wq']``) is one stacked leaf
    whose layers are quantized, counted and encoded in layer order, and
    dict keys flatten sorted.  The table's code order depends on that
    stream order, so the port walks its per-layer list the same way: a
    group holds one leaf position across all layers.  Any other list (an
    MoE model's ``first_blocks``) is a list in the reference too: each
    element is a tree of its own."""
    groups = []

    def visit(node, prefix, holders):
        for key in sorted(node):
            name = f"{prefix}['{key}']"
            child = node[key]
            if isinstance(child, list) and key == "blocks":  # stacked layers
                visit(child[0], name, child)
            elif isinstance(child, list):
                for i, sub in enumerate(child):
                    visit(sub, f"{name}[{i}]", [sub])
            elif isinstance(child, dict):
                visit(child, name, [h[key] for h in holders])
            else:
                groups.append((name, [(h, key) for h in holders]))

    visit(params, "", [params])
    return groups


def _unstack_if_one(dense, container):
    """A container built with a leading stack axis, without it when the
    dense leaf was one 2-D weight."""
    if dense.ndim > 2:
        return container
    return dataclasses.replace(container, **{
        f.name: getattr(container, f.name)[0]
        for f in dataclasses.fields(container)
        if isinstance(getattr(container, f.name), torch.Tensor)})


def _copy_tree(node):
    if isinstance(node, dict):
        return {k: _copy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_copy_tree(v) for v in node]
    return node


def build_serve_params(params: Any, policy: CompressionPolicy, *,
                       qcfg: QuantConfig | None = None,
                       table: dict | None = None,
                       block_weights: int | None = None,
                       device=None) -> ServeState:
    """Dense → quant/compressed per policy, on ``device`` (the card unless
    the caller passes another).  Planes, table and LUT are byte-equal to
    the reference's ``build_serve_params`` for the same weights.

    A leaf with a leading expert axis, (E, N, K), is quantized per expert
    and encoded expert by expert; its streams join the dictionary in the
    reference's layer-major, expert-minor order, and one literal capacity
    covers every layer's and expert's planes of that leaf."""
    device = resolve_device(device)
    qcfg = qcfg or QuantConfig(bits=policy.bits, granularity="per_channel")
    bw = block_weights or policy.block_weights
    out = _copy_tree(params)
    groups = _leaf_groups(out)

    # Pass 1: decide actions; quantize selected tensors (each expert of a
    # stacked leaf on its own); gather streams.
    actions, quantized, streams = [], {}, []
    for gi, (name, holders) in enumerate(groups):
        leaf = holders[0][0][holders[0][1]]
        if leaf.ndim < 2:
            actions.append("dense")
            continue
        act = policy.action(name, tuple(leaf.shape[-2:]))
        actions.append(act)
        if act in ("quant", "compressed"):
            per_layer = []
            for h, k in holders:
                w = h[k].to(device)
                subs = w.reshape((-1,) + tuple(w.shape[-2:]))
                per_layer.append([quantize_linear(sub, qcfg) for sub in subs])
            quantized[gi] = per_layer
            if act == "compressed":
                streams.extend(q.values for qls in per_layer for q in qls)

    # Pass 2: one model-wide dictionary (paper: single table per model).
    if table is None and streams:
        table = find_frequent_sequences(streams, max_codes=65535)
    lut = build_lut(table, device=device) if table is not None else None
    index = TableIndex(table, device=device) if table is not None else None

    # Pass 3: build containers.
    n_bytes = {"dense": 0, "quant": 0, "compressed": 0}
    for gi, (name, holders) in enumerate(groups):
        act = actions[gi]
        if act == "dense":
            for h, k in holders:
                h[k] = h[k].to(device)
                n_bytes["dense"] += h[k].numel() * h[k].element_size()
            continue
        per_layer = quantized[gi]
        if act == "quant":
            for (h, k), qls in zip(holders, per_layer):
                h[k] = q = _unstack_if_one(h[k], QuantLinear(
                    torch.stack([q.values for q in qls]),
                    torch.stack([q.scale for q in qls]),
                    torch.stack([q.zero for q in qls])))
                n_bytes["quant"] += q.nbytes
            continue
        shape = tuple(per_layer[0][0].values.shape)
        tiles = choose_fused_tiles(shape, bw)
        tn, tk = tiles[:2] if tiles else (0, 0)

        def encode(q):
            if tiles:
                return encode_blocked_tiled(q.values, index, tile_n=tn,
                                            tile_k=tk, block_weights=bw)
            return encode_blocked(q.values, index, block_weights=bw)

        bcs = [[encode(q) for q in qls] for qls in per_layer]
        cap = max(bc.literals.shape[1] for layer in bcs for bc in layer)
        for (h, k), qls, layer in zip(holders, per_layer, bcs):
            pl = stack_packed(qls, layer, shape=shape, tile_n=tn, tile_k=tk,
                              cap=cap)
            h[k] = pl = _unstack_if_one(h[k], pl)
            n_bytes["compressed"] += (pl.payload_nbytes
                                      + 8 * shape[0] * len(qls))
    if lut is not None:
        n_bytes["compressed"] += lut.numel()
    return ServeState(params=out, lut=lut, table=table, mode=policy.mode,
                      stats=n_bytes)


# ---------------------------------------------------------------------------
# Step functions.
# ---------------------------------------------------------------------------

def make_serve_fns(cfg=None, *, ctx: ServeContext | None = None,
                   device=None):
    """Returns (prefill, decode_step) for serving on ``device`` (from
    ``ctx``, else the argument; the card unless the caller passes another).

    prefill(params, lut, batch, caches) -> (last_logits, caches)
    decode_step(params, lut, token, caches, pos) -> (logits, caches)

    Caches are updated in place and returned.
    """
    if ctx is not None:
        cfg = ctx.cfg if cfg is None else cfg
        device = ctx.device
    device = resolve_device(device)

    def _last_logits(params, hidden, lut):
        """LM head on the final position only."""
        head = params.get("lm_head", params["embed"])
        logits = L.linear(hidden[:, -1:], head, lut)
        if cfg.logits_softcap:
            c = cfg.logits_softcap
            logits = torch.tanh(logits / c) * c
        return logits[:, 0]

    def prefill(params, lut, batch, caches):
        tokens = batch["tokens"].to(device)
        hidden, new_caches, _ = LM.forward(params, cfg, tokens, caches=caches,
                                           pos=0, lut=lut, return_hidden=True)
        return _last_logits(params, hidden, lut), new_caches

    def decode_step(params, lut, token, caches, pos):
        logits, new_caches, _ = LM.forward(params, cfg, token.to(device),
                                           caches=caches, pos=int(pos),
                                           lut=lut)
        return logits[:, -1], new_caches

    return prefill, decode_step


def sample_tokens(logits: torch.Tensor, temperature: float = 0.0,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """The next-token rule: greedy argmax (the first maximum) unless a
    generator and a positive temperature are given, then one categorical
    draw per row from softmax(logits / temperature).  logits (B, V) →
    (B,) token ids."""
    if generator is None or temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(params, cfg, tokens, *, ctx: ServeContext | None = None,
             lut=None, max_new: int = 16, max_len: int | None = None,
             temperature: float = 0.0,
             generator: torch.Generator | None = None, device=None):
    """One-shot generation: one prefill, then ``max_new − 1`` decode steps.
    The prefill's token is greedy; the decode steps follow
    :func:`sample_tokens` with ``temperature`` and ``generator``.

    tokens (B, T0) int; returns (B, T0 + max_new) on the serving device.
    Runs on ``device`` (from ``ctx``, else the argument; the card unless
    the caller passes another).  Prompts of different lengths are
    left-padded by the caller, as in the reference."""
    if ctx is not None:
        cfg = ctx.cfg if cfg is None else cfg
        lut, device = ctx.lut, ctx.device
    device = resolve_device(device)
    tokens = torch.as_tensor(tokens).to(device)
    if max_new <= 0:
        return tokens
    b, t0 = tokens.shape
    max_len = max_len or (t0 + max_new)
    caches = LM.init_caches(cfg, b, max_len, device=device)
    prefill, decode_step = make_serve_fns(cfg, device=device)
    ids = tokens.long()
    logits, caches = prefill(params, lut, {"tokens": ids}, caches)
    # the first new token is greedy whatever the temperature, as in the
    # reference; only the decode steps sample
    tok = sample_tokens(logits, 0.0)[:, None]
    out = [tok]
    for i in range(max_new - 1):
        logits, caches = decode_step(params, lut, tok, caches, t0 + i)
        tok = sample_tokens(logits, temperature, generator)[:, None]
        out.append(tok)
    return torch.cat([tokens] + [t.to(tokens.dtype) for t in out], dim=1)
