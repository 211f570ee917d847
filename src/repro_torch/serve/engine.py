"""Serving runtime — compressed-weight inference, the paper's system.

Counterpart of ``repro/serve/engine.py`` for one device:
  1. ``build_serve_params``: quantize every policy-selected weight to int8
     per channel, build ONE model-wide dictionary over the quantized byte
     streams, and encode each tensor in the tile-major blocked layout; a
     stacked expert leaf (E, N, K) is quantized and encoded expert by
     expert into one stacked container; under ``CompressionPolicy(tiles=
     G)`` every other compressed weight whose in-dim G divides is stored
     as G column groups (``TiledPackedLinear``), which K1 reads in one
     launch.  It runs on the card by default
     (quantization, counting and encoding are tensor ops on the weights'
     device).
  2. ``generate``: one prefill, then the greedy (or sampled) decode
     phase.  On the card the decode phase replays one captured CUDA graph
     of a decode step (:class:`DecodeGraph`, the counterpart of the
     reference's jitted ``_decode_loop``); on the CPU the same step runs
     eagerly in a Python loop.  Every compressed
     projection runs the fused decode→dequant→matmul kernel, every
     compressed expert stack the grouped one, an int8 LM head the
     dequant-matmul kernel, prefill attention the flash-attention kernel,
     and MLA's absorbed wkv_b the dict-decode kernel.

The continuous-batching scheduler (``serve/scheduler.py``) builds on the
prefill of :func:`make_serve_fns`, :func:`sample_tokens`' per-row mode and
the capture helpers here.  The resilience ladder (``serve/resilience.py``)
wraps :func:`generate` and frees a failed rung's graphs with
:func:`drop_graphs`; ``build_serve_params`` records the integrity
manifest.  Tiered expert residency (``serve/residency.py``) takes over
:func:`make_serve_fns` and :func:`generate` when the context carries a
manager.  An encoder–decoder (``models/encdec.py``) is served through
:func:`make_serve_fns` and :func:`decode_graph`.

On a device mesh (``ServeContext.mesh``, a ``launch.mesh.Mesh`` of
ranks): ``build_serve_params(model_shards=N)`` picks tiles that divide
each model shard's out dim, each rank serves its share of the state
(``sharding.partition.place_params``), and :func:`make_serve_fns` and
:func:`generate` run their steps under the mesh
(``partition.active_mesh``), where the compressed matmuls take their
sharded branches (``kernels.ops``).  Collectives over gloo cannot be
captured in a CUDA graph, so on a mesh the decode phase runs eagerly and
:func:`decode_graph` refuses a mesh.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time
import weakref
from typing import Any, Optional

import torch

from .._device import resolve_device
from ..core.blocked_codec import (TableIndex, build_lut, choose_fused_tiles,
                                  encode_blocked, encode_blocked_tiled)
from ..core.codec import find_frequent_sequences
from ..core.compressed import (QuantLinear, encode_tiled_planes,
                               quantize_linear, stack_packed, stack_tiled)
from ..core.integrity import build_manifest, leaf_groups
from ..core.policy import CompressionPolicy
from ..core.quant import QuantConfig
from ..kernels import _build, ops
from ..models import encdec as ED
from ..models import layers as L
from ..models import lm as LM
from ..sharding import partition as PT
from .context import ServeContext

# Captures of a step, the counterpart of the reference's TRACE_COUNTS:
# "decode_loop" for generate's decode step, "generate_step" for the
# scheduler's; one per capture, none for a replay.
CAPTURE_COUNTS: collections.Counter = collections.Counter()

# What the kernel wrappers and weight containers count from Python.  A
# captured step's Python runs once, at capture: its counts are taken back
# then and added at every replay.
_STEP_COUNTERS = (_build.LAUNCH_COUNTS, _build.KERNEL_COUNTS,
                  ops.DISPATCH_COUNTS, L.MATERIALIZE_COUNTS)


@dataclasses.dataclass
class ServeState:
    params: Any
    lut: Optional[torch.Tensor]
    table: Optional[dict]
    mode: str
    stats: dict
    # per-plane integrity manifest (core/integrity.py) recorded at pack
    # time; verify_serve_state re-hashes against it before serving
    manifest: Optional[dict] = None

    def to(self, device) -> "ServeState":
        """The same artifact with every tensor on ``device`` (the same
        bytes, so the manifest still holds)."""
        return dataclasses.replace(
            self, params=_map_leaves(self.params, lambda t: t.to(device)),
            lut=self.lut.to(device) if self.lut is not None else None)


def _map_leaves(node, fn):
    if isinstance(node, dict):
        return {k: _map_leaves(v, fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_leaves(v, fn) for v in node]
    return fn(node)


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
                       model_shards: int = 1,
                       manifest: bool = True,
                       device=None) -> ServeState:
    """Dense → quant/compressed per policy, on ``device`` (the card unless
    the caller passes another).  Planes, table and LUT are byte-equal to
    the reference's ``build_serve_params`` for the same weights, and so is
    the integrity manifest (``manifest=True``: ``core.integrity.
    build_manifest``, which records its own seconds as ``build_s``).

    A leaf with a leading expert axis, (E, N, K), is quantized per expert
    and encoded expert by expert; its streams join the dictionary in the
    reference's layer-major, expert-minor order, and one literal capacity
    covers every layer's and expert's planes of that leaf.

    ``policy.tiles = G > 1``: a compressed leaf whose in-dim G divides and
    whose path holds no ``"experts"`` (expert stacks stay stacked
    ``PackedLinear``s for K3) becomes a ``TiledPackedLinear`` per layer,
    its G column groups encoded on their own (``encode_tiled_planes``,
    tile-major where the (out, in/G) sub-weight admits it), one literal
    capacity across the leaf's layers and groups.

    ``model_shards``: the model-axis size of the serving mesh.  The fused
    tiles then divide each shard's out dim (``choose_fused_tiles(shards=
    (model_shards, 1))``, expert stacks and column groups included), so
    every rank's out band is whole tiles and serving on the mesh takes
    the sharded fused kernels."""
    device = resolve_device(device)
    qcfg = qcfg or QuantConfig(bits=policy.bits, granularity="per_channel")
    bw = block_weights or policy.block_weights
    out = _copy_tree(params)
    groups = leaf_groups(out)

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
        if (policy.tiles > 1 and shape[-1] % policy.tiles == 0
                and "experts" not in name):
            per = [[encode_tiled_planes(q.values, index, policy.tiles,
                                        block_weights=bw, tile="auto",
                                        shards=(model_shards, 1))
                    for q in qls] for qls in per_layer]
            tn, tk = per[0][0][1], per[0][0][2]
            cap = max(bc.literals.shape[1] for layer in per
                      for bcs, _, _ in layer for bc in bcs)
            for (h, k), qls, layer in zip(holders, per_layer, per):
                tl = stack_tiled(qls, [bcs for bcs, _, _ in layer],
                                 shape=shape, tile_n=tn, tile_k=tk, cap=cap)
                h[k] = tl = _unstack_if_one(h[k], tl)
                n_bytes["compressed"] += (tl.payload_nbytes
                                          + 8 * shape[0] * len(qls))
            continue
        tiles = choose_fused_tiles(shape, bw, shards=(model_shards, 1))
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
                      stats=n_bytes,
                      manifest=(build_manifest(out, lut, table) if manifest
                                else None))


# ---------------------------------------------------------------------------
# Step functions.
# ---------------------------------------------------------------------------

def make_serve_fns(cfg=None, *, ctx: ServeContext | None = None,
                   device=None):
    """Returns (prefill, decode_step) for serving on ``device`` (from
    ``ctx``, else the argument; the card unless the caller passes another).

    prefill(params, lut, batch, caches) -> (last_logits, caches)
      (``batch``: {"tokens": (B, T0)} and, for a VLM, "embeds" (B, T', d),
      prepended; the first decode position is then T' + T0; for an
      encoder–decoder, "enc_embeds" (B, S, d), the encoder's frames, and
      ``caches`` from ``encdec.init_caches``)
    decode_step(params, lut, token, caches, pos) -> (logits, caches)

    Caches are updated in place and returned.  ``pos`` is an int, a 0-d
    tensor or a per-row (B,) tensor; a tensor is never read on the host.
    A ``ctx`` with a ``residency`` manager gives the tiered closures
    (``serve.residency.make_tiered_serve_fns``): each step runs through
    the manager's fetch/replay protocol.  A ``ctx`` with a ``mesh`` gives
    closures that run under it (``partition.active_mesh``), over the
    rank's share of the params.
    """
    if ctx is not None:
        cfg = ctx.cfg if cfg is None else cfg
        device = ctx.device
        if ctx.residency is not None:
            from . import residency as _res
            return _res.make_tiered_serve_fns(
                ctx if cfg is ctx.cfg else ctx.with_cfg(cfg))
        if ctx.mesh is not None:
            return _on_mesh(serve_fns(cfg, resolve_device(device)), ctx.mesh)
    return serve_fns(cfg, resolve_device(device))


def _on_mesh(fns, mesh):
    """Each of ``fns`` run under ``mesh`` (``partition.active_mesh``)."""
    def wrap(fn):
        def run(*a, **kw):
            with PT.active_mesh(mesh):
                return fn(*a, **kw)
        return run
    return tuple(wrap(f) for f in fns)


def serve_fns(cfg, device: torch.device, *, routing: bool = False):
    """The resident (prefill, decode_step) of :func:`make_serve_fns` on
    ``device``.  ``routing=True`` (MoE family) appends each step's expert
    ids, (L_moe, B·T, k), to what it returns: the steps the residency
    manager launches."""
    if routing and cfg.family == "encdec":
        raise ValueError("routing capture is not supported for encdec")

    def _last_logits(params, hidden, lut):
        """LM head on the final position only."""
        head = params["lm_head"] if "lm_head" in params else params["embed"]
        logits = L.linear(hidden[:, -1:], head, lut)
        if cfg.logits_softcap:
            c = cfg.logits_softcap
            logits = torch.tanh(logits / c) * c
        return logits[:, 0]

    if cfg.family == "encdec":
        def prefill_ed(params, lut, batch, caches):
            hidden, caches = ED.forward(
                params, cfg, batch["enc_embeds"].to(device),
                batch["tokens"].to(device), caches=caches, pos=0, lut=lut,
                return_hidden=True)
            return _last_logits(params, hidden, lut), caches

        def decode_step_ed(params, lut, token, caches, pos):
            logits, caches = ED.decode_step(params, cfg, token.to(device),
                                            caches, pos, lut=lut)
            return logits[:, -1], caches

        return prefill_ed, decode_step_ed

    def prefill(params, lut, batch, caches):
        tokens = batch["tokens"].to(device)
        embeds = batch.get("embeds")
        out = LM.forward(params, cfg, tokens, caches=caches, pos=0, lut=lut,
                         embeds=None if embeds is None else embeds.to(device),
                         return_hidden=True, return_routing=routing)
        return (_last_logits(params, out[0], lut), out[1]) + out[3:]

    def decode_step(params, lut, token, caches, pos):
        out = LM.forward(params, cfg, token.to(device), caches=caches,
                         pos=pos, lut=lut, return_routing=routing)
        return (out[0][:, -1], out[1]) + out[3:]

    return prefill, decode_step


_MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x · c mod 2^32 for x in [0, 2^32) (an int or an int64 tensor): the
    constant is split in 16-bit halves, so no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def _mix32(x):
    """A 32-bit integer hash (Wellons' lowbias32) of x in [0, 2^32), by
    the same operators on a Python int and on an int64 tensor, so the host
    and either device give the same bits."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """A request's 32-bit sampling key from its integer seed (the port's
    counterpart of ``jax.random.PRNGKey(seed)``)."""
    seed = int(seed) & ((1 << 64) - 1)
    return _mix32((seed & _MASK32) ^ _mix32((seed >> 32) ^ 0x9E3779B9))


def fold_in(keys, data):
    """Per-row keys folded with per-row data (the absolute position), as
    ``jax.random.fold_in``: int64 tensors (B,) → (B,) in [0, 2^32)."""
    return _mix32(keys ^ _mix32((data + 0x632BE5AB) & _MASK32))


def _row_uniforms(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) uniforms in (0, 1), a pure function of each row's key and
    the column index: a 32-bit hash per element, its top 24 bits centred
    in their interval (exact in f32)."""
    cols = _mix32(torch.arange(n, dtype=torch.int64, device=keys.device)
                  ^ 0x85EBCA6B)
    h = _mix32(keys[:, None] ^ cols[None, :])
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def sample_tokens(logits: torch.Tensor, temperature=0.0,
                  generator: torch.Generator | None = None, *,
                  keys: torch.Tensor | None = None) -> torch.Tensor:
    """The next-token rule.  logits (B, V) → (B,) token ids.  Two modes:

    * a scalar ``temperature``: greedy argmax (the first maximum) unless a
      generator and a positive temperature are given, then one categorical
      draw per row from softmax(logits / temperature);
    * per-row temperatures (B,) with per-row ``keys`` (B,) (from
      :func:`fold_in`): each row draws from its own counter-based stream,
      a pure function of its key and its logits, the same on any device
      and with no host read; rows at temperature 0 take the greedy argmax
      exactly.

    A draw is the argmax of p / q with q ~ Exp(1), the race
    ``torch.multinomial(probs, 1)`` runs for one sample, without its
    host-side check of probs, which synchronizes and so cannot be
    captured."""
    greedy = torch.argmax(logits, dim=-1)
    if torch.is_tensor(temperature) and temperature.ndim == 1:
        temp = temperature.to(torch.float32)
        probs = torch.softmax(logits.to(torch.float32)
                              / torch.clamp(temp, min=1e-6)[:, None], dim=-1)
        q = -torch.log(_row_uniforms(keys, logits.shape[-1]))
        return torch.where(temp > 0, torch.argmax(probs / q, dim=-1), greedy)
    if generator is None or temperature <= 0:
        return greedy
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def _tensors(node):
    """Every tensor of a tree of dicts, lists and weight containers."""
    if torch.is_tensor(node):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            yield from _tensors(getattr(node, f.name))


@contextlib.contextmanager
def no_collection():
    """Python's cyclic garbage collector held off for the block: a CUDA
    graph that a dead cycle holds, destroyed by a collection while another
    graph is being captured, invalidates that capture
    (``torch.cuda.graph`` no longer collects before it captures)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def capture_step(step, generator: torch.Generator | None = None):
    """Capture ``step()`` in a CUDA graph (its kernels are recorded, not
    run), with no garbage collection during the capture
    (:func:`no_collection`).  → (graph, the counts its Python added to
    each of ``_STEP_COUNTERS``, which are taken back, host ms of the
    capture).  A capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    before = [collections.Counter(c) for c in _STEP_COUNTERS]
    t0 = time.perf_counter()
    try:
        with no_collection(), torch.cuda.graph(graph):
            step()
    finally:
        counts = [c - b for c, b in zip(_STEP_COUNTERS, before)]
        for c, b in zip(_STEP_COUNTERS, before):
            c.clear()
            c.update(b)
    return graph, counts, (time.perf_counter() - t0) * 1e3


def replay_step(graph, counts):
    """Replay a graph of :func:`capture_step`; add its step's counts."""
    graph.replay()
    for c, d in zip(_STEP_COUNTERS, counts):
        c.update(d)


class DecodeGraph:
    """The decode phase as replays of one captured CUDA graph of a decode
    step: the port's counterpart of the reference's jitted
    ``_decode_loop``.

    It owns what the step reads and writes, at fixed addresses: the token
    input (B, 1), the position (a 0-d int64 tensor), the KV or latent
    caches (which the prefill writes into) and a (B, max_len) buffer that
    takes each new token at column pos + 1.  An encoder–decoder's caches
    (``encdec.init_caches``: ``enc_len`` frames, cross K/V in
    ``enc_dtype``, the frames' dtype) also hold each decoder layer's cross
    K/V, which every prefill copies into the same buffers, so a replay
    reads the frames last prefilled.  The step decodes, samples,
    writes the token into the input and the buffer, and adds one to the
    position.  Between replays the host only launches the next one.

    The first decode step after a prefill runs eagerly (a real step, whose
    token is kept; it loads every kernel, function attribute and library
    handle the step needs), and the step is then captured once; every
    later step, in this call and the next, is a replay.  The counts the
    step's Python adds to the launch, dispatch and materialize counters
    at capture are taken back and added at each replay.  A capture that
    fails raises.  On a device without graphs (the CPU) every step runs
    eagerly on the same buffers.

    ``temperature > 0`` samples from the graph's own generator, which
    the graph registers (each replay advances its offset); :meth:`run`
    starts it from the caller's generator's state and hands the advanced
    state back, so the draws are the eager loop's with that generator."""

    def __init__(self, cfg, batch: int, max_len: int, *,
                 temperature: float = 0.0, enc_len: int = 0,
                 enc_dtype=torch.bfloat16, device=None, mesh=None):
        device = resolve_device(device)
        self.device, self.temperature = device, temperature
        self.mesh = mesh
        self.generator = (torch.Generator(device=device) if temperature > 0
                          else None)
        if cfg.family == "encdec":
            self.caches = ED.init_caches(cfg, batch, max_len, enc_len,
                                         enc_dtype=enc_dtype, device=device)
        else:
            self.caches = LM.init_caches(cfg, batch, max_len, device=device)
        self.tok = torch.zeros((batch, 1), dtype=torch.long, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)
        self.seq = torch.zeros((batch, max_len), dtype=torch.long,
                               device=device)
        self._fns = make_serve_fns(ctx=ServeContext(cfg, device=device,
                                                    mesh=mesh))
        self.graph = None
        self.step_counts = None        # per replay, one per _STEP_COUNTERS
        self.capture_ms = None         # host time of the capture
        self._finalizers: list = []

    def prefill(self, params, lut, ids: torch.Tensor,
                embeds: torch.Tensor | None = None,
                enc_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Zero the caches (KV and SSM state) and prefill ``ids`` (B, T0),
        after ``embeds`` (B, T', d) where given, into them (an
        encoder–decoder: over ``enc_embeds`` (B, S, d), whose cross K/V
        go into the caches' buffers); the greedy first token goes into
        the input, T' + T0 into the position.  → that token (B, 1)."""
        for t in _tensors(self.caches):
            t.zero_()
        logits, _ = self._fns[0](params, lut, {
            "tokens": ids, "embeds": embeds, "enc_embeds": enc_embeds},
            self.caches)
        tok = sample_tokens(logits, 0.0)[:, None]
        self.tok.copy_(tok)
        self.pos.fill_(_extra(embeds) + ids.shape[1])
        return tok

    def step(self, params, lut):
        """One decode step on the buffers (what the graph captures)."""
        logits, _ = self._fns[1](params, lut, self.tok, self.caches,
                                 self.pos)
        nxt = sample_tokens(logits, self.temperature,
                            self.generator)[:, None]
        self.tok.copy_(nxt)
        self.seq.index_copy_(1, (self.pos + 1)[None], nxt)
        self.pos.add_(1)

    def capture(self, params, lut):
        self.graph, self.step_counts, self.capture_ms = capture_step(
            lambda: self.step(params, lut), self.generator)
        CAPTURE_COUNTS["decode_loop"] += 1

    def replay(self):
        replay_step(self.graph, self.step_counts)

    def decode(self, params, lut, steps: int):
        """``steps`` decode steps after :meth:`prefill`: replays, after an
        eager step and the capture when there is no graph yet; eager steps
        on the CPU and on a mesh (its collectives are not captured)."""
        if self.device.type != "cuda" or self.mesh is not None:
            for _ in range(steps):
                self.step(params, lut)
            return
        if self.graph is None and steps:
            self.step(params, lut)
            self.capture(params, lut)
            steps -= 1
        for _ in range(steps):
            self.replay()

    def run(self, params, lut, ids: torch.Tensor, max_new: int,
            generator: torch.Generator | None = None,
            embeds: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None):
        """Prefill ``ids`` (B, T0) after ``embeds`` (B, T', d) where given
        (an encoder–decoder: over the frames ``enc_embeds`` (B, S, d)),
        then ``max_new − 1`` decode steps from position T' + T0, sampling
        (if the graph samples) from ``generator``'s state, which is
        advanced as the eager loop would advance it.  → the ``max_new``
        new tokens (B, max_new), int64."""
        t0 = _extra(embeds) + ids.shape[1]
        if t0 + max_new > self.seq.shape[1]:
            raise ValueError(f"{t0} prompt + {max_new} new tokens "
                             f"exceed the caches' {self.seq.shape[1]}")
        if self.generator is not None:
            self.generator.set_state(generator.get_state())
        tok = self.prefill(params, lut, ids, embeds, enc_embeds)
        self.decode(params, lut, max_new - 1)
        if self.generator is not None:
            generator.set_state(self.generator.get_state())
        return torch.cat([tok, self.seq[:, t0 + 1:t0 + max_new]], dim=1)


def _extra(embeds) -> int:
    """The positions a prefix of ``embeds`` (B, T', d) takes: T' (0 for
    none)."""
    return 0 if embeds is None else embeds.shape[1]


# The graphs decode_graph keeps, least recently used first.  Each holds
# its own caches, token buffer and graph pool, so the cache is bounded by
# count: a new shape past the bound frees the least recently used graph.
MAX_GRAPHS = 4
_GRAPHS: collections.OrderedDict = collections.OrderedDict()


def _forget(graph):
    for f in graph._finalizers:
        f.detach()


def _drop_graph(key, ref):
    graph = ref()
    if graph is not None and _GRAPHS.get(key) is graph:
        del _GRAPHS[key]
        _forget(graph)


def decode_graph(params, cfg, lut, batch: int, max_len: int, *,
                 temperature: float = 0.0,
                 generator: torch.Generator | None = None,
                 enc_len: int = 0, enc_dtype=torch.bfloat16,
                 device=None, mesh=None) -> DecodeGraph:
    """The :class:`DecodeGraph` of this configuration, batch, cache length,
    sampling rule (greedy, or a temperature when a ``generator`` is
    given) and, for an encoder–decoder, frames (``enc_len``, ``enc_dtype``)
    over these weights, made at the first call.  An encoder–decoder's
    decode phase is ``decode_graph(...).run(..., enc_embeds=frames)``: the
    counterpart of the reference's ``_decode_loop`` after its prefill.
    Graphs are kept by the ``data_ptr()`` of every parameter tensor and of
    the LUT, so a new
    ``ServeState`` gets a graph of its own, and a graph goes as soon as a
    tensor it reads is freed: none outlives its weights.  At most
    ``MAX_GRAPHS`` are kept; a new one past that frees the least recently
    used.  A ``mesh`` is refused: collectives over gloo cannot be captured
    in a CUDA graph (``generate`` on a mesh decodes eagerly; capture with
    NCCL across cards is not ported)."""
    if mesh is not None:
        raise ValueError("decode_graph: a step on a mesh runs collectives "
                         "over gloo, which a CUDA graph cannot capture; "
                         "generate(ctx=ServeContext(..., mesh=)) decodes "
                         "eagerly on a mesh")
    device = resolve_device(device)
    temperature = (max(float(temperature), 0.0) if generator is not None
                   else 0.0)
    leaves = list(_tensors(params)) + ([lut] if lut is not None else [])
    key = (cfg, batch, max_len, device, temperature, enc_len, enc_dtype,
           tuple(t.data_ptr() for t in leaves))
    graph = _GRAPHS.get(key)
    if graph is not None:
        _GRAPHS.move_to_end(key)
        return graph
    while len(_GRAPHS) >= MAX_GRAPHS:
        _forget(_GRAPHS.popitem(last=False)[1])
    graph = _GRAPHS[key] = DecodeGraph(cfg, batch, max_len,
                                       temperature=temperature,
                                       enc_len=enc_len, enc_dtype=enc_dtype,
                                       device=device)
    ref = weakref.ref(graph)
    graph._finalizers = [weakref.finalize(t, _drop_graph, key, ref)
                         for t in leaves]
    return graph


def drop_graphs(cfg) -> int:
    """Free every kept :class:`DecodeGraph` of configuration ``cfg`` (with
    its caches and graph pool), so that a later call captures anew.  The
    resilience ladder drops a rung's graphs when it leaves the rung: a
    capture that raised leaves a graph with ``graph is None`` behind.
    → how many were dropped."""
    keys = [k for k in _GRAPHS if k[0] == cfg]
    for k in keys:
        _forget(_GRAPHS.pop(k))
    return len(keys)


@torch.no_grad()
def generate(params, cfg, tokens, *, ctx: ServeContext | None = None,
             lut=None, max_new: int = 16, max_len: int | None = None,
             temperature: float = 0.0,
             generator: torch.Generator | None = None, embeds=None,
             device=None):
    """One-shot generation: one prefill, then ``max_new − 1`` decode steps.
    The prefill's token is greedy; the decode steps follow
    :func:`sample_tokens` with ``temperature`` and ``generator``.

    tokens (B, T0) int; returns (B, T0 + max_new) on the serving device.
    Runs on ``device`` (from ``ctx``, else the argument; the card unless
    the caller passes another).  Prompts of different lengths are
    left-padded by the caller, as in the reference.  The decode steps are
    those of :func:`decode_graph`'s graph: on the card, replays of one
    captured step (a later call with the same weights and shapes captures
    nothing); on the CPU, the same step run eagerly in a Python loop.  The
    first new token is greedy whatever the temperature, as in the
    reference; only the decode steps sample.  ``embeds`` (B, T', d), a
    VLM's patch embeddings, are prepended to the prompt's embeddings at
    the prefill, so the decode starts at T' + T0 (the cache holds T' + T0
    + max_new positions unless ``max_len`` says more); the returned
    sequence holds the tokens alone.  A ``ctx`` with a
    ``residency`` manager serves through ``residency.tiered_generate``
    (eager steps under the fetch/replay protocol, bitwise equal).  An
    encoder–decoder raises ``ValueError``, as the reference's ``generate``
    does (its ``init_caches`` refuses the family): it is served through
    :func:`make_serve_fns` or :func:`decode_graph`.  A ``ctx`` with a
    ``mesh`` serves the rank's share of ``params`` under it, its decode
    steps eager (same tokens on every rank)."""
    if cfg is None and ctx is not None:
        cfg = ctx.cfg
    if cfg.family == "encdec":
        raise ValueError("generate serves decoder-only LMs; family 'encdec' "
                         "decodes through make_serve_fns or decode_graph "
                         "(with its enc_embeds)")
    if ctx is not None:
        lut, device = ctx.lut, ctx.device
        if ctx.residency is not None:
            from . import residency as _res
            if embeds is not None:
                raise ValueError("tiered residency serves MoE models; "
                                 "embeds are a VLM's")
            return _res.tiered_generate(
                params, cfg, tokens, ctx=ctx, max_new=max_new,
                max_len=max_len, temperature=temperature,
                generator=generator)
    device = resolve_device(device)
    tokens = torch.as_tensor(tokens).to(device)
    if max_new <= 0:
        return tokens
    if embeds is not None:
        embeds = torch.as_tensor(embeds).to(device)
    b, t0 = tokens.shape
    length = max_len or (_extra(embeds) + t0 + max_new)
    mesh = ctx.mesh if ctx is not None else None
    if mesh is not None:
        graph = DecodeGraph(cfg, b, length, temperature=(
            max(float(temperature), 0.0) if generator is not None else 0.0),
            device=device, mesh=mesh)
    else:
        graph = decode_graph(params, cfg, lut, b, length,
                             temperature=temperature, generator=generator,
                             device=device)
    new = graph.run(params, lut, tokens.long(), max_new, generator, embeds)
    return torch.cat([tokens, new.to(tokens.dtype)], dim=1)
