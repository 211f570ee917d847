"""What each rank of ``tests/test_torch_mesh_serve.py``'s meshes runs.

The ranks that ``repro_torch.launch.mesh.spawn`` starts import this module
by name, so it imports the port alone (no JAX).  Each rank joins the
mesh, places its share of the served state (``partition.place_params``),
runs every case under the mesh and returns what the test holds against
one process: tokens and each step's logits, single attention calls, the
bytes its caches and its vocab bands hold, the engine's completions."""
import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.serve.context import ServeContext
from repro_torch.serve.engine import (DecodeGraph, _tensors, generate,
                                      make_serve_fns)
from repro_torch.serve.scheduler import Engine, Request
from repro_torch.sharding import partition as PT


def nbytes(tree) -> int:
    """Bytes of every tensor of a tree of dicts, lists and containers."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(nbytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


def eager(cfg, params, lut, toks, max_new, mesh=None, enc=None):
    """``make_serve_fns``' prefill and ``max_new − 1`` greedy decode steps
    over caches of ``T0 + max_new`` positions (the rank's share on a
    mesh): → (tokens (B, max_new), each step's logits (max_new, B, V))."""
    ctx = ServeContext(cfg, lut=lut, device="cpu", mesh=mesh)
    prefill, step = make_serve_fns(ctx=ctx)
    b, t0 = toks.shape
    if cfg.family == "encdec":
        caches = ED.init_caches(cfg, b, t0 + max_new, enc.shape[1],
                                enc_dtype=enc.dtype, device="cpu",
                                mesh=mesh)
        batch = {"tokens": toks, "enc_embeds": enc}
    else:
        caches = LM.init_caches(cfg, b, t0 + max_new, device="cpu",
                                mesh=mesh)
        batch = {"tokens": toks}
    logits, caches = prefill(params, lut, batch, caches)
    steps, out = [logits], [torch.argmax(logits, -1)[:, None]]
    for i in range(max_new - 1):
        logits, caches = step(params, lut, out[-1], caches,
                              torch.tensor(t0 + i))
        steps.append(logits)
        out.append(torch.argmax(logits, -1)[:, None])
    return torch.cat(out, 1), torch.stack(steps)


def attention_calls(cfg, layer, lut, x, t0, mesh=None):
    """Layer 0's attention (GQA or MLA) on ``x`` (B, T0 + 1, d): a prefill
    of the first T0 positions into caches of T0 + 1, then a decode step
    of the last at ``pos`` T0 (a 0-d tensor): → (prefill y, decode y)."""
    b = x.shape[0]
    caches = LM.init_caches(cfg, b, t0 + 1, device="cpu", mesh=mesh,
                            rows=False)
    cache = (caches.get("first") or caches["blocks"])[0]
    attn = L.apply_mla if cfg.mla else L.apply_attention
    with PT.active_mesh(mesh):
        y0, cache = attn(layer, x[:, :t0], cfg, lut=lut, cache=cache,
                         pos=0)
        y1, _ = attn(layer, x[:, t0:], cfg, lut=lut, cache=cache,
                     pos=torch.tensor(t0))
    return y0, y1


def run(rank: int, shape: tuple, cases: dict) -> dict:
    """``cases``: {kind: {key: inputs}} (``test_torch_mesh_serve._cases``)."""
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"))
    out = {"coords": dict(mesh.coords)}
    for key, (cfg, params, lut, toks, max_new) in cases.get(
            "generate", {}).items():
        placed = PT.place_params(params, mesh)
        ctx = ServeContext(cfg, lut=lut, device="cpu", mesh=mesh)
        ops.DISPATCH_COUNTS.clear()
        got = generate(placed, cfg, toks, ctx=ctx, max_new=max_new)
        graph = DecodeGraph(cfg, toks.shape[0], toks.shape[1] + max_new,
                            device="cpu", mesh=mesh)
        sampled = generate(placed, cfg, toks, ctx=ctx, max_new=max_new,
                           temperature=0.8,
                           generator=torch.Generator().manual_seed(11))
        out[key] = {"tokens": got, "dispatch": dict(ops.DISPATCH_COUNTS),
                    "sampled": sampled,
                    "eager": eager(cfg, placed, lut, toks, max_new, mesh),
                    "cache_bytes": nbytes(graph.caches),
                    "cache_shapes": [tuple(t.shape)
                                     for t in _tensors(graph.caches)],
                    "vocab_bytes": {k: nbytes(placed[k]) for k in
                                    ("embed", "lm_head") if k in placed},
                    "rows": graph.rows}
    for key, (cfg, params, lut, toks, max_new, enc) in cases.get(
            "encdec", {}).items():
        placed = PT.place_params(params, mesh)
        out[key] = eager(cfg, placed, lut, toks, max_new, mesh, enc)
    for key, (cfg, layer, lut, x, t0) in cases.get("attention",
                                                   {}).items():
        out[key] = attention_calls(cfg, PT.place_params(layer, mesh), lut, x,
                                   t0, mesh)
    for key, (table, ids) in cases.get("embed", {}).items():
        band = PT.place_vocab(table, mesh)
        with PT.active_mesh(mesh):
            out[key] = (L.embed(band, ids), nbytes(band), band.mesh_axes)
    for key, (cfg, params, lut, prompts, max_new) in cases.get(
            "engine", {}).items():
        placed = PT.place_params(params, mesh)
        ctx = ServeContext(cfg, lut=lut, device="cpu", mesh=mesh)
        eng = Engine(ctx, placed, n_slots=2, max_len=32, page_size=4)
        for i, p in enumerate(prompts):
            eng.submit(Request(tokens=p, max_new=max_new, rid=i))
        eng.drain()
        got = {c.rid: [int(t) for t in c.tokens] for c in eng.completions}
        alone = {i: generate(placed, cfg, torch.as_tensor(p)[None], ctx=ctx,
                             max_new=max_new, max_len=eng.pool.max_len
                             )[0].tolist() for i, p in enumerate(prompts)}
        out[key] = (got, alone, nbytes(eng.pool.pages),
                    eng.pool.pages_per_slot)
    return out
