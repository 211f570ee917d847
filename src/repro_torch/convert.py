"""Carry weights across from the JAX package, as numpy arrays.

The JAX package stacks per-layer leaves on a leading axis under
``params["blocks"]`` (attention + MLP layers, MoE layers, Mamba2 blocks)
and, for an encoder–decoder, under ``params["encoder"]`` and
``params["decoder"]``; the port keeps lists of per-layer dicts.  An MoE
model's ``first_blocks`` is a list in both, and the hybrid's
``shared_attn`` one unstacked dict in both.  Stacked expert leaves keep
their expert axis: (L, E, N, K) in the reference, (E, N, K) per layer here,
and so do their planes.  These functions take numpy only (``np.asarray`` of
every leaf, done by the caller), so this package never sees a JAX type.

Weight containers travel as plain dicts with a ``"kind"`` key:

  {"kind": "quant", "values", "scale", "zero"}
  {"kind": "packed", "codes" (uint16), "literals", "nlit", "scale", "zero",
   "shape", "tile_n", "tile_k"}
  {"kind": "tiled", the same keys, planes with a column-group axis}

with the same leading layer axis as any other stacked leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.compressed import PackedLinear, QuantLinear, TiledPackedLinear
from .serve.engine import ServeState


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # writable: torch shares it
    if a.dtype == np.uint16:
        a = a.view(np.int16)      # codes: the uint16 bits, as the kernel reads
    return torch.from_numpy(a).to(device)


def _leaf(node, device):
    if isinstance(node, dict) and node.get("kind") == "quant":
        return QuantLinear(_tensor(node["values"], device),
                           _tensor(node["scale"], device),
                           _tensor(node["zero"], device))
    if isinstance(node, dict) and node.get("kind") in ("packed", "tiled"):
        cls = PackedLinear if node["kind"] == "packed" else TiledPackedLinear
        return cls(_tensor(node["codes"], device),
                            _tensor(node["literals"], device),
                            _tensor(node["nlit"], device),
                            _tensor(node["scale"], device),
                            _tensor(node["zero"], device),
                            shape=tuple(int(s) for s in node["shape"]),
                            tile_n=int(node["tile_n"]),
                            tile_k=int(node["tile_k"]))
    if isinstance(node, dict):
        return {k: _leaf(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_leaf(v, device) for v in node]
    return _tensor(node, device)


def _layer(node, i: int):
    """Layer ``i`` of a stacked (leading layer axis) subtree."""
    if isinstance(node, dict):
        return {k: (v if k in ("kind", "shape", "tile_n", "tile_k")
                    else _layer(v, i)) for k, v in node.items()}
    return node[i]


def _stacks(cfg) -> dict:
    """{key: layers} of the reference's stacked lists for ``cfg``."""
    if cfg.family == "encdec":
        return {"encoder": cfg.encoder_layers, "decoder": cfg.decoder_layers}
    return {"blocks": cfg.n_layers - (cfg.first_dense_layers
                                      if cfg.family == "moe" else 0)}


def params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The JAX package's dense parameter tree (numpy leaves, stacked
    ``blocks``, or ``encoder`` and ``decoder``) → the port's parameter
    dict on ``device``."""
    device = resolve_device(device)
    stacks = _stacks(cfg)
    out = {k: _leaf(v, device) for k, v in tree.items() if k not in stacks}
    for k, n in stacks.items():
        out[k] = [_leaf(_layer(tree[k], i), device) for i in range(n)]
    return out


def serve_state_from_numpy(tree: dict, lut, cfg, *, mode: str,
                           table: dict | None = None,
                           stats: dict | None = None,
                           device=None) -> ServeState:
    """A JAX ``ServeState`` (containers as ``"kind"`` dicts, numpy planes
    and LUT) → the port's ``ServeState`` on ``device``."""
    device = resolve_device(device)
    params = params_from_numpy(tree, cfg, device)
    return ServeState(params=params,
                      lut=_tensor(lut, device) if lut is not None else None,
                      table=table, mode=mode, stats=dict(stats or {}))
