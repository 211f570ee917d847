"""Dry-run planning: each cell's parameters, train state, caches and
inputs at full size, as empty tensors.

Counterpart of ``repro/launch/specs.py``.  Its ``ShapeDtypeStruct``
stand-ins are here tensors on the ``meta`` device, or fake tensors on any
device under a ``torch._subclasses.fake_tensor.FakeTensorMode`` (the dry
run's: ``launch/dryrun.py`` plans on fake ``cuda`` tensors, so the port
takes its card branches).  Nothing is allocated and nothing is drawn: the
trees come from the port's own initializers (``models.lm.init_lm``,
``models.encdec.init_encdec``), so a plan's shapes cannot drift from the
model's, and the served containers from the compressed planners
(``core.compressed.planned_*``) with the tiles ``build_serve_params``
picks.  The port keeps a model's layers as a list, so a tree holds a
leaf per layer where the reference stacks them.

``input_specs(arch_id, shape_name)`` yields the four assigned input-shape
cells; serve shapes include the caches.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs import get_config
from ..core.blocked_codec import choose_fused_tiles
from ..core.compressed import (lut_spec, planned_packed_specs,
                               planned_quant_specs, planned_tiled_specs)
from ..core.integrity import leaf_groups
from ..core.policy import CompressionPolicy
from ..models import encdec as ED
from ..models import lm as LM
from ..sharding.partition import clean_keystr, is_row_parallel
from ..train import tree as T
from ..train.optimizer import (AdamWConfig, QMoment, moment_block,
                               quantizable)

# The four assigned LM shapes: (name, seq_len, global_batch, kind)
SHAPES = {
    "train_4k":    dict(seq=4_096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32_768, batch=32, kind="prefill"),
    "decode_32k":  dict(seq=32_768, batch=128, kind="decode"),
    "long_500k":   dict(seq=524_288, batch=1, kind="decode"),
}


def shape_applicable(cfg, shape_name: str) -> tuple[bool, str]:
    """The reference's rule: only long-context models take long_500k."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, "long_500k skipped: full quadratic attention"
    return True, ""


def dense_param_specs(cfg, dtype=torch.bfloat16, device="meta") -> Any:
    """The model's dense parameter tree from its initializer, on
    ``device`` (``meta``, or a fake device under a ``FakeTensorMode``)."""
    init = ED.init_encdec if cfg.family == "encdec" else LM.init_lm
    return init(cfg, device=device, dtype=dtype)


def serve_param_specs(cfg, policy: CompressionPolicy, dtype=torch.bfloat16,
                      model_shards: int = 1, device="meta"
                      ) -> tuple[Any, Any]:
    """(params with planned containers, the LUT's stand-in or None), as
    ``serve.engine.build_serve_params(policy, model_shards=)`` packs them:
    each policy-selected leaf a ``QuantLinear``, a ``PackedLinear`` (a
    stacked one for an expert leaf) or, under ``policy.tiles`` > 1 and
    outside the expert stacks, a ``TiledPackedLinear``; the fused tiles
    from ``choose_fused_tiles(shards=(model_shards, 1))``, so a mesh
    rank's out band is whole tiles.  Each layer's leaf is its own
    container; a ``PackedLinear`` carries the reference's
    ``row_parallel`` flag."""
    params = dense_param_specs(cfg, dtype, device)
    bw = policy.block_weights
    any_compressed = False
    for name, holders in leaf_groups(params):
        leaf = holders[0][0][holders[0][1]]
        if leaf.ndim < 2:
            continue
        shape2, lead = tuple(leaf.shape[-2:]), tuple(leaf.shape[:-2])
        act = policy.action(name, shape2)
        if act == "dense":
            continue
        any_compressed |= act == "compressed"
        for h, k in holders:
            if act == "quant":
                h[k] = planned_quant_specs(shape2, stacked=lead,
                                           device=device)
            elif (policy.tiles > 1 and shape2[1] % policy.tiles == 0
                  and "experts" not in name):
                picked = choose_fused_tiles(
                    (shape2[0], shape2[1] // policy.tiles), bw,
                    shards=(model_shards, 1))
                tn, tk = picked[:2] if picked else (0, 0)
                h[k] = planned_tiled_specs(shape2, policy.tiles,
                                           stacked=lead, block_weights=bw,
                                           tile_n=tn, tile_k=tk,
                                           device=device)
            else:
                picked = choose_fused_tiles(shape2, bw,
                                            shards=(model_shards, 1))
                tn, tk = picked[:2] if picked else (0, 0)
                h[k] = pl = planned_packed_specs(
                    shape2, stacked=lead, block_weights=bw, tile_n=tn,
                    tile_k=tk, device=device)
                pl.row_parallel = is_row_parallel(clean_keystr(name))
    return params, (lut_spec(device=device) if any_compressed else None)


def train_state_specs(cfg, optimizer: AdamWConfig,
                      param_dtype=torch.bfloat16, device="meta") -> Any:
    """{"params", "opt"}: the dense parameters and the moments
    ``optimizer.adamw_init`` makes for them — f32, or int8 ``QMoment``s
    in blocks of ``moment_block`` where ``quantizable`` decides by the
    leaf's stacked shape — and the step count."""
    params = dense_param_specs(cfg, param_dtype, device)
    counts = T.stack_counts(params)

    def empty(shape, dtype):
        return torch.empty(tuple(shape), dtype=dtype, device=device)

    def moments(path, p):
        if quantizable(p, optimizer, T.stacked_shape(path, p, counts)):
            *lead, last = p.shape
            b = moment_block(last, optimizer.qblock)
            return {k: QMoment(empty((*lead, last // b, b), torch.uint8),
                               empty((*lead, last // b, 1), torch.float32),
                               empty((*lead, last // b, 1), torch.float32))
                    for k in ("m", "v")}
        return {k: empty(p.shape, torch.float32) for k in ("m", "v")}

    mu = T.unflatten(params, [moments(path, p)
                              for path, p in T.flatten(params)])
    return {"params": params,
            "opt": {"mu": mu, "step": empty((), torch.int32)}}


def _enc_len(cfg, seq: int) -> int:
    return seq  # audio frames length == assigned seq_len


def cache_specs_for(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                    device="meta") -> Any:
    """The serving caches of ``batch`` rows of ``max_len`` positions (an
    encoder–decoder's: its self caches and the cross K/V of ``_enc_len``
    frames)."""
    if cfg.family == "encdec":
        return ED.init_caches(cfg, batch, max_len, _enc_len(cfg, max_len),
                              dtype=dtype, enc_dtype=dtype, device=device)
    return LM.init_caches(cfg, batch, max_len, dtype, device=device)


def input_specs(arch_id: str, shape_name: str, dtype=torch.bfloat16,
                device="meta") -> dict:
    """Batch (and cache) stand-ins for one (arch × shape) cell: {"kind",
    "batch": {...}, "caches", "out_caches" (prefill), "pos" (decode)},
    matching the step the dry run plans (token ids int32, as the
    reference's)."""
    cfg = get_config(arch_id).full
    sh = SHAPES[shape_name]
    seq, batch, kind = sh["seq"], sh["batch"], sh["kind"]

    def empty(shape, dt=torch.int32):
        return torch.empty(shape, dtype=dt, device=device)

    if kind == "train":
        if cfg.family == "encdec":
            b = {"enc_embeds": empty((batch, seq, cfg.d_model), dtype),
                 "tokens": empty((batch, seq)),
                 "labels": empty((batch, seq))}
        elif cfg.family == "vlm":
            text = seq - cfg.n_patches
            b = {"tokens": empty((batch, text)),
                 "embeds": empty((batch, cfg.n_patches, cfg.d_model),
                                 dtype),
                 "labels": empty((batch, text))}
        else:
            b = {"tokens": empty((batch, seq)),
                 "labels": empty((batch, seq))}
        return {"kind": "train", "batch": b}

    caches = cache_specs_for(cfg, batch, seq, dtype, device)
    if kind == "prefill":
        out_caches = caches
        if cfg.family == "encdec":
            b = {"enc_embeds": empty((batch, seq, cfg.d_model), dtype),
                 "tokens": empty((batch, 1))}
            caches = {"self": caches["self"]}  # cross K/V made by prefill
        elif cfg.family == "vlm":
            b = {"tokens": empty((batch, seq - cfg.n_patches)),
                 "embeds": empty((batch, cfg.n_patches, cfg.d_model),
                                 dtype)}
        else:
            b = {"tokens": empty((batch, seq))}
        return {"kind": "prefill", "batch": b, "caches": caches,
                "out_caches": out_caches}

    # decode: one new token against a seq-length cache
    return {"kind": "decode", "batch": {"tokens": empty((batch, 1))},
            "caches": caches, "pos": empty(())}
