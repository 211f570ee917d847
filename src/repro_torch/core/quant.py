"""8-bit per-channel quantizer — the paper's §3 ``Quantizer`` (Listing 1).

Counterpart of ``repro/core/quant.py`` (``find_params``/``quantize``,
per-channel granularity).  Everything is f32 on the weight's own device;
``torch.round`` rounds half to even, as ``jnp.round`` does, so the integer
payload is byte-equal to the reference's.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantization configuration: asymmetric, per output channel
    (rows of an (out, in) weight), the reference's serving default and the
    only one this port serves."""

    bits: float = 8
    granularity: str = "per_channel"

    @property
    def maxq(self) -> int:
        return int(2 ** int(self.bits) - 1)


def _check(cfg: QuantConfig):
    if cfg.granularity != "per_channel" or cfg.bits > 8 \
            or cfg.bits != int(cfg.bits):
        raise NotImplementedError(
            f"only integer ≤8-bit per-channel quantization is ported, got "
            f"{cfg}")


def find_params(rows: torch.Tensor, cfg: QuantConfig):
    """scale = (max − min)/maxq, zero = round(−min/scale) per row of a
    (channels, -1) f32 view; returns (scale, zero) as (channels, 1)."""
    _check(cfg)
    xmin = torch.clamp(rows.amin(dim=1), max=0.0)
    xmax = torch.clamp(rows.amax(dim=1), min=0.0)
    scale = (xmax - xmin) / cfg.maxq
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    zero = torch.round(-xmin / scale)
    return scale[:, None], zero[:, None]


def quantize(x: torch.Tensor, cfg: QuantConfig):
    """-> (values uint8 (channels, -1), scale f32 (channels, 1), zero)."""
    rows = x.to(torch.float32).reshape(x.shape[0], -1)
    scale, zero = find_params(rows, cfg)
    q = torch.clamp(torch.round(rows / scale) + zero, 0, cfg.maxq)
    return q.to(torch.uint8), scale, zero
