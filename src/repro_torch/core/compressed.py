"""Compressed weight containers — how the port's models carry weights.

Counterpart of ``repro/core/compressed.py`` (``QuantLinear``,
``PackedLinear``, ``pad_literals``, ``quantize_linear``).  A linear weight
is dense (a tensor), a :class:`QuantLinear` (mode 'quant') or a
:class:`PackedLinear` (mode 'compressed'); the decode LUT is shared by the
whole model and passed beside the params.
"""
from __future__ import annotations

import dataclasses

import torch

from . import blocked_codec as bcdc
from .quant import QuantConfig, quantize


@dataclasses.dataclass
class QuantLinear:
    """uint8 weight + per-channel affine params (mode='quant')."""

    values: torch.Tensor   # uint8 [out, in]
    scale: torch.Tensor    # f32 [out, 1]
    zero: torch.Tensor     # f32 [out, 1]

    def materialize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return ((self.values.to(torch.float32) - self.zero) * self.scale
                ).to(dtype)

    def to(self, device) -> "QuantLinear":
        return QuantLinear(self.values.to(device), self.scale.to(device),
                           self.zero.to(device))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.values, self.scale, self.zero))


@dataclasses.dataclass
class PackedLinear:
    """Blocked-compressed uint8 weight + quantizer params (mode='compressed').

      codes    int16 (uint16 bits) [nb, slots]
      literals uint8 [nb, cap, S]
      nlit     int32 [nb]
      scale    f32   [out, 1]
      zero     f32   [out, 1]

    ``tile_n > 0``: blocks are laid out tile-major per (tile_n, tile_k)
    weight tile, the layout the fused kernel reads; 0 = linear layout.
    """

    codes: torch.Tensor
    literals: torch.Tensor
    nlit: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    shape: tuple
    tile_n: int = 0
    tile_k: int = 0

    @property
    def payload_nbytes(self) -> int:
        return int(self.codes.numel() * 2 + self.literals.numel()
                   + self.nlit.numel() * 4)

    def to(self, device) -> "PackedLinear":
        return dataclasses.replace(
            self, codes=self.codes.to(device),
            literals=self.literals.to(device), nlit=self.nlit.to(device),
            scale=self.scale.to(device), zero=self.zero.to(device))

    def materialize_int8(self, lut: torch.Tensor) -> torch.Tensor:
        """Decode to the dense uint8 (out, in) weight.  For tests and
        yardsticks only: the serving path never calls it."""
        n, k = self.shape
        flat = bcdc.decode_blocked(self.codes, self.literals, lut
                                   ).reshape(-1)[: n * k]
        if self.tile_n:
            return bcdc.untile_flat(flat, (n, k), self.tile_n, self.tile_k)
        return flat.reshape(n, k)

    def materialize(self, lut: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
        w = self.materialize_int8(lut).to(torch.float32)
        return ((w - self.zero) * self.scale).to(dtype)


def pad_literals(literals: torch.Tensor, cap: int) -> torch.Tensor:
    """Pad a (..., cur_cap, S) literal plane up to a uniform capacity."""
    cur = literals.shape[-2]
    if cur > cap:
        raise ValueError(f"lit_cap {cap} < needed {cur}")
    if cur == cap:
        return literals
    pad = literals.new_zeros(literals.shape[:-2] + (cap - cur,
                                                    literals.shape[-1]))
    return torch.cat([literals, pad], dim=-2)


def quantize_linear(w: torch.Tensor,
                    qcfg: QuantConfig | None = None) -> QuantLinear:
    """Quantize an (out, in) weight to the QuantLinear container."""
    qcfg = qcfg or QuantConfig(bits=8, granularity="per_channel")
    values, scale, zero = quantize(w, qcfg)
    return QuantLinear(values=values.reshape(w.shape), scale=scale,
                       zero=zero)
