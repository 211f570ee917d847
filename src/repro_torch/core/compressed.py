"""Compressed weight containers — how the port's models carry weights.

Counterpart of ``repro/core/compressed.py`` (``QuantLinear``,
``PackedLinear``, ``pad_literals``, ``quantize_linear``,
``pack_expert_stack``).  A linear weight is dense (a tensor), a
:class:`QuantLinear` (mode 'quant') or a :class:`PackedLinear` (mode
'compressed'); the decode LUT is shared by the whole model and passed
beside the params.  A stacked weight (an MoE layer's experts) carries a
leading expert axis on every plane.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.dict_decode import dict_decode, dict_decode_plain
from . import blocked_codec as bcdc
from .codec import find_frequent_sequences
from .quant import QuantConfig, quantize


@dataclasses.dataclass
class QuantLinear:
    """uint8 weight + per-channel affine params (mode='quant'), with any
    leading (stacked expert) dims."""

    values: torch.Tensor   # uint8 [..., out, in]
    scale: torch.Tensor    # f32 [..., out, 1]
    zero: torch.Tensor     # f32 [..., out, 1]

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

      codes    int16 (uint16 bits) [..., nb, slots]
      literals uint8 [..., nb, cap, S]
      nlit     int32 [..., nb]
      scale    f32   [..., out, 1]
      zero     f32   [..., out, 1]

    Leading dims stack weights of one ``shape`` (an MoE layer's experts:
    [E, ...]) with one literal capacity.  ``tile_n > 0``: blocks are laid
    out tile-major per (tile_n, tile_k) weight tile, the layout the fused
    kernels read; 0 = linear layout.
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

    def materialize_int8(self, lut: torch.Tensor, *,
                         plain: bool = False) -> torch.Tensor:
        """Decode to the dense uint8 (..., out, in) weight, for any leading
        dims: blocks decode on their own, so the planes flatten to
        (-1, slots).  On CUDA planes the dict-decode kernel runs, on CPU
        planes its plain version; ``plain`` takes the plain version on any
        device (the ``materialize`` rung, which runs no port kernel)."""
        n, k = self.shape
        lead = tuple(self.codes.shape[:-2])
        slots = self.codes.shape[-1]
        cap, s = self.literals.shape[-2:]
        decode = dict_decode_plain if plain else dict_decode
        flat = decode(self.codes.reshape(-1, slots),
                      self.literals.reshape(-1, cap, s), lut)
        per = self.codes.shape[-2] * slots * s
        flat = flat.reshape(-1, per)[:, : n * k]
        if self.tile_n:
            w = bcdc.untile_flat(flat, (n, k), self.tile_n, self.tile_k)
        else:
            w = flat.reshape(-1, n, k)
        return w.reshape(lead + (n, k))

    def materialize(self, lut: torch.Tensor, dtype=torch.bfloat16, *,
                    plain: bool = False) -> torch.Tensor:
        """Decode + dequantize to the dense weight (any leading dims);
        ``plain`` as in :meth:`materialize_int8`."""
        w = self.materialize_int8(lut, plain=plain).to(torch.float32)
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


def stack_packed(qls: list, bcs: list, *, shape, tile_n: int, tile_k: int,
                 cap: int | None = None) -> PackedLinear:
    """One stacked PackedLinear from per-weight quantizers and encodings,
    with one literal capacity ``cap`` (default: the stack's largest)."""
    if cap is None:
        cap = max(bc.literals.shape[1] for bc in bcs)
    return PackedLinear(
        codes=torch.stack([bc.codes for bc in bcs]),
        literals=torch.stack([pad_literals(bc.literals, cap) for bc in bcs]),
        nlit=torch.stack([bc.nlit for bc in bcs]),
        scale=torch.stack([q.scale for q in qls]),
        zero=torch.stack([q.zero for q in qls]),
        shape=tuple(shape), tile_n=tile_n, tile_k=tile_k)


def pack_expert_stack(ws, table: dict | None = None,
                      block_weights: int = bcdc.DEFAULT_BLOCK_WEIGHTS,
                      tile="auto"):
    """Quantize + blocked-compress same-shape expert weights into one
    stacked PackedLinear (leading expert axis, one shared dictionary, one
    literal capacity; tile-major by default), on the weights' device — what
    ``serve.engine.build_serve_params`` emits for an ``experts/w_*`` leaf.
    Returns ``(packed, lut)``.  ``tile=None`` keeps the linear layout."""
    n, k = ws[0].shape
    device = ws[0].device
    qls = [quantize_linear(w) for w in ws]
    if table is None:
        table = find_frequent_sequences([q.values for q in qls])
    lut = bcdc.build_lut(table, device=device)
    index = bcdc.TableIndex(table, device=device)
    if tile == "auto":
        picked = bcdc.choose_fused_tiles((n, k), block_weights)
        tile = picked[:2] if picked else None
    if tile is not None:
        tn, tk = tile
        bcs = [bcdc.encode_blocked_tiled(q.values, index, tile_n=tn,
                                         tile_k=tk,
                                         block_weights=block_weights)
               for q in qls]
    else:
        tn, tk = 0, 0
        bcs = [bcdc.encode_blocked(q.values, index,
                                   block_weights=block_weights)
               for q in qls]
    return stack_packed(qls, bcs, shape=(n, k), tile_n=tn, tile_k=tk), lut
