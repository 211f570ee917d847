"""Compressed weight containers — how the port's models carry weights.

Counterpart of ``repro/core/compressed.py`` (``QuantLinear``,
``PackedLinear``, ``TiledPackedLinear``, ``encode_tiled_planes``,
``pad_literals``, ``quantize_linear``, ``pack_linear_tiled``,
``pack_expert_stack``, and the dry run's planners ``planned_packed_specs``,
``planned_tiled_specs``, ``planned_quant_specs`` and ``lut_spec``, which
hold shapes and dtypes, never numbers).  A linear weight is dense (a tensor), a
:class:`QuantLinear` (mode 'quant'), a :class:`PackedLinear` (mode
'compressed') or, under ``CompressionPolicy(tiles=G)``, a
:class:`TiledPackedLinear` (G column groups, each encoded on its own);
the decode LUT is shared by the whole model and passed beside the params.
A stacked weight (an MoE layer's experts) carries a leading expert axis on
every plane.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional

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
    # a mesh rank's vocab-row band of an embedding or head
    # (``sharding.partition.place_vocab``): None, or the axes its rows
    # were split over
    mesh_axes: Optional[tuple] = None

    def materialize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return ((self.values.to(torch.float32) - self.zero) * self.scale
                ).to(dtype)

    def to(self, device) -> "QuantLinear":
        return QuantLinear(self.values.to(device), self.scale.to(device),
                           self.zero.to(device), self.mesh_axes)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.values, self.scale, self.zero))


@dataclasses.dataclass
class _PackedPlanes:
    """What :class:`PackedLinear` and :class:`TiledPackedLinear` share: the
    blocked-compressed planes, the quantizer's affine and the tile layout
    (``tile_n > 0``: blocks laid out tile-major per (tile_n, tile_k) weight
    tile, the layout the fused kernels read; 0 = linear layout).  Each
    subclass decodes its planes to uint8 in ``materialize_int8``.
    ``GROUP_AXES``: the planes' column-group axes (0 or 1) between any
    stacking dims and (nb, slots); ``PROBE``: the prefix of its
    ``kernels.ops.DISPATCH_COUNTS`` probes."""

    codes: torch.Tensor
    literals: torch.Tensor
    nlit: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    shape: tuple
    tile_n: int = 0
    tile_k: int = 0
    # a mesh rank's share (``sharding.partition.place_params``): None, or
    # the mesh axes the planes were split over (see ``place_params``); the
    # planes and ``shape`` are then the rank's
    mesh_axes: Optional[tuple] = None
    # the reference's flag: the consumer contracts the model-sharded dim
    # (wo / w_down, ``sharding.partition.is_row_parallel``).  The planner
    # sets it as the reference's specs do; no kernel path reads it.
    row_parallel: bool = False

    GROUP_AXES: ClassVar[int] = 0
    PROBE: ClassVar[str] = ""

    @property
    def payload_nbytes(self) -> int:
        return int(self.codes.numel() * 2 + self.literals.numel()
                   + self.nlit.numel() * 4)

    def to(self, device):
        return dataclasses.replace(
            self, codes=self.codes.to(device),
            literals=self.literals.to(device), nlit=self.nlit.to(device),
            scale=self.scale.to(device), zero=self.zero.to(device))

    def materialize(self, lut: torch.Tensor, dtype=torch.bfloat16, *,
                    plain: bool = False) -> torch.Tensor:
        """Decode + dequantize to the dense weight (any leading dims);
        ``plain`` as in :meth:`materialize_int8`."""
        w = self.materialize_int8(lut, plain=plain).to(torch.float32)
        return ((w - self.zero) * self.scale).to(dtype)


@dataclasses.dataclass
class PackedLinear(_PackedPlanes):
    """Blocked-compressed uint8 weight + quantizer params (mode='compressed').

      codes    int16 (uint16 bits) [..., nb, slots]
      literals uint8 [..., nb, cap, S]
      nlit     int32 [..., nb]
      scale    f32   [..., out, 1]
      zero     f32   [..., out, 1]

    Leading dims stack weights of one ``shape`` (an MoE layer's experts:
    [E, ...]) with one literal capacity.
    """

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


@dataclasses.dataclass
class TiledPackedLinear(_PackedPlanes):
    """A compressed weight stored as ``tiles`` column groups: the dense
    (out, in) weight is split into G = ``tiles`` sub-weights of (out,
    in/G), and group g (x columns [g·in/G, (g+1)·in/G)) is encoded on its
    own, in the tile-major layout when ``tile_n > 0`` (the fused kernel's,
    chosen on the (out, in/G) sub-weight) or the linear one.  K1 reads all
    G groups in one launch (``kernels.ops.decode_dequant_matmul``).

      codes    int16 (uint16 bits) [..., G, nb, slots]
      literals uint8 [..., G, nb, cap, S]   one capacity for every group
      nlit     int32 [..., G, nb]
      scale    f32   [..., out, 1]
      zero     f32   [..., out, 1]

    The reference names the planes ``codes_t``, ``literals_t`` and
    ``nlit_t`` (``PLANE_KEYS``), and so does the integrity manifest."""

    GROUP_AXES: ClassVar[int] = 1
    PROBE: ClassVar[str] = "tiled_"
    PLANE_KEYS: ClassVar[dict] = {"codes": "codes_t",
                                  "literals": "literals_t",
                                  "nlit": "nlit_t"}

    @property
    def tiles(self) -> int:
        return self.codes.shape[-3]

    def materialize_int8(self, lut: torch.Tensor, *,
                         plain: bool = False) -> torch.Tensor:
        """Decode every group to the dense uint8 (..., out, in) weight:
        the planes flatten to (-1, slots) (K4 on CUDA planes, the plain
        decode on CPU planes or with ``plain``), each group's (out, in/G)
        sub-weight is untiled, and the group axis moves next to in/G."""
        out, k = self.shape
        tiles, nb, slots = self.codes.shape[-3:]
        lead = tuple(self.codes.shape[:-3])
        cap, s = self.literals.shape[-2:]
        k_t = k // tiles
        decode = dict_decode_plain if plain else dict_decode
        flat = decode(self.codes.reshape(-1, slots),
                      self.literals.reshape(-1, cap, s), lut)
        flat = flat.reshape(-1, tiles, nb * slots * s)[..., : out * k_t]
        if self.tile_n:
            flat = bcdc.untile_flat(flat, (out, k_t), self.tile_n,
                                    self.tile_k)
        w = flat.reshape(lead + (tiles, out, k_t)).movedim(-3, -2)
        return w.reshape(lead + (out, k))


def encode_tiled_planes(vals: torch.Tensor, table, tiles: int,
                        block_weights: int = bcdc.DEFAULT_BLOCK_WEIGHTS,
                        tile=None, shards: tuple = (1, 1)):
    """Encode a quantized (out, in) uint8 weight as ``tiles`` column
    groups.  → ``(bcs, tile_n, tile_k)``: one BlockedCompressed per group,
    literal capacities not yet unified.  ``tile=(tn, tk)`` or ``"auto"``
    (:func:`blocked_codec.choose_fused_tiles` on the (out, in/tiles)
    sub-weight) selects the tile-major layout; ``None`` the linear one.
    The block size shrinks to the sub-weight's volume, rounded down to
    whole grams, as the reference's does.  ``table``: a {gram -> code}
    dict or a prepared ``TableIndex``.  ``shards=(model_shards, 1)``: the
    auto choice divides the per-model-shard out dim
    (:func:`blocked_codec.choose_fused_tiles`)."""
    out, k = vals.shape
    if k % tiles:
        raise ValueError(f"{tiles} column groups do not divide {vals.shape}")
    k_t = k // tiles
    if tile == "auto":
        picked = bcdc.choose_fused_tiles((out, k_t), block_weights,
                                         shards=shards)
        tile = picked[:2] if picked else None
    s = bcdc.DEFAULT_SEQ_LEN
    bw = min(block_weights, (out * k_t // s) * s) or s
    index = bcdc._as_index(table, s, vals.device)
    bcs = []
    for t in range(tiles):
        sub = vals[:, t * k_t:(t + 1) * k_t].contiguous()
        if tile is not None:
            bcs.append(bcdc.encode_blocked_tiled(
                sub, index, tile_n=tile[0], tile_k=tile[1],
                block_weights=bw))
        else:
            bcs.append(bcdc.encode_blocked(sub, index, block_weights=bw))
    tn, tk = tile if tile is not None else (0, 0)
    return bcs, tn, tk


def stack_tiled(qls: list, per: list, *, shape, tile_n: int, tile_k: int,
                cap: int | None = None) -> TiledPackedLinear:
    """One stacked TiledPackedLinear from per-weight quantizers and their
    groups' encodings (``per[i]``: weight i's list of BlockedCompressed),
    with one literal capacity ``cap`` (default: the largest)."""
    if cap is None:
        cap = max(bc.literals.shape[1] for bcs in per for bc in bcs)

    def plane(f):
        return torch.stack([torch.stack([f(bc) for bc in bcs])
                            for bcs in per])

    return TiledPackedLinear(
        codes=plane(lambda bc: bc.codes),
        literals=plane(lambda bc: pad_literals(bc.literals, cap)),
        nlit=plane(lambda bc: bc.nlit),
        scale=torch.stack([q.scale for q in qls]),
        zero=torch.stack([q.zero for q in qls]),
        shape=tuple(shape), tile_n=tile_n, tile_k=tile_k)


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


def pack_linear_tiled(w: torch.Tensor, table, tiles: int,
                      qcfg: QuantConfig | None = None,
                      block_weights: int = bcdc.DEFAULT_BLOCK_WEIGHTS,
                      lit_cap: int | None = None,
                      tile=None, shards: tuple = (1, 1)
                      ) -> TiledPackedLinear:
    """Quantize one (out, in) weight and encode it as ``tiles`` column
    groups (:func:`encode_tiled_planes`; ``tile=None`` keeps the linear
    layout, ``"auto"`` picks the tile-major one), on the weight's device.
    ``lit_cap`` forces the literal capacity (default: the groups'
    largest)."""
    ql = quantize_linear(w, qcfg)
    bcs, tn, tk = encode_tiled_planes(ql.values, table, tiles,
                                      block_weights=block_weights, tile=tile,
                                      shards=shards)
    t = stack_tiled([ql], [bcs], shape=tuple(w.shape), tile_n=tn, tile_k=tk,
                    cap=lit_cap)
    return dataclasses.replace(t, codes=t.codes[0], literals=t.literals[0],
                               nlit=t.nlit[0], scale=t.scale[0],
                               zero=t.zero[0])


# ---------------------------------------------------------------------------
# Dry-run shape planning: containers of empty tensors (``meta``, or fake
# tensors under a ``FakeTensorMode``) of the shapes and dtypes packing
# gives, without data.
# ---------------------------------------------------------------------------

def _empty(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def planned_packed_specs(shape: tuple, *, stacked: tuple = (),
                         block_weights: int = bcdc.DEFAULT_BLOCK_WEIGHTS,
                         seq_len: int = bcdc.DEFAULT_SEQ_LEN,
                         lit_cap_frac: float = 0.25, tile_n: int = 0,
                         tile_k: int = 0, device="meta") -> PackedLinear:
    """A :class:`PackedLinear` of empty planes for a dense ``shape`` (the
    reference's ``planned_packed_specs``).  ``lit_cap_frac``: the planned
    escape rate, the literal capacity a share of the slots (packing sizes
    it from the data).  ``tile_n/tile_k``: the tile-major layout (the block
    size shrunk to divide the tile's volume); 0 the linear one."""
    n = math.prod(shape)
    if tile_n:
        bw = bcdc._shrink_block_weights(tile_n * tile_k, block_weights,
                                        seq_len)
        nb = n // bw
    else:
        bw = block_weights
        nb = -(-n // bw)
    slots = bw // seq_len
    cap = max(1, int(slots * lit_cap_frac))
    out = shape[0]
    return PackedLinear(
        codes=_empty(stacked + (nb, slots), torch.int16, device),
        literals=_empty(stacked + (nb, cap, seq_len), torch.uint8, device),
        nlit=_empty(stacked + (nb,), torch.int32, device),
        scale=_empty(stacked + (out, 1), torch.float32, device),
        zero=_empty(stacked + (out, 1), torch.float32, device),
        shape=tuple(shape), tile_n=tile_n, tile_k=tile_k)


def planned_tiled_specs(shape: tuple, tiles: int, *, stacked: tuple = (),
                        block_weights: int = bcdc.DEFAULT_BLOCK_WEIGHTS,
                        seq_len: int = bcdc.DEFAULT_SEQ_LEN,
                        lit_cap_frac: float = 0.25, tile_n: int = 0,
                        tile_k: int = 0, device="meta"
                        ) -> TiledPackedLinear:
    """A :class:`TiledPackedLinear` of empty planes: ``tiles`` column
    groups of (out, in/tiles), the block size first shrunk to the
    sub-weight's volume in whole grams (as :func:`encode_tiled_planes`),
    then to divide the tile's (the reference's ``planned_tiled_specs``)."""
    out, in_full = shape
    n = out * (in_full // tiles)
    bw = min(block_weights, (n // seq_len) * seq_len) or seq_len
    if tile_n:
        bw = bcdc._shrink_block_weights(tile_n * tile_k, bw, seq_len)
        nb = n // bw
    else:
        nb = -(-n // bw)
    slots = bw // seq_len
    cap = max(1, int(slots * lit_cap_frac))
    return TiledPackedLinear(
        codes=_empty(stacked + (tiles, nb, slots), torch.int16, device),
        literals=_empty(stacked + (tiles, nb, cap, seq_len), torch.uint8,
                        device),
        nlit=_empty(stacked + (tiles, nb), torch.int32, device),
        scale=_empty(stacked + (out, 1), torch.float32, device),
        zero=_empty(stacked + (out, 1), torch.float32, device),
        shape=tuple(shape), tile_n=tile_n, tile_k=tile_k)


def planned_quant_specs(shape: tuple, *, stacked: tuple = (),
                        device="meta") -> QuantLinear:
    """A :class:`QuantLinear` of empty planes for a dense ``shape``."""
    return QuantLinear(
        values=_empty(stacked + tuple(shape), torch.uint8, device),
        scale=_empty(stacked + (shape[0], 1), torch.float32, device),
        zero=_empty(stacked + (shape[0], 1), torch.float32, device))


def lut_spec(n_codes: int = 65536, seq_len: int = bcdc.DEFAULT_SEQ_LEN,
             device="meta") -> torch.Tensor:
    """The model-wide decode LUT's empty stand-in: (n_codes, seq_len)
    uint8."""
    return _empty((n_codes, seq_len), torch.uint8, device)
