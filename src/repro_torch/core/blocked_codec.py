"""Blocked dictionary codec — the data-parallel layout the kernels decode.

Counterpart of ``repro/core/blocked_codec.py``.  Per tensor, blocks of
``block_weights`` uint8 weights:

  codes:    uint16[n_blocks, slots]      one len-S gram per slot; ESCAPE
                                         marks a literal
  literals: uint8 [n_blocks, lit_cap, S] the escaped grams, packed per block
  nlit:     int32 [n_blocks]             escapes in each block

A block decodes on its own: ``rank = cumsum(is_escape) − 1`` inside the
block gives each escape its literal row.  Codes are carried as int16 that
holds the uint16 bits (torch's uint16 has few ops); readers widen with
``& 0xFFFF``.

Encoding is vectorised (one ``searchsorted`` against the sorted table keys,
one scatter for the literals) and runs on the weights' own device; the
planes are byte-equal to the reference's loop-based encoder.
"""
from __future__ import annotations

import dataclasses

import torch

from .codec import DEFAULT_SEQ_LEN, ESCAPE, gram_keys, table_keys

DEFAULT_BLOCK_WEIGHTS = 4096
DEFAULT_TILE_N = 128
DEFAULT_TILE_K = 512


@dataclasses.dataclass
class BlockedCompressed:
    """One tensor in the blocked format."""

    codes: torch.Tensor      # int16 (uint16 bits) [n_blocks, slots]
    literals: torch.Tensor   # uint8 [n_blocks, lit_cap, S]
    nlit: torch.Tensor       # int32 [n_blocks]


def build_lut(table: dict, seq_len: int = DEFAULT_SEQ_LEN,
              device="cpu") -> torch.Tensor:
    """Dense decode LUT: row ``code`` holds its gram, plus one zero row so
    the table is never empty (codes are dense in [0, len(table)))."""
    lut = torch.zeros((max(len(table), 1) + 1, seq_len), dtype=torch.uint8)
    if table:
        rows = [None] * len(table)
        for seq, code in table.items():
            rows[code] = seq
        lut[: len(table)] = torch.tensor(rows, dtype=torch.uint8)
    return lut.to(device)


class TableIndex:
    """A table's gram keys sorted for ``searchsorted``, with their codes."""

    def __init__(self, table: dict, seq_len: int = DEFAULT_SEQ_LEN,
                 device="cpu"):
        keys = table_keys(table, seq_len, device)
        self.keys, order = torch.sort(keys)
        self.codes = order.to(torch.int32)

    def lookup(self, keys: torch.Tensor) -> torch.Tensor:
        """int64 gram keys -> int32 codes, ESCAPE where absent."""
        if self.keys.numel() == 0:
            return torch.full_like(keys, ESCAPE, dtype=torch.int32)
        idx = torch.searchsorted(self.keys, keys).clamp_(
            max=self.keys.numel() - 1)
        hit = self.keys[idx] == keys
        return torch.where(hit, self.codes[idx],
                           torch.full_like(idx, ESCAPE, dtype=torch.int32))


def _as_index(table, seq_len, device) -> TableIndex:
    if isinstance(table, TableIndex):
        return table
    return TableIndex(table, seq_len, device)


def encode_blocked(weights: torch.Tensor, table,
                   block_weights: int = DEFAULT_BLOCK_WEIGHTS,
                   seq_len: int = DEFAULT_SEQ_LEN) -> BlockedCompressed:
    """Encode a uint8 tensor into the blocked format.  ``table`` is a
    {gram -> code} dict or a prepared :class:`TableIndex`."""
    if block_weights % seq_len:
        raise ValueError(f"block_weights {block_weights} is not a multiple "
                         f"of seq_len {seq_len}")
    flat = weights.reshape(-1).to(torch.uint8)
    orig_len = flat.numel()
    slots = block_weights // seq_len
    pad = (-orig_len) % block_weights
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    n_blocks = flat.numel() // block_weights
    index = _as_index(table, seq_len, flat.device)
    codes = index.lookup(gram_keys(flat, seq_len)).reshape(n_blocks, slots)
    esc = codes == ESCAPE
    nlit = esc.sum(dim=1, dtype=torch.int32)
    lit_cap = max(int(nlit.max()) if n_blocks else 0, 1)
    literals = flat.new_zeros((n_blocks, lit_cap, seq_len))
    rank = torch.cumsum(esc, dim=1) - 1
    bi, si = torch.nonzero(esc, as_tuple=True)
    grams = flat.reshape(n_blocks, slots, seq_len)
    literals[bi, rank[bi, si]] = grams[bi, si]
    return BlockedCompressed(codes=codes.to(torch.int16), literals=literals,
                             nlit=nlit)


def decode_blocked(codes: torch.Tensor, literals: torch.Tensor,
                   lut: torch.Tensor) -> torch.Tensor:
    """(nb, slots) codes -> (nb, slots·S) uint8: LUT row gather for
    dictionary slots, in-block escape-rank gather for literal slots."""
    c = codes.to(torch.int32) & 0xFFFF
    is_esc = c == ESCAPE
    from_dict = lut[torch.where(is_esc, 0, c).long()]      # (nb, slots, S)
    rank = (torch.cumsum(is_esc, dim=1) - 1).clamp_(0, literals.shape[1] - 1)
    from_lit = torch.gather(
        literals, 1, rank[:, :, None].expand(-1, -1, literals.shape[2]))
    out = torch.where(is_esc[:, :, None], from_lit, from_dict)
    return out.reshape(codes.shape[0], codes.shape[1] * literals.shape[2])


# ---------------------------------------------------------------------------
# Tile-major layout for the fused decode→dequant→matmul kernel: tile (j, k)
# of the (N/tile_n, K/tile_k) grid is flattened contiguously, so its blocks
# are the row range [t·bpt, (t+1)·bpt) of the planes, t = j·n_kt + k.
# ---------------------------------------------------------------------------

def _pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two that divides ``n``, capped at ``cap``."""
    return min(n & (-n), cap)


def _shrink_block_weights(vol: int, block_weights: int, seq_len: int) -> int:
    """Halve a tile's volume toward the ``block_weights`` cap while it stays
    a whole number of grams — the fused layout's actual block size."""
    bw = vol
    while bw > block_weights and bw % 2 == 0 and (bw // 2) % seq_len == 0:
        bw //= 2
    return bw


def choose_fused_tiles(shape: tuple, block_weights: int = DEFAULT_BLOCK_WEIGHTS,
                       seq_len: int = DEFAULT_SEQ_LEN,
                       max_tile_n: int = DEFAULT_TILE_N,
                       max_tile_k: int = DEFAULT_TILE_K,
                       shards: tuple = (1, 1)):
    """(tile_n, tile_k, block_weights) for the fused layout, or None when
    the weight cannot hold a tile of whole grams.  Tiles are the largest
    power-of-two divisors of (N, K) up to the kernel's tile, so no padding
    is ever needed.

    ``shards=(sn, sk)``: the intended mesh split of the dense dims; tiles
    then divide the per-shard dims (N/sn, K/sk), so the sharded fused
    path splits the tile-major block axis in whole out-tile bands (a
    per-shard divisor also divides the whole dim).  A shard count that
    does not divide its dim is ignored."""
    n, k = int(shape[0]), int(shape[1])
    if n <= 0 or k <= 0:
        return None
    sn, sk = int(shards[0]) or 1, int(shards[1]) or 1
    if sn > 1 and n % sn == 0:
        n //= sn
    if sk > 1 and k % sk == 0:
        k //= sk
    tn = _pow2_divisor(n, max_tile_n)
    tk = _pow2_divisor(k, max_tile_k)
    vol = tn * tk
    if vol % seq_len:
        return None
    bw = _shrink_block_weights(vol, block_weights, seq_len)
    if vol % bw or bw % seq_len:
        return None
    return tn, tk, bw


def tile_stream(w2d: torch.Tensor, tile_n: int, tile_k: int) -> torch.Tensor:
    """Re-order an (N, K) array into the tile-major flat byte stream."""
    n, k = w2d.shape
    if n % tile_n or k % tile_k:
        raise ValueError(f"tiles {(tile_n, tile_k)} do not divide {w2d.shape}")
    return (w2d.reshape(n // tile_n, tile_n, k // tile_k, tile_k)
            .permute(0, 2, 1, 3).reshape(-1))


def untile_flat(flat: torch.Tensor, shape: tuple, tile_n: int,
                tile_k: int) -> torch.Tensor:
    """Inverse of :func:`tile_stream` for a (..., N·K) flat."""
    n, k = shape
    lead = tuple(flat.shape[:-1])
    t = flat.reshape(lead + (n // tile_n, k // tile_k, tile_n, tile_k))
    d = len(lead)
    return t.permute(*range(d), d, d + 2, d + 1, d + 3).reshape(lead + (n, k))


def encode_blocked_tiled(weights2d: torch.Tensor, table,
                         tile_n: int = DEFAULT_TILE_N,
                         tile_k: int = DEFAULT_TILE_K,
                         block_weights: int = DEFAULT_BLOCK_WEIGHTS,
                         seq_len: int = DEFAULT_SEQ_LEN) -> BlockedCompressed:
    """Encode an (N, K) uint8 tensor in the fused tile-major layout;
    ``block_weights`` is a cap, shrunk so a tile holds whole blocks."""
    vol = tile_n * tile_k
    bw = _shrink_block_weights(vol, block_weights, seq_len)
    if vol % bw or bw % seq_len:
        raise ValueError(f"tile {(tile_n, tile_k)} holds no whole block of "
                         f"{bw} weights")
    return encode_blocked(tile_stream(weights2d.to(torch.uint8), tile_n,
                                      tile_k),
                          table, block_weights=bw, seq_len=seq_len)
