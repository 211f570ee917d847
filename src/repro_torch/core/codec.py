"""The paper's model-wide gram dictionary (Listing 2), vectorised in torch,
and its escape-stream format (Listings 3–4) on the host.

Counterpart of ``repro/core/codec.py::find_frequent_sequences``.  The
reference counts grams with ``np.unique(axis=0)`` and a Python ``Counter``
loop over every unique row, which takes minutes at Llama-3.2-1B's 50 M-gram
sample cap.  Here each gram becomes one big-endian integer key
(``b0<<24 | b1<<16 | b2<<8 | b3``), whose numeric order is the
lexicographic row order ``np.unique`` returns, so the whole count is a few
``torch.unique``/``sort`` calls on the weights' own device.

The returned table is the reference's, code assignment included:
``Counter.most_common`` breaks count ties by first insertion, and the
reference inserts stream by stream, each stream in ascending key order.
So the order here is (count descending, first stream ascending, key
ascending).

The stream side (``compress_array`` … ``compression_ratio``, the
reference's ``codec.py:58-189``) is host numpy, as the reference's is:
a stream of uint16, a value < ESCAPE a codeword for a gram, ESCAPE
followed by the gram's raw bytes one a uint16, and a trailing ESCAPE +
the remainder.  Streams are byte-equal to the reference's; both
directions are vectorised (a literal is < 256, so every ESCAPE in a
stream is a marker and the parse needs no serial walk).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

ESCAPE = 0xFFFF
DEFAULT_SEQ_LEN = 4
MAX_TABLE = ESCAPE  # codewords 0..0xFFFE


def gram_keys(flat: torch.Tensor, seq_len: int = DEFAULT_SEQ_LEN
              ) -> torch.Tensor:
    """(n·S,) uint8 -> (n,) int64 big-endian gram keys (S ≤ 7)."""
    if seq_len > 7:
        raise ValueError(f"gram keys hold at most 7 bytes, got {seq_len}")
    grams = flat.reshape(-1, seq_len).to(torch.int64)
    key = grams[:, 0].clone()
    for j in range(1, seq_len):
        key = (key << 8) | grams[:, j]
    return key


def keys_to_grams(keys: torch.Tensor, seq_len: int = DEFAULT_SEQ_LEN
                  ) -> torch.Tensor:
    """Inverse of :func:`gram_keys`: (n,) int64 -> (n, S) uint8."""
    shifts = torch.arange(seq_len - 1, -1, -1, device=keys.device) * 8
    return ((keys[:, None] >> shifts) & 0xFF).to(torch.uint8)


def frequent_keys(weights_list: list[torch.Tensor],
                  sequence_length: int = DEFAULT_SEQ_LEN,
                  max_codes: int = MAX_TABLE, min_count: int = 2,
                  sample_cap: int | None = 50_000_000) -> torch.Tensor:
    """Gram keys of the table in code order: ``keys[code]``."""
    uniq, cnts, first = [], [], []
    budget = sample_cap if sample_cap is not None else float("inf")
    device = weights_list[0].device if weights_list else "cpu"
    for si, w in enumerate(weights_list):
        flat = w.reshape(-1).to(torch.uint8)
        n = (flat.numel() // sequence_length) * sequence_length
        if n == 0:
            continue
        ngrams = n // sequence_length
        if ngrams > budget:
            ngrams = int(budget)
        budget -= ngrams
        keys = gram_keys(flat[: ngrams * sequence_length], sequence_length)
        u, c = torch.unique(keys, sorted=True, return_counts=True)
        uniq.append(u)
        cnts.append(c)
        first.append(torch.full_like(u, si))
        if budget <= 0:
            break
    if not uniq:
        return torch.zeros(0, dtype=torch.int64, device=device)
    keys, inv = torch.unique(torch.cat(uniq), sorted=True,
                             return_inverse=True)
    count = torch.zeros_like(keys).index_add_(0, inv, torch.cat(cnts))
    stream = torch.full_like(keys, len(weights_list)).scatter_reduce_(
        0, inv, torch.cat(first), reduce="amin")
    keep = count >= min_count
    keys, count, stream = keys[keep], count[keep], stream[keep]
    # keys ascend already; two stable sorts give (−count, stream, key)
    order = torch.sort(stream, stable=True).indices
    keys, count = keys[order], count[order]
    order = torch.sort(-count, stable=True).indices
    return keys[order][:max_codes]


def find_frequent_sequences(weights_list: list[torch.Tensor],
                            sequence_length: int = DEFAULT_SEQ_LEN,
                            max_codes: int = MAX_TABLE,
                            min_count: int = 2,
                            sample_cap: int | None = 50_000_000) -> dict:
    """Paper Listing 2: {tuple(gram) -> codeword}, codewords dense in
    [0, n_codes) — the same dict as the reference builds."""
    keys = frequent_keys(weights_list, sequence_length, max_codes,
                         min_count, sample_cap)
    grams = keys_to_grams(keys, sequence_length).cpu().tolist()
    return {tuple(g): i for i, g in enumerate(grams)}


def table_keys(table: dict, seq_len: int = DEFAULT_SEQ_LEN,
               device="cpu") -> torch.Tensor:
    """{gram -> code} table -> ``keys[code]`` (int64)."""
    keys = [0] * len(table)
    for seq, code in table.items():
        k = 0
        for v in seq:
            k = (k << 8) | int(v)
        keys[code] = k
    return torch.tensor(keys, dtype=torch.int64, device=device)


def _host_u8(a) -> np.ndarray:
    """A tensor or array, flat, as host uint8."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a).reshape(-1).astype(np.uint8)


def compress_array(weights, table: dict,
                   sequence_length: int = DEFAULT_SEQ_LEN) -> np.ndarray:
    """Paper Listing 3: the uint16 escape stream of a uint8 array (a
    tensor or an array), gram by gram: its codeword, or ESCAPE and its S
    bytes; the remainder of a length not divisible by S as ESCAPE and its
    bytes."""
    flat = _host_u8(weights)
    s = sequence_length
    n_full = len(flat) // s
    head = flat[:n_full * s].reshape(-1, s)
    tail = flat[n_full * s:]
    if table and n_full:
        keys = np.asarray(table_keys(table, s).numpy(), np.int64)
        gk = np.zeros(n_full, np.int64)
        for j in range(s):
            gk = (gk << 8) | head[:, j].astype(np.int64)
        order = np.argsort(keys)
        pos = np.clip(np.searchsorted(keys[order], gk), 0, len(keys) - 1)
        hit = keys[order][pos] == gk
        code = order[pos]
    else:
        hit = np.zeros(n_full, bool)
        code = np.zeros(n_full, np.int64)
    rows = np.empty((n_full, s + 1), np.uint16)
    rows[:, 0] = np.where(hit, code, ESCAPE)
    rows[:, 1:] = head
    width = np.where(hit, 1, s + 1)
    keep = np.arange(s + 1)[None, :] < width[:, None]
    out = rows[keep]
    if tail.size:
        out = np.concatenate([out, [ESCAPE], tail.astype(np.uint16)])
    return np.ascontiguousarray(out, dtype=np.uint16)


def decompress_array(stream, table: dict, orig_len: int,
                     sequence_length: int = DEFAULT_SEQ_LEN) -> np.ndarray:
    """Paper Listing 4: the uint8 array of ``orig_len`` bytes back from
    its stream.  A codeword not in ``table`` raises ``KeyError``, as the
    reference's lookup does."""
    st = np.asarray(stream).astype(np.int64).reshape(-1)
    s, n = sequence_length, len(st)
    esc = np.nonzero(st == ESCAPE)[0]
    lit = np.zeros(n, bool)
    for j in range(1, s + 1):
        lit[esc[esc + j < n] + j] = True
    is_code = (st != ESCAPE) & ~lit
    codes = st[is_code]
    n_codes = len(table)
    bad = codes[(codes < 0) | (codes >= n_codes)]
    if bad.size:
        raise KeyError(int(bad[0]))
    lut = keys_to_grams(table_keys(table, s), s).numpy() if n_codes \
        else np.zeros((0, s), np.uint8)
    rows = np.zeros((n, s), np.uint8)
    rows[is_code] = lut[codes]
    rows[lit, 0] = st[lit]
    width = np.where(is_code, s, np.where(lit, 1, 0))
    out = rows[np.arange(s)[None, :] < width[:, None]]
    return np.ascontiguousarray(out[:orig_len])


@dataclasses.dataclass
class CompressedStream:
    """One tensor compressed in the paper's stream format."""

    stream: np.ndarray        # uint16
    orig_len: int
    shape: tuple
    sequence_length: int = DEFAULT_SEQ_LEN

    @property
    def nbytes(self) -> int:
        return int(self.stream.nbytes)


def compress_model_arrays(arrays: dict, sequence_length: int = DEFAULT_SEQ_LEN,
                          table: dict | None = None,
                          max_codes: int = MAX_TABLE):
    """The paper's ``compress_model`` over a {name: uint8 array or tensor}
    dict, one table for the whole model → (table, {name:
    CompressedStream})."""
    if table is None:
        table = find_frequent_sequences(
            [torch.from_numpy(_host_u8(a)) for a in arrays.values()],
            sequence_length, max_codes)
    out = {}
    for name, arr in arrays.items():
        out[name] = CompressedStream(
            compress_array(arr, table, sequence_length),
            int(np.prod(tuple(arr.shape))), tuple(arr.shape),
            sequence_length)
    return table, out


def decompress_model_arrays(table: dict, streams: dict) -> dict:
    """{name: CompressedStream} → {name: uint8 array of its shape}."""
    return {name: decompress_array(cs.stream, table, cs.orig_len,
                                   cs.sequence_length).reshape(cs.shape)
            for name, cs in streams.items()}


def table_nbytes(table: dict, sequence_length: int = DEFAULT_SEQ_LEN) -> int:
    """Bytes to ship the decode LUT (counted against the compressed size,
    as the paper's on-disk format must include it)."""
    return len(table) * sequence_length


def compression_ratio(arrays: dict, streams: dict, table: dict,
                      original_bytes_per_weight: int = 2) -> dict:
    """Table-1-style accounting: original (fp16/bf16) bytes, quantized (1
    byte a weight), compressed (stream bytes + the LUT)."""
    n_weights = sum(int(np.prod(tuple(a.shape))) for a in arrays.values())
    original = n_weights * original_bytes_per_weight
    compressed = sum(s.nbytes for s in streams.values()) + table_nbytes(table)
    return {
        "n_weights": int(n_weights),
        "original_bytes": int(original),
        "quantized_bytes": int(n_weights),
        "compressed_bytes": int(compressed),
        "ratio_vs_original": original / max(compressed, 1),
        "ratio_vs_quantized": n_weights / max(compressed, 1),
    }
