"""The paper's model-wide gram dictionary (Listing 2), vectorised in torch.

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
"""
from __future__ import annotations

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
