"""LZW baseline — the dictionary-compression family the paper cites (§2.2).

Counterpart of ``repro/core/lzw.py`` (host-side numpy, the same code
stream): classic LZW over uint8 arrays with 16-bit codes, the dictionary
frozen when full.  The paper's own format is a static-dictionary variant
(``core/codec.py``); this is the baseline its compression table sets
beside it.
"""
from __future__ import annotations

import numpy as np

MAX_CODE = 0xFFFF  # 16-bit codes


def lzw_encode(data) -> np.ndarray:
    """Classic LZW over bytes → uint16 code stream."""
    flat = np.ascontiguousarray(data).reshape(-1).astype(np.uint8).tobytes()
    table: dict[bytes, int] = {bytes([i]): i for i in range(256)}
    next_code = 256
    out: list[int] = []
    w = b""
    for ch in flat:
        c = bytes([ch])
        wc = w + c
        if wc in table:
            w = wc
        else:
            out.append(table[w])
            if next_code <= MAX_CODE:
                table[wc] = next_code
                next_code += 1
            w = c
    if w:
        out.append(table[w])
    return np.asarray(out, dtype=np.uint16)


def lzw_decode(codes: np.ndarray, orig_len: int) -> np.ndarray:
    """Inverse of :func:`lzw_encode`."""
    table: dict[int, bytes] = {i: bytes([i]) for i in range(256)}
    next_code = 256
    stream = np.asarray(codes).tolist()
    if not stream:
        return np.zeros(0, np.uint8)
    w = table[stream[0]]
    out = bytearray(w)
    for code in stream[1:]:
        if code in table:
            entry = table[code]
        elif code == next_code:  # the KwKwK case
            entry = w + w[:1]
        else:
            raise ValueError(f"bad LZW code {code}")
        out.extend(entry)
        if next_code <= MAX_CODE:
            table[next_code] = w + entry[:1]
            next_code += 1
        w = entry
    return np.frombuffer(bytes(out[:orig_len]), dtype=np.uint8).copy()


def lzw_ratio(data) -> float:
    """bytes in / bytes out of the 16-bit LZW stream."""
    data = np.asarray(data)
    return data.size / max(lzw_encode(data).nbytes, 1)
