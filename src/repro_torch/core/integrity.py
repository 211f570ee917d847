"""Artifact integrity — checksummed serve params and device-side invariants.

Counterpart of ``repro/core/integrity.py``.  Dictionary compression
amplifies faults: one flipped bit in a ``PackedLinear`` code plane
mis-indexes the LUT and silently corrupts a whole decoded tile.  A serving
host with flash-backed storage and no network must be able to prove that
the artifact it loaded is the one that was packed.  Two layers:

  * **Host-side manifest** (:func:`build_manifest`,
    :func:`verify_serve_state`): a CRC32 of every plane (codes, literals,
    nlit, scale, zero, dense leaves), of the model-wide LUT and of the
    dictionary table, recorded at pack time on ``ServeState.manifest``.
    ``level='full'`` re-hashes every byte; ``level='fast'`` hashes small
    planes whole and a strided byte sample of large ones (read off the
    device alone).  Corrupt planes are named, leaf by leaf.
  * **Device-side invariants** (:func:`check_invariants`): every code
    indexes the LUT or is ESCAPE, every nlit fits the literal capacity,
    every scale and zero is finite — torch reductions on the planes'
    device and one host read.  A flip that stays inside the valid code
    range is invisible here; that is what the CRC layer is for.

Leaves are named by the reference's keyed paths
(``"['blocks']['attn']['wq'].codes"``; a ``TiledPackedLinear``'s planes
are the reference's ``codes_t``, ``literals_t`` and ``nlit_t``).  The reference stacks the layers
of ``params['blocks']`` on a leading axis; the port keeps a list, so a
stacked leaf is the concatenation of its layers' planes in layer order
and its CRCs are the reference's.  The port stores codes as int16 holding
the uint16 bits: the bytes, and so ``nbytes`` and both CRCs, are the
reference's; the manifest records the port's own dtype.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from .codec import ESCAPE
from .compressed import PackedLinear, QuantLinear, TiledPackedLinear

# 'fast' level: planes up to this many bytes hash whole; larger ones hash
# a strided byte sample of about _FAST_SAMPLE bytes, with head and tail.
FAST_FULL_MAX = 1 << 18
_FAST_SAMPLE = 1 << 16

MANIFEST_VERSION = 1

_CONTAINERS = (PackedLinear, TiledPackedLinear, QuantLinear)
_PACKED = (PackedLinear, TiledPackedLinear)


class IntegrityError(RuntimeError):
    """Raised when a quarantined (corrupt) artifact would otherwise serve."""

    def __init__(self, report: "IntegrityReport"):
        self.report = report
        super().__init__("artifact integrity check failed: "
                         + "; ".join(f"{leaf}[{plane}]: {reason}"
                                     for leaf, plane, reason in report.corrupt))


@dataclasses.dataclass
class IntegrityReport:
    level: str
    ok: bool
    corrupt: list            # [(leaf, plane, reason)], named per plane
    checked: int             # planes compared
    bytes_hashed: int
    elapsed_s: float

    @property
    def quarantined(self) -> list:
        """Sorted unique leaf names that must not be decoded."""
        return sorted({leaf for leaf, _, _ in self.corrupt})

    def summary(self) -> str:
        if self.ok:
            return (f"verify[{self.level}]: ok — {self.checked} planes, "
                    f"{self.bytes_hashed / 2**20:.1f} MiB hashed in "
                    f"{self.elapsed_s * 1e3:.1f} ms")
        return (f"verify[{self.level}]: CORRUPT — "
                f"{len(self.corrupt)} plane(s) in "
                f"{len(self.quarantined)} leaf(s): "
                + "; ".join(f"{l}[{p}]: {r}" for l, p, r in self.corrupt))


# ---------------------------------------------------------------------------
# The parameter tree in the reference's flatten order.
# ---------------------------------------------------------------------------

# The parameter lists the reference stacks on a leading layer axis: the
# decoder-only families' blocks, the encoder–decoder's two stacks.
STACKED = ("blocks", "encoder", "decoder")


def leaf_groups(params) -> list:
    """[(name, [(holder, key), ...]), ...] in the reference's flatten order.

    The reference stacks the layers of ``params["blocks"]`` (and of an
    encoder–decoder's ``"encoder"`` and ``"decoder"``: ``STACKED``), so each
    per-layer leaf (e.g. ``['blocks']['attn']['wq']``) is one stacked leaf
    whose layers are quantized, counted and encoded in layer order, and
    dict keys flatten sorted.  The table's code order depends on that
    stream order, so the port walks its per-layer list the same way: a
    group holds one leaf position across all layers.  Any other list (an
    MoE model's ``first_blocks``) is a list in the reference too: each
    element is a tree of its own."""
    groups = []

    def visit(node, prefix, holders):
        for key in sorted(node):
            name = f"{prefix}['{key}']"
            child = node[key]
            if isinstance(child, list) and key in STACKED:  # stacked layers
                visit(child[0], name, child)
            elif isinstance(child, list):
                for i, sub in enumerate(child):
                    visit(sub, f"{name}[{i}]", [sub])
            elif isinstance(child, dict):
                visit(child, name, [h[key] for h in holders])
            else:
                groups.append((name, [(h, key) for h in holders]))

    visit(params, "", [params])
    return groups


def plane_keys(container) -> dict:
    """{field -> the reference's plane name} where they differ: a
    ``TiledPackedLinear``'s ``codes`` is the reference's ``codes_t``."""
    return getattr(container, "PLANE_KEYS", {})


def _stacked(name: str) -> bool:
    return any(name.startswith(f"['{k}']") for k in STACKED)


def plane_leaves(params):
    """Yield (name, parts) for every plane of ``params`` in the reference's
    flatten order: ``name`` the reference's keyed path, ``parts`` the
    tensors whose concatenation is the reference's leaf (a stacked leaf:
    one per layer), with ``shape`` the reference's leaf shape."""
    for name, holders in leaf_groups(params):
        first = holders[0][0][holders[0][1]]
        if isinstance(first, _CONTAINERS):
            planes = [f.name for f in dataclasses.fields(first)
                      if isinstance(getattr(first, f.name), torch.Tensor)]
            keys = plane_keys(first)
            for plane in planes:
                yield _Leaf(f"{name}.{keys.get(plane, plane)}",
                            [getattr(h[k], plane) for h, k in holders],
                            _stacked(name))
        elif isinstance(first, torch.Tensor):
            yield _Leaf(name, [h[k] for h, k in holders], _stacked(name))


@dataclasses.dataclass
class _Leaf:
    name: str
    parts: list
    stacked: bool

    @property
    def shape(self) -> list:
        shape = [int(s) for s in self.parts[0].shape]
        return [len(self.parts)] + shape if self.stacked else shape

    @property
    def dtype(self) -> str:
        return str(self.parts[0].dtype).replace("torch.", "")

    def u8(self) -> list:
        """Each part's bytes as a flat uint8 tensor on its device."""
        return [p.contiguous().reshape(-1).view(torch.uint8)
                for p in self.parts]


# ---------------------------------------------------------------------------
# Digests.
# ---------------------------------------------------------------------------

def _host(u8) -> np.ndarray:
    return u8.cpu().numpy()


def _crc_full(parts) -> int:
    """CRC32 of the concatenation of ``parts`` (flat uint8 tensors),
    chained part by part."""
    c = 0
    for p in parts:
        c = zlib.crc32(_host(p), c)
    return c & 0xFFFFFFFF


def _take(parts, idx: np.ndarray) -> np.ndarray:
    """The bytes at global indices ``idx`` (ascending) of the concatenation
    of ``parts``, gathered on each part's device."""
    out, off = [], 0
    for p in parts:
        n = p.numel()
        lo, hi = np.searchsorted(idx, [off, off + n])
        if hi > lo:
            local = torch.from_numpy(idx[lo:hi] - off).to(p.device)
            out.append(_host(p[local]))
        off += n
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


def _crc_fast(parts) -> int:
    """The reference's strided-sample digest of the concatenation of
    ``parts``: planes up to FAST_FULL_MAX bytes whole; larger ones the
    length, the first 256 bytes, every stride-th byte and the last 256.
    Only the sampled bytes leave the device.  A single bit flip is caught
    only if it lands on a sampled byte."""
    n = sum(p.numel() for p in parts)
    if n <= FAST_FULL_MAX:
        return _crc_full(parts)
    stride = max(1, n // _FAST_SAMPLE)
    c = zlib.crc32(n.to_bytes(8, "little"))
    for idx in (np.arange(256), np.arange(0, n, stride),
                np.arange(n - 256, n)):
        c = zlib.crc32(_take(parts, idx.astype(np.int64)), c)
    return c & 0xFFFFFFFF


def _table_crc(table: Optional[dict]) -> Optional[int]:
    if table is None:
        return None
    c = 0
    for seq, code in sorted(table.items(), key=lambda kv: kv[1]):
        c = zlib.crc32(bytes(seq) + int(code).to_bytes(4, "little"), c)
    return c & 0xFFFFFFFF


def _entry(leaf: _Leaf) -> dict:
    u8 = leaf.u8()
    return {"shape": leaf.shape, "dtype": leaf.dtype,
            "nbytes": int(sum(p.numel() for p in u8)),
            "crc32": _crc_full(u8), "crc32_fast": _crc_fast(u8)}


def _lut_leaf(lut) -> _Leaf:
    return _Leaf("<lut>", [lut], False)


def build_manifest(params: Any, lut=None, table: Optional[dict] = None
                   ) -> dict:
    """Per-plane integrity manifest of a served param tree (the bytes are
    read to the host).  JSON-serializable; stored on
    ``ServeState.manifest`` by ``serve.engine.build_serve_params``."""
    t0 = time.perf_counter()
    leaves, total = {}, 0
    for leaf in plane_leaves(params):
        leaves[leaf.name] = entry = _entry(leaf)
        total += entry["nbytes"]
    lut_entry = None
    if lut is not None:
        lut_entry = _entry(_lut_leaf(lut))
        total += lut_entry["nbytes"]
    return {"version": MANIFEST_VERSION, "leaves": leaves, "lut": lut_entry,
            "table_crc32": _table_crc(table), "total_bytes": total,
            "build_s": time.perf_counter() - t0}


def _check_plane(leaf: _Leaf, plane: str, entry: dict, level: str,
                 corrupt: list) -> int:
    if leaf.shape != entry["shape"]:
        corrupt.append((leaf.name, plane, f"shape {leaf.shape} != manifest "
                        f"{entry['shape']}"))
        return 0
    if leaf.dtype != entry["dtype"]:
        corrupt.append((leaf.name, plane, f"dtype {leaf.dtype} != manifest "
                        f"{entry['dtype']}"))
        return 0
    u8 = leaf.u8()
    if level == "full":
        got, want, tag = _crc_full(u8), entry["crc32"], "crc32"
        hashed = entry["nbytes"]
    else:
        got, want, tag = _crc_fast(u8), entry["crc32_fast"], "crc32_fast"
        n = entry["nbytes"]
        hashed = n if n <= FAST_FULL_MAX else (
            512 + len(range(0, n, max(1, n // _FAST_SAMPLE))))
    if got != want:
        corrupt.append((leaf.name, plane,
                        f"{tag} {got:#010x} != manifest {want:#010x}"))
    return hashed


def _plane_tag(name: str) -> str:
    """Trailing attribute of a keyed path ('...w_gate.codes' -> 'codes')."""
    return name.rsplit(".", 1)[-1] if "." in name else name


def verify_serve_state(state, *, level: str = "full") -> IntegrityReport:
    """Re-hash a ServeState against its pack-time manifest.

    ``level``: 'off' (an ok report, nothing read), 'fast' (sampled
    digests: bounded time and bytes read off the device), 'full' (every
    byte: ground truth).  Every mismatching plane is named ``(leaf, plane,
    reason)`` in ``report.corrupt``; the union of leaves is
    ``report.quarantined``."""
    t0 = time.perf_counter()
    if level == "off":
        return IntegrityReport(level, True, [], 0, 0, 0.0)
    if level not in ("fast", "full"):
        raise ValueError(f"verify level {level!r} not in off|fast|full")
    manifest = getattr(state, "manifest", None)
    if not manifest:
        raise ValueError("ServeState carries no integrity manifest "
                         "(built with manifest=False?)")
    corrupt: list = []
    checked = hashed = 0
    seen = set()
    for leaf in plane_leaves(state.params):
        seen.add(leaf.name)
        entry = manifest["leaves"].get(leaf.name)
        if entry is None:
            corrupt.append((leaf.name, "-", "leaf absent from manifest"))
            continue
        hashed += _check_plane(leaf, _plane_tag(leaf.name), entry, level,
                               corrupt)
        checked += 1
    for name in manifest["leaves"]:
        if name not in seen:
            corrupt.append((name, "-", "manifest leaf missing from params"))
    if manifest["lut"] is not None:
        if state.lut is None:
            corrupt.append(("<lut>", "lut", "LUT missing from state"))
        else:
            hashed += _check_plane(_lut_leaf(state.lut), "lut",
                                   manifest["lut"], level, corrupt)
            checked += 1
    if _table_crc(state.table) != manifest["table_crc32"]:
        corrupt.append(("<table>", "table", "dictionary table crc mismatch"))
    return IntegrityReport(level, not corrupt, corrupt, checked, hashed,
                           time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Device-side structural invariants.
# ---------------------------------------------------------------------------

def _container_ok(w, n_rows: int) -> torch.Tensor:
    ok = torch.isfinite(w.scale).all() & torch.isfinite(w.zero).all()
    if isinstance(w, _PACKED):
        codes = w.codes.to(torch.int32) & 0xFFFF
        ok = ok & ((codes < n_rows) | (codes == ESCAPE)).all()
        cap = w.literals.shape[-2]
        ok = ok & ((w.nlit >= 0) & (w.nlit <= cap)).all()
    return ok


def invariant_flags(params, lut) -> dict:
    """{container leaf name -> 0-d bool tensor on the planes' device}:
    packed planes (untiled or column groups), every code < LUT rows or == ESCAPE, 0 <= nlit <= the
    literal capacity, scale and zero finite; int8 weights, scale and zero
    finite.  A stacked leaf's flag covers all its layers.  No host read."""
    n_rows = lut.shape[0] if lut is not None else 0
    out = {}
    for name, holders in leaf_groups(params):
        if isinstance(holders[0][0][holders[0][1]], _CONTAINERS):
            flags = [_container_ok(h[k], n_rows) for h, k in holders]
            out[name] = torch.stack(flags).all()
    return out


def check_invariants(state) -> IntegrityReport:
    """Host wrapper over :func:`invariant_flags`: the flags are stacked on
    the device and read back in one transfer, as the reference reads its
    one jitted evaluation.  Catches decode-crashing corruption
    (out-of-range LUT index, literal overflow, non-finite affine) before
    the first prefill; in-range bit flips pass — pair with
    :func:`verify_serve_state`."""
    t0 = time.perf_counter()
    flags = invariant_flags(state.params, state.lut)
    names = list(flags)
    values = (torch.stack(list(flags.values())).cpu().tolist()
              if flags else [])
    corrupt = [(n, "invariant", "device-side structural check failed")
               for n, ok in zip(names, values) if not ok]
    return IntegrityReport("invariant", not corrupt, corrupt, len(names),
                           0, time.perf_counter() - t0)
