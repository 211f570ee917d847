"""Tiered expert residency — a pinned host backing store and a device
cache of hot experts.

Counterpart of ``repro/serve/residency.py`` for one device.  A model need
not hold every compressed expert plane on the card:

  * **Backing tier**: the compressed expert planes (codes, literals, nlit,
    scale, zero of w_gate, w_up and w_down) of every MoE layer live in
    pinned host memory, one pinned tensor per (weight, plane) of shape
    (layers, experts, ...), copied off the served params once at
    construction and checked there against the pack-time manifest
    (``core/integrity.py``).  Every fetch re-hashes its expert's slice
    (CRC32 on the host, before the copy), so a corrupt plane raises
    ``IntegrityError`` naming (layer, expert, plane) and never reaches the
    card.  A demand fetch is a ``non_blocking`` copy out of a pinned view
    straight into its cache slot.
  * **Device cache**: per MoE layer and weight, a C-slot stacked
    ``PackedLinear`` that the grouped fused kernel (K3) reads like the
    full 64-expert stack, planned for the layer's expert count so that
    each expert's rows are bitwise the full stack's.  A miss is a
    synchronous fetch of compressed planes, never a dense weight
    (``MATERIALIZE_COUNTS['packed_stacked']`` stays 0).  Slots are evicted
    least recently used first and stamped with an install generation; the
    per-layer ``slot_of_expert`` (E,) and ``expert_of_slot`` (C,) index
    tensors ride in the served params (``models.layers.apply_moe``).
  * **Bitwise parity**: every expert a step routes to is resident before
    the step's outputs are kept (below), and the combine reads only routed
    experts, so outputs equal the fully resident path's at any capacity
    ≥ 1 (tests/test_torch_residency.py on the CPU; tests/test_torch_cuda.py
    and chip_smoke.py on the card).

**Fetch/replay** (:meth:`ResidencyManager.run`): launch the step against
the current cache, read its per-layer routing back to the host
(``lm.forward(..., return_routing=True)``) and check it against the slot
table.  If every routed expert was resident, the outputs are exact: commit
(LRU touch, trim a transient overflow, issue prefetches) and return.
Otherwise the routing is trusted only up to the first layer with a miss:
fetch that prefix's missing experts and replay; the trusted prefix grows
by a layer a pass, so at most ``n_layers`` replays.  A step's working set
may exceed the capacity (capacity 1 under top-6 routing): the cache grows
for the step and trims back at commit.

The port's steps write their caches in place (``layers._kv_write``,
``kv_cache.write_token``), where the reference's are pure; a replay is
still exact, because a pass writes only the rows at the step's positions
(the prefill: its prompt's rows), every pass writes them before it reads
them, and nothing else a pass writes is read by the next (the engine's
next tokens are overwritten, its token buffer is an input, and no random
generator advances inside a pass: ``tiered_generate`` draws after ``run``
returns, the engine draws per row by counter).

**Prefetch**: at commit, layer *l*'s routing predicts layer *l+1*'s hot
set one layer ahead, plus layer *l*'s own (temporal locality).  A
``residency-prefetch`` thread slices, checks and copies the predicted
experts on its own CUDA stream and records an event; ``run`` joins the
worker, makes the serving stream wait on each event and installs (a device
copy into the slot on the serving stream, so a slot is never overwritten
while a launch that reads it is in flight).  The first use of a prefetched
slot counts ``prefetch_hit``.  A failed prefetch counts
``prefetch_error`` and becomes a later demand miss, whose fetch fails
loudly.

The step runs eagerly on the card: the protocol reads the routing on every
pass, and a step that grows the cache changes C.  Fully resident serving
keeps its captured graphs.

Observability: ``RESIDENCY_COUNTS`` (the reference's keys), mirrored per
manager with stall seconds, the CRC's seconds (the demand path's, inside
the stall, and the prefetch worker's), the largest slot count a step grew
to and the largest batch of prefetched bytes that waited for an install;
``scheduler.Engine.health()`` and
``ResilientEngine.health()`` show :meth:`ResidencyManager.snapshot`.  A
fetch fault (``testing.faults.FaultInjector.fetch_fault`` patches
``_transfer``) raises ``torch.AcceleratorError`` and walks the ladder like
any device fault.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
import warnings
import zlib
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from .._device import resolve_device, upload
from ..core.compressed import PackedLinear
from ..core.integrity import (IntegrityError, IntegrityReport, _check_plane,
                              _Leaf)
from ..models import lm as LM
from . import engine as _engine

# Residency probe: event -> count, reset by ``scheduler.Engine.reset_stats``.
# 'hit': a routed expert was cached; 'prefetch_hit': the hit's slot was
# installed by the prefetcher and this is its first use; 'miss' /
# 'sync_fetch': a routed expert had to be fetched synchronously (a stall);
# 'prefetch_issued' / 'prefetch_installed': predictions queued / landed in
# a slot; 'evict': an occupied slot was reassigned or trimmed;
# 'bytes_fetched': compressed bytes moved host to device; 'replay': extra
# fetch-and-replay passes.
RESIDENCY_COUNTS: collections.Counter = collections.Counter()

_PLANES = ("codes", "literals", "nlit", "scale", "zero")
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


class ResidencyError(RuntimeError):
    """Residency-protocol failure (bad wiring, a replay that does not
    converge)."""


def _transfer(arrays, dst):
    """Host→device copy of one expert's planes: each pinned host view of
    ``arrays`` ({(key, plane): tensor}) into the device tensor of ``dst``
    under the same key, a ``non_blocking`` copy on the current stream.

    The one seam every fetch and prefetch crosses, module-level so that
    ``FaultInjector.fetch_fault`` can patch it to fail (raising
    ``torch.AcceleratorError``, which walks the ladder) or to delay (a
    saturated link)."""
    for key, t in arrays.items():
        dst[key].copy_(t, non_blocking=True)


def _u8(t: torch.Tensor) -> np.ndarray:
    """The bytes of a contiguous host tensor, as a flat uint8 array."""
    return t.numpy().reshape(-1).view(np.uint8)


@dataclasses.dataclass
class _SlotRec:
    """Host-side record of one device cache slot."""
    expert: int = -1          # -1 = vacant
    last_used: int = 0        # LRU tick (monotonic per manager)
    gen: int = 0              # install generation stamp
    source: str = ""          # 'demand' | 'prefetch'
    fresh: bool = False       # installed but not yet served from


class ResidencyManager:
    """Owns the expert cache slots and the host backing store.

    state: an ``engine.ServeState`` (params + manifest), or a params tree.
    The cache lives on the device of the state's expert planes.
    capacity: retained experts per layer (default all: fully resident,
    through the cache machinery); ``cache_bytes`` sizes it from a device
    byte budget instead.  prefetch=False: demand fetches only.
    verify=False skips the construction-time manifest check (the per-fetch
    slice CRCs still run)."""

    def __init__(self, state, cfg, *, capacity: Optional[int] = None,
                 cache_bytes: Optional[int] = None, prefetch: bool = True,
                 verify: bool = True):
        params = getattr(state, "params", state)
        manifest = getattr(state, "manifest", None)
        if getattr(cfg, "moe_expert_scan", False):
            raise ResidencyError("tiered residency and moe_expert_scan are "
                                 "mutually exclusive (both own expert-"
                                 "granular memory)")
        if getattr(cfg, "moe_local_dispatch", False):
            raise ResidencyError("tiered residency requires global MoE "
                                 "dispatch (moe_local_dispatch=False)")
        try:
            experts = [b["moe"]["experts"] for b in params["blocks"]]
        except (KeyError, TypeError):
            experts = []
        if not experts:
            raise ResidencyError("params carry no blocks[i]['moe']"
                                 "['experts'] stacks — tiered residency "
                                 "needs an MoE-family compressed model")
        for k in _EXPERT_KEYS:
            for w in (ex.get(k) for ex in experts):
                if not (isinstance(w, PackedLinear) and w.codes.ndim == 3
                        and w.tile_n > 0):
                    raise ResidencyError(
                        f"expert stack {k!r} is not a tile-major stacked "
                        f"PackedLinear — tiered residency caches compressed "
                        f"planes only (got {type(w).__name__})")
        self.cfg = cfg
        self._source_params = params
        self.device = experts[0]["w_gate"].codes.device
        self.n_layers = len(experts)
        self.n_experts = int(experts[0]["w_gate"].codes.shape[0])

        # Backing tier: one pinned host tensor per (weight, plane), (L, E,
        # ...), filled off the device layer by layer.
        pin = self.device.type == "cuda"
        self._host: Dict[str, Dict[str, torch.Tensor]] = {}
        for k in _EXPERT_KEYS:
            self._host[k] = {}
            for pl in _PLANES:
                first = getattr(experts[0][k], pl)
                host = torch.empty((self.n_layers,) + tuple(first.shape),
                                   dtype=first.dtype, pin_memory=pin)
                for l, ex in enumerate(experts):
                    host[l].copy_(getattr(ex[k], pl))
                self._host[k][pl] = host
        self.bytes_per_expert = sum(
            self._host[k][pl][0, 0].numel()
            * self._host[k][pl].element_size()
            for k in _EXPERT_KEYS for pl in _PLANES)
        if verify and manifest is not None:
            self._verify_backing(manifest)
        # Per-(layer, expert, weight, plane) digests: every later fetch is
        # re-hashed against these, so backing-store rot is caught at fetch
        # time, named, and never served.
        self._slice_crc = {
            (l, e, k, pl): zlib.crc32(_u8(self._host[k][pl][l, e]))
            & 0xFFFFFFFF
            for k in _EXPERT_KEYS for pl in _PLANES
            for l in range(self.n_layers) for e in range(self.n_experts)}

        granted_bytes = None
        if capacity is None and cache_bytes is not None:
            granted_bytes = int(cache_bytes)
            capacity = int(cache_bytes //
                           (self.n_layers * self.bytes_per_expert))
        elif capacity is not None:
            granted_bytes = int(capacity) * self.n_layers \
                * self.bytes_per_expert
        self.capacity = (self.n_experts if capacity is None
                         else max(1, min(int(capacity), self.n_experts)))
        # The cache floor is one expert per layer: a smaller grant is
        # clamped up, which overshoots the caller's byte budget.  Warn,
        # and record it for snapshot() / health().
        floor_bytes = self.n_layers * self.bytes_per_expert
        self.overshoot_bytes = 0
        if granted_bytes is not None and granted_bytes < floor_bytes:
            self.overshoot_bytes = floor_bytes - max(granted_bytes, 0)
            warnings.warn(
                f"expert-cache budget {granted_bytes / 2**20:.2f} MiB grants "
                f"0 experts/layer; clamping to capacity 1 overshoots the "
                f"budget by {self.overshoot_bytes / 2**20:.2f} MiB "
                f"({self.n_layers} layers x "
                f"{self.bytes_per_expert / 2**20:.2f} MiB/expert)",
                RuntimeWarning, stacklevel=2)
        self.c_alloc = self.capacity
        self.boot_capacity = self.capacity

        # Device tier: zero-initialised C-slot cache stacks per layer, with
        # the source's tiling, so K3 reads them as it reads the full stack.
        self._stacks: List[Dict[str, PackedLinear]] = []
        for ex in experts:
            layer = {}
            for k in _EXPERT_KEYS:
                src = ex[k]
                zp = {pl: torch.zeros(
                    (self.c_alloc,) + tuple(getattr(src, pl).shape[1:]),
                    dtype=getattr(src, pl).dtype, device=self.device)
                    for pl in _PLANES}
                layer[k] = PackedLinear(
                    zp["codes"], zp["literals"], zp["nlit"], zp["scale"],
                    zp["zero"], shape=src.shape, tile_n=src.tile_n,
                    tile_k=src.tile_k)
            self._stacks.append(layer)

        # Served tree: the caller's params with each MoE layer's expert
        # stacks swapped for its cache stacks and its residency maps beside
        # them.  Every other leaf is shared by reference.
        self._res_maps: List[Dict[str, torch.Tensor]] = [
            {} for _ in range(self.n_layers)]
        self._dp = dict(params, blocks=[
            dict(b, moe=dict(b["moe"], experts=self._stacks[l],
                             residency=self._res_maps[l]))
            for l, b in enumerate(params["blocks"])])

        self._slots: List[List[_SlotRec]] = [
            [_SlotRec() for _ in range(self.c_alloc)]
            for _ in range(self.n_layers)]
        self._where: List[Dict[int, int]] = [
            {} for _ in range(self.n_layers)]
        self._maps_dirty = True
        self._ticks = 0
        self._gen = 0
        self._last_needed: Dict[int, Set[int]] = {}

        self.prefetch_enabled = bool(prefetch)
        self._prefetch_boot = bool(prefetch)
        self._worker: Optional[threading.Thread] = None
        self._side: Optional[torch.cuda.Stream] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._ready: list = []      # [(l, e, device planes, nbytes, event)]
        self._errors: list = []     # [(l, e, repr(exc))]
        self._inflight: Set[tuple] = set()
        self.reset_stats()

    # -- stats ----------------------------------------------------------
    def reset_stats(self) -> None:
        self.stats = {k: 0 for k in
                      ("hit", "miss", "prefetch_hit", "prefetch_issued",
                       "prefetch_installed", "prefetch_error", "evict",
                       "fetch", "sync_fetch", "bytes_fetched", "replay",
                       "steps")}
        self.stall_s = 0.0
        self.crc_s = 0.0              # demand fetches' CRC, inside stall_s
        self.prefetch_crc_s = 0.0     # the prefetch worker's CRC
        self.peak_slots = self.c_alloc
        self.peak_ready_bytes = 0     # prefetched bytes awaiting install

    def _count(self, key: str, n: int = 1) -> None:
        RESIDENCY_COUNTS[key] += n
        self.stats[key] = self.stats.get(key, 0) + n

    def snapshot(self) -> dict:
        """Health and benchmark view: counters, sizing, derived rates."""
        s = dict(self.stats)
        looks = s["hit"] + s["prefetch_hit"] + s["miss"]
        s.update(
            capacity=self.capacity, slots_allocated=self.c_alloc,
            layers=self.n_layers, experts=self.n_experts,
            bytes_per_expert=self.bytes_per_expert,
            overshoot_bytes=self.overshoot_bytes,
            prefetch_enabled=self.prefetch_enabled,
            stall_s=round(self.stall_s, 6), crc_s=round(self.crc_s, 6),
            prefetch_crc_s=round(self.prefetch_crc_s, 6),
            peak_slots=self.peak_slots,
            peak_ready_bytes=self.peak_ready_bytes,
            stall_per_miss_ms=round(1e3 * self.stall_s / max(s["miss"], 1),
                                    4),
            hit_rate=(round((s["hit"] + s["prefetch_hit"]) / looks, 4)
                      if looks else None),
            prefetch_hit_rate=(round(s["prefetch_hit"] / looks, 4)
                               if looks else None),
            generation=self._gen)
        return s

    def cache_device_bytes(self) -> int:
        """Device bytes of the cache stacks right now (every layer)."""
        return sum(getattr(w, pl).numel() * getattr(w, pl).element_size()
                   for layer in self._stacks for w in layer.values()
                   for pl in _PLANES)

    def resident(self, layer: int) -> Dict[int, int]:
        """{expert: slot} cached at ``layer`` (tests, debugging)."""
        return dict(self._where[layer])

    def slot_table(self, layer: int) -> list:
        """The generation-stamped slot table at ``layer``."""
        return [dataclasses.replace(r) for r in self._slots[layer]]

    # -- integrity ------------------------------------------------------
    def _verify_backing(self, manifest) -> None:
        """Construction gate: the host planes about to back the cache must
        hash to their pack-time manifest digests (a stacked leaf's digest
        is over its layers' planes in layer order, as the store holds
        them)."""
        t0 = time.perf_counter()
        corrupt, checked, hashed = [], 0, 0
        for k in _EXPERT_KEYS:
            for pl in _PLANES:
                name = f"['blocks']['moe']['experts']['{k}'].{pl}"
                host = self._host[k][pl]
                leaf = _Leaf(name, [host[l] for l in range(self.n_layers)],
                             True)
                entry = manifest["leaves"].get(name)
                if entry is None:
                    corrupt.append((name, "-", "leaf absent from manifest"))
                    continue
                hashed += _check_plane(leaf, pl, entry, "full", corrupt)
                checked += 1
        report = IntegrityReport("residency-init", not corrupt, corrupt,
                                 checked, hashed, time.perf_counter() - t0)
        if not report.ok:
            raise IntegrityError(report)

    def _verify_slice(self, l: int, e: int, arrs) -> float:
        """CRC32 of one expert's host slices against the recorded digests:
        raises ``IntegrityError`` naming (layer, expert, plane), else
        returns the seconds it took."""
        t0 = time.perf_counter()
        corrupt, hashed = [], 0
        for (k, pl), a in arrs.items():
            u8 = _u8(a)
            hashed += u8.size
            got = zlib.crc32(u8) & 0xFFFFFFFF
            want = self._slice_crc[(l, e, k, pl)]
            if got != want:
                corrupt.append(
                    (f"blocks.moe.experts.{k}[layer {l}, expert {e}]", pl,
                     f"crc32 {got:#010x} != recorded {want:#010x} at "
                     f"fetch time"))
        if corrupt:
            raise IntegrityError(IntegrityReport(
                "fetch", False, corrupt, len(arrs), hashed,
                time.perf_counter() - t0))
        return time.perf_counter() - t0

    # -- device tree ----------------------------------------------------
    def check_params(self, params) -> None:
        """Tiered closures serve from the manager's spliced tree; the
        params a caller passes must be the tree this manager was built on
        (anything else would silently serve other weights)."""
        if params is not None and params is not self._source_params:
            raise ResidencyError(
                "params passed to a tiered serve fn are not the tree this "
                "ResidencyManager was built from — build the manager from "
                "the same ServeState you serve")

    def device_params(self):
        """The served param tree (cache stacks + current residency maps)."""
        if self._maps_dirty:
            soe = np.full((self.n_layers, self.n_experts), self.c_alloc,
                          np.int32)
            eos = np.full((self.n_layers, self.c_alloc), self.n_experts,
                          np.int32)
            for l, recs in enumerate(self._slots):
                for s, r in enumerate(recs):
                    if r.expert >= 0:
                        soe[l, r.expert] = s
                        eos[l, s] = r.expert
            soe_d, eos_d = upload(soe, self.device), upload(eos, self.device)
            for l, maps in enumerate(self._res_maps):
                maps["slot_of_expert"] = soe_d[l]
                maps["expert_of_slot"] = eos_d[l]
            self._maps_dirty = False
        return self._dp

    # -- slot mechanics -------------------------------------------------
    def _tick(self) -> int:
        self._ticks += 1
        return self._ticks

    def _find(self, l: int, e: int) -> Optional[int]:
        return self._where[l].get(int(e))

    def _touch(self, rec: _SlotRec) -> None:
        rec.last_used = self._tick()

    def _slice(self, l: int, e: int):
        """Expert ``e`` of layer ``l`` in the backing store: pinned views."""
        return {(k, pl): self._host[k][pl][l, e]
                for k in _EXPERT_KEYS for pl in _PLANES}

    def _slot_views(self, l: int, slot: int):
        """{(key, plane): the cache stacks' rows of ``slot`` at ``l``}."""
        return {(k, pl): getattr(stack, pl)[slot]
                for k, stack in self._stacks[l].items() for pl in _PLANES}

    def _fetch(self, l: int, e: int, protected: Set[int]) -> int:
        """Demand fetch: slice one expert off the backing store, verify,
        and copy it straight into a slot claimed at layer ``l``.  A copy
        that fails leaves the slot vacant (it may hold part of one)."""
        arrs = self._slice(l, e)
        self.crc_s += self._verify_slice(l, e, arrs)
        slot = self._claim(l, protected)
        _transfer(arrs, self._slot_views(l, slot))
        self._count("fetch")
        self._count("bytes_fetched", self.bytes_per_expert)
        return self._record(l, e, slot, "demand")

    def _install(self, l: int, e: int, dev, protected: Set[int]) -> int:
        """Place a landed prefetch's device planes into a slot at ``l``."""
        slot = self._claim(l, protected)
        for key, dst in self._slot_views(l, slot).items():
            dst.copy_(dev[key])
        return self._record(l, e, slot, "prefetch")

    def _claim(self, l: int, protected: Set[int]) -> int:
        """A slot at layer ``l`` to fill, left vacant: a vacant one first,
        else the least recently used slot whose expert is not
        ``protected`` (evicted), else a new slot (``_grow``)."""
        recs = self._slots[l]
        slot = next((i for i, r in enumerate(recs) if r.expert < 0), None)
        if slot is None:
            cands = [(r.last_used, i) for i, r in enumerate(recs)
                     if r.expert not in protected]
            if not cands:
                self._grow(1)
                return len(self._slots[l]) - 1
            slot = min(cands)[1]
            self._count("evict")
            self._where[l].pop(recs[slot].expert, None)
            recs[slot] = _SlotRec()
            self._maps_dirty = True
        return slot

    def _record(self, l: int, e: int, slot: int, source: str) -> int:
        """Stamp ``slot`` at ``l`` as holding expert ``e``."""
        self._gen += 1
        self._slots[l][slot] = _SlotRec(
            expert=int(e), last_used=self._tick(), gen=self._gen,
            source=source, fresh=(source == "prefetch"))
        self._where[l][int(e)] = slot
        self._maps_dirty = True
        return slot

    def _grow(self, extra: int) -> None:
        """Widen every layer's cache for a step whose working set exceeds
        the retained capacity; commit trims back (:meth:`_trim`)."""
        for layer in self._stacks:
            for stack in layer.values():
                for pl in _PLANES:
                    plane = getattr(stack, pl)
                    setattr(stack, pl, torch.cat(
                        [plane, plane.new_zeros((extra,)
                                                + tuple(plane.shape[1:]))]))
        for recs in self._slots:
            recs.extend(_SlotRec() for _ in range(extra))
        self.c_alloc += extra
        self.peak_slots = max(self.peak_slots, self.c_alloc)
        self._maps_dirty = True

    def _trim(self) -> None:
        """Compact back to ``capacity`` slots, keeping each layer's most
        recently used experts (the LRU tail is evicted)."""
        if self.c_alloc <= self.capacity:
            return
        new_slots: List[List[_SlotRec]] = []
        for l, recs in enumerate(self._slots):
            order = sorted(range(len(recs)),
                           key=lambda i: (recs[i].expert < 0,
                                          -recs[i].last_used, i))
            kept, dropped = order[:self.capacity], order[self.capacity:]
            for i in dropped:
                if recs[i].expert >= 0:
                    self._count("evict")
            idx = torch.tensor(kept, dtype=torch.long, device=self.device)
            for stack in self._stacks[l].values():
                for pl in _PLANES:
                    setattr(stack, pl, getattr(stack, pl).index_select(0,
                                                                       idx))
            new_slots.append([recs[i] for i in kept])
        self._slots = new_slots
        self._where = [{r.expert: s for s, r in enumerate(recs)
                        if r.expert >= 0} for recs in new_slots]
        self.c_alloc = self.capacity
        self._maps_dirty = True

    # -- runtime capacity (memory-pressure governor) --------------------
    def set_capacity(self, capacity: int) -> None:
        """Re-size the retained per-layer cache at run time.

        Shrinking compacts the stacks to the new capacity (the most
        recently used experts stay, the LRU tail is evicted); growing pads
        vacant slots at once, so regrown room is used by installs instead
        of evictions.  Parity is unaffected: the fetch/replay protocol
        refetches whatever a later step routes to.  Clamped to [1,
        n_experts]; a clamp up from a request below 1 records
        ``overshoot_bytes``."""
        want = int(capacity)
        capacity = max(1, min(want, self.n_experts))
        floor_bytes = self.n_layers * self.bytes_per_expert
        self.overshoot_bytes = floor_bytes if want < 1 else 0
        if capacity == self.capacity:
            return
        self.join_prefetches()       # no installs racing the re-shape
        self.capacity = capacity
        if self.c_alloc > capacity:
            self._trim()
        elif self.c_alloc < capacity:
            self._grow(capacity - self.c_alloc)
        self._maps_dirty = True

    def pause_prefetch(self) -> None:
        """Stop issuing predictions (the governor's first reclaim rung):
        fetches in flight still land and install at the next
        ``join_prefetches``."""
        self.prefetch_enabled = False

    def resume_prefetch(self) -> None:
        """Re-enable prediction (regrow), back to the boot setting."""
        self.prefetch_enabled = self._prefetch_boot

    # -- prefetch -------------------------------------------------------
    def _start_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            if self.device.type == "cuda" and self._side is None:
                self._side = torch.cuda.Stream(self.device)
            self._worker = threading.Thread(target=self._work, daemon=True,
                                            name="residency-prefetch")
            self._worker.start()

    def _prefetch_one(self, l: int, e: int):
        """Slice, verify and copy one predicted expert into fresh device
        tensors; on the card the copy runs on the side stream and an event
        marks its end.  → (planes, event or None, the CRC's seconds)."""
        arrs = self._slice(l, e)
        crc_s = self._verify_slice(l, e, arrs)

        def copy():
            dev = {key: torch.empty(t.shape, dtype=t.dtype,
                                    device=self.device)
                   for key, t in arrs.items()}
            _transfer(arrs, dev)
            return dev

        if self._side is None:
            return copy(), None, crc_s
        with torch.cuda.device(self.device), torch.cuda.stream(self._side):
            dev = copy()
            done = torch.cuda.Event()
            done.record(self._side)
        return dev, done, crc_s

    def _work(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            l, e = item
            try:
                dev, done, crc_s = self._prefetch_one(l, e)
                with self._lock:
                    self._ready.append((l, e, dev, self.bytes_per_expert,
                                        done))
                    self.prefetch_crc_s += crc_s
            except Exception as exc:   # recorded: a failed prefetch becomes
                with self._lock:       # a later (loud) demand miss
                    self._errors.append((l, e, repr(exc)))
            finally:
                self._queue.task_done()

    def close(self) -> None:
        """Stop and join the prefetch worker.  Idempotent; called by
        ``scheduler.Engine.close()`` and ``ResilientEngine.close()``, so
        teardown leaves no live ``residency-prefetch`` thread."""
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)
            self._queue.join()
            self._worker.join(timeout=5.0)
        self._worker = None

    def join_prefetches(self) -> None:
        """Wait out the prefetches in flight and install what landed:
        called at the top of every :meth:`run` and :meth:`step`, so
        installs are deterministic with respect to the step sequence (the
        overlap happens between steps).  On the card the serving stream
        waits on each copy's event first."""
        if self._worker is None:
            return
        self._queue.join()
        with self._lock:
            ready, self._ready = self._ready, []
            errors, self._errors = self._errors, []
        self.peak_ready_bytes = max(self.peak_ready_bytes,
                                    sum(r[3] for r in ready))
        for l, e, _ in errors:
            self._count("prefetch_error")
            self._inflight.discard((l, e))
        for l, e, dev, nbytes, done in ready:
            self._inflight.discard((l, e))
            if done is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(done)
                for t in dev.values():   # allocated on the side stream
                    t.record_stream(stream)
            if self._find(l, e) is not None:
                continue               # raced with a demand fetch
            self._count("fetch")
            self._count("bytes_fetched", nbytes)
            self._install(l, e, dev,
                          protected=self._last_needed.get(l, set()))
            self._count("prefetch_installed")

    def _issue_prefetches(self, needed: Sequence[Set[int]]) -> None:
        """Routing-aware prediction: layer l-1's observed routing
        prefetches layer l one layer ahead, plus the layer's own hot set
        (already resident: nothing to do)."""
        for l in range(self.n_layers):
            pred: Set[int] = set()
            if l < len(needed):
                pred |= needed[l]
            if 0 < l and l - 1 < len(needed):
                pred |= needed[l - 1]
            for e in sorted(pred):
                if self._find(l, e) is None \
                        and (l, e) not in self._inflight:
                    self._inflight.add((l, e))
                    self._count("prefetch_issued")
                    self._start_worker()
                    self._queue.put((l, e))

    # -- the protocol ---------------------------------------------------
    def _ensure(self, needed: Sequence[Set[int]],
                counted: Optional[set] = None) -> None:
        """Account hits and fetch misses of ``needed`` (a per-layer
        sequence of expert-id sets) synchronously; ``counted`` dedupes the
        accounting across replay passes of one step.  The stall is the
        host's time until the fetched planes are on the device."""
        counted = set() if counted is None else counted
        worst = max((len(exps) for exps in needed), default=0)
        if worst > self.c_alloc:
            self._grow(worst - self.c_alloc)
        t0, fetched = time.perf_counter(), False
        for l, exps in enumerate(needed):
            for e in sorted(int(x) for x in exps):
                slot = self._find(l, e)
                if slot is not None:
                    rec = self._slots[l][slot]
                    if (l, e) not in counted:
                        counted.add((l, e))
                        if rec.fresh and rec.source == "prefetch":
                            self._count("prefetch_hit")
                        else:
                            self._count("hit")
                    rec.fresh = False
                    self._touch(rec)
                else:
                    if (l, e) not in counted:
                        counted.add((l, e))
                        self._count("miss")
                    self._count("sync_fetch")
                    s = self._fetch(l, e, protected=exps)
                    fetched = True
                    rec = self._slots[l][s]
                    rec.fresh = False
                    self._touch(rec)
        if fetched:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            self.stall_s += time.perf_counter() - t0

    def _commit(self, needed: Sequence[Set[int]]) -> None:
        self.stats["steps"] += 1
        self._trim()
        self._last_needed = {l: set(exps) for l, exps in enumerate(needed)}
        if self.prefetch_enabled:
            self._issue_prefetches(needed)

    def _needed(self, routing: np.ndarray, active) -> List[Set[int]]:
        """Per-layer routed-expert sets from an (L, n_tok, k) routing
        array, keeping only rows of ``active`` slots when given."""
        r = np.asarray(routing)
        lm = r.shape[0]
        r = r.reshape(lm, -1, r.shape[-1])
        if active is not None:
            act = np.asarray(active, bool).reshape(-1)
            if act.size and r.shape[1] % act.size == 0:
                per = r.shape[1] // act.size
                r = r.reshape(lm, act.size, per, r.shape[-1])[:, act]
                r = r.reshape(lm, -1, routing.shape[-1])
            if not act.any():
                return [set() for _ in range(lm)]
        return [set(np.unique(r[l]).tolist()) if r[l].size else set()
                for l in range(lm)]

    def step(self, needed: Sequence) -> None:
        """Trace-driven tick: make ``needed`` (per-layer expert-id
        iterables) resident, commit, prefetch — :meth:`run` without a
        launch, for tests and trace benchmarks."""
        self.join_prefetches()
        needed = [set(int(e) for e in exps) for exps in needed]
        self._ensure(needed)
        self._commit(needed)

    def run(self, launch, *, active=None):
        """One serving step under the fetch/replay protocol.

        ``launch(device_params) -> (out, routing)``, routing an (L, n_tok,
        k) tensor of expert ids.  A discarded pass's writes must be
        rewritten by the next pass before they are read (the module
        docstring says why the port's steps qualify).  ``active``: an
        optional (B,) bool mask; only active rows' routing drives fetches.
        Returns ``out`` of the first fully resident pass; raises after
        ``n_layers + 1`` passes without one."""
        self.join_prefetches()
        counted: set = set()
        for _ in range(self.n_layers + 1):
            out, routing = launch(self.device_params())
            needed = self._needed(routing.cpu().numpy(), active)
            missing = [(l, e) for l, exps in enumerate(needed)
                       for e in exps if self._find(l, int(e)) is None]
            if not missing:
                self._ensure(needed, counted)
                self._commit(needed)
                return out
            # routing is trusted up to the first missing layer only:
            # deeper layers saw zero rows where its experts should have
            # fired.  Fetch the trusted prefix and replay.
            first = min(l for l, _ in missing)
            self._count("replay")
            self._ensure(needed[:first + 1], counted)
        raise ResidencyError(
            f"fetch/replay did not converge after {self.n_layers + 1} "
            f"passes — the launch does not rewrite what it reads")


# ---------------------------------------------------------------------------
# Tiered serve functions (engine-compatible closures over the manager).
# ---------------------------------------------------------------------------

def make_tiered_serve_fns(ctx):
    """(prefill, decode_step) with ``engine.make_serve_fns``' signatures,
    each step run through ``ctx.residency``'s fetch/replay protocol over
    the manager's spliced tree; the params a caller passes must be the
    tree the manager was built from."""
    mgr = ctx.residency
    if mgr is None:
        raise ResidencyError("ctx.residency is None — use "
                             "engine.make_serve_fns for resident serving")
    raw_prefill, raw_decode = _engine.serve_fns(
        ctx.cfg, resolve_device(ctx.device), routing=True)

    def prefill(params, lut, batch, caches):
        mgr.check_params(params)

        def launch(dp):
            logits, new_caches, eids = raw_prefill(dp, lut, batch, caches)
            return (logits, new_caches), eids

        return mgr.run(launch)

    def decode_step(params, lut, token, caches, pos):
        mgr.check_params(params)

        def launch(dp):
            logits, new_caches, eids = raw_decode(dp, lut, token, caches,
                                                  pos)
            return (logits, new_caches), eids

        return mgr.run(launch)

    return prefill, decode_step


@torch.no_grad()
def tiered_generate(params, cfg, tokens, *, ctx, max_new: int = 16,
                    max_len: Optional[int] = None, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None):
    """One-shot generation under tiered residency: the host-stepped mirror
    of ``engine.generate`` (the same prefill and cache shape, the same
    decode step at a 0-d position tensor, the same ``sample_tokens`` rule
    and generator draws), bitwise equal to it at any cache capacity,
    since every kept step saw all its routed experts resident."""
    device = resolve_device(ctx.device)
    tokens = torch.as_tensor(tokens).to(device)
    if max_new <= 0:
        return tokens
    b, t0 = tokens.shape
    caches = LM.init_caches(cfg, b, max_len or (t0 + max_new),
                            device=device)
    prefill, decode_step = make_tiered_serve_fns(
        ctx if ctx.cfg is cfg else ctx.with_cfg(cfg))
    logits, caches = prefill(params, ctx.lut, {"tokens": tokens.long()},
                             caches)
    tok = _engine.sample_tokens(logits, 0.0)[:, None]
    outs = [tok]
    pos = torch.full((), t0, dtype=torch.long, device=device)
    if generator is None:
        temperature = 0.0
    for _ in range(max_new - 1):
        logits, caches = decode_step(params, ctx.lut, tok, caches, pos)
        tok = _engine.sample_tokens(logits, temperature, generator)[:, None]
        outs.append(tok)
        pos = pos + 1
    return torch.cat([tokens] + [o.to(tokens.dtype) for o in outs], dim=1)
