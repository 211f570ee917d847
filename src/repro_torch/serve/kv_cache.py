"""Paged KV cache: the memory under the continuous-batching engine.

Counterpart of ``repro/serve/kv_cache.py`` for one device.  A fixed pool
of KV *pages* backs a fixed set of decode *slots*; each slot owns
``pages_per_slot`` pages, assembled through a per-slot page table into a
contiguous-looking cache of length ``max_len``:

  * ``PagedKVPool``: the host-side allocator over a device cache shaped
    like ``LM.init_caches(cfg, n_pages + 1, page_size)`` (batch axis = page
    id, time axis = in-page offset), so every layout the port's models make
    (per-layer K/V, MLA latent planes, an MoE model's ``"first"`` layers)
    pages uniformly, along the axes ``LM.cache_batch_time_axes`` finds.
    The last page is a *sink*, outside the allocator's ids (below).  The
    page tensors are written in place and rebuilt only by the runtime
    shrink and regrow (below), so a captured step reads them at fixed
    addresses until then.
  * ``paged_view``: gather the pool into the per-slot ``(n_slots,
    max_len, ...)`` cache the decode step reads and writes.
  * ``write_token``: scatter each slot's entry at its position back into
    its page.  PyTorch has no ``mode='drop'``: an inactive slot writes to
    the sink page, which no slot's view ever holds, so a vacant slot can
    never clobber a page that belongs to a live request.
  * ``insert_fragment``: copy a prefill fragment (batch 1, ``max_len``
    long) over the slot's whole page set, zero tail included, so a new
    tenant never sees the previous tenant's KV.

Pages are fungible across slots: ``alloc`` hands out the free list LIFO
(reuse is immediate), ``free`` returns a slot's pages.  ``n_pages`` below
``n_slots * pages_per_slot`` overcommits the pool: a free slot is then no
guarantee of free pages, and ``alloc`` raises ``PoolExhausted``.

Runtime elasticity (the memory-pressure governor, ``serve/governor.py``):
``retire_pages`` takes free pages out of circulation, highest ids first,
and releases a contiguous retired tail from the device (the leaves are
rebuilt without it, the sink page kept last); ``restore_pages`` returns
retired pages first and grows fresh zero pages past them.  A release or a
growth moves every page tensor, so the pool counts it in ``moves``: the
engine drops its captured tick when that count changes, and the next tick
captures anew.  A retire that releases nothing leaves every address as it
was and needs no new capture.
"""
from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from .._device import resolve_device, upload
from ..models import lm as LM


class PoolError(RuntimeError):
    """Slot-ownership invariant violated (double alloc).  A real exception,
    not an ``assert``: it guards page aliasing between live requests and
    must hold under ``python -O`` too."""


class PoolExhausted(PoolError):
    """The free list cannot back another slot's ``pages_per_slot`` pages;
    the scheduler's admission catches it and preempts or waits."""


def _leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, dict keys sorted (the
    reference's flatten order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with :func:`_leaves`' leaves replaced, in order,
    by the iterator ``leaves``'."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


@functools.lru_cache(maxsize=None)
def _axes_leaves(cfg) -> tuple:
    """Flattened per-leaf (batch_axis, time_axis), cached per config."""
    return tuple(_leaves(LM.cache_batch_time_axes(cfg)))


def _front(t: torch.Tensor, ba: int, ta: int) -> torch.Tensor:
    """A view of ``t`` with its batch and time axes first."""
    return t.movedim((ba, ta), (0, 1))


def paged_view(cfg, pages, page_table: torch.Tensor):
    """The per-slot contiguous caches from the page pool: a tree shaped
    like ``init_caches(cfg, n_slots, pages_per_slot * page_size)``, in new
    tensors.  ``page_table``: (n_slots, pages_per_slot) int64 page ids on
    the pool's device."""
    flat = page_table.reshape(-1)
    n_slots = page_table.shape[0]
    out = []
    for leaf, (ba, ta) in zip(_leaves(pages), _axes_leaves(cfg)):
        v = _front(leaf, ba, ta).index_select(0, flat)
        v = v.reshape((n_slots, -1) + tuple(v.shape[2:]))
        out.append(v.movedim((0, 1), (ba, ta)))
    return _rebuild(pages, iter(out))


def write_token(cfg, page_size: int, pages, view, page_table: torch.Tensor,
                pos: torch.Tensor, active: torch.Tensor,
                start: int | None = None) -> None:
    """Scatter each slot's cache entry at ``pos`` (B,) from ``view`` (the
    caches the decode step wrote in place) into its page, in place.  An
    inactive slot (``active`` (B,) bool False) writes to the sink page,
    the pool's last, which belongs to no slot.  ``start``: the pool holds
    a mesh rank's block of each slot's positions from ``start``
    (:class:`PagedKVPool`); an entry outside it goes to the sink too."""
    leaves = _leaves(pages)
    axes = _axes_leaves(cfg)
    sink = leaves[0].shape[axes[0][0]] - 1
    if start is not None:
        length = page_table.shape[1] * page_size
        pos = pos - start
        active = active & (pos >= 0) & (pos < length)
        pos = torch.clamp(pos, 0, length - 1)
    page_of = page_table.gather(1, (pos // page_size)[:, None])[:, 0]
    page = torch.where(active, page_of, torch.full_like(page_of, sink))
    off = pos % page_size
    rows = torch.arange(pos.shape[0], device=pos.device)
    for leaf, vleaf, (ba, ta) in zip(leaves, _leaves(view), axes):
        ent = _front(vleaf, ba, ta)[rows, pos]
        _front(leaf, ba, ta).index_put_((page, off), ent.to(leaf.dtype))


def insert_fragment(cfg, page_size: int, pages, fragment,
                    page_row: torch.Tensor) -> None:
    """Copy a prefill fragment (a cache tree with batch 1 and time
    ``pages_per_slot * page_size``) over one slot's pages ``page_row``
    (pages_per_slot,) int64, in place.  The whole region is overwritten,
    the fragment's zero tail included."""
    npr = page_row.shape[0]
    for leaf, fleaf, (ba, ta) in zip(_leaves(pages), _leaves(fragment),
                                     _axes_leaves(cfg)):
        f = _front(fleaf, ba, ta)
        f = f.reshape((npr, page_size) + tuple(f.shape[2:]))
        _front(leaf, ba, ta).index_copy_(0, page_row, f.to(leaf.dtype))


class PagedKVPool:
    """Host-side page allocator over a device-resident cache pool.

    ``pages`` is the device state, ``n_pages + 1`` pages (the last is the
    sink), written in place and rebuilt only when the governor releases a
    retired tail or grows the pool (``moves`` counts those); the page
    table and the free list are host state, so admission decisions never
    touch the device."""

    def __init__(self, cfg, n_slots: int, max_len: int, *,
                 page_size: int = 8, dtype=torch.bfloat16,
                 n_pages: int | None = None, device=None, mesh=None):
        _axes_leaves(cfg)             # fail fast on a layout it cannot page
        from ..sharding import partition as PT
        self.cfg = cfg
        self.n_slots = n_slots
        self.page_size = page_size
        # On a mesh whose model ranks split the positions
        # (``partition.cache_positions_split``), a rank's pages hold its
        # contiguous block of each slot's positions, ``start`` onwards:
        # the slot's length rounds to whole pages a rank, and the view
        # the layers read is that block.  Otherwise a page holds the
        # rank's heads (``lm.init_caches(mesh=)``) of whole positions.
        ms = (mesh.shape.get("model", 1)
              if PT.cache_positions_split(cfg, mesh) else 1)
        pages = -(-max_len // page_size)
        pages = -(-pages // ms) * ms
        self.max_len = pages * page_size
        self.pages_per_slot = pages // ms
        self.start = (mesh.axis_index("model") * (self.max_len // ms)
                      if ms > 1 else None)
        self.n_pages = (n_slots * self.pages_per_slot if n_pages is None
                        else n_pages)
        if self.n_pages < self.pages_per_slot:
            raise ValueError(
                f"n_pages ({self.n_pages}) cannot back even one slot "
                f"({self.pages_per_slot} pages/slot)")
        self.device = resolve_device(device)
        self.pages = LM.init_caches(cfg, self.n_pages + 1, page_size, dtype,
                                    device=self.device, mesh=mesh,
                                    rows=False, positions=False)
        self.page_table = np.zeros((n_slots, self.pages_per_slot), np.int64)
        self.free_pages: List[int] = list(range(self.n_pages))
        self._owned = [False] * n_slots
        # Runtime elasticity: retired pages are out of circulation but may
        # still be on the device until the tail they sit in is free and
        # can be released.  ``moves`` counts rebuilds of the page tensors.
        self.retired: set = set()
        self.moves = 0

    @property
    def n_pages_usable(self) -> int:
        """Pages in circulation: on the device, less the retired ones."""
        return self.n_pages - len(self.retired)

    def page_nbytes(self) -> int:
        """Device bytes of one page across every cache leaf."""
        return self.device_bytes() // (self.n_pages + 1)

    def device_bytes(self) -> int:
        """Device bytes of the page pool right now: ``n_pages`` pages and
        the sink page that inactive slots write to.  Falls when a retired
        tail is released, grows with ``restore_pages``."""
        return sum(t.numel() * t.element_size() for t in _leaves(self.pages))

    def can_alloc(self) -> bool:
        """Whether the free list can back another slot right now."""
        return len(self.free_pages) >= self.pages_per_slot

    # -- runtime shrink and regrow (memory-pressure governor) ----------
    def retire_pages(self, n: int) -> int:
        """Take up to ``n`` free pages out of circulation; → how many.
        Highest ids go first, so the retired set gathers at the pool's
        tail, and a contiguous retired tail is released from the device.
        An owned page is never touched: live requests keep their KV, so
        under pressure the caller preempts (freeing pages) and retires
        again."""
        take = sorted(self.free_pages, reverse=True)[:max(0, int(n))]
        for p in take:
            self.free_pages.remove(p)
            self.retired.add(p)
        self._release_tail()
        return len(take)

    def restore_pages(self, n: int) -> int:
        """Return ``n`` pages to circulation (the regrow rung): retired
        pages still on the device first, then fresh zero pages grown at
        the tail.  → ``n``."""
        n = max(0, int(n))
        back = sorted(self.retired)[:n]
        for p in back:
            self.retired.discard(p)
            self.free_pages.append(p)
        if n > len(back):
            self._grow_pages(n - len(back))
        return n

    def _rebuild_pages(self, n: int, extra: int = 0) -> None:
        """New page tensors holding pages [0, n), ``extra`` zero pages and
        the sink; the old tensors are freed with their last reference."""
        out = []
        for leaf, (ba, _) in zip(_leaves(self.pages), _axes_leaves(self.cfg)):
            f = _front(leaf, ba, ba + 1)
            parts = [f[:n]]
            if extra:
                parts.append(f.new_zeros((extra,) + tuple(f.shape[1:])))
            parts.append(f[-1:])
            out.append(torch.cat(parts).movedim((0, 1), (ba, ba + 1)))
        self.pages = _rebuild(self.pages, iter(out))
        self.moves += 1

    def _release_tail(self) -> None:
        """Release the contiguous retired tail from the device, if any."""
        new_n = self.n_pages
        while (new_n - 1) in self.retired:
            new_n -= 1
        if new_n == self.n_pages:
            return
        for p in range(new_n, self.n_pages):
            self.retired.discard(p)
        self._rebuild_pages(new_n)
        self.n_pages = new_n

    def _grow_pages(self, extra: int) -> None:
        self._rebuild_pages(self.n_pages, extra)
        self.free_pages.extend(range(self.n_pages, self.n_pages + extra))
        self.n_pages += extra

    def alloc(self, slot: int) -> np.ndarray:
        """Claim ``pages_per_slot`` pages for ``slot`` (LIFO reuse)."""
        if self._owned[slot]:
            raise PoolError(f"slot {slot} already owns pages")
        if len(self.free_pages) < self.pages_per_slot:
            raise PoolExhausted(
                f"page pool exhausted: {len(self.free_pages)} free of "
                f"{self.n_pages}, need {self.pages_per_slot}")
        row = [self.free_pages.pop() for _ in range(self.pages_per_slot)]
        self.page_table[slot] = row
        self._owned[slot] = True
        return self.page_table[slot]

    def free(self, slot: int) -> None:
        """Return ``slot``'s pages to the free list and point its row at
        page 0 (after a released tail a stale id would be out of range).
        Freeing a slot that owns nothing is a safe no-op: the retire,
        quarantine and preempt paths may each release a slot."""
        if self._owned[slot]:
            self.free_pages.extend(int(p) for p in self.page_table[slot])
            self._owned[slot] = False
            self.page_table[slot] = 0

    def insert(self, fragment, slot: int) -> None:
        """Write a prefill fragment into ``slot``'s pages, in place."""
        if not self._owned[slot]:
            raise PoolError(f"slot {slot} owns no pages")
        insert_fragment(self.cfg, self.page_size, self.pages, fragment,
                        upload(self.page_table[slot], self.device))
