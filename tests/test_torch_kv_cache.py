"""The paged KV pool of the port against the JAX package's, on the CPU.

``cache_batch_time_axes`` must find the reference's axes (less the
reference's stacked layer axis); ``paged_view`` and ``write_token`` must
give the reference's views and pages on the same numpy contents, bit for
bit (they move bytes, no arithmetic); ``insert_fragment`` must overwrite a
slot's whole region; and the allocator keeps the reference's ownership
rules.  Inactive slots write to the sink page (the pool's last), never to
a page any slot's view holds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.models import lm as JLM
from repro.serve import kv_cache as JKV

from repro_torch.configs import get_config as tget_config
from repro_torch.models import lm as TLM
from repro_torch.serve import kv_cache as KV

ARCHS = ("llama3.2-1b", "deepseek-v2-lite-16b")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_time_axes_match_reference(arch):
    """The port's per-layer leaves have the reference's axes, less its
    leading layer axis on the stacked ``blocks``; ``first`` is a list of
    per-layer trees in both."""
    ref = JLM.cache_batch_time_axes(get_config(arch).smoke)
    got = TLM.cache_batch_time_axes(tget_config(arch).smoke)
    for layer in got["blocks"]:
        assert {k: (b + 1, t + 1) for k, (b, t) in layer.items()} \
            == ref["blocks"]
    assert got.get("first", []) == ref.get("first", [])
    assert {l for layer in got["blocks"] for l in layer.values()} \
        == {(0, 1)}


def test_cache_batch_time_axes_rejects_ambiguous_leaves(monkeypatch):
    """A leaf with no time axis (a recurrent state) cannot be paged."""
    tcfg = tget_config("llama3.2-1b").smoke

    def no_time(cfg, batch, max_len, dtype=torch.bfloat16, device=None):
        return {"blocks": [{"state": torch.zeros((batch, 4), device=device)}]}

    monkeypatch.setattr(TLM, "init_caches", no_time)
    with pytest.raises(ValueError, match="unambiguous"):
        TLM.cache_batch_time_axes(tcfg)


def _filled(pool, seed):
    """Random bf16 contents in every page of ``pool`` (the sink too)."""
    g = torch.Generator().manual_seed(seed)
    for t in KV._leaves(pool.pages):
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))


def _ref_pages(cfg, pool):
    """The reference's stacked pool with the port pool's pages (its sink
    page left out): blocks (L, P, page, ...)."""
    leaves = KV._leaves(pool.pages)
    ref = JLM.init_caches(cfg, pool.n_pages, pool.page_size)
    flat, treedef = jax.tree_util.tree_flatten(ref)
    # the reference's leaves in its flatten order: blocks' k then v (or
    # ckv then krope) stacked over layers, then first's per layer
    n_moe = len(pool.pages["blocks"])
    per = len(pool.pages["blocks"][0])
    out = []
    for j in range(per):
        out.append(jnp.asarray(np.stack(
            [leaves[i * per + j][:pool.n_pages].float().numpy()
             for i in range(n_moe)]), flat[0].dtype))
    out.extend(jnp.asarray(l[:pool.n_pages].float().numpy(), flat[0].dtype)
               for l in leaves[n_moe * per:])
    return treedef.unflatten(out)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_view_and_write_match_reference(arch):
    """On the same page contents and page table: the same per-slot view,
    and after write_token (one slot inactive) the same pages, with the
    port's sink page as the reference's dropped write."""
    cfg, tcfg = get_config(arch).smoke, tget_config(arch).smoke
    pool = KV.PagedKVPool(tcfg, 3, 16, page_size=4, device="cpu")
    _filled(pool, 0)
    rng = np.random.default_rng(1)
    table = rng.permutation(pool.n_pages).reshape(3, -1).astype(np.int64)
    jpages = _ref_pages(cfg, pool)
    pt = torch.from_numpy(table)
    view = KV.paged_view(tcfg, pool.pages, pt)
    jview = JKV.paged_view(cfg, jpages, jnp.asarray(table, jnp.int32))
    jv = jax.tree_util.tree_leaves(jview)
    tv = KV._leaves(view)
    n_moe, per = len(view["blocks"]), len(view["blocks"][0])
    for j in range(per):
        got = np.stack([tv[i * per + j].float().numpy()
                        for i in range(n_moe)])
        np.testing.assert_array_equal(got, _np(jv[j]))
    for a, b in zip(tv[n_moe * per:], jv[per:]):
        np.testing.assert_array_equal(a.float().numpy(), _np(b))
    # new entries at each slot's position, as a decode step writes them
    pos = np.array([5, 0, 15])
    active = np.array([True, False, True])
    g = torch.Generator().manual_seed(2)
    for t in tv:
        t[torch.arange(3), torch.from_numpy(pos)] = torch.randn(
            (3,) + tuple(t.shape[2:]), generator=g).to(t.dtype)
    jview = _ref_pages_like(jview, tv, n_moe, per)
    sink_before = [l[-1].clone() for l in KV._leaves(pool.pages)]
    KV.write_token(tcfg, pool.page_size, pool.pages, view, pt,
                   torch.from_numpy(pos), torch.from_numpy(active))
    jnew = JKV.write_token(cfg, pool.page_size, jpages, jview,
                           jnp.asarray(table, jnp.int32),
                           jnp.asarray(pos, jnp.int32), jnp.asarray(active))
    want = _ref_pages(cfg, pool)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_array_equal(_np(a), _np(b))
    # the inactive slot's entry (position 0) went to the sink page
    for leaf, before, vleaf in zip(KV._leaves(pool.pages), sink_before, tv):
        assert torch.equal(leaf[-1, 0], vleaf[1, 0])
        assert torch.equal(leaf[-1, 1:], before[1:])


def _ref_pages_like(jview, tv, n_moe, per):
    """The port's view tensors as the reference's view tree."""
    flat, treedef = jax.tree_util.tree_flatten(jview)
    out = [jnp.asarray(np.stack([tv[i * per + j].float().numpy()
                                 for i in range(n_moe)]), flat[0].dtype)
           for j in range(per)]
    out.extend(jnp.asarray(t.float().numpy(), flat[0].dtype)
               for t in tv[n_moe * per:])
    return treedef.unflatten(out)


def test_write_token_leaves_other_pages_untouched():
    """Only the active slots' pages at their (page, offset) change, and
    the sink: every page of an inactive slot and every free page keeps
    its bytes."""
    tcfg = tget_config("llama3.2-1b").smoke
    pool = KV.PagedKVPool(tcfg, 3, 16, page_size=4, n_pages=14,
                          device="cpu")
    _filled(pool, 3)
    for slot in range(3):
        pool.alloc(slot)
    before = [t.clone() for t in KV._leaves(pool.pages)]
    pt = torch.from_numpy(pool.page_table)
    view = KV.paged_view(tcfg, pool.pages, pt)
    for t in KV._leaves(view):
        t.fill_(7.0)
    pos = torch.tensor([6, 9, 13])
    active = torch.tensor([True, False, True])
    KV.write_token(tcfg, pool.page_size, pool.pages, view, pt, pos, active)
    changed = {(int(pool.page_table[s, p // 4]), p % 4)
               for s, p in ((0, 6), (2, 13))}
    for t, b in zip(KV._leaves(pool.pages), before):
        for page in range(pool.n_pages):
            for off in range(4):
                if (page, off) in changed:
                    assert bool((t[page, off] == 7.0).all())
                else:
                    assert torch.equal(t[page, off], b[page, off]), (page,
                                                                     off)
        assert bool((t[-1, 9 % 4] == 7.0).all())     # the sink took slot 1


def test_insert_overwrites_the_whole_region():
    """A fragment inserted into a reused slot is exactly what the slot's
    view holds afterwards, its zero tail included (no stale KV)."""
    tcfg = tget_config("deepseek-v2-lite-16b").smoke
    pool = KV.PagedKVPool(tcfg, 2, 12, page_size=4, device="cpu")
    _filled(pool, 4)
    frag = TLM.init_caches(tcfg, 1, pool.max_len, device="cpu")
    g = torch.Generator().manual_seed(5)
    for t in KV._leaves(frag):
        t[:, :5] = torch.randn((1, 5) + tuple(t.shape[2:]),
                               generator=g).to(t.dtype)
    pool.alloc(1)
    pool.insert(frag, 1)
    view = KV.paged_view(tcfg, pool.pages, torch.from_numpy(pool.page_table))
    for v, f in zip(KV._leaves(view), KV._leaves(frag)):
        assert torch.equal(v[1], f[0])
        assert bool((v[1, 5:] == 0).all())


def test_pool_alloc_free_invariants():
    tcfg = tget_config("llama3.2-1b").smoke
    pool = KV.PagedKVPool(tcfg, 2, 16, page_size=8, device="cpu")
    assert pool.max_len == 16 and pool.pages_per_slot == 2
    row = list(pool.alloc(0))
    assert row == [3, 2]                         # LIFO off the free list
    with pytest.raises(KV.PoolError, match="already owns"):
        pool.alloc(0)                            # double alloc
    n_free = len(pool.free_pages)
    pool.free(1)                                 # never allocated: no-op
    assert len(pool.free_pages) == n_free
    pool.free(0)
    assert len(pool.free_pages) == pool.n_pages
    assert (pool.page_table[0] == 0).all()       # the vacant row: page 0
    assert sorted(pool.alloc(1)) == sorted(row)  # reuse is immediate
    with pytest.raises(KV.PoolError, match="owns no pages"):
        pool.insert(TLM.init_caches(tcfg, 1, 16, device="cpu"), 0)
    # the sink page is device memory but no allocator id
    assert pool.device_bytes() == (pool.n_pages + 1) * pool.page_nbytes()
    assert pool.page_nbytes() == (tcfg.n_layers * 2 * 8 * tcfg.n_kv_heads
                                  * tcfg.resolved_head_dim * 2)
    # overcommit: 2 pages back only one slot
    pool = KV.PagedKVPool(tcfg, 2, 16, page_size=8, n_pages=2, device="cpu")
    pool.alloc(0)
    assert not pool.can_alloc()
    with pytest.raises(KV.PoolExhausted, match="exhausted"):
        pool.alloc(1)
    with pytest.raises(ValueError, match="cannot back even one slot"):
        KV.PagedKVPool(tcfg, 2, 16, page_size=8, n_pages=1, device="cpu")


def test_max_len_rounds_up_to_pages():
    tcfg = tget_config("llama3.2-1b").smoke
    pool = KV.PagedKVPool(tcfg, 2, 13, page_size=4, device="cpu")
    assert pool.max_len == 16 and pool.n_pages == 8
    assert KV._leaves(pool.pages)[0].shape[:2] == (9, 4)
