"""The MoE slice (DeepSeek-V2-Lite: MLA attention + grouped compressed
experts) of the port against the JAX package, on the smoke config.

The reference's weights and packed states cross as numpy arrays
(``repro_torch.convert``), so both packages run the same model on the same
planes.  Tolerances:
  * packing: byte-equal (tables, planes, literal capacity, tiles, stats).
  * layers on the same input (the reference's jitted): the MLA and MoE
    outputs are held to one bf16 ulp of the output's largest magnitude
    (2^-8 relative), which a sum taken in another order, or a bf16 rounding
    that XLA's fusion skips, can move.  The cached MLA paths add the flash
    kernel's f32 sums in another order than the reference's: two ulps.
  * forward logits: dense f32 1e-4; quant/compressed 3e-2, as for Llama
    (the reference's scanned layers are one XLA program, which rounds bf16
    at other places than the port's op-by-op layers).
  * greedy tokens: equal, except from a step where the reference's own
    greedy choice is an exact bf16 tie (see the generate test).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.core.compressed import pack_expert_stack as jpack_expert_stack
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serve import engine as JE
from repro.serve.context import ServeContext as JContext

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core.compressed import PackedLinear, QuantLinear
from repro_torch.core.compressed import pack_expert_stack
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import _build, ops
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as TE
from repro_torch.serve.context import ServeContext

from test_torch_model import state_to_numpy
from test_torch_serve import _prompts

torch.set_num_threads(2)
ARCH = "deepseek-v2-lite-16b"
ATOL = {"dense": 1e-4, "quant": 3e-2, "compressed": 3e-2}
MODES = ("dense", "quant", "compressed")


@pytest.fixture(scope="module")
def models():
    """{mode: (jax params, jax lut, port params, port lut, numpy state)}
    on one seed; the reference packs once per mode."""
    cfg = get_config(ARCH).smoke
    tcfg = tget_config(ARCH).smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    dense_np = jax.tree_util.tree_map(np.asarray, params)
    out = {"dense": (params, None, convert.params_from_numpy(
        dense_np, tcfg, device="cpu"), None, None)}
    for mode in ("quant", "compressed"):
        st = JE.build_serve_params(params, JPolicy(mode=mode,
                                                   min_weight_size=1024),
                                   manifest=False)
        npst = state_to_numpy(st)
        ts = convert.serve_state_from_numpy(
            npst, np.asarray(st.lut) if st.lut is not None else None, tcfg,
            mode=mode, device="cpu")
        out[mode] = (st.params, st.lut, ts.params, ts.lut, (st, npst))
    return cfg, tcfg, out


@pytest.fixture(autouse=True)
def _clear_counts():
    _build.LAUNCH_COUNTS.clear()
    yield
    assert not _build.LAUNCH_COUNTS, "a CPU call launched a kernel"


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(a, np.float32)))
    return t if dtype is None else t.to(dtype)


def _ulps(got, ref, n=1):
    """Equal within n bf16 ulps of the reference's largest magnitude."""
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=n * 2.0 ** -8 * float(np.abs(ref).max()))


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


# -- packing ---------------------------------------------------------------

def _leaves(node, prefix=""):
    if isinstance(node, dict) and "kind" not in node:
        for k in sorted(node):
            yield from _leaves(node[k], f"{prefix}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, node


@pytest.mark.parametrize("mode", ["quant", "compressed"])
def test_stacked_planes_byte_equal(models, mode):
    """The port packs the smoke model (expert leaves (E, N, K) per layer)
    into the reference's planes: per-expert quantization, streams in
    layer-major/expert-minor order, one literal capacity across the whole
    L × E stack of a leaf."""
    cfg, tcfg, out = models
    st, npst = out[mode][4]
    tst = TE.build_serve_params(out["dense"][2], CompressionPolicy(
        mode=mode, min_weight_size=1024), device="cpu")
    assert tst.table == st.table
    assert tst.stats == st.stats
    if mode == "compressed":
        np.testing.assert_array_equal(tst.lut.numpy(), np.asarray(st.lut))
    ref = dict(_leaves(npst))
    n_moe = cfg.n_layers - cfg.first_dense_layers
    got = {}
    for path, leaf in _leaves({k: v for k, v in tst.params.items()
                               if k != "blocks"}):
        got[path] = [leaf]
    for path, _ in _leaves(tst.params["blocks"][0]):
        got["/blocks" + path] = [dict(_leaves(tst.params["blocks"][i]))[path]
                                 for i in range(n_moe)]
    assert sorted(got) == sorted(ref)
    checked = 0
    for path, layers in got.items():
        r = ref[path]
        stacked = path.startswith("/blocks")
        for i, leaf in enumerate(layers):
            def plane(name):
                a = np.asarray(r[name])
                return a[i] if stacked else a
            if isinstance(leaf, PackedLinear):
                assert r["kind"] == "packed", path
                assert (leaf.shape, leaf.tile_n, leaf.tile_k) == (
                    tuple(r["shape"]), r["tile_n"], r["tile_k"]), path
                np.testing.assert_array_equal(
                    leaf.codes.numpy().view(np.uint16), plane("codes"))
                for name in ("literals", "nlit", "scale", "zero"):
                    np.testing.assert_array_equal(
                        getattr(leaf, name).numpy(), plane(name))
                checked += 1
            elif isinstance(leaf, QuantLinear):
                assert r["kind"] == "quant", path
                for name in ("values", "scale", "zero"):
                    np.testing.assert_array_equal(
                        getattr(leaf, name).numpy(), plane(name))
                checked += 1
            else:
                np.testing.assert_array_equal(
                    leaf.numpy(), np.asarray(r)[i] if stacked else r)
    assert checked >= 2
    if mode == "compressed":
        w = tst.params["blocks"][1]["moe"]["experts"]["w_gate"]
        assert w.codes.shape == (cfg.n_experts, 3, 256)    # tile 16 × 64
        assert (w.tile_n, w.tile_k) == (16, 64)
        caps = {tst.params["blocks"][i]["moe"]["experts"]["w_gate"]
                .literals.shape[2] for i in range(n_moe)}
        assert len(caps) == 1                             # one cap per leaf


@pytest.mark.parametrize("tile", ["auto", None])
def test_pack_expert_stack_byte_equal(tile):
    rng = np.random.default_rng(3)
    ws = [rng.laplace(0.0, 0.02, size=(48, 64)).astype(np.float32)
          for _ in range(5)]
    jpl, jlut = jpack_expert_stack(ws, tile=tile)
    tpl, tlut = pack_expert_stack([torch.from_numpy(w) for w in ws],
                                  tile=tile)
    np.testing.assert_array_equal(tlut.numpy(), np.asarray(jlut))
    assert (tpl.shape, tpl.tile_n, tpl.tile_k) == (
        tuple(jpl.shape), jpl.tile_n, jpl.tile_k)
    np.testing.assert_array_equal(tpl.codes.numpy().view(np.uint16),
                                  np.asarray(jpl.codes))
    for name in ("literals", "nlit", "scale", "zero"):
        np.testing.assert_array_equal(getattr(tpl, name).numpy(),
                                      np.asarray(getattr(jpl, name)))
    # any leading dims decode: the stack materializes expert by expert
    np.testing.assert_array_equal(
        tpl.materialize(tlut, torch.float32).numpy(),
        np.asarray(jpl.materialize(jlut, jnp.float32)))


# -- layers ------------------------------------------------------------------

def _block_input(cfg, mode, seed, t=11):
    """A normed hidden state (3, t, d) from a seed, in the mode's
    activation dtype (bf16 once the embedding is int8), the same in both
    packages."""
    x = np.random.default_rng(seed).standard_normal((3, t, cfg.d_model))
    if mode == "dense":
        return jnp.asarray(x, jnp.float32), _t(x)
    jx = jnp.asarray(x, jnp.bfloat16)
    return jx, _t(jx, torch.bfloat16)


@pytest.mark.parametrize("mode", MODES)
def test_mla_matches_reference(models, mode):
    """apply_mla on the same input: without a cache; a chunked prefill into
    a longer cache (the flash kernel with Dv ≠ Dqk and q_offset); then one
    absorbed decode step over the cache."""
    cfg, tcfg, out = models
    jp, jlut, tp, tlut, _ = out[mode]
    jx, tx = _block_input(cfg, mode, 1)
    jbp, tbp = _layer(jp["blocks"], 0)["attn"], tp["blocks"][0]["attn"]
    mla = jax.jit(lambda p, x, c, lut, pos: JL.apply_mla(
        p, x, cfg, lut=lut, cache=c, pos=pos), static_argnums=4)
    ja, _ = mla(jbp, jx, None, jlut, None)
    ta, _ = TL.apply_mla(tbp, tx, tcfg, lut=tlut)
    _ulps(ta, ja, 1)
    jc = JL.init_mla_cache(cfg, 3, 16)
    tc = TL.init_mla_cache(tcfg, 3, 16)
    ja, jc = mla(jbp, jx, jc, jlut, 0)
    ta, tc = TL.apply_mla(tbp, tx, tcfg, lut=tlut, cache=tc, pos=0)
    _ulps(ta, ja, 2)
    for key in ("ckv", "krope"):
        _ulps(tc[key], jc[key], 1)
    jy, _ = mla(jbp, jx[:, -1:], jc, jlut, 11)
    ty, _ = TL.apply_mla(tbp, tx[:, -1:], tcfg, lut=tlut, cache=tc, pos=11)
    _ulps(ty, jy, 2)


@pytest.mark.parametrize("mode", MODES)
def test_moe_matches_reference(models, mode):
    """apply_moe on the same input: routing (top-k order), capacity drops
    (33 tokens × top-2 over 8 experts at capacity 11), the grouped expert
    matmuls and the combine."""
    cfg, tcfg, out = models
    jp, jlut, tp, tlut, _ = out[mode]
    jx, tx = _block_input(cfg, mode, 2)
    jbp, tbp = _layer(jp["blocks"], 1)["moe"], tp["blocks"][1]["moe"]
    jy, jaux, jids = jax.jit(lambda p, x, lut: JL.apply_moe(
        p, x, cfg, lut=lut, with_routing=True))(jbp, jx, jlut)
    ops.DISPATCH_COUNTS.clear()
    TL.MATERIALIZE_COUNTS.clear()
    ty, taux, tids = TL.apply_moe(tbp, tx, tcfg, lut=tlut, with_routing=True)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    counts = np.bincount(np.asarray(jids).reshape(-1), minlength=8)
    assert counts.max() > TL._capacity(33, 2, 8, cfg.capacity_factor)
    _ulps(ty, jy, 1)
    # the aux loss averages probabilities from the bf16 router logits,
    # which the jitted reference may keep unrounded inside a fusion
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-3)
    if mode == "compressed":
        assert ops.DISPATCH_COUNTS["grouped_fused"] == 3
        assert TL.MATERIALIZE_COUNTS["packed_stacked"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_moe_drops_match_reference(models, mode):
    """apply_moe at capacity factor 0.25 (33 tokens × top-2 over 8
    experts at capacity 4: most choices dropped, each to the scatter's
    cut-off column) against the reference at the same capacity."""
    cfg, tcfg, out = models
    cfg = dataclasses.replace(cfg, capacity_factor=0.25)
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.25)
    jp, jlut, tp, tlut, _ = out[mode]
    jx, tx = _block_input(cfg, mode, 2)
    jbp, tbp = _layer(jp["blocks"], 1)["moe"], tp["blocks"][1]["moe"]
    jy, _, jids = jax.jit(lambda p, x, lut: JL.apply_moe(
        p, x, cfg, lut=lut, with_routing=True))(jbp, jx, jlut)
    ty, _, tids = TL.apply_moe(tbp, tx, tcfg, lut=tlut, with_routing=True)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    cap = TL._capacity(33, 2, 8, 0.25)
    counts = np.bincount(np.asarray(jids).reshape(-1), minlength=8)
    assert cap == 4 and np.maximum(counts - cap, 0).sum() > 33
    _ulps(ty, jy, 1)


@pytest.mark.parametrize("n_tok,k,e,cap", [
    (4, 6, 64, 4),          # decode: an expert takes each token once
    (33, 2, 8, 6), (33, 2, 8, 4), (700, 6, 64, 60), (97, 3, 5, 4)])
def test_dispatch_tables_drop_by_scatter(n_tok, k, e, cap):
    """The dispatch tables equal a loop that places each choice kept
    within capacity, on random routings (distinct experts per token)."""
    g = torch.Generator().manual_seed(n_tok * e)
    ids = torch.argsort(torch.rand(n_tok, e, generator=g), dim=1)[:, :k]
    gates = torch.rand(n_tok, k, generator=g)
    slot = TL.expert_slots(ids, torch.nn.functional.one_hot(ids, e))
    table, gtable = TL.dispatch_tables(ids, slot, gates, cap, e)
    want = torch.full((e, cap), n_tok, dtype=torch.long)
    gwant = torch.zeros((e, cap))
    for i, (ex, s) in enumerate(zip(ids.reshape(-1).tolist(),
                                    slot.tolist())):
        if s < cap:
            want[ex, s] = i // k
            gwant[ex, s] = gates.reshape(-1)[i]
    assert torch.equal(table, want) and torch.equal(gtable, gwant)
    assert bool((slot >= cap).any()) == (n_tok > cap)     # drops


def test_routing_ties_take_the_lower_expert():
    """Equal router rows give equal probabilities: like lax.top_k, the
    port's routing takes the lower expert index first."""
    cfg = get_config(ARCH).smoke
    tcfg = tget_config(ARCH).smoke
    rng = np.random.default_rng(4)
    router = rng.standard_normal((8, 64)).astype(np.float32)
    router[5] = router[2]
    router[7] = router[2]
    x = rng.standard_normal((1, 6, 64)).astype(np.float32)
    x[0, :3] = router[2] * 3            # tokens whose top experts tie
    jp = JLM.init_lm(jax.random.PRNGKey(1), cfg, jnp.float32)
    jbp = dict(_layer(jp["blocks"], 0)["moe"], router=jnp.asarray(router))
    tbp = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu"
    )["blocks"][0]["moe"]
    tbp = dict(tbp, router=torch.from_numpy(router))
    _, _, jids = JL.apply_moe(jbp, jnp.asarray(x), cfg, with_routing=True)
    _, _, tids = TL.apply_moe(tbp, torch.from_numpy(x), tcfg,
                              with_routing=True)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert (np.asarray(jids)[:3] == [2, 5]).all()


# -- model -------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_forward_logits_match(models, mode):
    """Logits of a forward pass against the reference's jitted forward.  A
    token whose top-k expert set differs (a bf16 near-tie at the top-k
    boundary of the router, which XLA's fusion rounds elsewhere) takes
    other experts and is compared only through the routing count: at most
    one of the 33 tokens per layer."""
    cfg, tcfg, out = models
    jp, jlut, tp, tlut, _ = out[mode]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 11))
    jl, _, jaux, jroute = jax.jit(lambda p, t, lut: JLM.forward(
        p, cfg, t, lut=lut, return_routing=True))(
        jp, jnp.asarray(toks, jnp.int32), jlut)
    tl, _, taux, troute = TLM.forward(tp, tcfg, torch.from_numpy(toks),
                                      lut=tlut, return_routing=True)
    jl = np.asarray(jl, np.float32)
    assert tl.shape == jl.shape == (3, 11, cfg.vocab_size)
    assert troute.shape == (cfg.n_layers - 1, 33, cfg.top_k)
    differs = (np.sort(troute.numpy(), -1)
               != np.sort(np.asarray(jroute), -1)).any(-1)   # (L, 33)
    assert differs.sum(axis=1).max() <= 1, differs.sum(axis=1)
    ok = ~differs.any(axis=0).reshape(3, 11)
    np.testing.assert_allclose(tl.float().numpy()[ok], jl[ok], rtol=0,
                               atol=ATOL[mode])
    if not differs.any():       # the aux loss counts every token's route
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_forward_under_the_reference_routing(models, mode):
    """Given the reference's expert ids (``routing``), the port routes
    every token as the reference did, so every token's logits, those of
    near-tie tokens too, come within the tolerance."""
    cfg, tcfg, out = models
    jp, jlut, tp, tlut, _ = out[mode]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 11))
    jl, _, _, jroute = jax.jit(lambda p, t, lut: JLM.forward(
        p, cfg, t, lut=lut, return_routing=True))(
        jp, jnp.asarray(toks, jnp.int32), jlut)
    route = torch.from_numpy(np.array(jroute, np.int64))
    tl, _, _, troute = TLM.forward(tp, tcfg, torch.from_numpy(toks),
                                   lut=tlut, return_routing=True,
                                   routing=route)
    assert torch.equal(troute, route)
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl, np.float32), rtol=0,
                               atol=ATOL[mode])


def test_moe_given_its_own_routing_is_unchanged(models):
    """apply_moe given the expert ids it chose itself computes the same
    output bit for bit; given others, it keeps those within capacity."""
    cfg, tcfg, out = models
    _, _, tp, tlut, _ = out["compressed"]
    _, tx = _block_input(cfg, "compressed", 2)
    tbp = tp["blocks"][1]["moe"]
    y, aux, ids = TL.apply_moe(tbp, tx, tcfg, lut=tlut, with_routing=True)
    y2, aux2, ids2 = TL.apply_moe(tbp, tx, tcfg, lut=tlut,
                                  with_routing=True, expert_ids=ids)
    assert torch.equal(y2, y) and torch.equal(ids2, ids) and aux2 == aux
    flipped = ids.flip(0)               # another routing of the same tokens
    y3, _, ids3 = TL.apply_moe(tbp, tx, tcfg, lut=tlut, with_routing=True,
                               expert_ids=flipped)
    assert torch.equal(ids3, flipped) and not torch.equal(y3, y)


def _reference_greedy(jp, cfg, jlut, toks, n):
    """The reference's greedy tokens and each step's logits, from its
    jitted prefill and decode-step functions (what ``generate`` runs)."""
    prefill, decode_step = JE.make_serve_fns(cfg)
    t0 = toks.shape[1]
    caches = JLM.init_caches(cfg, toks.shape[0], t0 + n)
    logits, caches = prefill(jp, jlut, {"tokens": jnp.asarray(toks)}, caches)
    tokens, steps = [], []
    for i in range(n):
        steps.append(np.asarray(logits, np.float32))
        tokens.append(steps[-1].argmax(-1))
        if i < n - 1:
            logits, caches = decode_step(jp, jlut,
                                         jnp.asarray(tokens[-1][:, None]),
                                         caches, t0 + i)
    return np.stack(tokens, axis=1), steps


@pytest.mark.parametrize("mode", MODES)
def test_generate_tokens_match_reference(models, mode):
    """Greedy tokens for 3 left-padded prompts × 8 new tokens; compressed
    expert planes are never materialized, MLA's wkv_b once per layer per
    forward (the absorb, as in the reference).

    The random smoke model's bf16 logits are flat, and the reference's own
    greedy choice can be an exact bf16 tie, which a one-ulp difference in
    the port's logits (well inside ATOL) resolves the other way.  So a row
    may differ only from a step where the reference's logits give the
    port's token the same value as its own; such rows are listed in
    ROADMAP.md (queue 3)."""
    cfg, tcfg, out = models
    jp, jlut, tp, tlut, _ = out[mode]
    toks = _prompts(cfg.vocab_size)
    t0 = toks.shape[1]
    ref = np.asarray(JE.generate(jp, cfg, jnp.asarray(toks),
                                 ctx=JContext(cfg=cfg, lut=jlut),
                                 max_new=8))
    TL.MATERIALIZE_COUNTS.clear()
    got = TE.generate(tp, tcfg, torch.from_numpy(toks),
                      ctx=ServeContext(tcfg, lut=tlut, device="cpu"),
                      max_new=8).numpy()
    np.testing.assert_array_equal(got[:, :t0], toks)
    if mode == "compressed":
        assert TL.MATERIALIZE_COUNTS["packed_stacked"] == 0
        assert TL.MATERIALIZE_COUNTS["packed"] == 8 * cfg.n_layers
    if np.array_equal(got, ref):
        return
    tokens, steps = _reference_greedy(jp, cfg, jlut, toks, 8)
    np.testing.assert_array_equal(tokens, ref[:, t0:])
    for r in np.nonzero((got != ref).any(axis=1))[0]:
        s = int(np.argmax(got[r, t0:] != ref[r, t0:]))
        logits = steps[s][r]
        assert logits[got[r, t0 + s]] == logits[ref[r, t0 + s]], (
            f"row {r} step {s}: port token {got[r, t0 + s]} is not tied "
            f"with the reference's {ref[r, t0 + s]}")


def test_caches_and_entry_points():
    tcfg = tget_config(ARCH).smoke
    c = TLM.init_caches(tcfg, 2, 9, device="cpu")
    assert len(c["first"]) == 1 and len(c["blocks"]) == 2
    assert c["blocks"][0]["ckv"].shape == (2, 9, tcfg.kv_lora_rank)
    assert c["blocks"][0]["krope"].shape == (2, 9, tcfg.qk_rope_head_dim)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TLM.init_lm(tcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TLM.init_caches(tcfg, 1, 4)
