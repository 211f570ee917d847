"""Serving on a device mesh at the reference's shardings: each rank's share
of the caches, the batch's rows and the vocab, on the CPU.

Spawned gloo ranks (``launch.mesh.spawn``, one spawn per mesh shape) run
``tests/torch_mesh_serve_worker.py`` on the port's smoke models (random
weights from a seed, vocab 212 so that the vocab rows split over 2 and 4
model ranks), each rank on its share (``partition.place_params``,
``lm.init_caches(mesh=)``):

  * (1, 2), Llama (kv heads 2: the heads path) and seamless: tokens and
    every step's logits bitwise one process's;
  * (1, 4), Llama (kv heads 2 on 4 ranks: the positions path): attention
    calls within ATTN_ULPS bf16 ulps of one process's, logits within
    LOGIT_ATOL, tokens under the exact-tie rule; the engine's completions
    bitwise ``generate``'s on the same mesh;
  * (2, 2), Llama: each data rank's rows bitwise one process serving
    those rows alone, and the whole batch under the tie rule; DeepSeek
    (MLA's latents by positions, the local-routing MoE on the rank's
    rows) within the bounds of the positions path;
  * memory: each rank's caches hold exactly the bytes of
    ``make_cache_specs``' share (the reference's rules) and its int8
    embedding and head the serve specs' vocab band; the vocab-parallel
    lookup is bitwise the whole table's.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.compressed import QuantLinear
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import _build, ops
from repro_torch.launch import mesh as M
from repro_torch.launch.dryrun import sharded_bytes
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.serve import engine as TE
from repro_torch.sharding import partition as PT

import torch_mesh_serve_worker as W

torch.set_num_threads(2)
LLAMA, DEEPSEEK, SEAMLESS = ("llama3.2-1b", "deepseek-v2-lite-16b",
                             "seamless-m4t-medium")
VOCAB = 212                 # divides 2 and 4 model ranks
BATCH, T0, MAX_NEW = 4, 6, 6
# attention on a block of positions merges the blocks' softmax partials
# over the model ranks: within this many bf16 ulps of one process's
# largest magnitude
ATTN_ULPS = 2
# logits of the positions path and of a data split against one process
# serving the whole batch: the card-vs-CPU bound (chip_smoke.py)
LOGIT_ATOL = 5e-2


@pytest.fixture(autouse=True)
def _clear_counts():
    ops.DISPATCH_COUNTS.clear()
    _build.LAUNCH_COUNTS.clear()
    yield
    assert not _build.LAUNCH_COUNTS, "a CPU call launched a kernel"


@functools.lru_cache(maxsize=None)
def _served(arch, model_shards):
    """The arch's smoke model at VOCAB from seed 0, compressed for
    ``model_shards`` model ranks (dropless MoE capacity)."""
    cfg = dataclasses.replace(get_config(arch).smoke, vocab_size=VOCAB)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.top_k)
    init = ED.init_encdec if cfg.family == "encdec" else LM.init_lm
    st = TE.build_serve_params(init(cfg, seed=0, device="cpu"),
                               CompressionPolicy(mode="compressed",
                                                 min_weight_size=1024),
                               model_shards=model_shards, device="cpu")
    return cfg, st


def _tokens(seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(1, VOCAB, (BATCH, T0)))


def _x(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def _cases(shape):
    ms = shape[1]
    lm_cfg, lm = _served(LLAMA, ms)
    toks = _tokens()
    cases = {"generate": {"llama": (lm_cfg, lm.params, lm.lut, toks,
                                    MAX_NEW)}}
    first = lm.params["blocks"][0]["attn"]
    cases["attention"] = {"llama attn": (
        lm_cfg, first, lm.lut, _x((BATCH, T0 + 1, lm_cfg.d_model), 5), T0)}
    if shape == (1, 2):
        ed_cfg, ed = _served(SEAMLESS, ms)
        cases["encdec"] = {"seamless": (
            ed_cfg, ed.params, ed.lut, toks, MAX_NEW,
            _x((BATCH, 8, ed_cfg.d_model), 6))}
        table = QuantLinear(
            torch.from_numpy(np.random.default_rng(7).integers(
                0, 256, (VOCAB, 16), dtype=np.uint8)),
            torch.rand(VOCAB, 1, generator=torch.Generator().manual_seed(8)),
            torch.full((VOCAB, 1), 127.0))
        cases["embed"] = {"embed": (table, torch.from_numpy(
            np.random.default_rng(9).integers(0, VOCAB, (3, 5))))}
    if shape == (1, 4):
        prompts = [np.asarray(r) for r in toks[:3, 2:].numpy()]
        cases["engine"] = {"engine": (lm_cfg, lm.params, lm.lut, prompts,
                                      MAX_NEW)}
    if shape == (2, 2):
        ds_cfg, ds = _served(DEEPSEEK, ms)
        local = dataclasses.replace(ds_cfg, moe_local_dispatch=True)
        cases["generate"]["deepseek"] = (local, ds.params, ds.lut, toks,
                                         MAX_NEW)
        cases["attention"]["deepseek mla"] = (
            local, ds.params["first_blocks"][0]["attn"], ds.lut,
            _x((BATCH, T0 + 1, ds_cfg.d_model), 10), T0)
    return cases


@functools.lru_cache(maxsize=None)
def _run(shape):
    cases = _cases(shape)
    outs = M.spawn(W.run, shape[0] * shape[1], shape, cases, device="cpu")
    return cases, outs


SHAPES = [(1, 2), (1, 4), (2, 2)]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"mesh{s}")
def ran(request):
    return (request.param,) + _run(request.param)


def _one(cfg, st_or_params, lut, toks, max_new=MAX_NEW, enc=None):
    """One process's eager loop (the worker's, without a mesh)."""
    return W.eager(dataclasses.replace(cfg, moe_local_dispatch=False),
                   st_or_params, lut, toks, max_new, None, enc)


def _parting(got, want, got_logits, want_logits) -> list:
    """Rows whose tokens part from ``want`` away from an exact tie: a row
    may differ only from a step where one run's logits give both tokens
    the same value (``tests/test_torch_moe.py``'s rule)."""
    bad = []
    for r in range(got.shape[0]):
        diff = torch.nonzero(got[r] != want[r])
        if not diff.numel():
            continue
        s = int(diff[0])
        a, b = int(got[r, s]), int(want[r, s])
        if not any(bool(lg[s, r, a] == lg[s, r, b])
                   for lg in (got_logits, want_logits)):
            bad.append((r, s))
    return bad


def _ulps_close(got, want, ulps):
    want = want.float()
    atol = ulps * 2.0 ** -8 * float(want.abs().max())
    return float((got.float() - want).abs().max()) <= atol


def test_rank_caches_hold_the_reference_share(ran):
    """Each rank's caches total exactly the bytes of its share under the
    reference's ``make_cache_specs`` (batch rows on data, K/V by heads or
    by positions, MLA's latents by positions), and its int8 embedding
    the serve specs' vocab band."""
    shape, cases, outs = ran
    mesh = M.AbstractMesh(shape, ("data", "model"))
    for key, (cfg, params, _, toks, max_new) in cases["generate"].items():
        whole = LM.init_caches(cfg, toks.shape[0], toks.shape[1] + max_new,
                               device="meta")
        want = sharded_bytes(whole, PT.make_cache_specs(whole, mesh), mesh)
        assert want < W.nbytes(whole)
        specs = PT.make_param_specs(params, mesh, PT.ShardingConfig(
            mode="serve", fsdp_weights=False))
        for out in outs:
            o = out[key]
            assert o["cache_bytes"] == want, (key, o["cache_shapes"])
            for name, got in o["vocab_bytes"].items():
                assert got == sharded_bytes(params[name], specs[name],
                                            mesh), name
                assert got * shape[1] == W.nbytes(params[name])


def test_heads_path_is_bitwise_one_process():
    """(1, 2): Llama's kv heads divide the model ranks, so q/k/v are the
    rank's heads over its cache of them: tokens and every step's logits
    bitwise one process's; seamless (its cross K/V by heads too) through
    ``make_serve_fns``."""
    cases, outs = _run((1, 2))
    cfg, params, lut, toks, max_new = cases["generate"]["llama"]
    one_toks, one_logits = _one(cfg, params, lut, toks)
    for out in outs:
        o = out["llama"]
        assert o["rows"] is None
        assert torch.equal(o["tokens"][:, T0:], one_toks)
        assert torch.equal(o["eager"][0], one_toks)
        assert torch.equal(o["eager"][1], one_logits)
        assert o["dispatch"].get("fused_shard_map", 0) > 0
        assert o["dispatch"].get("dequant_shard_map", 0) > 0
        assert not o["dispatch"].get("unfused")
    cfg, params, lut, toks, max_new, enc = cases["encdec"]["seamless"]
    one = _one(cfg, params, lut, toks, max_new, enc)
    for out in outs:
        assert torch.equal(out["seamless"][0], one[0])
        assert torch.equal(out["seamless"][1], one[1])


def test_vocab_parallel_embed_is_the_whole_lookup():
    cases, outs = _run((1, 2))
    table, ids = cases["embed"]["embed"]
    from repro_torch.models import layers as L
    want = L.embed(table, ids)
    for out in outs:
        got, held, axes = out["embed"]
        assert axes == ("model",) and held * 2 == W.nbytes(table)
        assert torch.equal(got, want)


def test_attention_calls_within_ulps(ran):
    """A single attention call on the rank's share (prefill into its
    cache, then a decode step) against one process's: bitwise on the
    heads path, within ATTN_ULPS where the ranks hold blocks of
    positions (GQA on (1, 4), MLA)."""
    shape, cases, outs = ran
    for key, (cfg, layer, lut, x, t0) in cases["attention"].items():
        want = W.attention_calls(cfg, layer, lut, x, t0)
        heads = not cfg.mla and cfg.n_kv_heads % shape[1] == 0
        for out in outs:
            for got, ref in zip(out[key], want):
                assert got.shape == ref.shape and got.dtype == ref.dtype
                if heads:
                    assert torch.equal(got, ref), key
                else:
                    assert _ulps_close(got, ref, ATTN_ULPS), key


def test_positions_path_within_bounds():
    """(1, 4): Llama's 2 kv heads on 4 model ranks, each holding a block
    of the cache's positions; the decode partials merged over model."""
    cases, outs = _run((1, 4))
    cfg, params, lut, toks, _ = cases["generate"]["llama"]
    one_toks, one_logits = _one(cfg, params, lut, toks)
    for out in outs:
        o = out["llama"]
        assert all(s[1] * 4 == T0 + MAX_NEW for s in o["cache_shapes"])
        got_toks, got_logits = o["eager"]
        np.testing.assert_allclose(got_logits[0].float().numpy(),
                                   one_logits[0].float().numpy(), rtol=0,
                                   atol=LOGIT_ATOL)
        assert not _parting(got_toks, one_toks, got_logits, one_logits)
        assert torch.equal(o["tokens"], outs[0]["llama"]["tokens"])
        assert not _parting(o["tokens"][:, T0:], one_toks, got_logits,
                            one_logits)


def test_engine_on_positions_split_matches_generate():
    """The engine's pages hold each rank's block of every slot's positions
    (``PagedKVPool(mesh=)``): its completions are ``generate``'s on the
    same mesh and cache length, bit for bit."""
    _, outs = _run((1, 4))
    for out in outs:
        got, alone, pool_bytes, pages = out["engine"]
        assert got == alone and got == outs[0]["engine"][0]
        assert pages * 4 * 4 == 32           # 32 positions, pages of 4


def test_data_rank_rows_bitwise_alone():
    """(2, 2): each data rank serves its half of the batch's rows over
    its caches of those rows; its rows are bitwise one process serving
    them alone, and the whole batch (gathered at the end) one process's
    under the tie rule."""
    cases, outs = _run((2, 2))
    cfg, params, lut, toks, _ = cases["generate"]["llama"]
    whole_toks, whole_logits = _one(cfg, params, lut, toks)
    for out in outs:
        o = out["llama"]
        rows = o["rows"]
        assert rows == slice(2 * out["coords"]["data"],
                             2 * out["coords"]["data"] + 2)
        alone_toks, alone_logits = _one(cfg, params, lut, toks[rows])
        assert torch.equal(o["tokens"][rows, T0:], alone_toks)
        assert torch.equal(o["eager"][0][rows], alone_toks)
        assert torch.equal(o["eager"][1][:, rows], alone_logits)
        assert torch.equal(o["tokens"], outs[0]["llama"]["tokens"])
        assert not _parting(o["eager"][0], whole_toks, o["eager"][1],
                            whole_logits)


def test_sampled_rows_draw_as_in_one_process():
    """(2, 2): ``generate`` with a temperature and a generator draws the
    whole batch's exponentials on every rank and keeps its rows', so a
    row's draw does not depend on the rank that serves it: the sampled
    tokens are one process's."""
    cases, outs = _run((2, 2))
    cfg, params, lut, toks, max_new = cases["generate"]["llama"]
    want = TE.generate(params, cfg, toks, lut=lut, device="cpu",
                       max_new=max_new, temperature=0.8,
                       generator=torch.Generator().manual_seed(11))
    assert not torch.equal(want, TE.generate(params, cfg, toks, lut=lut,
                                             device="cpu", max_new=max_new))
    for out in outs:
        assert torch.equal(out["llama"]["sampled"], want)


def test_deepseek_on_data_and_positions_split():
    """(2, 2): DeepSeek's latents by positions, its rows over data, the
    local-routing MoE on each rank's rows (dropless): against one
    process serving the whole batch (global dispatch)."""
    cases, outs = _run((2, 2))
    cfg, params, lut, toks, _ = cases["generate"]["deepseek"]
    one_toks, one_logits = _one(cfg, params, lut, toks)
    for out in outs:
        o = out["deepseek"]
        got_toks, got_logits = o["eager"]
        np.testing.assert_allclose(got_logits[0].float().numpy(),
                                   one_logits[0].float().numpy(), rtol=0,
                                   atol=LOGIT_ATOL)
        assert not _parting(got_toks, one_toks, got_logits, one_logits)
        assert torch.equal(o["tokens"], outs[0]["deepseek"]["tokens"])
        assert o["dispatch"].get("grouped_fused_shard_map", 0) > 0
