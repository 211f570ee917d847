"""The slice end to end: greedy ``generate`` of the port against the JAX
package's, and where the port's entry points run.

Both packages serve the same smoke model on the same planes (the JAX
state crosses as numpy), for 3 left-padded prompts × 8 new tokens, in all
three weight modes; the greedy tokens must be equal (both argmaxes take the
first maximum).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.models import lm as JLM
from repro.serve import engine as JE
from repro.serve.context import ServeContext as JContext

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import _build
from repro_torch.kernels.dequant_matmul import dequant_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_decode_matmul import fused_decode_matmul
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as TE
from repro_torch.serve.context import ServeContext

from test_torch_model import state_to_numpy

torch.set_num_threads(2)


def _prompts(vocab, lens=(9, 5, 7), seed=4):
    """Left-padded (pad id 0) as examples/serve_batched.py pads."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        out[i, max(lens) - n:] = rng.integers(1, vocab, n)
    return out


@pytest.mark.parametrize("mode", ["dense", "quant", "compressed"])
def test_generate_tokens_match_reference(mode):
    cfg = get_config("llama3.2-1b").smoke
    tcfg = tget_config("llama3.2-1b").smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    if mode == "dense":
        jp, jlut = params, None
        tp = convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
        tlut = None
    else:
        st = JE.build_serve_params(params, JPolicy(mode=mode,
                                                   min_weight_size=1024))
        jp, jlut = st.params, st.lut
        ts = convert.serve_state_from_numpy(
            state_to_numpy(st), np.asarray(st.lut) if st.lut is not None
            else None, tcfg, mode=mode, device="cpu")
        tp, tlut = ts.params, ts.lut
    toks = _prompts(cfg.vocab_size)
    ref = np.asarray(JE.generate(jp, cfg, jnp.asarray(toks),
                                 ctx=JContext(cfg=cfg, lut=jlut),
                                 max_new=8))
    got = TE.generate(tp, tcfg, torch.from_numpy(toks),
                      ctx=ServeContext(tcfg, lut=tlut, device="cpu"),
                      max_new=8)
    assert got.dtype == torch.int32 and got.shape == (3, toks.shape[1] + 8)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_port_packs_and_serves_on_cpu():
    """The port's own packing feeds its own serving: quant and compressed
    states of one model give the same greedy tokens (the codec is
    lossless over the quantized model)."""
    tcfg = tget_config("llama3.2-1b").smoke
    params = TLM.init_lm(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(_prompts(tcfg.vocab_size, seed=5))
    outs = {}
    for mode in ("quant", "compressed"):
        st = TE.build_serve_params(params, CompressionPolicy(
            mode=mode, min_weight_size=1024), device="cpu")
        outs[mode] = TE.generate(st.params, tcfg, toks, lut=st.lut,
                                 max_new=6, device="cpu")
    assert torch.equal(outs["quant"], outs["compressed"])


def test_sampling_is_seeded():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    assert torch.equal(TE.sample_tokens(logits),
                       torch.argmax(logits, dim=-1))
    a = TE.sample_tokens(logits, 0.7, torch.Generator().manual_seed(1))
    b = TE.sample_tokens(logits, 0.7, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (4,)


@pytest.mark.parametrize("temperature", [0.7, 50.0])
def test_sampled_draw_is_multinomials(temperature):
    """sample_tokens draws what torch.multinomial(probs, 1) draws from the
    same generator state (the exponential race it runs for one sample),
    without multinomial's host-side check, which a captured step cannot
    hold."""
    logits = torch.randn(5, 300, generator=torch.Generator().manual_seed(2))
    probs = torch.softmax(logits / temperature, dim=-1)
    for seed in range(4):
        want = torch.multinomial(probs, 1,
                                 generator=torch.Generator().manual_seed(seed))
        got = TE.sample_tokens(logits, temperature,
                               torch.Generator().manual_seed(seed))
        assert torch.equal(got, want[:, 0])


@pytest.fixture
def no_kept_graphs():
    """Start with no decode graph kept: states that other test files cache
    keep their graphs alive in the same worker process."""
    for cfg in {key[0] for key in TE._GRAPHS}:
        TE.drop_graphs(cfg)


def test_decode_graphs_are_kept_per_state_and_released(no_kept_graphs):
    """decode_graph gives one graph per (config, batch, cache length,
    sampling rule, weights): the same for a second call or another
    generator at the same temperature, another for a new state of the same
    shapes or another temperature, and none left once its weights are
    freed."""
    tcfg = tget_config("llama3.2-1b").smoke
    states = [TE.build_serve_params(
        TLM.init_lm(tcfg, seed=s, device="cpu"),
        CompressionPolicy(min_weight_size=1024), device="cpu")
        for s in (0, 1)]
    n = len(TE._GRAPHS)

    def graph(st, **kw):
        return TE.decode_graph(st.params, tcfg, st.lut, 2, 12, device="cpu",
                               **kw)

    a = graph(states[0])
    assert graph(states[0]) is a and graph(states[1]) is not a
    assert graph(states[0], temperature=0.5) is a       # no generator
    sampled = graph(states[0], temperature=0.5,
                    generator=torch.Generator().manual_seed(0))
    assert sampled is not a and sampled.generator is not None
    assert graph(states[0], temperature=0.5,
                 generator=torch.Generator()) is sampled
    assert len(TE._GRAPHS) == n + 3
    del states[0], sampled
    assert len(TE._GRAPHS) == n + 1


def test_decode_graph_cache_is_bounded(no_kept_graphs):
    """generate at eight prompt lengths (eight cache lengths) keeps at most
    MAX_GRAPHS graphs, so the bytes the kept graphs hold stay at most
    MAX_GRAPHS times the largest one's; the least recently used goes
    first, and a repeated call on a kept shape makes no graph."""
    tcfg = tget_config("llama3.2-1b").smoke
    st = TE.build_serve_params(TLM.init_lm(tcfg, seed=0, device="cpu"),
                               CompressionPolicy(min_weight_size=1024),
                               device="cpu")
    rng = np.random.default_rng(8)

    def nbytes(g):
        return sum(t.numel() * t.element_size()
                   for t in TE._tensors([g.caches, g.tok, g.pos, g.seq]))

    def run(t0):
        """generate at prompt length t0; → the graph it used."""
        toks = torch.from_numpy(rng.integers(1, tcfg.vocab_size, (2, t0)))
        TE.generate(st.params, tcfg, toks, lut=st.lut, max_new=4,
                    device="cpu")
        return next(reversed(TE._GRAPHS.values()))

    TE.CAPTURE_COUNTS.clear()
    graphs = {}
    for t0 in range(5, 13):
        graphs[t0] = run(t0)
        assert len(TE._GRAPHS) <= TE.MAX_GRAPHS
        assert sum(nbytes(g) for g in TE._GRAPHS.values()) \
            <= TE.MAX_GRAPHS * nbytes(graphs[t0])
    kept = list(TE._GRAPHS.values())
    assert kept == [graphs[t0] for t0 in range(13 - TE.MAX_GRAPHS, 13)]
    # a kept shape again: the same graph, now the most recently used
    assert run(13 - TE.MAX_GRAPHS) is kept[0]
    assert list(TE._GRAPHS.values()) == kept[1:] + kept[:1]
    # so a new shape evicts the next oldest, not it
    run(13)
    assert kept[0] in TE._GRAPHS.values()
    assert kept[1] not in TE._GRAPHS.values()
    assert len(TE._GRAPHS) == TE.MAX_GRAPHS
    assert TE.CAPTURE_COUNTS["decode_loop"] == 0        # the CPU: eager


def test_sampled_generate_starts_greedy():
    """Under sampling the first new token is still the prefill's argmax,
    as in the reference (``repro.serve.engine.generate`` samples only in
    its decode loop); the decode steps draw from the seeded generator."""
    tcfg = tget_config("llama3.2-1b").smoke
    params = TLM.init_lm(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(_prompts(tcfg.vocab_size, seed=6))
    t0 = toks.shape[1]
    greedy = TE.generate(params, tcfg, toks, max_new=6, device="cpu")
    runs = [TE.generate(params, tcfg, toks, max_new=6, temperature=50.0,
                        generator=torch.Generator().manual_seed(7),
                        device="cpu") for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0][:, :t0 + 1], greedy[:, :t0 + 1])
    # at this temperature the draws are near uniform over the vocabulary
    assert not torch.equal(runs[0][:, t0 + 1:], greedy[:, t0 + 1:])


# -- where the entry points run --------------------------------------------

def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default runs there")
    tcfg = tget_config("llama3.2-1b").smoke
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLM.init_lm(tcfg)
    params = TLM.init_lm(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.build_serve_params(params, CompressionPolicy(min_weight_size=1024))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.generate(params, tcfg, torch.zeros((1, 3), dtype=torch.long))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.make_serve_fns(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLM.init_caches(tcfg, 1, 8)


def test_cpu_tensors_launch_no_kernel():
    _build.LAUNCH_COUNTS.clear()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 64, generator=g)
    wq = torch.randint(0, 256, (16, 64), dtype=torch.uint8, generator=g)
    s, z = torch.rand(16, 1, generator=g), torch.full((16, 1), 128.0)
    dequant_matmul(x, wq, s, z)
    codes = torch.full((1, 256), -1, dtype=torch.int16)   # all ESCAPE
    lits = torch.randint(0, 256, (1, 256, 4), dtype=torch.uint8, generator=g)
    lut = torch.zeros((2, 4), dtype=torch.uint8)
    fused_decode_matmul(x, codes, lits, lut, s, z, shape=(16, 64),
                        tile_n=16, tile_k=64)
    q = torch.randn(1, 4, 5, 16, generator=g)
    kv = torch.randn(1, 2, 5, 16, generator=g)
    flash_attention(q, kv, kv)
    assert sum(_build.LAUNCH_COUNTS.values()) == 0
