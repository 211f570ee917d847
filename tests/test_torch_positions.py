"""Positions as tensors in the port, against the JAX package.

A decode step takes its position as a Python int, a 0-d tensor (one
offset shared by the batch, what the captured decode graph passes) or a
per-row (B,) tensor (every row at its own offset), as the reference's
``decode_step`` does.  Both packages serve the same compressed smoke
model on the same planes (the reference's state crosses as numpy), for 3
prompts from a numpy seed.  Tolerances, as in test_torch_model.py and
test_torch_moe.py: the port's three spellings of one position give the
same bits; against the reference, logits within 3e-2 (bf16 activations
after the int8 embedding, one rounding flip moves a logit by ~2^-8 of its
size) and cache entries within 3e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serve import engine as JE

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serve import engine as TE

from test_torch_model import state_to_numpy

torch.set_num_threads(2)
ARCHS = {"gqa": "llama3.2-1b", "mla": "deepseek-v2-lite-16b"}
ATOL = 3e-2
B, T0, MAX_LEN = 3, 13, 16


@pytest.fixture(scope="module")
def served():
    """{family: (cfg, tcfg, jax params, jax lut, port params, port lut)},
    compressed, on one seed."""
    out = {}
    for family, arch in ARCHS.items():
        cfg, tcfg = get_config(arch).smoke, tget_config(arch).smoke
        params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
        st = JE.build_serve_params(params, JPolicy(mode="compressed",
                                                   min_weight_size=1024),
                                   manifest=False)
        ts = convert.serve_state_from_numpy(
            state_to_numpy(st), np.asarray(st.lut), tcfg, mode="compressed",
            device="cpu")
        out[family] = (cfg, tcfg, st.params, st.lut, ts.params, ts.lut)
    return out


def _inputs(vocab, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, vocab, (B, T0)), rng.integers(1, vocab, (B, 1)))


def _port_prefilled(tcfg, tp, tlut, prompt):
    prefill, decode_step = TE.make_serve_fns(tcfg, device="cpu")
    caches = TLM.init_caches(tcfg, B, MAX_LEN, device="cpu")
    _, caches = prefill(tp, tlut, {"tokens": torch.from_numpy(prompt)},
                        caches)
    return decode_step, caches


@pytest.mark.parametrize("family", list(ARCHS))
@pytest.mark.parametrize("spelling", ["0-d tensor", "(B,) tensor"])
def test_position_spellings_give_the_same_bits(served, family, spelling):
    """A decode step at position T0 given as an int and as a tensor: the
    same logits and caches, bit for bit."""
    _, tcfg, _, _, tp, tlut = served[family]
    prompt, tok = _inputs(tcfg.vocab_size, 1)
    pos = (torch.tensor(T0) if spelling == "0-d tensor"
           else torch.full((B,), T0))
    got = []
    for p in (T0, pos):
        decode_step, caches = _port_prefilled(tcfg, tp, tlut, prompt)
        logits, caches = decode_step(tp, tlut, torch.from_numpy(tok), caches,
                                     p)
        got.append((logits, list(TE._tensors(caches))))
    assert torch.equal(got[0][0], got[1][0])
    assert len(got[0][1]) == len(got[1][1]) > 0
    for a, b in zip(got[0][1], got[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", list(ARCHS))
def test_per_row_positions_match_reference(served, family):
    """Each row decodes at its own position (the rows' caches hold the
    prompt; a row at an earlier position overwrites its entry there and
    sees the cache up to it): the port's logits and written cache rows
    against the reference's decode_step with pos = jnp.array([...])."""
    cfg, tcfg, jp, jlut, tp, tlut = served[family]
    prompt, tok = _inputs(cfg.vocab_size, 2)
    rows = np.array([T0, 7, 11])
    jprefill, jdecode = JE.make_serve_fns(cfg)
    jc = JLM.init_caches(cfg, B, MAX_LEN)
    _, jc = jprefill(jp, jlut, {"tokens": jnp.asarray(prompt)}, jc)
    jl, jc = jdecode(jp, jlut, jnp.asarray(tok), jc, jnp.asarray(rows))
    decode_step, tc = _port_prefilled(tcfg, tp, tlut, prompt)
    tl, tc = decode_step(tp, tlut, torch.from_numpy(tok), tc,
                         torch.from_numpy(rows))
    jl = np.asarray(jl, np.float32)
    np.testing.assert_allclose(tl.float().numpy(), jl.reshape(B, -1),
                               rtol=0, atol=ATOL)
    key = "ckv" if family == "mla" else "k"
    jlast = np.asarray(jc["blocks"][key][-1], np.float32)
    tlast = tc["blocks"][-1][key].float().numpy()
    for r, p in enumerate(rows):
        np.testing.assert_allclose(tlast[r, p], jlast[r, p], rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("family", list(ARCHS))
def test_per_row_decode_agrees_with_one_row_at_a_time(served, family):
    """A (B,) position tensor gives each row what a batch of that row alone
    at its position gives, bit for bit."""
    _, tcfg, _, _, tp, tlut = served[family]
    prompt, tok = _inputs(tcfg.vocab_size, 3)
    rows = [T0, 5, 9]
    decode_step, caches = _port_prefilled(tcfg, tp, tlut, prompt)
    logits, _ = decode_step(tp, tlut, torch.from_numpy(tok), caches,
                            torch.tensor(rows))
    for r, p in enumerate(rows):
        decode_step, caches = _port_prefilled(tcfg, tp, tlut, prompt)
        one, _ = decode_step(tp, tlut, torch.from_numpy(tok), caches,
                             torch.full((B,), p))
        assert torch.equal(logits[r], one[r])


def test_vector_position_takes_one_token():
    """A per-row position writes one token a row; more raise, as the
    reference's ``_kv_write`` does."""
    dst = np.zeros((2, 8, 3), np.float32)
    src = np.ones((2, 2, 3), np.float32)
    pos = np.array([1, 4])
    with pytest.raises(ValueError, match="one token at a time"):
        JL._kv_write(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(pos))
    with pytest.raises(ValueError, match="one token at a time"):
        TL._kv_write(torch.from_numpy(dst), torch.from_numpy(src),
                     torch.from_numpy(pos))
    ref = np.asarray(JL._kv_write(jnp.asarray(dst), jnp.asarray(src[:, :1]),
                                  jnp.asarray(pos)))
    got = TL._kv_write(torch.from_numpy(dst.copy()),
                       torch.from_numpy(src[:, :1]), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("pos", [3, "0-d"])
def test_shared_position_writes_as_the_reference(pos):
    """A shared offset, an int or a 0-d tensor, writes T rows there."""
    rng = np.random.default_rng(4)
    dst = rng.standard_normal((2, 9, 3)).astype(np.float32)
    src = rng.standard_normal((2, 4, 3)).astype(np.float32)
    ref = np.asarray(JL._kv_write(jnp.asarray(dst), jnp.asarray(src), 3))
    tpos = torch.tensor(3) if pos == "0-d" else pos
    got = TL._kv_write(torch.from_numpy(dst.copy()), torch.from_numpy(src),
                       tpos)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_forward_refuses_vector_position_for_a_prefill(served):
    _, tcfg, _, _, tp, tlut = served["gqa"]
    prompt, _ = _inputs(tcfg.vocab_size, 5)
    caches = TLM.init_caches(tcfg, B, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="single-token decode only"):
        TLM.forward(tp, tcfg, torch.from_numpy(prompt), caches=caches,
                    pos=torch.zeros(B, dtype=torch.long), lut=tlut)


@pytest.mark.parametrize("family", list(ARCHS))
def test_generate_matches_the_int_position_loop_on_cpu(served, family):
    """generate (the decode graph's step on its buffers, a 0-d position
    tensor, tokens written at column pos + 1, run eagerly on the CPU)
    gives the tokens of a loop over decode_step at int positions; so do
    two runs of one graph (the prefill resets its buffers)."""
    _, tcfg, _, _, tp, tlut = served[family]
    prompt, _ = _inputs(tcfg.vocab_size, 6)
    prefill, decode_step = TE.make_serve_fns(tcfg, device="cpu")
    caches = TLM.init_caches(tcfg, B, MAX_LEN, device="cpu")
    logits, caches = prefill(tp, tlut, {"tokens": torch.from_numpy(prompt)},
                             caches)
    want = [TE.sample_tokens(logits)[:, None]]
    for i in range(2):
        logits, caches = decode_step(tp, tlut, want[-1], caches, T0 + i)
        want.append(TE.sample_tokens(logits)[:, None])
    want = torch.cat(want, dim=1)
    ids = torch.from_numpy(prompt)
    for _ in range(2):
        got = TE.generate(tp, tcfg, ids, lut=tlut, max_new=3, max_len=MAX_LEN,
                          device="cpu")
        assert torch.equal(got[:, T0:], want)
    graph = TE.decode_graph(tp, tcfg, tlut, B, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="exceed"):
        graph.run(tp, tlut, ids, MAX_LEN - T0 + 1)
