"""The port's dense LM against the JAX package's, on the smoke config.

The reference's weights cross as numpy arrays (``repro_torch.convert``), so
both packages run the same model on the same planes; the forward pass's
logits must agree.  Tolerances: f32 throughout in dense mode (1e-4); in
quant and compressed modes activations are bf16 after the QuantLinear
embedding, and one bf16 rounding flip where f32 sums are taken in another
order moves a logit by ~2^-8 of its size (3e-2).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.core.compressed import PackedLinear as JPacked
from repro.core.compressed import QuantLinear as JQuant
from repro.models import lm as JLM
from repro.serve import engine as JE

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM

torch.set_num_threads(2)
ATOL = {"dense": 1e-4, "quant": 3e-2, "compressed": 3e-2}


def state_to_numpy(st):
    """A JAX ServeState's params as the ``"kind"`` dicts convert takes."""
    def conv(x):
        if isinstance(x, JPacked):
            return {"kind": "packed", "codes": np.asarray(x.codes),
                    "literals": np.asarray(x.literals),
                    "nlit": np.asarray(x.nlit), "scale": np.asarray(x.scale),
                    "zero": np.asarray(x.zero), "shape": x.shape,
                    "tile_n": x.tile_n, "tile_k": x.tile_k}
        if isinstance(x, JQuant):
            return {"kind": "quant", "values": np.asarray(x.values),
                    "scale": np.asarray(x.scale), "zero": np.asarray(x.zero)}
        return np.asarray(x)
    return jax.tree_util.tree_map(
        conv, st.params, is_leaf=lambda x: isinstance(x, (JPacked, JQuant)))


@pytest.fixture(scope="module")
def models():
    """{mode: (jax params, jax lut, port params, port lut)} on one seed."""
    cfg = get_config("llama3.2-1b").smoke
    tcfg = tget_config("llama3.2-1b").smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    out = {"dense": (params, None, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu"),
        None)}
    for mode in ("quant", "compressed"):
        st = JE.build_serve_params(params, JPolicy(mode=mode,
                                                   min_weight_size=1024))
        ts = convert.serve_state_from_numpy(
            state_to_numpy(st), np.asarray(st.lut) if st.lut is not None
            else None, tcfg, mode=mode, device="cpu")
        out[mode] = (st.params, st.lut, ts.params, ts.lut)
    return cfg, tcfg, out


@pytest.mark.parametrize("mode", ["dense", "quant", "compressed"])
def test_forward_logits_match(models, mode):
    cfg, tcfg, out = models
    jp, jlut, tp, tlut = out[mode]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 11))
    jl, _, _ = JLM.forward(jp, cfg, jnp.asarray(toks, jnp.int32), lut=jlut)
    tl, _, _ = TLM.forward(tp, tcfg, torch.from_numpy(toks), lut=tlut)
    jl = np.asarray(jl, np.float32)
    tl = tl.to(torch.float32).numpy()
    assert tl.shape == jl.shape == (3, 11, cfg.vocab_size)
    np.testing.assert_allclose(tl[:, -1], jl[:, -1], rtol=0,
                               atol=ATOL[mode])
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL[mode])


@pytest.mark.parametrize("mode", ["dense", "compressed"])
def test_hidden_states_match(models, mode):
    cfg, tcfg, out = models
    jp, jlut, tp, tlut = out[mode]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7))
    jh, _, _ = JLM.forward(jp, cfg, jnp.asarray(toks, jnp.int32), lut=jlut,
                           return_hidden=True)
    th, _, _ = TLM.forward(tp, tcfg, torch.from_numpy(toks), lut=tlut,
                           return_hidden=True)
    # hidden states are O(1)–O(4): in bf16 a rounding flip is one ulp of
    # the value, so allow two ulps (2^-6) relative on top of the logit atol
    np.testing.assert_allclose(th.to(torch.float32).numpy(),
                               np.asarray(jh, np.float32),
                               rtol=0 if mode == "dense" else 2.0 ** -6,
                               atol=ATOL[mode])


def test_cached_prefill_and_decode_match(models):
    """Chunked prefill (cache longer than the prompt → flash over the
    cache with q_offset) then one decode step over the cache."""
    cfg, tcfg, out = models
    jp, jlut, tp, tlut = out["compressed"]
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6))
    jc = JLM.init_caches(cfg, 2, 10)
    tc = TLM.init_caches(tcfg, 2, 10, device="cpu")
    jl, jc, _ = JLM.forward(jp, cfg, jnp.asarray(toks, jnp.int32),
                            caches=jc, pos=0, lut=jlut)
    tl, tc, _ = TLM.forward(tp, tcfg, torch.from_numpy(toks), caches=tc,
                            pos=0, lut=tlut)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=0, atol=ATOL["compressed"])
    np.testing.assert_allclose(
        tc["blocks"][1]["k"].float().numpy(),
        np.asarray(jc["blocks"]["k"][1], np.float32), rtol=0, atol=3e-2)
    nxt = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    jl, _, _ = JLM.forward(jp, cfg, jnp.asarray(nxt, jnp.int32), caches=jc,
                           pos=6, lut=jlut)
    tl, _, _ = TLM.forward(tp, tcfg, torch.from_numpy(nxt), caches=tc, pos=6,
                           lut=tlut)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=0, atol=ATOL["compressed"])


def test_compressed_path_never_materializes(models):
    cfg, tcfg, out = models
    _, _, tp, tlut = out["compressed"]
    TL.MATERIALIZE_COUNTS.clear()
    TLM.forward(tp, tcfg, torch.zeros((1, 4), dtype=torch.long), lut=tlut)
    assert TL.MATERIALIZE_COUNTS["packed"] == 0
