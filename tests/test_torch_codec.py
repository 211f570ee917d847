"""Packing parity: the PyTorch port's host packing against the JAX package.

The same uint8 streams and weights, made from a seed with numpy, go through
``repro.core`` and ``repro_torch.core``; tables, LUTs and planes must be
byte-equal, and the whole ``build_serve_params`` of the smoke model must
give the same containers.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import CompressionPolicy as JPolicy
from repro.core import blocked_codec as jbc
from repro.core import codec as jcodec
from repro.core.compressed import pack_linear
from repro.core.quant import QuantConfig as JQuantConfig, quantize as jquantize
from repro.models import lm as JLM
from repro.serve import engine as JE

from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core import blocked_codec as tbc
from repro_torch.core import codec as tcodec
from repro_torch.core.compressed import quantize_linear
from repro_torch.core.policy import CompressionPolicy as TPolicy
from repro_torch.core.quant import QuantConfig, quantize
from repro_torch.serve import engine as TE

torch.set_num_threads(2)


def _streams(seed, sizes, alphabet):
    """uint8 streams over a small alphabet: many repeated grams and many
    count ties, which is where the code order can go wrong."""
    rng = np.random.default_rng(seed)
    return [rng.choice(alphabet, size=n).astype(np.uint8) for n in sizes]


@pytest.mark.parametrize("sizes,alphabet,max_codes,min_count,cap", [
    ((4096, 1024, 2048), [0, 1, 2, 255], 65535, 2, None),
    ((4096, 1024, 2048), [3, 7, 9], 10, 2, None),          # truncation
    ((1001, 0, 6, 3003), [0, 1, 2, 3, 4], 40, 3, None),    # ragged, empty
    ((4096, 4096, 4096), [0, 5, 6, 7], 65535, 2, 2500),    # sample cap
    ((50000,), list(range(256)), 65535, 2, None),          # mostly escapes
])
def test_frequent_sequences_same_dict(sizes, alphabet, max_codes, min_count,
                                      cap):
    streams = _streams(0, sizes, alphabet)
    ref = jcodec.find_frequent_sequences(streams, max_codes=max_codes,
                                         min_count=min_count, sample_cap=cap)
    got = tcodec.find_frequent_sequences(
        [torch.from_numpy(s) for s in streams], max_codes=max_codes,
        min_count=min_count, sample_cap=cap)
    assert got == ref                  # same grams, same code for each
    assert list(got.items()) == list(ref.items())
    np.testing.assert_array_equal(tbc.build_lut(ref).numpy(),
                                  jbc.build_lut(ref))


def _weight(seed, shape, levels=None):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    if levels:
        w = np.round(w * levels) / levels
    return w


@pytest.mark.parametrize("shape,levels", [
    ((64, 64), None), ((211, 64), 3), ((33, 100), None), ((128, 512), 2),
])
def test_quantize_byte_equal(shape, levels):
    w = _weight(1, shape, levels)
    w[3] = np.abs(w[3])                # a row with no negative values
    w[5] = 0.0                         # a constant row (scale <= 0 → 1)
    ref = jquantize(jnp.asarray(w), JQuantConfig(bits=8))
    q, scale, zero = quantize(torch.from_numpy(w), QuantConfig(bits=8))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(zero.numpy(), np.asarray(ref.zero))


def test_quantize_rounding_ties_byte_equal():
    """Values that sit on .5 after division by the scale: round half to
    even on both sides, so no ±1 code drift."""
    scale = np.float32(2.0 / 255.0)
    ks = np.arange(-100, 100, dtype=np.float32)
    row = (ks + np.float32(0.5)) * scale
    w = np.stack([np.concatenate([row, [-1.0, 1.0]]).astype(np.float32)] * 4)
    ref = jquantize(jnp.asarray(w), JQuantConfig(bits=8))
    q, _, _ = quantize(torch.from_numpy(w), QuantConfig(bits=8))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref.values))


@pytest.mark.parametrize("shape", [
    (64, 64), (211, 64), (96, 160), (2048, 2048), (8, 12), (3, 5), (130, 7),
    (512, 8192),
])
def test_choose_fused_tiles_same(shape):
    assert tbc.choose_fused_tiles(shape) == jbc.choose_fused_tiles(shape)
    assert tbc.choose_fused_tiles(shape, 256) == \
        jbc.choose_fused_tiles(shape, 256)


@pytest.mark.parametrize("shape,levels,block_weights,tiled", [
    ((64, 64), 2, 4096, True), ((96, 160), 3, 1024, True),
    ((128, 512), 1, 4096, True), ((211, 64), 2, 4096, False),
    ((33, 100), 4, 512, False),
])
def test_encode_planes_byte_equal(shape, levels, block_weights, tiled):
    w = _weight(2, shape, levels)
    ql = quantize_linear(torch.from_numpy(w))
    vals = ql.values.numpy()
    table = jcodec.find_frequent_sequences([vals])
    assert table, "the test needs a non-empty table"
    if tiled:
        tn, tk, _ = jbc.choose_fused_tiles(shape, block_weights)
        ref = pack_linear(jnp.asarray(w), table, jbc.build_lut(table),
                          block_weights=block_weights, tile=(tn, tk))
        got = tbc.encode_blocked_tiled(ql.values, table, tile_n=tn,
                                       tile_k=tk, block_weights=block_weights)
    else:
        ref = jbc.encode_blocked(vals, table, block_weights=block_weights)
        got = tbc.encode_blocked(ql.values, table,
                                 block_weights=block_weights)
    np.testing.assert_array_equal(got.codes.numpy().view(np.uint16),
                                  np.asarray(ref.codes))
    np.testing.assert_array_equal(got.literals.numpy(),
                                  np.asarray(ref.literals))
    np.testing.assert_array_equal(got.nlit.numpy(), np.asarray(ref.nlit))


def _smoke_params():
    """The smoke model's reference init with weights rounded to a few
    levels, so the model-wide table is not empty."""
    cfg = get_config("llama3.2-1b").smoke
    params = JLM.init_lm(jax.random.PRNGKey(0), cfg, jnp.float32)
    params = jax.tree_util.tree_map(lambda a: jnp.round(a * 8.0) / 8.0,
                                    params)
    return cfg, params


@pytest.mark.parametrize("mode", ["quant", "compressed"])
def test_build_serve_params_same_state(mode):
    cfg, params = _smoke_params()
    tcfg = tget_config("llama3.2-1b").smoke
    ref = JE.build_serve_params(params, JPolicy(mode=mode,
                                                min_weight_size=1024))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    got = TE.build_serve_params(tparams, TPolicy(mode=mode,
                                                 min_weight_size=1024),
                                device="cpu")
    assert got.stats == ref.stats
    assert got.table == ref.table
    if mode == "compressed":
        assert len(ref.table) > 10
        np.testing.assert_array_equal(got.lut.numpy(), np.asarray(ref.lut))
    else:
        assert ref.lut is None and got.lut is None
    for grp in ("attn", "mlp"):
        for name, jw in ref.params["blocks"][grp].items():
            for i in range(cfg.n_layers):
                tw = got.params["blocks"][i][grp][name]
                if mode == "quant":
                    np.testing.assert_array_equal(tw.values.numpy(),
                                                  np.asarray(jw.values[i]))
                else:
                    assert (tw.tile_n, tw.tile_k, tw.shape) == \
                        (jw.tile_n, jw.tile_k, jw.shape)
                    np.testing.assert_array_equal(
                        tw.codes.numpy().view(np.uint16),
                        np.asarray(jw.codes[i]))
                    np.testing.assert_array_equal(
                        tw.literals.numpy(), np.asarray(jw.literals[i]))
                    np.testing.assert_array_equal(tw.nlit.numpy(),
                                                  np.asarray(jw.nlit[i]))
                np.testing.assert_array_equal(tw.scale.numpy(),
                                              np.asarray(jw.scale[i]))
                np.testing.assert_array_equal(tw.zero.numpy(),
                                              np.asarray(jw.zero[i]))
    je, te = ref.params["embed"], got.params["embed"]
    np.testing.assert_array_equal(te.values.numpy(), np.asarray(je.values))


def test_materialize_round_trips():
    """A packed weight decodes back to its quantized values."""
    w = _weight(3, (96, 160), 3)
    ql = quantize_linear(torch.from_numpy(w))
    table = tcodec.find_frequent_sequences([ql.values])
    tn, tk, bw = tbc.choose_fused_tiles((96, 160), 1024)
    bc = tbc.encode_blocked_tiled(ql.values, table, tile_n=tn, tile_k=tk,
                                  block_weights=bw)
    from repro_torch.core.compressed import PackedLinear
    pl = PackedLinear(bc.codes, bc.literals, bc.nlit, ql.scale, ql.zero,
                      shape=(96, 160), tile_n=tn, tile_k=tk)
    lut = tbc.build_lut(table)
    assert torch.equal(pl.materialize_int8(lut), ql.values)
    torch.testing.assert_close(pl.materialize(lut, torch.float32),
                               ql.materialize(torch.float32))
