"""The port's GPTQ solver (``repro_torch.core.gptq``) against the JAX
package's, on the same numpy weights and calibration activations from a
seed.

Tolerances: the Hessian within 1e-5 relative (f32 sums of the same
products, another order); codes equal for at least 99.9 % of entries (the
inverse and Cholesky factor come from two LAPACK builds, and a column's
error moves every later column: a value near a rounding boundary may land
on the other side); ``gptq_layer_error`` within 1e-4 relative.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import gptq as JG
from repro.core.quant import QuantConfig as JQC

from repro_torch.core import gptq as TG
from repro_torch.core.quant import QuantConfig, dequantize, quantize

torch.set_num_threads(2)


def _layer(out_f, in_f, n_tok, seed, dead=()):
    rng = np.random.default_rng(seed)
    w = rng.laplace(0.0, 0.05, (out_f, in_f)).astype(np.float32)
    # correlated activations, as a trained layer's inputs are
    mix = rng.normal(size=(in_f, in_f)).astype(np.float32) / np.sqrt(in_f)
    xs = [(rng.normal(size=(n_tok, in_f)).astype(np.float32) @ mix)
          for _ in range(3)]
    for c in dead:
        for x in xs:
            x[:, c] = 0.0
    return w, xs


def test_hessian_matches():
    w, xs = _layer(16, 48, 40, 0)
    hj = JG.init_hessian(48)
    ht = TG.init_hessian(48)
    for x in xs:
        hj = JG.accumulate_hessian(hj, jnp.asarray(x))
        ht = TG.accumulate_hessian(ht, torch.from_numpy(x))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5,
                               atol=1e-5 * float(np.abs(hj).max()))


@pytest.mark.parametrize("out_f,in_f,bits,sym,dead", [
    (32, 64, 4, False, ()),
    (48, 96, 3, False, (5, 17)),       # dead columns
    (64, 128, 4, True, ()),
    (24, 64, 8, False, ()),
])
def test_gptq_codes_and_error_match(out_f, in_f, bits, sym, dead):
    w, xs = _layer(out_f, in_f, 64, out_f + in_f, dead)
    jq = JG.calibrate_and_quantize(jnp.asarray(w), [jnp.asarray(x)
                                                    for x in xs],
                                   JQC(bits=bits, symmetric=sym))
    tq = TG.calibrate_and_quantize(torch.from_numpy(w),
                                   [torch.from_numpy(x) for x in xs],
                                   QuantConfig(bits=bits, symmetric=sym))
    same = np.mean(tq.values.numpy() == np.asarray(jq.values))
    assert same >= 0.999, same
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(tq.zero.numpy(), np.asarray(jq.zero))
    h = TG.init_hessian(in_f)
    for x in xs:
        h = TG.accumulate_hessian(h, torch.from_numpy(x))
    ej = float(JG.gptq_layer_error(jnp.asarray(w), jq, jnp.asarray(h.numpy())))
    et = float(TG.gptq_layer_error(torch.from_numpy(w), tq, h))
    assert et == pytest.approx(ej, rel=1e-4)


def test_gptq_beats_naive_per_channel():
    """GPTQ's proxy error is below the naive per-channel quantizer's at 4
    bits on correlated activations (the paper's reason for GPTQ)."""
    w, xs = _layer(64, 128, 128, 7)
    wt = torch.from_numpy(w)
    h = TG.init_hessian(128)
    for x in xs:
        h = TG.accumulate_hessian(h, torch.from_numpy(x))
    cfg = QuantConfig(bits=4)
    g = float(TG.gptq_layer_error(wt, TG.gptq_quantize(wt, h, cfg), h))
    naive = float(TG.gptq_layer_error(wt, quantize(wt, cfg), h))
    assert g < naive, (g, naive)
    assert dequantize(TG.gptq_quantize(wt, h, cfg)).shape == wt.shape
