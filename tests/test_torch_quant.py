"""The port's quantizer (``repro_torch.core.quant``) against the JAX
package's, on the same numpy inputs from a seed.

Tolerances: integer codes equal (both round half to even in f32 on the
same f32 divisions); scale and zero equal; the dequantized view within
1e-6 relative (f32 roundoff of the same formula); the mean squared error
within 1e-5 relative (a mean of thousands of f32 terms, summed in
another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import quant as JQ

from repro_torch.core import quant as TQ

torch.set_num_threads(2)

CONFIGS = [
    dict(bits=8, granularity="per_channel"),
    dict(bits=4, granularity="per_channel"),
    dict(bits=4, granularity="per_channel", symmetric=True),
    dict(bits=3, granularity="per_channel", channel_axis=1),
    dict(bits=8, granularity="per_tensor"),
    dict(bits=2, granularity="per_tensor", symmetric=True),
    dict(bits=4, granularity="per_group", group_size=32),
    dict(bits=8, granularity="per_group", group_size=48),   # padded rows
    dict(bits=12, granularity="per_channel"),               # uint16 codes
    dict(bits=1.5),                                         # ternary
]
SHAPES = [(64, 96), (3, 40, 24)]


def _x(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.laplace(0.0, 0.02, shape)
            + rng.normal(0, 0.005, shape)).astype(np.float32)


def _both(x, kw):
    return (JQ.quantize(jnp.asarray(x), JQ.QuantConfig(**kw)),
            TQ.quantize(torch.from_numpy(x), TQ.QuantConfig(**kw)))


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    f"{v}" for v in kw.values()))
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_codes_equal(kw, shape):
    x = _x(shape)
    jq, tq = _both(x, kw)
    if kw.get("bits") == 1.5:
        np.testing.assert_array_equal(tq.codes.numpy(),
                                      np.asarray(jq.codes))
        np.testing.assert_array_equal(tq.w_max.numpy(),
                                      np.asarray(jq.w_max))
        return
    assert tq.values.dtype == (torch.uint8 if kw["bits"] <= 8
                               else torch.uint16)
    np.testing.assert_array_equal(tq.values.numpy().astype(np.int64),
                                  np.asarray(jq.values).astype(np.int64))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(tq.zero.numpy(), np.asarray(jq.zero))
    assert tq.layout == (None if jq.layout is None else
                         tuple(jq.layout[:3]) + (tuple(jq.layout[3]),))


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    f"{v}" for v in kw.values()))
def test_dequantize_fake_quant_and_error_match(kw):
    x = _x((48, 80), seed=1)
    jq, tq = _both(x, kw)
    jd = np.asarray(JQ.dequantize(jq))
    td = TQ.dequantize(tq).numpy()
    assert td.shape == x.shape
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-9)
    # against the reference's quantize → dequantize run eagerly: its
    # fake_quant is jitted, and XLA multiplies by maxq's reciprocal there
    # (an ulp off the scale, a code off at a rounding boundary)
    cfgt = TQ.QuantConfig(**kw)
    np.testing.assert_allclose(
        TQ.fake_quant(torch.from_numpy(x), cfgt).numpy(), jd, rtol=1e-6,
        atol=1e-9)
    np.testing.assert_allclose(
        float(TQ.quantization_error(torch.from_numpy(x), cfgt)),
        float(jnp.mean((jnp.asarray(x) - jd) ** 2)), rtol=1e-5)


@pytest.mark.parametrize("kw", [c for c in CONFIGS if c.get("bits") != 1.5],
                         ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_find_params_match(kw):
    x = _x((40, 72), seed=2)
    js, jz = JQ.find_params(jnp.asarray(x), JQ.QuantConfig(**kw))
    ts, tz = TQ.find_params(torch.from_numpy(x), TQ.QuantConfig(**kw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_per_channel_triple_is_the_packers():
    """Unpacked as (values, scale, zero), the per-channel quantizer gives
    what ``core.compressed.quantize_linear`` stores (the serving planes
    do not move)."""
    from repro_torch.core.compressed import quantize_linear
    w = torch.from_numpy(_x((32, 64), seed=3))
    values, scale, zero = TQ.quantize(w, TQ.QuantConfig(bits=8))
    ql = quantize_linear(w)
    assert torch.equal(ql.values, values) and torch.equal(ql.scale, scale)
    assert torch.equal(ql.zero, zero)


def test_bit_width_sweep_error_falls():
    """The paper's ablation order: error falls as bits grow (ternary,
    2, 4, 6, 8), in both packages alike."""
    x = _x((64, 128), seed=4)
    errs = [float(TQ.quantization_error(torch.from_numpy(x),
                                        TQ.QuantConfig(bits=b)))
            for b in (1.5, 2, 4, 6, 8)]
    assert errs == sorted(errs, reverse=True), errs
