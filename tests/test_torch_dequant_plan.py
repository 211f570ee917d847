"""K5's launch plan where it splits K, and the tensor-core kernel's work
split emulated in plain torch against the plain version and the JAX
package's Pallas kernel (interpret mode).

The emulation follows ``dequant_matmul_mma_kernel`` in
``csrc/dequant_matmul.cu``: per K split, steps of 64 columns; in a step
four m16n8k16 sub-steps (columns 16u .. 16u + 15, as ldmatrix reads the
bf16 tiles), each a 16-term product in f32, and Σx the same way (the
kernel's mma against a B of ones); then the splits' sums in split order
and the affine epilogue.  Tolerances as in
test_torch_kernels.py: integer-valued x is exact in every partial sum, so
bitwise; random bf16 x sums in another order, 1e-5 of the output's
largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops

from repro_torch.kernels import dequant_matmul as dqm

torch.set_num_threads(2)

SMS = 132                                    # H100 SXM


def _cdiv(a, b):
    return -(-a // b)


def test_dequant_plan_splits_k_proj_at_prefill():
    """Llama's k_proj at M = 700: 4 × 6 tiles on 132 SMs, 5 splits of 7
    (the last 4) steps; at M = 175 (one admission), 4 × 2 tiles, 16
    splits of 2 steps; gate/up's 64 × 6 tiles fill the card unsplit."""
    assert dqm.dequant_plan(700, 512, 2048, SMS).grid == (4, 6, 5)
    assert dqm.dequant_plan(175, 512, 2048, SMS).grid == (4, 2, 16)
    assert dqm.dequant_plan(700, 8192, 2048, SMS).grid == (64, 6, 1)


def _mma_emulation(x, wq, scale, zero, sms=SMS):
    """The work split of the card's K5 tensor-core kernel, in f32 torch:
    see the module's docstring.  Its plan (``mma_plan``) is
    ``dequant_plan``'s from MMA_MIN_M rows on; below, the tensor-core
    kernel's launch at those shapes (the decode kernel's row groups serve
    them)."""
    m, k = x.shape
    n = wq.shape[0]
    plan = dqm.mma_plan(m, n, k, sms)
    assert plan.kernel == "mma"
    if m >= dqm.MMA_MIN_M:
        assert dqm.dequant_plan(m, n, k, sms) == plan
    stripes, bands, splits = plan.grid
    steps = _cdiv(k, dqm.MMA_STEP_K)
    per = _cdiv(steps, splits)
    mp, np_, kp = bands * dqm.MMA_BM, stripes * dqm.MMA_BN, steps * 64
    xb = torch.zeros((mp, kp))
    xb[:m, :k] = x.to(torch.bfloat16).float()
    wp = torch.zeros((np_, kp))
    wp[:n, :k] = wq.float()
    cols = torch.arange(64).reshape(4, 16)            # sub-step u's columns
    accs, sxs = [], []
    for s in range(splits):
        acc, sx = torch.zeros((mp, np_)), torch.zeros(mp)
        for st in range(s * per, min((s + 1) * per, steps)):
            xs, ws = xb[:, 64 * st:64 * st + 64], wp[:, 64 * st:64 * st + 64]
            for u in range(4):
                acc = acc + xs[:, cols[u]] @ ws[:, cols[u]].T
                sx = sx + xs[:, cols[u]].sum(dim=1)   # the mma against ones
        accs.append(acc)
        sxs.append(sx)
    if splits == 1:
        acc, sx = accs[0], sxs[0]
    else:                        # splitk_epilogue: from 0, in split order
        acc, sx = torch.zeros((mp, np_)), torch.zeros(mp)
        for a, s in zip(accs, sxs):
            acc, sx = acc + a, sx + s
    acc, sx = acc[:m, :n], sx[:m, None]
    return scale.reshape(1, -1) * (acc - sx * zero.reshape(1, -1))


def _inputs(rng, m, n, k, kind):
    wq = rng.integers(0, 256, (n, k)).astype(np.uint8)
    scale = (rng.random((n, 1)) * 0.02 + 1e-3).astype(np.float32)
    zero = rng.integers(0, 256, (n, 1)).astype(np.float32)
    if kind == "int":
        x = rng.integers(-4, 5, (m, k)).astype(np.float32)
    else:                   # bf16-representable, as the kernels see it
        x = np.asarray(jnp.asarray(rng.standard_normal((m, k)).astype(
            np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
    return x, wq, scale, zero


def _assert_close_scaled(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("m,n,k", [
    (5, 37, 64),          # one tile, N ragged
    (40, 300, 1040),      # K not a whole step: the last step zero-filled
    (130, 200, 2048),     # two bands, M ragged
    (200, 128, 4096),     # one stripe: K split over the idle SMs
    (16, 1003, 512),      # 8 stripes, split
])
@pytest.mark.parametrize("kind", ["int", "bf16"])
def test_dequant_mma_decomposition(m, n, k, kind):
    """The emulated tensor-core kernel equals the plain version bitwise
    on integer-valued x, and within 1e-5 of the output's scale on bf16
    x, split or not."""
    args = [torch.from_numpy(a) for a in _inputs(
        np.random.default_rng(12), m, n, k, kind)]
    got = _mma_emulation(*args).numpy()
    plain = dqm.dequant_matmul_plain(*args, torch.float32).numpy()
    if kind == "int":
        np.testing.assert_array_equal(got, plain)
    else:
        _assert_close_scaled(got, plain)


@pytest.mark.parametrize("m,n,k", [(40, 256, 512), (130, 200, 1024)])
@pytest.mark.parametrize("kind", ["int", "bf16"])
def test_dequant_mma_decomposition_matches_pallas(m, n, k, kind):
    """The emulated tensor-core kernel against the reference's Pallas K5
    in interpret mode on the same numpy inputs: bitwise on integer x,
    within 1e-5 of the output's scale on bf16 x."""
    x, wq, scale, zero = _inputs(np.random.default_rng(13), m, n, k, kind)
    got = _mma_emulation(*map(torch.from_numpy, (x, wq, scale, zero)))
    pallas = np.asarray(jops.dequant_matmul(
        *map(jnp.asarray, (x, wq, scale, zero)), impl="pallas_interpret"))
    if kind == "int":
        np.testing.assert_array_equal(got.numpy(), pallas)
    else:
        _assert_close_scaled(got.numpy(), pallas)
