"""The port's Mamba2 / SSD module against the JAX package's, function by
function, on the same f32 inputs made from a seed with numpy.

Tolerances: 1e-5 where both sides sum a few f32 terms in one order
(``_causal_conv``, ``_segsum``, ``ssd_decode_step``); 1e-4 where the SSD
contractions sum a chunk's terms in another order (``ssd_chunked``,
``apply_mamba2``: the port contracts pairwise where ``jnp.einsum`` lets
opt_einsum choose).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.models import frontends as JF
from repro.models import ssm as JS

from repro_torch.configs import get_config as tget_config
from repro_torch.models import frontends as TF
from repro_torch.models import ssm as TS

torch.set_num_threads(2)
ATOL_SUM = 1e-5
ATOL_SSD = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _ssd_inputs(seed, b, t, h, p, g, n):
    """x, dt (softplus of normals), a (negative), B, C as float32 numpy."""
    r = _rng(seed)
    x = (r.standard_normal((b, t, h, p)) * 0.3).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, t, h)))).astype(np.float32)
    a = (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32)
    bi = (r.standard_normal((b, t, g, n)) * 0.3).astype(np.float32)
    ci = (r.standard_normal((b, t, g, n)) * 0.3).astype(np.float32)
    return x, dt, a, bi, ci


def _both(fn_j, fn_t, *arrays):
    """Run the reference on jnp arrays and the port on torch tensors."""
    return (fn_j(*(jnp.asarray(a) for a in arrays)),
            fn_t(*(torch.from_numpy(a) for a in arrays)))


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    r = _rng(0)
    xbc = r.standard_normal((2, 7, 12)).astype(np.float32)
    w = (r.standard_normal((12, 4)) * 0.5).astype(np.float32)
    b = (r.standard_normal(12) * 0.1).astype(np.float32)
    st = r.standard_normal((2, 3, 12)).astype(np.float32)
    args = (xbc, w, b) + ((st,) if with_state else ())
    (jy, js), (ty, ts) = _both(JS._causal_conv, TS._causal_conv, *args)
    _close(ty, jy, ATOL_SUM)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_segsum_matches():
    x = _rng(1).standard_normal((2, 3, 9)).astype(np.float32)
    j, t = _both(JS._segsum, TS._segsum, x)
    j = np.asarray(j)
    assert np.array_equal(np.isneginf(j), np.isneginf(t.numpy()))
    fin = np.isfinite(j)
    np.testing.assert_allclose(t.numpy()[fin], j[fin], rtol=0,
                               atol=ATOL_SUM)


@pytest.mark.parametrize("t,chunk,g,init", [
    (13, 8, 1, False),      # T not a multiple of the chunk
    (13, 8, 1, True),       # from a given state
    (16, 4, 2, False),      # two groups
    (13, 8, 2, True),
    (5, 8, 1, True),        # one chunk, padded
])
def test_ssd_chunked_matches(t, chunk, g, init):
    b, h, p, n = 2, 4, 3, 5
    x, dt, a, bi, ci = _ssd_inputs(2, b, t, h, p, g, n)
    s0 = (_rng(3).standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    extra = (s0,) if init else ()
    (jy, js), (ty, ts) = _both(
        lambda *z: JS.ssd_chunked(*z[:5], chunk, *z[5:]),
        lambda *z: TS.ssd_chunked(*z[:5], chunk, *z[5:]),
        x, dt, a, bi, ci, *extra)
    assert ty.shape == (b, t, h, p) and ts.shape == (b, h, p, n)
    _close(ty, jy, ATOL_SSD)
    _close(ts, js, ATOL_SSD)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches(g):
    b, h, p, n = 3, 4, 3, 5
    x, dt, a, bi, ci = _ssd_inputs(4, b, 1, h, p, g, n)
    s0 = (_rng(5).standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    (jy, js), (ty, ts) = _both(JS.ssd_decode_step, TS.ssd_decode_step,
                               x, dt, a, bi, ci, s0)
    _close(ty, jy, ATOL_SUM)
    _close(ts, js, ATOL_SUM)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_stepwise(g):
    """Chunked SSD (prefill) ≡ the token-by-token recurrence (decode), in
    the port alone (the reference's test_ssd_chunked_matches_stepwise)."""
    b, t, h, p, n = 2, 12, 4, 3, 5
    x, dt, a, bi, ci = (torch.from_numpy(z)
                        for z in _ssd_inputs(6, b, t, h, p, g, n))
    y_chunk, s_chunk = TS.ssd_chunked(x, dt, a, bi, ci, chunk=5)
    state = torch.zeros((b, h, p, n))
    ys = []
    for i in range(t):
        y_i, state = TS.ssd_decode_step(x[:, i:i + 1], dt[:, i:i + 1], a,
                                        bi[:, i:i + 1], ci[:, i:i + 1],
                                        state)
        ys.append(y_i)
    torch.testing.assert_close(y_chunk, torch.cat(ys, dim=1), rtol=1e-3,
                               atol=1e-3)
    torch.testing.assert_close(s_chunk, state, rtol=1e-3, atol=1e-3)


def _mamba(cfg_id="mamba2-2.7b", **over):
    cfg = dataclasses.replace(get_config(cfg_id).smoke, **over)
    tcfg = dataclasses.replace(tget_config(cfg_id).smoke, **over)
    p = JS.init_mamba2(jax.random.PRNGKey(0), cfg, jnp.float32)
    # exercise every parameter: biases, skip and norm off their init
    r = _rng(7)
    p = {k: (v + jnp.asarray(r.standard_normal(v.shape).astype(np.float32)
                             * 0.1)
             if k in ("conv_b", "dt_bias", "d_skip", "gate_norm") else v)
         for k, v in p.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return cfg, tcfg, p, tp


def test_init_shapes_match():
    cfg, tcfg, p, _ = _mamba()
    tp = TS.init_mamba2(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    np.testing.assert_allclose(tp["a_log"].numpy(), np.asarray(p["a_log"]),
                               rtol=0, atol=1e-6)
    jc, tc = JS.init_ssm_cache(cfg, 3), TS.init_ssm_cache(tcfg, 3)
    for k in ("conv", "ssm"):
        assert tuple(tc[k].shape) == jc[k].shape
        assert tc[k].dtype == torch.float32 and jc[k].dtype == jnp.float32


@pytest.mark.parametrize("groups", [1, 2])
def test_apply_mamba2_matches(groups):
    """The block without a cache, then prefill into a cache + two decode
    steps: outputs and the cached conv ring and state."""
    cfg, tcfg, p, tp = _mamba(ssm_n_groups=groups)
    x = (_rng(8).standard_normal((2, 11, cfg.d_model)) * 0.5
         ).astype(np.float32)
    jy, _ = JS.apply_mamba2(p, jnp.asarray(x), cfg)
    ty, _ = TS.apply_mamba2(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy, ATOL_SSD)

    jc, tc = JS.init_ssm_cache(cfg, 2), TS.init_ssm_cache(tcfg, 2)
    jy, jc = JS.apply_mamba2(p, jnp.asarray(x[:, :9]), cfg, cache=jc)
    ty, tc2 = TS.apply_mamba2(tp, torch.from_numpy(x[:, :9]), tcfg,
                              cache=tc)
    assert tc2 is tc                     # updated in place
    _close(ty, jy, ATOL_SSD)
    for i in (9, 10):
        jy, jc = JS.apply_mamba2(p, jnp.asarray(x[:, i:i + 1]), cfg,
                                 cache=jc)
        ty, tc = TS.apply_mamba2(tp, torch.from_numpy(x[:, i:i + 1]), tcfg,
                                 cache=tc)
        _close(ty, jy, ATOL_SSD)
    _close(tc["conv"], jc["conv"], ATOL_SUM)
    _close(tc["ssm"], jc["ssm"], ATOL_SSD)


def test_vision_patch_embeddings_shape():
    """The frontend stand-in: (B, P, d) normals × 0.02 drawn from an
    explicit generator, like the reference's from its key."""
    gen = torch.Generator().manual_seed(0)
    e = TF.vision_patch_embeddings(gen, 2, 8, 64)
    j = JF.vision_patch_embeddings(jax.random.PRNGKey(0), 2, 8, 64)
    assert tuple(e.shape) == j.shape and e.dtype == torch.float32
    assert abs(float(e.std()) - float(jnp.std(j))) < 5e-3
    again = TF.vision_patch_embeddings(torch.Generator().manual_seed(0),
                                       2, 8, 64)
    assert torch.equal(e, again)
