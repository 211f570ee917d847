"""The kernels' plain PyTorch versions against the JAX package.

Each kernel module of the port holds a CUDA kernel and its plain version;
on the CPU the wrapper runs the plain version.  The same inputs, made from
a seed with numpy, go through ``repro.kernels.ref`` and through the Pallas
kernel bodies in interpret mode (``impl="pallas_interpret"``).

Tolerances:
  * integer-valued f32 x: every product and partial sum is an exact
    integer in f32, so the affine epilogue sees identical numbers —
    bitwise, except against ``ref.dequant_matmul``, which dequantizes the
    weight before the product (another rounding order): 1e-5.
  * random f32 x: f32 sums in another order, rtol = atol = 1e-5, the atol
    taken relative to the output's largest magnitude for the two matmuls:
    their epilogue s·(Σx·q − z·Σx) subtracts two sums of size ~128·Σ|x|,
    so f32 roundoff there is absolute, not relative to each output.  The
    Pallas kernels round x to bf16 before the product, so x is made
    bf16-representable for those comparisons.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import blocked_codec as jbc
from repro.core import codec as jcodec
from repro.core.compressed import pack_linear
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash

from repro_torch.kernels import _build, ops
from repro_torch.kernels.dequant_matmul import (dequant_matmul,
                                                dequant_matmul_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.fused_decode_matmul import (
    fused_decode_matmul, fused_decode_matmul_plain)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def assert_close_scaled(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.fixture(autouse=True)
def _clear_counts():
    _build.LAUNCH_COUNTS.clear()
    yield
    assert not _build.LAUNCH_COUNTS, "a CPU call launched a kernel"


def _x(rng, m, k, kind):
    if kind == "int":
        return rng.integers(-4, 5, (m, k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if kind == "bf16":      # what the Pallas kernels see after their cast
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _packed(shape, seed, block_weights=4096):
    """A tile-major reference PackedLinear with a non-empty table, and the
    same planes as torch tensors."""
    rng = np.random.default_rng(seed)
    w = np.round(rng.standard_normal(shape) * 3).astype(np.float32) / 3
    from repro.core.compressed import quantize_linear
    vals = np.asarray(quantize_linear(jnp.asarray(w)).values)
    table = jcodec.find_frequent_sequences([vals])
    lut = jbc.build_lut(table)
    pl = pack_linear(jnp.asarray(w), table, lut,
                     block_weights=block_weights, tile="auto")
    t = {"codes": torch.from_numpy(np.array(pl.codes).view(np.int16)),
         "literals": torch.from_numpy(np.array(pl.literals)),
         "lut": torch.from_numpy(np.array(lut)),
         "scale": torch.from_numpy(np.array(pl.scale)),
         "zero": torch.from_numpy(np.array(pl.zero))}
    return pl, lut, t


@pytest.mark.parametrize("shape,m,bw", [
    ((64, 64), 3, 4096), ((96, 160), 5, 1024), ((256, 128), 16, 4096),
    ((32, 48), 7, 256),
])
@pytest.mark.parametrize("kind", ["int", "float", "bf16"])
def test_fused_decode_matmul_plain(shape, m, bw, kind):
    pl, lut, t = _packed(shape, 0, bw)
    x = _x(np.random.default_rng(1), m, shape[1], kind)
    kw = dict(shape=shape, tile_n=pl.tile_n, tile_k=pl.tile_k,
              out_dtype=torch.float32)
    got = fused_decode_matmul(torch.from_numpy(x), t["codes"],
                              t["literals"], t["lut"], t["scale"],
                              t["zero"], **kw).numpy()
    np.testing.assert_array_equal(
        got, fused_decode_matmul_plain(
            torch.from_numpy(x), t["codes"], t["literals"], t["lut"],
            t["scale"], t["zero"], **kw).numpy())
    ref = np.asarray(jref.fused_decode_matmul(
        jnp.asarray(x), pl.codes, pl.literals, pl.nlit, jnp.asarray(lut),
        pl.scale, pl.zero, shape=shape, tile_n=pl.tile_n, tile_k=pl.tile_k))
    if kind == "int":
        np.testing.assert_array_equal(got, ref)
    else:
        assert_close_scaled(got, ref)
    if kind == "float":
        return                       # the Pallas kernel rounds x to bf16
    pallas = np.asarray(jops.decode_dequant_matmul(
        jnp.asarray(x), pl, jnp.asarray(lut), out_dtype=jnp.float32,
        impl="pallas_interpret"))
    if kind == "int":
        np.testing.assert_array_equal(got, pallas)
    else:
        assert_close_scaled(got, pallas)


@pytest.mark.parametrize("n,k,m", [(211, 64, 5), (130, 520, 3), (64, 64, 16)])
@pytest.mark.parametrize("kind", ["int", "float", "bf16"])
def test_dequant_matmul_plain(n, k, m, kind):
    rng = np.random.default_rng(2)
    wq = rng.integers(0, 256, (n, k)).astype(np.uint8)
    scale = (rng.random((n, 1)) * 0.02 + 1e-3).astype(np.float32)
    zero = rng.integers(0, 256, (n, 1)).astype(np.float32)
    x = _x(rng, m, k, kind)
    args = [torch.from_numpy(a) for a in (x, wq, scale, zero)]
    got = dequant_matmul(*args, out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(
        got, dequant_matmul_plain(*args, torch.float32).numpy())
    ref = np.asarray(jref.dequant_matmul(*map(jnp.asarray,
                                              (x, wq, scale, zero))))
    assert_close_scaled(got, ref)
    if kind == "float":
        return
    pallas = np.asarray(jops.dequant_matmul(
        *map(jnp.asarray, (x, wq, scale, zero)), impl="pallas_interpret"))
    if kind == "int":
        np.testing.assert_array_equal(got, pallas)
    else:
        assert_close_scaled(got, pallas)


def test_ops_flatten_leading_dims():
    pl, lut, t = _packed((64, 64), 3)
    from repro_torch.core.compressed import PackedLinear
    tpl = PackedLinear(t["codes"], t["literals"], None, t["scale"],
                       t["zero"], shape=(64, 64), tile_n=pl.tile_n,
                       tile_k=pl.tile_k)
    x = torch.from_numpy(_x(np.random.default_rng(4), 6, 64, "int"))
    y3 = ops.decode_dequant_matmul(x.reshape(2, 3, 64), tpl, t["lut"],
                                   out_dtype=torch.float32)
    y2 = ops.decode_dequant_matmul(x, tpl, t["lut"], out_dtype=torch.float32)
    assert torch.equal(y3.reshape(6, 64), y2)
    assert ops.DISPATCH_COUNTS["fused"] >= 2
    linear = PackedLinear(t["codes"], t["literals"], None, t["scale"],
                          t["zero"], shape=(64, 64))
    with pytest.raises(NotImplementedError):
        ops.decode_dequant_matmul(x, linear, t["lut"])


def _qkv(seed, b, hq, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, tq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, tk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, tk, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,tq,tk,q_offset,causal", [
    (2, 4, 2, 37, 53, 16, True),     # GQA, ragged, offset (chunked prefill)
    (1, 8, 2, 29, 29, 0, True),      # prime T, full prefill
    (2, 4, 4, 13, 41, 0, False),
    (1, 4, 1, 7, 1300, 1200, True),  # reference's chunked path (Tk > 1024)
])
def test_flash_attention_plain_vs_ref(b, hq, hkv, tq, tk, q_offset, causal):
    q, k, v = _qkv(5, b, hq, hkv, tq, tk, 16)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          q_offset=q_offset).numpy()
    np.testing.assert_array_equal(got, flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)), causal=causal,
        q_offset=q_offset).numpy())
    ref = np.asarray(jref.flash_attention(*map(jnp.asarray, (q, k, v)),
                                          causal=causal, q_offset=q_offset))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("tq,tk,q_offset,bq,bk", [
    (48, 80, 32, 16, 16), (32, 32, 0, 16, 8), (24, 64, 40, 8, 32),
])
def test_flash_attention_plain_vs_pallas(tq, tk, q_offset, bq, bk):
    q, k, v = _qkv(6, 2, 4, 2, tq, tk, 16)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                          q_offset=q_offset).numpy()
    pallas = np.asarray(pallas_flash(
        *map(jnp.asarray, (q, k, v)), q_offset=q_offset, bq=bq, bk=bk,
        interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)


def test_flash_attention_strided_views():
    """The layers hand (B, T, H, D) tensors over transposed, not copied."""
    q, k, v = _qkv(7, 2, 4, 2, 9, 11, 16)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  .transpose(1, 2) for a in (q, k, v))
    assert not qt.is_contiguous()
    torch.testing.assert_close(
        flash_attention(qt, kt, vt, q_offset=2),
        flash_attention(*map(torch.from_numpy, (q, k, v)), q_offset=2),
        rtol=0, atol=0)
