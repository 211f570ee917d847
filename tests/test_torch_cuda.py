"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA card every test skips.  On the machine with
the card (which has no JAX, so the repository's conftest cannot load):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Shapes are ragged or small on purpose (the main path's shapes are checked
by chip_smoke.py).  Tolerances: integer-valued bf16 x → bitwise; random
bf16 x with f32 output → the same exact products summed in another order,
1e-4 of the output's largest magnitude; attention in f32 → 1e-4, in bf16
→ two bf16 ulps at |out| ≈ 1.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.blocked_codec import (TableIndex, build_lut,
                                            choose_fused_tiles,
                                            encode_blocked_tiled)
from repro_torch.core.codec import find_frequent_sequences
from repro_torch.core.compressed import quantize_linear
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import _build
from repro_torch.kernels import dequant_matmul as dqm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_decode_matmul as fdm
from repro_torch.models import lm as LM
from repro_torch.serve.engine import build_serve_params, make_serve_fns

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _gen(device, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _xs(m, k, g, device):
    xi = torch.randint(-4, 5, (m, k), generator=g, device=device)
    xr = torch.randn((m, k), generator=g, device=device)
    return xi.to(torch.bfloat16), xr.to(torch.bfloat16)


def _check_matmul(kernel, plain, xi, xr):
    assert torch.equal(kernel(xi, torch.bfloat16), plain(xi, torch.bfloat16))
    yk, yp = kernel(xr, torch.float32), plain(xr, torch.float32)
    err = (yk - yp).abs().max().item()
    assert err <= 1e-4 * yp.abs().max().item(), err


@pytest.mark.parametrize("n,k,m,levels", [
    (64, 64, 1, 2), (64, 64, 37, 2), (192, 128, 9, 300), (256, 512, 130, 3),
    (128, 96, 70, 300), (2048, 2048, 5, 2),
])
def test_fused_decode_matmul_on_card(card, n, k, m, levels):
    g = _gen(card)
    w = torch.randint(-levels, levels + 1, (n, k), generator=g,
                      device=card).float() / levels
    q = quantize_linear(w)
    table = find_frequent_sequences([q.values])
    tn, tk, bw = choose_fused_tiles((n, k))
    bc = encode_blocked_tiled(q.values, TableIndex(table, device=card),
                              tile_n=tn, tile_k=tk, block_weights=bw)
    args = (bc.codes, bc.literals, build_lut(table, device=card), q.scale,
            q.zero)
    kw = dict(shape=(n, k), tile_n=tn, tile_k=tk)
    xi, xr = _xs(m, k, g, card)
    _check_matmul(
        lambda x, dt: fdm.fused_decode_matmul(x, *args, **kw, out_dtype=dt),
        lambda x, dt: fdm.fused_decode_matmul_plain(x, *args, **kw,
                                                    out_dtype=dt), xi, xr)


@pytest.mark.parametrize("n,k,m", [(211, 64, 5), (130, 100, 3),
                                   (1000, 512, 40), (64, 2048, 1)])
def test_dequant_matmul_on_card(card, n, k, m):
    g = _gen(card, 1)
    q = quantize_linear(torch.randn((n, k), generator=g, device=card))
    xi, xr = _xs(m, k, g, card)
    _check_matmul(
        lambda x, dt: dqm.dequant_matmul(x, q.values, q.scale, q.zero, dt),
        lambda x, dt: dqm.dequant_matmul_plain(x, q.values, q.scale, q.zero,
                                               dt), xi, xr)


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,off,dtype", [
    (2, 4, 2, 70, 70, 64, 0, torch.float32),
    (1, 32, 8, 197, 229, 64, 0, torch.bfloat16),
    (2, 8, 2, 33, 100, 128, 20, torch.float32),
    (1, 4, 4, 1, 50, 64, 49, torch.bfloat16),
])
def test_flash_attention_on_card(card, b, hq, hkv, tq, tk, d, off, dtype):
    g = _gen(card, 2)
    q = torch.randn((b, hq, tq, d), generator=g, device=card).to(dtype)
    k = torch.randn((b, hkv, tk, d), generator=g, device=card).to(dtype)
    v = torch.randn((b, hkv, tk, d), generator=g, device=card).to(dtype)
    err = (fa.flash_attention(q, k, v, q_offset=off).float()
           - fa.flash_attention_plain(q, k, v, q_offset=off).float()
           ).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 1.6e-2), err


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.zeros((2, 64), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(torch.zeros((1, 2, 3, 16), device=card),
                           torch.zeros((1, 2, 3, 16), device=card),
                           torch.zeros((1, 2, 3, 16), device=card))
    with pytest.raises(TypeError):
        dqm.dequant_matmul(x, torch.zeros((8, 64), device=card),
                           torch.ones((8, 1), device=card),
                           torch.zeros((8, 1), device=card))


def test_prefill_card_matches_cpu(card):
    """A small llama (head_dim 64) packed on the card: prefill logits on
    the card equal the CPU's plain versions to bf16 accuracy, and the
    kernels ran."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").smoke, d_model=256,
                              n_heads=4, n_kv_heads=2, head_dim=64,
                              d_ff=512)
    params = LM.init_lm(cfg, seed=0, device=card)
    st = build_serve_params(params, CompressionPolicy(min_weight_size=1024),
                            device=card)
    ids = torch.randint(0, cfg.vocab_size, (3, 19),
                        generator=_gen(card, 3), device=card)
    out = {}
    _build.LAUNCH_COUNTS.clear()
    for dev, s in (("cuda", st), ("cpu", st.to("cpu"))):
        prefill, _ = make_serve_fns(cfg, device=dev)
        caches = LM.init_caches(cfg, 3, 24, device=dev)
        logits, _ = prefill(s.params, s.lut, {"tokens": ids}, caches)
        out[dev] = logits.float().cpu()
    assert _build.LAUNCH_COUNTS["fused_decode_matmul"] == 7 * cfg.n_layers
    assert _build.LAUNCH_COUNTS["flash_attention"] == cfg.n_layers
    assert _build.LAUNCH_COUNTS["dequant_matmul"] == 1
    assert (out["cuda"] - out["cpu"]).abs().max().item() <= 3e-2
