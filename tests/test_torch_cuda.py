"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA card every test skips.  On the machine with
the card (which has no JAX, so the repository's conftest cannot load):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Shapes are ragged or small on purpose (the main paths' shapes are checked
by chip_smoke.py).  Tolerances: integer-valued bf16 x → bitwise; random
bf16 x with f32 output → the same exact products summed in another order,
1e-4 of the output's largest magnitude; attention in f32 → 1e-4, in bf16
→ two bf16 ulps at |out| ≈ 1; the dictionary decode is integer work →
bitwise on every input.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.blocked_codec import (TableIndex, build_lut,
                                            choose_fused_tiles,
                                            encode_blocked,
                                            encode_blocked_tiled)
from repro_torch.core.codec import find_frequent_sequences
from repro_torch.core.compressed import (pack_expert_stack,
                                         pack_linear_tiled, quantize_linear)
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import _build, ops
from repro_torch.kernels import dequant_matmul as dqm
from repro_torch.kernels import dict_decode as ddc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_decode_matmul as fdm
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import ssm as SSM
from repro_torch.serve import engine as E
from repro_torch.serve.context import ServeContext
from repro_torch.serve.engine import build_serve_params, make_serve_fns
from repro_torch.serve.scheduler import Engine, Request

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
    (256, 704, 700, 300),   # tile_k 64, 11 tiles: no multiple of the span
    (384, 1024, 129, 2),    # one row past a band: two bands per block
    (128, 130, 4, 2),       # tile_k 2: a gram spans two rows of a tile
    (128, 130, 129, 300),
    (128, 131, 4, 300),     # tile_k 1: a gram spans four
    (128, 131, 129, 2),
    # the decode kernel at 5–16 rows (four row groups of 4)
    (2048, 2048, 5, 2), (2048, 2048, 8, 300), (2048, 2048, 16, 2),
    (256, 2816, 13, 300),   # tile_k 256, 11 tiles
    (128, 96, 16, 300),     # tile_k 32: a lane a row
    (128, 208, 8, 2),       # tile_k 16: rows in a lane, SIMT product
    (128, 136, 16, 300),    # tile_k 8
    (128, 132, 5, 2),       # tile_k 4
    # the tensor-core kernel below tile_k 64: 11 tiles of 32, 13 of 16,
    # 17 of 8, 33 of 4 with rows 8 bytes out of step (K ≡ 4 mod 8)
    (256, 352, 700, 300), (256, 208, 700, 2), (128, 136, 129, 300),
    (128, 132, 129, 2), (128, 352, 17, 2),
])
def test_fused_decode_matmul_on_card(card, n, k, m, levels):
    """K1 against its plain version (bitwise on integer x, within 1e-4 of
    the output's scale on random x) through the kernel the plan picks:
    the decode kernel at M ≤ 16, the tensor-core kernel above (any tile_k
    ≥ 4), the SIMT kernel at tile_k 1 and 2."""
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
    _check_kernel(fdm.NAME, m, tk, lambda: fdm.fused_decode_matmul(
        xi, *args, **kw))


def _check_kernel(name, m, tile_k, fn):
    """One call of fn launches the kernel the plan must pick: decode at
    M ≤ 16, the tensor-core kernel above, SIMT only at tile_k 1 and 2."""
    want = ("simt" if tile_k < 4 else "decode" if m <= fdm.DECODE_MAX_M
            else "mma")
    _build.KERNEL_COUNTS.clear()
    fn()
    assert dict(_build.KERNEL_COUNTS) == {f"{name}:{want}": 1}


@pytest.mark.parametrize("e,n,k,tile_k", [
    (1, 2048, 2048, 512),     # Llama-3.2-1B wq, wo
    (1, 512, 2048, 512),      # wk, wv
    (1, 8192, 2048, 512),     # w_gate, w_up
    (1, 2048, 8192, 512),     # w_down
    (1, 576, 2048, 512),      # DeepSeek-V2-Lite MLA wkv_a (tile_n 64)
    (1, 2048, 2816, 256),     # shared experts' w_down
    (1, 2048, 10944, 64),     # first layer's w_down
    (64, 1408, 2048, 512),    # expert stacks: gate / up
    (64, 2048, 1408, 128),    # down
])
def test_decode_kernel_on_card(card, e, n, k, tile_k):
    """The decode-batch kernel at both paths' decode shapes, M = 1 to 4:
    bitwise equal to the plain version on integer x, within 1e-4 of the
    output's scale on random x, two calls bitwise equal, one launch."""
    g = _gen(card, 7)
    ws = [torch.randn((n, k), generator=g, device=card) * 0.02
          for _ in range(e)]
    pl, lut = pack_expert_stack(ws)
    del ws
    assert pl.tile_k == tile_k
    kw = dict(shape=pl.shape, tile_n=pl.tile_n, tile_k=pl.tile_k)
    if e == 1:
        args = (pl.codes[0], pl.literals[0], lut, pl.scale[0], pl.zero[0])
        kernel, plain = fdm.fused_decode_matmul, fdm.fused_decode_matmul_plain
    else:
        args = (pl.codes, pl.literals, lut, pl.scale, pl.zero)
        kernel = fdm.grouped_fused_decode_matmul
        plain = fdm.grouped_fused_decode_matmul_plain
    for m in (1, 2, 3, 4):
        plan = fdm.launch_plan(m, n, k, tile_k, e, 132, pl.codes.shape[-1])
        assert plan.kernel == "decode" and plan.splits == 1
        shape = (e, m, k) if e > 1 else (m, k)
        xi = torch.randint(-4, 5, shape, generator=g, device=card
                           ).to(torch.bfloat16)
        xr = torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
        _check_matmul(lambda x, dt: kernel(x, *args, **kw, out_dtype=dt),
                      lambda x, dt: plain(x, *args, **kw, out_dtype=dt),
                      xi, xr)
        _build.LAUNCH_COUNTS.clear()
        _build.KERNEL_COUNTS.clear()
        y1 = kernel(xr, *args, **kw, out_dtype=torch.float32)
        y2 = kernel(xr, *args, **kw, out_dtype=torch.float32)
        assert sum(_build.LAUNCH_COUNTS.values()) == 2
        assert dict(_build.KERNEL_COUNTS) == {
            f"{fdm.NAME if e == 1 else fdm.GROUPED_NAME}:decode": 2}
        assert torch.equal(y1, y2)


@pytest.mark.parametrize("n,k,m", [
    (211, 64, 5), (130, 100, 3), (1000, 512, 40), (64, 2048, 1),
    # both paths' int8 LM heads at decode batch: the decode kernel
    (128256, 2048, 1), (128256, 2048, 2), (128256, 2048, 3),
    (128256, 2048, 4),
    (102400, 2048, 1), (102400, 2048, 2), (102400, 2048, 3),
    (102400, 2048, 4),
    (1003, 2048, 4),        # N ragged against the 8-row warp tasks
    (37, 48, 2),            # K not a whole stage
    (40, 28672, 3),         # x past 48 KB of shared memory
    (130, 100, 4),          # K % 16 != 0 at M = 4: the SIMT kernel
    (130, 100, 40),         # ... and at prefill M
    # quant mode's projections (Llama-3.2-1B: q/o, k/v, gate/up, down) at
    # 5 and 16 rows (the decode kernel's row groups) and from 17 on (the
    # tensor-core kernel, split-K where tiles are few)
    *[(n, k, m) for n, k in ((2048, 2048), (512, 2048), (8192, 2048),
                             (2048, 8192))
      for m in (5, 16, 17, 64, 175, 700)],
    (1003, 2048, 131),      # ragged M and N against the 128 × 128 tiles
    (1003, 2048, 13),       # the decode kernel's row groups, ragged N
    (128256, 2048, 16),     # the head at an engine tick of 16 slots
])
def test_dequant_matmul_on_card(card, n, k, m):
    """K5 (quantized from seeded random weights): bitwise equal to the
    plain version on integer x, within 1e-4 of the output's scale on
    random x, two calls bitwise equal, the launches of the kernel the
    plan picks: the decode kernel at M ≤ 16 (one launch a group of 4
    rows), the tensor-core kernel from MMA_MIN_M on, the SIMT kernel where
    K % 16 ≠ 0."""
    g = _gen(card, 1)
    q = quantize_linear(torch.randn((n, k), generator=g, device=card))
    xi, xr = _xs(m, k, g, card)
    _check_matmul(
        lambda x, dt: dqm.dequant_matmul(x, q.values, q.scale, q.zero, dt),
        lambda x, dt: dqm.dequant_matmul_plain(x, q.values, q.scale, q.zero,
                                               dt), xi, xr)
    plan = dqm.dequant_plan(m, n, k, 132)
    assert plan.kernel == ("simt" if k % 16 else "decode"
                           if m < dqm.MMA_MIN_M else "mma")
    launches = 2 * (-(-m // 4) if plan.kernel == "decode" else 1)
    _build.LAUNCH_COUNTS.clear()
    _build.KERNEL_COUNTS.clear()
    y1 = dqm.dequant_matmul(xr, q.values, q.scale, q.zero, torch.float32)
    y2 = dqm.dequant_matmul(xr, q.values, q.scale, q.zero, torch.float32)
    assert dict(_build.LAUNCH_COUNTS) == {dqm.NAME: launches}
    assert dict(_build.KERNEL_COUNTS) == {
        f"{dqm.NAME}:{plan.kernel}": launches}
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,dv,off,dtype,layout", [
    (2, 4, 2, 70, 70, 64, 64, 0, torch.float32, "contiguous"),
    (1, 32, 8, 197, 229, 64, 64, 0, torch.bfloat16, "contiguous"),
    (2, 8, 2, 33, 100, 128, 128, 20, torch.float32, "contiguous"),
    (1, 4, 4, 1, 50, 64, 64, 49, torch.bfloat16, "contiguous"),
    (2, 16, 16, 37, 69, 192, 128, 0, torch.float32, "contiguous"),
    (1, 16, 16, 101, 133, 192, 128, 32, torch.bfloat16, "contiguous"),
    (2, 16, 8, 64, 64, 192, 128, 5, torch.float32, "contiguous"),    # GQA, one q block
    (1, 8, 2, 1, 207, 64, 64, 206, torch.bfloat16, "contiguous"),    # one row, full cache
    (2, 4, 2, 15, 15, 64, 64, 0, torch.bfloat16, "contiguous"),      # a warp's ragged tail
    (1, 4, 4, 65, 80, 128, 128, 15, torch.bfloat16, "contiguous"),   # a block's tail
    (1, 4, 2, 40, 129, 64, 64, 89, torch.bfloat16, "contiguous"),    # Tk = 64·2 + 1
    (4, 32, 8, 175, 207, 64, 64, 0, torch.bfloat16, "contiguous"),   # Llama: GQA rep 4
    (4, 16, 16, 175, 207, 192, 128, 0, torch.bfloat16, "contiguous"),  # MLA's prefill
    (3, 4, 2, 16, 16, 16, 16, 0, torch.bfloat16, "contiguous"),      # Llama's smoke config
    (3, 4, 2, 70, 70, 16, 16, 0, torch.float32, "contiguous"),
    (3, 4, 4, 16, 16, 24, 16, 0, torch.bfloat16, "contiguous"),      # MLA's smoke config
    (2, 4, 4, 70, 135, 24, 16, 65, torch.bfloat16, "contiguous"),    # Dqk 24, K tiles
    (3, 4, 4, 37, 37, 24, 16, 0, torch.float32, "contiguous"),
    # f32 at the training shapes (4 × 256 tokens), and on the views the
    # layers pass ((B, T, H, D) transposed), not causal, beside bf16 k/v
    # (and bf16 q beside f32 k/v: bf16 out), and unaligned
    (4, 32, 8, 256, 256, 64, 64, 0, torch.float32, "contiguous"),
    (4, 16, 16, 256, 256, 192, 128, 0, torch.float32, "contiguous"),
    (2, 32, 8, 256, 256, 64, 64, 0, torch.float32, "views"),
    (2, 16, 16, 256, 256, 192, 128, 0, torch.float32, "views"),
    (2, 8, 2, 70, 100, 64, 64, 0, torch.float32, "noncausal"),
    (2, 4, 4, 37, 69, 192, 128, 0, torch.float32, "noncausal"),
    (4, 32, 8, 175, 207, 64, 64, 0, torch.float32, "mixed"),
    (4, 16, 16, 175, 207, 192, 128, 0, torch.float32, "mixed"),
    (2, 4, 2, 33, 50, 64, 64, 3, torch.bfloat16, "mixed"),
    (2, 8, 2, 37, 70, 64, 64, 5, torch.float32, "unaligned"),
    (2, 4, 4, 40, 129, 192, 128, 89, torch.float32, "unaligned"),
    (2, 4, 2, 45, 45, 24, 16, 0, torch.float32, "views"),
])
def test_flash_attention_on_card(card, b, hq, hkv, tq, tk, d, dv, off,
                                 dtype, layout):
    """bf16 operands run the bf16 kernel (``flash_attention:mma``), any f32
    operand the f32 kernel (three-term TF32, ``flash_attention:tf32x3``);
    each launch counts under its own name.  ``layout``: contiguous;
    ``views``, (B, T, H, D) tensors transposed as models/layers.py passes
    them; ``noncausal``; ``mixed``, k and v in the other dtype than q (the
    wrapper upcasts to f32); ``unaligned``, v's rows dv + 1 elements apart
    (the wrapper copies it contiguous).  Within 1e-4 of the plain version
    for an f32 output, two bf16 ulps for a bf16 one."""
    g = _gen(card, 2)
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    kv_dtype = other if layout == "mixed" else dtype

    def draw(*shape, dt=dtype):
        if layout == "views":          # (B, T, H, D) → (B, H, T, D) views
            x = torch.randn((shape[0], shape[2], shape[1], shape[3]),
                            generator=g, device=card).to(dt)
            return x.transpose(1, 2)
        return torch.randn(shape, generator=g, device=card).to(dt)

    q = draw(b, hq, tq, d)
    k, v = draw(b, hkv, tk, d, dt=kv_dtype), draw(b, hkv, tk, dv, dt=kv_dtype)
    if layout == "unaligned":
        v = torch.randn((b, hkv, tk, dv + 1), generator=g, device=card
                        ).to(dtype)[..., :dv]
        assert v.stride(2) % 4
    causal = layout != "noncausal"
    _build.LAUNCH_COUNTS.clear()
    _build.KERNEL_COUNTS.clear()
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=off)
    bf16 = dtype == kv_dtype == torch.bfloat16
    assert dict(_build.LAUNCH_COUNTS) == {fa.NAME if bf16 else fa.F32_NAME: 1}
    assert dict(_build.KERNEL_COUNTS) == {
        "flash_attention:mma" if bf16 else "flash_attention:tf32x3": 1}
    assert got.shape == (b, hq, tq, dv) and got.dtype == dtype
    err = (got.float() - fa.flash_attention_plain(
        q, k, v, causal=causal, q_offset=off).float()).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 1.6e-2), err


@pytest.mark.parametrize("layout", ["noncausal", "cache_views", "unaligned"])
def test_flash_attention_bf16_layouts_on_card(card, layout):
    """The tensor-core kernel without the causal mask, on transposed views
    of (B, L, H, D) caches as models/layers.py passes them (a cache longer
    than the keys written, q_offset into it), and on an operand whose
    T-stride is not a multiple of 8 elements (the wrapper copies it
    contiguous first): within 1.6e-2 of the plain version, bf16."""
    g = _gen(card, 6)
    b, hq, hkv, tq, d = 2, 8, 2, 37, 64
    causal, off = layout != "noncausal", 0
    if layout == "cache_views":
        tk, off = 100, 50
        cache = torch.randn((b, tk, 2 * hkv, d), generator=g, device=card
                            ).to(torch.bfloat16)
        k = cache[:, :, :hkv].transpose(1, 2)
        v = cache[:, :, hkv:].transpose(1, 2)
        q = torch.randn((b, tq, hq, d), generator=g, device=card
                        ).to(torch.bfloat16).transpose(1, 2)
        assert not (q.is_contiguous() or k.is_contiguous())
    else:
        tk = 70
        q = torch.randn((b, hq, tq, d), generator=g, device=card
                        ).to(torch.bfloat16)
        k = torch.randn((b, hkv, tk, d), generator=g, device=card
                        ).to(torch.bfloat16)
        v = torch.randn((b, hkv, tk, d), generator=g, device=card
                        ).to(torch.bfloat16)
    if layout == "unaligned":        # rows 68 elements apart
        wide = torch.randn((b, hkv, tk, d + 4), generator=g, device=card
                           ).to(torch.bfloat16)
        v = wide[..., :d]
        assert v.stride(2) % 8
    _build.LAUNCH_COUNTS.clear()
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=off)
    assert dict(_build.LAUNCH_COUNTS) == {fa.NAME: 1}
    want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off)
    err = (got.float() - want.float()).abs().max().item()
    assert got.is_contiguous() and err <= 1.6e-2, err


@pytest.mark.parametrize("e,n,k,m", [
    (5, 48, 64, 4),       # prime E, N tile 16: several N tiles per block
    (7, 24, 96, 83),      # odd cap past 16 rows, tile_k 32 (SIMT rows)
    (3, 256, 512, 130),   # tensor-core rows, ragged M
    (4, 192, 128, 4),     # a ragged last 128-column block
    (64, 128, 256, 4),    # 64 experts at decode
    (64, 640, 640, 83),   # 64 experts at a prefill cap, two spans a block
    (3, 128, 130, 83),    # tile_k 2
    (64, 128, 256, 8),    # 64 experts at capacity 8 and 16: row groups
    (64, 128, 256, 16),
    (7, 24, 96, 5),       # tile_k 32 at 5 rows
    (5, 48, 208, 16),     # tile_k 16 at 16 rows
    (3, 128, 352, 130),   # 11 tiles of 32 on the tensor cores
])
def test_grouped_fused_decode_matmul_on_card(card, e, n, k, m):
    g = _gen(card, 4)
    ws = [torch.randint(-3, 4, (n, k), generator=g, device=card).float() / 3
          for _ in range(e)]
    pl, lut = pack_expert_stack(ws)
    args = (pl.codes, pl.literals, lut, pl.scale, pl.zero)
    kw = dict(shape=pl.shape, tile_n=pl.tile_n, tile_k=pl.tile_k)
    xi = torch.randint(-4, 5, (e, m, k), generator=g, device=card
                       ).to(torch.bfloat16)
    xr = torch.randn((e, m, k), generator=g, device=card).to(torch.bfloat16)
    _check_matmul(
        lambda x, dt: fdm.grouped_fused_decode_matmul(x, *args, **kw,
                                                      out_dtype=dt),
        lambda x, dt: fdm.grouped_fused_decode_matmul_plain(
            x, *args, **kw, out_dtype=dt), xi, xr)
    # one launch for the stack, and each expert equals K1 on its planes
    _build.LAUNCH_COUNTS.clear()
    y = fdm.grouped_fused_decode_matmul(xi, *args, **kw)
    assert _build.LAUNCH_COUNTS[fdm.GROUPED_NAME] == 1
    for j in (0, e - 1):
        assert torch.equal(y[j], fdm.fused_decode_matmul(
            xi[j], pl.codes[j], pl.literals[j], lut, pl.scale[j],
            pl.zero[j], **kw))
    _check_kernel(fdm.GROUPED_NAME, m, pl.tile_k,
                  lambda: fdm.grouped_fused_decode_matmul(xi, *args, **kw))


def _dict_weights(n, escapes, g, device):
    """n uint8 weights and a gram table: "all" — no gram is in the table;
    "none" — every gram is (values 0–3, all 256 grams); "mixed" — half the
    grams, drawn at random, are; "half" — the first half's grams are."""
    w = torch.randint(0, 256, (n // 4, 4), generator=g, device=device
                      ).to(torch.uint8)
    if escapes == "mixed":
        hit = torch.rand(n // 4, generator=g, device=device) < 0.5
        w[hit] %= 4
    elif escapes == "half":
        w[: n // 8] %= 4
    elif escapes == "none":
        w %= 4
    if escapes == "all":
        table = {(1, 2, 3, 4): 0}
        assert not (w == torch.tensor([1, 2, 3, 4], device=device)
                    ).all(1).any()
    else:
        table = {g: i for i, g in enumerate(
            itertools.product(range(4), repeat=4))}
    return w.reshape(-1), table


@pytest.mark.parametrize("n_weights,block_weights,escapes,cap", [
    (13 * 4096, 4096, "half", None),      # prime block count
    (9 * 400 + 40, 400, "half", None),    # 100 slots, ragged end
    (9 * 408 + 40, 408, "mixed", None),   # 102 slots: the scalar path
    (4096 * 512, 4096, "half", None),     # MLA wkv_b's size: 512 blocks
    (4096 * 512, 4096, "all", None),      # ... the random-weight path
    (64 * 4096, 4096, "none", None),      # no escapes
    (64 * 4096, 4096, "mixed", None),     # escapes interleaved in a block
    (37 * 400 - 40, 400, "mixed", None),  # 100 slots, ragged end
    (7 * 10240, 10240, "mixed", None),    # 2560 slots: 3 chunks
    (7 * 10008 - 8, 10008, "all", None),  # 2502: chunks, scalar path
    (64 * 4096, 4096, "all", 300),        # cap below the blocks' escapes
    (7 * 10240, 10240, "mixed", 700),     # ... from the second chunk on
])
def test_dict_decode_on_card(card, n_weights, block_weights, escapes, cap):
    """K4 bitwise against its plain version; two calls give the same bits,
    and so do codes that start off a 16-byte boundary (the scalar path)."""
    w, table = _dict_weights(n_weights, escapes, _gen(card, 5), card)
    bc = encode_blocked(w, TableIndex(table, device=card),
                        block_weights=block_weights)
    lut = build_lut(table, device=card)
    lits = bc.literals
    if cap is not None:
        assert cap < int(bc.nlit.max())
        lits = lits[:, :cap].contiguous()
    got = ddc.dict_decode(bc.codes, lits, lut)
    assert torch.equal(got, ddc.dict_decode_plain(bc.codes, lits, lut))
    assert torch.equal(ddc.dict_decode(bc.codes, lits, lut), got)
    nb, slots = bc.codes.shape
    shifted = torch.empty(nb * slots + 1, dtype=torch.int16,
                          device=card)[1:].view(nb, slots)
    shifted.copy_(bc.codes)
    assert shifted.data_ptr() % 16
    assert torch.equal(ddc.dict_decode(shifted, lits, lut), got)
    if cap is None:
        assert torch.equal(got.reshape(-1)[:n_weights], w)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.zeros((2, 64), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(torch.zeros((1, 2, 3, 32), device=card),
                           torch.zeros((1, 2, 3, 32), device=card),
                           torch.zeros((1, 2, 3, 32), device=card))
    with pytest.raises(ValueError, match="head_dim"):      # (192, 64)
        fa.flash_attention(torch.zeros((1, 2, 3, 192), device=card),
                           torch.zeros((1, 2, 3, 192), device=card),
                           torch.zeros((1, 2, 3, 64), device=card))
    with pytest.raises(TypeError):
        dqm.dequant_matmul(x, torch.zeros((8, 64), device=card),
                           torch.ones((8, 1), device=card),
                           torch.zeros((8, 1), device=card))
    with pytest.raises(ValueError, match="boundary"):      # misaligned wq
        wq = torch.zeros(8 * 64 + 1, dtype=torch.uint8, device=card)
        dqm.dequant_matmul(x, wq[1:].view(8, 64),
                           torch.ones((8, 1), device=card),
                           torch.zeros((8, 1), device=card))
    ws = [torch.ones((16, 64), device=card)] * 3
    pl, lut = pack_expert_stack(ws)
    args = (pl.codes, pl.literals, lut, pl.scale, pl.zero)
    kw = dict(shape=pl.shape, tile_n=pl.tile_n, tile_k=pl.tile_k)
    with pytest.raises(ValueError, match="weight"):        # 2 x for 3
        fdm.grouped_fused_decode_matmul(torch.zeros((2, 4, 64), device=card),
                                        *args, **kw)
    # a linear-layout stack is no longer refused: it takes the two-step
    # path, K4 then the dense product, as the tile-major stack does there
    lin, lut_l = pack_expert_stack(ws, tile=None)
    x3 = torch.ones((3, 4, 64), device=card)
    linear = ops.grouped_decode_dequant_matmul(x3, lin, lut_l)
    ops.set_default_impl("unfused")
    try:
        assert torch.equal(linear,
                           ops.grouped_decode_dequant_matmul(x3, pl, lut))
    finally:
        ops.set_default_impl("auto")
    codes = torch.zeros((2, 256), dtype=torch.int16, device=card)
    with pytest.raises(ValueError, match="boundary"):      # misaligned
        lits = torch.zeros(2 * 4 + 1, dtype=torch.uint8, device=card)
        ddc.dict_decode(codes, lits[1:].view(2, 1, 4), lut)
    with pytest.raises(ValueError, match="at most"):       # 2^30 + 8 slots
        ddc.dict_decode(codes[:1, :1].expand(1, (1 << 30) + 8),
                        torch.zeros((1, 1, 4), dtype=torch.uint8,
                                    device=card), lut)
    with pytest.raises(ValueError, match="at most"):       # 2^31 blocks
        ddc.dict_decode(codes[:1, :1].expand(1 << 31, 1),
                        torch.zeros((1, 1, 4), dtype=torch.uint8,
                                    device=card).expand(1 << 31, 1, 4), lut)


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


def test_moe_prefill_card_matches_cpu(card):
    """A small DeepSeek-V2-Lite variant with MLA's head dims (192/128)
    packed on the card: prefill logits on the card equal the CPU's plain
    versions to bf16 accuracy, and every kernel of the MoE path ran."""
    cfg = dataclasses.replace(
        get_config("deepseek-v2-lite-16b").smoke, d_model=256, n_heads=4,
        n_kv_heads=4, kv_lora_rank=128, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, d_ff=512, moe_d_ff=128)
    params = LM.init_lm(cfg, seed=0, device=card)
    st = build_serve_params(params, CompressionPolicy(min_weight_size=1024),
                            device=card)
    ids = torch.randint(0, cfg.vocab_size, (3, 19),
                        generator=_gen(card, 3), device=card)
    out, routing = {}, {}
    _build.LAUNCH_COUNTS.clear()
    L.MATERIALIZE_COUNTS.clear()
    for dev, s in (("cuda", st), ("cpu", st.to("cpu"))):
        caches = LM.init_caches(cfg, 3, 24, device=dev)
        hidden, _, _, routing[dev] = LM.forward(
            s.params, cfg, ids.to(dev), caches=caches, pos=0, lut=s.lut,
            return_hidden=True, return_routing=True)
        out[dev] = L.linear(hidden[:, -1:], s.params["lm_head"], s.lut
                            ).float().cpu()
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert _build.LAUNCH_COUNTS[fdm.GROUPED_NAME] == 3 * n_moe
    assert _build.LAUNCH_COUNTS["fused_decode_matmul"] == 6 * cfg.n_layers
    assert _build.LAUNCH_COUNTS["dict_decode"] == cfg.n_layers
    assert _build.LAUNCH_COUNTS["flash_attention"] == cfg.n_layers
    assert _build.LAUNCH_COUNTS["dequant_matmul"] == 1
    assert L.MATERIALIZE_COUNTS["packed_stacked"] == 0
    # bf16 router logits can tie near the top-k boundary, so a few tokens
    # may take another expert set on the card; a request whose last token
    # does is left out of the logit check (at most one of the three)
    b, t = ids.shape
    differs = (routing["cuda"].cpu().sort(-1).values
               != routing["cpu"].sort(-1).values).any(-1).any(0)
    assert int(differs.sum()) <= b * t // 10, int(differs.sum())
    kept = ~differs.reshape(b, t)[:, -1]
    assert int(kept.sum()) >= b - 1
    err = (out["cuda"] - out["cpu"]).abs()[kept].max().item()
    assert err <= 3e-2, err


# -- the decode phase as one captured graph ---------------------------------

def _card_cfg(family):
    """Smoke-width variants with head dims the flash kernel takes (64;
    MLA's 192 / 128); Mamba2 and Zamba2 at head dim 64 with a state of 32
    (13-token prompts span two of their 8-token chunks); Qwen3 (qk-norm)
    with the int8 KV cache."""
    if family == "llama":
        return dataclasses.replace(get_config("llama3.2-1b").smoke,
                                   d_model=256, n_heads=4, n_kv_heads=2,
                                   head_dim=64, d_ff=512)
    if family in ("mamba2", "zamba2"):
        arch = "mamba2-2.7b" if family == "mamba2" else "zamba2-1.2b"
        return dataclasses.replace(get_config(arch).smoke, d_model=256,
                                   n_heads=4, n_kv_heads=4, head_dim=64,
                                   d_ff=512, ssm_state=32, ssm_head_dim=64)
    if family == "qwen3_int8":
        return dataclasses.replace(get_config("qwen3-4b").smoke, d_model=256,
                                   n_heads=4, n_kv_heads=2, head_dim=64,
                                   d_ff=512, kv_cache_bits=8)
    return dataclasses.replace(
        get_config("deepseek-v2-lite-16b").smoke, d_model=256, n_heads=4,
        n_kv_heads=4, kv_lora_rank=128, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, d_ff=512, moe_d_ff=128)


def _card_state(cfg, card, seed=0):
    params = LM.init_lm(cfg, seed=seed, device=card)
    return build_serve_params(params, CompressionPolicy(min_weight_size=1024),
                              device=card)


_COUNTERS = (_build.LAUNCH_COUNTS, ops.DISPATCH_COUNTS, L.MATERIALIZE_COUNTS)


def _counted(fn):
    """fn()'s result and what it added to the launch, dispatch and
    materialize counters."""
    for c in _COUNTERS:
        c.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, [dict(c) for c in _COUNTERS]


def _eager_loop(st, cfg, ids, max_new, temperature=0.0, generator=None):
    """The eager decode loop over make_serve_fns (int positions), as the
    CPU's generate runs it: → the max_new new tokens."""
    prefill, decode_step = make_serve_fns(cfg, device=ids.device)
    b, t0 = ids.shape
    caches = LM.init_caches(cfg, b, t0 + max_new, device=ids.device)
    logits, caches = prefill(st.params, st.lut, {"tokens": ids}, caches)
    toks = [E.sample_tokens(logits)[:, None]]
    for i in range(max_new - 1):
        logits, caches = decode_step(st.params, st.lut, toks[-1], caches,
                                     t0 + i)
        toks.append(E.sample_tokens(logits, temperature, generator)[:, None])
    return torch.cat(toks, dim=1)


@pytest.mark.parametrize("family,temperature", [
    ("llama", 0.0), ("llama", 2.0), ("deepseek", 0.0), ("deepseek", 2.0),
    ("mamba2", 0.0), ("mamba2", 2.0), ("zamba2", 0.0), ("zamba2", 2.0)])
def test_graphed_generate_matches_eager_loop(card, family, temperature):
    """generate on the card (an eager step, one capture, then replays)
    gives the eager loop's tokens bit for bit, greedy and sampled from a
    CUDA generator of the same seed, in a first call (capture) and a
    second (replays only); each call counts the eager loop's launches,
    dispatches and materializations, and only the first captures.  For
    Mamba2 and Zamba2 the replays must read the SSM state the last replay
    wrote into the cache tensors (and the second call's prefill must start
    from a zeroed state)."""
    cfg = _card_cfg(family)
    st = _card_state(cfg, card)
    ids = torch.randint(1, cfg.vocab_size, (3, 13), generator=_gen(card, 5),
                        device=card)
    max_new = 9
    g_eager, g_graph = _gen(card, 11), _gen(card, 11)
    for call in (1, 2):
        want, eager_counts = _counted(lambda: _eager_loop(
            st, cfg, ids, max_new, temperature, g_eager))
        E.CAPTURE_COUNTS.clear()
        got, counts = _counted(lambda: E.generate(
            st.params, cfg, ids, lut=st.lut, max_new=max_new,
            temperature=temperature, generator=g_graph))
        assert E.CAPTURE_COUNTS["decode_loop"] == (1 if call == 1 else 0)
        assert torch.equal(got[:, :13], ids)
        assert torch.equal(got[:, 13:], want), (call, got[:, 13:], want)
        assert counts == eager_counts
    if family == "deepseek":
        assert eager_counts[2] == {"packed": cfg.n_layers * max_new}
    if temperature:
        greedy = _eager_loop(st, cfg, ids, max_new)
        assert not torch.equal(want, greedy)


def test_new_state_captures_again(card):
    """A second ServeState of the same shapes gets a graph of its own (and
    its own tokens); the first state's graph still replays; a state's
    graph goes with its weights."""
    cfg = _card_cfg("llama")
    ids = torch.randint(1, cfg.vocab_size, (2, 11), generator=_gen(card, 6),
                        device=card)
    states = [_card_state(cfg, card, seed) for seed in (0, 1)]
    outs = []
    for st in states:
        E.CAPTURE_COUNTS.clear()
        outs.append(E.generate(st.params, cfg, ids, lut=st.lut, max_new=6))
        assert E.CAPTURE_COUNTS["decode_loop"] == 1
        assert torch.equal(outs[-1][:, 11:], _eager_loop(st, cfg, ids, 6))
    assert not torch.equal(outs[0], outs[1])
    E.CAPTURE_COUNTS.clear()
    again = E.generate(states[0].params, cfg, ids, lut=states[0].lut,
                       max_new=6)
    assert E.CAPTURE_COUNTS["decode_loop"] == 0 and torch.equal(again,
                                                                outs[0])
    n = len(E._GRAPHS)
    del states[1], st
    assert len(E._GRAPHS) == n - 1


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_decode_reads_nothing_on_the_host(card, family):
    """Under set_sync_debug_mode("error") (any synchronizing op raises): a
    decode step with a 0-d and a per-row position tensor, then a graphed
    generate from tokens on the card, its capture included."""
    cfg = _card_cfg(family)
    st = _card_state(cfg, card)
    ids = torch.randint(1, cfg.vocab_size, (3, 13), generator=_gen(card, 7),
                        device=card)
    prefill, decode_step = make_serve_fns(cfg, device=card)
    caches = LM.init_caches(cfg, 3, 16, device=card)
    logits, caches = prefill(st.params, st.lut, {"tokens": ids}, caches)
    tok = torch.argmax(logits, -1)[:, None]
    pos = torch.tensor(13, device=card)
    rows = torch.tensor([13, 13, 13], device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_step(st.params, st.lut, tok, caches, pos)
        decode_step(st.params, st.lut, tok, caches, rows)
        out = E.generate(st.params, cfg, ids, lut=st.lut, max_new=5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(out[:, 13:], _eager_loop(st, cfg, ids, 5))


# -- request-level serving: the engine's generate step as one graph --------

def _engine_cfg(family):
    """``_card_cfg``; the MoE in the dropless regime (capacity ≥ every
    token), where expert capacity cannot depend on the batch."""
    cfg = _card_cfg(family)
    if family == "deepseek":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts)
                                  / cfg.top_k)
    return cfg


@pytest.mark.parametrize("n,k", [(17, 2048), (24, 2048), (32, 2048),
                                 (64, 2048), (32, 128)])
def test_dense_decode_rows_on_card(card, n, k):
    """A dense weight at a decode step's n rows (DeepSeek-V2-Lite's router,
    64 × 2048, and a narrow one): ``layers.linear`` runs GEMMs of 16 rows,
    the last piece padded, so each row's bits are those it has alone."""
    g = _gen(card, n + k)
    w = torch.randn((64, k), generator=g, device=card).to(torch.bfloat16)
    x = torch.randn((n, 1, k), generator=g, device=card).to(torch.bfloat16)
    y = L.linear(x, w)
    for i in range(n):
        assert torch.equal(y[i:i + 1], L.linear(x[i:i + 1], w)), i


@pytest.mark.parametrize("n,family", [
    (n, f) for f in ("llama", "deepseek")
    for n in (4, 5, 8, 16, 17, 24, 32, 64)]
    + [(n, f) for f in ("mamba2", "zamba2") for n in (4, 5, 8, 16, 17, 32)])
def test_decode_rows_do_not_depend_on_the_batch(card, family, n):
    """Each row of a decode step gives the same bits alone (batch 1) as in
    a batch of n beside other rows at other positions: what makes the
    engine's ticks (M = n_slots) equal generate's steps (M = 1), as the
    reference's kernels (K innermost into one accumulator per row block)
    make them.  Checked op by op, every row against itself alone: K1 and
    K5 at M = n (their decode kernels; above 4 rows in groups of 4, above
    16 rows K1 in launches of 16), K3 on the layer's expert stack at
    capacity n (DeepSeek), the decode attention (GQA or MLA's absorbed
    form, above 16 rows in padded pieces of 16; for GQA also at
    Llama-3.2-1B's full head counts), Mamba2's in/out projections and its
    block's recurrent step (Mamba2, Zamba2; the hybrid's shared attention
    too), then the whole step."""
    cfg = _engine_cfg(family)
    st = _card_state(cfg, card)
    g = _gen(card, 9)
    recurrent = family in ("mamba2", "zamba2")
    if family == "mamba2":
        layer = st.params["blocks"][0]["mamba"]
    elif family == "zamba2":
        layer = st.params["shared_attn"]["attn"]
    else:
        layer = st.params["blocks"][0]["attn"]
    x = torch.randn((n, 1, cfg.d_model), generator=g, device=card
                    ).to(torch.bfloat16)
    diffs = {}

    def rows(fn, *args, dim=0):
        """fn on the n rows (along ``dim``) and on each row alone: the
        max |difference|."""
        many = fn(*args)
        return max((many.narrow(dim, i, 1).float() - fn(
            *(a.narrow(dim, i, 1) for a in args)).float()).abs().max().item()
            for i in range(n))

    w = layer["out_proj" if family == "mamba2" else "wo"]
    diffs["k1"] = rows(lambda h: L.linear(h, w, st.lut),
                       torch.randn((n, 1, w.shape[1]), generator=g,
                                   device=card).to(torch.bfloat16))
    if recurrent:
        mamba = st.params["blocks"][0]["mamba"]
        w = mamba["in_proj"]
        diffs["k1_in_proj"] = rows(lambda h: L.linear(h, w, st.lut), x)
    head = st.params.get("lm_head", st.params["embed"])
    diffs["k5"] = rows(lambda h: L.linear(h, head, st.lut), x)
    if family == "deepseek":
        ws = st.params["blocks"][0]["moe"]["experts"]
        for name in ("w_gate", "w_down"):
            w = ws[name]
            diffs[f"k3_{name}"] = rows(
                lambda h, w=w: ops.grouped_decode_dequant_matmul(
                    h, w, st.lut, out_dtype=h.dtype, decode=True),
                torch.randn((w.codes.shape[0], n, w.shape[1]), generator=g,
                            device=card).to(torch.bfloat16), dim=1)
    pos = torch.randint(1, 23, (n,), generator=g, device=card)
    caches = LM.init_caches(cfg, n, 24, device=card)
    for t in [t for k in caches for c in caches[k] for t in c.values()]:
        t.copy_(torch.randn(t.shape, generator=g, device=card).to(t.dtype))
    attn = L.apply_mla if family == "deepseek" else L.apply_attention

    def rows_cached(fn, *args):
        """``rows`` for fn(caches, *args) on the batch's cache rows."""
        many = fn(caches_of(slice(0, n)), *args)
        return max((many[i:i + 1].float() - fn(
            caches_of(slice(i, i + 1)), *(a[i:i + 1] for a in args)
        ).float()).abs().max().item() for i in range(n))

    def caches_of(r):
        return {k: [{n2: v[r].clone() for n2, v in layer_c.items()}
                    for layer_c in caches[k]] for k in caches}

    if recurrent:
        diffs["mamba2_step"] = rows_cached(
            lambda c, h: SSM.apply_mamba2(mamba, h, cfg, lut=st.lut,
                                          cache=c["blocks"][0])[0], x)
    if family != "mamba2":
        diffs["attention"] = rows_cached(
            lambda c, h, p: attn(layer, h, cfg, lut=st.lut,
                                 cache=c["attn" if family == "zamba2"
                                         else "blocks"][0], pos=p)[0],
            x, pos)
    if family == "llama":
        # the decode attention at Llama-3.2-1B's own head counts (32 q / 8
        # kv heads of 64, 232 cached positions), which the smoke width
        # does not reach: what the engine's ticks run at full width
        def full(*shape):
            return torch.randn(shape, generator=g, device=card
                               ).to(torch.bfloat16)
        diffs["attention_full_heads"] = rows(
            lambda q, k, v, p: L._attend_cached(q, k, v, p, 1),
            full(n, 1, 32, 64), full(n, 232, 8, 64), full(n, 232, 8, 64),
            torch.randint(1, 231, (n,), generator=g, device=card))
    _, decode_step = make_serve_fns(cfg, device=card)
    tok = torch.randint(1, cfg.vocab_size, (n, 1), generator=g, device=card)
    diffs["decode_step"] = rows_cached(
        lambda c, t, p: decode_step(st.params, st.lut, t, c, p)[0], tok, pos)
    assert diffs == {k: 0.0 for k in diffs}, diffs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2048, 512, 64])
def test_rms_norm_rows_do_not_depend_on_the_batch(card, d, dtype):
    """rms_norm gives each row the same bits alone as in a batch of 2 to
    16 rows or of a prefill's 700.  A plain CUDA mean over the row sums it
    in another order when fewer than 16 rows share the call, which let a
    long engine run leave generate's tokens at full Llama width (d 2048;
    512 is MLA's latent norm, 64 a smoke width)."""
    g = _gen(card, 10)
    x = (torch.randn((700, 1, d), generator=g, device=card) * 3).to(dtype)
    w = torch.randn(d, generator=g, device=card)
    alone = torch.cat([L.rms_norm(x[i:i + 1], w) for i in range(16)])
    for n in (2, 3, 4, 8, 16):
        assert torch.equal(L.rms_norm(x[:n], w), alone[:n]), n
    assert torch.equal(L.rms_norm(x, w)[:16], alone)


def _trace(cfg, card, n=8, seed=0):
    """n prompts (lengths 5–20), budgets (3–8) and cumulative Poisson(1.5)
    arrival ticks from a numpy seed."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(5, 21)))
               for _ in range(n)]
    max_new = rng.integers(3, 9, n)
    arrivals = np.concatenate([[0], np.cumsum(rng.poisson(1.5, n - 1))])
    return prompts, max_new, arrivals


def _serve_trace(eng, prompts, max_new, arrivals):
    done = 0
    while done < len(prompts) or eng.health()["occupied"] \
            or eng.health()["queued"]:
        while done < len(prompts) and eng.steps >= arrivals[done]:
            eng.submit(Request(tokens=prompts[done],
                               max_new=int(max_new[done]), rid=done))
            done += 1
        eng.step()
    return {c.rid: c for c in eng.completions}


@pytest.mark.parametrize("family", ["llama", "deepseek", "qwen3_int8"])
@pytest.mark.parametrize("slots", [3, 8, 16, 32])
def test_engine_matches_generate_on_card(card, family, slots):
    """A staggered mixed trace through the engine on the card (3, 8, 16 or
    32 slots; above 3, twice as many requests as slots, the first ``slots``
    at tick 0 so that every slot is taken): one capture of the generate
    step for the whole drain, every tick's and admission's launches
    counted, every completion bitwise equal to the port's generate of its
    prompt alone at the pool's length (a tick runs every slot's row, so
    its decode kernels run at M = slots: above 16, K1 in launches of 16
    rows).  Qwen3's int8 cache pages its codes and their scales."""
    cfg = _engine_cfg(family)
    st = _card_state(cfg, card)
    eng = Engine(ServeContext(cfg, lut=st.lut), st.params, n_slots=slots,
                 max_len=30)
    n = 8 if slots == 3 else 2 * slots
    prompts, max_new, arrivals = _trace(cfg, card, n)
    if slots > 3:
        arrivals = np.concatenate([np.zeros(slots, int),
                                   arrivals[:n - slots] + 1])
    E.CAPTURE_COUNTS.clear()
    _build.LAUNCH_COUNTS.clear()
    by_rid = _serve_trace(eng, prompts, max_new, arrivals)
    launches = dict(_build.LAUNCH_COUNTS)
    assert E.CAPTURE_COUNTS["generate_step"] == 1 and eng.capture_ms > 0
    h = eng.health()
    assert h["occupancy_max"] == slots and h["joined_mid_decode"] >= 1
    ticks = sum(1 for o in eng.stats["occupancy"] if o)
    assert len(eng.pool.free_pages) == eng.pool.n_pages
    for i, p in enumerate(prompts):
        assert by_rid[i].finished == "max_new"
        want = E.generate(st.params, cfg, torch.as_tensor(p)[None],
                          lut=st.lut, max_new=int(max_new[i]),
                          max_len=eng.pool.max_len)[0]
        assert np.array_equal(by_rid[i].tokens, want.cpu().numpy()), (
            i, by_rid[i].tokens, want)
    if family == "llama":
        # K5's head at M = slots: one launch a group of 4 rows; K1 one a
        # group of 16 rows
        head = dqm.dequant_plan(slots, cfg.vocab_size, cfg.d_model, 132,
                                decode=True)
        k5_tick = head.row_groups
        k1_tick = -(-slots // 16)
        assert launches == {"fused_decode_matmul": 7 * cfg.n_layers
                            * (k1_tick * ticks + n), "dequant_matmul":
                            k5_tick * ticks + n,
                            "flash_attention": cfg.n_layers * n}, launches


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_quant_mode_generate_and_engine_on_card(card, family):
    """Quant mode (every projection a QuantLinear through K5: the
    tensor-core kernel at the prefills' M, the decode kernel at the
    steps'): generate's graphed tokens bitwise equal to the eager loop's
    with the same counts, one capture; a staggered trace through the
    engine, every completion bitwise equal to generate alone.  Llama
    launches K5 only (7 a layer and the head) and materializes nothing."""
    cfg = _engine_cfg(family)
    st = build_serve_params(LM.init_lm(cfg, seed=0, device=card),
                            CompressionPolicy(mode="quant",
                                              min_weight_size=1024),
                            device=card)
    ids = torch.randint(1, cfg.vocab_size, (3, 13), generator=_gen(card, 5),
                        device=card)
    want, eager_counts = _counted(lambda: _eager_loop(st, cfg, ids, 9))
    E.CAPTURE_COUNTS.clear()
    got, counts = _counted(lambda: E.generate(st.params, cfg, ids,
                                              lut=st.lut, max_new=9))
    assert E.CAPTURE_COUNTS["decode_loop"] == 1
    assert torch.equal(got[:, 13:], want) and counts == eager_counts
    if family == "llama":
        assert counts == [{"dequant_matmul": (7 * cfg.n_layers + 1) * 9,
                           "flash_attention": cfg.n_layers}, {}, {}]
    eng = Engine(ServeContext(cfg, lut=st.lut), st.params, n_slots=3,
                 max_len=30)
    prompts, max_new, arrivals = _trace(cfg, card)
    by_rid = _serve_trace(eng, prompts, max_new, arrivals)
    assert eng.health()["joined_mid_decode"] >= 1
    for i, p in enumerate(prompts):
        want = E.generate(st.params, cfg, torch.as_tensor(p)[None],
                          lut=st.lut, max_new=int(max_new[i]),
                          max_len=eng.pool.max_len)[0]
        assert np.array_equal(by_rid[i].tokens, want.cpu().numpy()), i


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_resume_replays_one_captured_step_on_card(card, family):
    """A request preempted after 12 tokens (a pool of one slot's pages)
    resumes by its prompt's prefill and 11 replays of one captured batch-1
    decode step, bitwise equal to generate; a second preempted request
    resumes with no new capture."""
    from repro_torch.serve.resilience import FALLBACK_COUNTS
    cfg = _engine_cfg(family)
    st = _card_state(cfg, card)
    eng = Engine(ServeContext(cfg, lut=st.lut), st.params, n_slots=2,
                 max_len=32, page_size=8, n_pages=4)
    rng = np.random.default_rng(5)
    E.CAPTURE_COUNTS.clear()
    for rid in (0, 2):
        low = rng.integers(1, cfg.vocab_size, 8)
        high = rng.integers(1, cfg.vocab_size, 4)
        eng.submit(Request(tokens=low, max_new=20, rid=rid))
        for _ in range(11):
            eng.step()
        assert len(eng._slots[0].out) == 12
        eng.submit(Request(tokens=high, max_new=2, rid=rid + 1, priority=1))
        eng.drain()
        by_rid = {c.rid: c for c in eng.completions}
        assert by_rid[rid].resumed == 1 and by_rid[rid + 1].resumed == 0
        for r, p, n in ((rid, low, 20), (rid + 1, high, 2)):
            want = E.generate(st.params, cfg, torch.as_tensor(p)[None],
                              lut=st.lut, max_new=n,
                              max_len=eng.pool.max_len)[0]
            assert np.array_equal(by_rid[r].tokens, want.cpu().numpy()), r
        assert E.CAPTURE_COUNTS["resume_step"] == 1
    assert eng.health()["preempted"] == 2
    eng.close()
    assert not eng._resume_graphs
    FALLBACK_COUNTS.clear()           # the two preemptions


def test_row_draw_is_the_same_on_card_and_cpu(card):
    """The per-row sampling draw is a pure function of (key, position,
    logits): the card's tokens are the CPU's for fixed inputs."""
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(64, 1000, generator=g) * 2
    temp = torch.rand(64, generator=g) * 2
    temp[::5] = 0.0
    keys = E.fold_in(torch.tensor([E.seed_key(s) for s in range(64)]),
                     torch.randint(0, 4096, (64,), generator=g))
    cpu = E.sample_tokens(logits, temp, keys=keys)
    gpu = E.sample_tokens(logits.to(card), temp.to(card), keys=keys.to(card))
    assert torch.equal(gpu.cpu(), cpu)


def test_engine_reads_only_its_tokens_on_the_host(card):
    """Under set_sync_debug_mode("error") (any synchronizing op raises) a
    whole drain, its capture included, synchronizes only where the engine
    reads a device result: once a tick (the next tokens) and once an
    admission (the first token)."""
    cfg = _engine_cfg("llama")
    st = _card_state(cfg, card)
    eng = Engine(ServeContext(cfg, lut=st.lut), st.params, n_slots=3,
                 max_len=30)
    prompts, max_new, arrivals = _trace(cfg, card, seed=1)
    reads = []
    read = eng._read

    def counted_read(t):
        torch.cuda.set_sync_debug_mode("default")
        try:
            reads.append(t.shape)
            return read(t)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    eng._read = counted_read
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _serve_trace(eng, prompts, max_new, arrivals)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ticks = sum(1 for o in eng.stats["occupancy"] if o)
    assert len(reads) == ticks + len(prompts)
    assert E.CAPTURE_COUNTS["generate_step"] >= 1


# -- integrity and the resilience ladder ------------------------------------

# The rungs' logits differ by their order of sums (K1 in strips, K5 in one
# product, f32 SGEMM); a greedy token may differ only where the fused
# rung's top-2 logits lie within this of each other (a near tie: bf16
# logits often tie exactly), the stated logit tolerance between rungs.
RUNG_TIE = 0.1


def _same_or_tie(st, cfg, ids, want, got):
    """New tokens ``got`` equal ``want`` (the fused rung's), or first
    differ where the fused logits, teacher-forced on ``want``, have a
    top-2 gap within RUNG_TIE.  → that gap, or None when equal."""
    t0 = ids.shape[1]
    want, got = want[:, t0:].to(ids.device), got[:, t0:].to(ids.device)
    diff = torch.nonzero(got != want)
    if diff.numel() == 0:
        return None
    row, step = (int(v) for v in diff[torch.argmin(diff[:, 1])])
    prefill, decode_step = make_serve_fns(cfg, device=ids.device)
    caches = LM.init_caches(cfg, ids.shape[0], t0 + want.shape[1],
                            device=ids.device)
    logits, caches = prefill(st.params, st.lut, {"tokens": ids}, caches)
    for i in range(step):
        logits, caches = decode_step(st.params, st.lut, want[:, i:i + 1],
                                     caches, t0 + i)
    top = torch.topk(logits[row].float(), 2).values
    gap = float(top[0] - top[1])
    assert gap <= RUNG_TIE, (row, step, gap, want[row], got[row])
    return gap

def _rung_run(st, cfg, ids, max_new, rung, device):
    """generate on one rung of the ladder (a ladder of that rung alone);
    → (tokens, launch counts, dispatch counts)."""
    from repro_torch.serve.resilience import ResiliencePolicy, ResilientEngine
    eng = ResilientEngine(cfg, st, policy=ResiliencePolicy(ladder=(rung,)),
                          device=device)
    out, counts = _counted(lambda: eng.generate(ids, max_new=max_new))
    assert eng.last_rung == rung and ops._DEFAULT_IMPL == "auto"
    return out, counts[0], counts[1]


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_rungs_give_the_fused_tokens_on_card(card, family):
    """Each rung of the ladder gives the fused rung's greedy tokens on the
    card (or differs first at a near tie, ``_same_or_tie``).  The unfused rung launches K4 and then K5 for every compressed
    projection (and no K1 or K3); the materialize rung launches no port
    kernel for a compressed weight (only K5 for the int8 LM head and K2
    at the prefill)."""
    from repro_torch.serve.resilience import FALLBACK_COUNTS
    cfg = _card_cfg(family)
    st = _card_state(cfg, card)
    ids = torch.randint(1, cfg.vocab_size, (3, 13), generator=_gen(card, 8),
                        device=card)
    max_new = 9
    fused, fl, fd = _rung_run(st, cfg, ids, max_new, "fused", card)
    assert set(fd) <= {"fused", "grouped_fused"}
    assert fl.get("dict_decode", 0) == (cfg.n_layers * max_new
                                        if family == "deepseek" else 0)
    for rung in ("unfused", "materialize"):
        out, launches, dispatch = _rung_run(st, cfg, ids, max_new, rung,
                                            card)
        _same_or_tie(st, cfg, ids, fused, out)
        assert launches.get("fused_decode_matmul", 0) == 0
        assert launches.get(fdm.GROUPED_NAME, 0) == 0
        assert launches["flash_attention"] == cfg.n_layers
        if rung == "unfused":
            assert launches["dict_decode"] > 0
            assert launches["dequant_matmul"] == dispatch["unfused"] \
                + max_new
            assert set(dispatch) <= {"unfused", "grouped_unfused"}
            if family == "llama":
                assert launches["dict_decode"] == 7 * cfg.n_layers * max_new
        else:
            assert launches.get("dict_decode", 0) == 0
            assert launches["dequant_matmul"] == max_new    # the LM head
            assert set(dispatch) <= {"materialize", "grouped_materialize"}
    assert not FALLBACK_COUNTS


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_decode_fault_fires_at_the_cpu_tick_on_card(card, family):
    """A decode fault calibrated on the CPU fires at the same execution on
    the card, where it falls inside a replay of the captured step: the
    replay is refused on the host, the ladder serves the request on the
    unfused rung with the clean tokens (on the card: or a first difference
    at a near tie, ``_same_or_tie``), and the fused rung's graph is
    dropped."""
    from repro_torch.serve.resilience import (FALLBACK_COUNTS,
                                              ResiliencePolicy,
                                              ResilientEngine)
    from repro_torch.testing import FaultInjector
    cfg = _card_cfg(family)
    st = _card_state(cfg, card)
    ids = torch.randint(1, cfg.vocab_size, (2, 11), generator=_gen(card, 9),
                        device=card)
    max_new = 8
    runs = {}
    for dev, s in (("cpu", st.to("cpu")), ("cuda", st)):
        x = ids.to(dev)
        clean = E.generate(s.params, cfg, x, lut=s.lut, max_new=max_new,
                           device=dev)
        with FaultInjector().decode_fault(nth=1 << 30) as never:
            E.generate(s.params, dataclasses.replace(cfg, name="calib"), x,
                       lut=s.lut, max_new=max_new, device=dev)
        per_step = never.executions // max_new
        nth = per_step * 4 + 1            # the first call of step 5
        rcfg = dataclasses.replace(cfg, name=f"fault-{dev}")
        eng = ResilientEngine(rcfg, s, policy=ResiliencePolicy(
            max_retries=0), device=dev)
        FALLBACK_COUNTS.clear()
        E.CAPTURE_COUNTS.clear()
        with FaultInjector().decode_fault(nth=nth) as probe:
            out = eng.generate(x, max_new=max_new)
        runs[dev] = (never.executions, probe.executions, eng.last_rung,
                     dict(FALLBACK_COUNTS))
        if dev == "cpu":
            assert torch.equal(out, clean)
        else:
            _same_or_tie(s, cfg, x, clean, out)
        assert not any(k[0] == rcfg for k in E._GRAPHS)
        if dev == "cuda":
            # fused: captured, then refused in a replay; unfused: captured
            assert E.CAPTURE_COUNTS["decode_loop"] == 2
    assert runs["cpu"] == runs["cuda"], runs
    assert runs["cuda"][1] == runs["cuda"][0] // max_new * 4 + 1
    assert runs["cuda"][2:] == ("unfused", {"unfused": 1})


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_check_invariants_reads_the_host_once(card, family):
    """check_invariants reduces on the card and makes one host read (the
    stacked flags), counted under set_sync_debug_mode('warn'); its report
    and a flipped-code report match the CPU's."""
    import warnings
    from repro_torch.core import integrity as TI
    from repro_torch.testing import FaultInjector
    st = _card_state(_card_cfg(family), card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rep = TI.check_invariants(st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert rep.ok and rep.checked > 0 and len(syncs) == 1, syncs
    assert rep.corrupt == TI.check_invariants(st.to("cpu")).corrupt
    for level in ("fast", "full"):
        assert TI.verify_serve_state(st, level=level).ok
    bad, name = FaultInjector().flip_bit(st, "", plane="codes")
    got = TI.verify_serve_state(bad, level="full")
    assert got.quarantined == [name]
    assert got.corrupt == TI.verify_serve_state(bad.to("cpu")).corrupt


# -- tiered residency and the governor ---------------------------------------

@pytest.mark.parametrize("n,k", [(1408, 2048), (2048, 1408)])
def test_k3_on_cache_stacks_equals_the_full_stack_on_card(card, n, k):
    """K3 over a C-slot stack of experts gathered from DeepSeek-V2-Lite's
    64-expert stack (its gate/up and down shapes), planned for 64 experts,
    gives each expert's rows bit for bit as K3 over the full stack, for C
    in {1, 6, 24, 64} (slots in a seeded order), at M = 4 (the decode
    kernel) and M = 83 (the prefill cap: the tensor-core kernel).  The
    plan a launch of C experts alone would take differs from the full
    stack's (warps, or K splits), which is why the cache passes the
    layer's expert count."""
    g = _gen(card, 13)
    ws = [torch.randn((n, k), generator=g, device=card) * 0.02
          for _ in range(64)]
    pl, lut = pack_expert_stack(ws)
    del ws
    kw = dict(shape=pl.shape, tile_n=pl.tile_n, tile_k=pl.tile_k)
    planes = ("codes", "literals", "scale", "zero")
    rng = np.random.default_rng(3)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    slots = pl.codes.shape[-1]
    for m in (4, 83):
        x = torch.randn((64, m, k), generator=g, device=card
                        ).to(torch.bfloat16)
        full = fdm.grouped_fused_decode_matmul(
            x, *(getattr(pl, p) for p in planes[:2]), lut,
            *(getattr(pl, p) for p in planes[2:]), **kw,
            out_dtype=torch.float32)
        differs = []
        for c in (1, 6, 24, 64):
            idx = torch.as_tensor(rng.permutation(64)[:c], device=card)
            sub = [getattr(pl, p).index_select(0, idx).contiguous()
                   for p in planes]
            got = fdm.grouped_fused_decode_matmul(
                x.index_select(0, idx), sub[0], sub[1], lut, sub[2], sub[3],
                **kw, out_dtype=torch.float32, plan_experts=64)
            assert torch.equal(got, full.index_select(0, idx)), (m, c)
            differs.append(fdm.launch_plan(m, n, k, pl.tile_k, c, sms, slots)
                           != fdm.launch_plan(m, n, k, pl.tile_k, 64, sms,
                                              slots))
        assert any(differs), m


def _tiered_state(card):
    cfg = _engine_cfg("deepseek")
    return cfg, _card_state(cfg, card)


def test_tiered_generate_matches_resident_on_card(card):
    """generate under a ResidencyManager at capacities {all, half, 1}
    gives the resident (graphed) generate's tokens bit for bit, greedy and
    sampled; K3 runs on the cache stacks and no expert plane is
    materialized; the constrained capacities miss and replay."""
    from repro_torch.serve.residency import (RESIDENCY_COUNTS,
                                             ResidencyManager)
    cfg, st = _tiered_state(card)
    ids = torch.randint(1, cfg.vocab_size, (3, 13), generator=_gen(card, 5),
                        device=card)
    for temperature in (0.0, 2.0):
        want = E.generate(st.params, cfg, ids, lut=st.lut, max_new=9,
                          temperature=temperature, generator=_gen(card, 11))
        for cap in (cfg.n_experts, cfg.n_experts // 2, 1):
            RESIDENCY_COUNTS.clear()
            mgr = ResidencyManager(st, cfg, capacity=cap)
            ctx = ServeContext(cfg, lut=st.lut, residency=mgr)
            got, counts = _counted(lambda: E.generate(
                st.params, None, ids, ctx=ctx, max_new=9,
                temperature=temperature, generator=_gen(card, 11)))
            mgr.close()
            assert torch.equal(got, want), (temperature, cap)
            assert counts[0]["grouped_fused_decode_matmul"] > 0
            assert counts[2].get("packed_stacked", 0) == 0
            if cap < cfg.n_experts:
                assert RESIDENCY_COUNTS["miss"] > 0
                assert RESIDENCY_COUNTS["replay"] > 0


def test_prefetch_on_the_side_stream_on_card(card):
    """The prefetch worker copies on its own stream and the serving stream
    waits on its events: prefetched slots are installed and hit, and the
    tokens stay bitwise; under a slow link (fetch_fault with delay_s, on
    every demand fetch and prefetch) too."""
    from repro_torch.serve.residency import (RESIDENCY_COUNTS,
                                             ResidencyManager)
    from repro_torch.testing import FaultInjector
    cfg, st = _tiered_state(card)
    ids = torch.randint(1, cfg.vocab_size, (2, 9), generator=_gen(card, 6),
                        device=card)
    want = E.generate(st.params, cfg, ids, lut=st.lut, max_new=8)
    for delay in (0.0, 0.002):
        RESIDENCY_COUNTS.clear()
        mgr = ResidencyManager(st, cfg, capacity=2)
        ctx = ServeContext(cfg, lut=st.lut, residency=mgr)
        with FaultInjector().fetch_fault(times=1 << 30 if delay else 0,
                                         delay_s=delay) as probe:
            got = E.generate(st.params, None, ids, ctx=ctx, max_new=8)
        assert mgr._side is not None
        assert mgr._side != torch.cuda.current_stream(card)
        mgr.close()
        assert torch.equal(got, want), delay
        assert RESIDENCY_COUNTS["prefetch_installed"] > 0
        assert RESIDENCY_COUNTS["prefetch_hit"] > 0
        assert RESIDENCY_COUNTS["prefetch_error"] == 0
        assert (probe.executions > 0) == (delay > 0)


def test_tiered_engine_matches_generate_on_card(card):
    """The engine under a ResidencyManager of capacity 2 (its admissions
    and ticks eager, under fetch/replay): every completion of a staggered
    trace bitwise equal to generate of its prompt alone; no tick is
    captured."""
    from repro_torch.serve.residency import ResidencyManager
    cfg, st = _tiered_state(card)
    mgr = ResidencyManager(st, cfg, capacity=2)
    eng = Engine(ServeContext(cfg, lut=st.lut, residency=mgr), st.params,
                 n_slots=3, max_len=30)
    prompts, max_new, arrivals = _trace(cfg, card, n=6, seed=2)
    E.CAPTURE_COUNTS.clear()
    by_rid = _serve_trace(eng, prompts, max_new, arrivals)
    assert not E.CAPTURE_COUNTS
    assert eng.health()["residency"]["miss"] > 0
    eng.close()
    for i, p in enumerate(prompts):
        want = E.generate(st.params, cfg, torch.as_tensor(p)[None],
                          lut=st.lut, max_new=int(max_new[i]),
                          max_len=eng.pool.max_len)[0]
        assert np.array_equal(by_rid[i].tokens, want.cpu().numpy()), i


def test_pool_shrink_and_regrow_recapture_the_tick_on_card(card):
    """A ramp trace under a MemoryGovernor: the released tail gives its
    bytes back to the allocator, each move of the pages drops the
    engine's graph so the next tick captures anew, captures stay within
    1 + plan changes, and every survivor equals generate bitwise."""
    from repro_torch.serve.governor import MemoryGovernor
    from repro_torch.serve.kv_cache import PagedKVPool
    from repro_torch.testing import FaultInjector, pressure_trace
    from repro_torch.core.policy import device_budget
    cfg = _engine_cfg("llama")
    st = _card_state(cfg, card)
    pool = PagedKVPool(cfg, 3, 32, page_size=8, device=card)
    pn, boot = pool.page_nbytes(), pool.n_pages * pool.page_nbytes()
    del pool
    gov = MemoryGovernor(device_budget(boot, expert_bytes=0, kv_bytes=boot),
                         cooldown_steps=2)
    eng = Engine(ServeContext(cfg, lut=st.lut), st.params, n_slots=3,
                 max_len=32, governor=gov)
    prompts, max_new, arrivals = _trace(cfg, card, n=6, seed=4)
    trace = pressure_trace("ramp", boot_bytes=boot, low_bytes=5 * pn,
                           n_steps=24, seed=1)
    E.CAPTURE_COUNTS.clear()
    released = []
    on_step = gov.on_step

    def measured(engine):
        torch.cuda.synchronize()
        before, n = torch.cuda.memory_allocated(card), engine.pool.n_pages
        on_step(engine)
        torch.cuda.synchronize()
        if engine.pool.n_pages < n:
            released.append((before - torch.cuda.memory_allocated(card),
                             (n - engine.pool.n_pages) * pn))

    gov.on_step = measured
    with FaultInjector().memory_pressure(trace):
        by_rid = _serve_trace(eng, prompts, max_new, arrivals)
        for _ in range(12):
            eng.step()
    assert eng.pool.moves >= 2 and released
    assert all(got == want for got, want in released), released
    assert 2 <= E.CAPTURE_COUNTS["generate_step"] <= 1 + gov.plan_changes
    for i, p in enumerate(prompts):
        c = by_rid[i]
        assert c.finished in ("max_new", "eos", "pressure", "shed"), c
        if c.finished == "max_new":
            want = E.generate(st.params, cfg, torch.as_tensor(p)[None],
                              lut=st.lut, max_new=int(max_new[i]),
                              max_len=eng.pool.max_len)[0]
            assert np.array_equal(c.tokens, want.cpu().numpy()), i


# -- K1's column groups (TiledPackedLinear) --------------------------------

@pytest.mark.parametrize("n,k,groups", [
    (512, 2048, 2),      # Llama wk/wv at 2 groups: tile_k 512
    (2048, 2048, 4),     # wq/wo at 4 groups: one K tile a group
    (256, 2816, 2),      # tile_k 128, 11 tiles a group: splits, warps and
                         # spans cross the group boundary
    (192, 8192, 4),      # w_down's K, tile_n 64
    (256, 2 * 11 * 32, 2),   # 11 tiles of 32 a group (the tiled DeepSeek
    (256, 4 * 13 * 16, 4),   # first w_down's 171, cut), 13 of 16
])
@pytest.mark.parametrize("m", [1, 4, 5, 8, 9, 16, 200, 700])
def test_k1_column_groups_on_card(card, n, k, groups, m):
    """K1 over G column groups, one launch: bitwise equal to its plain
    version and to K1 at G = 1 on the untiled planes of the same weight
    (with the same tiles) on integer x, within 1e-4 of the output's scale
    of the plain version on random x, at every kernel of the plan (decode
    M ≤ 16, tensor cores M = 200 and 700, tile_k 16 and 32 included)."""
    g = _gen(card, 12)
    w = torch.randn((n, k), generator=g, device=card) * 0.02
    table = find_frequent_sequences([quantize_linear(w).values])
    tt = pack_linear_tiled(w, table, groups, tile="auto")
    lut = build_lut(table, device=card)
    args = (tt.codes, tt.literals, lut, tt.scale, tt.zero)
    kw = dict(shape=(n, k), tile_n=tt.tile_n, tile_k=tt.tile_k)
    xi, xr = _xs(m, k, g, card)
    _check_matmul(
        lambda x, dt: fdm.fused_decode_matmul(x, *args, **kw, out_dtype=dt),
        lambda x, dt: fdm.fused_decode_matmul_plain(x, *args, **kw,
                                                    out_dtype=dt), xi, xr)
    bc = encode_blocked_tiled(quantize_linear(w).values,
                              TableIndex(table, device=card),
                              tile_n=tt.tile_n, tile_k=tt.tile_k)
    _build.LAUNCH_COUNTS.clear()
    y = fdm.fused_decode_matmul(xi, *args, **kw)
    assert dict(_build.LAUNCH_COUNTS) == {fdm.NAME: 1}
    assert torch.equal(y, fdm.fused_decode_matmul(
        xi, bc.codes, bc.literals, lut, tt.scale, tt.zero, **kw))
    _check_kernel(fdm.NAME, m, tt.tile_k,
                  lambda: fdm.fused_decode_matmul(xi, *args, **kw))
    assert torch.equal(fdm.fused_decode_matmul(xr, *args, **kw),
                       fdm.fused_decode_matmul(xr, *args, **kw))


def test_k1_and_k3_bits_unchanged_on_card(card):
    """K1 at G = 1, K3 and K2 give, on fixed-seed inputs, the bits they
    gave before K1's column groups and K2's smoke head dims, and K1/K3
    above 4 rows the bits recorded with the 16-row decode kernel, each of
    their rows bitwise that row alone (``tools/k1_bits.py``: the CRC32 of
    each output, recorded on an H100 of 132 SMs); K2's f32 cases the bits
    of the three-term TF32 kernel, within 1e-4 of the plain version."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "k1_bits.py"
    spec = importlib.util.spec_from_file_location("k1_bits", path)
    k1_bits = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k1_bits)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    if sms not in k1_bits.EXPECTED:
        pytest.skip(f"bits recorded for {sorted(k1_bits.EXPECTED)} SMs, "
                    f"the card has {sms}")
    rows_alone, flash_err = {}, {}
    assert k1_bits.case_outputs(card, rows_alone, flash_err) == \
        k1_bits.EXPECTED[sms]
    assert rows_alone and all(rows_alone.values()), rows_alone
    f32 = [c[0] for c in k1_bits.FLASH_CASES if c[7] == "f32"]
    assert f32 and all(flash_err[n] <= k1_bits.F32_ATOL for n in f32), \
        flash_err


def _tiled_state(cfg, card, seed=0):
    params = LM.init_lm(cfg, seed=seed, device=card)
    return build_serve_params(params, CompressionPolicy(
        min_weight_size=1024, tiles=2), device=card)


@pytest.mark.parametrize("family", ["llama", "deepseek"])
def test_tiled_generate_and_engine_on_card(card, family):
    """A tiled state (tiles=2) on the card: graphed generate gives the
    eager loop's tokens bit for bit with its counts, every projection
    on K1 with column groups ('tiled_fused'), expert stacks on K3, MLA's
    tiled wkv_b absorbed by K4 (counted 'tiled'); the Engine's completions
    equal generate's."""
    from repro_torch.core.compressed import TiledPackedLinear
    cfg = _engine_cfg(family)
    st = _tiled_state(cfg, card)
    assert isinstance(st.params["blocks"][0]["attn"]["wo"],
                      TiledPackedLinear)
    ids = torch.randint(1, cfg.vocab_size, (3, 13), generator=_gen(card, 5),
                        device=card)
    max_new = 9
    want, eager_counts = _counted(lambda: _eager_loop(st, cfg, ids,
                                                      max_new))
    got, counts = _counted(lambda: E.generate(st.params, cfg, ids,
                                              lut=st.lut, max_new=max_new))
    assert torch.equal(got[:, 13:], want) and counts == eager_counts
    launches, dispatch, materialized = counts
    assert set(dispatch) <= {"tiled_fused", "grouped_fused"}
    assert launches["fused_decode_matmul"] == dispatch["tiled_fused"]
    if family == "deepseek":
        assert materialized == {"tiled": cfg.n_layers * max_new}
        assert launches["dict_decode"] == cfg.n_layers * max_new
    else:
        assert not materialized
    eng = Engine(ServeContext(cfg, lut=st.lut), st.params, n_slots=3,
                 max_len=30)
    prompts, budgets, arrivals = _trace(cfg, card)
    by_rid = _serve_trace(eng, prompts, budgets, arrivals)
    for i, p in enumerate(prompts):
        ref = E.generate(st.params, cfg, torch.as_tensor(p)[None],
                         lut=st.lut, max_new=int(budgets[i]),
                         max_len=eng.pool.max_len)[0]
        assert np.array_equal(by_rid[i].tokens, ref.cpu().numpy()), i
    eng.close()


# -- training and calibration on the card ---------------------------------------

@pytest.mark.parametrize("hq,hkv,d,dv", [(8, 2, 64, 64), (4, 4, 192, 128)])
def test_flash_attention_autograd_on_card(card, hq, hkv, d, dv):
    """K2 under its autograd.Function on f32 operands at T = 256 (a
    training forward's length; Llama's head dim and MLA's 192/128): the
    forward is the f32 (three-term TF32) kernel (one launch, within 1e-4
    of the plain version), and the gradients are the plain version's on the same
    inputs and upstream gradient, bitwise (the backward recomputes it)."""
    from repro_torch.kernels import ops as OPS
    g = _gen(card, 11)
    shapes = ((2, hq, 256, d), (2, hkv, 256, d), (2, hkv, 256, dv))
    base = [torch.randn(s, generator=g, device=card) for s in shapes]
    w = torch.randn((2, hq, 256, dv), generator=g, device=card)

    def run(fn):
        ts = [b.clone().requires_grad_(True) for b in base]
        out = fn(*ts, causal=True)
        (out * w).sum().backward()
        return out.detach(), [t.grad for t in ts]

    _build.KERNEL_COUNTS.clear()
    out, grads = run(OPS.flash_attention)
    assert dict(_build.KERNEL_COUNTS) == {"flash_attention:tf32x3": 1}
    out_p, grads_p = run(fa.flash_attention_plain)
    assert float((out - out_p).abs().max()) <= 1e-4
    for a, b in zip(grads, grads_p):
        assert torch.equal(a, b)


def test_train_steps_on_card_match_the_cpu(card):
    """The Llama smoke config from one init, 3 train steps on the card
    and on the CPU (the plain versions): each loss within 1e-5 relative
    and the parameters, as one vector, within 1e-5 relative (f32 sums in
    another order on each device, through AdamW, as in
    tests/test_torch_train.py); every step's attention on K2's f32
    (three-term TF32) kernel."""
    from repro_torch.train import tree as T
    from repro_torch.train.data import DataConfig, DataPipeline
    from repro_torch.train.steps import (TrainConfig, init_train_state,
                                         make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3.2-1b").smoke
    params = LM.init_lm(cfg, seed=0, device="cpu")
    tcfg = TrainConfig()
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=4,
                                   seq_len=32, seed=2))
    step = make_train_step(cfg, tcfg)
    sc = init_train_state(params, tcfg)
    sg = init_train_state(T.map_leaves(lambda t: t.to(card), params), tcfg)
    _build.KERNEL_COUNTS.clear()
    for i in range(3):
        sc, mc = step(sc, data.batch_at(i))
        sg, mg = step(sg, data.batch_at(i))
        assert float(mg["loss"]) == pytest.approx(float(mc["loss"]),
                                                  rel=1e-5)
    assert _build.KERNEL_COUNTS["flash_attention:tf32x3"] == 3 * cfg.n_layers
    a, b = T.leaves(sg["params"]), T.leaves(sc["params"])
    num = sum(float(((x.cpu() - y) ** 2).sum()) for x, y in zip(a, b))
    den = sum(float((y ** 2).sum()) for y in b)
    assert (num / den) ** 0.5 <= 1e-5


def test_gptq_on_card_matches_cpu(card):
    """GPTQ of one seeded weight on calibration activations, on the card
    and on the CPU: codes equal for at least 99.9 % of entries and the
    layer error within 1e-4 relative (the inverse and Cholesky factor of
    two solver libraries, as in tests/test_torch_gptq.py)."""
    from repro_torch.core import gptq
    from repro_torch.core.quant import QuantConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.laplace(0, 0.05, (96, 256)).astype(np.float32))
    mix = rng.normal(size=(256, 256)).astype(np.float32) / 16
    xs = [torch.from_numpy(rng.normal(size=(128, 256)).astype(np.float32)
                           @ mix) for _ in range(2)]
    cfg = QuantConfig(bits=4)
    cpu = gptq.calibrate_and_quantize(w, xs, cfg)
    dev = gptq.calibrate_and_quantize(w.to(card), [x.to(card) for x in xs],
                                      cfg)
    same = float((dev.values.cpu() == cpu.values).float().mean())
    assert same >= 0.999, same
    h = gptq.init_hessian(256)
    for x in xs:
        h = gptq.accumulate_hessian(h, x)
    e_cpu = float(gptq.gptq_layer_error(w, cpu, h))
    e_dev = float(gptq.gptq_layer_error(w.to(card), dev, h.to(card)))
    assert e_dev == pytest.approx(e_cpu, rel=1e-4)


# -- the encoder–decoder (seamless-m4t-medium) --------------------------------

from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import frontends  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tq", [1, 300])
def test_flash_attention_not_causal_at_seamless_shapes_on_card(card, tq,
                                                                dtype):
    """K2 without the mask at seamless-m4t-medium's shapes: 4 × 16 heads of
    64 over 300 frames, as the layers pass them ((B, T, H, D) tensors
    transposed), at Tq = 300 (the encoder's self-attention) and Tq = 1
    (cross-attention at a decode step: one live row in a block of 64;
    300 keys, a multiple of neither 64 nor 16).  Within 1e-4 of the plain
    version in f32, two bf16 ulps in bf16; the output has exactly the
    rows asked for and two calls give the same bits."""
    g = _gen(card, 21)

    def view(t):
        return torch.randn((4, t, 16, 64), generator=g, device=card
                           ).to(dtype).transpose(1, 2)

    q, k, v = view(tq), view(300), view(300)
    _build.KERNEL_COUNTS.clear()
    got = fa.flash_attention(q, k, v, causal=False)
    kernel = "mma" if dtype == torch.bfloat16 else "tf32x3"
    assert dict(_build.KERNEL_COUNTS) == {f"flash_attention:{kernel}": 1}
    assert got.shape == (4, 16, tq, 64) and got.dtype == dtype
    err = (got.float() - fa.flash_attention_plain(
        q, k, v, causal=False).float()).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 1.6e-2), err
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=False))


@pytest.mark.parametrize("m,decode", [(4, True), (1, True), (64, False)])
def test_dequant_matmul_seamless_head_on_card(card, m, decode):
    """K5 on seamless-m4t-medium's LM head, 256 206 × 1 024 (2 001 stripes
    of 128 rows and one of 78), quantized from a seeded random weight: at
    a decode step's rows (M = 4 and 1) and a prefill's (M = 64) bitwise to
    the plain version on integer x, within 1e-4 on random x."""
    g = _gen(card, 22)
    q = quantize_linear(torch.randn((256206, 1024), generator=g,
                                    device=card))
    xi, xr = _xs(m, 1024, g, card)
    _check_matmul(
        lambda x, dt: dqm.dequant_matmul(x, q.values, q.scale, q.zero, dt,
                                         decode=decode),
        lambda x, dt: dqm.dequant_matmul_plain(x, q.values, q.scale, q.zero,
                                               dt), xi, xr)


def _encdec_card_state(card, mode="compressed"):
    cfg = get_config("seamless-m4t-medium").smoke
    params = ED.init_encdec(cfg, seed=0, device=card)
    return cfg, build_serve_params(params, CompressionPolicy(
        mode=mode, min_weight_size=1024), device=card)


def _encdec_eager(st, cfg, ids, frames, max_new):
    """The eager decode loop over make_serve_fns on fresh caches."""
    prefill, decode_step = make_serve_fns(cfg, device=ids.device)
    b, t0 = ids.shape
    caches = ED.init_caches(cfg, b, t0 + max_new, frames.shape[1],
                            enc_dtype=frames.dtype, device=ids.device)
    logits, caches = prefill(st.params, st.lut, {"tokens": ids,
                                                 "enc_embeds": frames},
                             caches)
    toks = [torch.argmax(logits, -1)[:, None]]
    for i in range(max_new - 1):
        logits, caches = decode_step(st.params, st.lut, toks[-1], caches,
                                     t0 + i)
        toks.append(torch.argmax(logits, -1)[:, None])
    return torch.cat(toks, dim=1)


@pytest.mark.parametrize("mode", ["compressed", "quant"])
def test_encdec_graphed_matches_eager_over_two_batches_on_card(card, mode):
    """One DecodeGraph (an eager step, a capture, replays), two batches of
    other frames and prompts: each prefill copies its cross K/V into the
    graph's buffers, so each batch's tokens equal an eager loop's on fresh
    caches, bit for bit; the second batch captures nothing; a captured
    step launches K2 once a decoder layer (cross-attention, Tq = 1)."""
    cfg, st = _encdec_card_state(card, mode)
    graph = E.decode_graph(st.params, cfg, st.lut, 3, 11 + 9, enc_len=37,
                           device=card)
    outs = []
    for seed in (1, 2):
        g = _gen(card, seed)
        ids = torch.randint(1, cfg.vocab_size, (3, 11), generator=g,
                            device=card)
        frames = frontends.audio_frame_embeddings(g, 3, 37, cfg.d_model,
                                                  torch.bfloat16)
        want = _encdec_eager(st, cfg, ids, frames, 9)
        E.CAPTURE_COUNTS.clear()
        got = graph.run(st.params, st.lut, ids, 9, enc_embeds=frames)
        assert E.CAPTURE_COUNTS["decode_loop"] == (1 if seed == 1 else 0)
        assert torch.equal(got, want), (seed, got, want)
        outs.append(got)
    assert not torch.equal(outs[0], outs[1])
    step = dict(graph.step_counts[1])
    assert step.get("flash_attention:mma") == cfg.decoder_layers, step
    assert L.MATERIALIZE_COUNTS.get("packed", 0) == 0


@pytest.mark.parametrize("n", [4, 16])
def test_encdec_decode_rows_do_not_depend_on_the_batch(card, n):
    """Each row of an encoder–decoder decode step (K1, K2 at Tq = 1 over
    its own frames, the decode attention, K5) gives the same bits alone as
    in a batch of n at other positions."""
    cfg, st = _encdec_card_state(card)
    g = _gen(card, 23)
    caches = ED.init_caches(cfg, n, 24, 37, device=card)
    for t in E._tensors(caches):
        t.copy_(torch.randn(t.shape, generator=g, device=card).to(t.dtype))
    pos = torch.randint(1, 23, (n,), generator=g, device=card)
    tok = torch.randint(1, cfg.vocab_size, (n, 1), generator=g, device=card)
    _, decode_step = make_serve_fns(cfg, device=card)

    def rows_of(r):
        return {k: [{m: t[r].clone() for m, t in layer.items()}
                    for layer in v] if k == "self" else
                [t[r].clone() for t in v] for k, v in caches.items()}

    many = decode_step(st.params, st.lut, tok, rows_of(slice(0, n)), pos)[0]
    for i in range(n):
        one = decode_step(st.params, st.lut, tok[i:i + 1],
                          rows_of(slice(i, i + 1)), pos[i:i + 1])[0]
        assert torch.equal(many[i:i + 1], one), i


def test_encdec_train_steps_on_card_match_the_cpu(card):
    """The seamless smoke config from one init, 3 train steps (batches
    with f32 frames) on the card and on the CPU: each loss within 1e-5
    relative, the parameters within 1e-5 relative (as
    tests/test_torch_train.py); every attention forward on K2's f32
    kernel, the encoder's and the cross-attention's without the mask
    (enc + 2 · dec launches a step).  Then one step's gradients on the
    card against the same step with the all-plain attention, within the
    1e-3 (L2, relative) that chip_smoke.py's train phase holds."""
    from repro_torch.train import tree as T
    from repro_torch.train.data import DataConfig, DataPipeline
    from repro_torch.train.steps import (TrainConfig, init_train_state,
                                         make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("seamless-m4t-medium").smoke
    params = ED.init_encdec(cfg, seed=0, device="cpu")
    tcfg = TrainConfig()
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=4,
                                   seq_len=32, seed=2))
    rng = np.random.default_rng(3)
    frames = [torch.from_numpy((rng.standard_normal((4, 40, cfg.d_model))
                                * 0.02).astype(np.float32)) for _ in range(3)]
    step = make_train_step(cfg, tcfg)
    sc = init_train_state(params, tcfg)
    sg = init_train_state(T.map_leaves(lambda t: t.to(card), params), tcfg)
    _build.KERNEL_COUNTS.clear()
    for i in range(3):
        batch = dict(data.batch_at(i), enc_embeds=frames[i])
        sc, mc = step(sc, batch)
        sg, mg = step(sg, batch)
        assert float(mg["loss"]) == pytest.approx(float(mc["loss"]),
                                                  rel=1e-5)
    assert dict(_build.KERNEL_COUNTS) == {
        "flash_attention:tf32x3": 3 * (cfg.encoder_layers
                                       + 2 * cfg.decoder_layers)}
    a, b = T.leaves(sg["params"]), T.leaves(sc["params"])
    num = sum(float(((x.cpu() - y) ** 2).sum()) for x, y in zip(a, b))
    den = sum(float((y ** 2).sum()) for y in b)
    assert (num / den) ** 0.5 <= 1e-5
    from repro_torch.train.steps import loss_and_grads
    batch = {k: v.to(card) for k, v in dict(
        data.batch_at(3), enc_embeds=frames[0]).items()}
    _, kern = loss_and_grads(sg["params"], cfg, tcfg, batch)
    real = ops.flash_attention
    ops.flash_attention = fa.flash_attention_plain
    try:
        _, plain = loss_and_grads(sg["params"], cfg, tcfg, batch)
    finally:
        ops.flash_attention = real
    num = sum(float(((x - y) ** 2).sum()) for x, y in zip(kern, plain))
    den = sum(float((y ** 2).sum()) for y in plain)
    assert (num / den) ** 0.5 <= 1e-3


# -- serving on a mesh: ranks sharing the card over gloo -------------------

def _mesh_cases(card):
    """The smoke models packed for two model ranks, on the card: K1 on
    Llama's projections at decode and prefill M, K5 on its int8 w_gate,
    K3 on DeepSeek's first expert stack, generate on Llama; → (cases,
    one process's outputs)."""
    llama = LM.init_lm(get_config("llama3.2-1b").smoke, seed=0, device=card)
    cfg = get_config("llama3.2-1b").smoke
    st = build_serve_params(llama, CompressionPolicy(
        mode="compressed", min_weight_size=1024), model_shards=2,
        device=card)
    sq = build_serve_params(llama, CompressionPolicy(
        mode="quant", min_weight_size=1024), model_shards=2, device=card)
    ds_cfg = get_config("deepseek-v2-lite-16b").smoke
    ds = build_serve_params(LM.init_lm(ds_cfg, seed=0, device=card),
                            CompressionPolicy(mode="compressed",
                                              min_weight_size=1024),
                            model_shards=2, device=card)
    g = _gen(card, 3)
    blk = st.params["blocks"][0]
    matmul = {}
    for name, grp in (("wq", "attn"), ("w_gate", "mlp"), ("w_down", "mlp")):
        w = blk[grp][name]
        for m, decode in ((4, True), (33, False)):
            x = torch.randn((m, w.shape[1]), generator=g, device=card)
            matmul[f"k1 {name} {m}"] = (w, st.lut, x.to(torch.bfloat16),
                                        decode)
    q = sq.params["blocks"][0]["mlp"]["w_gate"]
    k5 = {"k5 w_gate": (q, torch.randn((4, q.values.shape[1]), generator=g,
                                       device=card).to(torch.bfloat16))}
    stack = ds.params["blocks"][1]["moe"]["experts"]["w_gate"]
    k3 = {"k3 w_gate": (stack, ds.lut, torch.randn(
        (stack.codes.shape[0], 5, stack.shape[1]), generator=g,
        device=card).to(torch.bfloat16))}
    ids = torch.randint(1, cfg.vocab_size, (3, 9), generator=g, device=card)
    cases = {"device": "cuda", "matmul": matmul, "k5": k5, "k3": k3,
             "generate": {"generate": (cfg, st.params, st.lut, ids, 6)}}
    one = {key: ops.decode_dequant_matmul(x, w, lut, out_dtype=torch.float32,
                                          decode=d)
           for key, (w, lut, x, d) in matmul.items()}
    one.update({key: ops.dequant_matmul(x, q.values, q.scale, q.zero,
                                        out_dtype=torch.float32)
                for key, (q, x) in k5.items()})
    one.update({key: ops.grouped_decode_dequant_matmul(
        xe, w, lut, out_dtype=torch.float32)
        for key, (w, lut, xe) in k3.items()})
    one["generate"] = E.generate(st.params, cfg, ids, lut=st.lut,
                                 max_new=6)
    return cases, one


def test_mesh_ranks_on_card_are_one_process_bitwise(card):
    """Two ranks on the one card (gloo takes CUDA tensors): each rank's
    K1 and K5 on its out band and K3 on its experts, launched with the
    whole weight's plan, gathered, are one process's outputs bit for bit;
    generate on the mesh gives one process's tokens; K1/K3's SIMT kernel
    launches in no rank."""
    import torch_mesh_worker
    from repro_torch.launch import mesh as M
    _build.build()
    cases, one = _mesh_cases(card)
    outs = M.spawn(torch_mesh_worker.run, 2, (1, 2), cases, device="cuda")
    for out in outs:
        for key in list(cases["matmul"]) + list(cases["k5"]) + list(
                cases["k3"]):
            y, probe = out[key][:2]
            assert torch.equal(y.to(card), one[key]), key
            assert set(probe) <= {"fused_shard_map", "dequant_shard_map",
                                  "grouped_fused_shard_map"}, probe
        toks, probe = out["generate"]
        assert torch.equal(toks.to(card), one["generate"])
        assert not probe.get("fused") and probe["fused_shard_map"] > 0
        launches = out["launches"]
        assert launches.get("fused_decode_matmul:decode", 0) > 0
        assert launches.get("grouped_fused_decode_matmul:decode", 0) > 0
        assert not launches.get("fused_decode_matmul:simt")


@pytest.mark.parametrize("shards,b", [(2, 4), (4, 4), (2, 2), (4, 20)])
def test_decode_attention_rank_heads_bitwise_on_card(card, shards, b):
    """A mesh rank's kv heads through the decode attention (the heads path
    of ``layers.apply_attention``), its rows padded for every kv head
    (``kv_heads=``): each head is bitwise the whole call's, at Llama-3.2-1B's
    heads (cuBLAS picks a batched GEMM by its batch count, so unpadded the
    rank's heads part by up to 1.5e-5: ``tools/mesh_bits.py``)."""
    g = _gen(card, 5)
    lk, hq, hkv, d = 207, 32, 8, 64

    def rand(*shape):
        return torch.randn(shape, generator=g, device=card).to(torch.bfloat16)

    q, k, v = rand(b, 1, hq, d), rand(b, lk, hkv, d), rand(b, lk, hkv, d)
    pos = torch.tensor(175, device=card)
    whole = L._attend_cached(q, k, v, pos, 1)
    qh, kh = hq // shards, hkv // shards
    for i in range(shards):
        part = L._attend_cached(q[:, :, i * qh:(i + 1) * qh],
                                k[:, :, i * kh:(i + 1) * kh],
                                v[:, :, i * kh:(i + 1) * kh], pos, 1,
                                kv_heads=hkv)
        assert torch.equal(part, whole[:, :, i * qh:(i + 1) * qh]), i


class _PiecesMesh:
    """A stand-in for the model axis of ``ms`` ranks, as rank ``rank``
    sees it: its all-gather puts the other ranks' piece sums of their
    bands of the row (``layers.square_pieces``) beside the rank's own."""

    def __init__(self, bands, rank):
        self.bands, self.rank = bands, rank

    def all_gather(self, t, axes, dim):
        k = 16 // len(self.bands)
        return torch.cat([t if i == self.rank else L.square_pieces(b, k)
                          for i, b in enumerate(self.bands)], dim)


@pytest.mark.parametrize("ms", [2, 4])
@pytest.mark.parametrize("shape", [(1, 1, 5120), (4, 1, 5120), (2, 7, 128),
                                   (3, 300, 4096)])
def test_ssm_gated_norm_pieces_are_mean_square_on_card(card, ms, shape):
    """A model rank's gated-norm mean of squares (``ssm.gated_mean_square``:
    its 16/ms pieces of d/16, the other ranks' gathered beside them, the
    16 added in one process's order) is bitwise ``layers._mean_square``
    of the whole row, at one row and at many (Mamba2-2.7B's d_inner
    5 120, Zamba2-1.2B's 4 096, the smoke models' 128)."""
    g = _gen(card, 11)
    xf = torch.randn(shape, generator=g, device=card)
    whole = L._mean_square(xf)
    bands = list(xf.split(shape[-1] // ms, dim=-1))
    for r in range(ms):
        got = SSM.gated_mean_square(bands[r], _PiecesMesh(bands, r), ms,
                                    shape[-1], False)
        assert torch.equal(got, whole), r


@pytest.mark.parametrize("ms", [2, 4, 16])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_ssm_decode_step_rank_heads_bitwise_on_card(card, ms, b):
    """A model rank's heads through ``ssm.ssd_decode_step`` (its x, dt,
    decay and state of its heads, B and C of its heads' group) are
    bitwise the whole call's heads, at Mamba2-2.7B's 80 heads of 64 × 128
    state, one group."""
    g = _gen(card, 12)
    h, p, n = 80, 64, 128

    def rand(*shape):
        return torch.randn(shape, generator=g, device=card)

    x, dt = rand(b, 1, h, p).to(torch.bfloat16), rand(b, 1, h).abs()
    a = -rand(h).abs()
    bi, ci = rand(b, 1, 1, n).to(torch.bfloat16), rand(b, 1, 1, n).to(
        torch.bfloat16)
    state = rand(b, h, p, n)
    y, s = SSM.ssd_decode_step(x, dt, a, bi, ci, state)
    hl = h // ms
    for m in range(ms):
        sl = slice(m * hl, (m + 1) * hl)
        ym, sm = SSM.ssd_decode_step(
            x[:, :, sl], dt[:, :, sl], a[sl], SSM._rank_groups(bi, h, hl, m),
            SSM._rank_groups(ci, h, hl, m), state[:, sl].contiguous())
        assert torch.equal(ym, y[:, :, sl]), m
        assert torch.equal(sm, s[:, sl]), m


def test_train_mesh_step_on_card_matches_one_process(card):
    """Four ranks on the one card (gloo), the Llama smoke train state
    sharded on (2, 2) (ZeRO-3): 3 steps, each from the state the mesh
    reached against one process's step on the card from the same state —
    the loss within 1e-5 relative and the parameters, as one vector,
    within 1e-6 (tests/test_torch_mesh_train.py's step bounds: the
    gradients add over the data ranks in another order); every rank the
    same losses; each rank's forward on K2's f32 kernel, one launch a
    layer a step."""
    import torch_mesh_train_worker
    from repro_torch.launch import mesh as M
    from repro_torch.train import tree as T
    from repro_torch.train.data import DataConfig, DataPipeline
    from repro_torch.train.steps import (TrainConfig, init_train_state,
                                         make_train_step)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3.2-1b").smoke
    tcfg = TrainConfig()
    state = init_train_state(LM.init_lm(cfg, seed=0, device=card), tcfg)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=4,
                                   seq_len=32, seed=2))
    batches = [data.batch_at(i) for i in range(3)]
    outs = M.spawn(torch_mesh_train_worker.run, 4, (2, 2), {
        "steps": {"llama": (cfg, tcfg, state, batches)}}, device="cuda")
    states, metrics, _ = outs[0]["llama"]
    step = make_train_step(cfg, tcfg)
    for i, b in enumerate(batches):
        new, m = step(T.map_leaves(lambda t: t.to(card), states[i]), b)
        assert metrics[i]["loss"] == pytest.approx(float(m["loss"]),
                                                   rel=1e-5), i
        a, w = T.leaves(states[i + 1]["params"]), T.leaves(new["params"])
        num = sum(float(((x.to(card) - y) ** 2).sum()) for x, y in zip(a, w))
        den = sum(float((y ** 2).sum()) for y in w)
        assert (num / den) ** 0.5 <= 1e-6, i
    for out in outs:
        assert out["llama"][1] == metrics
        assert out["launches"] == {"flash_attention:tf32x3":
                                   3 * cfg.n_layers}


def _example(name):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_on_card(card):
    """On the card the example holds the codec (every compressed weight
    decodes to the quant state's int8 values) and the tokens under the
    exact-tie rule (K1 and K5 sum in other orders)."""
    out = _example("torch_quickstart").main([], device=card)
    assert not out["codec_mismatch"] and out["codec_weights"] > 0
    assert out["eager_matches_generate"]
    assert all(p["tied"] for p in out["parting"])


@pytest.mark.parametrize("mode", ["compressed", "quant", "dense"])
def test_serve_batched_example_on_card(card, mode):
    out = _example("torch_serve_batched").main(["--mode", mode],
                                               device=card)
    assert out["prefill_ms"] > 0 and out["graph_tok_s"] > 0
    assert out["tokens"].shape == (8, 16)


def test_dryrun_plan_matches_run_on_card(card):
    """The dry run's plan (``launch/dryrun.py``) of the Llama smoke
    model's eager prefill and one decode step, on fake tensors of the
    packed state's shapes, launches by ``<wrapper>:<kernel>`` what the
    same calls launch on the card (``_build.KERNEL_COUNTS``), and holds
    the bytes they hold; the plans split by the card's own SM count."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import op_stats
    assert torch.cuda.get_device_properties(card).multi_processor_count \
        == _build.PLAN_SMS
    cfg = get_config("llama3.2-1b").smoke
    params = LM.init_lm(cfg, seed=0, device=card)
    st = build_serve_params(params, CompressionPolicy(min_weight_size=1024),
                            device=card, manifest=False)
    ids = torch.randint(0, cfg.vocab_size, (3, 11), generator=_gen(card),
                        device=card)
    caches = LM.init_caches(cfg, 3, 16, device=card)
    prefill, decode = make_serve_fns(cfg, device=card)
    real = {}
    with torch.no_grad():
        _build.KERNEL_COUNTS.clear()
        logits, caches = prefill(st.params, st.lut, {"tokens": ids}, caches)
        real["prefill"] = dict(_build.KERNEL_COUNTS)
        tok = logits.argmax(-1)[:, None]
        held = op_stats.tree_bytes(st.params, st.lut, tok, caches)
        _build.KERNEL_COUNTS.clear()
        decode(st.params, st.lut, tok, caches, 11)
        real["decode"] = dict(_build.KERNEL_COUNTS)
    _build.KERNEL_COUNTS.clear()
    plans = {}
    with D.fake_tensors(card):
        p, lut = D.fake_like(st.params, card), D.fake_like(st.lut, card)
        fc = D.fake_like(caches, card)
        plans["prefill"] = D.plan_step(D.serve_step(cfg, "prefill", None,
                                                    card), p, lut,
                                       {"tokens": D.fake_like(ids, card)},
                                       fc, mesh=None)
        plans["decode"] = D.plan_step(D.serve_step(cfg, "decode", None,
                                                   card), p, lut,
                                      D.fake_like(tok, card), fc, 11,
                                      mesh=None)
    _build.KERNEL_COUNTS.clear()
    _build.LAUNCH_COUNTS.clear()
    for step in ("prefill", "decode"):
        assert {k: v["launches"] for k, v in
                plans[step]["kernels"].items()} == real[step], step
    assert real["prefill"]["flash_attention:mma"] == cfg.n_layers
    assert plans["decode"]["memory"]["argument_size_in_bytes"] == held
