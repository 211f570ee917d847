"""Causal online-softmax attention (FlashAttention) with GQA.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention`` (the
TPU Pallas kernel).  The CUDA source is ``csrc/flash_attention.cu``, with
two kernels, both on the tensor cores (``mma.sync``), chosen by dtype:
bf16 q, k and v (every path through ``generate``) run the bf16 kernel
(bf16 operands, f32 sums, P split into bf16 hi + lo for P·V), counted as
``flash_attention``; any f32 operand runs the f32 kernel (TF32 operands
split into hi + lo, each product taken as hi·hi + hi·lo + lo·hi, f32
sums), counted as ``flash_attention_f32``.  A bf16 operand beside an f32
one is upcast to f32 before the launch (exact), and a bf16 q's output is
rounded back to bf16.  :func:`flash_attention_plain` is the plain PyTorch
version the CPU runs and the card's kernels are held against.
Layouts are the reference's: q (B, Hq, Tq, Dqk), k (B, Hkv, Tk, Dqk), v
(B, Hkv, Tk, Dv) → (B, Hq, Tq, Dv) in q's dtype, with query i at position
``q_offset + i``.  Masked scores are NEG_INF = −1e30 and the denominator
is max(l, 1e−30), as in the reference.  Both kernels also count in
``_build.KERNEL_COUNTS`` as ``flash_attention:mma`` / ``:tf32x3``.

Training differentiates through K2 with :class:`FlashAttentionFn`: its
forward launches the kernel (f32 operands, as training runs, the f32
kernel; bf16 the bf16 kernel), its backward recomputes attention
with :func:`flash_attention_plain` under autograd and differentiates
that.  The reference has no backward kernel (its attention has no
``custom_vjp``: JAX differentiates its plain path), so none is ported.
The kernels take the head-dim
pairs (Dqk, Dv) of ``HEAD_DIMS``: Llama's 64 and 128, DeepSeek-V2's
MLA (qk_nope + qk_rope = 192, v = 128), and the smoke configs' 16 and MLA
24/16 (the bf16 kernel stages Dqk 24 with zero columns up to 32).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NAME = "flash_attention"          # the CUDA source; the bf16 kernel's count
F32_NAME = "flash_attention_f32"  # the f32 (three-term TF32) kernel's count
NEG_INF = -1e30
# (Dqk, Dv) in the kernels: the published widths, then the smoke configs
HEAD_DIMS = ((64, 64), (128, 128), (192, 128), (16, 16), (24, 16))
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# both C entries: q, k, v, out, B, Hq, Hkv, Tq, Tk, Dqk, Dv, 9 strides,
# sm_scale, causal, q_offset, device, stream
_ARGTYPES = ([_P] * 4 + [_I] * 7 + [_L] * 9 + [ctypes.c_float]
             + [_I] * 3 + [_P])
# kernel → (C entry, operand dtype); the KERNEL_COUNTS key is NAME:kernel
_KERNELS = {"mma": ("qmoe_flash_attention_mma", torch.bfloat16),
            "tf32x3": ("qmoe_flash_attention_tf32x3", torch.float32)}


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          sm_scale: float | None = None,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain version: the full masked softmax in f32, grouped over the kv
    heads (no repeat)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rep = hq // hkv
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qg = q.to(torch.float32).reshape(b, hkv, rep, tq, d)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.to(torch.float32)) * sm
    if causal:
        qpos = torch.arange(tq, device=q.device) + q_offset
        kpos = torch.arange(tk, device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.to(torch.float32))
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, tq, v.shape[-1]).to(q.dtype)


def work(b: int, hq: int, hkv: int, tq: int, tk: int, d: int, dv: int, *,
         causal: bool = True, q_offset: int = 0, itemsize: int = 2
         ) -> tuple:
    """(FLOPs, bytes) of one launch: 2·(Dqk + Dv) operations per (query,
    key) pair the mask keeps (query i sees keys up to q_offset + i, all
    of them without the mask); the keys and values that some query sees
    read once, q read and the output written once, each element of
    ``itemsize`` bytes (2: the bf16 kernel; 4: the f32 one).  A dry run's
    plan (``launch/dryrun.py``) and ``chip_smoke.py``'s bounds count by
    it."""
    if causal:
        # Σ_i min(tk, q_offset + i + 1) over the tq queries
        full = max(0, min(tq, q_offset + tq - tk + 1))
        lo, hi = q_offset + 1, q_offset + tq - full
        pairs = full * tk + (hi + lo) * max(0, hi - lo + 1) // 2
        seen = min(tk, q_offset + tq)
    else:
        pairs, seen = tq * tk, tk
    return (2 * (d + dv) * b * hq * pairs,
            itemsize * (b * hkv * seen * (d + dv) + b * hq * tq * (d + dv)))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its base and (B, H, T) strides are multiples of 16 bytes
    (the kernels' copy unit: 8 bf16, 4 f32), else a contiguous copy that
    is."""
    per = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(st % per == 0 for st in t.stride()[:3]):
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """(B, Hq, Tq, Dqk) × (B, Hkv, Tk, Dqk), (B, Hkv, Tk, Dv) →
    (B, Hq, Tq, Dv).  Any strides over (B, H, T) with the head dim
    contiguous; ``sm_scale`` defaults to 1/sqrt(Dqk).  CPU tensors take the
    plain version; CUDA tensors launch a kernel or raise: the bf16 kernel
    when q, k and v are bf16, the f32 (three-term TF32) kernel when any is
    f32 (a bf16 operand upcast first).  An operand whose base or (B, H, T)
    strides are not multiples of 16 bytes goes through ``.contiguous()``
    first."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q.device}")
    dev = _build.cuda_args(q, k, v)
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    dv = v.shape[3]
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d
            or hq % hkv):
        raise ValueError(f"{NAME}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head_dim pair {(d, dv)} not in "
                         f"{HEAD_DIMS}")
    if q_offset < 0:
        raise ValueError(f"{NAME}: q_offset must be ≥ 0, got {q_offset}")
    ok = (torch.bfloat16, torch.float32)
    if q.dtype not in ok or k.dtype not in ok or v.dtype != k.dtype:
        raise TypeError(f"{NAME}: q and k/v must be bf16 or f32")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{NAME}: head_dim must be the contiguous axis")
    out = torch.empty((b, hq, tq, dv), dtype=q.dtype, device=dev)
    if b * hq * tq == 0:
        return out
    sm = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    kernel = "mma" if q.dtype == k.dtype == torch.bfloat16 else "tf32x3"
    symbol, dtype = _KERNELS[kernel]
    q, k, v = (t.to(dtype) for t in (q, k, v))
    if _build.PLAN is None:     # a plan's fake tensors have no address
        q, k, v = (_aligned(t) for t in (q, k, v))
    res = out if out.dtype == dtype else torch.empty_like(out, dtype=dtype)
    name = NAME if kernel == "mma" else F32_NAME
    if _build.PLAN is not None:        # a dry run: planned, not launched
        _build.PLAN.launch(f"{NAME}:{kernel}", work(
            b, hq, hkv, tq, tk, d, dv, causal=causal, q_offset=q_offset,
            itemsize=dtype.itemsize))
    else:
        fn = _build.function(NAME, symbol, _ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), res.data_ptr(),
                 b, hq, hkv, tq, tk, d, dv, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], float(sm), int(causal),
                 int(q_offset), dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, name)
    _build.LAUNCH_COUNTS[name] += 1
    _build.KERNEL_COUNTS[f"{NAME}:{kernel}"] += 1
    if res is not out:
        out.copy_(res)
    return out


class FlashAttentionFn(torch.autograd.Function):
    """K2 under autograd: the forward is :func:`flash_attention` (the
    kernel on CUDA tensors, which raises rather than fall back; the plain
    version on the CPU), the backward the plain version's gradient,
    recomputed from the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset)
        return flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(saved, ctx.needs_input_grad[:3])]
            out = flash_attention_plain(*ins, **ctx.opts)
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(got) if t.requires_grad else None
                     for t in ins) + (None, None, None)
