"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc.  Imports nothing of JAX or of the JAX package.
Phases, in order; the script exits non-zero if any fails:

  1. Device: the card's name and power limit (nvidia-smi), and the build of
     every kernel from ``src/repro_torch/kernels/csrc`` (one nvcc per
     source, all started together, into ``src/repro_torch/kernels/build``).
  2. Pack: Llama-3.2-1B at full width and all 16 layers, weights drawn from
     a seed on the card, packed by ``build_serve_params(mode='compressed')``
     with the default policy.
  3. Kernels against their plain PyTorch versions at the main path's
     shapes, on the packed planes: bitwise on integer-valued bf16 x, within
     a stated tolerance on random x; times (CUDA events, L2 flushed before
     every launch), bounds, the plain version's time and one PyTorch
     library call's time as a yardstick.
  4. End to end: ``generate`` answers 4 left-padded requests (prompt
     lengths 32–200 from the seed) with 32 new tokens each; the launch
     counts of that run must show every kernel of the path.
  5. Card against CPU: the same seeded model at 2 layers, packed once; the
     prefill logits of the card and of the CPU (plain versions) must agree
     within a stated tolerance; greedy tokens of 8 steps are compared.

Prints one JSON ``kernels`` line, one ``e2e`` line, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCH, MAX_NEW = 4, 32
PROMPT_MIN, PROMPT_MAX = 32, 200
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak, same source
# Tolerances, each with its reason:
#  * K1/K5 on random bf16 x, f32 output: the kernel and the plain version
#    sum the same exact products in another order; f32 roundoff over
#    K ≤ 8192 terms stays far below 1e-4 of the output's scale.
MATMUL_RTOL = 1e-4
#  * K2 in bf16 (the main path's dtypes): f32 math in both, another order
#    of sums and another exp; the bf16 output may round to the other side:
#    two bf16 ulps at |out| ≈ 1 (|v| ≤ ~4 for normal inputs).
FLASH_ATOL_BF16 = 1.6e-2
#  * K2 with f32 q and output: f32 roundoff only.
FLASH_ATOL_F32 = 1e-4
#  * Card against CPU prefill logits at 2 layers: bf16 activations, where
#    a rounding flip is 2^-8 relative, pass through 2 layers of width 2048
#    and the 2048-wide LM head; logits are O(1).
E2E_LOGIT_ATOL = 5e-2


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device milliseconds per call.

    ``graph_ms``: the calls are captured once in a CUDA graph and the graph
    is replayed between two CUDA events, so the host's Python overhead is
    not counted; the K1 calls walk the 16 layers' planes, so (as on the
    main path) the weights exceed the 50 MB L2.  ``ms``: CUDA events
    around single calls with the L2 flushed before each, host overhead
    included — for the plain versions, which are no speed yardstick."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def graph_ms(self, fns, reps: int = 10) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for f in fns:                       # warm-up outside capture
                f()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for f in fns:
                f()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * len(fns))

    def ms(self, fn, iters: int = 5, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for i in range(iters):
            self.flush.zero_()
            starts[i].record()
            fn()
            ends[i].record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def int_x(m, k, gen, device):
    return torch.randint(-4, 5, (m, k), generator=gen, device=device
                         ).to(torch.bfloat16)


def rand_x(m, k, gen, device):
    return torch.randn((m, k), generator=gen, device=device
                       ).to(torch.bfloat16)


def make_prompts(vocab: int):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, BATCH)
    reqs = [rng.integers(0, vocab, int(n)) for n in lens]
    width = int(max(lens))
    batch = np.zeros((BATCH, width), np.int64)     # left-padded with 0
    for i, r in enumerate(reqs):
        batch[i, width - len(r):] = r
    return batch, [int(n) for n in lens]


# ---------------------------------------------------------------------------

def check_fused(rt, state, device, t_prefill, gen, timer):
    """K1 on the four Llama-3.2-1B projection shapes at M = batch (decode)
    and M = batch·T (prefill)."""
    fdm = rt["fdm"]
    blocks = state.params["blocks"]
    lut = state.lut
    names = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
             ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down")]

    def planes(w):
        return ((w.codes, w.literals, lut, w.scale, w.zero),
                dict(shape=w.shape, tile_n=w.tile_n, tile_k=w.tile_k))

    rows, worst, bitwise = [], 0.0, True
    agg = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    seen = set()
    for grp, name in names:
        ws = [b[grp][name] for b in blocks]
        w = ws[0]
        n, k = w.shape
        args, kw = planes(w)
        for m in (BATCH, BATCH * t_prefill):
            xi = int_x(m, k, gen, device)
            yk = fdm.fused_decode_matmul(xi, *args, **kw,
                                         out_dtype=torch.bfloat16)
            yp = fdm.fused_decode_matmul_plain(xi, *args, **kw,
                                               out_dtype=torch.bfloat16)
            same = bool(torch.equal(yk, yp))
            bitwise &= same
            xr = rand_x(m, k, gen, device)
            yk = fdm.fused_decode_matmul(xr, *args, **kw,
                                         out_dtype=torch.float32)
            yp = fdm.fused_decode_matmul_plain(xr, *args, **kw,
                                               out_dtype=torch.float32)
            err = float((yk - yp).abs().max())
            tol = MATMUL_RTOL * float(yp.abs().max())
            worst = max(worst, err)
            if not (same and err <= tol and torch.isfinite(yk).all()):
                raise AssertionError(f"K1 {w.shape} M={m}: bitwise={same} "
                                     f"err={err} tol={tol}")
            key = (n, k, m)
            if key in seen:       # wq/wo and w_gate/w_up share a shape
                t = next(r for r in rows if (r["N"], r["K"], r["M"]) == key)
            else:
                seen.add(key)
                b, by = bound_ms(nbytes(xr, *args) + m * n * 2,
                                 2.0 * m * n * k)
                kern = [lambda p=planes(wl): fdm.fused_decode_matmul(
                    xr, *p[0], **p[1]) for wl in ws]
                wbs = [wl.materialize(lut, torch.bfloat16) for wl in ws]
                lib = [lambda wb=wb: xr @ wb.T for wb in wbs]
                t = {"N": n, "K": k, "M": m, "bitwise": same,
                     "max_abs_err": err,
                     "ms": timer.graph_ms(kern),
                     "plain_ms": timer.ms(lambda: fdm.fused_decode_matmul_plain(
                         xr, *args, **kw, out_dtype=torch.bfloat16)),
                     "library_ms": timer.graph_ms(lib),
                     "bound_ms": b, "bound_by": by,
                     "cap": w.literals.shape[1],
                     "tile": [w.tile_n, w.tile_k]}
                del wbs, lib
                rows.append(t)
            if m == BATCH:
                for f in agg:
                    agg[f] += t[f]
    return {"name": "fused_decode_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_decode_matmul.cu",
            "replaces": "src/repro/kernels/fused_decode_matmul.py:114",
            "bitwise": bitwise, "max_abs_err": worst,
            "timed_at": "one layer's 7 projections, decode M=4",
            **agg, "bound_by": "bytes"}, rows


def check_dequant(rt, state, device, gen, timer):
    """K5 on the tied LM head (128256 × 2048) at M = batch."""
    dqm = rt["dqm"]
    head = state.params["embed"]
    n, k = head.values.shape
    args = (head.values, head.scale, head.zero)
    xi = int_x(BATCH, k, gen, device)
    same = bool(torch.equal(dqm.dequant_matmul(xi, *args),
                            dqm.dequant_matmul_plain(xi, *args,
                                                     torch.bfloat16)))
    xr = rand_x(BATCH, k, gen, device)
    yk = dqm.dequant_matmul(xr, *args, out_dtype=torch.float32)
    yp = dqm.dequant_matmul_plain(xr, *args, torch.float32)
    err = float((yk - yp).abs().max())
    tol = MATMUL_RTOL * float(yp.abs().max())
    if not (same and err <= tol and torch.isfinite(yk).all()):
        raise AssertionError(f"K5 bitwise={same} err={err} tol={tol}")
    wb = head.materialize(torch.bfloat16)
    b, by = bound_ms(nbytes(xr, *args) + BATCH * n * 2, 2.0 * BATCH * n * k)
    row = {"name": "dequant_matmul", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/dequant_matmul.cu",
           "replaces": "src/repro/kernels/dequant_matmul.py:69",
           "bitwise": same, "max_abs_err": err,
           "timed_at": f"LM head {n}x{k}, M={BATCH}",
           # the 263 MB weight exceeds the L2 on its own
           "ms": timer.graph_ms([lambda: dqm.dequant_matmul(xr, *args)] * 4),
           "plain_ms": timer.ms(lambda: dqm.dequant_matmul_plain(
               xr, *args, torch.bfloat16)),
           "library_ms": timer.graph_ms([lambda: xr @ wb.T] * 4),
           "bound_ms": b, "bound_by": by}
    return row


def _sdpa(q, k, v):
    import torch.nn.functional as F
    try:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    except TypeError:        # older torch: repeat the kv heads
        rep = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
            is_causal=True)


def check_flash(rt, cfg, device, t_prefill, gen, timer):
    """K2 at the prefill's (B, 32, T, 64) against (B, 8, T + 32, 64) with
    q_offset 0, and on a ragged prime T."""
    fa = rt["fa"]
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rows, worst = [], 0.0
    for tq in (t_prefill, 197):
        tk = tq + MAX_NEW
        q = torch.randn((BATCH, hq, tq, d), generator=gen, device=device)
        k = torch.randn((BATCH, hkv, tk, d), generator=gen, device=device)
        v = torch.randn((BATCH, hkv, tk, d), generator=gen, device=device)
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        yk = fa.flash_attention(qb, kb, vb)
        yp = fa.flash_attention_plain(qb, kb, vb)
        err = float((yk.float() - yp.float()).abs().max())
        qf = qb.float()
        err32 = float((fa.flash_attention(qf, kb, vb)
                       - fa.flash_attention_plain(qf, kb, vb)).abs().max())
        worst = max(worst, err)
        if not (err <= FLASH_ATOL_BF16 and err32 <= FLASH_ATOL_F32
                and torch.isfinite(yk).all()):
            raise AssertionError(f"K2 T={tq}: bf16 err {err}, f32 err "
                                 f"{err32}")
        pairs = sum(min(tk, i + 1) for i in range(tq))
        seen_k = min(tk, tq)
        b, by = bound_ms(
            2 * (2 * BATCH * hq * tq * d + 2 * BATCH * hkv * seen_k * d),
            4.0 * d * BATCH * hq * pairs)
        kr = kb[:, :, :tq]
        vr = vb[:, :, :tq]
        rows.append({"Tq": tq, "Tk": tk, "max_abs_err": err,
                     "max_abs_err_f32": err32,
                     "ms": timer.graph_ms(
                         [lambda: fa.flash_attention(qb, kb, vb)] * 8),
                     "plain_ms": timer.ms(lambda: fa.flash_attention_plain(
                         qb, kb, vb)),
                     # SDPA's causal mask is aligned top-left; over the
                     # first Tq keys it is the same function
                     "library_ms": timer.graph_ms(
                         [lambda: _sdpa(qb, kr, vr)] * 8),
                     "bound_ms": b, "bound_by": by})
    main = rows[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:80",
            "max_abs_err": worst,
            "timed_at": f"prefill (B={BATCH}, {hq}, T={t_prefill}, {d}) vs "
                        f"Tk={t_prefill + MAX_NEW}",
            **{f: main[f] for f in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")}}, rows


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_decode_matmul as fdm
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.serve.engine import (build_serve_params, generate,
                                          make_serve_fns)
    rt = {"fdm": fdm, "dqm": dqm, "fa": fa}
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    failed = []

    # -- 1. device + build ---------------------------------------------------
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + json.dumps({k: round(v, 1) for k, v in built.items()}))
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # -- 2. pack Llama-3.2-1B -----------------------------------------------
    cfg = get_config("llama3.2-1b").full
    batch, lens = make_prompts(cfg.vocab_size)
    t_prefill = batch.shape[1]
    t0 = time.perf_counter()
    params = LM.init_lm(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = build_serve_params(params, CompressionPolicy(mode="compressed"),
                               device=device)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    log(f"pack: llama3.2-1b ({cfg.n_layers} layers) init {init_s:.2f} s, "
        f"build_serve_params {pack_s:.2f} s, table {len(state.table)} codes, "
        f"stats {json.dumps(state.stats)}")

    # -- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    timer = Timer(device)
    kernels, detail = {}, {}
    for name, fn in (
            ("fused_decode_matmul",
             lambda: check_fused(rt, state, device, t_prefill, gen, timer)),
            ("dequant_matmul",
             lambda: (check_dequant(rt, state, device, gen, timer), None)),
            ("flash_attention",
             lambda: check_flash(rt, cfg, device, t_prefill, gen, timer))):
        try:
            kernels[name], detail[name] = fn()
        except Exception:
            traceback.print_exc()
            failed.append(f"kernel {name}")
    log("kernel_detail " + json.dumps(detail))

    # -- 4. end to end: the main path ------------------------------------------
    e2e = {}
    try:
        _build.LAUNCH_COUNTS.clear()
        L.MATERIALIZE_COUNTS.clear()
        ops.DISPATCH_COUNTS.clear()
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(state.params, cfg, batch, lut=state.lut,
                       max_new=MAX_NEW, device=device)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCH_COUNTS)
        materialized = dict(L.MATERIALIZE_COUNTS)
        peak = torch.cuda.max_memory_allocated(device)
        # prefill alone, timed after the counted run (3 runs, median)
        prefill, _ = make_serve_fns(cfg, device=device)
        ids = torch.as_tensor(batch, device=device)
        pre = []
        for _ in range(3):
            caches = LM.init_caches(cfg, BATCH, t_prefill + MAX_NEW,
                                    device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = prefill(state.params, state.lut, {"tokens": ids},
                                caches)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t0)
        prefill_s = sorted(pre)[1]
        new = out[:, t_prefill:].cpu()
        e2e = {"model": cfg.name, "layers": cfg.n_layers, "batch": BATCH,
               "prompt_lens": lens, "max_new": MAX_NEW,
               "pack_s": pack_s, "generate_s": gen_s,
               "prefill_ms": prefill_s * 1e3,
               "decode_tokens_per_s": BATCH * (MAX_NEW - 1)
               / (gen_s - prefill_s),
               "peak_mem_bytes": peak, "stats": state.stats,
               "launches": launches, "materialize_counts": materialized,
               "first_request_tokens": new[0].tolist()}
        want = {"fused_decode_matmul": 7 * cfg.n_layers * MAX_NEW,
                "dequant_matmul": MAX_NEW}
        ok = (tuple(out.shape) == (BATCH, t_prefill + MAX_NEW)
              and int(new.min()) >= 0 and int(new.max()) < cfg.vocab_size
              and all(launches.get(k) == v for k, v in want.items())
              and launches.get("flash_attention", 0) > 0
              and materialized.get("packed", 0) == 0
              and bool(torch.isfinite(logits.float()).all()))
        if not ok:
            raise AssertionError(f"main path: launches {launches} (want "
                                 f"{want}, flash > 0), materialize "
                                 f"{materialized}, out {tuple(out.shape)}")
        for name, row in kernels.items():
            row["launches"] = launches.get(name, 0)
    except Exception:
        traceback.print_exc()
        failed.append("e2e")
    log("e2e " + json.dumps(e2e))
    del state
    torch.cuda.empty_cache()

    # -- 5. card against CPU at 2 layers ---------------------------------------
    try:
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        params2 = LM.init_lm(cfg2, seed=SEED + 1, device=device)
        st_gpu = build_serve_params(params2, CompressionPolicy(),
                                    device=device)
        del params2
        st_cpu = st_gpu.to("cpu")
        ids = torch.as_tensor(batch)
        res = {}
        for dev, st in (("cuda", st_gpu), ("cpu", st_cpu)):
            prefill, _ = make_serve_fns(cfg2, device=dev)
            caches = LM.init_caches(cfg2, BATCH, t_prefill + 8, device=dev)
            logits, _ = prefill(st.params, st.lut, {"tokens": ids}, caches)
            toks = generate(st.params, cfg2, ids, lut=st.lut, max_new=8,
                            device=dev)
            res[dev] = (logits.float().cpu(), toks[:, t_prefill:].cpu())
        err = float((res["cuda"][0] - res["cpu"][0]).abs().max())
        scale = float(res["cpu"][0].abs().max())
        mism = int((res["cuda"][1] != res["cpu"][1]).sum())
        log("card_vs_cpu " + json.dumps({
            "layers": 2, "logit_max_abs_err": err, "logit_scale": scale,
            "tolerance": E2E_LOGIT_ATOL, "token_mismatches": mism,
            "tokens_compared": BATCH * 8}))
        if not (err <= E2E_LOGIT_ATOL and math.isfinite(err)):
            raise AssertionError(f"card vs CPU logits differ by {err}")
    except Exception:
        traceback.print_exc()
        failed.append("card_vs_cpu")

    for row in kernels.values():
        row.setdefault("launches", 0)
    log(json.dumps({"kernels": [kernels[k] for k in kernels]}))
    if failed:
        log(f"FAILED: {failed}")
        return 1
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
