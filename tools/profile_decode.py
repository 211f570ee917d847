"""Where the time of the port's main paths goes on the card.

    python3 tools/profile_decode.py
        [--model llama|deepseek|both|engine|rows|k1|k2|k4|k5|train]
        [--src DIR]

For each model — Llama-3.2-1B (all 16 layers) and DeepSeek-V2-Lite (full
width, 8 of 27 layers, as chip_smoke.py serves it) — packs seeded weights
in compressed mode on the CUDA card, serves the 4 prompts of chip_smoke.py,
and profiles one prefill, 8 decode steps dispatched from Python (the eager
loop) and, where the port has it, the same 8 steps as replays of the
captured decode graph (``serve.engine.decode_graph``; the window starts
after its capture, and no Python runs in it, so no range marks the
absorb chain there) with torch.profiler: device
time by kernel, K2's time (every kernel named ``flash_attention``...), K4's
(``dict_decode``...), K5's (``dequant_matmul``...), the calls of the
split-K epilogue, and the share of the window's wall time in which the
device ran a kernel.  Busy time sums the device's own events (kernels,
copies, fills) only: an operator's row repeats its kernels' time and is
not counted.  The absorb chain (``PackedLinear.materialize``: K4, the
untile copy of ``materialize_int8`` and the dequantize ops after it; MLA's
``wkv_b`` on DeepSeek) is K4's time plus the device time of the
kernels that the operators of its calls launch, which the tool marks
with ``record_function`` ranges for the window (``absorb_span_ms``: the
device-side span of those ranges, the gaps between their kernels
included).  Prints one JSON line per window.

``--model engine`` profiles request-level serving on Llama-3.2-1B (all 16
layers): ``serve.scheduler.Engine`` with 4 slots of 232 tokens (pages of
8), as chip_smoke.py's engine phase builds it, holding chip_smoke.py's 4
prompts (unpadded).  After the admissions, the capture of the generate
step and a replayed tick, it profiles 8 ticks at full occupancy (each:
one host-to-device copy of the step's inputs, a replay of the step's
graph, the next-token read, the host's retire), then a step that admits
one request (its batch-1 prefill into the fragment, the insert into its
pages, and a tick).

``--model rows`` times ``generate``'s graphed decode on Llama-3.2-1B (all
16 layers) at batch 4, 8 and 16 (chip_smoke.py's prompts, 32 new tokens):
a warm-up prefill and decode (the step's capture), then the prefill and
the replayed decode phase timed three times (medians), and the launches
of one replayed step by kernel.  With ``--src`` A B B A, it shows what a
batch above 4 costs a step on each tree.

``--model k1`` times the fused decode-matmul kernels alone, at M = 4
(decode), 5, 8 and 16 (an engine tick or a batch of 5–16 rows) and 700
(prefill): K1 (``fused_decode_matmul``) on Llama-3.2-1B's seven
projection shapes, as chip_smoke.py does (CUDA-graph replays walking the
16 layers' planes; ``layer_ms`` sums a layer's seven at each M), and on
DeepSeek-V2-Lite's first down projection (2048 × 10944, tile_k 64, at M =
4 and 700; and as the tiled state packs it, two column groups at tile_k
32, at M = 700; the L2 flushed before each call); K3
(``grouped_fused_decode_matmul``) on DeepSeek-shaped expert stacks,
gate/up (64 × 1408 × 2048) and down (64 × 2048 × 1408), at cap 4, 8, 16
and 83.  The DeepSeek shapes are packed from seeded random weights of
those shapes alone.  Each row has the kernel the plan picks, its bytes or
operations bound and the time of one PyTorch call on the materialized
bf16 weights (``torch.matmul``; ``torch.bmm`` for a stack), timed the same
way; where ``K1_VARIANT_AT`` names the projection and M, the 16-row decode
kernel's design variants (``K1_VARIANTS``, built from the source with one
line replaced), bitwise-checked against it and timed beside it.  Prints
the registers and spills ptxas reports for each kernel of the source, and
one JSON line.

``--model k2`` times K2 (``flash_attention``) alone with CUDA-graph
replays, as chip_smoke.py does, at both paths' prefill shapes: Llama's
(4, 32 q / 8 kv heads, 175, 64) and MLA's (4, 16 / 16, 175, 192 / 128)
against 207 keys, and each at a ragged T = 197 against 229, through
chip_smoke.py's ``check_flash``.  Beside each: the kernel's error against
the plain version, its time and error with f32 q (the SIMT kernel), the
plain version's and SDPA's times and the bounds.  Prints the
registers, spills and static shared memory ptxas reports for each K2
instantiation, and one JSON line.

``--model k5`` times K5 (``dequant_matmul``) alone at M = 4 on both
paths' int8 LM heads, Llama-3.2-1B's 128 256 × 2048 and DeepSeek-V2-Lite's
102 400 × 2048 (quantized from seeded random weights of those shapes),
through chip_smoke.py's ``check_dequant``: its error against the plain
version, the kernel and grid the plan picks, its time (CUDA-graph
replays; each head is past the L2), ``torch.matmul``'s on the bf16 head
and the bytes bound.  Then the decode kernel's design choices: variants
of its source with one constant or line replaced (16 rows a warp, 4
warps a block, 4 loads a stage, no L2 prefetch, bf16 packed by PRMT;
K5_VARIANTS), built beside the kernels, and the source as built on two
other grids (2 blocks an SM; one task a warp), each bitwise-checked and
timed the same way, with its registers and spills.  Prints the registers
and spills ptxas reports for each K5 instantiation, and one JSON line.

``--model k4`` times K4 (``dict_decode``) alone on two planes of
DeepSeek-V2-Lite's MLA ``wkv_b`` shape (4096 × 512: 512 blocks of 1024
slots): one packed from a seeded random weight of that shape alone (tile-
major, as served: almost every gram escapes the dictionary), and one
whose first half of blocks the dictionary covers and whose second half
escapes (a literal capacity of ~1024 rows that half the blocks do not
use), through chip_smoke.py's ``check_dict_decode``: bitwise against the
plain version and between two calls, its time (CUDA-graph replays, the
L2 wiped before each call), the floor and copy times beside it, the bytes
bound.  Then the kernel's design choices: variants of its source with
its constants replaced (K4_VARIANTS: slots a lane and warps a block),
built beside the kernels and launched at the shape ``launch_shape`` gives
their constants, each bitwise-checked and timed the same way on both
planes, with its registers and spills.  Prints the registers and spills ptxas reports for
each K4 instantiation, and one JSON line.

``--src DIR`` imports the port from ``DIR``
instead of this checkout's ``src``: to compare two commits on one card,
unpack the other (``git archive``) into a gitignored directory and run
both in one call, in the order A, B, B, A.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
BATCH, DECODE_STEPS, SEED = 4, 8, 0
K1_M = (BATCH, 5, 8, 16, 700)     # --model k1: the M of Llama's projections
# The decode kernel's design choices at 5–16 rows: variants of
# csrc/fused_decode_matmul.cu with one line replaced, timed beside the
# source where ``K1_VARIANT_AT`` names the projection and M (the bits must
# not move: each row's arithmetic is the same).
K1_VARIANTS = {
    "4 warps a block": {"constexpr int kDecRowWarps = 8;":
                        "constexpr int kDecRowWarps = 4;"},
}
K1_VARIANT_AT = {("wq", 16), ("w_gate", 8), ("w_gate", 16), ("w_down", 16),
                 ("experts.w_gate", 16), ("experts.w_down", 16)}
MODELS = {"llama": ("llama3.2-1b", None),
          "deepseek": ("deepseek-v2-lite-16b", 8)}    # (arch, layers)


def requests(vocab):
    """chip_smoke.py's BATCH prompts (lengths 32–200 from the seed)."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(32, 201, BATCH)
    return [rng.integers(0, vocab, int(n)) for n in lens]


def prompts(vocab):
    """:func:`requests` left-padded with 0 into one batch."""
    reqs = requests(vocab)
    out = np.zeros((BATCH, max(len(r) for r in reqs)), np.int64)
    for i, r in enumerate(reqs):
        out[i, out.shape[1] - len(r):] = r
    return out


ABSORB, DECODE_INT8 = "absorb: materialize", "absorb: materialize_int8"


def mark_absorb():
    """Wrap ``PackedLinear.materialize`` and ``materialize_int8`` in
    ``record_function`` ranges (ABSORB, DECODE_INT8), so a window can sum
    the device time of the kernels their calls launch."""
    from repro_torch.core.compressed import PackedLinear
    for attr, label in (("materialize", ABSORB),
                        ("materialize_int8", DECODE_INT8)):
        def marked(self, *a, _f=getattr(PackedLinear, attr), _l=label, **kw):
            with torch.profiler.record_function(_l):
                return _f(self, *a, **kw)
        setattr(PackedLinear, attr, marked)


def window(model, name, fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    marks = (ABSORB, DECODE_INT8)
    # the device's own events only: an operator's row also carries the
    # time of the kernels it launched, and a range's device-side row spans
    # its kernels and the gaps between them
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in averages
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in marks]
    busy = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    # a range's device time: the kernels the operators inside its host-side
    # row launched (K4, launched through ctypes by no operator, is not
    # among them)
    ranged = {e.key: (e.device_time_total / 1e3, e.count) for e in averages
              if e.key in marks and e.device_type == DeviceType.CPU}
    span = sum(e.self_device_time_total / 1e3 for e in averages
               if e.key == ABSORB and e.device_type == DeviceType.CUDA)
    ops_ms, absorb_calls = ranged.get(ABSORB, (0.0, 0))
    int8_ms = ranged.get(DECODE_INT8, (0.0, 0))[0]
    k4_ms = sum(ms for k, ms, _ in rows if "dict_decode" in k)
    print(json.dumps({
        "model": model, "window": name, "wall_ms": wall * 1e3,
        "device_busy_ms": busy,
        "device_idle_share": 1 - busy / (wall * 1e3),
        "k2_ms": sum(ms for k, ms, _ in rows if "flash_attention" in k),
        "k4_ms": k4_ms,
        "k4_calls": sum(n for k, _, n in rows if "dict_decode" in k),
        # the absorb chain: K4, the untile of materialize_int8, then the
        # dequantize ops
        "absorb_calls": absorb_calls, "absorb_ms": k4_ms + ops_ms,
        "absorb_span_ms": span, "absorb_untile_ms": int8_ms,
        "absorb_dequantize_ms": ops_ms - int8_ms,
        "k5_ms": sum(ms for k, ms, _ in rows if "dequant_matmul" in k),
        "fused_decode_matmul_ms": sum(ms for k, ms, _ in rows
                                      if "fused_decode_matmul" in k),
        "splitk_epilogue_calls": sum(n for k, _, n in rows
                                     if "splitk_epilogue" in k),
        "top_kernels": [{"name": k[:80], "ms": ms, "calls": n}
                        for k, ms, n in rows[:12]]}), flush=True)


def profile_model(model, dev):
    from repro_torch.configs import get_config
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.models import lm as LM
    from repro_torch.serve import engine
    from repro_torch.serve.engine import (build_serve_params, make_serve_fns,
                                          sample_tokens)
    arch, layers = MODELS[model]
    cfg = get_config(arch).full
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = LM.init_lm(cfg, seed=SEED, device=dev)
    st = build_serve_params(params, CompressionPolicy(), device=dev)
    del params
    ids = torch.as_tensor(prompts(cfg.vocab_size), device=dev)
    t0 = ids.shape[1]
    prefill, decode_step = make_serve_fns(cfg, device=dev)
    state = {}

    def run_prefill():
        caches = LM.init_caches(cfg, BATCH, t0 + DECODE_STEPS + 2, device=dev)
        logits, state["caches"] = prefill(st.params, st.lut,
                                          {"tokens": ids}, caches)
        state["tok"] = sample_tokens(logits)[:, None]
        state["pos"] = t0

    def run_decode():
        for _ in range(DECODE_STEPS):
            logits, state["caches"] = decode_step(
                st.params, st.lut, state["tok"], state["caches"],
                state["pos"])
            state["tok"] = sample_tokens(logits)[:, None]
            state["pos"] += 1

    run_prefill()          # warm-up: kernel libraries load, caches fill
    run_decode()
    window(cfg.name, "prefill", run_prefill)
    window(cfg.name, f"decode x{DECODE_STEPS}", run_decode)
    if hasattr(engine, "decode_graph"):     # a port from before it: none
        graph = engine.decode_graph(st.params, cfg, st.lut, BATCH,
                                    t0 + DECODE_STEPS + 2, device=dev)
        # warm-up: an eager step, the capture, replays
        graph.run(st.params, st.lut, ids, DECODE_STEPS + 2)
        graph.prefill(st.params, st.lut, ids)
        window(cfg.name, f"graph decode x{DECODE_STEPS}",
               lambda: graph.decode(st.params, st.lut, DECODE_STEPS))


def short_name(fn: str) -> str:
    """``kernel<template args>`` from a mangled kernel name (its length-
    prefixed name ending in ``kernel``), else the name as it is."""
    for i in range(len(fn)):
        for j in range(i + 1, min(i + 4, len(fn))):
            if not fn[i:j].isdigit():
                break
            name = fn[j:j + int(fn[i:j])]
            rest = fn[j + len(name):]
            args = re.match(r"I(\w+?)EEv", rest)
            if name.endswith("kernel") and args:
                return f"{name}<{args.group(1)}>"
    return fn


def ptxas_kernels(report: str) -> list:
    """(kernel, registers, spill bytes, static shared memory bytes) for
    each entry function of a ``ptxas -v`` report, the template arguments
    shortened."""
    rows, fn, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = short_name(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append({"kernel": fn, "registers": int(m.group(1)),
                         "spill_bytes": spill,
                         "smem_bytes": int(smem.group(1)) if smem else 0})
    return rows


def print_ptxas(name: str) -> list:
    from repro_torch.kernels import _build
    rows = ptxas_kernels(_build.ptxas_report(name))
    for r in rows:
        print(f"ptxas {r['kernel']}: {r['registers']} registers, "
              f"{r['spill_bytes']} bytes spilled, {r['smem_bytes']} bytes "
              "static shared memory", flush=True)
    return rows


def k1_call(fdm, x, w, lut, e, fn=None):
    """K1 (e = 0: one weight's planes, x (M, K)) or K3 (a stack of e
    experts, x (E, M, K)) through ``fn``, a variant build's C entry, or
    the source's."""
    kw = dict(shape=w.shape, tile_n=w.tile_n, tile_k=w.tile_k,
              out_dtype=torch.bfloat16, fn=fn)
    if e == 0:
        return fdm._launch(fdm.NAME, x[None], w.codes.reshape(
            1, -1, w.codes.shape[-1]), w.literals.reshape(
            (1, -1) + tuple(w.literals.shape[-2:])), lut, w.scale, w.zero,
            **kw)[0]
    return fdm._launch(fdm.GROUPED_NAME, x, w.codes, w.literals, lut,
                       w.scale, w.zero, **kw)


def time_k1(dev, label, reps=20):
    from chip_smoke import Timer, bound_ms, nbytes, plane_bytes
    from repro_torch.configs import get_config
    from repro_torch.core.blocked_codec import build_lut
    from repro_torch.core.codec import find_frequent_sequences
    from repro_torch.core.compressed import (pack_expert_stack,
                                             pack_linear_tiled,
                                             quantize_linear)
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_decode_matmul as fdm
    from repro_torch.models import lm as LM
    from repro_torch.serve.engine import build_serve_params
    t0 = time.perf_counter()
    _build.build([fdm.NAME])
    build_s = time.perf_counter() - t0
    cfg = get_config("llama3.2-1b").full
    params = LM.init_lm(cfg, seed=SEED, device=dev)
    st = build_serve_params(params, CompressionPolicy(), device=dev)
    del params
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timer = Timer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plan_of(m, w, e):
        """The kernel the plan picks and its grid (a tree from before the
        decode kernel: the kernel and its K splits)."""
        slots = w.codes.shape[-1]
        if not hasattr(fdm, "launch_grid"):
            plan = fdm.launch_plan(m, *w.shape, w.tile_k, e, sms)
            return {"kernel": "mma" if plan.bm == fdm.MMA_BM else "simt",
                    "splits": plan.splits}
        plan = fdm.launch_plan(m, *w.shape, w.tile_k, e, sms, slots)
        return fdm.launch_grid(plan, m, w.shape[0], w.tile_k, slots, e)

    # (a tree from before the 16-row decode kernel has none of the lines)
    variants = {} if not hasattr(fdm, "DECODE_MAX_M") else {
        label: fn for label, (fn, _, _) in build_variants(
            _build, fdm.NAME, K1_VARIANTS,
            "qmoe_fused_decode_matmul").items()}
    for fn in variants.values():
        fn.argtypes = fdm._ARGTYPES

    def variant_rows(proj, m, x, w, lut, e, reps_, main_ms):
        """Each of K1_VARIANTS on the call (x, w) beside the source: its
        time walking the same weights and whether its bits are the
        source's."""
        out = {}
        for label, fn in variants.items():
            calls = [lambda wl=wl, fn=fn: k1_call(fdm, x, wl, lut, e, fn)
                     for wl in w]
            same = all(torch.equal(k1_call(fdm, x, wl, lut, e, fn),
                                   k1_call(fdm, x, wl, lut, e))
                       for wl in w[:2])
            out[label] = {"ms": timer.graph_ms(calls, reps=reps_),
                          "bitwise_to_source": same}
        row = {"proj": proj, "M": m, "source_ms": main_ms, "variants": out}
        print(json.dumps(row), flush=True)
        return row

    variant_out = []
    rows, layer_ms = [], {}
    for grp, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                      ("attn", "wo"), ("mlp", "w_gate"), ("mlp", "w_up"),
                      ("mlp", "w_down")):
        ws = [b[grp][name] for b in st.params["blocks"]]
        n, k = ws[0].shape
        wbs = [w.materialize(st.lut, torch.bfloat16) for w in ws]
        for m in K1_M:
            x = torch.randn((m, k), generator=gen, device=dev
                            ).to(torch.bfloat16)
            fns = [lambda w=w: fdm.fused_decode_matmul(
                x, w.codes, w.literals, st.lut, w.scale, w.zero,
                shape=w.shape, tile_n=w.tile_n, tile_k=w.tile_k)
                for w in ws]
            ms = timer.graph_ms(fns, reps=reps)
            lib = timer.graph_ms([lambda wb=wb: x @ wb.T for wb in wbs],
                                 reps=reps)
            b, by = bound_ms(nbytes(x) + plane_bytes(ws[0]) + m * n * 2,
                             2.0 * m * n * k)
            rows.append({"proj": name, "N": n, "K": k, "M": m, "ms": ms,
                         "bound_ms": b, "bound_by": by, "library_ms": lib,
                         **plan_of(m, ws[0], 1)})
            print(json.dumps(rows[-1]), flush=True)
            layer_ms[m] = layer_ms.get(m, 0.0) + ms
            if (name, m) in K1_VARIANT_AT:
                variant_out.append(variant_rows(name, m, x, ws, st.lut, 0,
                                                reps, ms))
        del wbs
    del st
    torch.cuda.empty_cache()
    # DeepSeek-V2-Lite: the first layer's down projection (tile_k 64; its
    # ~34 MB of planes fit the L2, so each call is timed cold) and one
    # expert stack of each shape (~280 MB of planes, past the L2)
    for proj, e, n, k, m_values in (
            ("first.w_down", 1, 2048, 10944, (BATCH, 700)),
            ("first.w_down G=2", 1, 2048, 10944, (700,)),
            ("experts.w_gate", 64, 1408, 2048, (4, 8, 16, 83)),
            ("experts.w_down", 64, 2048, 1408, (4, 8, 16, 83))):
        ws = [torch.randn((n, k), generator=gen, device=dev) * 0.02
              for _ in range(e)]
        if proj.endswith("G=2"):
            # the tiled state's first w_down: two column groups of 5472
            # columns, which the packer cuts into tiles 32 wide
            table = find_frequent_sequences([quantize_linear(ws[0]).values])
            pl = pack_linear_tiled(ws[0], table, 2, tile="auto")
            lut = build_lut(table, device=dev)
            planes = (pl.codes, pl.literals)
        else:
            pl, lut = pack_expert_stack(ws)
            planes = (pl.codes[0], pl.literals[0])
        del ws
        kw = dict(shape=pl.shape, tile_n=pl.tile_n, tile_k=pl.tile_k)
        wb = pl.materialize(lut, torch.bfloat16)
        if e == 1:
            wb = wb.reshape(1, n, k)
        for m in m_values:
            if e == 1:
                args = (*planes, lut, pl.scale.reshape(-1, 1),
                        pl.zero.reshape(-1, 1))
                x = torch.randn((m, k), generator=gen, device=dev
                                ).to(torch.bfloat16)
                ms = timer.graph_ms([lambda: fdm.fused_decode_matmul(
                    x, *args, **kw)], reps=reps, cold=True)
                lib = timer.graph_ms([lambda: x @ wb[0].T], reps=reps,
                                     cold=True)
            else:
                args = (pl.codes, pl.literals, lut, pl.scale, pl.zero)
                x = torch.randn((e, m, k), generator=gen, device=dev
                                ).to(torch.bfloat16)
                ms = timer.graph_ms([lambda: fdm.grouped_fused_decode_matmul(
                    x, *args, **kw)] * 4, reps=reps)
                wbt = wb.transpose(1, 2)
                lib = timer.graph_ms([lambda: torch.bmm(x, wbt)] * 4,
                                     reps=reps)
                if (proj, m) in K1_VARIANT_AT:
                    variant_out.append(variant_rows(proj, m, x, [pl] * 4,
                                                    lut, e, reps, ms))
            b, by = bound_ms(nbytes(x, lut) + plane_bytes(pl) + e * m * n * 2,
                             2.0 * e * m * n * k)
            rows.append({"proj": proj, "E": e, "N": n, "K": k, "M": m,
                         "tile": [pl.tile_n, pl.tile_k], "ms": ms,
                         "bound_ms": b, "bound_by": by, "library_ms": lib,
                         **plan_of(m, pl, e)})
            print(json.dumps(rows[-1]), flush=True)
        del pl, args, wb
        torch.cuda.empty_cache()
    ptxas = print_ptxas(fdm.NAME)
    print(json.dumps({"k1": label, "build_s": build_s,
                      "layer_ms": layer_ms, "rows": rows,
                      "variants": variant_out,
                      "ptxas": ptxas}), flush=True)


K2_SHAPES = (("llama", 32, 8, 64, 64), ("mla", 16, 16, 192, 128))
# The f32 kernel's design choices at the training shapes: variants of
# csrc/flash_attention.cu with one line replaced, each checked against the
# plain version (1e-4) and timed beside the source.
K2_F32_VARIANTS = {
    "MLA 64-key tiles": {"constexpr int kMlaKeys = 32;":
                         "constexpr int kMlaKeys = 64;"},
    "D 64 at 3 blocks an SM": {"constexpr int kMinBlocks64 = 2;":
                               "constexpr int kMinBlocks64 = 3;"},
    "cvt.rna instruction": {
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;":
        "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) "
        ": \"f\"(x));\n  return r;"},
    "hi and lo truncated": {
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;":
        "  return __float_as_uint(x) & 0xffffe000u;"},
}


def time_k2(dev, label):
    """K2 at both paths' prefill shapes through chip_smoke.check_flash, and
    its f32 kernel at both training shapes through
    chip_smoke.check_flash_train (one definition of its error, timing and
    bound), then K2_F32_VARIANTS at the training shapes (a tree with the
    three-term TF32 kernel)."""
    from chip_smoke import Timer, check_flash, check_flash_train
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    _build.build(["flash_attention"])
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timer = Timer(dev)
    rt = {"fa": fa, "_build": _build}
    rows, train_rows, variants = [], [], []
    for what, hq, hkv, d, dv in K2_SHAPES:
        _, shape_rows = check_flash(rt, dev, 175, gen, timer, hq, hkv, d, dv,
                                    what)
        for row in shape_rows:
            rows.append({"shape": what, "B": BATCH, "Hq": hq, "Hkv": hkv,
                         **row})
            print(json.dumps(rows[-1]), flush=True)
    for what, hq, hkv, d, dv in K2_SHAPES:
        _build.KERNEL_COUNTS.clear()
        row = check_flash_train(rt, dev, gen, timer, hq, hkv, d, dv,
                                f"{what} training")
        train_rows.append({**row, "kernel_launches": dict(
            _build.KERNEL_COUNTS)})
        print(json.dumps(train_rows[-1]), flush=True)
    if "kMlaKeys" in (_build.CSRC / "flash_attention.cu").read_text():
        symbol = "qmoe_flash_attention_tf32x3"
        built = build_variants(_build, "flash_attention", K2_F32_VARIANTS,
                               symbol)
        source = _build.function("flash_attention", symbol, fa._ARGTYPES)
        for name, (fn, ptxas, _) in built.items():
            fn.argtypes = fa._ARGTYPES
            out = {"variant": name, "ptxas": [
                r for r in ptxas if "tf32x3" in r["kernel"]]}
            for (what, hq, hkv, d, dv), src_row in zip(K2_SHAPES,
                                                         train_rows):
                _build._FUNCS[("flash_attention", symbol)] = fn
                try:
                    row = check_flash_train(rt, dev, gen, timer, hq, hkv, d,
                                            dv, f"{what} training")
                except AssertionError as e:     # outside the tolerance
                    row = {"ms": None, "max_abs_err": str(e)}
                finally:
                    _build._FUNCS[("flash_attention", symbol)] = source
                out[what] = {"ms": row["ms"], "source_ms": src_row["ms"],
                             "max_abs_err": row["max_abs_err"]}
            variants.append(out)
            print(json.dumps(out), flush=True)
    ptxas = print_ptxas("flash_attention")
    print(json.dumps({"k2": label, "build_s": build_s, "rows": rows,
                      "train_rows": train_rows, "variants": variants,
                      "ptxas": ptxas}), flush=True)


K5_HEADS = (("llama3.2-1b", 128256, 2048),
            ("deepseek-v2-lite-16b", 102400, 2048))
# Llama-3.2-1B's distinct projection shapes in quant mode (q/o, k/v,
# gate/up, down) and its head, timed at prefill M (the fixed batch's
# 4 × 175, one admission's 175) and, on gate/up and the head, at the M
# around the cut between the SIMT and the tensor-core kernel.  The
# tensor-core kernel's design choice against the source as built (two
# blocks an SM, at most 128 registers a thread): launch bounds of one
# block an SM (no cap on registers).
K5_SHAPES = (("q/o", 2048, 2048), ("k/v", 512, 2048),
             ("gate/up", 8192, 2048), ("down", 2048, 8192),
             ("llama3.2-1b head", 128256, 2048))
K5_PREFILL_M = (700, 175)
K5_CUT_M = (5, 8, 16)
K5_CUT_SHAPES = ("gate/up", "llama3.2-1b head")
K5_MMA_VARIANTS = {
    "1 block an SM": {"constexpr int kMmaBlocksPerSM = 2;":
                      "constexpr int kMmaBlocksPerSM = 1;"},
}
# The decode kernel's design choices, each timed against the source as
# built: a variant is the source with its own constants (or a line of it)
# replaced.  PACK_HI packs the high halves of two exact f32 by one PRMT.
K5_VARIANTS = {
    "as built": {},
    "16 rows a warp": {"constexpr int kTiles = 1;":
                       "constexpr int kTiles = 2;"},
    "4 warps a block": {"constexpr int kDecWarps = 8;":
                        "constexpr int kDecWarps = 4;"},
    "4 loads a stage": {"constexpr int kLoads = 8;":
                        "constexpr int kLoads = 4;"},
    "no L2 prefetch": {"L2::256B.": ""},
    "bf16 pack by PRMT": {
        '#include "mma_sm80.cuh"':
            '#include "mma_sm80.cuh"\n#define PACK_HI(a, b) __byte_perm('
            '__float_as_uint(a), __float_as_uint(b), 0x7632)',
        "qmoe::bf16x2_of(": "PACK_HI("},
}


def build_variants(_build, name, variants, symbol):
    """One library per ``variants`` entry ({label: {old: new}}), the
    source ``csrc/<name>.cu`` with each ``old`` replaced, built into the
    build directory, all nvcc at once → {label: (C entry ``symbol``,
    ptxas rows, the substituted source)}."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    out = _build.BUILD_DIR / f"{name}_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, subs in variants.items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"{name} variant {label!r}: {old!r} is "
                                   "not in the source")
            text = text.replace(old, new)
        stem = out / re.sub(r"\W+", "_", label)
        stem.with_suffix(".cu").write_text(text)
        procs[label] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-I", str(_build.CSRC), "-o", str(stem.with_suffix(".so")),
             str(stem.with_suffix(".cu"))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), stem, text)
    libs = {}
    for label, (proc, stem, text) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} variant {label!r}:\n"
                               + report)
        fn = getattr(ctypes.CDLL(str(stem.with_suffix(".so"))), symbol)
        fn.restype = ctypes.c_int
        libs[label] = (fn, ptxas_kernels(report), text)
    return libs


def build_k5_variants(_build):
    """K5_VARIANTS built → {name: (C entry, ptxas rows of its decode
    kernels, warps a block, rows a task)}."""
    libs = {}
    for name, (fn, ptxas, text) in build_variants(
            _build, "dequant_matmul", K5_VARIANTS,
            "qmoe_dequant_matmul_decode").items():
        const = {c: int(re.search(rf"constexpr int {c} = (\d+);",
                                  text).group(1))
                 for c in ("kDecWarps", "kTiles")}
        libs[name] = (fn, [r for r in ptxas if "decode" in r["kernel"]],
                      const["kDecWarps"], 8 * const["kTiles"])
    return libs


def time_k5_variants(dqm, libs, head, dev, gen, timer, sms):
    """Each variant at M = 4 on ``head``: bitwise on integer x against
    the plain version, its time with the CUDA-graph replays of
    check_dequant; the source as built also on two other grids."""
    from chip_smoke import BATCH, int_x, rand_x
    from repro_torch.kernels import _build
    n, k = head.values.shape
    args = (head.values, head.scale, head.zero)
    xi, xr = int_x(BATCH, k, gen, dev), rand_x(BATCH, k, gen, dev)
    want = dqm.dequant_matmul_plain(xi, *args, torch.bfloat16)
    rows = []
    for name, (fn, ptxas, warps, rows_a_task) in libs.items():
        fn.argtypes = dqm._DECODE_ARGTYPES
        tasks = -(-n // rows_a_task)
        per_sm = dqm.DECODE_BLOCKS_PER_SM * dqm.DECODE_WARPS  # as planned
        rounds = -(-tasks // (sms * per_sm))
        grids = {"plan: balanced persistent": -(-tasks // (rounds * warps))}
        if name == "as built":
            grids["persistent, 2 blocks an SM"] = min(
                -(-tasks // warps), sms * per_sm // warps)
            grids["one task a warp"] = -(-tasks // warps)
        for grid, blocks in grids.items():
            def call(x, fn=fn, blocks=blocks, name=name):
                y = torch.empty((BATCH, n), dtype=torch.bfloat16, device=dev)
                _build.check(fn(x.data_ptr(), *(t.data_ptr() for t in args),
                                y.data_ptr(), 1, BATCH, n, k, blocks,
                                dev.index,
                                torch.cuda.current_stream(dev).cuda_stream),
                             f"K5 variant {name!r}")
                return y
            rows.append({"variant": name, "grid": grid, "blocks": blocks,
                         "N": n, "K": k, "M": BATCH,
                         "bitwise": bool(torch.equal(call(xi), want)),
                         "ms": timer.graph_ms([lambda: call(xr)] * 4),
                         "ptxas": ptxas})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def time_k5_prefill(dqm, dev, gen, timer, mma_libs):
    """K5 at prefill M on Llama-3.2-1B's projection shapes and its head
    (K5_SHAPES) through chip_smoke.check_k5, with the SIMT kernel's time
    at the same shape and inputs (a tree with ``simt_plan``), at the cut's
    M (K5_CUT_M) on gate/up and the head too (there also the tensor-core
    kernel's time, on a tree where the decode kernel's row groups take
    those M), and the tensor-core kernel's design variants (``mma_libs``)
    at the prefill M."""
    from chip_smoke import check_k5, int_x, rand_x, weight_graph_ms
    from repro_torch.core.compressed import quantize_linear
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, n, k in K5_SHAPES:
        q = quantize_linear(torch.randn((n, k), generator=gen, device=dev))
        args = (q.values, q.scale, q.zero)
        wb = q.materialize(torch.bfloat16)
        for m in K5_PREFILL_M + (K5_CUT_M if name in K5_CUT_SHAPES
                                 else ()):
            row = {"shape": name, "N": n, "K": k, "M": m,
                   **check_k5({"dqm": dqm}, *args, wb, m, gen, timer,
                              plain=m in K5_PREFILL_M)}
            xi, xr = int_x(m, k, gen, dev), rand_x(m, k, gen, dev)
            want = dqm.dequant_matmul_plain(xi, *args, torch.bfloat16)
            out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            plans = {}
            if hasattr(dqm, "simt_plan"):
                plans["simt"] = (dqm.simt_plan(m, n, k, sms), None)
            if hasattr(dqm, "mma_plan") and m in K5_CUT_M:
                # the tensor-core kernel where the decode kernel's row
                # groups now serve (MMA_MIN_M 17): the price of the cut
                plans["mma"] = (dqm.mma_plan(m, n, k, sms), None)
            if m in K5_PREFILL_M and mma_libs:
                plans.update({label: (dqm.dequant_plan(m, n, k, sms), fn)
                              for label, (fn, _) in mma_libs.items()})
                # K split for both of an SM's block slots, not one
                plans["split for two blocks an SM"] = (dqm.dequant_plan(
                    m, n, k, sms * dqm.MMA_BLOCKS_PER_SM), None)
            for label, (plan, fn) in plans.items():
                def call(x, plan=plan, fn=fn):
                    dqm._launch(plan, x, *args, out, fn=fn)
                    return out
                row[label] = {
                    "bitwise": bool(torch.equal(call(xi), want)),
                    "ms": weight_graph_ms(timer, q.values,
                                          lambda c=call: c(xr))}
            rows.append(row)
            print(json.dumps(rows[-1]), flush=True)
        del q, args, wb
        torch.cuda.empty_cache()
    return rows


def time_k5(dev, label):
    """K5 at both paths' LM heads through chip_smoke.check_dequant: one
    definition of its error, timing and bound; then, on a tree with the
    decode kernel, its design variants (K5_VARIANTS) on the same heads;
    then the prefill rows (time_k5_prefill), on a tree with the
    tensor-core kernel with its design variants (K5_MMA_VARIANTS)."""
    from chip_smoke import Timer, check_dequant
    from repro_torch.core.compressed import quantize_linear
    from repro_torch.kernels import _build
    from repro_torch.kernels import dequant_matmul as dqm
    t0 = time.perf_counter()
    _build.build([dqm.NAME])
    variants = (build_k5_variants(_build)
                if hasattr(dqm, "dequant_plan") else {})
    mma_libs = {}
    if hasattr(dqm, "MMA_MIN_M"):
        for name, (fn, ptxas, _) in build_variants(
                _build, dqm.NAME, K5_MMA_VARIANTS,
                "qmoe_dequant_matmul_mma").items():
            fn.argtypes = dqm._MMA_ARGTYPES
            mma_libs[name] = (fn, [r for r in ptxas if "mma" in r["kernel"]])
    build_s = time.perf_counter() - t0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timer = Timer(dev)
    rows, design = [], []
    for arch, n, k in K5_HEADS:
        head = quantize_linear(torch.randn((n, k), generator=gen,
                                           device=dev))
        rows.append({"head": arch, **check_dequant({"dqm": dqm}, head, gen,
                                                   timer)})
        print(json.dumps(rows[-1]), flush=True)
        design += [{"head": arch, **r} for r in time_k5_variants(
            dqm, variants, head, dev, gen, timer, sms)]
        del head
        torch.cuda.empty_cache()
    prefill = time_k5_prefill(dqm, dev, gen, timer, mma_libs)
    ptxas = print_ptxas(dqm.NAME)
    print(json.dumps({"k5": label, "build_s": build_s, "rows": rows,
                      "variants": design, "prefill": prefill,
                      "mma_variants_ptxas": {k: v[1] for k, v in
                                             mma_libs.items()},
                      "ptxas": ptxas}), flush=True)


K4_SHAPE = (4096, 512)     # DeepSeek-V2-Lite's MLA wkv_b
# The kernel's design choices, each timed against the source as built: a
# variant is the source with its own constants replaced.
K4_VARIANTS = {
    "as built": {},
    "8 slots a lane, 4 warps": {
        "constexpr int kLaneSlots = 4;": "constexpr int kLaneSlots = 8;",
        "constexpr int kMaxWarps = 8;": "constexpr int kMaxWarps = 4;"},
    "16 slots a lane, 2 warps": {
        "constexpr int kLaneSlots = 4;": "constexpr int kLaneSlots = 16;",
        "constexpr int kMaxWarps = 8;": "constexpr int kMaxWarps = 2;"},
    "2 slots a lane, 16 warps": {
        "constexpr int kLaneSlots = 4;": "constexpr int kLaneSlots = 2;",
        "constexpr int kMaxWarps = 8;": "constexpr int kMaxWarps = 16;"},
}


def k4_planes(dev, gen):
    """The two planes of K4_SHAPE (see --model k4) and their LUTs."""
    from types import SimpleNamespace
    from repro_torch.core.blocked_codec import (TableIndex, build_lut,
                                                encode_blocked)
    from repro_torch.core.codec import find_frequent_sequences
    from repro_torch.core.compressed import pack_expert_stack
    w = torch.randn(K4_SHAPE, generator=gen, device=dev)
    pl, lut = pack_expert_stack([w])
    random = SimpleNamespace(codes=pl.codes[0], literals=pl.literals[0],
                             nlit=pl.nlit[0], shape=K4_SHAPE)
    n = K4_SHAPE[0] * K4_SHAPE[1]
    q = torch.randint(0, 256, (n,), generator=gen, device=dev
                      ).to(torch.uint8)
    q[: n // 2] %= 4                    # 256 grams, all in the table
    table = find_frequent_sequences([q[: n // 2]], max_codes=256)
    bc = encode_blocked(q, TableIndex(table, device=dev))
    half = SimpleNamespace(codes=bc.codes, literals=bc.literals,
                           nlit=bc.nlit, shape=K4_SHAPE)
    return {"wkv_b random": (random, lut),
            "half dictionary": (half, build_lut(table, device=dev))}


def time_k4_variants(ddc, libs, plane, lut, dev, timer):
    """Each variant on one plane, launched at the shape launch_shape gives
    its constants: bitwise against the plain version, its time under
    check_dict_decode's timer."""
    from repro_torch.kernels import _build
    codes, lits = plane.codes, plane.literals
    nb, slots = codes.shape
    want = ddc.dict_decode_plain(codes, lits, lut)
    rows = []
    for name, (fn, ptxas, text) in libs.items():
        fn.argtypes = ddc._ARGTYPES
        const = {c: int(re.search(rf"constexpr int {c} = (\d+);",
                                  text).group(1))
                 for c in ("kLaneSlots", "kMaxWarps")}
        _, threads = ddc.launch_shape(nb, slots, const["kLaneSlots"],
                                      const["kMaxWarps"])

        def call(fn=fn, threads=threads, name=name):
            out = torch.empty((nb, slots * 4), dtype=torch.uint8, device=dev)
            _build.check(fn(codes.data_ptr(), lits.data_ptr(),
                            lut.data_ptr(), out.data_ptr(), nb, slots,
                            lits.shape[1], threads, dev.index,
                            torch.cuda.current_stream(dev).cuda_stream),
                         f"K4 variant {name!r}")
            return out
        rows.append({"variant": name,
                     "grid": f"{nb} blocks of {threads} threads",
                     "bitwise": bool(torch.equal(call(), want)),
                     "ms": timer.graph_ms([call], reps=20, cold=True),
                     "ptxas": ptxas})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def time_k4(dev, label):
    """K4 on k4_planes through chip_smoke.check_dict_decode: one definition
    of its check, timing, floors and bound; then, on a tree with the
    redesigned kernel, its design variants (K4_VARIANTS) on the same
    planes."""
    from chip_smoke import Timer, check_dict_decode
    from repro_torch.kernels import _build
    from repro_torch.kernels import dict_decode as ddc
    t0 = time.perf_counter()
    _build.build([ddc.NAME])
    variants = (build_variants(_build, ddc.NAME, K4_VARIANTS,
                               "qmoe_dict_decode")
                if hasattr(ddc, "launch_shape") else {})
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timer = Timer(dev)
    rows, design = [], []
    for plane_name, (plane, lut) in k4_planes(dev, gen).items():
        summary, _ = check_dict_decode({"ddc": ddc}, plane, lut, timer)
        rows.append({"plane": plane_name, **summary})
        print(json.dumps(rows[-1]), flush=True)
        design += [{"plane": plane_name, **r} for r in time_k4_variants(
            ddc, variants, plane, lut, dev, timer)]
    ptxas = print_ptxas(ddc.NAME)
    print(json.dumps({"k4": label, "build_s": build_s, "rows": rows,
                      "variants": design, "ptxas": ptxas}), flush=True)


def profile_engine(dev):
    from repro_torch.configs import get_config
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.models import lm as LM
    from repro_torch.serve.context import ServeContext
    from repro_torch.serve.engine import build_serve_params
    from repro_torch.serve.scheduler import Engine, Request
    cfg = get_config("llama3.2-1b").full
    params = LM.init_lm(cfg, seed=SEED, device=dev)
    st = build_serve_params(params, CompressionPolicy(), device=dev)
    del params
    eng = Engine(ServeContext(cfg, lut=st.lut), st.params, n_slots=BATCH,
                 max_len=232, page_size=8)
    reqs = requests(cfg.vocab_size)
    for i, r in enumerate(reqs):
        eng.submit(Request(tokens=r, max_new=2 * DECODE_STEPS + 4, rid=i))
    eng.step()            # 4 admissions, an eager tick and the capture
    eng.step()            # a replayed tick
    window(cfg.name, f"engine tick x{DECODE_STEPS}",
           lambda: [eng.step() for _ in range(DECODE_STEPS)])
    eng.drain()
    eng.submit(Request(tokens=reqs[0], max_new=2, rid=BATCH))
    window(cfg.name, "engine admission + tick", eng.step)
    eng.drain()


ROWS_BATCHES = (4, 8, 16)


def time_rows(dev, label):
    """``--model rows`` (the module's docstring)."""
    from chip_smoke import MAX_NEW, make_prompts
    from repro_torch.configs import get_config
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.kernels import _build
    from repro_torch.models import lm as LM
    from repro_torch.serve import engine as E
    from repro_torch.serve.engine import build_serve_params
    cfg = get_config("llama3.2-1b").full
    params = LM.init_lm(cfg, seed=SEED, device=dev)
    st = build_serve_params(params, CompressionPolicy(), device=dev)
    del params
    torch.cuda.empty_cache()
    rows = []
    for b in ROWS_BATCHES:
        batch, _ = make_prompts(cfg.vocab_size, b)
        ids = torch.as_tensor(batch, device=dev)
        t_prefill = ids.shape[1]
        graph = E.decode_graph(st.params, cfg, st.lut, b,
                               t_prefill + MAX_NEW, device=dev)
        graph.prefill(st.params, st.lut, ids)
        graph.decode(st.params, st.lut, MAX_NEW - 1)     # captures
        pre, dec = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph.prefill(st.params, st.lut, ids)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            graph.decode(st.params, st.lut, MAX_NEW - 1)
            torch.cuda.synchronize()
            pre.append((t1 - t0) * 1e3)
            dec.append((time.perf_counter() - t1) * 1e3 / (MAX_NEW - 1))
        graph.prefill(st.params, st.lut, ids)
        _build.LAUNCH_COUNTS.clear()
        _build.KERNEL_COUNTS.clear()
        graph.decode(st.params, st.lut, 1)              # one replay
        torch.cuda.synchronize()
        rows.append({"batch": b, "prompt_len": t_prefill,
                     "prefill_ms": sorted(pre)[1],
                     "decode_ms_per_step": sorted(dec)[1],
                     "decode_ms_runs": dec, "capture_ms": graph.capture_ms,
                     "step_launches": dict(_build.LAUNCH_COUNTS),
                     "step_kernel_launches": dict(_build.KERNEL_COUNTS)})
        print(json.dumps(rows[-1]), flush=True)
        del graph
        E.drop_graphs(cfg)
        torch.cuda.empty_cache()
    print(json.dumps({"rows": label, "rows_by_batch": rows}), flush=True)


TRAIN_MARKS = {"forward": "train: forward",
               "k2_forward": "train: K2 forward",
               "k2_backward": "train: K2 backward (plain)",
               "adamw": "train: AdamW"}


def mark_train():
    """``record_function`` ranges (TRAIN_MARKS) around the train step's
    loss (the forward), K2's autograd.Function forward and backward, and
    AdamW's update.  The backward runs on autograd's device thread, so it
    is the step's busy time less the forward's and AdamW's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import steps as S

    def ranged(f, label):
        def run(*a, **kw):
            with torch.profiler.record_function(label):
                return f(*a, **kw)
        return run

    S._loss_fn = ranged(S._loss_fn, TRAIN_MARKS["forward"])
    S.adamw_update = ranged(S.adamw_update, TRAIN_MARKS["adamw"])
    fn = fa.FlashAttentionFn
    fn.forward = staticmethod(ranged(fn.forward, TRAIN_MARKS["k2_forward"]))
    fn.backward = staticmethod(ranged(fn.backward,
                                      TRAIN_MARKS["k2_backward"]))


def profile_train(dev):
    """``--model train``: one eager Llama-3.2-1B f32 train step (4 × 256
    tokens, full width, 16 layers, chip_smoke.py's train settings) under
    the profiler, after two warm-up steps and three timed ones: busy time
    by kernel and by range (forward, K2's forward, the backward, K2's plain
    backward within it, the rest of the backward, AdamW), and the idle
    share of the step's wall time."""
    from chip_smoke import (TRAIN_BATCH, TRAIN_DATA_VOCAB, TRAIN_SEQ,
                            TRAIN_STEPS)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import lm as LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as S
    from repro_torch.train.data import DataConfig, DataPipeline
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3.2-1b").full
    tcfg = S.TrainConfig(optimizer=opt.AdamWConfig(
        lr=5e-3, warmup_steps=max(TRAIN_STEPS // 10, 1),
        total_steps=TRAIN_STEPS))
    data = DataPipeline(DataConfig(vocab_size=TRAIN_DATA_VOCAB,
                                   batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    state = S.init_train_state(LM.init_lm(cfg, seed=SEED, device=dev), tcfg)
    step = S.make_train_step(cfg, tcfg)
    mark_train()
    ms = []
    for i in range(5):           # 2 warm-up steps, then 3 timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, data.batch_at(i))
        float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    _build.KERNEL_COUNTS.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, data.batch_at(5))
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    marks = set(TRAIN_MARKS.values())
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in averages
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in marks]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    ranged = {name: sum(e.device_time_total / 1e3 for e in averages
                        if e.key == label and e.device_type == DeviceType.CPU)
              for name, label in TRAIN_MARKS.items()}
    # K2's kernel is launched through ctypes, by no operator, so no range
    # holds it: every launch is in the forward
    k2_ms = sum(ms_ for k, ms_, _ in rows if "flash_attention" in k)
    ranged["forward"] += k2_ms
    ranged["k2_forward"] += k2_ms
    backward = busy - ranged["forward"] - ranged["adamw"]
    print(json.dumps({
        "model": cfg.name, "window": "train step", "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "step_ms_unprofiled": ms[2:],
        "wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": 1 - busy / wall,
        "forward_ms": ranged["forward"],
        "k2_forward_ms": ranged["k2_forward"],
        "backward_ms": backward, "k2_backward_ms": ranged["k2_backward"],
        "backward_rest_ms": backward - ranged["k2_backward"],
        "adamw_ms": ranged["adamw"],
        "k2_kernel_ms": k2_ms,
        "kernel_launches": dict(_build.KERNEL_COUNTS),
        "top_kernels": [{"name": k[:80], "ms": ms_, "calls": n}
                        for k, ms_, n in rows[:15]]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model",
                    choices=["llama", "deepseek", "both", "engine", "rows",
                             "k1", "k2", "k4", "k5", "train"],
                    default="both")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory to import repro_torch from")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import nvidia_smi_line
    print(f"card: {nvidia_smi_line()}", flush=True)
    dev = torch.device("cuda", 0)
    kernel_alone = {"k1": time_k1, "k2": time_k2, "k4": time_k4,
                    "k5": time_k5, "rows": time_rows}
    if args.model == "train":
        profile_train(dev)
        return 0
    if args.model in kernel_alone:
        kernel_alone[args.model](dev, args.src)
        return 0
    mark_absorb()
    if args.model == "engine":
        profile_engine(dev)
        return 0
    for model in (("llama", "deepseek") if args.model == "both"
                  else (args.model,)):
        profile_model(model, dev)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
