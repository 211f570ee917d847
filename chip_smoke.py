"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc.  Imports nothing of JAX or of the JAX package.
Two main paths — Llama-3.2-1B (dense) and DeepSeek-V2-Lite (MLA + MoE) —
each in the phases below, then the other decoder-only families, the
encoder–decoder, the examples, serving on a mesh of ranks, training, and
training on a mesh; the script exits non-zero if any phase fails:

  1. Device: the card's name and power limit (nvidia-smi), and the build of
     every kernel from ``src/repro_torch/kernels/csrc`` (one nvcc per
     source, all started together, into ``src/repro_torch/kernels/build``).
  2. Pack: the model at full width, weights drawn from a seed on the card,
     packed by ``build_serve_params(mode='compressed')`` with the default
     policy.  Llama-3.2-1B with all 16 layers; DeepSeek-V2-Lite with 8 of
     its 27 layers (the dense first layer + 7 MoE layers: the f32 weights
     drawn for packing would not fit the card at full depth).
  3. Kernels against their plain PyTorch versions at the path's shapes, on
     the packed planes — every kernel the path launches, at every weight
     shape it gives it, and (Llama's K1 phase) K1 and K3 on weights the
     packer tiles 1, 2, 4 and 8 weights wide: bitwise on integer-valued bf16 x
     (and for the dictionary decode, on every input), within a stated
     tolerance on random x; times (CUDA-graph replays with the weights past
     the L2, or the L2 flushed in the graph, or CUDA events around single
     calls), bounds, the plain version's time and one PyTorch library
     call's time as a yardstick where one exists.
  4. End to end: 4 left-padded requests (prompt lengths 32–200 from the
     seed), 32 new tokens each, greedy: first the eager decode loop
     (``make_serve_fns``' ``decode_step`` dispatched from Python), then
     ``generate`` twice (its decode phase replays one captured CUDA graph
     of a step: the first call captures it, the second only replays).
     Each of the three runs' launch counts, read right after it, must be
     what the path's code launches, no expert plane may be materialized,
     the first ``generate`` must capture once and the second not at all,
     and both must give the eager loop's tokens bit for bit.  Decode ms a
     step and tokens/s of the graph (its replays alone) and of the eager
     loop, the capture's ms, each run's peak memory and the size of the
     graph's memory pool are printed.
     On the Llama path, then the engine phase (``engine_phase``): 8
     greedy requests (prompt lengths 32–200 and budgets 8–32 from the
     seed) arriving at cumulative Poisson(1.5) ticks, drained through the
     continuous-batching ``serve.scheduler.Engine`` (4 slots × 232 tokens,
     pages of 8, its tick one captured CUDA graph): every completion
     bitwise equal to ``generate`` of its prompt alone at the pool's
     length, one capture, the drain's launches, every page freed; ticks,
     tokens/s, the median tick and admission prefill, the capture, the
     pool's bytes and peak memory are printed.
     Then the rows phase (``rows_phase``): 5–32 rows, where K1's decode
     kernel runs four row groups (above 16 rows, a launch a group of 16)
     and K5's decode kernel one launch a group of 4 rows — ``generate`` at
     batch 8, 16 and 32 with the gates above, the engine phase's requests
     through the engine at 8, 16 and 32 slots (each completion bitwise
     ``generate`` alone), kernel rows at M = 5, 8, 16, 32 (decode rows)
     for K1 (the 7 projections) and K5 (the head), and on the DeepSeek
     path K3's stacks at capacities 5, 8, 16: each row bitwise on integer
     x and each row of the output bitwise that row alone.  K1/K3's SIMT
     kernel, which only tiles 1 or 2 weights wide reach, must launch in no
     phase but the kernel checks (``SimtWatch``).
  5. Card against CPU: the same seeded model at 2 layers, packed once; the
     prefill logits of the card and of the CPU (plain versions) must agree
     within a stated tolerance; greedy tokens are compared.  For the MoE,
     also under the card's routing, and with K2's f32 kernel beside its
     bf16 kernel; the tokens each request routes and keeps
     differently are reported.
  6. Resilience (``resilience_phase`` on Llama after the engine phase;
     ``moe_rungs`` on DeepSeek-V2-Lite at 2 layers): the manifest,
     ``verify_serve_state`` and ``check_invariants`` timed, a flipped code
     bit named and refused; ``ResilientEngine.generate`` on each rung of
     the ladder with its launch counts and its tokens against the fused
     rung's; each rung's prefill and decode step timed; a scheduler drain
     with a poisoned slot; a request preempted after RESUME_AFTER tokens
     and resumed, bitwise equal to ``generate``; K4 and K5 at the unfused
     rung's shapes against their plain versions.  Every other phase must
     end with the dispatch lever unset and no fallback counted.
  7. Families (``families_phase``, after both paths): the decoder-only
     families beside them, compressed, at full width, weights from the
     seed (FAMILY_MODELS): Zamba2-1.2B (hybrid: 38 Mamba2 blocks, the
     shared attention block after every 6th; K1, K2 at MHA D 64, K5) and
     Mamba2-2.7B (64 blocks; also one 320-token prompt, two SSD chunks) at
     full depth, Qwen3-4B (qk-norm, the int8 KV cache; also the engine at
     4 slots) at 8 of 36 layers, Qwen2-7B (QKV bias) at 4 of 28, and
     InternVL2-2B at 4 of 24 with 256 patch embeddings before each prompt.
     Each through ``serve``'s gates (launches as ``family_want`` computes
     them from the config, graphed tokens bitwise the eager loop's),
     nothing materialized; every kernel call of a prefill and a decode
     step against its plain version on the same inputs, and the prefill
     logits against the same path with every kernel swapped for its
     plain version (``against_plain``); kernel rows for K1 on Mamba2's in/out projections
     (tile_n 16) and K5 on each model's head (N = 32 000, 50 280,
     151 936, 152 064, 92 553) at decode and prefill M; a ``family`` line
     per model.
  8. Encoder–decoder (``encdec_phase``, after the families):
     seamless-m4t-medium at full width and depth (12 + 12 layers),
     compressed, weights from the seed; 4 requests of ENCDEC_FRAMES bf16
     audio frames (``frontends.audio_frame_embeddings``), prompts
     left-padded to 16 tokens, 32 new: the eager loop, then
     ``decode_graph(...).run`` twice (capture, replays), then a second
     batch through the same graph, then the first in quant mode; launches
     as ``encdec_want`` computes them, graphed tokens bitwise the eager
     loop's, nothing materialized, each decode row bitwise itself alone
     at 4 and 16 rows, every K1/K5/K2 call of a prefill and a step
     within 1 (K2: 2) bf16 ulps of its plain version; kernel rows for K2
     at the encoder's shape and at Tq = 1 (no mask), K5 on the 256 206-row
     head, K1 on the encoder's ``w_gate``; an ``encdec`` line.
  9. Examples (``examples_phase``, after the encoder–decoder):
     ``examples/torch_quickstart.py`` on the card (its own gates: every
     compressed weight decodes to the quant state's int8 values byte for
     byte, the two modes' tokens apart only at an exact tie) and
     ``examples/torch_serve_batched.py`` in each mode (prefill ms, eager
     and graphed tokens/s); an ``examples`` line.
 10. Mesh (``mesh_phase``): MESH_RANKS ranks on the one card over gloo
     (``launch.mesh.spawn``; the packed planes reach them through CUDA
     IPC, each rank keeps its share of the planes, of the vocab rows and
     of the caches): Llama-3.2-1B at full width and depth on MESH_LLAMA
     through ``generate`` (its kv heads on the model ranks: tokens
     bitwise the one-process eager loop's, every K1 launch at an out
     band's N, K5 on the stored vocab band, K1 launches a rank as one
     process's, no SIMT; K1/K5 rows on the bands, a K2 row on the rank's
     heads), then cut to MESH_ROWS_LAYERS layers on MESH_WIDE (each data
     rank's rows bitwise one process serving them alone), DeepSeek-V2-Lite at full width cut to
     MESH_DS_LAYERS layers with ``moe_local_dispatch`` and the tiled
     Llama cut to MESH_TILED_LAYERS on MESH_WIDE, and the Llama smoke
     model on MESH_SPREAD (its 2 kv heads on 4 ranks: each holds a block
     of the cache's positions) (prefill logits within MESH_LOGIT_ATOL of
     one process; tokens under the exact-tie rule; DeepSeek's K3 on 32
     experts a rank, K4 and K2 on every rank); each rank's cache bytes
     gated to be the whole caches' share, beside its peak memory;
     per-rank ms a step (ranks sharing one card); a ``mesh`` line.
 11. Train (``train_phase``): Llama-3.2-1B at full width, 16 layers,
     f32, trained TRAIN_STEPS steps from seed 0 (the loss must fall; every
     attention forward K2's f32 kernel, three-term TF32 on the tensor
     cores, under its autograd.Function); one
     step's gradients against the all-plain attention's; GPTQ on layer 0
     (below naive per-channel); the trained model packed compressed and
     served through ``serve``'s gates, with its escape share.
     DeepSeek-V2-Lite at full width cut to 2 layers (a depth cut: the MoE
     backward, the aux loss, MLA through K2 at (192, 128)); then the
     training launcher on its smoke default, stopped by SIGINT and resumed
     (losses bitwise the uninterrupted run's).  K2 f32 rows at both
     training shapes.  Then FAMILY_TRAIN: seamless-m4t-medium at full
     depth (f32 frames; K2 without the mask in its encoder and
     cross-attention), Zamba2-1.2B at 7 blocks, InternVL2-2B at 2 layers
     (patch embeddings), each with its gradients against the all-plain
     attention's.
 12. Train on a mesh (``train_mesh_phase``, last): MESH_RANKS ranks on the
     card over gloo; Llama-3.2-1B at full width cut to TRAIN_MESH_LAYERS
     layers, f32, its train state sharded on TRAIN_MESH (ZeRO-3), each
     block's leaves gathered over data where it uses them (twice with
     remat), tensor-parallel over model; TRAIN_MESH_STEPS steps, each loss
     within TRAIN_MESH_LOSS_RTOL of one process's on the card, K2's f32
     kernel on the rank's q heads in every forward and recompute; the
     checkpoint after step TRAIN_MESH_CKPT restored onto
     TRAIN_MESH_RESTORE and into one process, one more step each;
     DeepSeek-V2-Lite at 2 layers on TRAIN_MESH_MOE (its experts on
     model), its kept (token, expert) pairs equal one process's;
     Mamba2-2.7B at TRAIN_MESH_SSM_LAYERS blocks on TRAIN_MESH_SSM (each
     model rank on its SSM heads), TRAIN_MESH_SSM_STEPS steps, each loss
     and gradient norm within TRAIN_MESH_LOSS_RTOL of one process's; K2
     f32 at each mesh's rank's heads and rows.
 13. Dry run (``dryrun_phase``, last): plans on fake tensors
     (``launch/dryrun.py``) for an H100 SXM of 132 SMs (the card's count
     must be that), held against this run: the train_mesh phase's Llama
     cell on each rank of a ``PlannedMesh`` (bytes by collective, K2's
     launches and the state's bytes equal to what the rank measured, the
     planned peak within DRYRUN_PEAK_RATIO of the measured), Llama-3.2-1B
     compressed on the fixed batch (a prefill's and a decode step's
     launches by kernel and argument bytes equal to the card's eager
     calls, K1's planned bytes a layer within DRYRUN_K1_RTOL of those
     behind PERF.md's K1 bound); and internlm2-1.8b's decode_32k on the
     16×16 mesh, which must plan (its bytes a rank and its caches'
     beside the reference's share printed, not gated).

Prints one ``kernel_detail`` and one ``e2e`` line per path, an
``engine`` and a ``rows`` line for Llama, a ``resilience`` line per path,
a ``family`` line per model of the families phase, an ``encdec`` line,
an ``examples`` and a ``mesh`` line (with ``mesh_detail``), a
``train_mesh`` line (with ``train_mesh_detail``), a ``dryrun`` line (with
``dryrun_detail``),
K1/K3's SIMT kernel's launches by phase, one JSON
``kernels`` line (every kernel, with the launches of its path's run; on
Llama's rows also the engine drain's, ``engine_launches``), the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCH, MAX_NEW = 4, 32
PROMPT_MIN, PROMPT_MAX = 32, 200
DS_LAYERS = 8            # DeepSeek-V2-Lite depth on the card (of 27)
# The engine phase (Llama): requests arrive at cumulative Poisson(1.5)
# ticks into the continuous-batching engine
ENGINE_SLOTS, ENGINE_PAGE, ENGINE_MAX_LEN = 4, 8, 232
ENGINE_REQUESTS, ENGINE_NEW_MIN, ENGINE_NEW_MAX = 8, 8, 32
DS_CHECK_STEPS = 4       # greedy steps compared card against CPU
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak, same source
F32_FLOP_PER_S = 67e12           # f32 outside the tensor cores, same source
TF32_FLOP_PER_S = 495e12         # dense TF32 tensor-core peak, same source
# Tolerances, each with its reason:
#  * K1/K5 on random bf16 x, f32 output: the kernel and the plain version
#    sum the same exact products in another order; f32 roundoff over
#    K ≤ 10944 terms stays far below 1e-4 of the output's scale.
MATMUL_RTOL = 1e-4
#  * K2 in bf16 (the main path's dtypes): f32 math in both, another order
#    of sums and another exp; the bf16 output may round to the other side:
#    two bf16 ulps at |out| ≈ 1 (|v| ≤ ~4 for normal inputs).
FLASH_ATOL_BF16 = 1.6e-2
#  * K2 with f32 q and output: f32 roundoff only.
FLASH_ATOL_F32 = 1e-4
#  * K2 at MLA's (192, 128) on random bf16 q/k/v, 207 keys: the same
#    two bf16 ulps at |out| ≈ 1 (v ~ N(0, 1), softmax weights average it).
#  * Card against CPU prefill logits at 2 layers: bf16 activations, where
#    a rounding flip is 2^-8 relative, pass through 2 layers of width 2048
#    and the 2048-wide LM head; logits are O(1).  The same bound holds for
#    DeepSeek-V2-Lite's 2 layers (a dense layer and an MoE layer) where the
#    last token keeps the same experts on both devices.  A near-tie at the
#    top-6 boundary of bf16 router logits can route it differently, or
#    route an earlier token differently and so move it past an expert's
#    capacity (slots are ranked token-major): such a request (at most one
#    of the four) is left out of the comparison with the CPU's own routing,
#    and every request is held to the bound against a CPU run given the
#    card's routing.
E2E_LOGIT_ATOL = 5e-2
#  * Rungs of the ladder against the fused rung at 16 layers: the same
#    products summed in another order (K5 in one product, K1 in strips;
#    materialize in one f32 matmul), each output rounded to bf16, through
#    16 layers: twice the 2-layer card-vs-CPU bound on the prefill logits;
#    greedy tokens equal, or first differing where the fused top-2 gap is
#    within that bound (a near tie).
RUNG_LOGIT_ATOL = 1e-1
# The resilience phase's poisoned drain: 4 requests of 8 new tokens
RES_REQUESTS, RES_NEW = 4, 8
# the tokens a request has generated when a higher-priority arrival
# preempts it; it resumes with this many minus one replayed decode steps
RESUME_AFTER = 128
# The residency phase (DeepSeek-V2-Lite, 8 layers): (expert-cache capacity
# a layer, new tokens of the fixed batch); fewer tokens where every step
# fetches.  K3's cache-stack row is timed at C = RES_CACHE_C.
RES_CAPACITIES = ((64, 32), (24, 16), (6, 12), (1, 8))
RES_CACHE_C = 24
# The governor phase (Llama-3.2-1B): the engine phase's requests under a
# 'ramp' and an 'oscillate' budget trace of GOV_STEPS steps from the boot
# pool's bytes down to GOV_LOW_SLOTS slots' pages
GOV_LOW_SLOTS, GOV_STEPS, GOV_COOLDOWN = 2, 64, 4
# The tiled phase (Llama): column groups of CompressionPolicy(tiles=G); the
# first is the one served by the engine, the rungs and the launcher
TILES = (2, 4)


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
    not counted; the K1 calls walk the layers' planes, so (as on the
    main path) the weights exceed the 50 MB L2, or the graph flushes the
    L2 before each call where they do not.  ``ms``: CUDA events
    around single calls with the L2 flushed before each, host overhead
    included — for the plain versions, which are no speed yardstick."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def graph_ms(self, fns, reps: int = 10, cold: bool = False) -> float:
        """``cold``: for weights that fit the L2 together, a 128 MB memset
        (which evicts it) is captured before each call, and a graph of the
        memsets alone is timed and subtracted."""
        if not cold:
            return self._replay_ms(fns, reps) / len(fns)
        wipe = self.flush[:128 << 20].zero_
        both = [f for fn in fns for f in (wipe, fn)]
        return (self._replay_ms(both, reps)
                - self._replay_ms([wipe] * len(fns), reps)) / len(fns)

    def _replay_ms(self, fns, reps: int) -> float:
        """Milliseconds of one replay of a CUDA graph of ``fns``."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for f in fns:                       # warm-up outside capture
                f()
        torch.cuda.current_stream().wait_stream(side)
        from repro_torch.serve.engine import no_collection
        graph = torch.cuda.CUDAGraph()
        # a dead graph freed mid-capture would void it
        with no_collection(), torch.cuda.graph(graph,
                                               capture_error_mode="relaxed"):
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
        return start.elapsed_time(end) / reps

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


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    """The larger of the bytes over HBM's rate and the operations over
    ``peak`` (bf16 tensor cores; F32_FLOP_PER_S for f32 work)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class SimtWatch(collections.Counter):
    """``_build.KERNEL_COUNTS`` for the whole run (the same object, whose
    class ``watch`` swaps, since the decode graph's replays add to it): the
    Counter that every phase clears and reads, which also keeps, by phase
    (``phase``, set as each path moves on), each launch of K1/K3's SIMT
    kernel — a launch inside a captured step is seen at its capture.  No
    served path may launch it: only tiles 1 or 2 weights wide reach it,
    and only the kernel checks (``<path> kernels``) hold such tiles."""

    @classmethod
    def watch(cls, counts: collections.Counter) -> "SimtWatch":
        counts.__class__ = cls
        counts.phase, counts.simt = "setup", collections.Counter()
        return counts

    def __setitem__(self, key, value):
        if key.endswith(":simt") and "fused_decode_matmul" in key:
            self.simt[self.phase] += value - self.get(key, 0)
        super().__setitem__(key, value)


def matmul_kernels(kernel_launches: dict) -> dict:
    """A run's ``_build.KERNEL_COUNTS`` without K2's (``flash_attention:
    mma|simt``): the matmul wrappers' launches, which the gates hold."""
    return {k: v for k, v in kernel_launches.items()
            if not k.startswith("flash_attention:")}


def by_kernel(kernel_launches: dict, name: str) -> dict:
    """The launches of wrapper ``name`` by kernel ({kernel: n}) from a
    run's ``_build.KERNEL_COUNTS``."""
    return {key.split(":", 1)[1]: v for key, v in kernel_launches.items()
            if key.split(":", 1)[0] == name}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def int_x(m, k, gen, device):
    return torch.randint(-4, 5, (m, k), generator=gen, device=device
                         ).to(torch.bfloat16)


def rand_x(m, k, gen, device):
    return torch.randn((m, k), generator=gen, device=device
                       ).to(torch.bfloat16)


def make_prompts(vocab: int, n_prompts: int = BATCH):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, n_prompts)
    reqs = [rng.integers(0, vocab, int(n)) for n in lens]
    width = int(max(lens))
    batch = np.zeros((n_prompts, width), np.int64)     # left-padded with 0
    for i, r in enumerate(reqs):
        batch[i, width - len(r):] = r
    return batch, [int(n) for n in lens]


# ---------------------------------------------------------------------------

L2_BYTES = 50 << 20      # H100 SXM L2


def launch_info(fdm, m, w, e, decode=False, plan_n=None, plan_e=None):
    """The kernel ``fdm.launch_plan`` picks for a call at M = ``m`` on the
    planes of ``w`` (E = ``e`` weights; ``decode``: a decode step's rows;
    ``plan_n`` / ``plan_e``: the N and E the launch is planned for, a mesh
    rank's share passing the whole weight's) and its grid and block size
    (above 16 decode rows: of one launch of ``row_groups``)."""
    slots = w.codes.shape[-1]
    n, k = w.shape
    plan = fdm.launch_plan(m, plan_n or n, k, w.tile_k, plan_e or e,
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count, slots, decode)
    rows = min(m, fdm.DECODE_MAX_M) if plan.row_groups > 1 else m
    out = fdm.launch_grid(plan, rows, w.shape[0], w.tile_k, slots, e)
    if plan.row_groups > 1:
        out["row_groups"] = plan.row_groups
    return out


def check_fused(rt, lut, projections, device, m_prefill, gen, timer,
                timed_at, cold=False, shards=1):
    """K1 on each ``(label, weights, in_layer)`` of ``projections`` — the
    packed planes of one projection in every layer that has it — at M =
    batch (decode) and M = ``m_prefill`` (prefill): bitwise on integer x,
    within MATMUL_RTOL on random x.  Calls are timed walking the layers'
    planes; with ``cold``, a walk whose planes fit twice in the L2 is timed
    with the L2 flushed before each call.  The row's times add up the
    ``in_layer`` projections: one layer's K1 work at decode (``ms``...)
    and at the prefill (``prefill_ms``...).  ``shards``: the planes are
    out bands of a weight ``shards`` times as wide, and each launch takes
    the whole weight's plan (``plan_n``), as the mesh path launches it."""
    fdm = rt["fdm"]

    def planes(w):
        return ((w.codes, w.literals, lut, w.scale, w.zero),
                dict(shape=w.shape, tile_n=w.tile_n, tile_k=w.tile_k))

    rows, worst, bitwise = [], 0.0, True
    agg = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    pre = dict.fromkeys(("prefill_ms", "prefill_bound_ms",
                         "prefill_library_ms"), 0.0)
    pre_by = set()
    seen = set()
    for label, ws, in_layer in projections:
        w = ws[0]
        n, k = w.shape
        args, kw = planes(w)
        pk = {"plan_n": n * shards} if shards > 1 else {}
        flush = cold and sum(plane_bytes(wl) for wl in ws) < 2 * L2_BYTES
        for m in (BATCH, m_prefill):
            xi = int_x(m, k, gen, device)
            yk = fdm.fused_decode_matmul(xi, *args, **kw, **pk,
                                         out_dtype=torch.bfloat16)
            yp = fdm.fused_decode_matmul_plain(xi, *args, **kw,
                                               out_dtype=torch.bfloat16)
            same = bool(torch.equal(yk, yp))
            bitwise &= same
            xr = rand_x(m, k, gen, device)
            yk = fdm.fused_decode_matmul(xr, *args, **kw, **pk,
                                         out_dtype=torch.float32)
            yp = fdm.fused_decode_matmul_plain(xr, *args, **kw,
                                               out_dtype=torch.float32)
            err = float((yk - yp).abs().max())
            tol = MATMUL_RTOL * float(yp.abs().max())
            worst = max(worst, err)
            if not (same and err <= tol and torch.isfinite(yk).all()):
                raise AssertionError(f"K1 {label} {w.shape} M={m}: "
                                     f"bitwise={same} err={err} tol={tol}")
            key = (n, k, m, len(ws))
            if key in seen:       # projections of one shape share a time
                t = next(r for r in rows
                         if (r["N"], r["K"], r["M"], r["layers"]) == key)
            else:
                seen.add(key)
                flops, moved = fdm.work(m, n, k, codes=w.codes,
                                        literals=w.literals, lut=lut,
                                        scale=w.scale, zero=w.zero)
                b, by = bound_ms(moved, flops)
                kern = [lambda p=planes(wl): fdm.fused_decode_matmul(
                    xr, *p[0], **p[1], **pk) for wl in ws]
                wbs = [wl.materialize(lut, torch.bfloat16) for wl in ws]
                lib = [lambda wb=wb: xr @ wb.T for wb in wbs]
                t = {"proj": label, "N": n, "K": k, "M": m,
                     "layers": len(ws), "bitwise": same, "max_abs_err": err,
                     "ms": timer.graph_ms(kern, cold=flush),
                     "plain_ms": timer.ms(lambda: fdm.fused_decode_matmul_plain(
                         xr, *args, **kw, out_dtype=torch.bfloat16)),
                     "library_ms": timer.graph_ms(lib, cold=flush),
                     "bound_ms": b, "bound_by": by, "l2_flushed": flush,
                     "cap": w.literals.shape[1],
                     "tile": [w.tile_n, w.tile_k],
                     **pk, **launch_info(fdm, m, w, 1, plan_n=n * shards)}
                del wbs, lib
                rows.append(t)
            if m == BATCH and in_layer:
                for f in agg:
                    agg[f] += t[f]
            if m == m_prefill and in_layer:
                for f in pre:
                    pre[f] += t[f[len("prefill_"):]]
                pre_by.add(t["bound_by"])
    return {"name": "fused_decode_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_decode_matmul.cu",
            "replaces": "src/repro/kernels/fused_decode_matmul.py:114",
            "bitwise": bitwise, "max_abs_err": worst, "timed_at": timed_at,
            **agg, "bound_by": "bytes", **pre,
            "prefill_timed_at": f"the same projections at M={m_prefill}",
            "prefill_bound_by": "+".join(sorted(pre_by))}, rows


def check_small_tiles(rt, device, gen):
    """K1 and K3 on weights whose K the packer cuts into tiles 2 and 1
    weights wide (K ≡ 2 mod 4, K odd: the SIMT kernel, at every M) and 4
    and 8 wide (the decode kernel's product on the SIMT cores; at M = 129
    the tensor-core kernel, K ≡ 4 mod 8 copying x 8 bytes at a time), at
    M = batch and 129: bitwise on integer x.  Packed from seeded random
    weights of those shapes alone."""
    fdm, pack_stack = rt["fdm"], rt["pack_expert_stack"]
    rows = []
    for e, n, k in ((1, 128, 130), (1, 128, 131), (3, 128, 130),
                    (1, 128, 132), (1, 128, 136), (3, 128, 132)):
        ws = [torch.randint(-3, 4, (n, k), generator=gen, device=device
                            ).float() / 3 for _ in range(e)]
        pl, lut = pack_stack(ws)
        kw = dict(shape=pl.shape, tile_n=pl.tile_n, tile_k=pl.tile_k,
                  out_dtype=torch.bfloat16)
        for m in (BATCH, 129):
            x = torch.randint(-4, 5, (e, m, k), generator=gen,
                              device=device).to(torch.bfloat16)
            if e == 1:
                args = (pl.codes[0], pl.literals[0], lut, pl.scale[0],
                        pl.zero[0])
                same = bool(torch.equal(
                    fdm.fused_decode_matmul(x[0], *args, **kw),
                    fdm.fused_decode_matmul_plain(x[0], *args, **kw)))
            else:
                args = (pl.codes, pl.literals, lut, pl.scale, pl.zero)
                same = bool(torch.equal(
                    fdm.grouped_fused_decode_matmul(x, *args, **kw),
                    fdm.grouped_fused_decode_matmul_plain(x, *args, **kw)))
            rows.append({"kernel": "K1" if e == 1 else "K3", "E": e, "N": n,
                         "K": k, "M": m, "tile": [pl.tile_n, pl.tile_k],
                         "bitwise": same,
                         "launch": launch_info(fdm, m, pl, e)})
            if not same:
                raise AssertionError(f"K1/K3 at tile_k {pl.tile_k}: "
                                     f"{rows[-1]}")
    return rows


def dequant_launch(dqm, m, n, k, decode=False, plan_n=None):
    """The kernel ``dqm.dequant_plan`` picks for K5 at (m, n, k), planned
    for ``plan_n`` columns where given, with its grid (a tree from before
    the plan: the SIMT kernel)."""
    if not hasattr(dqm, "dequant_plan"):
        return {"kernel": "simt"}
    pk = {"plan_n": plan_n} if plan_n else {}
    plan = dqm.dequant_plan(m, n, k, torch.cuda.get_device_properties(0)
                            .multi_processor_count, decode, **pk)
    return {f: v for f, v in plan._asdict().items() if v or f == "kernel"}


def check_k5(rt, wq, scale, zero, wb, m, gen, timer, plain=True,
             decode=False, plan_n=None):
    """K5 at M = ``m`` on the uint8 weight ``wq`` (N, K) with its scale and
    zero (``wb``: the same weight dequantized to bf16, for the library
    call): bitwise equal to the plain version on integer x, within
    MATMUL_RTOL on random x, two calls with the same bits.  Timed as
    CUDA-graph replays, with the L2 wiped before each call where the
    weight fits it; the plain version by single calls (``plain``), and
    ``torch.matmul`` on ``wb`` the same way as the kernel.  ``decode``:
    the rows are a decode step's (``dequant_plan``); ``plan_n``: ``wq``
    is an out band of a weight of ``plan_n`` rows, launched with that
    weight's plan, as the mesh path launches it.  → the row."""
    dqm = rt["dqm"]
    pk = {"plan_n": plan_n} if plan_n else {}
    dq = lambda x, *a, **kw: dqm.dequant_matmul(x, *a, **kw,  # noqa: E731
                                                decode=decode, **pk)
    device = wq.device
    n, k = wq.shape
    args = (wq, scale, zero)
    xi = int_x(m, k, gen, device)
    same = bool(torch.equal(dq(xi, *args),
                            dqm.dequant_matmul_plain(xi, *args,
                                                     torch.bfloat16)))
    xr = rand_x(m, k, gen, device)
    yk = dq(xr, *args, out_dtype=torch.float32)
    yp = dqm.dequant_matmul_plain(xr, *args, torch.float32)
    err = float((yk - yp).abs().max())
    tol = MATMUL_RTOL * float(yp.abs().max())
    again = bool(torch.equal(yk, dq(xr, *args, out_dtype=torch.float32)))
    if not (same and again and err <= tol and torch.isfinite(yk).all()):
        raise AssertionError(f"K5 ({m}, {n}, {k}): bitwise={same} err={err}"
                             f" tol={tol} repeatable={again}")
    flops, moved = dqm.work(m, n, k, wq=wq, scale=scale, zero=zero)
    b, by = bound_ms(moved, flops)
    return {"bitwise": same, "max_abs_err": err,
            "launch": dequant_launch(dqm, m, n, k, decode, plan_n), **pk,
            "ms": weight_graph_ms(timer, wq, lambda: dq(xr, *args)),
            "plain_ms": timer.ms(lambda: dqm.dequant_matmul_plain(
                xr, *args, torch.bfloat16)) if plain else None,
            "library_ms": weight_graph_ms(timer, wq, lambda: xr @ wb.T),
            "bound_ms": b, "bound_by": by}


def weight_graph_ms(timer, w, fn) -> float:
    """``timer.graph_ms`` of a call that reads weight ``w``: with the L2
    wiped before each call where ``w`` fits it, else 4 calls a replay."""
    if nbytes(w) < L2_BYTES:
        return timer.graph_ms([fn], reps=20, cold=True)
    return timer.graph_ms([fn] * 4)


K5_ROW = {"name": "dequant_matmul", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/dequant_matmul.cu",
          "replaces": "src/repro/kernels/dequant_matmul.py:69"}


def check_dequant(rt, head, gen, timer):
    """K5 on the int8 LM head at M = batch (``check_k5``)."""
    n, k = head.values.shape
    return {**K5_ROW, **check_k5(rt, head.values, head.scale, head.zero,
                                 head.materialize(torch.bfloat16), BATCH,
                                 gen, timer),
            "timed_at": f"LM head {n}x{k}, M={BATCH}"}


def _sdpa(q, k, v):
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          enable_gqa=True)


def check_flash(rt, device, t_prefill, gen, timer, hq, hkv, d, dv, what):
    """K2 at the prefill's (B, hq, T, d) against (B, hkv, T + 32, d/dv)
    keys and values with q_offset 0 (the prefill over a cache of T + 32),
    and on a ragged prime T: the tensor-core kernel on bf16 operands (the
    main path's), and the f32 kernel with f32 q (``f32_*``; the wrapper
    upcasts k and v to f32 inside the timed call), each launched under its
    own count."""
    fa, _build = rt["fa"], rt["_build"]
    rows, worst = [], 0.0
    for tq in (t_prefill, 197):
        tk = tq + MAX_NEW
        q = torch.randn((BATCH, hq, tq, d), generator=gen, device=device)
        k = torch.randn((BATCH, hkv, tk, d), generator=gen, device=device)
        v = torch.randn((BATCH, hkv, tk, dv), generator=gen, device=device)
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        qf = qb.float()
        _build.LAUNCH_COUNTS.clear()
        yk = fa.flash_attention(qb, kb, vb)
        yk32 = fa.flash_attention(qf, kb, vb)
        routed = dict(_build.LAUNCH_COUNTS)
        err = float((yk.float() - fa.flash_attention_plain(qb, kb, vb)
                     .float()).abs().max())
        err32 = float((yk32 - fa.flash_attention_plain(qf, kb, vb))
                      .abs().max())
        worst = max(worst, err)
        if not (err <= FLASH_ATOL_BF16 and err32 <= FLASH_ATOL_F32
                and routed == {fa.NAME: 1, fa.F32_NAME: 1}
                and torch.isfinite(yk).all()):
            raise AssertionError(f"K2 ({d}, {dv}) T={tq}: bf16 err {err}, "
                                 f"f32 err {err32}, launches {routed}")
        flops, moved = fa.work(BATCH, hq, hkv, tq, tk, d, dv)
        kv_bytes = moved - 2 * BATCH * hq * tq * (d + dv)
        b, by = bound_ms(moved, flops)
        b32, by32 = bound_ms(kv_bytes + 4 * BATCH * hq * tq * (d + dv),
                             3 * flops, TF32_FLOP_PER_S)
        kr, vr = kb[:, :, :tq], vb[:, :, :tq]
        # SDPA on f32 operands: with enable_gqa it takes the math backend
        # (bmm, whose cuBLAS workspace per stream outlives the timing); k
        # and v repeated to the q heads, outside the timed call, take its
        # fused kernel
        kf, vf = (t.float().repeat_interleave(hq // hkv, dim=1)
                  for t in (kr, vr))
        rows.append({"Tq": tq, "Tk": tk, "Dqk": d, "Dv": dv,
                     "max_abs_err": err, "max_abs_err_f32": err32,
                     "ms": timer.graph_ms(
                         [lambda: fa.flash_attention(qb, kb, vb)] * 8),
                     "plain_ms": timer.ms(lambda: fa.flash_attention_plain(
                         qb, kb, vb)),
                     # SDPA's causal mask is aligned top-left; over the
                     # first Tq keys it is the same function
                     "library_ms": timer.graph_ms(
                         [lambda: _sdpa(qb, kr, vr)] * 8),
                     "bound_ms": b, "bound_by": by,
                     "f32_ms": timer.graph_ms(
                         [lambda: fa.flash_attention(qf, kb, vb)] * 8),
                     "f32_library_ms": timer.graph_ms(
                         [lambda: torch.nn.functional
                          .scaled_dot_product_attention(
                              qf, kf, vf, is_causal=True)] * 8),
                     "f32_bound_ms": b32, "f32_bound_by": by32})
    main = rows[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:80",
            "max_abs_err": worst,
            "timed_at": f"{what} (B={BATCH}, {hq}, T={t_prefill}, {d}) vs "
                        f"Tk={t_prefill + MAX_NEW}, Dv={dv}; bf16 "
                        "operands, the tensor-core kernel",
            "library": "scaled_dot_product_attention",
            **{f: main[f] for f in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by", "f32_ms",
                                    "f32_bound_ms", "f32_library_ms")},
            "f32_max_abs_err": max(r["max_abs_err_f32"] for r in rows),
            "f32_kernel": "three-term TF32 on the tensor cores, f32 q "
                          "(flash_attention_f32)"}, rows


def plane_bytes(w) -> int:
    """Bytes a decode of the packed weight ``w`` must read: the codes, the
    literal rows its blocks use (4 × Σ nlit), scale and zero."""
    return (w.codes.numel() * 2 + used_literal_bytes(w)
            + (w.scale.numel() + w.zero.numel()) * 4)


def used_literal_bytes(w) -> int:
    """The literal rows the blocks of ``w`` use: 4 × Σ nlit bytes."""
    return int(w.nlit.sum()) * 4


def check_grouped(rt, cfg, state, device, n_prefill, gen, timer,
                  plan_experts=None):
    """K3 on the first MoE layer's three expert stacks (64 experts; gate/up
    1408 × 2048, down 2048 × 1408) at M = cap of a decode step (4 tokens)
    and of the prefill (4 prompts × T tokens).  ``plan_experts``: the
    stacks are a mesh rank's share of stacks of that many experts, each
    launch planned for them, as the mesh path launches it."""
    fdm, L = rt["fdm"], rt["L"]
    lut = state.lut
    experts = state.params["blocks"][0]["moe"]["experts"]
    caps = {"decode": L._capacity(BATCH, cfg.top_k, cfg.n_experts,
                                  cfg.capacity_factor),
            "prefill": L._capacity(n_prefill, cfg.top_k, cfg.n_experts,
                                   cfg.capacity_factor)}
    rows, worst, bitwise = [], 0.0, True
    agg = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    pre = dict.fromkeys(("prefill_ms", "prefill_bound_ms",
                         "prefill_library_ms"), 0.0)
    pre_by = set()
    for name in ("w_gate", "w_up", "w_down"):
        w = experts[name]
        e = w.codes.shape[0]
        n, k = w.shape
        args = (w.codes, w.literals, lut, w.scale, w.zero)
        kw = dict(shape=w.shape, tile_n=w.tile_n, tile_k=w.tile_k)
        pk = {"plan_experts": plan_experts} if plan_experts else {}
        wbt = w.materialize(lut, torch.bfloat16).transpose(1, 2)
        for phase, m in caps.items():
            xi = torch.randint(-4, 5, (e, m, k), generator=gen, device=device
                               ).to(torch.bfloat16)
            same = bool(torch.equal(
                fdm.grouped_fused_decode_matmul(xi, *args, **kw, **pk),
                fdm.grouped_fused_decode_matmul_plain(
                    xi, *args, **kw, out_dtype=torch.bfloat16)))
            bitwise &= same
            xr = torch.randn((e, m, k), generator=gen, device=device
                             ).to(torch.bfloat16)
            yk = fdm.grouped_fused_decode_matmul(xr, *args, **kw, **pk,
                                                 out_dtype=torch.float32)
            yp = fdm.grouped_fused_decode_matmul_plain(
                xr, *args, **kw, out_dtype=torch.float32)
            err = float((yk - yp).abs().max())
            tol = MATMUL_RTOL * float(yp.abs().max())
            worst = max(worst, err)
            if not (same and err <= tol and torch.isfinite(yk).all()):
                raise AssertionError(f"K3 {name} {tuple(w.codes.shape)} "
                                     f"M={m}: bitwise={same} err={err} "
                                     f"tol={tol}")
            flops, moved = fdm.work(m, n, k, codes=w.codes,
                                    literals=w.literals, lut=lut,
                                    scale=w.scale, zero=w.zero, e=e,
                                    literal_bytes=used_literal_bytes(w))
            b, by = bound_ms(moved, flops)
            # one stack's planes (~280 MB) and bf16 weights (~370 MB) are
            # each past the 50 MB L2, so repeated calls find it cold
            t = {"stack": name, "E": e, "N": n, "K": k, "M": m,
                 "phase": phase, "bitwise": same, "max_abs_err": err,
                 "ms": timer.graph_ms([lambda: fdm.grouped_fused_decode_matmul(
                     xr, *args, **kw, **pk)] * 4),
                 "plain_ms": timer.ms(
                     lambda: fdm.grouped_fused_decode_matmul_plain(
                         xr, *args, **kw, out_dtype=torch.bfloat16)),
                 "library_ms": timer.graph_ms(
                     [lambda: torch.bmm(xr, wbt)] * 4),
                 "bound_ms": b, "bound_by": by,
                 "cap": w.literals.shape[2], "tile": [w.tile_n, w.tile_k],
                 **pk, **launch_info(fdm, m, w, e, plan_e=plan_experts)}
            rows.append(t)
            if phase == "decode":
                for f in agg:
                    agg[f] += t[f]
            else:
                for f in pre:
                    pre[f] += t[f[len("prefill_"):]]
                pre_by.add(by)
        del wbt
    return {"name": "grouped_fused_decode_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_decode_matmul.cu",
            "replaces": "src/repro/kernels/fused_decode_matmul.py:202",
            "bitwise": bitwise, "max_abs_err": worst,
            "timed_at": f"one MoE layer's 3 expert stacks, decode cap "
                        f"{caps['decode']}",
            "library": "torch.bmm on the materialized bf16 expert stack",
            **agg, "bound_by": "bytes", **pre,
            "prefill_timed_at": f"the same stacks at prefill cap "
                                f"{caps['prefill']}",
            "prefill_bound_by": "+".join(sorted(pre_by))}, rows


def check_grouped_rows(rt, state, device, gen, timer, m):
    """K3 on the first MoE layer's three expert stacks at decode capacity
    ``m`` (the decode kernel's row groups; above 16 a launch a group of
    16: an engine tick of m slots in the dropless regime): ``rows_check``
    on each (bitwise on integer x,
    MATMUL_RTOL on random x, each row bitwise that row alone), timed as
    ``check_grouped`` times it.  → (the row, its stacks)."""
    fdm = rt["fdm"]
    lut = state.lut
    experts = state.params["blocks"][0]["moe"]["experts"]
    row = {"name": "grouped_fused_decode_matmul", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/fused_decode_matmul.cu",
           "replaces": "src/repro/kernels/fused_decode_matmul.py:202",
           "timed_at": f"one MoE layer's 3 expert stacks, cap {m}",
           "library": "torch.bmm on the materialized bf16 expert stack",
           "bitwise": True, "rows_equal_alone": True, "max_abs_err": 0.0,
           "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "bound_by": "bytes"}
    detail = []
    for name in ("w_gate", "w_up", "w_down"):
        w = experts[name]
        e = w.codes.shape[0]
        n, k = w.shape
        args = (w.codes, w.literals, lut, w.scale, w.zero)
        kw = dict(shape=w.shape, tile_n=w.tile_n, tile_k=w.tile_k)
        fields, xr = rows_check(
            lambda x, dt: fdm.grouped_fused_decode_matmul(
                x, *args, **kw, out_dtype=dt, decode=True),
            lambda x, dt: fdm.grouped_fused_decode_matmul_plain(
                x, *args, **kw, out_dtype=dt), m, k, gen, device, lead=(e,))
        wbt = w.materialize(lut, torch.bfloat16).transpose(1, 2)
        flops, moved = fdm.work(m, n, k, codes=w.codes, literals=w.literals,
                                lut=lut, scale=w.scale, zero=w.zero, e=e,
                                literal_bytes=used_literal_bytes(w))
        b, by = bound_ms(moved, flops)
        t = {"stack": name, "E": e, "N": n, "K": k, "M": m, **fields,
             "ms": timer.graph_ms([lambda: fdm.grouped_fused_decode_matmul(
                 xr, *args, **kw, decode=True)] * 4),
             "plain_ms": timer.ms(
                 lambda: fdm.grouped_fused_decode_matmul_plain(
                     xr, *args, **kw, out_dtype=torch.bfloat16)),
             "library_ms": timer.graph_ms([lambda: torch.bmm(xr, wbt)] * 4),
             "bound_ms": b, "bound_by": by,
             **launch_info(fdm, m, w, e, decode=True)}
        del wbt
        for f in ("ms", "plain_ms", "bound_ms", "library_ms"):
            row[f] += t[f]
        row["max_abs_err"] = max(row["max_abs_err"], t["max_abs_err"])
        detail.append(t)
    row["launch"] = {f: detail[0][f] for f in ("kernel", "grid", "threads",
                                                "smem_bytes", "row_groups")
                     if f in detail[0]}
    return row, detail


def check_dict_decode(rt, w, lut, timer):
    """K4 on MLA's wkv_b (4096 × 512: 512 blocks of 1024 slots) and on a
    ragged, prime block count of the same planes.  Beside the kernel's
    time, two floors under the same cold graph timer: ``floor_ms``, a
    one-element ``zero_()`` (what a graph node with no work reads), and
    ``copy_ms``, a ``copy_`` that reads and writes K4's byte count.  The
    bytes are what this run's data needs: the codes, the literal rows the
    blocks use, the LUT rows the codes index (once each) and the output."""
    ddc = rt["ddc"]
    rows = []
    for label, nb in (("wkv_b", w.codes.shape[0]),
                      ("ragged", max(w.codes.shape[0] - 3, 1))):
        codes, lits = w.codes[:nb], w.literals[:nb]
        got = ddc.dict_decode(codes, lits, lut)
        again = ddc.dict_decode(codes, lits, lut)
        same = bool(torch.equal(got, ddc.dict_decode_plain(codes, lits, lut))
                    and torch.equal(got, again))
        if not same:
            raise AssertionError(f"K4 {label} ({nb} blocks) differs from "
                                 "its plain version or between two calls")
        slots, cap = codes.shape[1], lits.shape[1]
        nlit = w.nlit[:nb].clamp(max=cap)
        lut_rows = torch.unique(codes[codes != -1]).numel()  # -1: escape
        _, moved = ddc.work(nb, slots, cap, lut.shape[0],
                            literal_rows=int(nlit.sum()),
                            lut_rows_read=lut_rows)
        b, by = bound_ms(moved, 0.0)
        half = torch.empty(moved // 2, dtype=torch.uint8, device=got.device)
        other = torch.empty_like(half)
        one = torch.empty(1, device=got.device)
        row = {"planes": label, "blocks": nb, "slots": slots, "cap": cap,
               "bitwise": same, "bytes": moved, "lut_rows_read": lut_rows,
               # the kernel alone: CUDA-graph replays, the L2 wiped
               # before each call (the planes fit it)
               "ms": timer.graph_ms(
                   [lambda: ddc.dict_decode(codes, lits, lut)],
                   reps=20, cold=True),
               "floor_ms": timer.graph_ms([one.zero_], reps=20, cold=True),
               "copy_ms": timer.graph_ms([lambda: other.copy_(half)],
                                         reps=20, cold=True),
               # single launches with the L2 flushed before each, the
               # host's launch latency inside
               "call_ms": timer.ms(
                   lambda: ddc.dict_decode(codes, lits, lut), iters=20),
               "plain_ms": timer.ms(
                   lambda: ddc.dict_decode_plain(codes, lits, lut)),
               "library_ms": None, "bound_ms": b, "bound_by": by}
        if hasattr(ddc, "launch_shape"):
            blocks, threads = ddc.launch_shape(nb, slots)
            row["grid"] = f"{blocks} blocks of {threads} threads"
        rows.append(row)
    main = rows[0]
    return {"name": "dict_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dict_decode.cu",
            "replaces": "src/repro/kernels/dict_decode.py:44",
            "bitwise": True, "max_abs_err": 0.0,
            "timed_at": f"MLA wkv_b {tuple(w.shape)}, {main['blocks']} blocks",
            "library": "none: no single PyTorch call decodes the dictionary",
            **{f: main[f] for f in ("ms", "floor_ms", "copy_ms", "call_ms",
                                    "plain_ms", "library_ms", "bound_ms",
                                    "bound_by")},
            **({"grid": main["grid"]} if "grid" in main else {})}, rows


def pack(rt, cfg, device, seed, tiles=0, mode="compressed",
         model_shards=1):
    """Seeded weights on the card, packed in ``mode`` with the default
    policy (``tiles``: its column groups; ``model_shards``: the model ranks
    of the mesh it is packed for); the dense weights are freed.
    → (state, timings)."""
    init = (rt["ED"].init_encdec if cfg.family == "encdec"
            else rt["LM"].init_lm)
    t0 = time.perf_counter()
    params = init(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = rt["build_serve_params"](
        params, rt["CompressionPolicy"](mode=mode, tiles=tiles),
        model_shards=model_shards, device=device)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    del params
    torch.cuda.empty_cache()
    log(f"pack: {cfg.name} ({cfg.n_layers} layers, {mode}, tiles {tiles}"
        f"{f', model_shards {model_shards}' if model_shards > 1 else ''}) "
        "init "
        f"{init_s:.2f} s, "
        f"build_serve_params {pack_s:.2f} s (peak {peak} B), table "
        f"{len(state.table or ())} codes, stats {json.dumps(state.stats)}")
    return state, {"init_s": init_s, "pack_s": pack_s,
                   "pack_peak_mem_bytes": peak}


def eager_loop(rt, cfg, state, ids, embeds=None):
    """The decode phase as an eager Python loop over ``make_serve_fns``'
    ``decode_step`` (int positions, every op dispatched from the host), as
    ``generate`` runs it on the CPU, greedy; ``embeds`` (B, T', d): a
    VLM's patch embeddings before the prompt.  → (the MAX_NEW new tokens,
    seconds of the decode steps alone)."""
    prefill, decode_step = rt["make_serve_fns"](cfg, device=ids.device)
    b = ids.shape[0]
    t0 = ids.shape[1] + (0 if embeds is None else embeds.shape[1])
    caches = rt["LM"].init_caches(cfg, b, t0 + MAX_NEW, device=ids.device)
    logits, caches = prefill(state.params, state.lut,
                             {"tokens": ids, "embeds": embeds}, caches)
    toks = [torch.argmax(logits, dim=-1)[:, None]]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(MAX_NEW - 1):
        logits, caches = decode_step(state.params, state.lut, toks[-1],
                                     caches, t0 + i)
        toks.append(torch.argmax(logits, dim=-1)[:, None])
    torch.cuda.synchronize()
    return torch.cat(toks, dim=1), time.perf_counter() - t


def serve(rt, cfg, state, device, batch, lens, want, packed_want,
          dispatch_want=None, kernel_want=None, embeds=None):
    """The main path (``embeds``: a VLM's patch embeddings, prepended at
    the prefill).  The eager decode loop first; then ``generate``
    twice: the first call runs an eager step and captures the decode step,
    the second only replays it.  Counts are zeroed just before each of the
    three and read just after; each must count ``want`` launches (and,
    where given, ``kernel_want`` launches by wrapper and kernel),
    ``packed_want`` materializations and (where given) ``dispatch_want``
    dispatches, the first generate one capture and the second none, and
    both give the eager loop's tokens bit for bit.
    Then the prefill alone (median of 3) and the graphed decode phase
    alone (replays, after a prefill), whose tokens must be the same too.
    Raises on any difference."""
    _build, L, LM, ops, E = (rt["_build"], rt["L"], rt["LM"], rt["ops"],
                             rt["engine"])
    b, t_tokens = batch.shape
    # the prefill's positions: the patch embeddings', then the prompt's
    t_prefill = t_tokens + (0 if embeds is None else embeds.shape[1])
    steps = MAX_NEW - 1
    ids = torch.as_tensor(batch, device=device)

    def counted(fn):
        for c in (_build.LAUNCH_COUNTS, _build.KERNEL_COUNTS,
                  L.MATERIALIZE_COUNTS, ops.DISPATCH_COUNTS,
                  E.CAPTURE_COUNTS):
            c.clear()
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {"s": time.perf_counter() - t0,
                     "launches": dict(_build.LAUNCH_COUNTS),
                     "kernel_launches": dict(_build.KERNEL_COUNTS),
                     "materialize_counts": dict(L.MATERIALIZE_COUNTS),
                     "dispatch_counts": dict(ops.DISPATCH_COUNTS),
                     "captures": E.CAPTURE_COUNTS["decode_loop"],
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(
                         device)}

    def generate():
        return rt["generate"](state.params, cfg, batch, lut=state.lut,
                              max_new=MAX_NEW, embeds=embeds, device=device)

    (eager, eager_decode_s), eager_run = counted(
        lambda: eager_loop(rt, cfg, state, ids, embeds))
    out_capture, capture_run = counted(generate)
    out, replay_run = counted(generate)
    graph = E.decode_graph(state.params, cfg, state.lut, b,
                           t_prefill + MAX_NEW, device=device)
    # the decode graph's private pool (its step's intermediates), which
    # max_memory_allocated does not count once the capture has freed them
    pool = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ()))
            == tuple(graph.graph.pool())]
    prefill, _ = rt["make_serve_fns"](cfg, device=device)
    pre = []
    for _ in range(3):
        caches = LM.init_caches(cfg, b, t_prefill + MAX_NEW, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = prefill(state.params, state.lut,
                            {"tokens": ids, "embeds": embeds}, caches)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    prefill_s = sorted(pre)[1]
    tok0 = graph.prefill(state.params, state.lut, ids, embeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.decode(state.params, state.lut, steps)
    torch.cuda.synchronize()
    graph_decode_s = time.perf_counter() - t0
    alone = torch.cat([tok0, graph.seq[:, t_prefill + 1:t_prefill + MAX_NEW]],
                      dim=1)
    new = out[:, t_tokens:]
    runs = {"eager_loop": eager_run, "generate_capture": capture_run,
            "generate_replay": replay_run}
    e2e = {"model": cfg.name, "layers": cfg.n_layers, "batch": b,
           "prompt_lens": lens, "max_new": MAX_NEW,
           "generate_s": replay_run["s"], "prefill_ms": prefill_s * 1e3,
           "capture_ms": graph.capture_ms,
           "decode_ms_per_step": graph_decode_s / steps * 1e3,
           "decode_tokens_per_s": b * steps / graph_decode_s,
           "eager_decode_ms_per_step": eager_decode_s / steps * 1e3,
           "eager_decode_tokens_per_s": b * steps / eager_decode_s,
           "generate_decode_tokens_per_s":
               b * steps / (replay_run["s"] - prefill_s),
           "peak_mem_bytes": capture_run["peak_mem_bytes"],
           "replay_peak_mem_bytes": replay_run["peak_mem_bytes"],
           "eager_peak_mem_bytes": eager_run["peak_mem_bytes"],
           "graph_pool_bytes": sum(pool), "graph_pool_segments": len(pool),
           "stats": state.stats, "launches": replay_run["launches"],
           "kernel_launches": replay_run["kernel_launches"],
           "materialize_counts": replay_run["materialize_counts"],
           "dispatch_counts": replay_run["dispatch_counts"],
           "runs": {k: {n: r[n] for n in ("s", "launches",
                                          "kernel_launches", "captures",
                                          "materialize_counts")}
                    for k, r in runs.items()},
           "first_request_tokens": new[0].tolist(), "tokens": new.tolist()}
    faults = []
    if not (tuple(out.shape) == (b, t_tokens + MAX_NEW)
            and int(new.min()) >= 0 and int(new.max()) < cfg.vocab_size
            and bool(torch.isfinite(logits.float()).all())):
        faults.append(f"out {tuple(out.shape)}, tokens in "
                      f"[{int(new.min())}, {int(new.max())}]")
    for name, toks in (("generate_capture", out_capture[:, t_tokens:]),
                       ("generate_replay", new), ("graph_decode", alone)):
        if not torch.equal(toks, eager):
            faults.append(f"{name} tokens differ from the eager loop's at "
                          f"{torch.nonzero(toks != eager).tolist()[:8]}")
    for name, run in runs.items():
        if run["launches"] != want or any(
                run["materialize_counts"].get(k, 0) != v
                for k, v in packed_want.items()) or (
                dispatch_want is not None
                and run["dispatch_counts"] != dispatch_want) or (
                kernel_want is not None
                and matmul_kernels(run["kernel_launches"]) != kernel_want):
            faults.append(f"{name}: launches {run['launches']} (want "
                          f"{want}), by kernel {run['kernel_launches']} "
                          f"(want {kernel_want}), materialize "
                          f"{run['materialize_counts']}"
                          f" (want {packed_want}), dispatch "
                          f"{run['dispatch_counts']} (want {dispatch_want})")
    if [r["captures"] for r in runs.values()] != [0, 1, 0]:
        faults.append("captures (eager, first, second generate) "
                      f"{[r['captures'] for r in runs.values()]}, want "
                      "[0, 1, 0]")
    if faults:
        raise AssertionError(f"{cfg.name} main path: {faults}")
    return e2e


def engine_requests(cfg):
    """The engine phase's requests from the seed: (prompt lengths, prompts,
    budgets, cumulative Poisson(1.5) arrival ticks)."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, ENGINE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    budgets = rng.integers(ENGINE_NEW_MIN, ENGINE_NEW_MAX + 1,
                           ENGINE_REQUESTS)
    arrivals = np.concatenate([[0], np.cumsum(
        rng.poisson(1.5, ENGINE_REQUESTS - 1))])
    return lens, prompts, budgets, arrivals


def engine_phase(rt, cfg, state, device, dispatch="fused",
                 slots=ENGINE_SLOTS, refs=None):
    """Request-level serving: ENGINE_REQUESTS greedy requests (prompt
    lengths in PROMPT_MIN–PROMPT_MAX and budgets in ENGINE_NEW_MIN–
    ENGINE_NEW_MAX from the seed) arriving at cumulative Poisson(1.5)
    ticks into ``Engine`` (``slots`` slots of ENGINE_MAX_LEN tokens, pages
    of ENGINE_PAGE), drained.  Counts are zeroed just before the drain and
    read just after.  Gates: every request ends as one ``Completion`` with
    ``finished == 'max_new'``, its tokens bitwise equal to ``generate`` of
    its prompt alone at the pool's length (a tick runs all ``slots`` rows:
    the decode kernels at M = slots); at ENGINE_SLOTS all slots occupied
    at once (above, more than ENGINE_SLOTS rows live in a tick) and a
    request joined mid-decode; one capture of the generate step; the
    launches of (ticks + admissions) decode steps and prefills, by kernel
    (K1's decode kernel every tick, its tensor-core kernel at every
    admission, K5's decode kernel ⌈slots / 4⌉ launches a tick), each K1
    launch one ``dispatch`` (its probe: 'fused', or 'tiled_fused' for a
    tiled state; None for a quant-mode state, whose projections all launch
    K5 and dispatch nothing); no weight materialized; every page back on
    the free list.  ``refs``: a dict of generate's tokens by request,
    filled on the first call and compared against after.  Raises on any
    difference; → the numbers."""
    _build, L, ops, E = rt["_build"], rt["L"], rt["ops"], rt["engine"]
    lens, prompts, budgets, arrivals = engine_requests(cfg)
    eng = rt["Engine"](rt["ServeContext"](cfg, lut=state.lut), state.params,
                       n_slots=slots, max_len=ENGINE_MAX_LEN,
                       page_size=ENGINE_PAGE)
    prefill_s, tick_s = [], []
    prefill = eng._prefill

    def timed_prefill(*args):         # its first-token read synchronizes
        t = time.perf_counter()
        out = prefill(*args)
        prefill_s.append(time.perf_counter() - t)
        return out

    eng._prefill = timed_prefill
    for c in (_build.LAUNCH_COUNTS, _build.KERNEL_COUNTS,
              L.MATERIALIZE_COUNTS, ops.DISPATCH_COUNTS, E.CAPTURE_COUNTS):
        c.clear()
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = 0
    while done < ENGINE_REQUESTS or eng.health()["occupied"] \
            or eng.health()["queued"]:
        while done < ENGINE_REQUESTS and eng.steps >= arrivals[done]:
            eng.submit(rt["Request"](tokens=prompts[done],
                                     max_new=int(budgets[done]), rid=done))
            done += 1
        n_pre = len(prefill_s)
        t = time.perf_counter()
        eng.step()                    # a tick ends on its token read
        if len(prefill_s) == n_pre and eng.stats["occupancy"][-1]:
            tick_s.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCH_COUNTS)
    kernel_counts = dict(_build.KERNEL_COUNTS)
    materialized = dict(L.MATERIALIZE_COUNTS)
    dispatched = dict(ops.DISPATCH_COUNTS)
    captures = E.CAPTURE_COUNTS["generate_step"]
    peak = torch.cuda.max_memory_allocated(device)
    h = eng.health()
    ticks = sum(1 for o in eng.stats["occupancy"] if o)
    n_tokens = sum(c.n_generated for c in eng.completions)
    info = {"model": cfg.name, "layers": cfg.n_layers,
            "slots": slots, "page_size": ENGINE_PAGE,
            "max_len": eng.pool.max_len, "requests": ENGINE_REQUESTS,
            "prompt_lens": lens.tolist(), "max_new": budgets.tolist(),
            "arrivals": arrivals.tolist(), "ticks": ticks,
            "steps": eng.steps, "generated_tokens": n_tokens,
            "drain_ms": drain_s * 1e3, "tokens_per_s": n_tokens / drain_s,
            "tick_ms_median": float(np.median(tick_s)) * 1e3,
            "ticks_timed": len(tick_s),
            "prefill_ms_median": float(np.median(prefill_s)) * 1e3,
            "prefill_ms_each": [t * 1e3 for t in prefill_s],
            "capture_ms": eng.capture_ms,
            "pool_device_bytes": eng.pool.device_bytes(),
            "peak_mem_bytes": peak, "launches": launches,
            "kernel_launches": kernel_counts,
            "materialize_counts": materialized, "dispatch": dispatched,
            "captures": captures, "health": h}
    faults = []
    by_rid = {}
    for c in eng.completions:
        if c.rid in by_rid:
            faults.append(f"request {c.rid} completed twice")
        by_rid[c.rid] = c
    mismatched = []
    refs = {} if refs is None else refs
    for i, p in enumerate(prompts):
        c = by_rid.get(i)
        if c is None or c.finished != "max_new":
            faults.append(f"request {i}: {c and c.finished}")
            continue
        if i not in refs:
            refs[i] = rt["generate"](
                state.params, cfg, torch.as_tensor(p)[None], lut=state.lut,
                max_new=int(budgets[i]), max_len=eng.pool.max_len,
                device=device)[0].cpu().numpy()
        if not np.array_equal(c.tokens, refs[i]):
            mismatched.append(i)
    info["requests_not_bitwise_equal_to_generate"] = mismatched
    if mismatched:
        faults.append(f"requests {mismatched} differ from generate")
    n_steps = ticks + ENGINE_REQUESTS
    proj = 7 * cfg.n_layers * n_steps
    # above 16 slots a tick's K1 runs its decode kernel once a group of 16
    # rows (one dispatch a projection)
    k1_groups = -(-slots // 16)
    # a tick's M = slots: K5 (the head; in quant mode every projection)
    # on its decode kernel, one launch a group of 4 rows; an admission's
    # head at M = 1, its projections at the prompt's length (> 16: the
    # tensor-core kernels)
    groups = -(-slots // 4)
    tick_proj = 7 * cfg.n_layers * ticks
    admit_proj = 7 * cfg.n_layers * ENGINE_REQUESTS
    head = groups * ticks + ENGINE_REQUESTS
    want_launches = {"fused_decode_matmul": proj + (k1_groups - 1)
                     * tick_proj, "dequant_matmul": head,
                     "flash_attention": cfg.n_layers * ENGINE_REQUESTS}
    want_kernels = {"fused_decode_matmul:decode": k1_groups * tick_proj,
                    "fused_decode_matmul:mma": admit_proj,
                    "dequant_matmul:decode": head}
    want_dispatch = {dispatch: proj}
    if dispatch is None:
        want_launches = {"dequant_matmul": groups * tick_proj + admit_proj
                         + head,
                         "flash_attention": cfg.n_layers * ENGINE_REQUESTS}
        want_dispatch = {}
        want_kernels = {"dequant_matmul:mma": admit_proj,
                        "dequant_matmul:decode": groups * tick_proj + head}
    if matmul_kernels(kernel_counts) != want_kernels:
        faults.append(f"by kernel {kernel_counts}, want {want_kernels}")
    if launches != want_launches:
        faults.append(f"launches {launches}, want {want_launches}")
    if dispatched != want_dispatch:
        faults.append(f"dispatch {dispatched}, want {want_dispatch}")
    if materialized:
        faults.append(f"materialized {materialized}")
    if captures != 1:
        faults.append(f"{captures} captures of the generate step, want 1")
    if not (h["occupancy_max"] == slots if slots == ENGINE_SLOTS
            else h["occupancy_max"] > ENGINE_SLOTS) \
            or h["joined_mid_decode"] < 1:
        faults.append(f"occupancy_max {h['occupancy_max']}, joined mid-"
                      f"decode {h['joined_mid_decode']}")
    if len(eng.pool.free_pages) != eng.pool.n_pages:
        faults.append(f"{len(eng.pool.free_pages)} of {eng.pool.n_pages} "
                      "pages free after the drain")
    log(f"engine {cfg.name} " + json.dumps(info))
    if faults:
        raise AssertionError(f"{cfg.name} engine: {faults}")
    return info


# The rows phase (Llama-3.2-1B): generate's batches and the engine's slots
# above the fixed batch's 4, and the M of its kernel rows (K1, K3, K5).
ROWS_BATCHES = (8, 16, 32)
ROWS_M = (5, 8, 16, 32)


def rows_check(call, plain, m, k, gen, device, lead=()):
    """One kernel call at M = ``m`` rows of x (after ``lead`` dims; the
    row axis is the last but one): bitwise equal to ``plain`` on integer
    x, within MATMUL_RTOL on random x, and each row of the random-x output
    bitwise that row computed alone (M = 1: what makes an engine tick of m
    slots give generate's tokens).  → (row fields, the random x)."""
    xi = torch.randint(-4, 5, (*lead, m, k), generator=gen, device=device
                       ).to(torch.bfloat16)
    same = bool(torch.equal(call(xi, torch.bfloat16),
                            plain(xi, torch.bfloat16)))
    xr = torch.randn((*lead, m, k), generator=gen, device=device
                     ).to(torch.bfloat16)
    yk, yp = call(xr, torch.float32), plain(xr, torch.float32)
    err = float((yk - yp).abs().max())
    tol = MATMUL_RTOL * float(yp.abs().max())
    alone = all(torch.equal(yk[..., i:i + 1, :],
                            call(xr[..., i:i + 1, :], torch.float32))
                for i in range(m))
    if not (same and alone and err <= tol and torch.isfinite(yk).all()):
        raise AssertionError(f"M={m}: bitwise={same} rows_alone={alone} "
                             f"err={err} tol={tol}")
    return {"bitwise": same, "rows_equal_alone": alone,
            "max_abs_err": err}, xr


# Dense-weight decode rows (MoE's router; every projection in dense mode):
# the M of ``layers.linear``'s GEMMs of 16 rows, the last piece padded
DENSE_ROWS_M = (5, 16, 17, 24, 32, 64)


def dense_rows(rt, w, what, device, gen) -> dict:
    """``layers.linear`` on a dense bf16 weight ``w`` at a decode step's
    rows, x (M, 1, K) bf16 at each M of DENSE_ROWS_M: every row bitwise
    that row alone (M = 1), and the output within MATMUL_RTOL of the f32
    product plus bf16's rounding of it (2⁻⁸ of each value).  → the
    numbers; raises where a row differs."""
    lin = rt["L"].linear
    w = w.to(torch.bfloat16)
    out = {"weight": what, "shape": list(w.shape), "rows_differing": {},
           "max_abs_err": 0.0}
    for m in DENSE_ROWS_M:
        x = torch.randn((m, 1, w.shape[1]), generator=gen, device=device
                        ).to(torch.bfloat16)
        y = lin(x, w, decode=True)
        out["rows_differing"][m] = [i for i in range(m) if not torch.equal(
            y[i:i + 1], lin(x[i:i + 1], w, decode=True))]
        ref = x.float() @ w.float().T
        err = (y.float() - ref).abs()
        tol = MATMUL_RTOL * ref.abs().max() + ref.abs() * 2.0 ** -8
        out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
        if out["rows_differing"][m] or not bool((err <= tol).all()):
            raise AssertionError(f"dense rows {what}: {out}")
    return out


def rows_kernels(rt, cfg, state, device, gen, timer):
    """Kernel rows at decode M = 5, 8, 16, 32 (``ROWS_M``) for K1 on Llama's 7
    projections (timed walking the 16 layers' planes; one row per M, the
    layer's 7 summed) and K5 on the head: each through ``rows_check``,
    with the plan's kernel, ms, bound, plain ms and ``torch.matmul``'s ms
    on the bf16 weight.  → kernels rows."""
    fdm = rt["fdm"]
    lut = state.lut
    blocks = state.params["blocks"]
    rows = {m: {"name": fdm.NAME, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/"
                          "fused_decode_matmul.cu",
                "replaces": "src/repro/kernels/fused_decode_matmul.py:114",
                "timed_at": f"one layer's 7 projections, M={m}",
                "bitwise": True, "rows_equal_alone": True,
                "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "bound_ms": 0.0, "library_ms": 0.0, "bound_by": "bytes",
                "library": "torch.matmul on the bf16 weight", "detail": []}
            for m in ROWS_M}
    for grp, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                      ("attn", "wo"), ("mlp", "w_gate"), ("mlp", "w_up"),
                      ("mlp", "w_down")):
        ws = [b[grp][name] for b in blocks]
        w = ws[0]
        n, k = w.shape
        args = (w.codes, w.literals, lut, w.scale, w.zero)
        kw = dict(shape=w.shape, tile_n=w.tile_n, tile_k=w.tile_k)
        wbs = [wl.materialize(lut, torch.bfloat16) for wl in ws]
        for m in ROWS_M:
            fields, xr = rows_check(
                lambda x, dt: fdm.fused_decode_matmul(x, *args, **kw,
                                                      out_dtype=dt,
                                                      decode=True),
                lambda x, dt: fdm.fused_decode_matmul_plain(
                    x, *args, **kw, out_dtype=dt), m, k, gen, device)
            b, by = bound_ms(nbytes(xr, *args) + m * n * 2, 2.0 * m * n * k)
            t = {"proj": name, "N": n, "K": k, "M": m, **fields,
                 "ms": timer.graph_ms([lambda wl=wl: fdm.fused_decode_matmul(
                     xr, wl.codes, wl.literals, lut, wl.scale, wl.zero,
                     **kw, decode=True) for wl in ws]),
                 "plain_ms": timer.ms(lambda: fdm.fused_decode_matmul_plain(
                     xr, *args, **kw, out_dtype=torch.bfloat16)),
                 "library_ms": timer.graph_ms([lambda wb=wb: xr @ wb.T
                                               for wb in wbs]),
                 "bound_ms": b, "bound_by": by,
                 **launch_info(fdm, m, w, 1, decode=True)}
            row = rows[m]
            for f in ("ms", "plain_ms", "bound_ms", "library_ms"):
                row[f] += t[f]
            for f in ("bitwise", "rows_equal_alone"):
                row[f] = row[f] and t[f]
            row["max_abs_err"] = max(row["max_abs_err"], t["max_abs_err"])
            row["detail"].append(t)
            row.setdefault("launch", {f: t[f] for f in (
                "kernel", "grid", "threads", "smem_bytes", "row_groups")
                if f in t})
        del wbs
    head = state.params.get("lm_head", state.params["embed"])
    wb = head.materialize(torch.bfloat16)
    n, k = head.values.shape
    out = list(rows.values())
    dqm = rt["dqm"]
    for m in ROWS_M:
        fields, _ = rows_check(
            lambda x, dt: dqm.dequant_matmul(x, head.values, head.scale,
                                             head.zero, dt, decode=True),
            lambda x, dt: dqm.dequant_matmul_plain(x, head.values,
                                                   head.scale, head.zero,
                                                   dt), m, k, gen, device)
        out.append({**K5_ROW, **check_k5(rt, head.values, head.scale,
                                         head.zero, wb, m, gen, timer,
                                         decode=True),
                    **fields, "timed_at": f"LM head {n}x{k}, M={m}"})
    return out


def rows_phase(rt, cfg, state, device, engine_refs, gen, timer, kernels,
               faults):
    """5–32 rows on Llama-3.2-1B at full width, where K1's decode kernel
    runs four row groups (above 16 rows a launch a group of 16) and K5's
    decode kernel one launch a group of 4 rows: ``generate`` at batch 8,
    16 and 32 (``serve``'s gates: the eager loop, two generates bitwise to
    it, one capture, the launches by kernel), its prefill, capture and
    decode ms a step graphed; the engine phase's requests through the
    engine at 8, 16 and 32 slots, each completion bitwise the
    ``generate``-alone tokens the engine phase computed; layer 0's w_gate
    as dense mode holds it through ``layers.linear`` (``dense_rows``); and
    the kernel rows at M = 5, 8, 16, 32 (``rows_kernels``).  → the
    numbers."""
    info = {"generate": {}, "engine": {}}
    L = cfg.n_layers
    for b in ROWS_BATCHES:
        batch, lens = make_prompts(cfg.vocab_size, b)
        groups, k1_groups = -(-b // 4), -(-b // 16)
        e2e = serve(rt, cfg, state, device, batch, lens, want={
            "fused_decode_matmul": 7 * L * (1 + k1_groups * (MAX_NEW - 1)),
            "dequant_matmul": groups * MAX_NEW, "flash_attention": L},
            packed_want={"packed": 0}, kernel_want={
                "fused_decode_matmul:mma": 7 * L,
                "fused_decode_matmul:decode": 7 * L * k1_groups
                * (MAX_NEW - 1),
                "dequant_matmul:decode": groups * MAX_NEW})
        info["generate"][b] = {
            f: e2e[f] for f in ("prompt_lens", "prefill_ms", "capture_ms",
                                "decode_ms_per_step", "decode_tokens_per_s",
                                "eager_decode_ms_per_step", "peak_mem_bytes",
                                "launches", "kernel_launches")}
    for slots in ROWS_BATCHES:
        eng = engine_phase(rt, cfg, state, device, slots=slots,
                           refs=engine_refs)
        info["engine"][slots] = {
            f: eng[f] for f in ("ticks", "tokens_per_s", "tick_ms_median",
                                "prefill_ms_median", "capture_ms",
                                "kernel_launches", "health",
                                "requests_not_bitwise_equal_to_generate")}
    info["dense_rows"] = dense_rows(
        rt, state.params["blocks"][0]["mlp"]["w_gate"].materialize(
            state.lut, torch.bfloat16), "layer 0 w_gate (dense mode)",
        device, gen)
    rows = rows_kernels(rt, cfg, state, device, gen, timer)
    for row in rows:
        m = int(row["timed_at"].rsplit("M=", 1)[1])
        b = min(bb for bb in ROWS_BATCHES if bb >= m)
        row["path"] = f"{cfg.name} rows"
        row["launches"] = info["generate"][b]["launches"].get(row["name"], 0)
        row["launches_by_kernel"] = by_kernel(
            info["generate"][b]["kernel_launches"], row["name"])
        row["launches_of"] = f"generate at batch {b}"
    kernels.extend(rows)
    info["kernel_rows"] = [{f: r.get(f) for f in (
        "name", "timed_at", "ms", "bound_ms", "plain_ms", "library_ms",
        "bitwise", "rows_equal_alone", "max_abs_err")} for r in rows]
    return info


# ---------------------------------------------------------------------------
# Integrity and the resilience ladder.
# ---------------------------------------------------------------------------

def unlevered(rt, what: str, failed: list):
    """A phase other than the resilience phase must end with the dispatch
    lever unset and no fallback counted."""
    ops, res = rt["ops"], rt["resilience"]
    if ops._DEFAULT_IMPL != "auto" or res.FALLBACK_COUNTS:
        log(f"{what}: lever {ops._DEFAULT_IMPL}, fallbacks "
            f"{dict(res.FALLBACK_COUNTS)}")
        failed.append(f"{what}: lever set or fallbacks counted")


def counted_run(rt, fn):
    """fn() with the launch, dispatch, materialize, capture and fallback
    counters zeroed just before and read just after; → (out, run)."""
    _build, L, ops, E, R = (rt["_build"], rt["L"], rt["ops"], rt["engine"],
                            rt["resilience"])
    counters = (_build.LAUNCH_COUNTS, _build.KERNEL_COUNTS,
                ops.DISPATCH_COUNTS, L.MATERIALIZE_COUNTS, E.CAPTURE_COUNTS,
                R.FALLBACK_COUNTS)
    for c in counters:
        c.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {"s": time.perf_counter() - t0,
                 "launches": dict(_build.LAUNCH_COUNTS),
                 "kernel_launches": dict(_build.KERNEL_COUNTS),
                 "dispatch": dict(ops.DISPATCH_COUNTS),
                 "materialized": dict(L.MATERIALIZE_COUNTS),
                 "captures": dict(E.CAPTURE_COUNTS),
                 "fallbacks": dict(R.FALLBACK_COUNTS)}


def integrity_checks(rt, state, device, faults):
    """verify_serve_state fast and full and check_invariants (timed), one
    seeded code-bit flip named by 'full' and refused by the gate."""
    I, R = rt["integrity"], rt["resilience"]
    info = {"manifest_s": state.manifest["build_s"],
            "manifest_bytes": state.manifest["total_bytes"],
            "manifest_leaves": len(state.manifest["leaves"])}
    for level in ("fast", "full"):
        t0 = time.perf_counter()
        rep = I.verify_serve_state(state, level=level)
        info[f"verify_{level}_s"] = time.perf_counter() - t0
        info[f"verify_{level}_bytes_hashed"] = rep.bytes_hashed
        if not rep.ok:
            faults.append(f"verify {level}: {rep.summary()}")
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = I.check_invariants(state)
        ms.append((time.perf_counter() - t0) * 1e3)
        if not rep.ok:
            faults.append(f"check_invariants: {rep.summary()}")
    info["check_invariants_ms"] = sorted(ms)[1]
    info["invariant_leaves"] = rep.checked
    bad, name = rt["FaultInjector"](SEED).flip_bit(state, "", plane="codes")
    rep = I.verify_serve_state(bad, level="full")
    info["flipped_leaf"] = name
    info["flip_named"] = rep.quarantined == [name]
    try:
        R.ResilientEngine(None, bad, policy=R.ResiliencePolicy(
            verify="full"), device=device)
        info["flip_refused"] = False
    except I.IntegrityError as e:
        info["flip_refused"] = e.report.quarantined == [name]
    R.FALLBACK_COUNTS.clear()         # the refusal's 'integrity_refused'
    if not (info["flip_named"] and info["flip_refused"]):
        faults.append(f"flipped code bit in {name}: named "
                      f"{rep.quarantined}, refused {info['flip_refused']}")
    return info


def top2_gap(rt, cfg, state, ids, toks, row, step):
    """The fused rung's top-2 logit gap of request ``row`` at decode
    ``step`` (0: the prefill's token), teacher-forced on ``toks``."""
    prefill, decode_step = rt["make_serve_fns"](cfg, device=ids.device)
    b, t0 = ids.shape
    caches = rt["LM"].init_caches(cfg, b, t0 + MAX_NEW, device=ids.device)
    logits, caches = prefill(state.params, state.lut, {"tokens": ids},
                             caches)
    for i in range(step):
        logits, caches = decode_step(state.params, state.lut,
                                     toks[:, i:i + 1], caches, t0 + i)
    top = torch.topk(logits[row].float(), 2).values
    return float(top[0] - top[1])


def compare_rung_tokens(rt, cfg, state, ids, fused, got, rung, faults):
    """``got`` must equal the fused rung's tokens, or first differ at a
    step where the fused logits' top-2 gap is within RUNG_LOGIT_ATOL (a
    near tie that the rungs' other order of sums may resolve the other
    way).  → the report."""
    diff = torch.nonzero(got != fused)
    if diff.numel() == 0:
        return {"tokens_equal": True}
    row, step = (int(v) for v in diff[torch.argmin(diff[:, 1])])
    gap = top2_gap(rt, cfg, state, ids, fused, row, step)
    out = {"tokens_equal": False, "first_diff": [row, step],
           "fused_top2_gap": gap}
    if gap > RUNG_LOGIT_ATOL:
        faults.append(f"{rung} tokens differ from fused at request {row} "
                      f"step {step}, fused top-2 gap {gap}")
    return out


def check_unfused_kernels(rt, w, lut, device, gen, timer, m_prefill, run):
    """K4 and K5 at the unfused rung's call sites, on the largest Llama
    projection (w_gate, 8192 × 2048): K4 decodes its planes (bitwise
    against the plain version, two calls equal); K5 multiplies the decoded
    weight at M = batch and at the prefill's M (bitwise on integer x,
    within MATMUL_RTOL on random x).  Timed as CUDA-graph replays with the
    L2 wiped before each call (planes and weight fit it).  Launches from
    the unfused rung's ``run`` (counted_run)."""
    ddc, dqm = rt["ddc"], rt["dqm"]
    launches = run["launches"]
    codes, lits = w.codes, w.literals
    got = ddc.dict_decode(codes, lits, lut)
    same = bool(torch.equal(got, ddc.dict_decode_plain(codes, lits, lut))
                and torch.equal(got, ddc.dict_decode(codes, lits, lut)))
    if not same:
        raise AssertionError("K4 on w_gate differs from its plain version "
                             "or between two calls")
    nb, slots = codes.shape
    cap = lits.shape[1]
    lut_rows = torch.unique(codes[codes != -1]).numel()     # -1: escape
    moved = (nb * slots * 2 + int(w.nlit.clamp(max=cap).sum()) * 4
             + lut_rows * lut.shape[1] + nb * slots * 4)
    b, by = bound_ms(moved, 0.0)
    k4 = {"name": "dict_decode", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/dict_decode.cu",
          "replaces": "src/repro/kernels/dict_decode.py:44",
          "call_site": "unfused rung: ops.decode_dequant_matmul",
          "bitwise": same, "max_abs_err": 0.0,
          "timed_at": f"Llama w_gate {tuple(w.shape)}, {nb} blocks of "
                      f"{slots} slots",
          "ms": timer.graph_ms([lambda: ddc.dict_decode(codes, lits, lut)],
                               reps=20, cold=True),
          "plain_ms": timer.ms(lambda: ddc.dict_decode_plain(codes, lits,
                                                             lut)),
          "library_ms": None,
          "library": "none: no single PyTorch call decodes the dictionary",
          "bound_ms": b, "bound_by": by, "bytes": moved,
          "launches": launches.get("dict_decode", 0)}
    wq = w.materialize_int8(lut)
    n, k = wq.shape
    wb = w.materialize(lut, torch.bfloat16)
    dec, pre = (check_k5(rt, wq, w.scale, w.zero, wb, m, gen, timer)
                for m in (BATCH, m_prefill))
    k5 = {**K5_ROW, "call_site": "unfused rung: ops.decode_dequant_matmul",
          "bitwise": dec["bitwise"] and pre["bitwise"],
          "max_abs_err": max(dec["max_abs_err"], pre["max_abs_err"]),
          "timed_at": f"decoded Llama w_gate {n}x{k}, M={BATCH}",
          "library": "torch.matmul on the bf16 dense weight",
          **{f: dec[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by", "launch")},
          **{f"prefill_{f}": pre[f] for f in ("ms", "plain_ms", "library_ms",
                                              "bound_ms", "bound_by",
                                              "launch")},
          "prefill_timed_at": f"the same weight at M={m_prefill}",
          "launches": launches.get("dequant_matmul", 0),
          "launches_by_kernel": by_kernel(run["kernel_launches"],
                                          dqm.NAME)}
    return [k4, k5]


def ladder_runs(rt, reng, generate):
    """``generate`` (a ResilientEngine call) three times, counted: clean
    (the fused rung), under decode_fault(nth=1) (the unfused rung) and
    under failing(times=2) at the request seam (materialize).  → (runs
    with their last rung, new tokens), both by rung."""
    R, FI = rt["resilience"], rt["FaultInjector"]
    runs, toks = {}, {}
    toks["fused"], runs["fused"] = counted_run(rt, generate)
    runs["fused"]["last_rung"] = reng.last_rung
    with FI(SEED).decode_fault(nth=1):
        toks["unfused"], runs["unfused"] = counted_run(rt, generate)
    runs["unfused"]["last_rung"] = reng.last_rung
    orig = R._generate
    R._generate = FI(SEED).failing(orig, times=2)
    try:
        toks["materialize"], runs["materialize"] = counted_run(rt, generate)
    finally:
        R._generate = orig
    runs["materialize"]["last_rung"] = reng.last_rung
    return runs, toks


def resilience_phase(rt, cfg, state, device, batch, gen, timer, faults):
    """Llama-3.2-1B at full width: the integrity checks; ResilientEngine
    .generate clean (fused), under decode_fault(nth=1) (unfused: K4 then
    K5 for every projection) and under failing(times=2) at the request
    seam (materialize), each run's counts zeroed before it and read after
    it, tokens compared with the clean run; each rung's prefill ms and
    decode ms a step; one scheduler drain with a poisoned slot; one
    request preempted after RESUME_AFTER tokens and resumed.  → (info,
    the K4 and K5 rows at the unfused rung's call sites)."""
    R = rt["resilience"]
    t_prefill = batch.shape[1]
    ids = torch.as_tensor(batch, device=device)
    n = cfg.n_layers
    info = integrity_checks(rt, state, device, faults)
    t0 = time.perf_counter()
    reng = R.ResilientEngine(cfg, state, policy=R.ResiliencePolicy(
        max_retries=0, verify="fast"), device=device)
    info["gate_s"] = time.perf_counter() - t0

    def generate():
        return reng.generate(batch, max_new=MAX_NEW)[:, t_prefill:]

    want = {"fused": {"fused_decode_matmul": 7 * n * MAX_NEW,
                      "dequant_matmul": MAX_NEW, "flash_attention": n},
            "unfused": {"dict_decode": 7 * n * MAX_NEW,
                        "dequant_matmul": (7 * n + 1) * MAX_NEW,
                        "flash_attention": n},
            "materialize": {"dequant_matmul": MAX_NEW, "flash_attention": n}}
    runs, toks = ladder_runs(rt, reng, generate)
    for rung, run in runs.items():
        fallbacks = {"fused": {}, "unfused": {"unfused": 1},
                     "materialize": {"unfused": 1, "materialize": 1}}[rung]
        if (run["launches"] != want[rung] or set(run["dispatch"]) != {rung}
                or run["fallbacks"] != fallbacks
                or run["last_rung"] != rung):
            faults.append(f"{rung} run: launches {run['launches']} (want "
                          f"{want[rung]}), dispatch {run['dispatch']}, "
                          f"fallbacks {run['fallbacks']}, last rung "
                          f"{run['last_rung']}")
        if rung != "fused":
            run.update(compare_rung_tokens(rt, cfg, state, ids,
                                           toks["fused"], toks[rung], rung,
                                           faults))
    if not torch.equal(toks["fused"], rt["generate"](
            state.params, cfg, batch, lut=state.lut, max_new=MAX_NEW,
            device=device)[:, t_prefill:]):
        faults.append("ResilientEngine's fused tokens differ from generate's")
    info["runs"] = runs
    info["health"] = {k: v for k, v in reng.health().items()
                      if k != "dispatch"}
    info["rungs"] = rung_times(rt, cfg, state, device, ids, faults)
    info["rung_logit_atol"] = RUNG_LOGIT_ATOL
    rt["resilience"].FALLBACK_COUNTS.clear()
    info["engine"] = poisoned_drain(rt, cfg, state, device, faults)
    info["resume"] = preempted_resume(rt, cfg, state, device, faults)
    return info


def rung_times(rt, cfg, state, device, ids, faults):
    """Each rung alone (a ladder of one rung): prefill ms (median of 3)
    and its last-position logits against the fused rung's; decode ms a
    step from replays of the rung's captured graph (after a prefill)."""
    R, E, LM = rt["resilience"], rt["engine"], rt["LM"]
    batch = ids.cpu().numpy()
    t_prefill = ids.shape[1]
    rungs, fused_logits = {}, None
    for rung in ("fused", "unfused", "materialize"):
        r = R.ResilientEngine(cfg, state, policy=R.ResiliencePolicy(
            ladder=(rung,)), device=device)
        pre = []
        for _ in range(3):
            caches = LM.init_caches(cfg, BATCH, t_prefill + MAX_NEW,
                                    device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = r.prefill({"tokens": ids}, caches)
            pre.append((time.perf_counter() - t0) * 1e3)
        logits = logits.float()
        if fused_logits is None:
            fused_logits = logits
        err = float((logits - fused_logits).abs().max())
        r.generate(batch, max_new=MAX_NEW)         # captures its graph
        graph = E.decode_graph(state.params, r._rung_cfg(rung), state.lut,
                               BATCH, t_prefill + MAX_NEW, device=device)
        if graph.graph is None:
            raise AssertionError(f"{rung}: no captured decode graph")
        graph.prefill(state.params, state.lut, ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.decode(state.params, state.lut, MAX_NEW - 1)
        torch.cuda.synchronize()
        rungs[rung] = {"prefill_ms": sorted(pre)[1], "prefill_ms_each": pre,
                       "decode_ms_per_step": (time.perf_counter() - t0)
                       / (MAX_NEW - 1) * 1e3,
                       "prefill_logit_max_abs_diff_vs_fused": err}
        if not (err <= RUNG_LOGIT_ATOL and math.isfinite(err)):
            faults.append(f"{rung} prefill logits differ from fused by "
                          f"{err}")
    return rungs


def poisoned_drain(rt, cfg, state, device, faults):
    """RES_REQUESTS greedy requests through ResilientEngine.scheduler()
    with slot 1 poisoned from its second step on (slot_fault, on every
    rung): exactly one request refused; the survivors resumed and bitwise
    equal to generate of their prompt alone at the pool's length."""
    R = rt["resilience"]
    rng = np.random.default_rng(SEED + 2)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, RES_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(k)) for k in lens]
    reng = R.ResilientEngine(cfg, state, policy=R.ResiliencePolicy(
        max_retries=0), device=device)
    eng = reng.scheduler(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                         page_size=ENGINE_PAGE)
    for i, p in enumerate(prompts):
        eng.submit(rt["Request"](tokens=p, max_new=RES_NEW, rid=i))
    R.FALLBACK_COUNTS.clear()
    t0 = time.perf_counter()
    with rt["FaultInjector"](SEED).slot_fault(slot=1, nth=2):
        while not any(c.finished == "refused" for c in eng.completions):
            eng.step()
    eng.drain()
    info = {"requests": RES_REQUESTS, "prompt_lens": lens.tolist(),
            "max_new": RES_NEW, "drain_s": time.perf_counter() - t0,
            "fallbacks": dict(R.FALLBACK_COUNTS),
            "finished": {c.rid: c.finished for c in eng.completions}}
    refused = [c.rid for c in eng.completions if c.finished == "refused"]
    survivors_equal, info["survivors"] = [], {}
    for c in eng.completions:
        if c.finished != "max_new":
            continue
        want = rt["generate"](state.params, cfg, torch.as_tensor(
            prompts[c.rid])[None], lut=state.lut, max_new=RES_NEW,
            max_len=eng.pool.max_len, device=device)[0].cpu().numpy()
        same = bool(np.array_equal(c.tokens, want))
        survivors_equal.append(same and c.resumed == 1)
        info["survivors"][c.rid] = {
            "resumed": c.resumed, "tokens": c.tokens[len(prompts[c.rid]):]
            .tolist(), "generate": want[len(prompts[c.rid]):].tolist()}
    info["refused"], info["survivors_equal"] = refused, survivors_equal
    if not (refused == [1] and len(survivors_equal) == RES_REQUESTS - 1
            and all(survivors_equal)
            and info["fallbacks"].get("quarantine") == 1):
        faults.append(f"poisoned drain: {info}")
    reng.close()
    R.FALLBACK_COUNTS.clear()
    return info


def preempted_resume(rt, cfg, state, device, faults):
    """A request preempted after RESUME_AFTER tokens on a pool of one
    slot's pages by a higher-priority arrival, then resumed: both
    completions bitwise equal to generate's.  Times the resume (the
    prompt's prefill and RESUME_AFTER - 1 replays of the captured batch-1
    step; cold, with the capture, in the drain, then warm) beside the
    same steps run eagerly and one prefill of prompt and tokens, and
    holds the resumed fragment bitwise against the eager steps' cache."""
    E, LM, R = rt["engine"], rt["LM"], rt["resilience"]
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (PROMPT_MIN, 16)]
    budgets = (RESUME_AFTER + 8, 4)
    eng = rt["Engine"](rt["ServeContext"](cfg, lut=state.lut), state.params,
                       n_slots=2, max_len=ENGINE_MAX_LEN,
                       page_size=ENGINE_PAGE,
                       n_pages=-(-ENGINE_MAX_LEN // ENGINE_PAGE))
    resumes, prefill = [], eng._prefill

    def timed_prefill(toks, replay=()):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = prefill(toks, replay)
        torch.cuda.synchronize()
        if len(replay):
            resumes.append((time.perf_counter() - t) * 1e3)
        return out

    eng._prefill = timed_prefill
    E.CAPTURE_COUNTS.clear()
    R.FALLBACK_COUNTS.clear()
    eng.submit(rt["Request"](tokens=prompts[0], max_new=budgets[0], rid=0))
    for _ in range(RESUME_AFTER - 1):
        eng.step()
    out = list(eng._slots[0].out)
    eng.submit(rt["Request"](tokens=prompts[1], max_new=budgets[1], rid=1,
                             priority=1))
    eng.drain()
    done = {c.rid: c for c in eng.completions}
    equal = []
    for rid, p in enumerate(prompts):
        want = rt["generate"](state.params, cfg, torch.as_tensor(p)[None],
                              lut=state.lut, max_new=budgets[rid],
                              max_len=eng.pool.max_len,
                              device=device)[0].cpu().numpy()
        equal.append(done[rid].finished == "max_new"
                     and np.array_equal(done[rid].tokens, want))
    info = {"prompt_len": len(prompts[0]), "tokens_before": len(out),
            "replayed_steps": len(out) - 1, "resumed": done[0].resumed,
            "bitwise_equal_generate": equal,
            "preempts": R.FALLBACK_COUNTS.get("preempt", 0),
            "resume_captures": E.CAPTURE_COUNTS["resume_step"]}
    warm = []
    for _ in range(3):
        timed_prefill(prompts[0], out[:-1])
        warm.append(resumes.pop())
    toks = np.concatenate([prompts[0], out[:-1]])
    prefill_fn, decode_step = rt["make_serve_fns"](cfg, device=device)
    caches = LM.init_caches(cfg, 1, eng.pool.max_len, torch.bfloat16,
                            device=device)
    ids = torch.as_tensor(prompts[0], device=device)[None]
    rep = torch.as_tensor(out[:-1], device=device).reshape(-1, 1, 1)
    pos = torch.zeros((), dtype=torch.long, device=device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    prefill_fn(state.params, state.lut, {"tokens": ids}, caches)
    pos.fill_(len(prompts[0]))
    for tok in rep:
        decode_step(state.params, state.lut, tok, caches, pos)
        pos.add_(1)
    torch.cuda.synchronize()
    info["eager_ms"] = (time.perf_counter() - t) * 1e3
    same = all(torch.equal(a, b) for a, b in
               zip(E._tensors(eng._frag), E._tensors(caches)))
    one = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill_fn(state.params, state.lut, {"tokens": torch.as_tensor(
            toks, device=device)[None]}, caches)
        torch.cuda.synchronize()
        one.append((time.perf_counter() - t) * 1e3)
    info.update({"cold_ms": resumes[0], "warm_ms": sorted(warm)[1],
                 "warm_ms_each": warm,
                 "one_prefill_of_prompt_and_tokens_ms": sorted(one)[1],
                 "fragment_bitwise_equal_eager": same})
    if not (all(equal) and info["resumed"] == 1 and info["preempts"] == 1
            and info["resume_captures"] == 1 and same and len(resumes) == 1):
        faults.append(f"preempted resume: {info}")
    eng.close()
    R.FALLBACK_COUNTS.clear()
    return info


def moe_rungs(rt, device, batch, faults):
    """DeepSeek-V2-Lite at full width, its dense first layer and one MoE
    layer: pack (with the manifest), the integrity checks, then
    ResilientEngine.generate clean (fused: K1, K3, K4), under
    decode_fault(nth=1) (unfused: the grouped stacks decoded by K4, no K1
    or K3) and under failing(times=2) (materialize: no K1, K3 or K4),
    tokens compared with the fused run's."""
    R = rt["resilience"]
    cfg = dataclasses.replace(
        rt["get_config"]("deepseek-v2-lite-16b").full, n_layers=2)
    state, packing = pack(rt, cfg, device, SEED + 3)
    info = {"model": cfg.name, "layers": cfg.n_layers, **packing,
            **integrity_checks(rt, state, device, faults)}
    t_prefill = batch.shape[1]
    ids = torch.as_tensor(batch, device=device)
    reng = R.ResilientEngine(cfg, state, policy=R.ResiliencePolicy(
        max_retries=0), device=device)

    def generate():
        return reng.generate(batch, max_new=MAX_NEW)[:, t_prefill:]

    runs, toks = ladder_runs(rt, reng, generate)
    kernels = {"fused": {"fused_decode_matmul", "grouped_fused_decode_matmul",
                         "dict_decode", "dequant_matmul", "flash_attention"},
               "unfused": {"dict_decode", "dequant_matmul",
                           "flash_attention"},
               "materialize": {"dequant_matmul", "flash_attention"}}
    for rung, run in runs.items():
        if (set(run["launches"]) != kernels[rung]
                or set(run["dispatch"]) != {rung, "grouped_" + rung}
                or run["last_rung"] != rung
                or run["materialized"].get("packed_stacked", 0)):
            faults.append(f"DeepSeek {rung}: launches {run['launches']}, "
                          f"dispatch {run['dispatch']}, last rung "
                          f"{run['last_rung']}, materialized "
                          f"{run['materialized']}")
        if rung != "fused":
            run.update(compare_rung_tokens(rt, cfg, state, ids,
                                           toks["fused"], toks[rung], rung,
                                           faults))
    info["runs"] = runs
    R.FALLBACK_COUNTS.clear()
    del state
    torch.cuda.empty_cache()
    return info


# ---------------------------------------------------------------------------
# Tiered expert residency and the memory-pressure governor.
# ---------------------------------------------------------------------------

def zero_counts(rt):
    """Zero the launch, materialize, dispatch, capture, fallback and
    residency counters."""
    for c in (rt["_build"].LAUNCH_COUNTS, rt["_build"].KERNEL_COUNTS,
              rt["L"].MATERIALIZE_COUNTS,
              rt["ops"].DISPATCH_COUNTS, rt["engine"].CAPTURE_COUNTS,
              rt["resilience"].FALLBACK_COUNTS,
              rt["residency"].RESIDENCY_COUNTS):
        c.clear()


def pinned_copy_gb_per_s(device) -> float:
    """A plain 256 MiB copy from pinned host memory to the card, host clock
    around it and a synchronize: the fetch rate's yardstick."""
    src = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty_like(src, device=device)
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    return src.numel() / (time.perf_counter() - t0) / 1e9


def expert_plane_bytes(params) -> int:
    """Device bytes of the caller's packed expert stacks (every MoE
    layer's codes, literals, nlit, scale and zero)."""
    return sum(t.numel() * t.element_size()
               for b in params["blocks"] for w in b["moe"]["experts"].values()
               for t in (w.codes, w.literals, w.nlit, w.scale, w.zero))


def residency_phase(rt, cfg, state, device, batch, faults):
    """DeepSeek-V2-Lite at full width under tiered residency: one
    ResidencyManager over the packed state (its pinned host store, the
    manifest checked), then ``generate`` through it (the user's entry
    point: ``tiered_generate``) of the fixed batch, greedy, at each
    capacity of RES_CAPACITIES (set_capacity between them), each run's
    counts zeroed just before it and read just after.  Gates: tokens
    bitwise equal to the fully resident generate's at the same cache
    length; no expert plane materialized; every pass's launches (K3 three
    a MoE layer, K1 six a layer, K4 one a layer, K5 one, K2 one a layer a
    prefill pass).  → (info, K3's launches over the runs)."""
    Res, _build, L = rt["residency"], rt["_build"], rt["L"]
    t_prefill = batch.shape[1]
    max_len = t_prefill + MAX_NEW
    want = rt["generate"](state.params, cfg, batch, lut=state.lut,
                          max_new=MAX_NEW, device=device)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    info = {"model": cfg.name, "layers": cfg.n_layers,
            "pinned_copy_gb_per_s": pinned_copy_gb_per_s(device),
            "caller_expert_planes_device_bytes":
                expert_plane_bytes(state.params)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr = Res.ResidencyManager(state, cfg, capacity=RES_CAPACITIES[0][0])
    info.update(manager_build_s=time.perf_counter() - t0,
                bytes_per_expert=mgr.bytes_per_expert,
                host_store_bytes=mgr.bytes_per_expert * n_moe
                * mgr.n_experts, capacities=[])
    ctx = rt["ServeContext"](cfg, lut=state.lut, residency=mgr)
    run, calls = mgr.run, []

    def timed_run(*a, **kw):          # a prefill or decode step, synced
        t = time.perf_counter()
        out = run(*a, **kw)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t,
                      Res.RESIDENCY_COUNTS["replay"]))
        return out

    join, joins = mgr.join_prefetches, []

    def timed_join():                 # the serving thread's prefetch wait
        t = time.perf_counter()
        join()
        joins.append(time.perf_counter() - t)

    mgr.run, mgr.join_prefetches = timed_run, timed_join
    k3 = 0
    try:
        for cap, n in RES_CAPACITIES:
            mgr.set_capacity(cap)
            mgr.reset_stats()
            calls.clear()
            joins.clear()
            zero_counts(rt)
            torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = rt["generate"](state.params, None, batch, ctx=ctx,
                                 max_new=n, max_len=max_len)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            launches = dict(_build.LAUNCH_COUNTS)
            materialized = dict(L.MATERIALIZE_COUNTS)
            snap = mgr.snapshot()
            passes = n + snap["replay"]
            pre_replays = calls[0][1]
            decode_s = [t for t, _ in calls[1:]]
            row = {"capacity": cap, "new_tokens": n,
                   "bitwise": bool(torch.equal(out, want[:, :t_prefill + n])),
                   "generate_s": total_s, "prefill_ms": calls[0][0] * 1e3,
                   "prefill_replays": pre_replays,
                   "decode_ms_per_step": (float(np.mean(decode_s)) * 1e3
                                          if decode_s else None),
                   "decode_ms_each": [t * 1e3 for t in decode_s],
                   "hits": snap["hit"], "misses": snap["miss"],
                   "prefetch_hits": snap["prefetch_hit"],
                   "prefetch_installed": snap["prefetch_installed"],
                   "replays": snap["replay"], "evictions": snap["evict"],
                   "sync_fetches": snap["sync_fetch"],
                   "bytes_fetched": snap["bytes_fetched"],
                   "stall_s": mgr.stall_s, "crc_s": mgr.crc_s,
                   "prefetch_crc_s": mgr.prefetch_crc_s,
                   "prefetch_join_s": sum(joins),
                   "passes": passes,
                   "demand_fetch_gb_per_s": (
                       snap["sync_fetch"] * mgr.bytes_per_expert
                       / mgr.stall_s / 1e9 if mgr.stall_s else None),
                   "cache_device_bytes": mgr.cache_device_bytes(),
                   "peak_slots": snap["peak_slots"],
                   "peak_ready_bytes": snap["peak_ready_bytes"],
                   "memory_allocated": torch.cuda.memory_allocated(device),
                   "peak_mem_bytes": torch.cuda.max_memory_allocated(device),
                   "launches": launches, "materialize_counts": materialized}
            info["capacities"].append(row)
            k3 += launches.get("grouped_fused_decode_matmul", 0)
            expect = {"grouped_fused_decode_matmul": 3 * n_moe * passes,
                      "fused_decode_matmul": 6 * cfg.n_layers * passes,
                      "dict_decode": cfg.n_layers * passes,
                      "dequant_matmul": passes,
                      "flash_attention": cfg.n_layers * (1 + pre_replays)}
            if not row["bitwise"]:
                faults.append(f"capacity {cap}: tokens differ from the "
                              "resident generate's at "
                              f"{torch.nonzero(out != want[:, :t_prefill + n]).tolist()[:8]}")
            if launches != expect or materialized.get("packed_stacked", 0):
                faults.append(f"capacity {cap}: launches {launches} (want "
                              f"{expect}), materialized {materialized}")
            if cap < mgr.n_experts and not snap["miss"]:
                faults.append(f"capacity {cap}: no miss")
    finally:
        mgr.close()
    del mgr, ctx
    torch.cuda.empty_cache()
    return info, k3


def check_grouped_cache(rt, cfg, state, device, gen, timer, c=RES_CACHE_C):
    """K3 on C-slot cache stacks (C of the first MoE layer's 64 experts in
    a seeded order, its three stacks) at a decode step's cap, planned for
    the layer's 64 experts as the residency manager launches it: bitwise
    against its plain version on integer x and against the full stack's
    rows on random x, within MATMUL_RTOL of the plain version on random x;
    its time (graph replays; the three stacks' planes and bf16 weights
    past the L2 together), the bound of its bytes, the plain version's
    time and torch.bmm's on the same bf16 stacks."""
    fdm, L = rt["fdm"], rt["L"]
    lut = state.lut
    experts = state.params["blocks"][0]["moe"]["experts"]
    e = cfg.n_experts
    m = L._capacity(BATCH, cfg.top_k, e, cfg.capacity_factor)
    idx = torch.as_tensor(np.random.default_rng(SEED).permutation(e)[:c],
                          device=device)
    agg = dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms"), 0.0)
    worst, rows = 0.0, []
    for name in ("w_gate", "w_up", "w_down"):
        w = experts[name]
        sub = dataclasses.replace(w, **{
            p: getattr(w, p).index_select(0, idx).contiguous()
            for p in ("codes", "literals", "nlit", "scale", "zero")})
        n, k = w.shape
        args = (sub.codes, sub.literals, lut, sub.scale, sub.zero)
        kw = dict(shape=w.shape, tile_n=w.tile_n, tile_k=w.tile_k)
        xi = torch.randint(-4, 5, (c, m, k), generator=gen, device=device
                           ).to(torch.bfloat16)
        same = bool(torch.equal(
            fdm.grouped_fused_decode_matmul(xi, *args, **kw,
                                            plan_experts=e),
            fdm.grouped_fused_decode_matmul_plain(
                xi, *args, **kw, out_dtype=torch.bfloat16)))
        xr = torch.randn((e, m, k), generator=gen, device=device
                         ).to(torch.bfloat16)
        xs = xr.index_select(0, idx)
        yk = fdm.grouped_fused_decode_matmul(xs, *args, **kw,
                                             out_dtype=torch.float32,
                                             plan_experts=e)
        full = fdm.grouped_fused_decode_matmul(
            xr, w.codes, w.literals, lut, w.scale, w.zero, **kw,
            out_dtype=torch.float32).index_select(0, idx)
        yp = fdm.grouped_fused_decode_matmul_plain(xs, *args, **kw,
                                                   out_dtype=torch.float32)
        err = float((yk - yp).abs().max())
        tol = MATMUL_RTOL * float(yp.abs().max())
        rows_equal = bool(torch.equal(yk, full))
        worst = max(worst, err)
        if not (same and rows_equal and err <= tol
                and torch.isfinite(yk).all()):
            raise AssertionError(f"K3 cache stack {name} C={c} M={m}: "
                                 f"bitwise={same} rows equal to the full "
                                 f"stack's={rows_equal} err={err} tol={tol}")
        wbt = sub.materialize(lut, torch.bfloat16).transpose(1, 2)
        b, by = bound_ms(nbytes(xs, lut) + plane_bytes(sub) + c * m * n * 2,
                         2.0 * c * m * n * k)
        t = {"stack": name, "C": c, "N": n, "K": k, "M": m,
             "bitwise": same, "rows_equal_full_stack": rows_equal,
             "max_abs_err": err,
             "ms": timer.graph_ms([lambda: fdm.grouped_fused_decode_matmul(
                 xs, *args, **kw, plan_experts=e)] * 4, cold=True),
             "plain_ms": timer.ms(
                 lambda: fdm.grouped_fused_decode_matmul_plain(
                     xs, *args, **kw, out_dtype=torch.bfloat16)),
             "library_ms": timer.graph_ms([lambda: torch.bmm(xs, wbt)] * 4,
                                          cold=True),
             "bound_ms": b, "bound_by": by,
             **launch_info(fdm, m, w, e)}
        rows.append(t)
        for f in agg:
            agg[f] += t[f]
        del wbt
    return {"name": "grouped_fused_decode_matmul (C-slot cache stack)",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_decode_matmul.cu",
            "replaces": "src/repro/kernels/fused_decode_matmul.py:202",
            "bitwise": True, "max_abs_err": worst,
            "timed_at": f"one MoE layer's 3 cache stacks of C={c} of "
                        f"{e} experts, decode cap {m}, planned for {e}",
            "library": "torch.bmm on the materialized bf16 cache stacks",
            **agg, "bound_by": "bytes"}, rows


def governor_phase(rt, cfg, state, device, faults):
    """Llama-3.2-1B at full width: the engine phase's requests drained
    through an Engine with no pressure, then under a MemoryGovernor
    replaying a 'ramp' and an 'oscillate' budget trace (low: GOV_LOW_SLOTS
    slots' pages) through the injector's pressure seam, each drain's
    counts zeroed just before it and read just after.  Gates: every
    request ends as one Completion of an accounted reason; every
    'max_new' survivor bitwise equal to the unpressured drain's;
    CAPTURE_COUNTS['generate_step'] <= 1 + plan changes; each reclaim
    that released a free tail gave its pages' bytes back to the
    allocator.  → info."""
    G, P, _build = rt["governor"], rt["policy"], rt["_build"]
    lens, prompts, budgets, arrivals = engine_requests(cfg)
    accounted = {"eos", "max_new", "shed", "deadline", "refused", "pressure"}

    def drain(gov):
        eng = rt["Engine"](rt["ServeContext"](cfg, lut=state.lut),
                           state.params, n_slots=ENGINE_SLOTS,
                           max_len=ENGINE_MAX_LEN, page_size=ENGINE_PAGE,
                           governor=gov)
        zero_counts(rt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = 0
        while done < ENGINE_REQUESTS or eng.health()["occupied"] \
                or eng.health()["queued"]:
            while done < ENGINE_REQUESTS and eng.steps >= arrivals[done]:
                eng.submit(rt["Request"](tokens=prompts[done],
                                         max_new=int(budgets[done]),
                                         rid=done))
                done += 1
            eng.step()
        torch.cuda.synchronize()
        run = {"drain_ms": (time.perf_counter() - t0) * 1e3,
               "steps": eng.steps,
               "launches": dict(_build.LAUNCH_COUNTS),
               "captures": dict(rt["engine"].CAPTURE_COUNTS),
               "fallbacks": dict(rt["resilience"].FALLBACK_COUNTS),
               "pool_device_bytes": eng.pool.device_bytes(),
               "page_nbytes": eng.pool.page_nbytes(),
               "pages_per_slot": eng.pool.pages_per_slot,
               "n_pages": eng.pool.n_pages, "page_moves": eng.pool.moves}
        comps = {}
        for c in eng.completions:
            if c.rid in comps:
                faults.append(f"request {c.rid} completed twice")
            comps[c.rid] = c
        eng.close()
        return run, comps

    base, base_comps = drain(None)
    info = {"model": cfg.name, "layers": cfg.n_layers,
            "unpressured": base, "traces": {}}
    pn, pps = base["page_nbytes"], base["pages_per_slot"]
    boot = base["n_pages"] * pn
    for kind, kw in (("ramp", {}), ("oscillate", {"period": 2})):
        gov = G.MemoryGovernor(P.device_budget(boot, expert_bytes=0,
                                               kv_bytes=boot),
                               cooldown_steps=GOV_COOLDOWN)
        trace = rt["pressure_trace"](kind, boot_bytes=boot,
                                     low_bytes=GOV_LOW_SLOTS * pps * pn,
                                     n_steps=GOV_STEPS, seed=SEED, **kw)
        released, on_step = [], gov.on_step

        def measured(engine, on_step=on_step, released=released):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(device)
            n = engine.pool.n_pages
            on_step(engine)
            torch.cuda.synchronize()
            if engine.pool.n_pages < n:
                released.append(
                    [before - torch.cuda.memory_allocated(device),
                     (n - engine.pool.n_pages) * pn])

        gov.on_step = measured
        with rt["FaultInjector"]().memory_pressure(trace):
            run, comps = drain(gov)
        reasons = {rid: c.finished for rid, c in comps.items()}
        survivors = [rid for rid, r in reasons.items() if r == "max_new"]
        differ = [rid for rid in survivors if not np.array_equal(
            comps[rid].tokens, base_comps[rid].tokens)]
        captures = run["captures"].get("generate_step", 0)
        run.update(plan_changes=gov.plan_changes, reasons=reasons,
                   survivors=survivors, survivors_not_bitwise=differ,
                   released_bytes_and_pages_bytes=released,
                   events=[(e["step"], e["rung"], e["detail"])
                           for e in gov.events],
                   rung_latency_s=gov.rung_latency,
                   trace_low_bytes=GOV_LOW_SLOTS * pps * pn,
                   boot_bytes=boot)
        info["traces"][kind] = run
        if set(reasons) != set(range(ENGINE_REQUESTS)) or not set(
                reasons.values()) <= accounted:
            faults.append(f"{kind}: completions {reasons}")
        if differ or not survivors:
            faults.append(f"{kind}: survivors {survivors}, not bitwise "
                          f"equal to the unpressured drain: {differ}")
        if not 1 <= captures <= 1 + gov.plan_changes:
            faults.append(f"{kind}: {captures} captures of the tick for "
                          f"{gov.plan_changes} plan changes")
        if any(a != b for a, b in released):
            faults.append(f"{kind}: released (allocator drop, pages' "
                          f"bytes) {released}")
    if not any(r["released_bytes_and_pages_bytes"]
               for r in info["traces"].values()):
        faults.append("no reclaim released a free tail of the pool")
    if any(c.finished != "max_new" for c in base_comps.values()):
        faults.append("unpressured drain: "
                      f"{[c.finished for c in base_comps.values()]}")
    rt["resilience"].FALLBACK_COUNTS.clear()
    return info


def governor_moe(rt, device, faults):
    """DeepSeek-V2-Lite at full width, its dense first layer and one MoE
    layer, served by an Engine under a ResidencyManager (capacity 8) and
    a MemoryGovernor: a budget cut of 5 experts' bytes a layer trims the
    expert cache to 3 and pauses prefetch, and no KV page goes; the
    completions stay bitwise equal to the resident generate's.  → info."""
    G, P, Res = rt["governor"], rt["policy"], rt["residency"]
    full = rt["get_config"]("deepseek-v2-lite-16b").full
    cfg = dataclasses.replace(full, n_layers=2, capacity_factor=float(
        full.n_experts) / full.top_k)
    state, packing = pack(rt, cfg, device, SEED + 5)
    mgr = Res.ResidencyManager(state, cfg, capacity=8)
    unit = mgr.n_layers * mgr.bytes_per_expert
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(PROMPT_MIN, 64, 2)]
    probe = rt["Engine"](rt["ServeContext"](cfg, lut=state.lut),
                         state.params, n_slots=2, max_len=96)
    kv_boot = probe.pool.n_pages * probe.pool.page_nbytes()
    del probe
    gov = G.MemoryGovernor(P.device_budget(
        kv_boot + 8 * unit, expert_bytes=cfg.n_experts * unit,
        kv_bytes=kv_boot), cooldown_steps=2)
    eng = rt["Engine"](rt["ServeContext"](cfg, lut=state.lut, residency=mgr),
                       state.params, n_slots=2, max_len=96, governor=gov)
    zero_counts(rt)
    for i, p in enumerate(prompts):
        eng.submit(rt["Request"](tokens=p, max_new=8, rid=i))
    eng.step()
    before = mgr.cache_device_bytes()
    gov.set_budget(kv_boot + 3 * unit)
    eng.step()
    fb = dict(rt["resilience"].FALLBACK_COUNTS)
    info = {"model": cfg.name, "layers": cfg.n_layers, **packing,
            "unit_bytes": unit, "cache_bytes_before": before,
            "cache_bytes_after": mgr.cache_device_bytes(),
            "capacity": mgr.capacity,
            "prefetch_enabled": mgr.prefetch_enabled,
            "pages_usable": eng.pool.n_pages_usable,
            "n_pages": eng.pool.n_pages, "page_moves": eng.pool.moves,
            "fallbacks": fb}
    if not (mgr.capacity == 3 and not mgr.prefetch_enabled
            and eng.pool.n_pages_usable == eng.pool.n_pages
            and eng.pool.moves == 0 and fb.get("pressure_trim") == 1
            and not fb.get("pressure_kv_retire")
            and mgr.cache_device_bytes() == 3 * unit):
        faults.append(f"DeepSeek governor: {info}")
    eng.drain()
    info["residency"] = mgr.snapshot()
    info["launches"] = dict(rt["_build"].LAUNCH_COUNTS)
    differ = []
    for c in eng.completions:
        want = rt["generate"](state.params, cfg,
                              torch.as_tensor(prompts[c.rid])[None],
                              lut=state.lut, max_new=8,
                              max_len=eng.pool.max_len, device=device)[0]
        if c.finished != "max_new" or not np.array_equal(
                c.tokens, want.cpu().numpy()):
            differ.append(c.rid)
    info["requests_not_bitwise_equal_to_generate"] = differ
    if differ or len(eng.completions) != len(prompts):
        faults.append(f"DeepSeek governor: requests {differ} differ")
    eng.close()
    rt["resilience"].FALLBACK_COUNTS.clear()
    del eng, mgr, state
    torch.cuda.empty_cache()
    return info


# ---------------------------------------------------------------------------
# Column groups: TiledPackedLinear storage and K1 with G > 1.
# ---------------------------------------------------------------------------

def check_fused_groups(rt, lut, projections, untiled, device, m_prefill,
                       gen, timer):
    """K1 over G column groups on each ``(label, [planes per layer],
    in_layer)`` of ``projections`` (one G), against ``untiled`` (the same
    projections' G = 1 planes: the same weights, tiles and blocks) at M =
    batch and M = ``m_prefill``: bitwise equal to its plain version and to
    K1 at G = 1 on integer x, within MATMUL_RTOL of the plain version on
    random x.  Timed as ``check_fused`` times K1 (graph replays walking the
    layers' planes), with K1 at G = 1 on the untiled planes under the same
    timer (``g1_ms``).  → (totals over one layer's projections, rows)."""
    fdm = rt["fdm"]
    rows, worst = [], 0.0
    fields = ("ms", "g1_ms", "plain_ms", "bound_ms", "library_ms")
    agg = dict.fromkeys(fields, 0.0)
    pre = dict.fromkeys(fields, 0.0)
    pre_by, seen = set(), {}
    for (label, ws, in_layer), (_, us, _) in zip(projections, untiled):
        w, u = ws[0], us[0]
        n, k = w.shape
        if (w.tile_n, w.tile_k, w.codes.shape[-1]) != (
                u.tile_n, u.tile_k, u.codes.shape[-1]):
            raise AssertionError(f"{label}: groups tiled {w.tile_n}x"
                                 f"{w.tile_k} ({w.codes.shape[-1]} slots), "
                                 f"untiled {u.tile_n}x{u.tile_k}")
        kw = dict(shape=w.shape, tile_n=w.tile_n, tile_k=w.tile_k)

        def k1(x, p, dt=torch.bfloat16):
            return fdm.fused_decode_matmul(x, p.codes, p.literals, lut,
                                           p.scale, p.zero, **kw,
                                           out_dtype=dt)

        def plain(x, dt=torch.bfloat16):
            return fdm.fused_decode_matmul_plain(x, w.codes, w.literals, lut,
                                                 w.scale, w.zero, **kw,
                                                 out_dtype=dt)
        for m in (BATCH, m_prefill):
            xi = int_x(m, k, gen, device)
            yk = k1(xi, w)
            same_plain = bool(torch.equal(yk, plain(xi)))
            same_g1 = bool(torch.equal(yk, k1(xi, u)))
            xr = rand_x(m, k, gen, device)
            yk, yp = k1(xr, w, torch.float32), plain(xr, torch.float32)
            err = float((yk - yp).abs().max())
            tol = MATMUL_RTOL * float(yp.abs().max())
            worst = max(worst, err)
            if not (same_plain and same_g1 and err <= tol
                    and torch.isfinite(yk).all()):
                raise AssertionError(
                    f"K1 G={w.tiles} {label} {w.shape} M={m}: bitwise "
                    f"plain={same_plain} G=1={same_g1} err={err} tol={tol}")
            key = (n, k, m)
            if key not in seen:
                b, by = bound_ms(nbytes(xr, w.codes, w.literals, lut,
                                        w.scale, w.zero) + m * n * 2,
                                 2.0 * m * n * k)
                wbs = [ul.materialize(lut, torch.bfloat16) for ul in us]
                seen[key] = {
                    "proj": label, "N": n, "K": k, "M": m, "G": w.tiles,
                    "layers": len(ws), "bitwise_plain": same_plain,
                    "bitwise_g1": same_g1, "max_abs_err": err,
                    "ms": timer.graph_ms([lambda p=wl: k1(xr, p)
                                          for wl in ws]),
                    "g1_ms": timer.graph_ms([lambda p=ul: k1(xr, p)
                                             for ul in us]),
                    "plain_ms": timer.ms(lambda: plain(xr)),
                    "library_ms": timer.graph_ms([lambda wb=wb: xr @ wb.T
                                                  for wb in wbs]),
                    "bound_ms": b, "bound_by": by,
                    "tile": [w.tile_n, w.tile_k],
                    **launch_info(fdm, m, w, 1)}
                del wbs
                rows.append(seen[key])
            t = seen[key]
            if in_layer:
                for f in fields:
                    (agg if m == BATCH else pre)[f] += t[f]
                if m == m_prefill:
                    pre_by.add(t["bound_by"])
    return {"max_abs_err": worst, **agg, "bound_by": "bytes",
            **{f"prefill_{f}": v for f, v in pre.items()},
            "prefill_bound_by": "+".join(sorted(pre_by))}, rows


def logits_and_tokens(rt, cfg, state, batch, device):
    """The prefill's last-position logits (f32, on the host) and the
    greedy tokens of ``generate`` for the fixed batch."""
    ids = torch.as_tensor(batch, device=device)
    prefill, _ = rt["make_serve_fns"](cfg, device=device)
    caches = rt["LM"].init_caches(cfg, BATCH, ids.shape[1] + MAX_NEW,
                                  device=device)
    logits, _ = prefill(state.params, state.lut, {"tokens": ids}, caches)
    toks = rt["generate"](state.params, cfg, batch, lut=state.lut,
                          max_new=MAX_NEW, device=device)[:, ids.shape[1]:]
    return logits.float().cpu(), toks


def against_untiled(rt, cfg, tiled, untiled, batch, device, faults):
    """The tiled state's prefill logits within E2E_LOGIT_ATOL of the
    untiled state's; where the greedy tokens first differ (if they do),
    with the untiled logits' top-2 gap there."""
    ids = torch.as_tensor(batch, device=device)
    lt, tt = logits_and_tokens(rt, cfg, tiled, batch, device)
    lu, tu = logits_and_tokens(rt, cfg, untiled, batch, device)
    err = float((lt - lu).abs().max())
    out = {"prefill_logit_max_abs_err": err, "tolerance": E2E_LOGIT_ATOL,
           "logits_bitwise": bool(torch.equal(lt, lu)),
           "tokens_equal": bool(torch.equal(tt, tu))}
    if not (err <= E2E_LOGIT_ATOL and math.isfinite(err)):
        faults.append(f"tiled prefill logits differ from untiled by {err}")
    diff = torch.nonzero(tt != tu)
    if diff.numel():
        row, step = (int(v) for v in diff[torch.argmin(diff[:, 1])])
        out["first_diff"] = [row, step]
        out["untiled_top2_gap"] = top2_gap(rt, cfg, untiled, ids, tu, row,
                                           step)
    return out


def tiled_rungs(rt, cfg, state, device, batch, fused, faults):
    """The tiled state on the unfused and materialize rungs (a ladder of
    one rung each): launches, dispatch and the tokens against the fused
    rung's (``compare_rung_tokens``)."""
    R = rt["resilience"]
    n = cfg.n_layers
    ids = torch.as_tensor(batch, device=device)
    want = {"unfused": {"dict_decode": 7 * n * MAX_NEW,
                        "dequant_matmul": (7 * n + 1) * MAX_NEW,
                        "flash_attention": n},
            "materialize": {"dequant_matmul": MAX_NEW, "flash_attention": n}}
    out = {}
    for rung in ("unfused", "materialize"):
        reng = R.ResilientEngine(cfg, state, policy=R.ResiliencePolicy(
            ladder=(rung,), max_retries=0), device=device)
        toks, run = counted_run(rt, lambda: reng.generate(
            batch, max_new=MAX_NEW)[:, ids.shape[1]:])
        run["last_rung"] = reng.last_rung
        if (run["launches"] != want[rung]
                or run["dispatch"] != {f"tiled_{rung}": 7 * n * MAX_NEW}
                or reng.last_rung != rung):
            faults.append(f"tiled {rung} run: launches {run['launches']} "
                          f"(want {want[rung]}), dispatch {run['dispatch']}"
                          f", last rung {reng.last_rung}")
        run.update(compare_rung_tokens(rt, cfg, state, ids, fused, toks,
                                       rung, faults))
        out[rung] = run
        rt["engine"].drop_graphs(reng._rung_cfg(rung))
    return out


def tiled_phase(rt, cfg, untiled, device, batch, lens, gen, timer,
                kernels, failed):
    """Llama-3.2-1B at full width, packed with CompressionPolicy(tiles=G)
    for G in TILES (the same seeded weights as ``untiled``): K1 with
    column groups at every projection shape against its plain version and
    K1 at G = 1; the main path at each G (the eager loop and ``generate``
    twice, bitwise among themselves, every projection one 'tiled_fused'
    K1 launch, nothing materialized); at TILES[0] the engine drain, the
    prefill logits and greedy tokens against the untiled state's, and the
    unfused and materialize rungs.  Adds one kernels row per G."""
    t_prefill = batch.shape[1]
    n = cfg.n_layers
    names = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
             ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))

    def projections(st):
        return [(name, [b[grp][name] for b in st.params["blocks"]], True)
                for grp, name in names]

    info, faults = {}, []
    for tiles in TILES:
        try:
            st, packing = pack(rt, cfg, device, SEED, tiles=tiles)
            res = info[f"G{tiles}"] = {"packing": packing}
            row, detail = check_fused_groups(
                rt, st.lut, projections(st), projections(untiled), device,
                BATCH * t_prefill, gen, timer)
            res["kernel_rows"] = detail
            e2e = serve(rt, cfg, st, device, batch, lens, want={
                "fused_decode_matmul": 7 * n * MAX_NEW,
                "dequant_matmul": MAX_NEW, "flash_attention": n},
                packed_want={"packed": 0, "tiled": 0},
                dispatch_want={"tiled_fused": 7 * n * MAX_NEW})
            res["e2e"] = {k: v for k, v in e2e.items() if k != "tokens"}
            kernels.append(dict(
                row, name=f"fused_decode_matmul (column groups, G={tiles})",
                route="cuda", path=cfg.name,
                source="src/repro_torch/kernels/csrc/fused_decode_matmul.cu",
                replaces="src/repro/kernels/fused_decode_matmul.py:114",
                timed_at=f"one layer's 7 projections as {tiles} column "
                         f"groups, decode M={BATCH}",
                prefill_timed_at=f"the same projections at "
                                 f"M={BATCH * t_prefill}",
                library="torch.matmul on the bf16 dense weight",
                launches=e2e["launches"].get("fused_decode_matmul", 0)))
            if tiles == TILES[0]:
                eng = engine_phase(rt, cfg, st, device,
                                   dispatch="tiled_fused")
                kernels[-1]["engine_launches"] = eng["launches"].get(
                    "fused_decode_matmul", 0)
                res["engine"] = {k: eng[k] for k in (
                    "ticks", "tokens_per_s", "tick_ms_median",
                    "prefill_ms_median", "launches", "dispatch",
                    "requests_not_bitwise_equal_to_generate")}
                res["against_untiled"] = against_untiled(
                    rt, cfg, st, untiled, batch, device, faults)
                fused = torch.as_tensor(e2e["tokens"], device=device)
                res["rungs"] = tiled_rungs(rt, cfg, st, device, batch,
                                           fused, faults)
            del st
            rt["engine"].drop_graphs(cfg)
            torch.cuda.empty_cache()
        except Exception:
            traceback.print_exc()
            faults.append(f"G={tiles} raised")
    log(f"tiled {cfg.name} " + json.dumps(info))
    if faults:
        log(f"tiled faults: {faults}")
        failed.append(f"{cfg.name} tiled")


def tiled_moe(rt, device, batch, lens, gen, timer, kernels, faults):
    """DeepSeek-V2-Lite at full width, 2 layers, CompressionPolicy(tiles=
    2): K1 with column groups at MLA's and the MLPs' shapes against its
    plain version (bitwise on integer x, within MATMUL_RTOL on random x);
    where the plan gives K1's tensor-core kernel a tile narrower than its
    64-column step (the first w_down's groups at tile_k 32, at the
    prefill's M) its time, bound, plain and ``torch.matmul`` times, a row
    of ``kernels``; K4 decoding the tiled
    wkv_b (the absorb's weight) bitwise against its plain decode; the main
    path with every projection on 'tiled_fused', the expert stacks on K3
    and the absorb counted 'tiled'."""
    fdm = rt["fdm"]
    cfg = dataclasses.replace(rt["get_config"]("deepseek-v2-lite-16b").full,
                              n_layers=2)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    st, packing = pack(rt, cfg, device, SEED, tiles=2)
    first, moe = st.params["first_blocks"], st.params["blocks"]
    ws = ([(f"attn.{k}", b["attn"][k]) for b in first + moe
           for k in ("wq", "wkv_a", "wo")]
          + [(f"first.{k}", b["mlp"][k]) for b in first
             for k in ("w_gate", "w_up", "w_down")]
          + [(f"shared.{k}", b["moe"]["shared"][k]) for b in moe
             for k in ("w_gate", "w_up", "w_down")])
    checks, seen = [], set()
    for label, w in ws:
        if (label, w.shape) in seen:
            continue
        seen.add((label, w.shape))
        kw = dict(shape=w.shape, tile_n=w.tile_n, tile_k=w.tile_k)
        args = (w.codes, w.literals, st.lut, w.scale, w.zero)
        for m in (BATCH, BATCH * batch.shape[1]):
            xi, xr = int_x(m, w.shape[1], gen, device), \
                rand_x(m, w.shape[1], gen, device)
            same = bool(torch.equal(fdm.fused_decode_matmul(xi, *args, **kw),
                                    fdm.fused_decode_matmul_plain(
                                        xi, *args, **kw,
                                        out_dtype=torch.bfloat16)))
            yk = fdm.fused_decode_matmul(xr, *args, **kw,
                                         out_dtype=torch.float32)
            yp = fdm.fused_decode_matmul_plain(xr, *args, **kw)
            err = float((yk - yp).abs().max())
            ok = same and err <= MATMUL_RTOL * float(yp.abs().max())
            plan = launch_info(fdm, m, w, 1)
            checks.append({"proj": label, "shape": list(w.shape), "M": m,
                           "G": w.tiles, "tile": [w.tile_n, w.tile_k],
                           "bitwise": same, "max_abs_err": err, **plan})
            if plan["kernel"] == "mma" and w.tile_k < 64:
                n, k = w.shape
                wb = w.materialize(st.lut, torch.bfloat16)
                b, by = bound_ms(nbytes(xr, *args) + m * n * 2,
                                 2.0 * m * n * k)
                kernels.append({
                    "name": fdm.NAME, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              "fused_decode_matmul.cu",
                    "replaces": "src/repro/kernels/fused_decode_matmul.py"
                                ":114",
                    "path": f"{cfg.name} tiled (tensor cores, tile_k < 64)",
                    "timed_at": f"{label} {tuple(w.shape)}, G={w.tiles}, "
                                f"tile_k {w.tile_k}, M={m}",
                    "bitwise": same, "max_abs_err": err, "launch": plan,
                    "ms": timer.graph_ms([lambda: fdm.fused_decode_matmul(
                        xr, *args, **kw)], reps=20, cold=True),
                    "plain_ms": timer.ms(lambda: fdm.fused_decode_matmul_plain(
                        xr, *args, **kw, out_dtype=torch.bfloat16)),
                    "library_ms": timer.graph_ms([lambda: xr @ wb.T],
                                                 reps=20, cold=True),
                    "library": "torch.matmul on the bf16 weight",
                    "bound_ms": b, "bound_by": by,
                    "launches_of": "fused_decode_matmul:mma, generate"})
                del wb
            if not ok:
                faults.append(f"K1 G=2 {label} {w.shape} M={m}: bitwise "
                              f"{same}, err {err}")
    wkv_b = moe[0]["attn"]["wkv_b"]
    k4_same = bool(torch.equal(wkv_b.materialize_int8(st.lut),
                               wkv_b.materialize_int8(st.lut, plain=True)))
    if not k4_same:
        faults.append("K4 on the tiled wkv_b differs from the plain decode")
    L = cfg.n_layers
    e2e = serve(rt, cfg, st, device, batch, lens, want={
        "grouped_fused_decode_matmul": 3 * n_moe * MAX_NEW,
        "fused_decode_matmul": 6 * L * MAX_NEW,
        "dict_decode": L * MAX_NEW, "dequant_matmul": MAX_NEW,
        "flash_attention": L},
        packed_want={"packed_stacked": 0, "packed": 0,
                     "tiled": L * MAX_NEW},
        dispatch_want={"tiled_fused": 6 * L * MAX_NEW,
                       "grouped_fused": 3 * n_moe * MAX_NEW})
    for row in kernels:
        if row.get("launches_of") == "fused_decode_matmul:mma, generate":
            row["launches"] = e2e["kernel_launches"].get(
                "fused_decode_matmul:mma", 0)
    info = {"model": cfg.name, "layers": L, "packing": packing,
            "k1_checks": checks, "k4_tiled_wkv_b_bitwise": k4_same,
            "wkv_b": {"shape": list(wkv_b.shape), "G": wkv_b.tiles,
                      "codes": list(wkv_b.codes.shape)},
            "e2e": {k: v for k, v in e2e.items() if k != "tokens"}}
    del st
    rt["engine"].drop_graphs(cfg)
    torch.cuda.empty_cache()
    return info


# ---------------------------------------------------------------------------
# Quant mode: every projection a QuantLinear through K5.
# ---------------------------------------------------------------------------

# The prefill M at which quant_phase times K5 on each distinct Llama
# projection: the fixed batch's 4 × 175 and one engine admission's 175
QUANT_K5_M = (700, 175)


def quant_counts(rt, cfg, state, ids, faults):
    """K5 and K2 launches of one quant-mode prefill and of one eager
    decode step after it, each counted alone, with nothing materialized
    and no fallback: 7 projections a layer and the head, K2 at the
    prefill only; the prefill's projections on K5's tensor-core kernel,
    its head (the last position's 4 rows) and the step on the decode
    kernel.  → the counts."""
    _build, L = rt["_build"], rt["L"]
    prefill, decode_step = rt["make_serve_fns"](cfg, device=ids.device)
    caches = rt["LM"].init_caches(cfg, BATCH, ids.shape[1] + 1,
                                  device=ids.device)
    out = {}
    for what in ("prefill", "step"):
        _build.LAUNCH_COUNTS.clear()
        _build.KERNEL_COUNTS.clear()
        L.MATERIALIZE_COUNTS.clear()
        if what == "prefill":
            logits, caches = prefill(state.params, state.lut,
                                     {"tokens": ids}, caches)
        else:
            decode_step(state.params, state.lut,
                        torch.argmax(logits, dim=-1)[:, None], caches,
                        ids.shape[1])
        torch.cuda.synchronize()
        out[what] = dict(_build.LAUNCH_COUNTS)
        out[f"{what}_by_kernel"] = dict(_build.KERNEL_COUNTS)
        want = {"dequant_matmul": 7 * cfg.n_layers + 1}
        want_kernels = {"dequant_matmul:decode": 7 * cfg.n_layers + 1}
        if what == "prefill":
            want["flash_attention"] = cfg.n_layers
            want_kernels = {"dequant_matmul:mma": 7 * cfg.n_layers,
                            "dequant_matmul:decode": 1}
        if out[what] != want or matmul_kernels(
                out[f"{what}_by_kernel"]) != want_kernels \
                or L.MATERIALIZE_COUNTS:
            faults.append(f"quant {what}: launches {out[what]} (want "
                          f"{want}), by kernel {out[f'{what}_by_kernel']} "
                          f"(want {want_kernels}), materialized "
                          f"{dict(L.MATERIALIZE_COUNTS)}")
    return out


def quant_phase(rt, cfg, compressed, device, batch, lens, fused_tokens,
                gen, timer, kernels, failed):
    """Llama-3.2-1B at full width in quant mode, packed from the same
    seeded weights as the compressed state: nothing materialized (the
    embedding gathers rows, the tied head is a QuantLinear), every
    projection and the head through K5 (the tensor-core kernel at the
    prefill's M, the decode kernel at the steps'), 113 launches a prefill
    and a step.  The fixed batch through ``serve`` (graphed tokens bitwise
    to the eager loop), its tokens against the compressed state's (equal,
    or apart at a fused top-2 gap ≤ RUNG_LOGIT_ATOL: the same int8
    weights, sums in another order), the engine's requests bitwise to
    ``generate``; then K5 at QUANT_K5_M on each distinct projection shape
    (rows of ``kernels``).  → the info."""
    faults, info = [], {}
    ids = torch.as_tensor(batch, device=device)
    n = cfg.n_layers
    try:
        state, info["packing"] = pack(rt, cfg, device, SEED, mode="quant")
        info["counts"] = quant_counts(rt, cfg, state, ids, faults)
        e2e = serve(rt, cfg, state, device, batch, lens, want={
            "dequant_matmul": (7 * n + 1) * MAX_NEW, "flash_attention": n},
            packed_want={"quant": 0, "packed": 0}, dispatch_want={},
            kernel_want={"dequant_matmul:mma": 7 * n,
                         "dequant_matmul:decode":
                             (7 * n + 1) * MAX_NEW - 7 * n})
        info["e2e"] = e2e
        for name, run in e2e["runs"].items():
            if run["materialize_counts"]:
                faults.append(f"{name} materialized "
                              f"{run['materialize_counts']}")
        info["vs_compressed"] = compare_rung_tokens(
            rt, cfg, compressed, ids,
            torch.as_tensor(fused_tokens, device=device),
            torch.as_tensor(e2e["tokens"], device=device), "quant", faults)
        info["engine"] = engine_phase(rt, cfg, state, device, dispatch=None)
    except Exception:
        traceback.print_exc()
        faults.append("serving raised")
    if rt["resilience"].FALLBACK_COUNTS:
        faults.append(f"fallbacks {dict(rt['resilience'].FALLBACK_COUNTS)}")
    if "packing" not in info:
        failed.append(f"{cfg.name} quant")
        return
    # the tensor-core kernel's launches: at M = 700 the fixed batch's
    # prefill (serve's generate), at 175 one admission's (the engine's
    # drain, prompts of PROMPT_MIN-PROMPT_MAX)
    launches = {
        700: ("generate, fixed batch", info.get("e2e", {}).get(
            "kernel_launches", {}).get("dequant_matmul:mma", 0)),
        175: ("engine drain, admissions", info.get("engine", {}).get(
            "kernel_launches", {}).get("dequant_matmul:mma", 0))}
    block = state.params["blocks"][0]
    for label, w in (("q/o_proj", block["attn"]["wq"]),
                     ("k/v_proj", block["attn"]["wk"]),
                     ("gate/up_proj", block["mlp"]["w_gate"]),
                     ("down_proj", block["mlp"]["w_down"])):
        wb = w.materialize(torch.bfloat16)
        for m in QUANT_K5_M:
            try:
                row = check_k5(rt, w.values, w.scale, w.zero, wb, m, gen,
                               timer)
            except Exception:
                traceback.print_exc()
                faults.append(f"K5 {label} M={m}")
                continue
            kernels.append({**K5_ROW, **row, "path": f"{cfg.name} quant",
                            "timed_at": f"{label} {tuple(w.values.shape)}"
                                        f", M={m}",
                            "library": "torch.matmul on the bf16 weight",
                            "launches_of": f"dequant_matmul:mma, "
                                           f"{launches[m][0]}",
                            "launches": launches[m][1]})
        del wb
    log(f"quant {cfg.name} " + json.dumps(info))
    if faults:
        log(f"quant faults: {faults}")
        failed.append(f"{cfg.name} quant")
    del state
    torch.cuda.empty_cache()


def quant_moe(rt, device, batch, lens, failed):
    """DeepSeek-V2-Lite at 2 layers (a dense and an MoE layer) in quant
    mode, the fixed batch through ``serve``: MLA's wq, wkv_a, wo, the
    dense and the shared experts' MLPs and the head through K5 (13 a
    pass); MLA's wkv_b and the 3 expert stacks materialized at every pass
    (5), as the reference does in quant mode."""
    full = rt["get_config"]("deepseek-v2-lite-16b").full
    cfg = dataclasses.replace(full, n_layers=2)
    faults, info = [], {}
    try:
        state, info["packing"] = pack(rt, cfg, device, SEED, mode="quant")
        info["e2e"] = serve(rt, cfg, state, device, batch, lens, want={
            "dequant_matmul": 13 * MAX_NEW, "flash_attention": 2},
            packed_want={"quant": 5 * MAX_NEW, "packed": 0},
            dispatch_want={})
        del state
    except Exception:
        traceback.print_exc()
        faults.append("raised")
    if rt["resilience"].FALLBACK_COUNTS:
        faults.append(f"fallbacks {dict(rt['resilience'].FALLBACK_COUNTS)}")
    log(f"quant {cfg.name} " + json.dumps(info))
    if faults:
        log(f"quant faults: {faults}")
        failed.append(f"{cfg.name} quant")
    torch.cuda.empty_cache()


# the launcher's runs on the card, the reference's smoke configs and flag
# sets; the pressure run's low watermark (1 MiB under the 4 GiB boot
# budget) forces the governor to retire KV pages and regrow them; the
# quant run serves every projection through K5 (admissions of 16 tokens
# on its tensor-core kernel, the ticks on its decode kernel)
LAUNCHER_RUNS = (
    ("llama_verify", ["--arch", "llama3.2-1b", "--tiles", "2",
                      "--verify", "full"]),
    ("llama_pressure", ["--arch", "llama3.2-1b", "--tiles", "2",
                        "--pressure-trace", "oscillate",
                        "--pressure-low-mib", "1"]),
    ("deepseek_tiered", ["--arch", "deepseek-v2-lite-16b",
                         "--residency", "tiered", "--tiles", "2"]),
    ("llama_quant", ["--arch", "llama3.2-1b", "--mode", "quant"]),
)


def cpu_top2_gap(rt, cfg, params, mode, tiles, prompt, prefix) -> float:
    """The top-2 gap of the CPU's logits for the token after ``prompt`` +
    ``prefix``, from the launcher's state of ``params`` (``mode``,
    ``tiles``) built on the CPU (the plain versions): where a card sample
    leaves the CPU's, how near a tie the CPU's choice was."""
    st = rt["build_serve_params"](params, rt["CompressionPolicy"](
        mode=mode, min_weight_size=1024, tiles=tiles), device="cpu")
    seq = torch.tensor([list(prompt) + list(prefix)], dtype=torch.long)
    logits = rt["LM"].forward(st.params, cfg, seq, lut=st.lut)[0]
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def launcher_phase(rt, device, gen, timer, kernels, faults):
    """``repro_torch.launch.serve.main`` in this process on the card, for
    each of LAUNCHER_RUNS: every request ends as one completion, every K1
    launch is a 'tiled_fused' dispatch (K3 for the expert stacks), no
    fallback rung is taken; under the pressure trace the governor changes
    its plan and retires KV pages at least once; in quant mode nothing is
    dispatched or materialized, K5 launches its decode kernel (and its
    tensor-core kernel for a prompt past 16 tokens) and no other matmul
    kernel runs.  Both runs of an argv,
    on the card and with ``--device cpu`` (every kernel's plain version),
    serve the same weights, ``init_lm(seed=0)`` drawn on the CPU: the CPU
    run must end its requests for the same reasons; where its sample
    tokens first differ is reported, with the CPU logits' top-2 gap there.  Then K2 at the smoke configs' head dims (16; MLA 24/16)
    against its plain version, a kernels row each with the launches of
    that arch's runs."""
    out, flash = {}, collections.Counter()
    for name, flags in LAUNCHER_RUNS:
        argv = flags + ["--batch", "4", "--max-new", "16"]
        params = rt["LM"].init_lm(rt["get_config"](flags[1]).smoke, seed=0,
                                  device="cpu")
        res, run = counted_run(rt, lambda: rt["launch_serve"].main(
            argv, params=params))
        cpu = rt["launch_serve"].main(argv + ["--device", "cpu"],
                                      params=params)
        flash[flags[1]] += run["launches"].get("flash_attention", 0)
        rids = sorted(c.rid for c in res["completions"])
        d, launches = res["dispatch"], run["launches"]
        moe = "deepseek" in name
        mode = flags[flags.index("--mode") + 1] if "--mode" in flags \
            else "compressed"
        tiles = int(flags[flags.index("--tiles") + 1]) if "--tiles" in flags \
            else 0
        info = {"argv": argv, "s": run["s"], "reasons": res["reasons"],
                "dispatch": d, "launches": launches,
                "kernel_launches": run["kernel_launches"],
                "materialized": run["materialized"],
                "tokens": res["tokens"], "sample": res["sample"],
                "fallbacks": run["fallbacks"],
                "last_rung": res["health"]["last_rung"],
                "cpu_reasons": cpu["reasons"]}
        first = next((i for i, (a, b) in enumerate(zip(res["sample"],
                                                       cpu["sample"]))
                      if a != b), None)
        info["cpu_sample_first_diff"] = first
        if first is not None:
            cfg = rt["get_config"](flags[1]).smoke
            prompt = rt["DataPipeline"](rt["DataConfig"](
                vocab_size=cfg.vocab_size, batch=4,
                seq_len=16)).batch_at(0)["tokens"][0].tolist()
            info["cpu_top2_gap_there"] = cpu_top2_gap(
                rt, cfg, params, mode, tiles, prompt, cpu["sample"][:first])
        if res["residency"] is not None:
            info["residency"] = {k: res["residency"][k] for k in (
                "capacity", "hit", "miss", "prefetch_hit", "evict",
                "bytes_fetched")}
        if res["pressure"] is not None:
            info["pressure"] = {k: res["pressure"][k] for k in (
                "plan_changes", "refusing", "plan", "rung_latency_s")}
        out[name] = info
        if mode == "quant":
            kl = matmul_kernels(run["kernel_launches"])
            # the smoke prompts are 16 tokens: admissions too run K5's
            # decode kernel (4 launches of 4 rows); a longer prompt its
            # tensor-core kernel
            matmuls_ok = (set(launches) == {"dequant_matmul",
                                            "flash_attention"}
                          and "dequant_matmul:decode" in kl
                          and set(kl) <= {"dequant_matmul:mma",
                                          "dequant_matmul:decode"}
                          and not run["materialized"])
            want_d = set()
        else:
            matmuls_ok = (
                launches.get("fused_decode_matmul") == d.get("tiled_fused")
                and (not moe or launches.get("grouped_fused_decode_matmul")
                     == d.get("grouped_fused")))
            want_d = {"tiled_fused"} | ({"grouped_fused"} if moe else set())
        # the governor counts its rungs among the fallbacks; no other
        # fallback may be taken
        ladder = {k: v for k, v in run["fallbacks"].items()
                  if not k.startswith("pressure_")}
        pressed = res["pressure"] is None or (
            res["pressure"]["plan_changes"] > 0
            and run["fallbacks"].get("pressure_kv_retire", 0) > 0)
        if (rids != [0, 1, 2, 3] or set(d) != want_d or not matmuls_ok
                or ladder or res["health"]["last_rung"] != "fused"
                or sum(res["reasons"].values()) != 4 or not pressed
                or cpu["reasons"] != res["reasons"]):
            faults.append(f"launcher {name}: requests {rids}, dispatch {d}, "
                          f"launches {launches}, by kernel "
                          f"{run['kernel_launches']}, materialized "
                          f"{run['materialized']}, fallbacks "
                          f"{run['fallbacks']}, reasons {res['reasons']}, "
                          f"pressure {info.get('pressure')}")
    for arch in ("llama3.2-1b", "deepseek-v2-lite-16b"):
        cfg = rt["get_config"](arch).smoke
        if cfg.family == "moe":
            dims = (cfg.n_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                    cfg.v_head_dim)
        else:
            dims = (cfg.n_kv_heads, cfg.resolved_head_dim,
                    cfg.resolved_head_dim)
        row, detail = check_flash(rt, device, 16, gen, timer, cfg.n_heads,
                                  *dims, f"{cfg.name} prefill")
        out[f"flash_{cfg.name}"] = detail
        kernels.append(dict(row, path=f"launcher {cfg.name}",
                            launches=flash[arch]))
    return out


# ---------------------------------------------------------------------------
# Training and calibration: the train phase.
# ---------------------------------------------------------------------------

# Llama-3.2-1B at full width, all 16 layers, f32: steps, batch × tokens
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 256
# The train phase's data: DataPipeline's Markov stream over the first
# TRAIN_DATA_VOCAB token ids, at the launcher's lr 5e-3.  At this width
# that lr spikes the loss whatever the data (tools/train_loss_witness.py,
# H100: over the full vocabulary 12.18 → 12.35 with warmup 1 and → 13.07
# with the launcher's 50-step schedule; over 1 024 ids a spike at step 5
# too), while one step at lr 1e-6 lowers the loss (the gradient's sign is
# right) and lr 5e-4 falls slowly (12.18 → 12.10).  The full vocabulary
# leaves 8 steps ~0.4 nats above ln V to win, less than a spike; 1 024
# ids leave ~5, so the fall checked is the model learning.
TRAIN_DATA_VOCAB = 1024
# DeepSeek-V2-Lite at full width, cut to 2 layers (the dense first layer
# and one MoE layer): the MoE dispatch's backward, the aux loss, MLA
DS_TRAIN_LAYERS, DS_TRAIN_STEPS = 2, 3
#  * One train step's gradients with K2 under its autograd.Function (the
#    f32 kernel's forward) against those of the all-plain attention, every
#    parameter as one vector (L2): the two forwards differ by f32 roundoff
#    (FLASH_ATOL_F32 at most, sums in another order), which 16 layers of
#    f32 activations carry into every gradient.
TRAIN_GRAD_RTOL = 1e-3
GPTQ_BITS = 4
# the training launcher's leg: steps of its smoke default, checkpoints
# every LAUNCH_CKPT_EVERY, SIGINT at LAUNCH_STOP_AT
LAUNCH_TRAIN_STEPS, LAUNCH_CKPT_EVERY, LAUNCH_STOP_AT = 30, 4, 13


def check_flash_train(rt, device, gen, timer, hq, hkv, d, dv, what,
                      batch=TRAIN_BATCH):
    """K2's f32 kernel at a training forward's shapes: f32 q, k and v of
    (batch, h, TRAIN_SEQ, d), causal, against its plain version
    (FLASH_ATOL_F32); timed beside the plain version and SDPA on the same
    f32 inputs (k and v repeated to the q heads outside the timed call).
    The bound is the lesser of two: the work as f32 FMA at f32's peak, and
    as the kernel takes it, three TF32 products at TF32's peak; each the
    larger of its operations and the bytes.  → the kernels row."""
    fa = rt["fa"]
    t = TRAIN_SEQ
    q = torch.randn((batch, hq, t, d), generator=gen, device=device)
    k = torch.randn((batch, hkv, t, d), generator=gen, device=device)
    v = torch.randn((batch, hkv, t, dv), generator=gen,
                    device=device)
    err = float((fa.flash_attention(q, k, v) - fa.flash_attention_plain(
        q, k, v)).abs().max())
    if not err <= FLASH_ATOL_F32:
        raise AssertionError(f"K2 f32 ({d}, {dv}) T={t}: err {err}")
    kf, vf = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    pairs = t * (t + 1) // 2
    moved = 4 * batch * (hq * t * (d + dv) + hkv * t * (d + dv))
    flops = 2.0 * (d + dv) * batch * hq * pairs
    fma = bound_ms(moved, flops, F32_FLOP_PER_S)
    tf32x3 = bound_ms(moved, 3 * flops, TF32_FLOP_PER_S)
    (b, by), peak = min((fma, "f32 FMA at 67 TFLOP/s"),
                        (tf32x3, "3 TF32 products at 495 TFLOP/s"))
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:80",
            "kernel": "three-term TF32 on the tensor cores (f32 operands)",
            "timed_at": f"{what}: f32 q, k, v (B={batch}, {hq}/{hkv} "
                        f"heads, T={t}, {d}/{dv}), causal",
            "max_abs_err": err,
            "ms": timer.graph_ms([lambda: fa.flash_attention(q, k, v)] * 8),
            "plain_ms": timer.ms(lambda: fa.flash_attention_plain(q, k, v)),
            "library_ms": timer.graph_ms([
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kf, vf, is_causal=True)] * 8),
            "library": "scaled_dot_product_attention (f32)",
            "bound_ms": b, "bound_by": by, "bound_peak": peak,
            "f32_fma_bound_ms": fma[0], "tf32x3_bound_ms": tf32x3[0]}


def train_steps(rt, cfg, state, step, data, n, first=0):
    """``n`` train steps from ``first``, counted (launches zeroed just
    before, read just after) and timed (each step ends on its loss's host
    read).  ``state``: the train state, or a function that makes it, so
    that no caller holds the first state through the run and the peak is
    a step's own (the old state, the new one, the gradients and the
    activations).  → (state, {losses, step_ms, median_step_ms,
    peak_mem_bytes, launches, kernel_launches})."""
    _build = rt["_build"]
    if callable(state):
        state = state()
    _build.LAUNCH_COUNTS.clear()
    _build.KERNEL_COUNTS.clear()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(first, first + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        log(f"train {cfg.name} step {i + 1}: loss {losses[-1]:.6f} "
            f"grad_norm {float(m['grad_norm']):.4f} lr "
            f"{float(m['lr']):.3e} ({ms[-1]:.1f} ms)")
    return state, {"losses": losses, "step_ms": ms,
                   "median_step_ms": float(np.median(ms)),
                   "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                   "launches": dict(_build.LAUNCH_COUNTS),
                   "kernel_launches": dict(_build.KERNEL_COUNTS)}


def k2_train_launches(run) -> int:
    """K2's f32-kernel launches in a ``train_steps`` run; raises if the run
    launched K2 through any other kernel."""
    k2 = {k: n for k, n in run["kernel_launches"].items()
          if k.startswith("flash_attention:")}
    if set(k2) - {"flash_attention:tf32x3"}:
        raise AssertionError(f"train steps launched K2 as {k2}")
    return k2.get("flash_attention:tf32x3", 0)


def grad_against_plain(rt, cfg, tcfg, params, batch, k2_want=None):
    """One step's loss and gradients with K2 under its autograd.Function
    against the all-plain attention (``ops.flash_attention`` swapped for
    the plain version under autograd): every parameter as one vector (L2).
    ``k2_want``: K2's launches in the forward (default: one a layer).
    → the numbers."""
    S, T, ops, fa = rt["steps"], rt["tree"], rt["ops"], rt["fa"]
    _build = rt["_build"]
    _build.KERNEL_COUNTS.clear()
    loss, grads = S.loss_and_grads(params, cfg, tcfg, batch)
    k2 = _build.KERNEL_COUNTS["flash_attention:tf32x3"]
    real = ops.flash_attention
    ops.flash_attention = fa.flash_attention_plain
    try:
        _build.KERNEL_COUNTS.clear()
        loss_p, grads_p = S.loss_and_grads(params, cfg, tcfg, batch)
        plain_launches = sum(_build.KERNEL_COUNTS.values())
    finally:
        ops.flash_attention = real
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(grads, grads_p))
    den = sum(float((b ** 2).sum()) for b in grads_p)
    rel = (num / den) ** 0.5
    out = {"loss": float(loss), "loss_plain": float(loss_p),
           "grad_rel_l2": rel, "tolerance": TRAIN_GRAD_RTOL,
           "tf32x3_launches": k2, "plain_run_launches": plain_launches,
           "leaves": len(T.leaves(params))}
    if not (rel <= TRAIN_GRAD_RTOL
            and k2 == (cfg.n_layers if k2_want is None else k2_want)
            and plain_launches == 0 and math.isfinite(rel)):
        raise AssertionError(f"K2 autograd gradients: {out}")
    return out


def layer0_inputs(rt, cfg, params, tokens) -> dict:
    """The inputs of layer 0's 7 projections on ``tokens`` (one no-grad
    forward with ``layers.linear`` recording them): {name: (n_tok, K)}."""
    L = rt["L"]
    blk = params["blocks"][0]
    names = {id(blk[g][n]): n for g, ns in (
        ("attn", ("wq", "wk", "wv", "wo")),
        ("mlp", ("w_gate", "w_up", "w_down"))) for n in ns}
    seen, real = {}, L.linear

    def recording(x, w, *a, **kw):
        n = names.get(id(w))
        if n is not None and n not in seen:
            seen[n] = x.reshape(-1, x.shape[-1]).detach().clone()
        return real(x, w, *a, **kw)

    L.linear = recording
    try:
        with torch.no_grad():
            rt["LM"].forward(params, cfg, tokens, return_hidden=True)
    finally:
        L.linear = real
    return seen


def gptq_check(rt, cfg, params, tokens) -> dict:
    """GPTQ at full width on layer 0's 7 projections, each calibrated on
    its own inputs from ``tokens``: ``gptq_layer_error`` of GPTQ against
    naive per-channel at GPTQ_BITS; GPTQ must be the lower for each.  →
    the numbers, with the seconds."""
    gptq, Q = rt["gptq"], rt["quant"]
    blk = params["blocks"][0]
    ws = {n: blk[g][n] for g, ns in (("attn", ("wq", "wk", "wv", "wo")),
                                     ("mlp", ("w_gate", "w_up", "w_down")))
          for n in ns}
    inputs = layer0_inputs(rt, cfg, params, tokens)
    qcfg = Q.QuantConfig(bits=GPTQ_BITS)
    out, worse = {}, []
    for name, w in ws.items():
        x = inputs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = gptq.accumulate_hessian(gptq.init_hessian(w.shape[1],
                                                      device=w.device), x)
        qt = gptq.gptq_quantize(w, h, qcfg)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        e_g = float(gptq.gptq_layer_error(w, qt, h))
        e_n = float(gptq.gptq_layer_error(w, Q.quantize(w, qcfg), h))
        out[name] = {"shape": list(w.shape), "tokens": x.shape[0],
                     "gptq_error": e_g, "naive_per_channel_error": e_n,
                     "ratio": e_g / e_n, "s": sec}
        if not (e_g < e_n and math.isfinite(e_g)):
            worse.append(name)
    out["s_total"] = sum(v["s"] for v in out.values())
    if worse:
        raise AssertionError(f"GPTQ not below naive per-channel at "
                             f"{GPTQ_BITS} bits on {worse}: {out}")
    return out


def escape_share(rt, state) -> float:
    """Escaped grams over all grams of the packed weights."""
    esc = tot = 0
    for w in rt["tree"].leaves(state.params):
        if hasattr(w, "nlit"):
            esc += int(w.nlit.sum())
            tot += w.codes.numel()
    return esc / max(tot, 1)


def llama_train(rt, device, gen, timer, kernels, faults) -> dict:
    """Llama-3.2-1B at full width, 16 layers, f32, from seed 0 on the card:
    first one step without remat (every block's activations kept), then
    TRAIN_STEPS steps of batch TRAIN_BATCH × TRAIN_SEQ (tokens below
    TRAIN_DATA_VOCAB) at the reference launcher's AdamW (lr 5e-3, warmup
    steps/10) with the config's per-block remat: its first loss bitwise
    the step without remat's (the peaks of both reported); the loss must
    fall, and every step's attention is K2's f32 kernel (32 launches a
    step, the recompute's included; none of another K2 kernel).  Then
    one forward and backward with remat and without on the same batch:
    the same loss bits, a lower peak with remat (a step's own peak is
    AdamW's update, where the activations are gone).  Then
    one step's gradients against the all-plain attention; GPTQ on layer
    0; the trained model packed compressed and served by ``serve`` (the
    eager loop, two generates, bitwise, the counts) with the escape
    share.  → the numbers."""
    S, opt = rt["steps"], rt["optimizer"]
    cfg = rt["get_config"]("llama3.2-1b").full
    tcfg = S.TrainConfig(optimizer=opt.AdamWConfig(
        lr=5e-3, warmup_steps=max(TRAIN_STEPS // 10, 1),
        total_steps=TRAIN_STEPS))
    data = rt["DataPipeline"](rt["DataConfig"](
        vocab_size=TRAIN_DATA_VOCAB, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    def init():
        return S.init_train_state(rt["LM"].init_lm(cfg, seed=SEED,
                                                   device=device), tcfg)

    # one step without remat (every block's activations kept) from the
    # same init: its loss bits and peak beside the remat run's
    plain_cfg = dataclasses.replace(cfg, remat=False)
    state, no_remat = train_steps(rt, plain_cfg, init, S.make_train_step(
        plain_cfg, tcfg), data, 1)
    del state
    torch.cuda.empty_cache()
    info = {"model": cfg.name, "layers": cfg.n_layers, "dtype": "float32",
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": cfg.remat}
    state, run = train_steps(rt, cfg, init, S.make_train_step(cfg, tcfg),
                             data, TRAIN_STEPS)
    info.update(run)
    losses = run["losses"]
    info["no_remat"] = {
        "loss": no_remat["losses"][0], "step_ms": no_remat["step_ms"][0],
        "peak_mem_bytes": no_remat["peak_mem_bytes"],
        "k2": k2_train_launches(no_remat),
        "loss_bitwise": no_remat["losses"][0] == losses[0]}
    log(f"train {cfg.name} remat: first loss {losses[0]!r} (no remat "
        f"{no_remat['losses'][0]!r}), peak {run['peak_mem_bytes']} B (no "
        f"remat {no_remat['peak_mem_bytes']} B), median step "
        f"{run['median_step_ms']:.1f} ms (no remat "
        f"{no_remat['step_ms'][0]:.1f} ms, a first step)")
    if not (cfg.remat and info["no_remat"]["loss_bitwise"]
            and info["no_remat"]["k2"] == cfg.n_layers):
        faults.append(f"llama train remat: {info['no_remat']}")
    k2 = k2_train_launches(run)
    info["flash_attention_tf32x3_launches"] = k2
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
            and k2 == k2_per_step(rt, cfg) * TRAIN_STEPS
            and set(run["launches"]) == {"flash_attention_f32"}):
        faults.append(f"llama train: losses {losses}, launches "
                      f"{run['launches']}, by kernel "
                      f"{run['kernel_launches']}")
    params = state["params"]
    del state
    torch.cuda.empty_cache()
    batch = {k: v.to(device) for k, v in
             data.batch_at(TRAIN_STEPS).items()}
    # the forward and backward alone, with and without remat: the step's
    # peak is AdamW's (the old state, the new one and the gradients), so
    # what remat frees shows here
    info["grads_peak"] = {}
    for name, c in (("remat", cfg), ("no_remat", plain_cfg)):
        gc.collect()     # no garbage freed inside the measured call
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, grads = S.loss_and_grads(params, c, tcfg, batch)
        info["grads_peak"][name] = {
            "loss": float(loss),
            "bytes_above_params": torch.cuda.max_memory_allocated() - base}
        del loss, grads
    gp = info["grads_peak"]
    log(f"train {cfg.name} forward+backward peak above the parameters: "
        f"remat {gp['remat']['bytes_above_params']} B, no remat "
        f"{gp['no_remat']['bytes_above_params']} B")
    if not (gp["remat"]["loss"] == gp["no_remat"]["loss"]
            and gp["remat"]["bytes_above_params"]
            < gp["no_remat"]["bytes_above_params"]):
        faults.append(f"llama train remat, forward and backward: {gp}")
    info["grad_vs_plain"] = grad_against_plain(rt, cfg, tcfg, params, batch,
                                               k2_want=k2_per_step(rt, cfg))
    torch.cuda.empty_cache()
    info["gptq"] = gptq_check(rt, cfg, params, data.batch_at(
        TRAIN_STEPS + 1)["tokens"].to(device))
    row = check_flash_train(rt, device, gen, timer, cfg.n_heads,
                            cfg.n_kv_heads, cfg.resolved_head_dim,
                            cfg.resolved_head_dim, "Llama-3.2-1B training")
    kernels.append(dict(row, path=f"{cfg.name} train", launches=k2,
                        launches_of=f"{TRAIN_STEPS} train steps"))
    # the trained model, packed compressed and served
    rt["engine"].drop_graphs(cfg)
    state = rt["build_serve_params"](params, rt["CompressionPolicy"](
        mode="compressed"), device=device)
    del params
    torch.cuda.empty_cache()
    info["escape_share"] = escape_share(rt, state)
    batch, lens = make_prompts(cfg.vocab_size)
    e2e = serve(rt, cfg, state, device, batch, lens, want={
        "fused_decode_matmul": 7 * cfg.n_layers * MAX_NEW,
        "dequant_matmul": MAX_NEW, "flash_attention": cfg.n_layers},
        packed_want={"packed": 0})
    info["serve"] = {f: e2e[f] for f in (
        "decode_ms_per_step", "prefill_ms", "launches", "kernel_launches",
        "first_request_tokens")}
    rt["engine"].drop_graphs(cfg)
    return info


def deepseek_train(rt, device, gen, timer, kernels, faults) -> dict:
    """DeepSeek-V2-Lite at full width cut to DS_TRAIN_LAYERS layers, f32,
    from seed 0: DS_TRAIN_STEPS steps (the MoE dispatch's backward, the
    aux loss, MLA through K2's f32 kernel at (192, 128)); finite losses,
    the routers' aux loss > 0, 2 K2 launches a step; K2 f32 at MLA's
    training shapes against its plain version.  → the numbers."""
    S, opt = rt["steps"], rt["optimizer"]
    cfg = dataclasses.replace(rt["get_config"]("deepseek-v2-lite-16b").full,
                              n_layers=DS_TRAIN_LAYERS)
    tcfg = S.TrainConfig(optimizer=opt.AdamWConfig(
        lr=5e-3, warmup_steps=1, total_steps=DS_TRAIN_STEPS))
    data = rt["DataPipeline"](rt["DataConfig"](
        vocab_size=TRAIN_DATA_VOCAB, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    state, run = train_steps(rt, cfg, lambda: S.init_train_state(
        rt["LM"].init_lm(cfg, seed=SEED, device=device), tcfg),
        S.make_train_step(cfg, tcfg), data, DS_TRAIN_STEPS)
    with torch.no_grad():
        _, _, aux = rt["LM"].forward(state["params"], cfg, data.batch_at(
            DS_TRAIN_STEPS)["tokens"].to(device), return_hidden=True)
    info = {"model": cfg.name, "layers": cfg.n_layers,
            "depth_cut": f"{DS_TRAIN_LAYERS} of 27 layers", **run,
            "aux_loss": float(aux)}
    k2 = k2_train_launches(run)
    info["flash_attention_tf32x3_launches"] = k2
    if not (all(map(math.isfinite, run["losses"])) and float(aux) > 0
            and k2 == k2_per_step(rt, cfg) * DS_TRAIN_STEPS):
        faults.append(f"deepseek train: {info}")
    del state
    torch.cuda.empty_cache()
    row = check_flash_train(rt, device, gen, timer, cfg.n_heads, cfg.n_heads,
                            cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                            cfg.v_head_dim, "DeepSeek-V2-Lite MLA training")
    kernels.append(dict(row, path=f"{cfg.name} train", launches=k2,
                        launches_of=f"{DS_TRAIN_STEPS} train steps at "
                                    f"{DS_TRAIN_LAYERS} layers"))
    return info


# The families' train steps at full width: (arch, config overrides, steps).
# seamless-m4t-medium at full depth (12 + 12 layers; K2's f32 kernel
# without the mask in the encoder and the cross-attention); Zamba2-1.2B
# cut to 7 Mamba2 blocks, the fewest after which its shared attention
# block is applied (it follows every 6th block but the last segment's:
# 6 blocks give none); InternVL2-2B cut to 2 layers, 64 patch embeddings
# before each row's tokens.
FAMILY_TRAIN = (
    ("seamless-m4t-medium", {}, 3),
    ("zamba2-1.2b", {"n_layers": 7}, 2),
    ("internvl2-2b", {"n_layers": 2, "n_patches": 64}, 2),
)


class FrontendData:
    """A data pipeline whose batches also carry the frontend's output for
    the step: an encoder–decoder's ``enc_embeds`` (TRAIN_BATCH ×
    TRAIN_SEQ f32 frames) or a VLM's ``embeds`` (TRAIN_BATCH ×
    ``n_patches``), drawn on the card from the seed and the step."""

    def __init__(self, rt, cfg, base, device):
        self.rt, self.cfg, self.base, self.device = rt, cfg, base, device

    def batch_at(self, i):
        batch = dict(self.base.batch_at(i))
        g = torch.Generator(device=self.device)
        g.manual_seed(SEED * 1000 + i)
        fe = self.rt["frontends"]
        if self.cfg.family == "encdec":
            batch["enc_embeds"] = fe.audio_frame_embeddings(
                g, TRAIN_BATCH, TRAIN_SEQ, self.cfg.d_model)
        elif self.cfg.family == "vlm":
            batch["embeds"] = fe.vision_patch_embeddings(
                g, TRAIN_BATCH, self.cfg.n_patches, self.cfg.d_model)
        return batch


def k2_per_step(rt, cfg) -> int:
    """K2's launches in one train step: an attention layer's each (an
    encoder–decoder: its encoder layers and, twice, its decoder layers;
    the hybrid: each application of the shared block), twice where the
    blocks run checkpointed (``cfg.remat``: the forward, then the
    backward's recompute, ``layers.block``)."""
    if cfg.family == "encdec":
        n = cfg.encoder_layers + 2 * cfg.decoder_layers
    elif cfg.family == "hybrid":
        n = len(rt["LM"]._hybrid_segments(cfg)) - 1
    else:
        n = 0 if cfg.family == "ssm" else cfg.n_layers
    return 2 * n if cfg.remat else n


def family_train(rt, device, faults, arch, over, steps) -> dict:
    """One family's f32 train steps at full width from seed 0 (batches of
    TRAIN_BATCH × TRAIN_SEQ tokens below TRAIN_DATA_VOCAB, with the
    frontend's output: ``FrontendData``): finite losses, K2's f32 kernel
    ``k2_per_step`` times a step, and one step's gradients against the
    all-plain attention (TRAIN_GRAD_RTOL).  → the numbers."""
    S, opt = rt["steps"], rt["optimizer"]
    full = rt["get_config"](arch).full
    cfg = dataclasses.replace(full, **over)
    tcfg = S.TrainConfig(optimizer=opt.AdamWConfig(
        lr=5e-3, warmup_steps=1, total_steps=steps))
    data = FrontendData(rt, cfg, rt["DataPipeline"](rt["DataConfig"](
        vocab_size=TRAIN_DATA_VOCAB, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)),
        device)
    init = (rt["ED"].init_encdec if cfg.family == "encdec"
            else rt["LM"].init_lm)
    info = {"model": cfg.name, "family": cfg.family, **over,
            "full_layers": full.n_layers, "dtype": "float32",
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "n_params": cfg.n_params()}
    state, run = train_steps(rt, cfg, lambda: S.init_train_state(
        init(cfg, seed=SEED, device=device), tcfg),
        S.make_train_step(cfg, tcfg), data, steps)
    info.update(run)
    k2 = k2_train_launches(run)
    per = k2_per_step(rt, cfg)
    info["flash_attention_tf32x3_launches"] = k2
    info["flash_attention_tf32x3_want"] = per * steps
    if not (all(map(math.isfinite, run["losses"])) and k2 == per * steps):
        faults.append(f"{cfg.name} train: losses {run['losses']}, K2 "
                      f"{k2} (want {per * steps})")
    params = state["params"]
    del state
    torch.cuda.empty_cache()
    batch = {k: v.to(device) for k, v in data.batch_at(steps).items()}
    info["grad_vs_plain"] = grad_against_plain(rt, cfg, tcfg, params, batch,
                                               k2_want=per)
    del params
    torch.cuda.empty_cache()
    log(f"train {cfg.name} " + json.dumps(info))
    return info


def launcher_train(rt, faults) -> dict:
    """``repro_torch.launch.train.main`` in this process on the card at its
    smoke default: LAUNCH_TRAIN_STEPS steps uninterrupted; then the same
    run stopped by SIGINT at LAUNCH_STOP_AT (``PreemptionGuard``: a
    checkpoint, a stop) and started again on its --ckpt-dir, which must
    resume there and give the uninterrupted run's losses, bit for bit.
    → the numbers."""
    import signal
    import tempfile
    main = rt["launch_train"].main
    argv = ["--steps", str(LAUNCH_TRAIN_STEPS), "--ckpt-every",
            str(LAUNCH_CKPT_EVERY)]

    def stop(s, m):
        if s == LAUNCH_STOP_AT:
            signal.raise_signal(signal.SIGINT)

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ref = main(argv + ["--ckpt-dir", f"{d}/ref"])
        ref_s = time.perf_counter() - t0
        first = main(argv + ["--ckpt-dir", f"{d}/run"], on_metrics=stop)
        second = main(argv + ["--ckpt-dir", f"{d}/run"])
    resumed = {**first["losses"], **second["losses"]}
    differ = [s for s in ref["losses"] if resumed.get(s) != ref["losses"][s]]
    info = {"argv": argv, "uninterrupted_s": ref_s,
            "stopped_at": first["end_step"],
            "resumed_from": second["start_step"],
            "end_step": second["end_step"],
            "losses_first_last": [ref["losses"][1],
                                  ref["losses"][LAUNCH_TRAIN_STEPS]],
            "steps_differing_from_uninterrupted": differ}
    if (first["end_step"] != LAUNCH_STOP_AT
            or second["start_step"] != LAUNCH_STOP_AT
            or second["end_step"] != LAUNCH_TRAIN_STEPS or differ):
        faults.append(f"launcher train: {info}")
    return info


def train_phase(rt, device, gen, timer, kernels, faults) -> dict:
    """Training and calibration on the card: ``llama_train``,
    ``deepseek_train``, ``family_train`` on each of FAMILY_TRAIN,
    ``launcher_train``, each timed."""
    out = {}
    for name, fn in (("llama", lambda: llama_train(
            rt, device, gen, timer, kernels, faults)),
                     ("deepseek", lambda: deepseek_train(
                         rt, device, gen, timer, kernels, faults)),
                     *((arch, lambda a=arch, o=over, n=n: family_train(
                         rt, device, faults, a, o, n))
                       for arch, over, n in FAMILY_TRAIN),
                     ("launcher", lambda: launcher_train(rt, faults))):
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        except Exception:
            traceback.print_exc()
            faults.append(f"train {name} raised")
        out.setdefault(name, {})["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


# The families phase: the decoder-only families beside Llama and DeepSeek,
# compressed, at full width, random weights from the seed: (arch, layers on
# the card or None for full depth, config overrides).  Depth cuts are for
# time (Qwen2-7B's, Qwen3-4B's and InternVL2-2B's layers are all alike).
FAMILY_MODELS = (
    ("zamba2-1.2b", None, {}),
    ("mamba2-2.7b", None, {}),
    ("qwen3-4b", 8, {"kv_cache_bits": 8}),
    ("qwen2-7b", 4, {}),
    ("internvl2-2b", 4, {}),
)
# Mamba2's extra request: one prompt longer than its 256-token SSD chunk
MAMBA_LONG_PROMPT = 320
#  * The families' kernels against their plain versions on the path's own
#    inputs: every K1, K5 and K2 call of a prefill and a decode step is
#    repeated with the plain version on the same inputs.  Both round the
#    same f32 value, summed in another order, to bf16: one bf16 ulp of
#    the call's largest output (K1, K5), two for K2 (another exp; as
#    FLASH_ATOL_BF16).
FAMILY_CALL_ULPS = {"fused_decode_matmul": 1, "dequant_matmul": 1,
                    "flash_attention": 2}
#  * End to end, the prefill logits of the kernels' path against the same
#    path with every kernel swapped for its plain version: the per-call
#    differences above pass through every layer, so the logits part by a
#    number of ulps that grows with depth (measured, reported beside
#    ATOL["compressed"] = 3e-2 of tests/test_torch_model.py, which is
#    below one bf16 ulp of a logit above 4: 2^-5).  Gated: each request's
#    greedy token the same, or the plain path's top-2 gap within the
#    difference.
FAMILY_LOGIT_ATOL = 3e-2


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 7) if v > 0 else 0.0


def _plain_fns(rt) -> dict:
    """The plain versions of the wrappers ``ops`` calls, by wrapper name
    and ``ops`` attribute."""
    fdm, dqm, fa = rt["fdm"], rt["dqm"], rt["fa"]
    return {
        # decode and plan_n choose a launch; the plain order has neither
        "fused_decode_matmul": ("_fused", lambda x, *a, decode=False,
                                plan_n=None, **kw:
                                fdm.fused_decode_matmul_plain(x, *a, **kw)),
        "dequant_matmul": ("_dequant_matmul",
                           lambda x, wq, sc, z, out_dtype, decode=False,
                           plan_n=None: dqm.dequant_matmul_plain(
                               x, wq, sc, z, out_dtype)),
        "flash_attention": ("flash_attention",
                            lambda q, k, v, causal=True, sm_scale=None,
                            q_offset=0: fa.flash_attention_plain(
                                q, k, v, causal=causal, sm_scale=sm_scale,
                                q_offset=q_offset))}


def family_want(rt, cfg) -> dict:
    """The launches, by wrapper, of one prefill and MAX_NEW − 1 decode
    steps, from the config: K1 once a compressed projection a forward (7
    an attention + MLP layer, 2 a Mamba2 block: in_proj, out_proj; the
    hybrid's shared block 7 at each application), K5 once a forward (the
    int8 head, at the last position), K2 once an attention layer at the
    prefill."""
    fam = cfg.family
    attn = cfg.n_layers
    if fam in ("ssm", "hybrid"):
        attn = (len(rt["LM"]._hybrid_segments(cfg)) - 1 if fam == "hybrid"
                else 0)
    mamba = cfg.n_layers if fam in ("ssm", "hybrid") else 0
    want = {"fused_decode_matmul": (7 * attn + 2 * mamba) * MAX_NEW,
            "dequant_matmul": MAX_NEW}
    if attn:
        want["flash_attention"] = attn
    return want


@contextlib.contextmanager
def plain_kernels(rt, record=None):
    """Every kernel wrapper the dense, SSM and hybrid paths call — K1
    (``ops._fused``), K5 (``ops._dequant_matmul``) and K2
    (``ops.flash_attention``) — swapped for its plain version on the
    card's tensors; restored on exit.  With ``record`` (a dict), each
    kernel runs as before and its plain version is run beside it on the
    same inputs: per wrapper, the calls and the worst difference in bf16
    ulps of the call's largest plain output."""
    ops = rt["ops"]
    plain = _plain_fns(rt)
    saved = {attr: getattr(ops, attr) for attr, _ in plain.values()}

    def beside(name, real, ref):
        def call(*a, **kw):
            y = real(*a, **kw)
            p = ref(*a, **kw).float()
            err = float((y.float() - p).abs().max())
            ulp = _bf16_ulp(float(p.abs().max()))
            r = record.setdefault(name, {"calls": 0, "worst_abs_err": 0.0,
                                         "worst_ulps": 0.0})
            r["calls"] += 1
            r["worst_abs_err"] = max(r["worst_abs_err"], err)
            r["worst_ulps"] = max(r["worst_ulps"], err / ulp if ulp
                                  else (0.0 if err == 0 else math.inf))
            return y
        return call

    for name, (attr, ref) in plain.items():
        setattr(ops, attr, ref if record is None
                else beside(name, saved[attr], ref))
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(ops, attr, fn)


def against_plain(rt, cfg, state, device, batch, embeds=None) -> dict:
    """The kernels against their plain versions on the path's own inputs
    (``plain_kernels(record=...)`` over a prefill and one decode step):
    each call within FAMILY_CALL_ULPS.  Then the prefill's last-position
    logits of the kernels' path and of the all-plain path (the plain run
    launching no kernel): the difference (reported beside
    FAMILY_LOGIT_ATOL), finite logits, and each request's greedy token
    the same or the plain path's top-2 gap within the difference."""
    _build, LM = rt["_build"], rt["LM"]
    prefill, decode_step = rt["make_serve_fns"](cfg, device=device)
    ids = torch.as_tensor(batch, device=device)
    t0 = ids.shape[1] + (0 if embeds is None else embeds.shape[1])

    def run(step=False):
        caches = LM.init_caches(cfg, ids.shape[0], t0 + MAX_NEW,
                                device=device)
        logits, caches = prefill(state.params, state.lut,
                                 {"tokens": ids, "embeds": embeds}, caches)
        if step:
            decode_step(state.params, state.lut,
                        torch.argmax(logits, -1)[:, None], caches, t0)
        torch.cuda.synchronize()
        return logits.float()

    calls = {}
    with plain_kernels(rt, calls):
        run(step=True)
    kern = run()
    _build.LAUNCH_COUNTS.clear()
    with plain_kernels(rt):
        t = time.perf_counter()
        plain = run()
        plain_s = time.perf_counter() - t
    launched = dict(_build.LAUNCH_COUNTS)
    err = float((kern - plain).abs().max())
    top2 = plain.topk(2, dim=-1).values
    same = torch.argmax(kern, -1) == torch.argmax(plain, -1)
    near = (top2[:, 0] - top2[:, 1]) <= err
    out = {"calls": calls, "call_ulps_allowed": FAMILY_CALL_ULPS,
           "logits_max_abs_err": err, "logits_atol": FAMILY_LOGIT_ATOL,
           "within_logits_atol": err <= FAMILY_LOGIT_ATOL,
           "logits_err_ulps": err / _bf16_ulp(float(plain.abs().max())),
           "max_abs_logit": float(plain.abs().max()),
           "greedy_same": same.tolist(),
           "plain_top2_gap": (top2[:, 0] - top2[:, 1]).tolist(),
           "plain_prefill_s": plain_s, "plain_run_launches": launched}
    bad = [n for n, r in calls.items()
           if r["worst_ulps"] > FAMILY_CALL_ULPS[n]]
    if bad or launched or set(calls) != set(
            family_want(rt, cfg)) or not bool(
            torch.isfinite(kern).all()) or not bool((same | near).all()):
        raise AssertionError(f"{cfg.name} against plain: {out}")
    return out


def check_head_k5(rt, head, m_prefill, gen, timer, what):
    """K5 on a model's int8 head (``check_k5``; Mamba2's N = 50 280 and
    InternVL2's 92 553 end in a partial stripe of 128 rows): at M = BATCH
    as a decode step's rows and at the prefill's M.  → the kernels row
    (decode M) with the prefill M's numbers beside."""
    n, k = head.values.shape
    wb = head.materialize(torch.bfloat16)
    dec = check_k5(rt, head.values, head.scale, head.zero, wb, BATCH, gen,
                   timer, decode=True)
    pre = check_k5(rt, head.values, head.scale, head.zero, wb, m_prefill,
                   gen, timer)
    del wb
    return {**K5_ROW, **dec, "N": n, "K": k, "ragged_last_stripe": n % 128,
            "timed_at": f"{what} head {n}x{k}, M={BATCH} (decode rows)",
            **{f"prefill_{f}": pre[f] for f in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "bitwise", "max_abs_err", "launch")},
            "prefill_timed_at": f"the same head at M={m_prefill}"}


def family_model(rt, device, gen, timer, kernels, arch, depth, over,
                 faults) -> dict:
    """One model of FAMILY_MODELS: pack, serve (``serve``'s gates: the
    eager loop, a capturing and a replaying ``generate``, tokens bitwise,
    launches as ``family_want``), nothing materialized, the prefill
    against the all-plain path; a K5 row on its head; Mamba2 also its
    long prompt and K1 rows; Qwen3 the engine (``engine_phase``) on its
    int8 cache and that cache's bytes; InternVL2 with patch embeddings.
    → the model's line."""
    E = rt["engine"]
    full = rt["get_config"](arch).full
    cfg = dataclasses.replace(full, **over, n_layers=depth or full.n_layers)
    batch, lens = make_prompts(cfg.vocab_size)
    embeds = None
    if cfg.family == "vlm":
        g = torch.Generator(device=device)
        g.manual_seed(SEED)
        embeds = rt["frontends"].vision_patch_embeddings(
            g, BATCH, cfg.n_patches, cfg.d_model)
    phase(rt, f"families {cfg.name}")
    state, packing = pack(rt, cfg, device, SEED)
    info = {"model": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
            "full_layers": full.n_layers, **over, **packing}
    want = family_want(rt, cfg)
    t0 = time.perf_counter()
    e2e = serve(rt, cfg, state, device, batch, lens, want=want,
                packed_want={}, embeds=embeds)
    info["serve_s"] = time.perf_counter() - t0
    info.update({k: e2e[k] for k in (
        "batch", "prompt_lens", "max_new", "prefill_ms", "capture_ms",
        "decode_ms_per_step", "decode_tokens_per_s",
        "eager_decode_ms_per_step", "eager_decode_tokens_per_s",
        "peak_mem_bytes", "graph_pool_bytes", "launches",
        "kernel_launches", "materialize_counts", "stats")})
    info["launches_want"] = want
    info["graphed_tokens_bitwise_eager"] = True      # serve raised if not
    if embeds is not None:
        info["patch_embeddings"] = embeds.shape[1]
    materialized = {k: r["materialize_counts"] for k, r in e2e["runs"].items()
                    if r["materialize_counts"]}
    if materialized:
        faults.append(f"{cfg.name} materialized {materialized}")
    info["against_plain"] = against_plain(rt, cfg, state, device, batch,
                                          embeds)
    m_prefill = BATCH * batch.shape[1]
    rows = []
    if cfg.family == "ssm":
        rng = np.random.default_rng(SEED)
        long = rng.integers(0, cfg.vocab_size, (1, MAMBA_LONG_PROMPT))
        info["long_prompt"] = {
            k: v for k, v in serve(rt, cfg, state, device, long,
                                   [MAMBA_LONG_PROMPT], want=want,
                                   packed_want={}).items()
            if k in ("prefill_ms", "decode_ms_per_step",
                     "eager_decode_ms_per_step", "launches",
                     "materialize_counts", "tokens")}
        info["long_prompt"]["against_plain"] = against_plain(
            rt, cfg, state, device, long)
    if cfg.family == "dense" and cfg.kv_cache_bits == 8:
        phase(rt, f"families {cfg.name} engine")
        eng = engine_phase(rt, cfg, state, device)
        info["engine"] = {k: eng[k] for k in (
            "slots", "requests", "ticks", "tokens_per_s", "tick_ms_median",
            "prefill_ms_median", "pool_device_bytes", "peak_mem_bytes",
            "kernel_launches", "requests_not_bitwise_equal_to_generate")}
        nb = [sum(nbytes(t) for t in E._tensors(rt["LM"].init_caches(
            c, ENGINE_SLOTS, ENGINE_MAX_LEN, device=device)))
              for c in (cfg, dataclasses.replace(cfg, kv_cache_bits=16))]
        info["kv_cache_bytes"] = {"int8": nb[0], "bf16": nb[1],
                                  "ratio": nb[0] / nb[1]}
        if not nb[0] < 0.7 * nb[1]:
            faults.append(f"{cfg.name} int8 cache {nb[0]} B not under 0.7 "
                          f"of bf16's {nb[1]} B")
    phase(rt, f"{cfg.name} kernels")
    if cfg.family == "ssm":
        blocks = state.params["blocks"]
        row, detail = check_fused(
            rt, state.lut, [(name, [b["mamba"][name] for b in blocks], True)
                            for name in ("in_proj", "out_proj")],
            device, m_prefill, gen, timer,
            "one Mamba2 block's in_proj and out_proj, decode M=4")
        rows.append(row)
        info["k1_rows"] = detail
    rows.append(check_head_k5(rt, state.params.get(
        "lm_head", state.params["embed"]), m_prefill, gen, timer, cfg.name))
    for row in rows:
        row["path"] = f"families {cfg.name}"
        row["launches"] = e2e["launches"].get(row["name"], 0)
        row["launches_by_kernel"] = by_kernel(e2e["kernel_launches"],
                                              row["name"])
        row["launches_of"] = "the model's generate (prefill + 31 steps)"
    kernels.extend(rows)
    log(f"family {cfg.name} " + json.dumps(info))
    E.drop_graphs(cfg)
    return info


def families_phase(rt, device, gen, timer, kernels, faults) -> dict:
    """FAMILY_MODELS one after another (``family_model``); a model that
    raises is a fault and the next still runs.  → seconds by model."""
    out = {}
    for arch, depth, over in FAMILY_MODELS:
        t0 = time.perf_counter()
        try:
            family_model(rt, device, gen, timer, kernels, arch, depth, over,
                         faults)
        except Exception:
            traceback.print_exc()
            faults.append(f"{arch} raised")
        torch.cuda.empty_cache()
        out[arch] = time.perf_counter() - t0
    return {"seconds": out}


# The encoder–decoder phase: seamless-m4t-medium at full width and full
# depth (12 + 12 layers), compressed, random weights from the seed; 4
# requests of ENCDEC_FRAMES bf16 frames (the reference's serving specs
# give bf16 frames) and a decoder prompt left-padded to ENCDEC_PROMPT
# tokens (pad id 0), MAX_NEW new tokens; then a second batch (other
# frames, other prompts) through the same decode graph; then the first
# batch in mode='quant'.
ENCDEC_FRAMES = 300
ENCDEC_PROMPT, ENCDEC_LENS = 16, (16, 12, 8, 4)
# decode rows each held against itself alone
ENCDEC_ROWS = (4, 16)


def encdec_prompts(vocab: int, seed: int):
    """ENCDEC_LENS prompts left-padded to ENCDEC_PROMPT (pad id 0), token
    ids from ``seed``."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(ENCDEC_LENS), ENCDEC_PROMPT), np.int64)
    for i, n in enumerate(ENCDEC_LENS):
        out[i, ENCDEC_PROMPT - n:] = rng.integers(1, vocab, n)
    return out


def encdec_want(cfg, mode: str):
    """(launches by wrapper, launches by wrapper:kernel) of one prefill
    and MAX_NEW − 1 decode steps, from the config.  A prefill runs K1 on
    every projection: 7 an encoder layer (at M = B·S), the cross K/V (2 a
    decoder layer, at M = B·S) and 9 a decoder layer (self q/k/v/o, cross
    q/o, the MLP; at M = B·T0), all on the tensor-core kernel; K2 once an
    encoder layer (no mask), and twice a decoder layer (causal over the
    cache; cross-attention, no mask); K5 once (the head at the last
    position, a decode row).  A decode step: K1 9 a decoder layer (decode
    kernel), K2 once a decoder layer (cross-attention at Tq = 1), K5 once.
    In quant mode every projection is K5 instead of K1 (its tensor-core
    kernel at the prefill, its decode kernel at a step)."""
    e, d, steps = cfg.encoder_layers, cfg.decoder_layers, MAX_NEW - 1
    pre, step = 7 * e + 2 * d + 9 * d, 9 * d
    k2 = (e + 2 * d) + steps * d
    if mode == "quant":
        return ({"dequant_matmul": pre + 1 + steps * (step + 1),
                 "flash_attention": k2},
                {"dequant_matmul:mma": pre,
                 "dequant_matmul:decode": MAX_NEW + steps * step,
                 "flash_attention:mma": k2})
    return ({"fused_decode_matmul": pre + steps * step,
             "dequant_matmul": MAX_NEW, "flash_attention": k2},
            {"fused_decode_matmul:mma": pre,
             "fused_decode_matmul:decode": steps * step,
             "dequant_matmul:decode": MAX_NEW, "flash_attention:mma": k2})


def encdec_eager(rt, cfg, state, ids, frames):
    """The decode phase as an eager loop over ``make_serve_fns``' steps on
    fresh caches (int positions).  → (the MAX_NEW new tokens, seconds of
    the decode steps alone)."""
    prefill, decode_step = rt["make_serve_fns"](cfg, device=ids.device)
    b, t0 = ids.shape
    caches = rt["ED"].init_caches(cfg, b, t0 + MAX_NEW, frames.shape[1],
                                  enc_dtype=frames.dtype, device=ids.device)
    logits, caches = prefill(state.params, state.lut,
                             {"tokens": ids, "enc_embeds": frames}, caches)
    toks = [torch.argmax(logits, dim=-1)[:, None]]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(MAX_NEW - 1):
        logits, caches = decode_step(state.params, state.lut, toks[-1],
                                     caches, t0 + i)
        toks.append(torch.argmax(logits, dim=-1)[:, None])
    torch.cuda.synchronize()
    return torch.cat(toks, dim=1), time.perf_counter() - t


def encdec_serve(rt, cfg, state, device, batches, mode, faults) -> dict:
    """The main path on each (ids, frames) of ``batches``: the eager loop,
    then ``decode_graph(...).run`` — the first batch twice (the first run
    takes an eager step and captures the decode step, the second only
    replays), every later batch once through the same graph (its prefill
    copies its cross K/V into the graph's buffers).  Counts zeroed just
    before each run and read just after: each must be ``encdec_want``'s,
    nothing materialized, one capture in all; every graphed run's tokens
    bitwise the eager loop's on that batch.  Then the encoder alone, the
    prefill alone (medians of 3) and the graphed decode alone (replays
    after a prefill)."""
    E, ED = rt["engine"], rt["ED"]
    want, kernel_want = encdec_want(cfg, mode)
    ids0, frames0 = batches[0]
    b, t0 = ids0.shape
    graph = E.decode_graph(state.params, cfg, state.lut, b, t0 + MAX_NEW,
                           enc_len=frames0.shape[1], enc_dtype=frames0.dtype,
                           device=device)
    runs, tokens = {}, []

    def counted(fn):
        torch.cuda.reset_peak_memory_stats(device)
        out, run = counted_run(rt, fn)
        run["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
        return out, run

    for i, (ids, frames) in enumerate(batches):
        (eager, eager_s), runs[f"eager_{i}"] = counted(
            lambda: encdec_eager(rt, cfg, state, ids, frames))
        for rep in ((0, 1) if i == 0 else (0,)):
            got, runs[f"graph_{i}_{rep}"] = counted(
                lambda: graph.run(state.params, state.lut, ids, MAX_NEW,
                                  enc_embeds=frames))
            if not torch.equal(got, eager):
                faults.append(f"{cfg.name} {mode} batch {i} run {rep}: "
                              "graphed tokens differ from the eager loop's "
                              f"at {torch.nonzero(got != eager).tolist()[:8]}")
        if i == 0:
            eager_decode_s = eager_s
        tokens.append(eager)
    for name, run in runs.items():
        if (run["launches"] != want or run["kernel_launches"] != kernel_want
                or run["materialized"] or run["fallbacks"]):
            faults.append(f"{cfg.name} {mode} {name}: launches "
                          f"{run['launches']} (want {want}), by kernel "
                          f"{run['kernel_launches']} (want {kernel_want}), "
                          f"materialized {run['materialized']}, fallbacks "
                          f"{run['fallbacks']}")
    captures = [r["captures"].get("decode_loop", 0) for r in runs.values()]
    if captures != [0, 1, 0] + [0, 0] * (len(batches) - 1):
        faults.append(f"{cfg.name} {mode} captures {captures}")
    prefill, _ = rt["make_serve_fns"](cfg, device=device)

    def median_ms(fn):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return sorted(out)[1]

    with torch.no_grad():
        encoder_ms = median_ms(lambda: ED.encode(state.params, cfg, frames0,
                                                 lut=state.lut))
        prefill_ms = median_ms(lambda: prefill(
            state.params, state.lut, {"tokens": ids0, "enc_embeds": frames0},
            ED.init_caches(cfg, b, t0 + MAX_NEW, frames0.shape[1],
                           device=device)))
        graph.prefill(state.params, state.lut, ids0, enc_embeds=frames0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        graph.decode(state.params, state.lut, MAX_NEW - 1)
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t
    pool = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ()))
            == tuple(graph.graph.pool())]
    steps = MAX_NEW - 1
    replay = runs["graph_0_1"]
    return {"mode": mode, "encoder_ms": encoder_ms, "prefill_ms": prefill_ms,
            "decode_ms_per_step": graph_s / steps * 1e3,
            "decode_tokens_per_s": b * steps / graph_s,
            "eager_decode_ms_per_step": eager_decode_s / steps * 1e3,
            "eager_decode_tokens_per_s": b * steps / eager_decode_s,
            "capture_ms": graph.capture_ms,
            "peak_mem_bytes": runs["graph_0_0"]["peak_mem_bytes"],
            "replay_peak_mem_bytes": replay["peak_mem_bytes"],
            "graph_pool_bytes": sum(pool), "launches": replay["launches"],
            "kernel_launches": replay["kernel_launches"],
            "launches_want": want, "kernel_launches_want": kernel_want,
            "step_kernel_launches": dict(graph.step_counts[1]),
            "runs": {k: {f: r[f] for f in ("s", "captures", "materialized")}
                     for k, r in runs.items()},
            "tokens": [t.tolist() for t in tokens]}


def encdec_rows(rt, cfg, state, device, ids, frames) -> dict:
    """Each row of a decode step bitwise itself alone, at ENCDEC_ROWS
    rows: the batch's caches after its prefill (at 16 rows the 4 rows
    four times over), per-row positions.  → the worst |difference| by row
    count."""
    ED = rt["ED"]
    prefill, decode_step = rt["make_serve_fns"](cfg, device=device)
    b, t0 = ids.shape
    caches = ED.init_caches(cfg, b, t0 + MAX_NEW, frames.shape[1],
                            device=device)
    with torch.no_grad():
        logits, caches = prefill(state.params, state.lut,
                                 {"tokens": ids, "enc_embeds": frames},
                                 caches)
        tok = torch.argmax(logits, -1)[:, None]
        out = {}
        for n in ENCDEC_ROWS:
            reps = -(-n // b)

            def rows(r, reps=reps):
                def one(t):
                    return torch.cat([t] * reps)[r].clone()
                return {k: [{m: one(t) for m, t in layer.items()}
                            for layer in v] if k == "self"
                        else [one(t) for t in v] for k, v in caches.items()}

            toks = torch.cat([tok] * reps)[:n]
            pos = t0 + torch.arange(n, device=device) % 3
            many = decode_step(state.params, state.lut, toks,
                               rows(slice(0, n)), pos)[0]
            out[n] = max(float((many[i:i + 1].float() - decode_step(
                state.params, state.lut, toks[i:i + 1],
                rows(slice(i, i + 1)), pos[i:i + 1])[0].float()
                ).abs().max()) for i in range(n))
    return out


def encdec_against_plain(rt, cfg, state, device, ids, frames) -> dict:
    """Every K1, K5 and K2 call of a prefill and a decode step against its
    plain version on the same inputs (``plain_kernels(record=...)``):
    within FAMILY_CALL_ULPS.  → per wrapper, calls and worst ulps."""
    ED = rt["ED"]
    prefill, decode_step = rt["make_serve_fns"](cfg, device=device)
    b, t0 = ids.shape
    calls = {}
    with torch.no_grad(), plain_kernels(rt, calls):
        caches = ED.init_caches(cfg, b, t0 + MAX_NEW, frames.shape[1],
                                device=device)
        logits, caches = prefill(state.params, state.lut,
                                 {"tokens": ids, "enc_embeds": frames},
                                 caches)
        decode_step(state.params, state.lut,
                    torch.argmax(logits, -1)[:, None], caches, t0)
        torch.cuda.synchronize()
    bad = [n for n, r in calls.items()
           if r["worst_ulps"] > FAMILY_CALL_ULPS[n]]
    if bad or set(calls) != set(FAMILY_CALL_ULPS):
        raise AssertionError(f"{cfg.name} against plain: {calls}")
    return {"calls": calls, "call_ulps_allowed": FAMILY_CALL_ULPS}


def check_flash_cross(rt, device, gen, timer, b, h, tq, tk, d, what):
    """K2 without the mask at (b, h, tq, d) against (b, h, tk, d) keys and
    values, bf16 operands as the layers pass them ((B, T, H, D) tensors
    transposed): within FLASH_ATOL_BF16 of the plain version; timed beside
    the plain version and SDPA (no mask) on the same inputs.  Bound: the
    bytes (q, k, v read once, the output written once) and the operations
    (2·(d + dv) a query–key pair)."""
    fa = rt["fa"]

    def view(t):
        return torch.randn((b, t, h, d), generator=gen, device=device
                           ).to(torch.bfloat16).transpose(1, 2)

    q, k, v = view(tq), view(tk), view(tk)
    y = fa.flash_attention(q, k, v, causal=False)
    err = float((y.float() - fa.flash_attention_plain(
        q, k, v, causal=False).float()).abs().max())
    if not (err <= FLASH_ATOL_BF16 and torch.isfinite(y).all()):
        raise AssertionError(f"K2 not causal ({b}, {h}, {tq}, {tk}, {d}): "
                             f"err {err}")
    bb, by = bound_ms(nbytes(q, k, v, y), 2.0 * 2 * d * b * h * tq * tk)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:80",
            "kernel": "bf16 tensor cores (flash_attention:mma), no mask",
            "timed_at": f"{what}: bf16 q (B={b}, {h} heads, Tq={tq}, D={d}) "
                        f"over Tk={tk}, not causal",
            "max_abs_err": err,
            "ms": timer.graph_ms([lambda: fa.flash_attention(
                q, k, v, causal=False)] * 8),
            "plain_ms": timer.ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=False)),
            "library_ms": timer.graph_ms([
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v)] * 8),
            "library": "scaled_dot_product_attention (bf16, no mask)",
            "bound_ms": bb, "bound_by": by}


def encdec_phase(rt, device, gen, timer, kernels, faults) -> dict:
    """seamless-m4t-medium at full width and depth: pack, the main path
    on two batches (``encdec_serve``), each decode row bitwise alone
    (``encdec_rows``), every kernel call against its plain version
    (``encdec_against_plain``), kernel rows (K2 at the encoder's and the
    cross-attention's decode shapes, K5 on the 256 206-row head, K1 on
    the encoder's ``w_gate``), then the first batch in quant mode.  → the
    ``encdec`` line's numbers."""
    E = rt["engine"]
    cfg = rt["get_config"]("seamless-m4t-medium").full
    b, s = len(ENCDEC_LENS), ENCDEC_FRAMES
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    batches = []
    for i in range(2):
        frames = rt["frontends"].audio_frame_embeddings(
            g, b, s, cfg.d_model, torch.bfloat16)
        ids = torch.as_tensor(encdec_prompts(cfg.vocab_size, SEED + i),
                              device=device)
        batches.append((ids, frames))
    state, packing = pack(rt, cfg, device, SEED)
    info = {"model": cfg.name, "encoder_layers": cfg.encoder_layers,
            "decoder_layers": cfg.decoder_layers, "batch": b, "frames": s,
            "frames_dtype": "bfloat16", "prompt": ENCDEC_PROMPT,
            "prompt_lens": list(ENCDEC_LENS), "max_new": MAX_NEW,
            "n_params": cfg.n_params(), **packing}
    t0 = time.perf_counter()
    info["compressed"] = comp = encdec_serve(rt, cfg, state, device, batches,
                                             "compressed", faults)
    info["serve_s"] = time.perf_counter() - t0
    rows = encdec_rows(rt, cfg, state, device, *batches[0])
    info["rows_worst_abs_diff_alone"] = rows
    if any(v != 0.0 for v in rows.values()):
        faults.append(f"{cfg.name} decode rows depend on the batch: {rows}")
    info["against_plain"] = encdec_against_plain(rt, cfg, state, device,
                                                 *batches[0])
    phase(rt, "encdec kernels")
    m_enc, m_dec = b * s, b * ENCDEC_PROMPT
    launches = comp["launches"]
    k1, k1_rows = check_fused(
        rt, state.lut, [("w_gate", [blk["mlp"]["w_gate"]
                                    for blk in state.params["encoder"]],
                         True)],
        device, m_enc, gen, timer,
        f"the encoder's w_gate (4096 x 1024, 12 layers' planes), M={BATCH}")
    info["k1_rows"] = k1_rows
    k5 = check_head_k5(rt, state.params["lm_head"], m_dec, gen, timer,
                       cfg.name)
    k2_enc = check_flash_cross(rt, device, gen, timer, b, cfg.n_heads, s, s,
                               cfg.resolved_head_dim, "the encoder's "
                               "self-attention")
    k2_dec = check_flash_cross(rt, device, gen, timer, b, cfg.n_heads, 1, s,
                               cfg.resolved_head_dim, "cross-attention at a "
                               "decode step")
    for row in (k1, k5, k2_enc, k2_dec):
        row["path"] = f"encdec {cfg.name}"
        row["launches"] = launches.get(row["name"], 0)
        row["launches_by_kernel"] = by_kernel(comp["kernel_launches"],
                                              row["name"])
        row["launches_of"] = ("the graphed run of the first batch (prefill "
                              f"+ {MAX_NEW - 1} steps)")
    kernels.extend([k1, k5, k2_enc, k2_dec])
    phase(rt, "encdec")
    E.drop_graphs(cfg)
    del state
    torch.cuda.empty_cache()
    qstate, qpacking = pack(rt, cfg, device, SEED, mode="quant")
    info["quant"] = quant = encdec_serve(rt, cfg, qstate, device,
                                         batches[:1], "quant", faults)
    quant["pack_s"] = qpacking["pack_s"]
    same = [a == c for a, c in zip(quant["tokens"][0], comp["tokens"][0])]
    quant["requests_equal_to_compressed"] = sum(same)
    E.drop_graphs(cfg)
    del qstate
    torch.cuda.empty_cache()
    log(f"encdec {cfg.name} " + json.dumps(info))
    return {"encdec_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# The examples phase: examples/torch_quickstart.py and
# examples/torch_serve_batched.py on the card, as a user runs them.
# ---------------------------------------------------------------------------

EXAMPLE_MODES = ("compressed", "quant", "dense")


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(rt, device, gen, timer, kernels, faults) -> dict:
    """The quickstart (100 steps of the Llama smoke model, packed
    compressed and quant, 12 tokens for 2 prompts): its card checks, the
    codec byte for byte and the tokens under the exact-tie rule, are its
    own assertions; then the batched-serving example in each mode (its
    graph-step tokens must be its eager loop's)."""
    out = {}
    try:
        q = load_example("torch_quickstart").main([], device=device)
        out["quickstart"] = {
            "loss": q["loss"], "dense_bytes": q["dense_bytes"],
            "compressed_bytes": q["compressed_bytes"],
            "codec_equal": f"{q['codec_weights'] - len(q['codec_mismatch'])}"
                           f"/{q['codec_weights']}",
            "exact": q["exact"], "parting": q["parting"],
            "compressed_tokens": q["compressed"][:, -12:].tolist(),
            "quant_tokens": q["quant"][:, -12:].tolist()}
    except Exception:
        traceback.print_exc()
        faults.append("quickstart")
    sb = load_example("torch_serve_batched")
    for mode in EXAMPLE_MODES:
        try:
            r = sb.main(["--mode", mode], device=device)
            out[f"serve_batched {mode}"] = {
                k: r[k] for k in ("prefill_ms", "decode_ms", "tok_s",
                                  "graph_ms", "graph_tok_s")}
        except Exception:
            traceback.print_exc()
            faults.append(f"serve_batched {mode}")
    return out


# ---------------------------------------------------------------------------
# The mesh phase: serving on a device mesh of ranks (processes, over gloo)
# that share the one card.  Proves the sharded kernels' shapes and bits,
# not a multi-card speed.
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_LLAMA = (1, 2)      # Llama-3.2-1B, full width and depth, compressed
MESH_WIDE = (2, 2)       # Llama-3.2-1B's rows over data, DeepSeek-V2-Lite
                         # (local-routing MoE), tiled Llama
MESH_SPREAD = (1, 4)     # Llama smoke: 2 kv heads on 4 model ranks, each
                         # holding a block of the cache's positions
MESH_ROWS_LAYERS = 4     # Llama-3.2-1B's rows over data on MESH_WIDE: the
                         # first 4 of the 16 layers packed for MESH_LLAMA
                         # (a depth cut: the phase's time)
MESH_DS_LAYERS = 2       # DeepSeek-V2-Lite at full width, cut to 2 layers
MESH_SSM = (1, 2)        # Mamba2-2.7B at full width, its SSM heads on model
MESH_SSM_LAYERS = 4      # of its 64 blocks (a depth cut: the phase's time)
MESH_TILED_LAYERS = 2    # tiled Llama-3.2-1B (tiles 2), cut to 2 layers
#  * Local-routing MoE and column groups against one process at 2 layers:
#    the local router runs in f32 (the global one in x's bf16), the
#    partial outputs add over model in bf16, column groups add their f32
#    partial sums over data: bf16 flips through 2 layers, the
#    card-vs-CPU bound above.  Both sides dropless (capacity factor
#    E / top-k), so no token's drop depends on its data shard.
MESH_LOGIT_ATOL = E2E_LOGIT_ATOL


class LaunchShapes(collections.Counter):
    """{(wrapper, N, E): launches} of K1, K3 and K5 in this process: the
    out width N and weight count E each launch took (K5: one count a
    launch, as ``LAUNCH_COUNTS``)."""

    @classmethod
    def install(cls, rt) -> "LaunchShapes":
        rec, fdm, dqm = cls(), rt["fdm"], rt["dqm"]
        rows, k5 = fdm._launch_rows, dqm._launch

        def launch_rows(name, fn, plan, *a, **kw):
            rec[(name, kw["n"], kw["e"])] += 1
            return rows(name, fn, plan, *a, **kw)

        def launch(plan, xb, wq, *a, **kw):
            rec[("dequant_matmul", wq.shape[0], 1)] += plan.row_groups
            return k5(plan, xb, wq, *a, **kw)

        fdm._launch_rows, dqm._launch = launch_rows, launch
        return rec

    def table(self) -> dict:
        return {f"{name} N={n} E={e}": v for (name, n, e), v in
                sorted(self.items())}


def eager_logits(rt, cfg, params, lut, ids, ctx=None):
    """``make_serve_fns``' prefill and MAX_NEW − 1 eager decode steps,
    greedy (under ``ctx``'s mesh where given); → (tokens (B, MAX_NEW),
    each step's logits (MAX_NEW, B, V) f32, prefill ms, decode ms a
    step)."""
    device = ids.device
    if ctx is None:
        ctx = rt["ServeContext"](cfg, lut=lut, device=device)
    prefill, step = rt["make_serve_fns"](ctx=ctx)
    b, t0 = ids.shape
    caches = rt["LM"].init_caches(cfg, b, t0 + MAX_NEW, device=device,
                                  mesh=ctx.mesh)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, caches = prefill(params, lut, {"tokens": ids}, caches)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    steps, toks = [logits.float()], [torch.argmax(logits, -1)[:, None]]
    t = time.perf_counter()
    for i in range(MAX_NEW - 1):
        logits, caches = step(params, lut, toks[-1], caches, t0 + i)
        steps.append(logits.float())
        toks.append(torch.argmax(logits, -1)[:, None])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / (MAX_NEW - 1)
    return torch.cat(toks, 1), torch.stack(steps), prefill_ms, step_ms


def tie_rule(toks, ref, logits, ref_logits) -> list:
    """Rows whose tokens part from ``ref`` away from an exact tie: each row
    may differ only from a step where one run's logits give both tokens
    the same value (``tests/test_torch_moe.py``'s rule).  → [(row, step,
    both top-2 gaps)] of every parting row, with ``tied``."""
    out = []
    for r in range(toks.shape[0]):
        diff = torch.nonzero(toks[r] != ref[r])
        if not diff.numel():
            continue
        s = int(diff[0])
        a, b = int(toks[r, s]), int(ref[r, s])
        tied = any(bool(lg[r, a] == lg[r, b])
                   for lg in (logits[s], ref_logits[s]))
        gaps = [float(v[0] - v[1]) for v in (
            torch.topk(logits[s][r], 2).values,
            torch.topk(ref_logits[s][r], 2).values)]
        out.append({"row": r, "step": s, "tied": tied, "top2_gaps": gaps})
    return out


def band_bits(rt, mesh, lut, pairs, ms, gen) -> dict:
    """Each share of ``pairs`` — ``(label, whole, share)`` — launched as
    the mesh path launches it (planned for the whole weight: ``plan_n``,
    ``plan_experts``) against the whole weight's launch on the same
    random x, at each M of ``ms`` (K3: capacity rows): K1 on an out band
    and K5 on the head's band bitwise the rank's columns of the whole
    launch, K3 on the rank's experts bitwise its experts of it.  The int8
    head is replicated (``share`` None) and cut here as ``ops`` cuts it
    at each call.  → {"<label> M=<m>": equal}."""
    fdm, dqm = rt["fdm"], rt["dqm"]
    f32 = torch.float32
    out = {}
    for label, whole, share in pairs:
        for m in ms:
            if share is None:                       # K5: the head's band
                n, k = whole.values.shape
                waxes = rt["partition"].weight_axes(mesh)
                per = n // mesh.axis_size(waxes)
                cols = slice(mesh.axis_index(waxes) * per,
                             (mesh.axis_index(waxes) + 1) * per)
                x = rand_x(m, k, gen, whole.values.device)
                a = dqm.dequant_matmul(
                    x, whole.values[cols], whole.scale[cols],
                    whole.zero[cols], out_dtype=f32, decode=m <= BATCH,
                    plan_n=n)
                b = dqm.dequant_matmul(x, whole.values, whole.scale,
                                       whole.zero, out_dtype=f32,
                                       decode=m <= BATCH)[:, cols]
                out[f"{label} M={m}"] = bool(torch.equal(a, b))
                continue
            kw = dict(tile_n=whole.tile_n, tile_k=whole.tile_k,
                      out_dtype=f32)
            i = mesh.axis_index(share.mesh_axes)
            if whole.codes.ndim == 3:               # K3: the rank's experts
                e, k = whole.codes.shape[0], whole.shape[1]
                per = share.codes.shape[0]
                rows = slice(i * per, (i + 1) * per)
                x = torch.randn((e, m, k), generator=gen,
                                device=whole.codes.device).to(torch.bfloat16)
                a = fdm.grouped_fused_decode_matmul(
                    x[rows], share.codes, share.literals, lut, share.scale,
                    share.zero, shape=share.shape, plan_experts=e, **kw)
                b = fdm.grouped_fused_decode_matmul(
                    x, whole.codes, whole.literals, lut, whole.scale,
                    whole.zero, shape=whole.shape, **kw)[rows]
            else:                                   # K1: an out band
                n, k = whole.shape
                per = share.shape[0]
                x = rand_x(m, k, gen, whole.codes.device)
                a = fdm.fused_decode_matmul(
                    x, share.codes, share.literals, lut, share.scale,
                    share.zero, shape=share.shape, plan_n=n, **kw)
                b = fdm.fused_decode_matmul(
                    x, whole.codes, whole.literals, lut, whole.scale,
                    whole.zero, shape=whole.shape, **kw
                    )[:, i * per:(i + 1) * per]
            out[f"{label} M={m}"] = bool(torch.equal(a, b))
    return out


def tensor_bytes(rt, tree) -> int:
    """Bytes of every tensor of a tree (meta tensors included)."""
    return sum(t.numel() * t.element_size()
               for t in rt["engine"]._tensors(tree))


def cache_report(rt, cfg, b, length, mesh, device) -> dict:
    """The rank's caches of ``b`` rows and ``length`` positions as
    ``lm.init_caches(mesh=)`` allocates them (``generate``'s), beside the
    whole caches' bytes at the same (rounded) length, and this process's
    peak memory on the card since its last reset."""
    LM, PT = rt["LM"], rt["partition"]
    share = LM.init_caches(cfg, b, length, device="meta", mesh=mesh)
    whole = LM.init_caches(cfg, b, PT.cache_len(cfg, length, mesh),
                           device="meta")
    return {"cache_bytes": tensor_bytes(rt, share),
            "whole_cache_bytes": tensor_bytes(rt, whole),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(device)}


def mesh_llama(rt, mesh, p, rec, gen, timer) -> dict:
    """Llama-3.2-1B on MESH_LLAMA: a prefill on the mesh (the process's
    first: kernel loads, library handles, gloo's first collectives), then
    one timed, then ``generate`` on the mesh (the counted main path; its
    decode ms a step is its time past the timed prefill's); on rank 0, K1
    on the layers' out bands and K5 on the head's band, each launched
    with the whole weight's plan as the mesh path launches it, against
    their plain versions (``check_fused``, ``check_k5``) and against the
    whole weight's launch (``band_bits``, layer 0)."""
    cfg, lut, ids = p["cfg"], p["lut"], p["ids"]
    device = ids.device
    b, t0 = ids.shape
    params = rt["partition"].place_params(p["params"], mesh)
    ctx = rt["ServeContext"](cfg, lut=lut, device=device, mesh=mesh)
    prefill, _ = rt["make_serve_fns"](ctx=ctx)
    caches = rt["LM"].init_caches(cfg, b, t0 + MAX_NEW, device=device,
                                  mesh=mesh)
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill(params, lut, {"tokens": ids}, caches)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
    del caches
    rec.clear()
    torch.cuda.reset_peak_memory_stats(device)
    toks, run = counted_run(rt, lambda: rt["generate"](
        params, cfg, ids, ctx=ctx, max_new=MAX_NEW))
    out = {"tokens": toks[:, t0:].cpu(), "run": run,
           "launch_shapes": rec.table(), "prefill_ms": prefill_ms,
           "step_ms": (run["s"] * 1e3 - prefill_ms) / (MAX_NEW - 1),
           "rows": [], **cache_report(rt, cfg, b, t0 + MAX_NEW, mesh,
                                      device)}
    if mesh.rank == 0:
        blocks = params["blocks"]
        projections = [(name, [b[grp][name] for b in blocks], True)
                       for grp, name in (("attn", "wq"), ("attn", "wk"),
                                         ("attn", "wv"), ("attn", "wo"),
                                         ("mlp", "w_gate"), ("mlp", "w_up"),
                                         ("mlp", "w_down"))]
        shards = mesh.shape["model"]
        row, _ = check_fused(rt, lut, projections, device, ids.numel(), gen,
                             timer, f"one layer's 7 out bands (N/{shards}, "
                             f"planned for N), decode M={BATCH}",
                             shards=shards)
        k1 = run["kernel_launches"]
        out["rows"].append(dict(
            row, name="fused_decode_matmul (mesh band N/2)",
            launches=k1.get("fused_decode_matmul:decode", 0)
            + k1.get("fused_decode_matmul:mma", 0),
            launches_of=f"{cfg.name} generate on mesh {MESH_LLAMA}, rank 0"))
        head, whole_head = params["embed"], p["params"]["embed"]
        n = whole_head.values.shape[0]
        band = slice(0, n // mesh.shape["model"])
        # the rank stores its vocab band (partition.place_vocab), which
        # K5 reads: the whole head's rows, byte for byte
        out["head_band_stored"] = bool(
            head.mesh_axes == ("model",)
            and torch.equal(head.values, whole_head.values[band])
            and torch.equal(head.scale, whole_head.scale[band]))
        wq, sc, zr = head.values, head.scale, head.zero
        out["rows"].append({
            **K5_ROW, **check_k5(rt, wq, sc, zr, whole_head.materialize(
                torch.bfloat16)[band], BATCH, gen, timer, decode=True,
                plan_n=n),
            "name": "dequant_matmul (mesh, stored vocab band N/2)",
            "timed_at": f"LM head band {wq.shape[0]}x{wq.shape[1]} of {n} "
                        f"(stored on the rank, planned for N), M={BATCH} "
                        "(decode)",
            "launches": run["launches"].get("dequant_matmul", 0),
            "launches_of": f"{cfg.name} generate on mesh {MESH_LLAMA}, "
                           "rank 0"})
        shards = mesh.shape["model"]
        hd = cfg.resolved_head_dim
        row, _ = check_flash(rt, device, t0, gen, timer,
                             cfg.n_heads // shards, cfg.n_kv_heads // shards,
                             hd, hd, f"{cfg.name} prefill, the rank's heads "
                             f"(H/{shards}) on mesh {MESH_LLAMA}")
        out["rows"].append(dict(
            row, name=f"flash_attention (mesh, the rank's heads H/{shards})",
            launches=run["kernel_launches"].get("flash_attention:mma", 0),
            launches_of=f"{cfg.name} generate on mesh {MESH_LLAMA}, "
                        "rank 0"))
        whole = p["params"]
        out["band_bits"] = band_bits(
            rt, mesh, lut, [(name, whole["blocks"][0][grp][name],
                             blocks[0][grp][name])
                            for grp, name in (("attn", "wq"), ("attn", "wk"),
                                              ("attn", "wv"), ("attn", "wo"),
                                              ("mlp", "w_gate"),
                                              ("mlp", "w_up"),
                                              ("mlp", "w_down"))]
            + [("head", whole_head, None)], (BATCH, ids.numel()), gen)
    return out


def mesh_rows(rt, mesh, p, rec, gen, timer) -> dict:
    """Llama-3.2-1B (MESH_ROWS_LAYERS layers) on MESH_WIDE through
    ``generate``: each data rank
    prefills and decodes its rows of the batch (``partition.batch_rows``)
    over its caches of those rows and of its heads, and the new tokens
    are gathered over data at the end (the counted main path)."""
    cfg, lut, ids = p["cfg"], p["lut"], p["ids"]
    device = ids.device
    b, t0 = ids.shape
    params = rt["partition"].place_params(p["params"], mesh)
    ctx = rt["ServeContext"](cfg, lut=lut, device=device, mesh=mesh)
    rows = rt["partition"].batch_rows(mesh, b)
    rec.clear()
    torch.cuda.reset_peak_memory_stats(device)
    toks, run = counted_run(rt, lambda: rt["generate"](
        params, cfg, ids, ctx=ctx, max_new=MAX_NEW))
    return {"tokens": toks[:, t0:].cpu(), "run": run,
            "rows_held": [rows.start, rows.stop],
            "launch_shapes": rec.table(), "step_ms": None,
            "prefill_ms": None, "s": run["s"],
            **cache_report(rt, cfg, b, t0 + MAX_NEW, mesh, device)}


def mesh_eager(rt, mesh, p, rec, gen, timer) -> dict:
    """A model on MESH_WIDE: ``make_serve_fns`` on the mesh, a prefill and
    MAX_NEW − 1 eager decode steps (the counted main path; its prefill ms
    is the model's first in the rank, loads and warm-up included); rank 0
    keeps every step's logits and, for an MoE model, checks K3 on its
    experts as the mesh path launches it (``check_grouped`` on the last
    layer's stacks: E/model experts planned for E, at the capacities of
    a decode step and of its data shard's prefill; ``band_bits`` against
    the whole stacks' launch)."""
    cfg, lut, ids = p["cfg"], p["lut"], p["ids"]
    params = rt["partition"].place_params(p["params"], mesh)
    ctx = rt["ServeContext"](cfg, lut=lut, device=ids.device, mesh=mesh)
    rec.clear()
    torch.cuda.reset_peak_memory_stats(ids.device)
    (toks, logits, prefill_ms, step_ms), run = counted_run(
        rt, lambda: eager_logits(rt, cfg, params, lut, ids, ctx))
    out = {"tokens": toks.cpu(), "run": run, "launch_shapes": rec.table(),
           "prefill_ms": prefill_ms, "step_ms": step_ms,
           "logits": logits.cpu() if mesh.rank == 0 else None, "rows": [],
           **cache_report(rt, cfg, ids.shape[0], ids.shape[1] + MAX_NEW,
                          mesh, ids.device)}
    if mesh.rank == 0 and cfg.n_experts:
        held = types.SimpleNamespace(
            params={"blocks": params["blocks"][-1:]}, lut=lut)
        n_prefill = ids.numel() // mesh.shape["data"]
        row, _ = check_grouped(rt, cfg, held, ids.device, n_prefill, gen,
                               timer, plan_experts=cfg.n_experts)
        kl = run["kernel_launches"]
        out["rows"].append(dict(
            row, name="grouped_fused_decode_matmul (mesh, E/2 experts)",
            launches=kl.get("grouped_fused_decode_matmul:decode", 0)
            + kl.get("grouped_fused_decode_matmul:mma", 0),
            launches_of=f"{cfg.name} at {cfg.n_layers} layers on mesh "
                        f"{MESH_WIDE}, rank 0"))
        L = rt["L"]
        caps = sorted({L._capacity(n, cfg.top_k, cfg.n_experts,
                                   cfg.capacity_factor)
                       for n in (BATCH // mesh.shape["data"], n_prefill)})
        whole = p["params"]["blocks"][-1]["moe"]["experts"]
        mine = params["blocks"][-1]["moe"]["experts"]
        out["band_bits"] = band_bits(
            rt, mesh, lut, [(name, whole[name], mine[name])
                            for name in ("w_gate", "w_up", "w_down")],
            caps, gen)
    return out


def mesh_ssm(rt, mesh, p, rec, gen, timer) -> dict:
    """Mamba2-2.7B (MESH_SSM_LAYERS blocks) on MESH_SSM, each model rank
    on its own SSM heads (``ssm.apply_mamba2``: K1 on its in_proj and
    out_proj out bands, its state (B, H/2, P, N) and its channels of the
    conv window): ``generate`` (the counted main path), then the eager
    loop on the mesh for its logits; on rank 0, K1 on the two bands
    against their plain versions (``check_fused``, each launch planned for
    the whole weight) and against the whole weight's launch
    (``band_bits``, block 0)."""
    cfg, lut, ids = p["cfg"], p["lut"], p["ids"]
    device = ids.device
    b, t0 = ids.shape
    params = rt["partition"].place_params(p["params"], mesh)
    ctx = rt["ServeContext"](cfg, lut=lut, device=device, mesh=mesh)
    rec.clear()
    torch.cuda.reset_peak_memory_stats(device)
    toks, run = counted_run(rt, lambda: rt["generate"](
        params, cfg, ids, ctx=ctx, max_new=MAX_NEW))
    shapes = rec.table()
    report = cache_report(rt, cfg, b, t0 + MAX_NEW, mesh, device)
    share = rt["LM"].init_caches(cfg, b, t0 + MAX_NEW, device="meta",
                                 mesh=mesh)
    etoks, logits, prefill_ms, step_ms = eager_logits(rt, cfg, params, lut,
                                                      ids, ctx)
    out = {"tokens": toks[:, t0:].cpu(), "eager_tokens": etoks.cpu(),
           "run": run, "launch_shapes": shapes, "prefill_ms": prefill_ms,
           "step_ms": step_ms,
           "logits": logits.cpu() if mesh.rank == 0 else None,
           "cache_shapes": {k: list(v.shape)
                            for k, v in share["blocks"][0].items()},
           "conv_w_rows": int(params["blocks"][0]["mamba"]["conv_w"].shape[0]),
           "rows": [], **report}
    if mesh.rank == 0:
        blocks = params["blocks"]
        shards = mesh.shape["model"]
        row, _ = check_fused(
            rt, lut, [(name, [blk["mamba"][name] for blk in blocks], True)
                      for name in ("in_proj", "out_proj")],
            device, ids.numel(), gen, timer,
            f"one Mamba2 block's in_proj and out_proj out bands "
            f"(N/{shards}, planned for N), decode M={BATCH}", shards=shards)
        k1 = run["kernel_launches"]
        out["rows"].append(dict(
            row, name=f"fused_decode_matmul (mesh band N/{shards}, Mamba2 "
                      "in_proj/out_proj)",
            launches=k1.get("fused_decode_matmul:decode", 0)
            + k1.get("fused_decode_matmul:mma", 0),
            launches_by_kernel={k: v for k, v in k1.items()
                                if k.startswith("fused_decode_matmul:")},
            launches_of=f"{cfg.name} at {cfg.n_layers} blocks, generate on "
                        f"mesh {MESH_SSM}, rank 0"))
        whole = p["params"]["blocks"][0]["mamba"]
        out["band_bits"] = band_bits(
            rt, mesh, lut, [(name, whole[name], blocks[0]["mamba"][name])
                            for name in ("in_proj", "out_proj")],
            (BATCH, ids.numel()), gen)
    return out


def mesh_rank(rank: int, payload: dict) -> dict:
    """One rank of the mesh phase (``launch.mesh.spawn``: each rank a
    process on the one card, the payload's planes its parent's, shared
    through CUDA IPC): Llama on MESH_LLAMA, Mamba2 on MESH_SSM (ranks
    past them wait), then DeepSeek-V2-Lite and the tiled Llama on
    MESH_WIDE."""
    rt = load_runtime()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device())
    M = rt["mesh"]
    rec = LaunchShapes.install(rt)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + rank)
    out = {}
    with torch.no_grad():
        mesh = M.make_mesh(MESH_LLAMA, ("data", "model"))
        if mesh is not None:
            timer = Timer(device) if mesh.rank == 0 else None
            out["llama"] = mesh_llama(rt, mesh, payload["llama"], rec, gen,
                                      timer)
            del timer
        mesh = M.make_mesh(MESH_SSM, ("data", "model"))
        if mesh is not None:
            timer = Timer(device) if mesh.rank == 0 else None
            out["mamba"] = mesh_ssm(rt, mesh, payload["mamba"], rec, gen,
                                    timer)
            del timer
        mesh = M.make_mesh(MESH_WIDE, ("data", "model"))
        timer = Timer(device) if mesh.rank == 0 else None
        out["rows"] = mesh_rows(rt, mesh, payload["rows"], rec, gen, timer)
        for key in ("deepseek", "tiled"):
            out[key] = mesh_eager(rt, mesh, payload[key], rec, gen, timer)
        mesh = M.make_mesh(MESH_SPREAD, ("data", "model"))
        out["spread"] = mesh_eager(rt, mesh, payload["spread"], rec, gen,
                                   timer)
    return out


def mesh_phase(rt, device, gen, timer, kernels, faults) -> dict:
    """Serving on a device mesh, MESH_RANKS ranks sharing the card over
    gloo (``launch.mesh.spawn``), each on its share of the planes
    (``sharding.partition.place_params``):
      * Llama-3.2-1B at full width and depth, compressed for 2 model
        ranks, on MESH_LLAMA: the fixed batch, MAX_NEW tokens through
        ``generate``; tokens bitwise the one-process eager loop's over the
        same planes; every K1 launch at an out band's N (N/2), K5 at the
        head's band, as many K1 launches a rank as one process makes, no
        SIMT launch; K1/K5 rows on the bands, each launched with the
        whole weight's plan, and each band's launch bitwise the whole
        weight's columns (``band_bits``).
      * DeepSeek-V2-Lite at full width, MESH_DS_LAYERS layers, dropless,
        ``moe_local_dispatch`` on MESH_WIDE: prefill logits within
        MESH_LOGIT_ATOL of one process (global dispatch), tokens under
        the exact-tie rule; K3 on 32 experts a rank (planned for 64, and
        bitwise the whole stacks' launch on them), K4 (wkv_b) and K2
        launched on every rank.
      * Llama-3.2-1B tiled (tiles 2), MESH_TILED_LAYERS layers, on
        MESH_WIDE: prefill logits within MESH_LOGIT_ATOL, tokens under
        the exact-tie rule.
      * Mamba2-2.7B at full width, MESH_SSM_LAYERS blocks, compressed for
        2 model ranks, on MESH_SSM, each model rank on its 40 SSM heads:
        the fixed batch, MAX_NEW tokens through ``generate``; tokens
        against the one-process eager loop over the same planes, bitwise
        or under the exact-tie rule with the prefill logits within
        MESH_LOGIT_ATOL (``held`` says which); each rank's SSM state
        (B, 40, 64, 128), its channels of the conv window and conv_w, its
        caches half the whole's; every K1 launch at an out band's N (the
        whole weight's plan), K5 at the head's band, no SIMT launch; a K1
        row on the two bands and each band's launch bitwise the whole
        weight's columns.
    Per-rank ms a step are of ranks sharing one card, not a multi-card
    speed."""
    get, replace = rt["get_config"], dataclasses.replace
    mshards = MESH_LLAMA[1]
    cfg = get("llama3.2-1b").full
    batch, lens = make_prompts(cfg.vocab_size)
    ids = torch.from_numpy(batch).to(device)
    llama, _ = pack(rt, cfg, device, SEED, model_shards=mshards)
    zero_counts(rt)
    ref_toks, _ = eager_loop(rt, cfg, llama, ids)
    one_k1 = {k: v for k, v in rt["_build"].KERNEL_COUNTS.items()
              if k.startswith("fused_decode_matmul")}
    full = get("deepseek-v2-lite-16b").full
    dcfg = replace(full, n_layers=MESH_DS_LAYERS,
                   capacity_factor=full.n_experts / full.top_k)
    dbatch, _ = make_prompts(dcfg.vocab_size)
    dids = torch.from_numpy(dbatch).to(device)
    ds, _ = pack(rt, dcfg, device, SEED, model_shards=MESH_WIDE[1])
    d_ref = eager_logits(rt, dcfg, ds.params, ds.lut, dids)
    tcfg = replace(cfg, n_layers=MESH_TILED_LAYERS)
    tiled, _ = pack(rt, tcfg, device, SEED, tiles=2,
                    model_shards=MESH_WIDE[1])
    t_ref = eager_logits(rt, tcfg, tiled.params, tiled.lut, ids)
    # Llama cut to MESH_ROWS_LAYERS layers (the same packed planes), and
    # one process serving each data rank's rows of the batch alone
    rcfg = replace(cfg, n_layers=MESH_ROWS_LAYERS)
    rstate = types.SimpleNamespace(
        params={**llama.params,
                "blocks": llama.params["blocks"][:MESH_ROWS_LAYERS]},
        lut=llama.lut)
    row_refs = {}
    for d in range(MESH_WIDE[0]):
        per = ids.shape[0] // MESH_WIDE[0]
        rows = slice(d * per, (d + 1) * per)
        row_refs[(rows.start, rows.stop)] = eager_loop(
            rt, rcfg, rstate, ids[rows])[0].cpu()
    # Mamba2-2.7B cut to MESH_SSM_LAYERS blocks, packed for its model
    # ranks; one process's eager loop (tokens, every step's logits)
    mcfg = replace(get("mamba2-2.7b").full, n_layers=MESH_SSM_LAYERS)
    mbatch, _ = make_prompts(mcfg.vocab_size)
    mids = torch.from_numpy(mbatch).to(device)
    mamba, _ = pack(rt, mcfg, device, SEED, model_shards=MESH_SSM[1])
    m_ref = eager_logits(rt, mcfg, mamba.params, mamba.lut, mids)
    scfg = get("llama3.2-1b").smoke
    sbatch, _ = make_prompts(scfg.vocab_size)
    sids = torch.from_numpy(sbatch).to(device)
    # the smoke weights are below the default policy's size floor: packed
    # at 1 024 weights, as the launcher packs them (bf16 activations, K1,
    # K5 and K2 at the smoke head dims)
    spread = rt["build_serve_params"](
        rt["LM"].init_lm(scfg, seed=SEED, device=device),
        rt["CompressionPolicy"](mode="compressed", min_weight_size=1024),
        model_shards=MESH_SPREAD[1], device=device)
    s_ref = eager_logits(rt, scfg, spread.params, spread.lut, sids)
    payload = {
        "llama": {"cfg": cfg, "params": llama.params, "lut": llama.lut,
                  "ids": ids},
        "mamba": {"cfg": mcfg, "params": mamba.params, "lut": mamba.lut,
                  "ids": mids},
        "rows": {"cfg": rcfg, "params": rstate.params, "lut": llama.lut,
                 "ids": ids},
        "deepseek": {"cfg": replace(dcfg, moe_local_dispatch=True),
                     "params": ds.params, "lut": ds.lut, "ids": dids},
        "tiled": {"cfg": tcfg, "params": tiled.params, "lut": tiled.lut,
                  "ids": ids},
        "spread": {"cfg": scfg, "params": spread.params, "lut": spread.lut,
                   "ids": sids}}
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = rt["mesh"].spawn(mesh_rank, MESH_RANKS, payload, device="cuda")
    spawn_s = time.perf_counter() - t
    res = {"spawn_s": spawn_s, "ranks": MESH_RANKS,
           "note": "ranks share one card: per-rank ms are not a multi-card "
                   "speed", "llama": {}, "mamba": {}, "rows": {},
           "deepseek": {}, "tiled": {}, "spread": {}}

    def caches_of(o, split):
        """A rank's cache bytes, gated to be the whole caches' 1/split."""
        got = {k: o[k] for k in ("cache_bytes", "whole_cache_bytes",
                                 "peak_mem_bytes")}
        got["split"] = split
        return got, o["cache_bytes"] * split == o["whole_cache_bytes"]

    # Llama on MESH_LLAMA
    bands = {w.shape[0] // mshards for b in llama.params["blocks"]
             for grp in ("attn", "mlp") for w in b[grp].values()}
    head_band = llama.params["embed"].values.shape[0] // mshards
    for r, out in enumerate(outs[:math.prod(MESH_LLAMA)]):
        o = out["llama"]
        k1 = {k: v for k, v in o["run"]["kernel_launches"].items()
              if k.startswith("fused_decode_matmul")}
        ns = {int(key.split("N=")[1].split()[0]) for key in o["launch_shapes"]
              if key.startswith("fused_decode_matmul ")}
        k5n = {int(key.split("N=")[1].split()[0]) for key in o["launch_shapes"]
               if key.startswith("dequant_matmul ")}
        mem, split_ok = caches_of(o, MESH_LLAMA[1])
        res["llama"][f"rank{r}"] = {
            "tokens_equal": bool(torch.equal(o["tokens"], ref_toks.cpu())),
            "prefill_ms": o["prefill_ms"], "step_ms": o["step_ms"],
            "kernel_launches": o["run"]["kernel_launches"],
            "dispatch": o["run"]["dispatch"],
            "launch_shapes": o["launch_shapes"], **mem}
        if not split_ok:
            faults.append(f"llama mesh rank {r}: caches {mem}")
        if "head_band_stored" in o and not o["head_band_stored"]:
            faults.append(f"llama mesh rank {r}: the head's vocab band is "
                          "not the stored rows")
        if not torch.equal(o["tokens"], ref_toks.cpu()):
            faults.append(f"llama mesh rank {r}: tokens differ from the "
                          "one-process eager loop")
        if k1 != one_k1 or ns != bands or k5n != {head_band}:
            faults.append(f"llama mesh rank {r}: K1 {k1} vs one process "
                          f"{one_k1}, K1 N {sorted(ns)} vs bands "
                          f"{sorted(bands)}, K5 N {sorted(k5n)}")
        if o["run"]["kernel_launches"].get("fused_decode_matmul:simt"):
            faults.append(f"llama mesh rank {r}: SIMT launched")
        if "band_bits" in o:
            res["llama"]["band_bits"] = o["band_bits"]
            if not all(o["band_bits"].values()):
                faults.append(f"llama mesh rank {r}: a band's launch "
                              f"differs from the whole weight's: "
                              f"{o['band_bits']}")
        if set(o["run"]["dispatch"]) != {"fused_shard_map",
                                         "dequant_shard_map"}:
            faults.append(f"llama mesh rank {r}: dispatch "
                          f"{o['run']['dispatch']}")
        for row in o["rows"]:
            kernels.append(dict(row, path=f"{cfg.name} mesh {MESH_LLAMA}"))

    # Mamba2 on MESH_SSM: each model rank on its SSM heads
    ms = MESH_SSM[1]
    whole0 = mamba.params["blocks"][0]["mamba"]
    bands = {whole0[name].shape[0] // ms for name in ("in_proj", "out_proj")}
    head_band = mamba.params["embed"].values.shape[0] // ms
    want_ssm = [BATCH, mcfg.ssm_heads // ms, mcfg.ssm_head_dim,
                mcfg.ssm_state]
    want_conv = [BATCH, mcfg.ssm_conv - 1,
                 (mcfg.d_inner + 2 * mcfg.ssm_n_groups * mcfg.ssm_state)
                 // ms]
    logits0 = outs[0]["mamba"]["logits"]
    err = float((logits0[0] - m_ref[1][0].cpu()).abs().max())
    res["mamba"]["prefill_logit_err"] = err
    for r, out in enumerate(outs[:math.prod(MESH_SSM)]):
        o = out["mamba"]
        kl = o["run"]["kernel_launches"]
        ns = {int(key.split("N=")[1].split()[0]) for key in o["launch_shapes"]
              if key.startswith("fused_decode_matmul ")}
        k5n = {int(key.split("N=")[1].split()[0]) for key in o["launch_shapes"]
               if key.startswith("dequant_matmul ")}
        bitwise = bool(torch.equal(o["tokens"], m_ref[0].cpu()))
        parting = tie_rule(o["tokens"], m_ref[0].cpu(), logits0,
                           m_ref[1].cpu())
        held = ("bitwise" if bitwise else "exact-tie rule"
                if all(p["tied"] for p in parting) and err <= MESH_LOGIT_ATOL
                else None)
        mem, split_ok = caches_of(o, ms)
        res["mamba"][f"rank{r}"] = {
            "tokens_equal": bitwise, "held": held, "parting": parting,
            "generate_equals_eager": bool(torch.equal(o["tokens"],
                                                      o["eager_tokens"])),
            "prefill_ms": o["prefill_ms"], "step_ms": o["step_ms"],
            "generate_s": o["run"]["s"], "kernel_launches": kl,
            "dispatch": o["run"]["dispatch"],
            "launch_shapes": o["launch_shapes"],
            "cache_shapes": o["cache_shapes"],
            "conv_w_rows": o["conv_w_rows"], **mem}
        if held is None:
            faults.append(f"mamba mesh rank {r}: tokens part from one process "
                          f"(prefill logits {err} vs {MESH_LOGIT_ATOL}, "
                          f"{parting})")
        if not torch.equal(o["tokens"], o["eager_tokens"]) or \
                not torch.equal(o["tokens"], outs[0]["mamba"]["tokens"]):
            faults.append(f"mamba mesh rank {r}: generate's tokens differ "
                          "from the mesh's eager loop or from rank 0's")
        if (o["cache_shapes"]["ssm"] != want_ssm
                or o["cache_shapes"]["conv"] != want_conv or not split_ok
                or o["conv_w_rows"] != want_conv[2]):
            faults.append(f"mamba mesh rank {r}: caches {o['cache_shapes']} "
                          f"(want ssm {want_ssm}, conv {want_conv}), {mem}, "
                          f"conv_w rows {o['conv_w_rows']}")
        if ns != bands or k5n != {head_band} or not (
                kl.get("fused_decode_matmul:decode", 0)
                + kl.get("fused_decode_matmul:mma", 0)):
            faults.append(f"mamba mesh rank {r}: K1 N {sorted(ns)} vs bands "
                          f"{sorted(bands)}, K5 N {sorted(k5n)}, launches "
                          f"{kl}")
        if kl.get("fused_decode_matmul:simt"):
            faults.append(f"mamba mesh rank {r}: SIMT launched")
        if not o["run"]["dispatch"].get("fused_shard_map") or \
                o["run"]["dispatch"].get("unfused"):
            faults.append(f"mamba mesh rank {r}: dispatch "
                          f"{o['run']['dispatch']}")
        if "band_bits" in o:
            res["mamba"]["band_bits"] = o["band_bits"]
            if not all(o["band_bits"].values()):
                faults.append(f"mamba mesh rank {r}: a band's launch differs "
                              f"from the whole weight's: {o['band_bits']}")
        for row in o["rows"]:
            kernels.append(dict(row, path=f"{mcfg.name} mesh {MESH_SSM}"))
    log("mesh_ssm " + json.dumps({
        "model": f"{mcfg.name} at {MESH_SSM_LAYERS} of 64 blocks (full "
                 "width), compressed for 2 model ranks",
        "device": nvidia_smi_line(), **{k: v for k, v in res["mamba"].items()
                                        if not k.startswith("rank")},
        "per_rank": {r: {f: d[f] for f in (
            "held", "tokens_equal", "prefill_ms", "step_ms", "generate_s",
            "cache_bytes", "whole_cache_bytes", "peak_mem_bytes",
            "cache_shapes")}
            for r, d in res["mamba"].items() if r.startswith("rank")}},
        default=str))

    # Llama's rows over data on MESH_WIDE: each data rank's rows bitwise
    # one process serving them alone
    for r, out in enumerate(outs):
        o = out["rows"]
        rows = tuple(o["rows_held"])
        mem, split_ok = caches_of(o, math.prod(MESH_WIDE))
        res["rows"][f"rank{r}"] = {
            "rows": rows, "s": o["s"],
            "rows_equal_alone": bool(torch.equal(
                o["tokens"][rows[0]:rows[1]], row_refs[rows])),
            "whole_equal_one_process": bool(torch.equal(
                o["tokens"], ref_toks.cpu())),
            "kernel_launches": o["run"]["kernel_launches"],
            "dispatch": o["run"]["dispatch"], **mem}
        if not res["rows"][f"rank{r}"]["rows_equal_alone"]:
            faults.append(f"llama rows mesh rank {r}: its rows {rows} "
                          "differ from one process serving them alone")
        if not torch.equal(o["tokens"], outs[0]["rows"]["tokens"]):
            faults.append(f"llama rows mesh rank {r}: tokens differ from "
                          "rank 0's")
        if not split_ok:
            faults.append(f"llama rows mesh rank {r}: caches {mem}")
        if o["run"]["kernel_launches"].get("fused_decode_matmul:simt"):
            faults.append(f"llama rows mesh rank {r}: SIMT launched")

    # DeepSeek-V2-Lite (local routing) and the tiled Llama on MESH_WIDE,
    # the Llama smoke model's positions split on MESH_SPREAD
    e_loc = dcfg.n_experts // MESH_WIDE[1]
    splits = {"deepseek": math.prod(MESH_WIDE), "tiled": math.prod(MESH_WIDE),
              "spread": MESH_SPREAD[1]}
    for key, ref, model in (("deepseek", d_ref, dcfg), ("tiled", t_ref,
                                                        tcfg),
                            ("spread", s_ref, scfg)):
        logits0 = outs[0][key]["logits"]
        err = float((logits0[0] - ref[1][0].cpu()).abs().max())
        parting = tie_rule(outs[0][key]["tokens"], ref[0].cpu(), logits0,
                           ref[1].cpu())
        res[key]["prefill_logit_err"] = err
        res[key]["parting"] = parting
        if not err <= MESH_LOGIT_ATOL:
            faults.append(f"{key} mesh: prefill logits {err} > "
                          f"{MESH_LOGIT_ATOL}")
        if not all(p["tied"] for p in parting):
            faults.append(f"{key} mesh: tokens part from one process "
                          f"away from an exact tie: {parting}")
        bits = outs[0][key].get("band_bits")
        if bits is not None:
            res[key]["band_bits"] = bits
            if not all(bits.values()):
                faults.append(f"{key} mesh: the rank's experts' launch "
                              f"differs from the whole stack's: {bits}")
        for r, out in enumerate(outs):
            o = out[key]
            kl = o["run"]["kernel_launches"]
            mem, split_ok = caches_of(o, splits[key])
            res[key][f"rank{r}"] = {
                "prefill_ms": o["prefill_ms"], "step_ms": o["step_ms"],
                "kernel_launches": kl, "launches": o["run"]["launches"],
                "dispatch": o["run"]["dispatch"],
                "launch_shapes": o["launch_shapes"],
                "tokens_equal_rank0": bool(torch.equal(
                    o["tokens"], outs[0][key]["tokens"])), **mem}
            if not split_ok:
                faults.append(f"{key} mesh rank {r}: caches {mem}")
            if not torch.equal(o["tokens"], outs[0][key]["tokens"]):
                faults.append(f"{key} mesh rank {r}: tokens differ from "
                              "rank 0's")
            if kl.get("fused_decode_matmul:simt"):
                faults.append(f"{key} mesh rank {r}: SIMT launched")
            if key == "deepseek":
                k3e = {int(k.split("E=")[1]) for k in o["launch_shapes"]
                       if k.startswith("grouped_fused_decode_matmul ")}
                if k3e != {e_loc} or not o["run"]["launches"].get(
                        "dict_decode") or not o["run"]["launches"].get(
                        "flash_attention") or not o["run"]["dispatch"].get(
                        "grouped_fused_shard_map"):
                    faults.append(f"deepseek mesh rank {r}: K3 E {k3e} "
                                  f"(want {e_loc}), launches "
                                  f"{o['run']['launches']}, dispatch "
                                  f"{o['run']['dispatch']}")
            elif key == "spread":
                if not (o["run"]["kernel_launches"].get("flash_attention:mma")
                        and o["run"]["launches"].get("fused_decode_matmul")):
                    faults.append(f"spread mesh rank {r}: launches "
                                  f"{o['run']['launches']}")
            elif not o["run"]["dispatch"].get("tiled_fused_shard_map"):
                faults.append(f"tiled mesh rank {r}: dispatch "
                              f"{o['run']['dispatch']}")
            for row in o["rows"]:
                kernels.append(dict(row, path=f"{model.name} mesh "
                                    f"{MESH_WIDE}"))
    keys = ("llama", "mamba", "rows", "deepseek", "tiled", "spread")
    log("mesh_detail " + json.dumps({k: v for k, v in res.items()
                                     if k in keys}, default=str))
    return {"spawn_s": spawn_s, "note": res["note"], "summary": {
        key: {r: {f: v for f, v in d.items()
                  if f in ("prefill_ms", "step_ms", "s", "tokens_equal",
                           "held", "rows_equal_alone", "cache_bytes",
                           "whole_cache_bytes", "peak_mem_bytes")}
              for r, d in res[key].items() if r.startswith("rank")}
        for key in keys},
        "deepseek_logit_err": res["deepseek"]["prefill_logit_err"],
        "tiled_logit_err": res["tiled"]["prefill_logit_err"],
        "spread_logit_err": res["spread"]["prefill_logit_err"],
        "mamba_logit_err": res["mamba"]["prefill_logit_err"],
        "parting": {k: res[k]["parting"] for k in ("deepseek", "tiled",
                                                   "spread")},
        "band_bits": {k: res[k].get("band_bits")
                      for k in ("llama", "mamba", "deepseek")}}


# Training on a mesh (``train_mesh_phase``): MESH_RANKS ranks sharing the
# card over gloo, each storing its shard of the train state (ZeRO-3).
TRAIN_MESH = (2, 2)          # Llama-3.2-1B: the train steps, a checkpoint
TRAIN_MESH_RESTORE = (1, 2)  # the checkpoint restored onto it, one step
TRAIN_MESH_MOE = (1, 2)      # DeepSeek-V2-Lite: a step, experts on model
# Llama-3.2-1B at full width cut to 2 of its 16 layers (four ranks share
# the card; each gathers a block's leaves over data where the block uses
# them, twice with the config's remat, and computes its model rank's
# heads, FFN columns and vocab band), 2 steps of TRAIN_BATCH x TRAIN_SEQ
# tokens, the checkpoint after step 1 (3 steps and the checkpoint after
# step 2 took the phase past its ~60 s when a step gathered the whole
# parameters: 1.5 GB a rank through gloo's host staging).
# f32 Adam moments, as the one-device train phase: int8 moments part the
# mesh's losses from one process's by 9.3e-4 at step 3 (`pr32_try2`: a
# moment's code that roundoff moves between 0 and 1 moves its element by
# about lr; tests/test_torch_train.py holds them step by step).
TRAIN_MESH_LAYERS, TRAIN_MESH_STEPS, TRAIN_MESH_CKPT = 2, 2, 1
MESH_MOE_LAYERS = 2          # DeepSeek-V2-Lite at full width, 2 layers
TRAIN_MESH_SSM = (1, 2)      # Mamba2-2.7B: steps, its SSM heads on model
TRAIN_MESH_SSM_LAYERS = 2    # of its 64 blocks, full width, f32
TRAIN_MESH_SSM_STEPS = 2     # the second step's loss reads the first's update
#  * Each step's loss on the mesh (and after the restores) against one
#    process's on the card: a data rank's GEMMs take 512 of the 1 024
#    rows and the gradients add over ranks in another order (f32
#    roundoff); AdamW at lr 5e-3 sends an element whose gradient is near
#    eps by up to lr (tests/test_torch_mesh_train.py), which the steps
#    carry into the loss (measured at 3 steps: 5.2e-7, `pr32_try1`).  The
#    DeepSeek step's loss (the MoE's aux in it), and Mamba2's losses and
#    gradient norms, are held to it too.
TRAIN_MESH_LOSS_RTOL = 1e-5


def _mesh_step(mesh, step, shards, batch) -> tuple:
    """One train step on ``mesh``, timed: → (shards, its record: loss,
    grad norm, ms, the bytes received and the wall seconds spent by
    collective, ``Mesh.traffic`` and ``Mesh.seconds``)."""
    bytes0 = collections.Counter(mesh.traffic)
    secs0 = collections.Counter(mesh.seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shards, m = step(shards, batch)
    loss = float(m["loss"])
    return shards, {"loss": loss, "grad_norm": float(m["grad_norm"]),
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "bytes": dict(mesh.traffic - bytes0),
                    "comm_s": dict(mesh.seconds - secs0)}


def train_mesh_rank(rank: int, payload: dict) -> dict:
    """One rank of the train-mesh phase (``launch.mesh.spawn``; the
    parent's weights reach it through CUDA IPC): Llama-3.2-1B's train
    state sharded on TRAIN_MESH, TRAIN_MESH_STEPS steps (counted, timed,
    the bytes and seconds of each step's collectives), the
    step-TRAIN_MESH_CKPT checkpoint written from the mesh; that
    checkpoint restored onto TRAIN_MESH_RESTORE (``elastic_restore``) and
    one more step; then DeepSeek-V2-Lite's train state sharded on
    TRAIN_MESH_MOE and one step through ``make_train_step``, each MoE
    layer's kept choices recorded."""
    rt = load_runtime()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    M, PT, S, _build = rt["mesh"], rt["partition"], rt["steps"], rt["_build"]
    ops, heads = rt["ops"], []
    flash = ops.flash_attention

    def seen(q, *a, **kw):       # the q heads each K2 call of a step sees
        heads.append(int(q.shape[1]))
        return flash(q, *a, **kw)

    ops.flash_attention = seen
    p = payload["llama"]
    device = p["params"]["embed"].device
    cfg, tcfg, data = p["cfg"], p["tcfg"], p["data"]
    out = {}
    mesh = M.make_mesh(TRAIN_MESH, ("data", "model"))
    state = S.init_train_state(p["params"], tcfg)
    specs = PT.make_train_state_specs(state, mesh)
    shards = PT.shard_tree(state, specs, mesh)
    like = rt["tree"].map_leaves(lambda x: torch.empty(
        x.shape, dtype=x.dtype, device="meta"), state)
    del state
    step = S.make_train_step(cfg, tcfg, mesh=mesh, specs=specs)
    _build.LAUNCH_COUNTS.clear()
    _build.KERNEL_COUNTS.clear()
    torch.cuda.reset_peak_memory_stats()
    steps, save_s = [], None
    for i in range(TRAIN_MESH_STEPS):
        shards, rec = _mesh_step(mesh, step, shards, data.batch_at(i))
        rec["gathered_peak_bytes"] = PT.GATHER_STATS["peak"]
        steps.append(rec)
        if i + 1 == TRAIN_MESH_CKPT:
            t0 = time.perf_counter()
            rt["checkpoint"].save(p["ckpt_dir"], i + 1, shards, specs=specs,
                                  mesh=mesh)
            save_s = time.perf_counter() - t0
    out["llama"] = {"steps": steps, "save_s": save_s,
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                    "launches": dict(_build.LAUNCH_COUNTS),
                    "kernel_launches": dict(_build.KERNEL_COUNTS),
                    "k2_heads": sorted(set(heads)),
                    "shard_bytes": sum(x.numel() * x.element_size() for x in
                                       rt["tree"].leaves(shards))}
    del shards
    torch.cuda.empty_cache()
    mesh = M.make_mesh(TRAIN_MESH_RESTORE, ("data", "model"))
    if mesh is not None:
        t0 = time.perf_counter()
        restored, at = rt["fault"].elastic_restore(
            p["ckpt_dir"], like, mesh, PT.make_train_state_specs,
            device=device)
        restore_s = time.perf_counter() - t0
        specs = PT.make_train_state_specs(like, mesh)
        _build.KERNEL_COUNTS.clear()
        heads.clear()
        torch.cuda.reset_peak_memory_stats()
        restored, rec = _mesh_step(
            mesh, S.make_train_step(cfg, tcfg, mesh=mesh, specs=specs),
            restored, data.batch_at(at))
        out["restored"] = {"at": at, "restore_s": restore_s, **rec,
                           "kernel_launches": dict(_build.KERNEL_COUNTS),
                           "k2_heads": sorted(set(heads)),
                           "gathered_peak_bytes": PT.GATHER_STATS["peak"],
                           "peak_mem_bytes":
                               torch.cuda.max_memory_allocated()}
        del restored
    torch.cuda.empty_cache()
    mesh = M.make_mesh(TRAIN_MESH_MOE, ("data", "model"))
    if mesh is not None:
        d = payload["deepseek"]
        state = S.init_train_state(d["params"], d["tcfg"])
        specs = PT.make_train_state_specs(state, mesh)
        shards = PT.shard_tree(state, specs, mesh)
        del state
        step = S.make_train_step(d["cfg"], d["tcfg"], mesh=mesh,
                                 specs=specs)
        _build.KERNEL_COUNTS.clear()
        heads.clear()
        torch.cuda.reset_peak_memory_stats()
        with rt["routes"].recording() as routes:
            shards, rec = _mesh_step(mesh, step, shards, d["batch"])
        out["deepseek"] = {
            **rec, "routes": [(ids.cpu(), keep.cpu(), float(aux))
                              for ids, keep, aux in routes],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "kernel_launches": dict(_build.KERNEL_COUNTS),
            "k2_heads": sorted(set(heads)), "coords": dict(mesh.coords),
            "shard_bytes": sum(x.numel() * x.element_size() for x in
                               rt["tree"].leaves(shards))}
        del shards
    torch.cuda.empty_cache()
    mesh = M.make_mesh(TRAIN_MESH_SSM, ("data", "model"))
    if mesh is not None:
        m = payload["mamba"]
        state = S.init_train_state(m["params"], m["tcfg"])
        specs = PT.make_train_state_specs(state, mesh)
        # the leaves the gather on use would gather whole over model: none
        # of a Mamba2 block's where its heads divide the model ranks
        whole = [PT.clean_keystr(path) for (path, _), sp in zip(
            rt["tree"].flatten(state["params"]),
            PT.flat_specs(specs["params"], state["params"]))
            if PT.model_dim(sp, mesh) is not None and not PT.tp_keeps_band(
                PT.clean_keystr(path), sp, m["cfg"], mesh)]
        shards = PT.shard_tree(state, specs, mesh)
        del state
        step = S.make_train_step(m["cfg"], m["tcfg"], mesh=mesh, specs=specs)
        _build.KERNEL_COUNTS.clear()
        torch.cuda.reset_peak_memory_stats()
        recs = []
        for batch in m["batches"]:
            shards, rec = _mesh_step(mesh, step, shards, batch)
            recs.append(rec)
        out["mamba"] = {
            **recs[0], "losses": [r["loss"] for r in recs],
            "grad_norms": [r["grad_norm"] for r in recs],
            "gathered_peak_bytes": PT.GATHER_STATS["peak"],
            "whole_over_model": whole, "coords": dict(mesh.coords),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "kernel_launches": dict(_build.KERNEL_COUNTS),
            "shard_bytes": sum(x.numel() * x.element_size() for x in
                               rt["tree"].leaves(shards))}
        del shards
    return out


def train_mesh_phase(rt, device, gen, timer, kernels, faults) -> dict:
    """Training on a device mesh, MESH_RANKS ranks sharing the card over
    gloo (``launch.mesh.spawn``):
      * Llama-3.2-1B at full width, TRAIN_MESH_LAYERS of its 16 layers,
        f32, from seed 0: its train state sharded on TRAIN_MESH
        (``make_train_state_specs``); TRAIN_MESH_STEPS steps, each loss
        within TRAIN_MESH_LOSS_RTOL of one process's step on the card;
        every rank the same losses, K2's f32 kernel (``tf32x3``) in every
        forward and recompute and no other K2 kernel; per rank ms a step,
        peak memory, the most gathered-parameter bytes alive at once, the
        bytes and the wall seconds of a step's collectives (gathers on
        use, the model ranks' sums, the gradients' reduce-scatter); the
        step-TRAIN_MESH_CKPT
        checkpoint written from the mesh, restored onto TRAIN_MESH_RESTORE
        and into one process (``elastic_restore``, each leaf's CRC32
        checked against the manifest), one more step each within the
        bound of the uninterrupted run.  K2 f32 held against its plain
        version at a data rank's shape.
      * DeepSeek-V2-Lite at full width, MESH_MOE_LAYERS layers, capacity
        factor 1.25: its train state sharded on TRAIN_MESH_MOE and one
        step through ``make_train_step`` (each model rank runs its E/model
        experts on the dispatch table every rank computes alike, its
        combine summed over model; MLA on its heads), against one
        process's ``make_train_step`` on the same batch: the kept (token,
        expert) pairs of each data rank's rows equal, in a batch that
        drops some; the loss and the aux within TRAIN_MESH_LOSS_RTOL; K2
        f32 on each rank's heads in its forward and recompute.
      * Mamba2-2.7B at full width, TRAIN_MESH_SSM_LAYERS blocks, f32: its
        train state sharded on TRAIN_MESH_SSM and TRAIN_MESH_SSM_STEPS
        steps through ``make_train_step`` (each on its batch, as the
        Llama steps), each model rank on
        its 40 SSM heads (its rows of in_proj and channels of the conv, B's
        and C's rows gathered as weights, out_proj row-parallel): no leaf of its blocks gathered whole over model; each
        step's loss and gradient norm within TRAIN_MESH_LOSS_RTOL of one
        process's steps on the card (the norm reads the backward, the
        second loss the first step's update); each rank's most
        gathered-parameter bytes alive (``GATHER_STATS["peak"]``) and the
        first step's collective bytes.
    Every rank's K2 calls see the rank's q heads (n_heads / model).
    Times are of ranks sharing one card: they prove bits and shapes, not a
    multi-card speed."""
    import tempfile
    get, replace = rt["get_config"], dataclasses.replace
    S, opt, T, LM = rt["steps"], rt["optimizer"], rt["tree"], rt["LM"]
    cfg = replace(get("llama3.2-1b").full, n_layers=TRAIN_MESH_LAYERS)
    tcfg = S.TrainConfig(optimizer=opt.AdamWConfig(
        lr=5e-3, warmup_steps=1, total_steps=TRAIN_MESH_STEPS + 1))
    data = rt["DataPipeline"](rt["DataConfig"](
        vocab_size=TRAIN_DATA_VOCAB, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    params = LM.init_lm(cfg, seed=SEED, device=device)
    # one process, on the card: the uninterrupted run
    state = S.init_train_state(params, tcfg)
    step = S.make_train_step(cfg, tcfg)
    rt["_build"].KERNEL_COUNTS.clear()
    one, one_ms = [], []
    for i in range(TRAIN_MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, data.batch_at(i))
        one.append(float(m["loss"]))
        one_ms.append((time.perf_counter() - t0) * 1e3)
    one_k2 = rt["_build"].KERNEL_COUNTS.get("flash_attention:tf32x3", 0)
    like = T.map_leaves(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"), state)
    del state
    # DeepSeek: one process's step on the batch the mesh steps on
    dcfg = replace(get("deepseek-v2-lite-16b").full,
                   n_layers=MESH_MOE_LAYERS)
    dtcfg = S.TrainConfig(optimizer=opt.AdamWConfig(
        lr=5e-3, warmup_steps=1, total_steps=2))
    dparams = LM.init_lm(dcfg, seed=SEED, device=device)
    dbatch = data.batch_at(0)
    dstate = S.init_train_state(dparams, dtcfg)
    rt["_build"].KERNEL_COUNTS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with rt["routes"].recording() as one_routes:
        dstate, dm = S.make_train_step(dcfg, dtcfg)(dstate, dbatch)
    one_moe = {"loss": float(dm["loss"]),
               "ms": (time.perf_counter() - t0) * 1e3,
               "k2": rt["_build"].KERNEL_COUNTS.get(
                   "flash_attention:tf32x3", 0)}
    del dstate, dm
    torch.cuda.empty_cache()
    # Mamba2: one process's steps on the batches the mesh steps on
    scfg = replace(get("mamba2-2.7b").full, n_layers=TRAIN_MESH_SSM_LAYERS)
    sparams = LM.init_lm(scfg, seed=SEED, device=device)
    sstate = S.init_train_state(sparams, dtcfg)
    sstep = S.make_train_step(scfg, dtcfg)
    sbatches = [data.batch_at(i) for i in range(TRAIN_MESH_SSM_STEPS)]
    one_ssm = {"losses": [], "grad_norms": [], "ms": []}
    for batch in sbatches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sstate, sm = sstep(sstate, batch)
        one_ssm["losses"].append(float(sm["loss"]))
        one_ssm["grad_norms"].append(float(sm["grad_norm"]))
        one_ssm["ms"].append((time.perf_counter() - t0) * 1e3)
    del sstate, sm
    torch.cuda.empty_cache()
    res = {"model": f"{cfg.name} at {TRAIN_MESH_LAYERS} of 16 layers "
                    "(full width, f32)",
           "moe_model": f"{dcfg.name} at {MESH_MOE_LAYERS} of 27 layers "
                        f"(full width, f32), capacity factor "
                        f"{dcfg.capacity_factor}",
           "mesh": TRAIN_MESH, "restore_mesh": TRAIN_MESH_RESTORE,
           "moe_mesh": TRAIN_MESH_MOE, "per_rank": {},
           "note": "ranks share one card over gloo: per-rank ms are not a "
                   "multi-card speed; comm_s: wall seconds in each "
                   "collective, its peers' wait included",
           "one_process": {"losses": one, "step_ms": one_ms}}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        payload = {"llama": {"cfg": cfg, "tcfg": tcfg, "data": data,
                             "params": params, "ckpt_dir": ckpt_dir},
                   "deepseek": {"cfg": dcfg, "tcfg": dtcfg,
                                "params": dparams, "batch": dbatch},
                   "mamba": {"cfg": scfg, "tcfg": dtcfg, "params": sparams,
                             "batches": sbatches}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = rt["mesh"].spawn(train_mesh_rank, MESH_RANKS, payload,
                                device="cuda")
        res["spawn_s"] = time.perf_counter() - t0
        del payload, dparams, sparams
        t0 = time.perf_counter()
        restored, at = rt["fault"].elastic_restore(ckpt_dir, like,
                                                   device=device)
        res["one_process"]["restore_s"] = time.perf_counter() - t0
    rt["_build"].KERNEL_COUNTS.clear()
    restored, m = step(restored, data.batch_at(at))
    res["one_process"]["restored"] = {"at": at, "loss": float(m["loss"])}
    del restored
    torch.cuda.empty_cache()

    def close(a, b):
        return abs(a - b) <= TRAIN_MESH_LOSS_RTOL * abs(b)

    per = k2_per_step(rt, cfg)
    want_k2 = per * TRAIN_MESH_STEPS
    if one_k2 != want_k2:
        faults.append(f"train_mesh one process: K2 tf32x3 {one_k2}")
    if not (at == TRAIN_MESH_CKPT and close(float(m["loss"]), one[at])):
        faults.append(f"train_mesh: one process restored at {at}, loss "
                      f"{float(m['loss'])} vs {one[at]}")
    for r, out in enumerate(outs):
        o = out["llama"]
        losses = [s["loss"] for s in o["steps"]]
        k2 = {k: n for k, n in o["kernel_launches"].items()
              if k.startswith("flash_attention:")}
        mine = res["per_rank"][f"rank{r}"] = {
            "losses": losses, "step_ms": [s["ms"] for s in o["steps"]],
            "bytes_a_step": [s["bytes"] for s in o["steps"]],
            "comm_s_a_step": [s["comm_s"] for s in o["steps"]],
            "gathered_peak_bytes": [s["gathered_peak_bytes"]
                                    for s in o["steps"]],
            "peak_mem_bytes": o["peak_mem_bytes"],
            "shard_bytes": o["shard_bytes"], "save_s": o["save_s"],
            "kernel_launches": o["kernel_launches"],
            "k2_heads": o["k2_heads"], "launches": o["launches"]}
        if o["k2_heads"] != [cfg.n_heads // TRAIN_MESH[1]]:
            faults.append(f"train_mesh rank {r}: K2 saw q heads "
                          f"{o['k2_heads']}, want the rank's "
                          f"{cfg.n_heads // TRAIN_MESH[1]}")
        if losses != [s["loss"] for s in outs[0]["llama"]["steps"]]:
            faults.append(f"train_mesh rank {r}: losses {losses} differ "
                          "from rank 0's")
        if not all(close(a, b) for a, b in zip(losses, one)):
            faults.append(f"train_mesh rank {r}: losses {losses} vs one "
                          f"process {one}")
        if k2 != {"flash_attention:tf32x3": want_k2}:
            faults.append(f"train_mesh rank {r}: K2 launches {k2}, want "
                          f"{want_k2} tf32x3")
        if "restored" in out:
            rr = out["restored"]
            mine["restored"] = rr
            if not (rr["at"] == TRAIN_MESH_CKPT
                    and close(rr["loss"], one[TRAIN_MESH_CKPT])
                    and rr["kernel_launches"].get(
                        "flash_attention:tf32x3") == per
                    and rr["k2_heads"] == [
                        cfg.n_heads // TRAIN_MESH_RESTORE[1]]):
                faults.append(f"train_mesh rank {r} restored on "
                              f"{TRAIN_MESH_RESTORE}: {rr} vs one process "
                              f"{one[TRAIN_MESH_CKPT]}")
    # DeepSeek's step: the data ranks' kept choices side by side
    got = {r: o["deepseek"] for r, o in enumerate(outs) if "deepseek" in o}
    moe = {"layers": len(one_routes), "dropped": [
        int((~keep).sum()) for _, keep, _ in one_routes],
        "choices": int(one_routes[0][1].numel()) if one_routes else 0,
        "ranks": len(got), "one_process": one_moe,
        "per_rank": {f"rank{r}": {k: g[k] for k in (
            "loss", "grad_norm", "ms", "bytes", "comm_s", "peak_mem_bytes",
            "kernel_launches", "k2_heads")} for r, g in got.items()}}
    moe["ids_equal"] = moe["kept_equal"] = len(got) == math.prod(
        TRAIN_MESH_MOE)
    moe["aux_rel_err"] = moe["loss_rel_err"] = 0.0
    # one rank of each data index: its rows' routes (the model ranks of a
    # data rank route the same rows alike)
    by_data = {}
    for g in got.values():
        by_data.setdefault(g["coords"]["data"], g)
    for g in got.values():
        d = by_data[g["coords"]["data"]]
        moe["ids_equal"] &= all(torch.equal(a[0], b[0]) and torch.equal(
            a[1], b[1]) for a, b in zip(g["routes"], d["routes"]))
    for li, (ids, keep, aux) in enumerate(one_routes):
        mids = torch.cat([by_data[i]["routes"][li][0]
                          for i in sorted(by_data)])
        mkeep = torch.cat([by_data[i]["routes"][li][1]
                           for i in sorted(by_data)])
        moe["ids_equal"] &= bool(torch.equal(mids, ids.cpu()))
        moe["kept_equal"] &= bool(torch.equal(mkeep, keep.cpu()))
        moe["aux_rel_err"] = max(moe["aux_rel_err"], max(
            abs(g["routes"][li][2] - float(aux)) / abs(float(aux))
            for g in got.values()))
    for g in got.values():
        moe["loss_rel_err"] = max(moe["loss_rel_err"], abs(
            g["loss"] - one_moe["loss"]) / abs(one_moe["loss"]))
    res["deepseek"] = moe
    ds_k2 = {g["kernel_launches"].get("flash_attention:tf32x3", 0)
             for g in got.values()} | {one_moe["k2"]}
    if not (moe["layers"] == MESH_MOE_LAYERS - dcfg.first_dense_layers
            and all(moe["dropped"]) and moe["ids_equal"]
            and moe["kept_equal"]
            and len({g["loss"] for g in got.values()}) == 1
            and moe["aux_rel_err"] <= TRAIN_MESH_LOSS_RTOL
            and moe["loss_rel_err"] <= TRAIN_MESH_LOSS_RTOL
            and ds_k2 == {k2_per_step(rt, dcfg)}
            and all(g["k2_heads"] == [dcfg.n_heads // TRAIN_MESH_MOE[1]]
                    for g in got.values())):
        faults.append(f"train_mesh deepseek: {moe}")
    # Mamba2's steps on its SSM heads
    sgot = {r: o["mamba"] for r, o in enumerate(outs) if "mamba" in o}
    ssm = {"model": f"{scfg.name} at {TRAIN_MESH_SSM_LAYERS} of 64 blocks "
                    "(full width, f32)", "mesh": TRAIN_MESH_SSM,
           "device": nvidia_smi_line(), "one_process": one_ssm,
           "per_rank": {f"rank{r}": {k: g[k] for k in (
               "losses", "grad_norms", "ms", "bytes", "comm_s",
               "gathered_peak_bytes", "peak_mem_bytes", "shard_bytes",
               "whole_over_model")} for r, g in sgot.items()}}

    def rel_err(key):
        """The largest relative distance of a rank's step values under
        ``key`` from one process's."""
        return max((abs(a - b) / abs(b) for g in sgot.values()
                    for a, b in zip(g[key], one_ssm[key])), default=None)

    # the first step's gradient norm reads the backward; the second
    # step's loss reads the first step's update
    ssm["loss_rel_err"] = rel_err("losses")
    ssm["grad_norm_rel_err"] = rel_err("grad_norms")
    res["mamba"] = ssm
    log("train_mesh_ssm " + json.dumps(ssm, default=str))
    if not (len(sgot) == math.prod(TRAIN_MESH_SSM)
            and all(len(g["losses"]) == TRAIN_MESH_SSM_STEPS
                    for g in sgot.values())
            and len({tuple(g["losses"]) for g in sgot.values()}) == 1
            and ssm["loss_rel_err"] <= TRAIN_MESH_LOSS_RTOL
            and ssm["grad_norm_rel_err"] <= TRAIN_MESH_LOSS_RTOL
            and not any(g["whole_over_model"] for g in sgot.values())):
        faults.append(f"train_mesh mamba: {ssm}")
    # K2 f32 at each mesh's rank's shape: its heads, its data rank's rows
    for mshape, run, of in (
            (TRAIN_MESH, outs[0]["llama"]["kernel_launches"],
             f"{TRAIN_MESH_STEPS} train steps"),
            (TRAIN_MESH_RESTORE, outs[0].get("restored", {}).get(
                "kernel_launches", {}), "the step after the restore")):
        row = check_flash_train(
            rt, device, gen, timer, cfg.n_heads // mshape[1],
            cfg.n_kv_heads // mshape[1], cfg.resolved_head_dim,
            cfg.resolved_head_dim, "Llama-3.2-1B training, a rank's heads "
            f"and rows on mesh {mshape}", batch=TRAIN_BATCH // mshape[0])
        kernels.append(dict(
            row, path=f"{cfg.name} train mesh {mshape}",
            launches=run.get("flash_attention:tf32x3", 0),
            launches_of=f"{of} at {TRAIN_MESH_LAYERS} layers on mesh "
                        f"{mshape}, rank 0 (remat: the recompute's too)"))
    log("train_mesh_detail " + json.dumps(res, default=str))
    ranks = res["per_rank"]
    # what the dry run's phase holds its plan of this cell against
    rt["train_mesh"] = {"cfg": cfg, "tcfg": tcfg, "batch": data.batch_at(1),
                        "per_rank": ranks, "moe": {
                            "cfg": dcfg, "tcfg": dtcfg, "batch": dbatch,
                            "per_rank": {f"rank{r}": {
                                "bytes_a_step": [g["bytes"]],
                                "kernel_launches": g["kernel_launches"],
                                "shard_bytes": g["shard_bytes"],
                                "peak_mem_bytes": g["peak_mem_bytes"]}
                                for r, g in got.items()}}}
    return {"note": res["note"], "model": res["model"], "one_process": one,
            "summary": {r: {f: d[f] for f in ("losses", "step_ms",
                                              "comm_s_a_step",
                                              "gathered_peak_bytes",
                                              "peak_mem_bytes", "save_s")}
                        for r, d in ranks.items()},
            "bytes_a_step_rank0": ranks["rank0"]["bytes_a_step"],
            "restored": {r: d["restored"] for r, d in ranks.items()
                         if "restored" in d},
            "one_process_restored": res["one_process"]["restored"],
            "deepseek": moe, "mamba": {
                "loss_rel_err": ssm["loss_rel_err"],
                "gathered_peak_bytes": {r: d["gathered_peak_bytes"]
                                        for r, d in ssm["per_rank"].items()},
                "bytes_a_step": {r: d["bytes"]
                                 for r, d in ssm["per_rank"].items()}},
            "spawn_s": res["spawn_s"]}


# The dry run (``dryrun_phase``, last): plans on fake tensors held against
# the runs above and one production cell.
#  * The planned peak (arguments + the step's peak of temporaries) against
#    a rank's measured ``max_memory_allocated`` over the train_mesh
#    phase's steps and checkpoint: the plan counts storages, not the
#    caching allocator's blocks, and the measured peak spans two steps and
#    a checkpoint's gather, so only their ratio is gated.
DRYRUN_PEAK_RATIO = (0.5, 2.0)
#  * PERF.md §6's K1 decode bound of one Llama-3.2-1B layer's 7
#    projections at M = 4 (ms at HBM_BYTES_PER_S): the plan's K1 bytes a
#    layer must come within DRYRUN_K1_RTOL of the bytes behind it.
DRYRUN_K1_BOUND_MS, DRYRUN_K1_RTOL = 0.0279, 0.01
DRYRUN_CELL = ("internlm2-1.8b", "decode_32k")   # on the 16×16 mesh


def dryrun_train_mesh(rt, faults) -> dict:
    """The train_mesh phase's cells planned on each rank of a
    ``PlannedMesh``: Llama on TRAIN_MESH and DeepSeek (its experts on
    model) on TRAIN_MESH_MOE, one ``make_train_step`` on the rank's
    ZeRO-3 shards (``launch.specs.train_state_specs``, f32) against what
    that rank measured in its last step: bytes by collective and K2's
    f32 launches equal, the state's bytes equal its shards', the planned
    peak against the measured peak within DRYRUN_PEAK_RATIO."""
    tm = rt.get("train_mesh")
    if tm is None:
        faults.append("dryrun: the train_mesh phase left no measurements")
        return {}
    out = dryrun_train_cell(rt, faults, tm, TRAIN_MESH)
    out.update({f"moe {r}": row for r, row in dryrun_train_cell(
        rt, faults, tm["moe"], TRAIN_MESH_MOE).items()})
    return out


def dryrun_train_cell(rt, faults, tm, shape) -> dict:
    """One train_mesh cell (``tm``: its cfg, tcfg, batch and each rank's
    measurements) planned on every rank of a ``PlannedMesh`` of
    ``shape`` (``dryrun_train_mesh``)."""
    D, PT, S = rt["dryrun"], rt["partition"], rt["steps"]
    cfg, tcfg, batch = tm["cfg"], tm["tcfg"], tm["batch"]
    dev = D.planned_device("cuda")
    out = {}
    for r in range(math.prod(shape)):
        got = tm["per_rank"][f"rank{r}"]
        mesh = rt["mesh"].PlannedMesh(shape, ("data", "model"), r)
        with D.fake_tensors(dev):
            state = rt["specs"].train_state_specs(cfg, tcfg.optimizer,
                                                  torch.float32, dev)
            specs = PT.make_train_state_specs(state, mesh)
            shards = PT.shard_tree(state, specs, mesh)
            del state
            fb = D.fake_like(batch, dev)
            plan = D.plan_step(S.make_train_step(cfg, tcfg, mesh=mesh,
                                                 specs=specs),
                               shards, fb, mesh=mesh, grad=True)
        mem = plan["memory"]
        k2 = plan["kernels"].get("flash_attention:tf32x3", {})
        row = {"received_planned": plan["collectives"][
                   "received_bytes_by_kind"],
               "received_measured": got["bytes_a_step"][-1],
               "k2_planned": k2.get("launches", 0),
               "k2_measured": got["kernel_launches"].get(
                   "flash_attention:tf32x3", 0) / len(got["bytes_a_step"]),
               "state_bytes_planned": mem["argument_size_in_bytes"]
               - rt["op_stats"].tree_bytes(fb),
               "state_bytes_measured": got["shard_bytes"],
               "peak_planned": mem["total_hbm_bytes"],
               "peak_measured": got["peak_mem_bytes"],
               "memory": mem, "collectives": plan["collectives"]}
        row["peak_ratio"] = row["peak_planned"] / row["peak_measured"]
        out[f"rank{r}"] = row
        lo, hi = DRYRUN_PEAK_RATIO
        if not (row["received_planned"] == row["received_measured"]
                and row["k2_planned"] == row["k2_measured"]
                == k2_per_step(rt, cfg)
                and row["state_bytes_planned"] == row["state_bytes_measured"]
                and lo <= row["peak_ratio"] <= hi):
            faults.append(f"dryrun train_mesh {cfg.name} rank {r}: {row}")
    return out


def dryrun_llama(rt, device, faults) -> dict:
    """Llama-3.2-1B at full width, compressed, on the fixed batch: a
    prefill and one decode step, planned on fake tensors of the packed
    state's own shapes, against ``KERNEL_COUNTS`` of the same eager calls
    on the card (the decode step: 112 K1 decode, 1 K5 decode, no K2, as
    PERF.md §6 counts them); the argument bytes and the state's bytes
    equal; the plan's K1 bytes a layer at decode within DRYRUN_K1_RTOL of
    the bytes behind §6's K1 bound."""
    D, ops, _build = rt["dryrun"], rt["op_stats"], rt["_build"]
    cfg = rt["get_config"]("llama3.2-1b").full
    batch, _ = make_prompts(cfg.vocab_size)
    state, packing = pack(rt, cfg, device, SEED)
    ids = torch.as_tensor(batch, device=device)
    t0 = batch.shape[1]
    caches = rt["LM"].init_caches(cfg, BATCH, t0 + MAX_NEW, device=device)
    prefill, decode = rt["make_serve_fns"](cfg, device=device)
    real = {}
    with torch.no_grad():
        _build.KERNEL_COUNTS.clear()
        logits, caches = prefill(state.params, state.lut, {"tokens": ids},
                                 caches)
        torch.cuda.synchronize()
        real["prefill"] = dict(_build.KERNEL_COUNTS)
        tok = logits.argmax(-1)[:, None]
        holds = ops.tree_bytes(state.params, state.lut, tok, caches)
        _build.KERNEL_COUNTS.clear()
        decode(state.params, state.lut, tok, caches, t0)
        torch.cuda.synchronize()
        real["decode"] = dict(_build.KERNEL_COUNTS)
    real_state = ops.tree_bytes(state.params, state.lut)
    dev = D.planned_device("cuda")
    plans = {}
    with D.fake_tensors(dev):
        params, lut = D.fake_like(state.params, dev), D.fake_like(state.lut,
                                                                 dev)
        fcaches = D.fake_like(caches, dev)
        plans["prefill"] = D.plan_step(
            D.serve_step(cfg, "prefill", None, dev), params, lut,
            {"tokens": D.fake_like(ids, dev)}, fcaches, mesh=None)
        plans["decode"] = D.plan_step(
            D.serve_step(cfg, "decode", None, dev), params, lut,
            D.fake_like(tok, dev), fcaches, t0, mesh=None)
        plan_state = ops.tree_bytes(params, lut)
    del state, caches, logits
    torch.cuda.empty_cache()
    out = {"packing": packing, "state_bytes_measured": real_state,
           "state_bytes_planned": plan_state,
           "decode_argument_bytes_measured": holds}
    for step in ("prefill", "decode"):
        launches = {k: v["launches"]
                    for k, v in plans[step]["kernels"].items()}
        out[step] = {"launches_planned": launches,
                     "launches_measured": real[step],
                     "memory": plans[step]["memory"],
                     "cost": plans[step]["cost"]}
        if launches != real[step]:
            faults.append(f"dryrun llama {step}: planned {launches}, "
                          f"measured {real[step]}")
    want = {"fused_decode_matmul:decode": 7 * cfg.n_layers,
            "dequant_matmul:decode": 1}
    k1 = plans["decode"]["kernels"].get("fused_decode_matmul:decode", {})
    out["k1_bytes_a_layer_planned"] = k1.get("bytes", 0) / cfg.n_layers
    out["k1_bytes_behind_bound"] = DRYRUN_K1_BOUND_MS * 1e-3 \
        * HBM_BYTES_PER_S
    out["k1_rel_diff"] = (out["k1_bytes_a_layer_planned"]
                          / out["k1_bytes_behind_bound"] - 1)
    arg = plans["decode"]["memory"]["argument_size_in_bytes"]
    if not (out["decode"]["launches_planned"] == want
            and arg == holds and plan_state == real_state
            and abs(out["k1_rel_diff"]) <= DRYRUN_K1_RTOL):
        faults.append(f"dryrun llama: decode launches "
                      f"{out['decode']['launches_planned']} (want {want}), "
                      f"argument bytes {arg} vs {holds}, state "
                      f"{plan_state} vs {real_state}, K1 bytes a layer "
                      f"{out['k1_rel_diff']:+.4f} off the bound's")
    return out


def dryrun_cell(rt, faults) -> dict:
    """One production cell (DRYRUN_CELL, rank 0 of the 16×16 mesh) through
    ``launch.dryrun.run_cell``: it must plan; its per-rank bytes are
    printed beside the card's memory, with no gate on the fit."""
    rec = rt["dryrun"].run_cell(*DRYRUN_CELL, multi_pod=False)
    if not rec["ok"]:
        faults.append(f"dryrun cell {DRYRUN_CELL}: {rec.get('error')}")
        return rec
    mem, gb = rec["memory"], 1e9
    return {"cell": f"{DRYRUN_CELL[0]} {DRYRUN_CELL[1]} single (16x16)",
            "planned": rec["planned"],
            "per_rank_gb": {k: mem[f"{k}_size_in_bytes"] / gb
                            for k in ("argument", "temp")}
            | {"total": mem["total_hbm_bytes"] / gb},
            "cache_gb": rec["cache_bytes"] / gb,
            "reference_cache_gb": rec["reference_cache_bytes"] / gb,
            "batch_rows": rec["batch_rows"],
            "card_gb": torch.cuda.get_device_properties(0).total_memory / gb,
            "collective_gb_by_kind": {
                k: v / gb for k, v in rec["collectives"][
                    "bytes_by_kind"].items()},
            "launches_by_kernel": {k: v["launches"]
                                   for k, v in rec["kernels"].items()},
            "host_wall_s": rec["wall_s"]}


def dryrun_phase(rt, device, gen, timer, kernels, faults) -> dict:
    """The dry run (``launch/dryrun.py``), planned on fake tensors for an
    H100 SXM of 132 SMs (the card's own count must be that): the
    train_mesh cell against each rank's measurements
    (``dryrun_train_mesh``), Llama-3.2-1B's prefill and decode step
    against the card's launches (``dryrun_llama``), and internlm2-1.8b's
    decode_32k cell on the 16×16 mesh (``dryrun_cell``).  Planned bytes
    and FLOPs are the plan's, for that card; measured numbers are this
    run's, beside nvidia-smi's name and power limit."""
    _build = rt["_build"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"planned_sms": _build.PLAN_SMS, "device_sms": sms,
           "nvidia_smi": nvidia_smi_line()}
    if sms != _build.PLAN_SMS:
        faults.append(f"dryrun: the card has {sms} SMs, the plans "
                      f"{_build.PLAN_SMS}")
    for name, fn in (("train_mesh", lambda: dryrun_train_mesh(rt, faults)),
                     ("llama", lambda: dryrun_llama(rt, device, faults)),
                     ("cell", lambda: dryrun_cell(rt, faults))):
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        except Exception:
            traceback.print_exc()
            faults.append(f"dryrun {name} raised")
        out[f"{name}_s"] = time.perf_counter() - t0
    log("dryrun_detail " + json.dumps(out, default=str))
    tm = out.get("train_mesh", {})
    return {"sms": [sms, _build.PLAN_SMS],
            "train_mesh": {r: {k: v[k] for k in (
                "received_planned", "received_measured", "k2_planned",
                "k2_measured", "state_bytes_planned", "state_bytes_measured",
                "peak_planned", "peak_measured", "peak_ratio")}
                for r, v in tm.items()},
            "llama": {k: out.get("llama", {}).get(k) for k in (
                "state_bytes_planned", "state_bytes_measured",
                "k1_bytes_a_layer_planned", "k1_bytes_behind_bound",
                "k1_rel_diff")},
            "cell": out.get("cell"),
            "seconds": {k: out[k] for k in out if k.endswith("_s")}}


def phase(rt, name: str):
    """Name the phase that the launches from here on belong to (for
    ``SimtWatch``)."""
    rt["watch"].phase = name


def run_checks(cfg, checks, kernels, failed):
    """Run each ``(name, check)``; a check returns (row, detail).  Rows go
    to ``kernels`` with the path's name; a check that raises is a failed
    phase.  → the rows."""
    rows, detail = [], {}
    for name, fn in checks:
        try:
            row, detail[name] = fn()
            rows.append(dict(row, path=cfg.name))
        except Exception:
            traceback.print_exc()
            failed.append(f"{cfg.name} kernel {name}")
    log(f"kernel_detail {cfg.name} " + json.dumps(detail))
    kernels.extend(rows)
    return rows


def llama_path(rt, device, gen, timer, kernels, failed):
    """Llama-3.2-1B: pack, K1/K5/K2 at its shapes, serve, card vs CPU."""
    cfg = rt["get_config"]("llama3.2-1b").full
    batch, lens = make_prompts(cfg.vocab_size)
    t_prefill = batch.shape[1]
    state, packing = pack(rt, cfg, device, SEED)
    blocks = state.params["blocks"]
    projections = [(name, [b[grp][name] for b in blocks], True)
                   for grp, name in (("attn", "wq"), ("attn", "wk"),
                                     ("attn", "wv"), ("attn", "wo"),
                                     ("mlp", "w_gate"), ("mlp", "w_up"),
                                     ("mlp", "w_down"))]

    def check_k1():
        row, detail = check_fused(rt, state.lut, projections, device,
                                  BATCH * t_prefill, gen, timer,
                                  "one layer's 7 projections, decode M=4")
        return row, {"rows": detail,
                     "small_tiles": check_small_tiles(rt, device, gen)}

    phase(rt, f"{cfg.name} kernels")
    rows = run_checks(cfg, (
        ("fused_decode_matmul", check_k1),
        ("dequant_matmul",
         lambda: (check_dequant(rt, state.params["embed"], gen,
                                timer), None)),
        ("flash_attention",
         lambda: check_flash(rt, device, t_prefill, gen, timer, cfg.n_heads,
                             cfg.n_kv_heads, cfg.resolved_head_dim,
                             cfg.resolved_head_dim, "prefill"))),
        kernels, failed)
    phase(rt, f"{cfg.name} e2e")
    e2e = {}
    try:
        e2e = serve(rt, cfg, state, device, batch, lens, want={
            "fused_decode_matmul": 7 * cfg.n_layers * MAX_NEW,
            "dequant_matmul": MAX_NEW, "flash_attention": cfg.n_layers},
            packed_want={"packed": 0})
        e2e.update(packing)
    except Exception:
        traceback.print_exc()
        failed.append(f"{cfg.name} e2e")
    for row in rows:
        row["launches"] = e2e.get("launches", {}).get(row["name"], 0)
        row["launches_by_kernel"] = by_kernel(
            e2e.get("kernel_launches", {}), row["name"])
    log(f"e2e {cfg.name} " + json.dumps(e2e))
    engine, refs = {}, {}
    phase(rt, f"{cfg.name} engine")
    try:
        engine = engine_phase(rt, cfg, state, device, refs=refs)
    except Exception:
        traceback.print_exc()
        failed.append(f"{cfg.name} engine")
    for row in rows:
        row["engine_launches"] = engine.get("launches", {}).get(row["name"],
                                                                0)
    unlevered(rt, f"{cfg.name} e2e and engine", failed)
    phase(rt, f"{cfg.name} rows")
    t0, info, faults = time.perf_counter(), {}, []
    try:
        info = rows_phase(rt, cfg, state, device, refs, gen, timer, kernels,
                          faults)
    except Exception:
        traceback.print_exc()
        faults.append("raised")
    info["s"] = time.perf_counter() - t0
    log(f"rows {cfg.name} " + json.dumps(info))
    if faults:
        failed.append(f"{cfg.name} rows")
    unlevered(rt, f"{cfg.name} rows", failed)
    phase(rt, f"{cfg.name} resilience")
    res, faults = {}, []
    try:
        res = resilience_phase(rt, cfg, state, device, batch, gen, timer,
                               faults)
        kernels.extend(dict(row, path=cfg.name) for row in
                       check_unfused_kernels(
                           rt, state.params["blocks"][0]["mlp"]["w_gate"],
                           state.lut, device, gen, timer, BATCH * t_prefill,
                           res["runs"]["unfused"]))
    except Exception:
        traceback.print_exc()
        faults.append("raised")
    log(f"resilience {cfg.name} " + json.dumps(res))
    if faults:
        log(f"resilience faults: {faults}")
        failed.append(f"{cfg.name} resilience")
    rt["resilience"].FALLBACK_COUNTS.clear()
    phase(rt, f"{cfg.name} governor")
    gov, faults = {}, []
    try:
        gov = governor_phase(rt, cfg, state, device, faults)
    except Exception:
        traceback.print_exc()
        faults.append("raised")
    log(f"governor {cfg.name} " + json.dumps(gov))
    if faults:
        log(f"governor faults: {faults}")
        failed.append(f"{cfg.name} governor")
    for row in rows:
        row["governor_launches"] = {
            kind: run["launches"].get(row["name"], 0)
            for kind, run in gov.get("traces", {}).items()}
    rt["resilience"].FALLBACK_COUNTS.clear()
    rt["engine"].drop_graphs(cfg)
    phase(rt, f"{cfg.name} tiled")
    tiled_phase(rt, cfg, state, device, batch, lens, gen, timer, kernels,
                failed)
    unlevered(rt, f"{cfg.name} tiled", failed)
    phase(rt, f"{cfg.name} quant")
    t0 = time.perf_counter()
    quant_phase(rt, cfg, state, device, batch, lens, e2e.get("tokens", []),
                gen, timer, kernels, failed)
    unlevered(rt, f"{cfg.name} quant", failed)
    log(f"quant_phase: {time.perf_counter() - t0:.1f} s")
    del state
    torch.cuda.empty_cache()
    phase(rt, f"{cfg.name} card_vs_cpu")
    try:
        card_vs_cpu(rt, dataclasses.replace(cfg, n_layers=2), device, batch,
                    steps=8)
    except Exception:
        traceback.print_exc()
        failed.append(f"{cfg.name} card_vs_cpu")
    unlevered(rt, f"{cfg.name} card_vs_cpu", failed)


def deepseek_path(rt, device, gen, timer, kernels, failed):
    """DeepSeek-V2-Lite at full width, depth 8: pack, K3/K4/K2 (192/128)
    and K1/K5 at its shapes, serve, card vs CPU at depth 2."""
    full = rt["get_config"]("deepseek-v2-lite-16b").full
    cfg = dataclasses.replace(full, n_layers=DS_LAYERS)
    batch, lens = make_prompts(cfg.vocab_size)
    t_prefill = batch.shape[1]
    state, packing = pack(rt, cfg, device, SEED)
    first, moe = state.params["first_blocks"], state.params["blocks"]
    attn = [b["attn"] for b in first + moe]
    # MLA's wq, wkv_a and wo in all 8 layers and the shared experts' MLP
    # in the 7 MoE layers make one MoE layer's K1 work; the dense first
    # layer's 10944-wide MLP runs once per forward
    projections = (
        [(name, [a[name] for a in attn], True)
         for name in ("wq", "wkv_a", "wo")]
        + [(f"shared.{name}", [b["moe"]["shared"][name] for b in moe], True)
           for name in ("w_gate", "w_up", "w_down")]
        + [(f"first.{name}", [b["mlp"][name] for b in first], False)
           for name in ("w_gate", "w_up", "w_down")])
    phase(rt, f"{cfg.name} kernels")
    rows = run_checks(cfg, (
        ("grouped_fused_decode_matmul",
         lambda: check_grouped(rt, cfg, state, device, BATCH * t_prefill,
                               gen, timer)),
        ("dict_decode",
         lambda: check_dict_decode(rt, moe[0]["attn"]["wkv_b"], state.lut,
                                   timer)),
        ("flash_attention",
         lambda: check_flash(rt, device, t_prefill, gen, timer, cfg.n_heads,
                             cfg.n_heads,
                             cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                             cfg.v_head_dim, "MLA prefill")),
        ("fused_decode_matmul",
         lambda: check_fused(rt, state.lut, projections, device,
                             BATCH * t_prefill, gen, timer,
                             "one MoE layer's 6 projections (MLA wq, wkv_a, "
                             "wo; shared experts), decode M=4", cold=True)),
        ("dequant_matmul",
         lambda: (check_dequant(rt, state.params["lm_head"], gen,
                                timer), None)),
        ("grouped_fused_decode_matmul (C-slot cache stack)",
         lambda: check_grouped_cache(rt, cfg, state, device, gen, timer)),
        *[(f"grouped_fused_decode_matmul cap {m}",
           lambda m=m: check_grouped_rows(rt, state, device, gen, timer, m))
          for m in ROWS_M]),
        kernels, failed)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    phase(rt, f"{cfg.name} e2e")
    e2e = {}
    try:
        # per forward: 3 grouped launches per MoE layer; K1 for MLA's wq,
        # wkv_a, wo and the 3 projections of the dense or shared-expert
        # MLP in every layer; K4 for MLA's absorbed wkv_b in every layer;
        # K5 for the int8 LM head; K2 once per layer, at the prefill only
        e2e = serve(rt, cfg, state, device, batch, lens, want={
            "grouped_fused_decode_matmul": 3 * n_moe * MAX_NEW,
            "fused_decode_matmul": 6 * cfg.n_layers * MAX_NEW,
            "dict_decode": cfg.n_layers * MAX_NEW,
            "dequant_matmul": MAX_NEW, "flash_attention": cfg.n_layers},
            packed_want={"packed_stacked": 0,
                         "packed": cfg.n_layers * MAX_NEW})
        e2e.update(packing, full_layers=full.n_layers)
    except Exception:
        traceback.print_exc()
        failed.append(f"{cfg.name} e2e")
    for row in rows:
        row["launches"] = e2e.get("launches", {}).get(row["name"], 0)
        row["launches_by_kernel"] = by_kernel(
            e2e.get("kernel_launches", {}), row["name"])
    log(f"e2e {cfg.name} " + json.dumps(e2e))
    unlevered(rt, f"{cfg.name} e2e", failed)
    try:
        log(f"dense_rows {cfg.name} " + json.dumps(dense_rows(
            rt, moe[0]["moe"]["router"], "layer 1 router", device, gen)))
    except Exception:
        traceback.print_exc()
        failed.append(f"{cfg.name} dense rows")
    phase(rt, f"{cfg.name} residency")
    res, faults, k3 = {}, [], 0
    try:
        res, k3 = residency_phase(rt, cfg, state, device, batch, faults)
    except Exception:
        traceback.print_exc()
        faults.append("raised")
    log(f"residency {cfg.name} " + json.dumps(res))
    if faults:
        log(f"residency faults: {faults}")
        failed.append(f"{cfg.name} residency")
    for row in rows:
        if row["name"].endswith("(C-slot cache stack)"):
            row["launches"] = k3
        else:
            row["residency_launches"] = sum(
                c["launches"].get(row["name"], 0)
                for c in res.get("capacities", []))
    unlevered(rt, f"{cfg.name} residency", failed)
    del state
    torch.cuda.empty_cache()
    phase(rt, f"{cfg.name} card_vs_cpu")
    try:
        card_vs_cpu(rt, dataclasses.replace(cfg, n_layers=2), device, batch,
                    steps=DS_CHECK_STEPS)
    except Exception:
        traceback.print_exc()
        failed.append(f"{cfg.name} card_vs_cpu")
    unlevered(rt, f"{cfg.name} card_vs_cpu", failed)
    phase(rt, f"{full.name} resilience")
    res, faults = {}, []
    try:
        res = moe_rungs(rt, device, batch, faults)
    except Exception:
        traceback.print_exc()
        faults.append("raised")
    log(f"resilience {full.name} " + json.dumps(res))
    if faults:
        log(f"resilience faults: {faults}")
        failed.append(f"{full.name} resilience")
    rt["resilience"].FALLBACK_COUNTS.clear()
    phase(rt, f"{full.name} governor")
    gov, faults = {}, []
    try:
        gov = governor_moe(rt, device, faults)
    except Exception:
        traceback.print_exc()
        faults.append("raised")
    log(f"governor {full.name} " + json.dumps(gov))
    if faults:
        log(f"governor faults: {faults}")
        failed.append(f"{full.name} governor")
    rt["resilience"].FALLBACK_COUNTS.clear()
    phase(rt, f"{full.name} tiled")
    res, faults = {}, []
    try:
        res = tiled_moe(rt, device, batch, lens, gen, timer, kernels,
                        faults)
    except Exception:
        traceback.print_exc()
        faults.append("raised")
    log(f"tiled {full.name} " + json.dumps(res))
    if faults:
        log(f"tiled faults: {faults}")
        failed.append(f"{full.name} tiled")
    unlevered(rt, f"{full.name} tiled", failed)
    phase(rt, f"{full.name} quant")
    quant_moe(rt, device, batch, lens, failed)
    unlevered(rt, f"{full.name} quant", failed)


def card_vs_cpu(rt, cfg, device, batch, steps):
    """The same seeded model at 2 layers, packed once on the card and
    copied to the CPU: prefill logits of the last position within
    E2E_LOGIT_ATOL, greedy tokens of ``steps`` steps compared.

    For an MoE model the card's prefill runs twice, with K2's tensor-core
    kernel (the main path's) and with its f32 kernel (f32 q), and each is
    held against two CPU runs.  Against the CPU's own routing: a request
    whose last token routes to, or keeps within capacity, other experts is
    left out (at most one), the others within the tolerance.  Against a
    CPU run given the card's expert ids (``forward(routing=...)``), so that
    both route and keep alike: every request within the tolerance.  Per
    request, the tokens routed and kept differently are reported."""
    LM, L = rt["LM"], rt["L"]
    t0 = time.perf_counter()
    params = LM.init_lm(cfg, seed=SEED + 1, device=device)
    st_gpu = rt["build_serve_params"](params, rt["CompressionPolicy"](),
                                      device=device)
    del params
    st_cpu = st_gpu.to("cpu")
    ids = torch.as_tensor(batch)
    t_prefill = ids.shape[1]
    moe = cfg.family == "moe"
    head_key = "lm_head" if "lm_head" in st_gpu.params else "embed"

    def prefill(st, dev, routing=None):
        caches = LM.init_caches(cfg, BATCH, t_prefill + steps, device=dev)
        out = LM.forward(st.params, cfg, ids.to(dev), caches=caches, pos=0,
                         lut=st.lut, return_hidden=True, return_routing=moe,
                         routing=routing)
        logits = L.linear(out[0][:, -1:], st.params[head_key], st.lut)[:, 0]
        return (logits.float().cpu(), out[1],
                out[3].cpu() if moe else None)

    res = {}
    for key, dev, st in (("card", device, st_gpu), ("cpu", "cpu", st_cpu)):
        _, decode_step = rt["make_serve_fns"](cfg, device=dev)
        logits, caches, route = prefill(st, dev)
        toks = []
        tok = torch.argmax(logits, dim=-1)[:, None].to(dev)
        for i in range(steps):
            toks.append(tok.cpu())
            if i < steps - 1:
                lg, caches = decode_step(st.params, st.lut, tok, caches,
                                         t_prefill + i)
                tok = torch.argmax(lg, dim=-1)[:, None]
        res[key] = (logits, torch.cat(toks, 1), route)
    diff = (res["card"][0] - res["cpu"][0]).abs().max(dim=-1).values
    info = {"model": cfg.name, "layers": 2,
            "logit_max_abs_err_per_request": diff.tolist(),
            "logit_scale": float(res["cpu"][0].abs().max()),
            "tolerance": E2E_LOGIT_ATOL,
            "token_mismatches": int((res["card"][1] != res["cpu"][1]).sum()),
            "tokens_compared": BATCH * steps}
    faults = []
    if not moe:
        worst = diff.max().item()
        if not (worst <= E2E_LOGIT_ATOL and math.isfinite(worst)):
            faults.append(f"logits differ by {diff.tolist()}")
    else:
        _build, fa, ops = rt["_build"], rt["fa"], rt["ops"]
        tensor_core = ops.flash_attention

        def f32(q, k, v, **kw):           # K2's f32 kernel takes f32 q
            return tensor_core(q.float(), k, v, **kw).to(q.dtype)

        _build.LAUNCH_COUNTS.clear()
        ops.flash_attention = f32
        try:
            res["card_f32"] = prefill(st_gpu, device)
        finally:
            ops.flash_attention = tensor_core
        k2 = {n: _build.LAUNCH_COUNTS[n] for n in (fa.NAME, fa.F32_NAME)}
        if k2 != {fa.NAME: 0, fa.F32_NAME: cfg.n_layers}:
            faults.append(f"f32 run launched K2 as {k2}")
        cap = L._capacity(BATCH * t_prefill, cfg.top_k, cfg.n_experts,
                          cfg.capacity_factor)

        def kept(r):              # the experts a token keeps; -1: dropped
            slot = L.expert_slots(r, torch.nn.functional.one_hot(
                r, cfg.n_experts)).reshape(r.shape)
            return torch.where(slot < cap, r, -1).sort(-1).values

        def per_request(a, b, f):         # (L_moe, n, k) twice → (BATCH,)
            return torch.stack([f(x) != f(y) for x, y in zip(a, b)]).any(
                -1).any(0).reshape(BATCH, t_prefill)

        cpu_logits, cpu_route = res["cpu"][0], res["cpu"][2]
        for key in ("card", "card_f32"):
            logits, _, route = res[key]
            same = prefill(st_cpu, "cpu", routing=route)[0]
            err = (logits - cpu_logits).abs().max(dim=-1).values
            err_same = (logits - same).abs().max(dim=-1).values
            routed = per_request(route, cpu_route, lambda r: r.sort(-1)
                                 .values)
            moved = per_request(route, cpu_route, kept)
            left_out = (routed | moved)[:, -1]
            info[key] = {
                "logit_max_abs_err_per_request": err.tolist(),
                "same_routing_logit_max_abs_err_per_request":
                    err_same.tolist(),
                "tokens_routed_differently_per_request":
                    routed.sum(1).tolist(),
                "tokens_kept_differently_per_request": moved.sum(1).tolist(),
                "slots_dropped": int((kept(route) < 0).sum()),
                "requests_left_out": torch.nonzero(left_out)[:, 0].tolist()}
            gated = err[~left_out].max().item() if (~left_out).any() else 0.
            worst = err_same.max().item()
            if int(left_out.sum()) > 1 or not (
                    gated <= E2E_LOGIT_ATOL and worst <= E2E_LOGIT_ATOL
                    and math.isfinite(gated) and math.isfinite(worst)):
                faults.append(f"{key}: logits differ by {err.tolist()}, "
                              f"under the card's routing by "
                              f"{err_same.tolist()}, left out "
                              f"{left_out.tolist()}")
        info["slots_dropped_cpu"] = int((kept(cpu_route) < 0).sum())
        info["slots"] = cpu_route.numel()
    info["seconds"] = time.perf_counter() - t0
    log("card_vs_cpu " + json.dumps(info))
    if faults:
        raise AssertionError(f"{cfg.name} card vs CPU: {faults}")


# ---------------------------------------------------------------------------

def load_runtime() -> dict:
    """The port's modules and entry points by name (the ``rt`` every phase
    takes), imported from this checkout's ``src``; each rank of the mesh
    phase loads them too."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.compressed import pack_expert_stack
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.kernels import dict_decode as ddc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_decode_matmul as fdm
    from repro_torch.models import layers as L
    from repro_torch.models import frontends
    from repro_torch.models import encdec as ED
    from repro_torch.models import lm as LM
    from repro_torch.serve import engine
    from repro_torch.serve.context import ServeContext
    from repro_torch.serve.engine import (build_serve_params, generate,
                                          make_serve_fns)
    from repro_torch.serve.scheduler import Engine, Request
    from repro_torch.core import integrity
    from repro_torch.serve import governor, residency, resilience
    from repro_torch.core import policy
    from repro_torch.testing import FaultInjector, pressure_trace, routes
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.train.data import DataConfig, DataPipeline
    from repro_torch.train import checkpoint, fault, optimizer, steps, tree
    from repro_torch.core import gptq, quant
    from repro_torch.launch import dryrun, mesh, op_stats, specs
    from repro_torch.sharding import partition
    return {"launch_serve": launch_serve, "DataConfig": DataConfig,
          "launch_train": launch_train, "optimizer": optimizer,
          "steps": steps, "tree": tree, "gptq": gptq, "quant": quant,
          "checkpoint": checkpoint, "fault": fault,
          "DataPipeline": DataPipeline, "integrity": integrity, "resilience": resilience,
          "residency": residency, "governor": governor, "policy": policy,
          "pressure_trace": pressure_trace,
          "FaultInjector": FaultInjector, "frontends": frontends,
          "fdm": fdm, "dqm": dqm, "fa": fa, "ddc": ddc, "L": L, "LM": LM,
          "ED": ED,
          "ops": ops, "_build": _build, "engine": engine,
          "get_config": get_config,
          "CompressionPolicy": CompressionPolicy,
          "pack_expert_stack": pack_expert_stack,
          "build_serve_params": build_serve_params, "generate": generate,
          "make_serve_fns": make_serve_fns, "Engine": Engine,
          "Request": Request, "ServeContext": ServeContext,
          "mesh": mesh, "partition": partition, "routes": routes,
          "dryrun": dryrun, "op_stats": op_stats, "specs": specs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    rt = load_runtime()
    rt["watch"] = SimtWatch.watch(rt["_build"].KERNEL_COUNTS)
    _build = rt["_build"]
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    failed, kernels = [], []
    t_start = time.perf_counter()

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

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    timer = Timer(device)
    for path in (llama_path, deepseek_path):
        t0 = time.perf_counter()
        try:
            path(rt, device, gen, timer, kernels, failed)
        except Exception:
            traceback.print_exc()
            failed.append(path.__name__)
        log(f"{path.__name__}: {time.perf_counter() - t0:.1f} s")

    for name, fn in (("families", families_phase), ("encdec", encdec_phase),
                     ("examples", examples_phase), ("mesh", mesh_phase),
                     ("launcher", launcher_phase), ("train", train_phase),
                     ("train_mesh", train_mesh_phase),
                     ("dryrun", dryrun_phase)):
        t0 = time.perf_counter()
        phase(rt, name)
        res, faults = {}, []
        try:
            res = fn(rt, device, gen, timer, kernels, faults)
        except Exception:
            traceback.print_exc()
            faults.append("raised")
        log(f"{name} " + json.dumps(res))
        if faults:
            log(f"{name} faults: {faults}")
            failed.append(name)
        unlevered(rt, name, failed)
        log(f"{name}_phase: {time.perf_counter() - t0:.1f} s")

    # K1/K3's SIMT kernel: only the kernel checks (tiles 1 and 2 weights
    # wide) may have launched it
    simt = dict(rt["watch"].simt)
    log("simt_launches_by_phase " + json.dumps(simt))
    served = {p: n for p, n in simt.items() if n and not p.endswith(
        " kernels")}
    if served:
        failed.append(f"fused_decode_matmul:simt launched on served paths: "
                      f"{served}")
    for row in kernels:
        row.setdefault("launches", 0)
    log(json.dumps({"kernels": kernels}))
    log(f"seconds: {time.perf_counter() - t_start:.1f}")
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
