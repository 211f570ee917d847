"""Where the time of the port's main path goes on the card.

    python3 tools/profile_decode.py

Packs Llama-3.2-1B (all 16 layers, weights from a seed) in compressed mode
on the CUDA card, serves the 4 prompts of chip_smoke.py, and profiles one
prefill and 8 decode steps with torch.profiler: device time by kernel,
and the share of the window's wall time in which the device ran a kernel.
Prints one JSON line per window.  Needs one CUDA card.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import CompressionPolicy  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.serve.engine import (build_serve_params,  # noqa: E402
                                      make_serve_fns, sample_tokens)

BATCH, DECODE_STEPS, SEED = 4, 8, 0


def prompts(vocab):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(32, 201, BATCH)
    reqs = [rng.integers(0, vocab, int(n)) for n in lens]
    out = np.zeros((BATCH, int(max(lens))), np.int64)
    for i, r in enumerate(reqs):
        out[i, out.shape[1] - len(r):] = r
    return out


def window(name, fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    busy = 0.0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((e.key, dev / 1e3, e.count))
            busy += dev / 1e3
    rows.sort(key=lambda r: -r[1])
    print(json.dumps({
        "window": name, "wall_ms": wall * 1e3, "device_busy_ms": busy,
        "device_idle_share": 1 - busy / (wall * 1e3),
        "top_kernels": [{"name": k[:80], "ms": ms, "calls": n}
                        for k, ms, n in rows[:12]]}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = get_config("llama3.2-1b").full
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
    window("prefill", run_prefill)
    window(f"decode x{DECODE_STEPS}", run_decode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
