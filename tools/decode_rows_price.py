"""Decode rows above 16 on the card: their bits against each row alone, and
what a 32-row step costs.

    python3 tools/decode_rows_price.py [--src DIR] [--batch 32]

On Llama-3.2-1B at full width (16 layers, seeded weights packed in
compressed mode on the CUDA card), with the port's package taken from
``--src`` (default: this checkout's ``src``; give another tree's to
compare, e.g. a commit unpacked by ``git archive``):

  * rows: at M = ``--batch`` decode rows, the max |difference| of each row
    against itself alone (M = 1) for K1 (``wo``), K5 (the LM head), the
    decode attention at the full head counts (232 cached positions) and
    the whole decode step, with the number of rows that differ;
  * generate: a batch of ``--batch`` seeded 64-token prompts, the graphed
    decode step's ms (replays of ``STEPS`` steps, median of 3 runs);
  * engine: ``--batch`` requests through an ``Engine`` of ``--batch``
    slots (pages of 8), the median ms of a tick without an admission,
    and for the first ``CHECKED`` requests the index of the first token
    that differs from ``generate`` of the prompt alone (null: none).

Prints the card's name and power limit, then one JSON line.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PROMPT, NEW, STEPS, PAGE, CHECKED = 64, 40, 32, 8, 4


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def first_diff(a, b):
    d = np.nonzero(np.asarray(a) != np.asarray(b))[0]
    return int(d[0]) if len(d) else None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.serve import engine as E
    from repro_torch.serve.context import ServeContext
    from repro_torch.serve.scheduler import Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    n = args.batch
    cfg = get_config("llama3.2-1b").full
    st = E.build_serve_params(LM.init_lm(cfg, seed=0, device=dev),
                              CompressionPolicy(), device=dev)
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def rows(fn, *a):
        many = fn(*a)
        d = [float((many[i:i + 1].float() - fn(*(t[i:i + 1] for t in a))
                    .float()).abs().max()) for i in range(n)]
        return {"max_abs_diff": max(d), "rows_differing": sum(x > 0 for x in d)}

    out = {"src": args.src, "batch": n, "rows": {}}
    blk = st.params["blocks"][0]["attn"]
    head = st.params.get("lm_head", st.params["embed"])
    out["rows"]["k1_wo"] = rows(lambda h: L.linear(h, blk["wo"], st.lut),
                                rnd(n, 1, blk["wo"].shape[1]))
    out["rows"]["k5_head"] = rows(lambda h: L.linear(h, head, st.lut),
                                  rnd(n, 1, cfg.d_model))
    pos = torch.randint(1, 231, (n,), generator=g, device=dev)
    out["rows"]["attention"] = rows(
        lambda q, k, v, p: L._attend_cached(q, k, v, p, 1),
        rnd(n, 1, 32, 64), rnd(n, 232, 8, 64), rnd(n, 232, 8, 64), pos)
    _, decode_step = E.make_serve_fns(cfg, device=dev)
    caches = LM.init_caches(cfg, n, 232, device=dev)
    for t in [t for c in caches["blocks"] for t in c.values()]:
        t.copy_(rnd(*t.shape))

    def step(tok, p, r):
        c = {"blocks": [{k: v[r].clone() for k, v in lc.items()}
                        for lc in caches["blocks"]]}
        return decode_step(st.params, st.lut, tok, c, p)[0]

    tok = torch.randint(1, cfg.vocab_size, (n, 1), generator=g, device=dev)
    many = step(tok, pos, slice(0, n))
    d = [float((many[i:i + 1].float() - step(tok[i:i + 1], pos[i:i + 1],
                                            slice(i, i + 1)).float())
               .abs().max()) for i in range(n)]
    out["rows"]["decode_step"] = {"max_abs_diff": max(d),
                                  "rows_differing": sum(x > 0 for x in d)}
    del caches

    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, (n, PROMPT))
    ids = torch.as_tensor(prompts, device=dev)
    graph = E.decode_graph(st.params, cfg, st.lut, n, PROMPT + STEPS + 1,
                           device=dev)
    ms = []
    for _ in range(3):
        graph.prefill(st.params, st.lut, ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.decode(st.params, st.lut, STEPS)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / STEPS * 1e3)
    out["generate_decode_ms_per_step"] = float(np.median(ms))
    out["generate_decode_ms_runs"] = ms
    E.drop_graphs(cfg)

    eng = Engine(ServeContext(cfg, lut=st.lut), st.params, n_slots=n,
                 max_len=PROMPT + NEW + PAGE, page_size=PAGE)
    for i in range(n):
        eng.submit(Request(tokens=prompts[i], max_new=NEW, rid=i))
    tick_s = []
    while eng.health()["occupied"] or eng.health()["queued"]:
        admitted = eng.health()["queued"] > 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if not admitted and eng.stats["occupancy"][-1]:
            tick_s.append(time.perf_counter() - t)
    out["engine_tick_ms_median"] = float(np.median(tick_s)) * 1e3
    out["engine_ticks_timed"] = len(tick_s)
    by_rid = {c.rid: c for c in eng.completions}
    out["engine_first_token_differing_from_generate"] = [
        first_diff(by_rid[i].tokens, E.generate(
            st.params, cfg, torch.as_tensor(prompts[i])[None], lut=st.lut,
            max_new=NEW, max_len=eng.pool.max_len, device=dev)[0].cpu()
            .numpy()) for i in range(CHECKED)]
    print(torch.cuda.get_device_name(0), "|", smi(), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
