"""End-to-end serving on the PyTorch port — batched requests
against a compressed model.

A request pool with mixed prompt lengths (8–24 tokens) is left-padded
into one batch, prefilled once, then decoded step by step from the
compressed (or int8, or dense) weights through ``make_serve_fns``,
reporting the prefill's ms and tokens/s of the eager decode loop (the
reference's per-phase latency columns, batched).  Beside it, the same
decode phase as replays of one captured CUDA graph of a step
(``serve.engine.decode_graph``: the port's counterpart of the
reference's jitted step; on the CPU it runs the same step eagerly), with
its tokens, which must be the eager loop's.

    PYTHONPATH=src python examples/torch_serve_batched.py [--requests 8] \
        [--mode compressed|quant|dense] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.policy import CompressionPolicy
from repro_torch.models import lm as LM
from repro_torch.serve.engine import (_map_leaves, build_serve_params,
                                      decode_graph, make_serve_fns)
from repro_torch.train.data import DataConfig, DataPipeline


def build_requests(data, n, min_len=8, max_len=24, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        ln = int(rng.integers(min_len, max_len + 1))
        reqs.append(data.batch_at(2000 + i)["tokens"][0, :ln].numpy())
    return reqs


def pad_batch(reqs, pad_id=0) -> torch.Tensor:
    """Left-pad to a rectangle (decode positions align on the right)."""
    ln = max(len(r) for r in reqs)
    out = np.full((len(reqs), ln), pad_id, np.int64)
    for i, r in enumerate(reqs):
        out[i, ln - len(r):] = r
    return torch.from_numpy(out)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--mode", default="compressed",
                    choices=["dense", "quant", "compressed"])
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default; 'cpu' to run there")
    args = ap.parse_args(argv)
    device = resolve_device(device if device is not None else args.device)

    cfg = get_config("llama3.2-1b").smoke
    params = LM.init_lm(cfg, seed=0, device=device)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=4,
                                   seq_len=32))
    if args.mode == "dense":
        serve_params, lut = _map_leaves(params, lambda t: t.to(device)), None
    else:
        st = build_serve_params(params, CompressionPolicy(
            mode=args.mode, min_weight_size=1024), device=device)
        serve_params, lut = st.params, st.lut
        print(f"weights: {args.mode}, "
              f"{sum(st.stats.values()) / 2**20:.2f} MiB on device")

    reqs = build_requests(data, args.requests)
    batch = pad_batch(reqs).to(device)
    b, t0 = batch.shape
    max_len = t0 + args.max_new

    prefill, decode_step = make_serve_fns(cfg, device=device)
    caches = LM.init_caches(cfg, b, max_len, device=device)
    _sync(device)
    t_start = time.perf_counter()
    logits, caches = prefill(serve_params, lut, {"tokens": batch}, caches)
    _sync(device)
    t_prefill = time.perf_counter() - t_start

    tok = torch.argmax(logits, dim=-1)[:, None]
    outs = [tok]
    t_start = time.perf_counter()
    for i in range(args.max_new - 1):
        logits, caches = decode_step(serve_params, lut, tok, caches, t0 + i)
        tok = torch.argmax(logits, dim=-1)[:, None]
        outs.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t_start
    gen = torch.cat(outs, dim=1).cpu()
    n_tokens = b * args.max_new
    print(f"served {args.requests} requests (batch={b}, prompt<= {t0}): "
          f"prefill {t_prefill * 1e3:.1f} ms, eager decode "
          f"{t_decode * 1e3:.1f} ms ({n_tokens / max(t_decode, 1e-9):.1f} "
          "tok/s incl. per-step decompression)")

    # the decode phase as graph replays: a first run captures the step,
    # a second one only replays, and is timed
    graph = decode_graph(serve_params, cfg, lut, b, max_len, device=device)
    graph.run(serve_params, lut, batch, args.max_new)
    tok0 = graph.prefill(serve_params, lut, batch)
    _sync(device)
    t_start = time.perf_counter()
    graph.decode(serve_params, lut, args.max_new - 1)
    _sync(device)
    t_graph = time.perf_counter() - t_start
    graphed = torch.cat([tok0, graph.seq[:, t0 + 1:t0 + args.max_new]],
                        dim=1).cpu()
    steps = max(args.max_new - 1, 1)
    print(f"graphed decode {t_graph * 1e3:.1f} ms "
          f"({b * (args.max_new - 1) / max(t_graph, 1e-9):.1f} tok/s, "
          f"{t_graph * 1e3 / steps:.3f} ms a step; eager "
          f"{t_decode * 1e3 / steps:.3f} ms a step)")
    same = bool(torch.equal(graphed, gen))
    print(f"graphed tokens equal the eager loop's: {same}")
    print("first request continuation:", gen[0].tolist())
    assert same, "the graphed decode must give the eager loop's tokens"
    return {"prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
            "tok_s": n_tokens / max(t_decode, 1e-9),
            "graph_ms": t_graph * 1e3,
            "graph_tok_s": b * (args.max_new - 1) / max(t_graph, 1e-9),
            "tokens": gen, "batch": b, "prompt_len": t0}


if __name__ == "__main__":
    main()
