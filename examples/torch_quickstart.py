"""Quickstart on the PyTorch port — the whole Tiny-QMoE pipeline in one
script.

Builds the Llama-3.2 smoke model, trains it briefly so the weights have
real structure (100 AdamW steps: lr 1e-2, warmup 10, a 200-step schedule,
batches of 16 × 32 tokens from data seed 0), quantizes and
dictionary-compresses it (the paper's §3 + §4 pipeline), and generates
12 greedy tokens for 2 prompts from the compressed form and from the
int8 (quant) form.

Losslessness is checked where each device can hold it:
  * the codec, on any device: every compressed weight decodes
    (``PackedLinear.materialize_int8``) to the quant state's int8 values,
    byte for byte;
  * the tokens: on the CPU the two modes run the same plain product and
    must agree token for token, as in the reference's quickstart.  On the
    card the compressed weights run the fused decode kernel (K1) and the
    int8 ones the dequant-matmul kernel (K5), which sum in other orders,
    so a token may part where the logits tie: each row may differ only
    from a step whose logits give both tokens the same value in one of
    the two runs (the exact-tie rule), and every parting token is printed
    with its top-2 gap.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.compressed import PackedLinear, QuantLinear
from repro_torch.core.policy import CompressionPolicy
from repro_torch._device import resolve_device
from repro_torch.models import lm as LM
from repro_torch.serve.context import ServeContext
from repro_torch.serve.engine import (_tensors, build_serve_params,
                                      generate, make_serve_fns)
from repro_torch.train.data import DataConfig, DataPipeline
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.steps import (TrainConfig, init_train_state,
                                     make_train_step)

TRAIN_STEPS, PROMPTS, PROMPT_LEN, MAX_NEW = 100, 2, 16, 12


def _pairs(sc, sq):
    """(name, compressed container, quant container) for every weight the
    compressed state packed (both states walk the same tree)."""
    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                yield from walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                yield from walk(x, y, f"{path}/{i}")
        elif isinstance(a, PackedLinear):
            yield path, a, b
    yield from walk(sc.params, sq.params, "")


def codec_equal(sc, sq) -> tuple:
    """(weights compared, weights whose decoded int8 differs from the
    quant state's values)."""
    n, bad = 0, []
    for name, pc, pq in _pairs(sc, sq):
        n += 1
        if not isinstance(pq, QuantLinear) or not torch.equal(
                pc.materialize_int8(sc.lut), pq.values):
            bad.append(name)
    return n, bad


@torch.no_grad()
def greedy_with_logits(state, cfg, prompt, device):
    """The eager loop (``make_serve_fns``: a prefill, then decode steps):
    → (new tokens (B, MAX_NEW), each step's logits [(B, V)])."""
    prefill, decode_step = make_serve_fns(cfg, device=device)
    b, t0 = prompt.shape
    caches = LM.init_caches(cfg, b, t0 + MAX_NEW, device=device)
    logits, caches = prefill(state.params, state.lut, {"tokens": prompt},
                             caches)
    steps, toks = [logits.float()], [torch.argmax(logits, -1)]
    for i in range(MAX_NEW - 1):
        logits, caches = decode_step(state.params, state.lut,
                                     toks[-1][:, None], caches, t0 + i)
        steps.append(logits.float())
        toks.append(torch.argmax(logits, -1))
    return torch.stack(toks, 1), steps


def parting_tokens(out_c, out_q, logits_c, logits_q) -> list:
    """Each row's first step where the two modes part: (row, step, the
    compressed and quant tokens, each run's top-2 gap there, whether the
    exact-tie rule holds)."""
    found = []
    for r in range(out_c.shape[0]):
        diff = (out_c[r] != out_q[r]).nonzero()
        if not len(diff):
            continue
        s = int(diff[0])
        tc, tq = int(out_c[r, s]), int(out_q[r, s])
        gaps, tied = [], False
        for lg in (logits_c[s][r], logits_q[s][r]):
            top = torch.topk(lg, 2).values
            gaps.append(float(top[0] - top[1]))
            tied |= bool(lg[tc] == lg[tq])
        found.append({"row": r, "step": s, "compressed": tc, "quant": tq,
                      "gap_compressed": gaps[0], "gap_quant": gaps[1],
                      "tied": tied})
    return found


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default; 'cpu' to run there")
    args = ap.parse_args(argv)
    device = resolve_device(device if device is not None else args.device)

    # 1. A small model with learned structure (random weights don't
    #    compress).
    cfg = get_config("llama3.2-1b").smoke
    print(f"model: {cfg.name}  layers={cfg.n_layers} d={cfg.d_model} "
          f"vocab={cfg.vocab_size}  device={device}")
    params = LM.init_lm(cfg, seed=0, device=device)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=16,
                                   seq_len=32, seed=0))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-2, warmup_steps=10,
                                             total_steps=200))
    state = init_train_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    for i in range(TRAIN_STEPS):
        state, m = step(state, data.batch_at(i))
    loss = float(m["loss"])
    print(f"trained {TRAIN_STEPS} steps, loss={loss:.3f}")
    params = state["params"]

    # 2. Quantize + compress (paper §3 + §4).
    dense_bytes = sum(t.numel() * t.element_size()
                      for t in _tensors(params))
    sc = build_serve_params(params, CompressionPolicy(
        mode="compressed", min_weight_size=1024), device=device)
    comp_bytes = sum(sc.stats.values())
    print(f"dense {dense_bytes / 2**20:.2f} MiB -> compressed "
          f"{comp_bytes / 2**20:.2f} MiB "
          f"({dense_bytes / comp_bytes:.1f}x, "
          f"dictionary={len(sc.table or {})} entries)")
    sq = build_serve_params(params, CompressionPolicy(
        mode="quant", min_weight_size=1024), device=device)

    # 3. The codec is lossless over the quantized weights.
    n_w, bad = codec_equal(sc, sq)
    print(f"codec: {n_w - len(bad)}/{n_w} compressed weights decode to the "
          "quant state's int8 values byte for byte")

    # 4. Serve from both forms.
    prompt = data.batch_at(999)["tokens"][:PROMPTS, :PROMPT_LEN].to(device)
    out_c = generate(sc.params, cfg, prompt,
                     ctx=ServeContext.from_state(cfg, sc, device=device),
                     max_new=MAX_NEW)
    out_q = generate(sq.params, cfg, prompt,
                     ctx=ServeContext.from_state(cfg, sq, device=device),
                     max_new=MAX_NEW)
    exact = bool(torch.equal(out_c, out_q))
    print(f"compressed generation: {out_c[0, -MAX_NEW:].tolist()}")
    print(f"matches quantized model exactly: {exact}")
    result = {"loss": loss, "dense_bytes": dense_bytes,
              "compressed_bytes": comp_bytes, "codec_weights": n_w,
              "codec_mismatch": bad, "exact": exact,
              "compressed": out_c.cpu(), "quant": out_q.cpu(),
              "parting": []}
    assert not bad, f"codec not lossless on {bad}"
    if device.type == "cpu":
        assert exact, ("dictionary codec must be lossless over quantized "
                       "weights")
        return result
    # on the card: the eager loops' step logits name any parting token
    new_c, lc = greedy_with_logits(sc, cfg, prompt, device)
    new_q, lq = greedy_with_logits(sq, cfg, prompt, device)
    parting = parting_tokens(new_c, new_q, lc, lq)
    for p in parting:
        print(f"  row {p['row']} parts at step {p['step']}: compressed "
              f"{p['compressed']} vs quant {p['quant']}, top-2 gap "
              f"{p['gap_compressed']} / {p['gap_quant']}, exact tie "
              f"{p['tied']}")
    result["parting"] = parting
    result["eager_matches_generate"] = bool(
        torch.equal(new_c.cpu(), out_c[:, -MAX_NEW:].cpu())
        and torch.equal(new_q.cpu(), out_q[:, -MAX_NEW:].cpu()))
    assert result["eager_matches_generate"], \
        "generate's graphed tokens must be the eager loop's"
    assert all(p["tied"] for p in parting), \
        f"tokens part away from an exact tie: {parting}"
    return result


if __name__ == "__main__":
    main()
