"""Why the loss of a short full-width training run rises or falls: the same
model, data and steps under several AdamW settings.

    python3 tools/train_loss_witness.py [--steps 8]

On Llama-3.2-1B at full width (16 layers, f32, seed 0, on the CUDA card),
batch 4 × 256 tokens from ``DataPipeline``'s Markov stream, each run from
the same initial weights:

  * ``launcher_8``: the reference launcher's AdamW at ``--steps`` steps
    (lr 5e-3, warmup max(steps // 10, 1), cosine over the run) over the
    model's full vocabulary;
  * ``lr_5e-4``: the same at a tenth of the lr;
  * ``launcher_50``: the launcher's default schedule (lr 5e-3, 50 steps,
    warmup 5), its first ``--steps`` steps;
  * ``ids_1024``: ``launcher_8`` over the first 1 024 token ids;
  * ``descent``: one step at lr 1e-6 on batch 0, and batch 0's loss
    before and after it (a first-order check of the gradient's sign:
    Adam's first step moves each parameter by about lr against its
    gradient, so the loss must fall).

Each run prints its losses and gradient norms a step.  Prints the card's
name and power limit, then one JSON line.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ, SEED = 4, 256, 0


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("train_loss_witness: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import lm as LM
    from repro_torch.train import steps as S
    from repro_torch.train.data import DataConfig, DataPipeline
    from repro_torch.train.optimizer import AdamWConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cfg = get_config("llama3.2-1b").full
    n = args.steps

    def data(vocab):
        return DataPipeline(DataConfig(vocab_size=vocab, batch=BATCH,
                                       seq_len=SEQ))

    def train(lr, warmup, total, vocab, steps):
        tcfg = S.TrainConfig(optimizer=AdamWConfig(
            lr=lr, warmup_steps=warmup, total_steps=total))
        d = data(vocab)
        state = S.init_train_state(LM.init_lm(cfg, seed=SEED,
                                              device=device), tcfg)
        step = S.make_train_step(cfg, tcfg)
        losses, norms, lrs = [], [], []
        t0 = time.perf_counter()
        for i in range(steps):
            b = {k: v.to(device) for k, v in d.batch_at(i).items()}
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            lrs.append(float(m["lr"]))
        return state, tcfg, {"lr": lr, "warmup": warmup, "total": total,
                             "vocab": vocab, "losses": losses,
                             "grad_norms": norms, "lrs": lrs,
                             "s": time.perf_counter() - t0}

    runs = {}
    for name, lr, warmup, total, vocab in (
            ("launcher_8", 5e-3, max(n // 10, 1), n, cfg.vocab_size),
            ("lr_5e-4", 5e-4, max(n // 10, 1), n, cfg.vocab_size),
            ("launcher_50", 5e-3, 5, 50, cfg.vocab_size),
            ("ids_1024", 5e-3, max(n // 10, 1), n, 1024)):
        state, _, runs[name] = train(lr, warmup, total, vocab, n)
        del state
        torch.cuda.empty_cache()
        print(f"{name}: " + json.dumps(runs[name]), flush=True)

    state, tcfg, run = train(1e-6, 1, n, cfg.vocab_size, 1)
    b0 = {k: v.to(device) for k, v in data(cfg.vocab_size).batch_at(
        0).items()}
    after = float(S.loss_and_grads(state["params"], cfg, tcfg, b0)[0])
    run["loss_after"] = after
    run["falls"] = after < run["losses"][0]
    runs["descent"] = run
    print("descent: " + json.dumps(run), flush=True)
    print(smi())
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "model": cfg.name, "steps": n,
                      "first_last": {k: [v["losses"][0], v["losses"][-1]]
                                     for k, v in runs.items()
                                     if k != "descent"},
                      "descent": [run["losses"][0], after]}))


if __name__ == "__main__":
    main()
