"""Fault-tolerant training on the PyTorch port — checkpoint/restart.

Trains the Llama smoke model with the production loop (periodic atomic
checkpoints), stops it at 60 % of the way as a preemption would, resumes a
fresh loop from the last commit, and restores the newest checkpoint onto
one device at the end (the port's ``elastic_restore``; a restore onto a
mesh waits for the multi-device port).

    PYTHONPATH=src python examples/torch_fault_tolerant_train.py \
        [--steps 60] [--device cpu]
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.configs import get_config
from repro_torch.models import lm as LM
from repro_torch.train.data import DataConfig, DataPipeline
from repro_torch.train.fault import (FaultConfig, FaultTolerantLoop,
                                     elastic_restore)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.steps import (TrainConfig, init_train_state,
                                     make_train_step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ft_example"))
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default; 'cpu' to run there")
    args = ap.parse_args(argv)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    cfg = get_config("llama3.2-1b").smoke
    params = LM.init_lm(cfg, seed=0, device=args.device)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=8,
                                   seq_len=32))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=5e-3, warmup_steps=10,
                                             total_steps=args.steps))
    step = make_train_step(cfg, tcfg)
    fcfg = FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=10, keep=3,
                       handle_sigterm=False)
    losses = []

    def on_metrics(s, m):
        losses.append(float(m["loss"]))
        if s % 10 == 0:
            print(f"step {s:4d} loss {losses[-1]:.3f}")

    # phase 1: 60 % of the way, then "crash" (the loop stops)
    half = (args.steps * 6 // 10 // 10) * 10 or args.steps // 2
    FaultTolerantLoop(step, init_train_state(params, tcfg), data, fcfg,
                      on_metrics=on_metrics).run(half)
    print(f"--- simulated preemption after step {half} ---")
    # phase 2: a fresh loop resumes from the last committed checkpoint
    loop = FaultTolerantLoop(step, init_train_state(params, tcfg), data,
                             fcfg, on_metrics=on_metrics)
    resumed_at = loop.maybe_resume()
    print(f"resumed from committed step {resumed_at}")
    final = loop.run(args.steps)
    print(f"finished at step {args.steps}, loss {losses[-1]:.3f}")
    # phase 3: the newest checkpoint restored onto one device
    _, at = elastic_restore(args.ckpt_dir, final)
    print(f"restore onto one device at step {at}: ok")
    assert losses[0] > losses[-1], "training should have reduced the loss"
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    return {"resumed_at": resumed_at, "restored_at": at, "losses": losses}


if __name__ == "__main__":
    main()
