"""Training launcher — the production training loop, on one device or on
a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 100 --batch 16 --seq 64 [--full] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 256 \
        -m repro_torch.launch.train --mesh single

Counterpart of ``repro/launch/train.py`` with its flags and defaults, plus
``--device``.  It trains any decoder-only arch (an encoder–decoder exits
with the reference's message, as there) on its smoke config (``--full``:
the full width) from ``init_lm(cfg, seed=0)`` in f32 on the seeded
``train.data.DataPipeline``, through ``train.fault.FaultTolerantLoop``:
periodic atomic checkpoints under ``--ckpt-dir`` every ``--ckpt-every``
steps, a checkpoint and a stop at SIGTERM/SIGINT, and a resume from the
newest committed step that loads when it starts again with the same
``--ckpt-dir``.  The optional levers: ``--accum`` microbatches,
``--grad-compression int8_ef``, ``--quantized-opt`` (int8 Adam moments),
``--logits-chunk``.

It runs on the CUDA card unless ``--device cpu`` is given, and never
falls back to the CPU.  ``--mesh host`` (the default) is the one device;
``--mesh single|multi`` trains on the reference's 16×16 or 2×16×16 mesh
(``launch.mesh.make_production_mesh``) over the ranks ``torchrun``
started, and is refused, naming the 256 or 512 ranks it needs, when
fewer were started.  On a mesh each rank stores its shards of the train
state (``sharding.partition.make_train_state_specs``, ZeRO-3), steps on
its data rank's rows (``train/steps.py``), and rank 0 prints; every rank
returns the same losses.  ``main(mesh=...)`` trains on a mesh the caller
made (``launch.mesh.make_mesh`` in ranks it started).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import tempfile

import torch

from .._device import resolve_device
from ..configs import get_config
from ..models import lm as LM
from ..sharding import partition as PT
from ..train.data import DataConfig, DataPipeline
from ..train.fault import FaultConfig, FaultTolerantLoop
from ..train.optimizer import AdamWConfig
from ..train.steps import TrainConfig, init_train_state, make_train_step
from . import mesh as M


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="the arch's full width (smoke config by default)")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"],
                    help="'host': one device; 'single'/'multi': the 16x16 "
                         "or 2x16x16 mesh over the ranks torchrun started")
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--quantized-opt", action="store_true")
    ap.add_argument("--logits-chunk", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="where to train: the CUDA card by default; 'cpu' "
                         "runs the kernels' plain versions")
    return ap


def main(argv=None, *, params=None, on_metrics=None, mesh=None) -> dict:
    """Run the launcher on ``argv`` (default: the command line).
    ``params``: the arch's weights to start from instead of
    ``init_lm(cfg, seed=0)`` (a resume restores over them).
    ``on_metrics(step, metrics)`` is called after each step, beside the
    printing.  ``mesh``: a mesh of this process's ranks to train on
    instead of ``--mesh``'s.  → {"start_step", "end_step", "losses"
    {step: loss}}."""
    ap = _parser()
    args = ap.parse_args(argv)
    if mesh is None and args.mesh != "host":
        need = 512 if args.mesh == "multi" else 256
        have = M.world_size()
        if need > have:
            ap.error(f"--mesh {args.mesh} needs {need} devices, have {have} "
                     f"(start {need} ranks with torchrun)")
        M.init_from_env(args.device or "cuda")
        mesh = M.make_production_mesh(multi_pod=args.mesh == "multi")
        if mesh is None:          # a rank past the mesh trains nothing
            return {}
    if mesh is not None and mesh.size <= 1:
        mesh = None
    device = resolve_device(args.device)
    quiet = (contextlib.redirect_stdout(io.StringIO())
             if mesh is not None and mesh.rank else contextlib.nullcontext())
    with quiet:
        return _train(args, device, params, on_metrics, mesh)


def _train(args, device, params, on_metrics, mesh) -> dict:
    entry = get_config(args.arch)
    cfg = entry.full if args.full else entry.smoke
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr,
                              warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps,
                              quantized_state=args.quantized_opt),
        accum_steps=args.accum, grad_compression=args.grad_compression,
        logits_chunk=args.logits_chunk)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   batch=args.batch, seq_len=args.seq))
    if cfg.family == "encdec":
        raise SystemExit("use examples/ for enc-dec; LM families here")
    if params is None:
        params = LM.init_lm(cfg, seed=0, device=device,
                            dtype=tcfg.param_dtype)
    state = init_train_state(params, tcfg)
    specs = None
    if mesh is not None:
        specs = PT.make_train_state_specs(state, mesh)
        state = PT.shard_tree(state, specs, mesh)
        print(f"mesh: {dict(mesh.shape)} (ZeRO-3 train state)", flush=True)
    del params
    losses = {}

    def metrics(s, m):
        losses[s] = float(m["loss"])
        if s % 10 == 0 or s == 1:
            print(f"step {s:5d} loss {losses[s]:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"lr {float(m['lr']):.2e}", flush=True)
        if on_metrics is not None:
            on_metrics(s, m)

    loop = FaultTolerantLoop(
        make_train_step(cfg, tcfg, mesh=mesh, specs=specs), state, data,
        FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        state_shardings=specs, mesh=mesh, on_metrics=metrics)
    del state
    try:
        start = loop.maybe_resume()
        if start:
            print(f"resumed from committed step {start}", flush=True)
        loop.run(args.steps)
    finally:
        loop.guard.restore()
    end = max(losses, default=start)
    print(f"done at step {end}." if end >= args.steps else
          f"stopped at step {end} (preempted; committed).", flush=True)
    return {"start_step": start, "end_step": end, "losses": losses}


if __name__ == "__main__":
    main()
