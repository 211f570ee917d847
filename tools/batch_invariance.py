"""Whether a decode row on the card depends on the rows beside it.

    python3 tools/batch_invariance.py [--batch N] [--plain-mean] [--unpadded]

The engine (``serve.scheduler.Engine``) serves each request bitwise equal
to ``generate`` of its prompt alone only if every op of a decode step
gives a row the same bits in a batch of ``n_slots`` as alone.  On
Llama-3.2-1B at full width (16 layers, seeded weights packed in
compressed mode on the CUDA card) and one seeded 32-token prompt, this
tool:

  * runs STEPS (180) greedy decode steps twice in lockstep, the row alone
    and the same row in a batch of ``--batch`` rows (default 2; the other
    rows idle at position 0, as empty slots), and at the first step whose
    logits differ names the first ops (``models.layers`` functions) whose
    outputs differ for the row, with whether their inputs were equal;
  * serves the prompt through an ``Engine`` of 1, 2, 4, 8 and 16 slots
    (232 tokens, pages of 8) for STEPS tokens and gives the index of the
    first token that differs from ``generate``'s (null: none).

``--plain-mean`` first puts back a plain ``torch.mean`` in ``rms_norm``
(the port before its norm summed a row in a layout fixed for any number
of rows), to show what that layout repairs; ``--unpadded`` runs the
decode attention's einsums at the batch's own rows (``layers.ROW_PAD`` =
1; the port before it padded them to 16 rows).  Prints the card's name
and power limit, then one JSON line.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import CompressionPolicy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402
from repro_torch.serve.context import ServeContext  # noqa: E402
from repro_torch.serve.scheduler import Engine, Request  # noqa: E402

PROMPT, MAX_LEN, PAGE, STEPS = 32, 232, 8, 180
SLOTS = (1, 2, 4, 8, 16)
BATCH = [2]           # the lockstep batch (--batch)
TRACED = ("embed", "rope_tables", "rms_norm", "linear", "apply_rope",
          "_kv_write", "_attend_cached", "_silu_mul")


def first_diff(a, b):
    d = np.nonzero(np.asarray(a) != np.asarray(b))[0]
    return int(d[0]) if len(d) else None


def trace_ops(record):
    """Wrap the traced layer functions: each call appends (name, row 0 of
    its tensor inputs, row 0 of its output) to ``record[0]`` when it is a
    list."""
    def wrap(name, fn):
        def traced(*args, **kw):
            out = fn(*args, **kw)
            if record[0] is not None:
                def row0(t):
                    t = t[0] if t.ndim and t.shape[0] in (1, BATCH[0]) \
                        else t
                    return t.detach().float().clone()
                first = out[0] if isinstance(out, tuple) else out
                record[0].append((name, [row0(a) for a in args
                                         if torch.is_tensor(a)],
                                  row0(first)))
            return out
        return traced
    for name in TRACED:
        setattr(L, name, wrap(name, getattr(L, name)))


def lockstep(cfg, st, prompt, steps, dev):
    """The row alone and in a batch of BATCH rows, step by step on the
    alone run's greedy tokens.  → the first step whose logits differ and
    the first ops whose outputs differ there."""
    record = [None]
    trace_ops(record)
    prefill, step = E.make_serve_fns(cfg, device=dev)
    n = BATCH[0]
    one = LM.init_caches(cfg, 1, MAX_LEN, device=dev)
    two = LM.init_caches(cfg, n, MAX_LEN, device=dev)
    logits, _ = prefill(st.params, st.lut, {"tokens": prompt[None]}, one)
    for a, b in zip(E._tensors(two), E._tensors(one)):
        a[:1].copy_(b)
    tok = int(E.sample_tokens(logits)[0])
    for i in range(steps):
        pos = PROMPT + i
        record[0] = []
        l1, _ = step(st.params, st.lut, torch.tensor([[tok]], device=dev),
                     one, torch.tensor([pos], device=dev))
        ops1, record[0] = record[0], []
        l2, _ = step(st.params, st.lut,
                     torch.tensor([[tok]] + [[0]] * (n - 1), device=dev),
                     two, torch.tensor([pos] + [0] * (n - 1), device=dev))
        ops2, record[0] = record[0], None
        if not torch.equal(l1[0], l2[0]):
            ops = []
            for (name, in1, o1), (_, in2, o2) in zip(ops1, ops2):
                if not torch.equal(o1, o2):
                    ops.append({"op": name, "inputs_equal": all(
                        torch.equal(a, b) for a, b in zip(in1, in2)),
                        "max_abs_diff": float((o1 - o2).abs().max())})
                if len(ops) == 4:
                    break
            return {"first_step": i, "ops": ops}
        tok = int(E.sample_tokens(l1)[0])
    return {"first_step": None, "ops": []}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--plain-mean", action="store_true")
    ap.add_argument("--unpadded", action="store_true")
    args = ap.parse_args()
    BATCH[0] = args.batch
    if not torch.cuda.is_available():
        print("batch_invariance: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.plain_mean:
        L._mean_square = lambda xf: torch.mean(xf * xf, dim=-1,
                                               keepdim=True)
    if args.unpadded:
        L.ROW_PAD = 1
    _build.build()
    dev = torch.device("cuda", 0)
    cfg = get_config("llama3.2-1b").full
    st = E.build_serve_params(LM.init_lm(cfg, seed=0, device=dev),
                              CompressionPolicy(mode="compressed"),
                              device=dev, manifest=False)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, PROMPT)
    ids = torch.as_tensor(prompt, device=dev)
    want = E.generate(st.params, cfg, ids[None], lut=st.lut,
                      max_new=STEPS, max_len=MAX_LEN,
                      device=dev)[0, PROMPT:].cpu().numpy()
    engine = {}
    for n in SLOTS:
        eng = Engine(ServeContext(cfg, lut=st.lut, device=dev), st.params,
                     n_slots=n, max_len=MAX_LEN, page_size=PAGE)
        eng.submit(Request(tokens=prompt, max_new=STEPS))
        eng.drain()
        eng.close()
        engine[f"{n}_slots_first_diff"] = first_diff(
            eng.completions[0].tokens[PROMPT:], want)
    out = {"model": cfg.name, "steps": STEPS,
           "plain_mean": args.plain_mean, "unpadded": args.unpadded,
           f"batch_of_{args.batch}": lockstep(cfg, st, ids, STEPS, dev),
           "engine_vs_generate": engine}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
