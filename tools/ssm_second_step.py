"""How far the first train step's roundoff alone moves the second step's
loss, for Mamba2-2.7B at full width on the card.

    python3 tools/ssm_second_step.py

``chip_smoke.py`` holds a Mamba2 training mesh's losses to one process's
within TRAIN_MESH_LOSS_RTOL.  AdamW's first step sends an element whose
gradient lies near eps by up to lr, so two first steps whose gradients
differ only by roundoff can part at the second step's loss.  At
``chip_smoke.py``'s Mamba2 train case (2 of 64 blocks, f32, seed 0,
lr 5e-3 after one warm-up step, its data), this tool takes two steps in
one process with ``accum_steps`` 1 and with 2 (the same function, its
sums in another order) and on the mesh (1, 2) (two ranks sharing the
card over gloo, each on its SSM heads), the second step on the first's
batch and on the next.  Prints the card's name and power limit, then one
JSON object: each run's [loss, gradient norm] a step.
"""
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

# the second step's batch: the first's again, or the next one
SECOND = {"same": (0, 0), "next": (0, 1)}


def _steps(step, state, batches, idx) -> list:
    out = []
    for i in idx:
        state, m = step(state, batches[i])
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return out


def _rank(rank: int, payload: dict) -> dict:
    """One rank of the mesh (1, 2): both runs from the whole state."""
    rt = cs.load_runtime()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    M, PT, S = rt["mesh"], rt["partition"], rt["steps"]
    mesh = M.make_mesh((1, 2), ("data", "model"))
    out = {}
    for name, idx in SECOND.items():
        state = S.init_train_state(payload["params"], payload["tcfg"])
        specs = PT.make_train_state_specs(state, mesh)
        shards = PT.shard_tree(state, specs, mesh)
        del state
        step = S.make_train_step(payload["cfg"], payload["tcfg"], mesh=mesh,
                                 specs=specs)
        out[name] = _steps(step, shards, payload["batches"], idx)
        del shards
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("ssm_second_step: no CUDA device", file=sys.stderr)
        return 2
    rt = cs.load_runtime()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rt["_build"].build()
    S, opt = rt["steps"], rt["optimizer"]
    replace = dataclasses.replace
    data = rt["DataPipeline"](rt["DataConfig"](
        vocab_size=cs.TRAIN_DATA_VOCAB, batch=cs.TRAIN_BATCH,
        seq_len=cs.TRAIN_SEQ))
    batches = [data.batch_at(0), data.batch_at(1)]
    tcfg = S.TrainConfig(optimizer=opt.AdamWConfig(
        lr=5e-3, warmup_steps=1, total_steps=2))
    cfg = replace(rt["get_config"]("mamba2-2.7b").full,
                  n_layers=cs.TRAIN_MESH_SSM_LAYERS)
    params = rt["LM"].init_lm(cfg, seed=cs.SEED, device="cuda")
    res = {}
    for accum in (1, 2):
        tc = replace(tcfg, accum_steps=accum)
        for name, idx in SECOND.items():
            res[f"one process, accum_steps {accum}, {name}"] = _steps(
                S.make_train_step(cfg, tc), S.init_train_state(params, tc),
                batches, idx)
            torch.cuda.empty_cache()
    outs = rt["mesh"].spawn(_rank, 2, {"cfg": cfg, "tcfg": tcfg,
                                       "params": params,
                                       "batches": batches}, device="cuda")
    for r, out in enumerate(outs):
        for name, steps in out.items():
            res[f"mesh (1, 2) rank {r}, {name}"] = steps
    print(cs.nvidia_smi_line())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
