"""Whether an attention op on the card gives a head the same bits when a
mesh rank runs it on its share of the heads as when one process runs it
on all of them.

    python3 tools/mesh_bits.py [--shards N]

On a mesh whose model ranks divide the kv heads, each rank attends its
heads alone (``models.layers.apply_attention``'s heads path), and the
serving contract is that its tokens are one process's bit for bit.  At
Llama-3.2-1B's attention shapes (32 q heads, 8 kv heads, head dim 64;
the fixed batch's 4 rows, a 175-token prefill over a 207-position cache,
a decode step at position 175), on seeded random bf16 inputs, this tool
runs each op the heads path runs over the heads (K2's prefill over the
cache, ``layers._attend_cached``'s decode attention and its pieces:
the two f32 einsums, the masked softmax; and the decode attention with
its rows padded to ROW_PAD · all kv heads / the rank's, as the mesh runs
it, ``kv_heads=``) on every head and on each
rank's heads (``--shards``, default 2), and reports for each op whether
every rank's heads are bitwise the whole call's and the largest
difference.  Prints the card's name and power limit, then one JSON line.
"""
import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

B, T0, NEW, HQ, HKV, D = 4, 175, 32, 32, 8, 64


def _einsums(q, k, v, pos):
    """``_attend_cached``'s decode math, op by op: → {op: output}."""
    b, t, hq, hd = q.shape
    hkv = k.shape[2]
    pad = L._row_pad(b, q)
    qf = pad(q.reshape(b, t, hkv, hq // hkv, hd))
    kf, vf = pad(k), pad(v)
    logits = torch.einsum("btgrd,blgd->btgrl", qf, kf) / math.sqrt(hd)
    mask = L._decode_mask(pos, t, k.shape[1], q.device)[None, :, None, None]
    masked = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(masked, dim=-1)
    out = torch.einsum("btgrl,blgd->btgrd", p, vf)
    return {"scores einsum": logits[:b].reshape(b, t, hq, -1),
            "softmax": p[:b].reshape(b, t, hq, -1),
            "value einsum": out[:b].reshape(b, t, hq, hd)}


def compare(whole: dict, parts: list, hq_dim: int, n: int) -> dict:
    out = {}
    for op, w in whole.items():
        per = w.shape[hq_dim] // n
        diffs = [float((p[op].float() - w.narrow(hq_dim, i * per, per)
                        .float()).abs().max()) for i, p in enumerate(parts)]
        out[op] = {"bitwise": all(torch.equal(
            p[op], w.narrow(hq_dim, i * per, per))
            for i, p in enumerate(parts)), "max_abs_diff": max(diffs)}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cpu: the plain versions, to try the tool")
    args = ap.parse_args()
    n = args.shards
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        _build.build()
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    lk = T0 + NEW
    q = rand(B, T0, HQ, D)
    k, v = rand(B, lk, HKV, D), rand(B, lk, HKV, D)
    qd = rand(B, 1, HQ, D)
    pos = torch.tensor(T0, device=dev)
    qh, kh = HQ // n, HKV // n

    def run(q_, k_, v_, qd_):
        return {"K2 prefill over the cache":
                L._attend_cache_flash(q_, k_, v_, 0),
                "decode attention (_attend_cached)":
                L._attend_cached(qd_, k_, v_, pos, 1),
                "decode attention, rows padded for every kv head":
                L._attend_cached(qd_, k_, v_, pos, 1, kv_heads=HKV),
                **_einsums(qd_, k_, v_, pos)}

    with torch.no_grad():
        whole = run(q, k, v, qd)
        parts = [run(q[:, :, i * qh:(i + 1) * qh], k[:, :, i * kh:(i + 1) * kh],
                     v[:, :, i * kh:(i + 1) * kh], qd[:, :, i * qh:(i + 1) * qh])
                 for i in range(n)]
    res = compare(whole, parts, 2, n)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    print(json.dumps({"shards": n, "shapes": {
        "prefill": [B, HQ, T0, D], "keys": lk, "decode": [B, 1, HQ, D]},
        "ops": res, "launches": dict(_build.LAUNCH_COUNTS),
        "dispatch": dict(ops.DISPATCH_COUNTS)}))


if __name__ == "__main__":
    main()
