"""The bits of K1, K3, K2 and K5's decode kernel on fixed-seed inputs, for
holding a kernel change to "unchanged bit for bit".

    python3 tools/k1_bits.py [--src DIR] [--check]

Imports the port from ``--src`` (default: this checkout's ``src``),
builds its fused decode-matmul kernel on the CUDA card, and runs K1 on
untiled planes (G = 1) and K3 on expert stacks (``CASES``: the decode
kernel at M ≤ 4 and at 5–16 rows, the tensor-core kernel) on weights and
x drawn with numpy from one seed, so that two trees see the same inputs,
and K2 (its flash-attention kernels) at the main paths' prefill shapes
(``FLASH_CASES``: the bf16 kernel on bf16, the f32 kernel, three-term
TF32, on f32 q beside bf16 k and v; each case's error against the plain
version is printed too, and ``--check`` holds the f32 cases to K2's f32
tolerance, 1e-4), and K5 (``dequant_matmul``) at M = 1–4 on both paths' int8 LM heads
(``K5_CASES``: its decode kernel), quantized from numpy draws.
Prints one JSON line: the CRC32 of each case's output bytes, the card's
name and SM count, and for the cases above 4 rows whether every row is
bitwise that row alone (M = 1: what a decode-kernel case above 4 rows
must give).  ``--check`` compares the CRCs with ``EXPECTED`` (taken from
an earlier tree on an H100 of 132 SMs; the plan, and so the order of the
sums, depends on the SM count) and exits 1 on a difference or on a row
that differs from itself alone.

Only functions of the port that every tree since K3 has are used:
``fused_decode_matmul`` and ``grouped_fused_decode_matmul`` on 2-D and
stacked planes, ``pack_expert_stack`` to pack, ``flash_attention`` and its
plain version, ``quantize_linear`` and ``dequant_matmul``.
"""
from __future__ import annotations

import argparse
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 0

# (name, experts E (0: K1 on one weight), N, K, M, x kind)
CASES = (
    ("k1_decode", 0, 2048, 2048, 4, "rand"),
    ("k1_decode_int", 0, 2048, 2048, 4, "int"),
    ("k1_decode_t128", 0, 2048, 1408, 3, "rand"),
    ("k1_decode_m9", 0, 512, 2048, 9, "rand"),
    ("k1_mma", 0, 1024, 2048, 300, "rand"),
    ("k1_mma_int", 0, 1024, 2048, 300, "int"),
    ("k3_decode", 8, 1408, 2048, 4, "rand"),
    ("k3_decode_c8", 8, 1408, 2048, 8, "rand"),
    ("k3_decode_c16", 8, 2048, 1408, 16, "rand"),
    ("k3_mma", 8, 2048, 1408, 130, "rand"),
)

# (name, B, Hq, Hkv, T, Dqk, Dv, q dtype): keys T + 32, q_offset 0; k and
# v bf16.  An f32 case's contract is K2's f32 tolerance against the plain
# version, F32_ATOL, not its bits: its CRC is the bits of the kernel that
# passed it when they were taken.
F32_ATOL = 1e-4
FLASH_CASES = (
    ("k2_mma_64", 4, 32, 8, 175, 64, 64, "bf16"),
    ("k2_mma_192", 4, 16, 16, 175, 192, 128, "bf16"),
    ("k2_tf32x3_64", 4, 32, 8, 175, 64, 64, "f32"),
    ("k2_tf32x3_192", 4, 16, 16, 175, 192, 128, "f32"),
)

# (name, N, K, M): K5 on an int8 LM head (Llama-3.2-1B's, DeepSeek-V2-
# Lite's) at decode batch, random bf16 x, bf16 output
K5_CASES = tuple((f"k5_decode_{arch}_m{m}", n, 2048, m)
                 for arch, n in (("llama", 128256), ("deepseek", 102400))
                 for m in (1, 2, 3, 4))

# CRC32 of each case's output on an H100 80GB HBM3 (132 SMs), from the
# tree before K1's column groups and K2's smoke head dims (and the same
# from the tree with them); the key is the SM count the plans were made for.
# The cases above 4 rows (k1_decode_m9, k3_decode_c8 / c16) are from the
# tree that gave the decode kernel 16 rows, their rows each bitwise equal
# to the row alone; before it M = 9 ran the SIMT kernel (CRC 846810400).
EXPECTED: dict = {132: {
    "k1_decode": 2086993932, "k1_decode_int": 1476962406,
    "k1_decode_t128": 911195632, "k1_decode_m9": 3968490457,
    "k3_decode_c8": 674148794, "k3_decode_c16": 3269957869,
    "k1_mma": 34615304, "k1_mma_int": 942546493,
    "k3_decode": 360643931, "k3_mma": 3723757787,
    "k2_mma_64": 3481377767, "k2_mma_192": 505407163,
    # K2's f32 kernel (three-term TF32), within 1e-4 of the plain version
    # there (1.5e-6 and 2.4e-6); the SIMT kernel it replaced gave
    # 1568519408 and 484588909
    "k2_tf32x3_64": 636781454, "k2_tf32x3_192": 111455433,
    # K5's decode kernel, from the tree before K5's tensor-core kernel
    "k5_decode_llama_m1": 1744373323, "k5_decode_llama_m2": 2962426492,
    "k5_decode_llama_m3": 3509981583, "k5_decode_llama_m4": 1652619544,
    "k5_decode_deepseek_m1": 3800816622,
    "k5_decode_deepseek_m2": 2631134178,
    "k5_decode_deepseek_m3": 1246984601,
    "k5_decode_deepseek_m4": 1565512306}}


def case_outputs(device, rows_alone=None, flash_err=None) -> dict:
    """{case: CRC32 of the output bytes} for ``CASES`` on ``device``; for
    the K1/K3 cases above 4 rows, ``rows_alone[case]`` is whether each row
    of the output is bitwise that row computed alone (M = 1); for the K2
    cases, ``flash_err[case]`` is the output's largest distance from the
    plain version's."""
    from repro_torch.core.compressed import pack_expert_stack
    from repro_torch.kernels import fused_decode_matmul as fdm
    out = {}
    for name, e, n, k, m, kind in CASES:
        rng = np.random.default_rng([SEED, n, k, m, e])
        ws = [torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)
                               * 0.02).to(device) for _ in range(max(e, 1))]
        pl, lut = pack_expert_stack(ws)
        del ws
        shape = (max(e, 1), m, k)
        if kind == "int":
            x = rng.integers(-4, 5, shape).astype(np.float32)
        else:
            x = rng.standard_normal(shape).astype(np.float32)
        x = torch.from_numpy(x).to(device).to(torch.bfloat16)
        kw = dict(shape=tuple(pl.shape), tile_n=pl.tile_n, tile_k=pl.tile_k,
                  out_dtype=torch.float32)
        def run(xs):
            if e == 0:
                return fdm.fused_decode_matmul(
                    xs[0], pl.codes[0], pl.literals[0], lut, pl.scale[0],
                    pl.zero[0], **kw)[None]
            return fdm.grouped_fused_decode_matmul(
                xs, pl.codes, pl.literals, lut, pl.scale, pl.zero, **kw)

        y = run(x)
        out[name] = zlib.crc32(y[0 if e == 0 else slice(None)].contiguous()
                               .cpu().numpy().tobytes())
        if rows_alone is not None and 4 < m <= 16:
            rows_alone[name] = all(torch.equal(y[:, i:i + 1],
                                               run(x[:, i:i + 1]))
                                   for i in range(m))
    from repro_torch.kernels import flash_attention as fa
    for name, b, hq, hkv, t, d, dv, qdt in FLASH_CASES:
        rng = np.random.default_rng([SEED, b, hq, t, d, dv])

        def draw(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(device).to(torch.bfloat16)

        q = draw(b, hq, t, d)
        k, v = draw(b, hkv, t + 32, d), draw(b, hkv, t + 32, dv)
        if qdt == "f32":
            q = q.float()
        y = fa.flash_attention(q, k, v)
        out[name] = zlib.crc32(y.contiguous().cpu().float().numpy()
                               .tobytes())
        if flash_err is not None:
            flash_err[name] = float((y.float() - fa.flash_attention_plain(
                q, k, v).float()).abs().max())
    from repro_torch.core.compressed import quantize_linear
    from repro_torch.kernels import dequant_matmul as dqm
    heads = {}
    for name, n, k, m in K5_CASES:
        if n not in heads:
            heads.clear()
            rng = np.random.default_rng([SEED, n, k])
            heads[n] = quantize_linear(torch.from_numpy(
                rng.standard_normal((n, k), dtype=np.float32)).to(device))
        q = heads[n]
        rng = np.random.default_rng([SEED, n, k, m])
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)).to(device).to(torch.bfloat16)
        y = dqm.dequant_matmul(x, q.values, q.scale, q.zero)
        out[name] = zlib.crc32(y.contiguous().cpu().float().numpy()
                               .tobytes())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_bits: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows_alone, flash_err = {}, {}
    crcs = case_outputs(device, rows_alone, flash_err)
    print(json.dumps({"src": args.src, "card": torch.cuda.get_device_name(0),
                      "sms": sms, "crc32": crcs,
                      "rows_equal_alone": rows_alone,
                      "k2_max_abs_err": flash_err}), flush=True)
    if args.check:
        want = EXPECTED.get(sms)
        if want is None:
            print(f"k1_bits: no expected bits for {sms} SMs",
                  file=sys.stderr)
            return 1
        bad = {k: (v, want.get(k)) for k, v in crcs.items()
               if want.get(k) != v}
        if bad:
            print(f"k1_bits: bits changed: {bad}", file=sys.stderr)
            return 1
        far = {name: err for name, err in flash_err.items()
               if dict((c[0], c[7]) for c in FLASH_CASES)[name] == "f32"
               and not err <= F32_ATOL}
        if far:
            print(f"k1_bits: K2 f32 cases past {F32_ATOL}: {far}",
                  file=sys.stderr)
            return 1
        apart = [k for k, same in rows_alone.items() if not same]
        if apart:
            print(f"k1_bits: rows differ from themselves alone: {apart}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
