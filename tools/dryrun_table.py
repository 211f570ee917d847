"""The dry run's records as one markdown table, a row per (arch, shape).

    PYTHONPATH=src python tools/dryrun_table.py results/dryrun_torch \
        [more record directories ...]
    PYTHONPATH=src python tools/dryrun_table.py --before OLD_DIR NEW_DIR

``--before OLD_DIR``: OLD_DIR's records (another tree's sweep) beside
the given ones, a row per cell.  The ``train_4k`` cells first: on each
mesh the planned argument / temp / total GB a rank and the all-gathered
GB a step, before → after, and whether the after fits the planned card.
Then the serve cells (prefill, decode, ``long_500k``): on each mesh the
planned argument / temp / total GB a rank, before → after; the rank's
caches in GB beside its share under the reference's
``make_cache_specs`` (and the Mamba2 state the port keeps whole on
model, GB); the all-gathered GB a step on 16×16, before → after.

Reads every ``<arch>__<shape>__<mesh>__<mode>.json`` that
``python -m repro_torch.launch.dryrun`` wrote (a cell found in two
directories: an ok record wins) and prints, for each arch and shape: its
status on the two meshes (ok, the reference's skip, or the error's type);
on the 16×16 mesh the planned bytes one rank holds (arguments), its
step's temporaries and their total in GB and the total's multiple of the
planned card's memory, the collectives' result bytes a step by the
reference's HLO kind in GB, and the kernel with the most planned bytes
(GB, launches); on the 2×16×16 mesh the total; and on both the bytes a
device holds of the same trees under the reference's shardings.  Every
number is the plan's, for the card each record names: nothing here was
measured.
"""
import glob
import json
import os
import sys

GB = 1e9
KINDS = ("all-gather", "all-reduce", "all-to-all")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load(dirs) -> dict:
    cells = {}
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "*__*__*__*.json"))):
            with open(path) as f:
                rec = json.load(f)
            key = (rec["arch"], rec["shape"], rec["mesh"])
            if rec.get("ok") or key not in cells:
                cells[key] = rec
    return cells


def status(rec) -> str:
    if rec is None:
        return "not run"
    if "skipped" in rec:
        return "skipped"
    if rec.get("ok"):
        return "ok"
    return rec.get("error", "?").split(":")[0]


def planned(rec) -> bool:
    return rec is not None and rec.get("ok") and "skipped" not in rec


def row(arch, shape, one, two) -> str:
    st = status(one) if status(one) == status(two) else \
        f"{status(one)} / {status(two)}"
    cells = [f"{arch} {shape}", st]
    if planned(one):
        mem, col = one["memory"], one["collectives"]["bytes_by_kind"]
        top = max(one["kernels"].items(), key=lambda kv: kv[1]["bytes"],
                  default=None)
        cells += [f"{mem['argument_size_in_bytes'] / GB:.2f} / "
                  f"{mem['temp_size_in_bytes'] / GB:.2f} / "
                  f"{mem['total_hbm_bytes'] / GB:.2f} "
                  f"({mem['total_hbm_bytes'] / one['planned']['hbm_bytes']:.2f}×)",
                  " / ".join(f"{col.get(k, 0) / GB:.3g}" for k in KINDS),
                  (f"{top[0]} {top[1]['bytes'] / GB:.3g} "
                   f"({top[1]['launches']})" if top else "none")]
    else:
        cells += ["", "", ""]
    cells.append(f"{two['memory']['total_hbm_bytes'] / GB:.2f}"
                 if planned(two) else "")
    cells.append(" / ".join(
        f"{r['reference_specs_argument_bytes'] / GB:.2f}"
        if planned(r) else "–" for r in (one, two)))
    return "| " + " | ".join(cells) + " |"


def _mem(rec) -> str:
    if not planned(rec):
        return status(rec)
    mem = rec["memory"]
    return (f"{mem['argument_size_in_bytes'] / GB:.2f} / "
            f"{mem['temp_size_in_bytes'] / GB:.2f} / "
            f"{mem['total_hbm_bytes'] / GB:.2f}")


def _caches(rec) -> str:
    if not planned(rec) or "cache_bytes" not in rec:
        return "–"
    extra = sum(rec.get("cache_whole_on_model", {}).values())
    out = (f"{rec['cache_bytes'] / GB:.3g} / "
           f"{rec['reference_cache_bytes'] / GB:.3g}")
    return out + (f" (+{extra / GB:.3g} SSM)" if extra else "")


def _gathered(rec) -> str:
    if not planned(rec):
        return "–"
    got = rec["collectives"]["bytes_by_kind"].get("all-gather", 0)
    return f"{got / GB:.3g}"


def _fits(rec) -> str:
    if not planned(rec):
        return "–"
    mem = rec["memory"]["total_hbm_bytes"]
    return "yes" if mem <= rec["planned"]["hbm_bytes"] else "no"


def compare_train(old, new):
    """The train cells of two sweeps: on each mesh the planned argument /
    temp / total GB a rank and the all-gathered GB a step, before →
    after, and whether the after fits the planned card."""
    keys = sorted({(k[0], k[1]) for k in new if k[1] == "train_4k"})
    if not keys:
        return
    print("| cell | 16×16 GB a rank: argument / temp / total, before → after"
          " | 2×16×16, before → after | all-gathered GB a step, 16×16; "
          "2×16×16, before → after | fits 80 GB after: 16×16 / 2×16×16 |")
    print("|" + "---|" * 5)
    for arch, shape in keys:
        o1, o2 = (old.get((arch, shape, m)) for m in ("single", "multi"))
        n1, n2 = (new.get((arch, shape, m)) for m in ("single", "multi"))
        print(f"| {arch} {shape} | {_mem(o1)} → {_mem(n1)} | "
              f"{_mem(o2)} → {_mem(n2)} | {_gathered(o1)} → "
              f"{_gathered(n1)}; {_gathered(o2)} → {_gathered(n2)} | "
              f"{_fits(n1)} / {_fits(n2)} |")
    print()


def compare(before_dir, dirs):
    old, new = load([before_dir]), load(dirs)
    compare_train(old, new)
    if not any(k[1] != "train_4k" for k in new):
        return
    print("| cell | 16×16 GB a rank: argument / temp / total, before → after"
          " | 2×16×16, before → after | caches GB a rank / the reference's"
          " share: 16×16; 2×16×16 | 16×16 all-gathered GB a step, before "
          "→ after |")
    print("|" + "---|" * 5)
    for arch in sorted({k[0] for k in new}):
        for shape in SHAPES[1:]:
            keys = [(arch, shape, m) for m in ("single", "multi")]
            if not any(planned(new.get(k)) for k in keys):
                continue
            o1, o2 = (old.get(k) for k in keys)
            n1, n2 = (new.get(k) for k in keys)
            print(f"| {arch} {shape} | {_mem(o1)} → {_mem(n1)} | "
                  f"{_mem(o2)} → {_mem(n2)} | {_caches(n1)}; {_caches(n2)} "
                  f"| {_gathered(o1)} → {_gathered(n1)} |")


def main(argv):
    if argv[:1] == ["--before"]:
        return compare(argv[1], argv[2:])
    cells = load(argv or ["results/dryrun_torch"])
    print("| cell | status | 16×16 GB a rank: argument / temp / total "
          "(÷ 80 GB) | 16×16 collective GB a step: all-gather / all-reduce"
          " / all-to-all | 16×16 largest kernel: planned GB (launches) | "
          "2×16×16 total GB | reference specs' argument GB a device: "
          "16×16 / 2×16×16 |")
    print("|" + "---|" * 7)
    for arch in sorted({k[0] for k in cells}):
        for shape in SHAPES:
            one = cells.get((arch, shape, "single"))
            two = cells.get((arch, shape, "multi"))
            if one is None and two is None:
                continue
            print(row(arch, shape, one, two))


if __name__ == "__main__":
    main(sys.argv[1:])
