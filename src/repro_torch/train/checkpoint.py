"""Checkpointing with atomic commit, per-leaf checksums and a restore that
walks back past a damaged step.

Counterpart of ``repro/train/checkpoint.py``, with its on-disk layout (one
directory per step):

    ckpt_dir/step_00000420/
      manifest.json        # leaf names, shapes, dtypes, CRC32s, step
      shard_00000.npz      # the leaves, as numpy arrays
      COMMIT               # written last: its presence marks validity

A step is written into a temporary directory and renamed into place, so a
writer cut short never leaves a committed step half written;
``latest_step`` skips uncommitted directories.  ``restore`` checks every
leaf's shape, dtype and CRC32 against the manifest and the target tree
before it builds anything, and raises ``CheckpointCorruptError`` naming
the leaf; ``restore_latest`` walks back to the newest step that loads.

Leaves are named by the port's own tree paths (``train.tree``: dict keys
sorted, ``['params']['blocks'][0]['attn']['wq']``), so a checkpoint of the
port holds the port's leaves, a layer at a time.  The state is written
from wherever it lives (``.cpu()``) and restored onto the devices of the
target tree's leaves, or onto ``device``: one device (a restore across
devices waits for the multi-device port, ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from typing import Any

import numpy as np
import torch

from . import tree as T

COMMIT = "COMMIT"


class CheckpointCorruptError(ValueError):
    """A committed checkpoint failed shape/dtype/checksum validation."""


def _leaf_crc(arr: np.ndarray) -> int:
    a = np.ascontiguousarray(arr)
    raw = a.reshape(-1).view(np.uint8) if a.size else np.zeros(0, np.uint8)
    return zlib.crc32(raw) & 0xFFFFFFFF


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree: Any, *, host_id: int = 0,
         extra: dict | None = None) -> str:
    """Write one checkpoint atomically; returns the step directory."""
    step_dir = _step_dir(ckpt_dir, step)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step:08d}_")
    try:
        arrs = {name: leaf.detach().cpu().numpy()
                for name, leaf in T.flatten(tree)}
        np.savez(os.path.join(tmp, f"shard_{host_id:05d}.npz"), **arrs)
        manifest = {
            "step": step,
            "names": list(arrs),
            "shapes": [list(a.shape) for a in arrs.values()],
            "dtypes": [str(a.dtype) for a in arrs.values()],
            "crc32": [_leaf_crc(a) for a in arrs.values()],
            "hosts": 1,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, COMMIT), "w") as f:
            f.write("ok")
        if os.path.isdir(step_dir):
            shutil.rmtree(step_dir)
        os.replace(tmp, step_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return step_dir


def _committed(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_")
                  and os.path.exists(os.path.join(ckpt_dir, d, COMMIT)))


def latest_step(ckpt_dir: str) -> int | None:
    """Newest *committed* step, skipping torn writes."""
    steps = _committed(ckpt_dir)
    return steps[-1] if steps else None


def _load_manifest(step_dir: str) -> dict:
    try:
        with open(os.path.join(step_dir, "manifest.json")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"unreadable manifest in {step_dir}: "
                                     f"{e}") from e


def restore(ckpt_dir: str, step: int, like: Any, *, device=None,
            verify: bool = True) -> Any:
    """Load step ``step`` into the structure of ``like``: every leaf in
    ``like``'s leaf's dtype, on ``device`` or else on that leaf's device.
    ``verify=True`` checks each leaf's shape and dtype against the
    manifest and the target and its CRC32, raising
    ``CheckpointCorruptError`` (naming the leaf) before anything is
    built."""
    step_dir = _step_dir(ckpt_dir, step)
    if not os.path.exists(os.path.join(step_dir, COMMIT)):
        raise FileNotFoundError(f"no committed checkpoint at {step_dir}")
    flat = T.flatten(like)
    manifest = _load_manifest(step_dir)
    m_names = manifest.get("names", [])
    m_shapes = {n: tuple(s) for n, s in zip(m_names,
                                            manifest.get("shapes", []))}
    m_dtypes = dict(zip(m_names, manifest.get("dtypes", [])))
    crcs = dict(zip(m_names, manifest.get("crc32", [])))
    if verify:
        for name, leaf in flat:
            if name not in m_shapes:
                raise CheckpointCorruptError(
                    f"{step_dir}: manifest missing leaf {name}")
            if m_shapes[name] != tuple(leaf.shape):
                raise CheckpointCorruptError(
                    f"{name}: ckpt {m_shapes[name]} vs model "
                    f"{tuple(leaf.shape)}")
    data = {}
    try:
        for fn in sorted(os.listdir(step_dir)):
            if fn.startswith("shard_") and fn.endswith(".npz"):
                with np.load(os.path.join(step_dir, fn)) as z:
                    for k in z.files:
                        data[k] = z[k]
    except Exception as e:   # a truncated or garbled archive
        raise CheckpointCorruptError(
            f"unreadable shard in {step_dir}: {e}") from e
    arrs = []
    for name, leaf in flat:      # validate every leaf, then build
        if name not in data:
            raise CheckpointCorruptError(f"checkpoint missing leaf {name}")
        arr = data[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise CheckpointCorruptError(
                f"{name}: ckpt {arr.shape} vs model {tuple(leaf.shape)}")
        if verify and m_dtypes.get(name, str(arr.dtype)) != str(arr.dtype):
            raise CheckpointCorruptError(
                f"{name}: shard dtype {arr.dtype} vs manifest "
                f"{m_dtypes[name]}")
        if verify and name in crcs and _leaf_crc(arr) != crcs[name]:
            raise CheckpointCorruptError(
                f"{name}: checksum mismatch (bit rot or torn shard)")
        arrs.append(arr)
    return T.unflatten(like, [
        torch.from_numpy(np.array(a)).to(
            device=device if device is not None else leaf.device,
            dtype=leaf.dtype)
        for a, (_, leaf) in zip(arrs, flat)])


def restore_latest(ckpt_dir: str, like: Any, *, on_skip=None):
    """Restore the newest *loadable* committed checkpoint → (state, step).

    Walks committed steps newest → oldest; a step that fails validation
    (unreadable shard, checksum or shape mismatch) is skipped, and
    ``on_skip(step, exc)`` is told.  Raises FileNotFoundError when no
    step loads."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint dir {ckpt_dir}")
    last_exc = None
    for s in reversed(_committed(ckpt_dir)):
        try:
            return restore(ckpt_dir, s, like), s
        except (CheckpointCorruptError, KeyError, OSError) as e:
            last_exc = e
            if on_skip is not None:
                on_skip(s, e)
    raise FileNotFoundError(
        f"no loadable committed checkpoint under {ckpt_dir}"
        + (f" (last error: {last_exc})" if last_exc else ""))


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` committed checkpoints."""
    for s in _committed(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
