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
target tree's leaves, or onto ``device``.

On a mesh of ranks (``specs``/``shardings`` and ``mesh``: each rank holds
its shards, ``sharding.partition``) ``save`` gathers each leaf whole on
rank 0, which writes it in the same layout and manifest (``"hosts": 1``,
as the reference writes), then every rank passes a barrier: a checkpoint
of one state is byte-equal whoever wrote it, and restores anywhere.
``restore`` reads whole leaves, checks each against the manifest (whole
shape, dtype, CRC32) and keeps this rank's shard under the target's
specs; the ranks agree on the outcome, so a damaged leaf raises
``CheckpointCorruptError`` on every rank.
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

from ..sharding import partition as PT
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
         extra: dict | None = None, specs: Any = None, mesh=None) -> str:
    """Write one checkpoint atomically; returns the step directory.  On
    ``mesh`` (``tree`` this rank's shards under ``specs``) every rank
    sends its shards to rank 0 (``Mesh.gather_host``), which assembles
    each leaf whole and writes, and all pass a barrier after the
    commit."""
    step_dir = _step_dir(ckpt_dir, step)
    sharded = mesh is not None and mesh.size > 1
    if sharded:
        flat = T.flatten(tree)
        arrs = {}
        for (name, leaf), spec in zip(flat, PT.flat_specs(specs, tree)):
            parts = mesh.gather_host(leaf)
            if parts is not None:
                arrs[name] = PT.assemble(parts, spec, mesh).numpy()
        if mesh.rank == 0:
            _write(ckpt_dir, step, arrs, host_id, extra)
        mesh.barrier()
        return step_dir
    _write(ckpt_dir, step, {name: leaf.detach().cpu().numpy()
                            for name, leaf in T.flatten(tree)},
           host_id, extra)
    return step_dir


def _write(ckpt_dir: str, step: int, arrs: dict, host_id: int,
           extra: dict | None) -> None:
    step_dir = _step_dir(ckpt_dir, step)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step:08d}_")
    try:
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
            verify: bool = True, shardings: Any = None, mesh=None) -> Any:
    """Load step ``step`` into the structure of ``like``: every leaf in
    ``like``'s leaf's dtype, on ``device`` or else on that leaf's device.
    ``verify=True`` checks each leaf's shape and dtype against the
    manifest and the target and its CRC32, raising
    ``CheckpointCorruptError`` (naming the leaf) before anything is
    built.  On ``mesh`` ``like`` holds this rank's shards under
    ``shardings`` (a spec tree): each whole leaf is checked, then cut to
    the rank's shard; every rank raises if any rank's check failed."""
    sharded = mesh is not None and mesh.size > 1
    specs = PT.flat_specs(shardings, like) if sharded else None
    flat = T.flatten(like)
    try:
        arrs = _read_checked(ckpt_dir, step, [
            (name, PT.whole_shape(leaf.shape, specs[i], mesh) if sharded
             else tuple(leaf.shape)) for i, (name, leaf) in enumerate(flat)],
            verify)
        failed = None
    except (CheckpointCorruptError, KeyError, OSError) as e:
        failed = e
    if sharded and mesh.agree(failed is not None) and failed is None:
        failed = CheckpointCorruptError(
            f"step {step} under {ckpt_dir}: another rank's restore failed")
    if failed is not None:
        raise failed
    out = []
    for i, (arr, (_, leaf)) in enumerate(zip(arrs, flat)):
        t = torch.from_numpy(np.array(arr))
        if sharded:
            t = PT.shard_leaf(t, specs[i], mesh)
        out.append(t.to(device=device if device is not None else leaf.device,
                        dtype=leaf.dtype))
    return T.unflatten(like, out)


def _read_checked(ckpt_dir: str, step: int, want: list, verify: bool):
    """The arrays of ``want`` ([(leaf name, whole shape)]) from step
    ``step``, each checked against the manifest and ``want``."""
    step_dir = _step_dir(ckpt_dir, step)
    if not os.path.exists(os.path.join(step_dir, COMMIT)):
        raise FileNotFoundError(f"no committed checkpoint at {step_dir}")
    manifest = _load_manifest(step_dir)
    m_names = manifest.get("names", [])
    m_shapes = {n: tuple(s) for n, s in zip(m_names,
                                            manifest.get("shapes", []))}
    m_dtypes = dict(zip(m_names, manifest.get("dtypes", [])))
    crcs = dict(zip(m_names, manifest.get("crc32", [])))
    if verify:
        for name, shape in want:
            if name not in m_shapes:
                raise CheckpointCorruptError(
                    f"{step_dir}: manifest missing leaf {name}")
            if m_shapes[name] != shape:
                raise CheckpointCorruptError(
                    f"{name}: ckpt {m_shapes[name]} vs model {shape}")
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
    for name, shape in want:      # validate every leaf, then build
        if name not in data:
            raise CheckpointCorruptError(f"checkpoint missing leaf {name}")
        arr = data[name]
        if tuple(arr.shape) != shape:
            raise CheckpointCorruptError(
                f"{name}: ckpt {arr.shape} vs model {shape}")
        if verify and m_dtypes.get(name, str(arr.dtype)) != str(arr.dtype):
            raise CheckpointCorruptError(
                f"{name}: shard dtype {arr.dtype} vs manifest "
                f"{m_dtypes[name]}")
        if verify and name in crcs and _leaf_crc(arr) != crcs[name]:
            raise CheckpointCorruptError(
                f"{name}: checksum mismatch (bit rot or torn shard)")
        arrs.append(arr)
    return arrs


def restore_latest(ckpt_dir: str, like: Any, *, on_skip=None,
                   shardings: Any = None, mesh=None):
    """Restore the newest *loadable* committed checkpoint → (state, step).

    Walks committed steps newest → oldest; a step that fails validation
    (unreadable shard, checksum or shape mismatch) is skipped, and
    ``on_skip(step, exc)`` is told.  Raises FileNotFoundError when no
    step loads.  ``shardings``/``mesh``: as :func:`restore` (its ranks
    agree, so they skip the same steps)."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint dir {ckpt_dir}")
    last_exc = None
    for s in reversed(_committed(ckpt_dir)):
        try:
            return restore(ckpt_dir, s, like, shardings=shardings,
                           mesh=mesh), s
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
