"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/lib<name>-<hash>.so`` beside this file (listed in ``.gitignore``),
with a plain C entry point loaded through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

The hash covers the source, every header in ``csrc/`` and the flags, so an
edited kernel rebuilds on its next use.  Nothing builds at import: the
first launch on a CUDA tensor builds what it needs, and :func:`build`
starts one nvcc per source, all at once, for callers that want every
kernel up front.  ``ptxas``' report (registers, shared memory, spills) is
kept beside each library as ``.log``.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fused_decode_matmul", "dequant_matmul", "flash_attention",
           "dict_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# Launches of each kernel, by kernel name (K3 grouped_fused_decode_matmul
# shares fused_decode_matmul's source).  Every wrapper adds one where it
# launches its kernel and nowhere else; callers clear it to count a run.
# A launch captured in the decode graph counts at each replay of the graph
# (``serve.engine.DecodeGraph`` takes back what the capture added).
LAUNCH_COUNTS: collections.Counter = collections.Counter()
# The same launches of the wrappers that choose among kernels (K1, K3 and
# K5), by "<name>:<kernel>", the kernel their plan picked ("decode",
# "mma", "simt"): which of a wrapper's kernels a run went through.
KERNEL_COUNTS: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple, object] = {}
_SMS: dict[int, int] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in " + str(CSRC))


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names=SOURCES) -> dict:
    """Compile every missing library of ``names``, one nvcc each, all
    started together.  Returns {name: seconds spent building} (0.0 when
    the library was already there).  Raises with nvcc's output on
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               str(CSRC / f"{name}.cu")]
        with open(out.with_suffix(".log"), "w") as log:
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                           tmp, out, time.perf_counter())
    failed = []
    while procs:              # each source's own seconds, as it finishes
        for name in [n for n, p in procs.items() if p[0].poll() is not None]:
            proc, tmp, out, t0 = procs.pop(name)
            seconds[name] = time.perf_counter() - t0
            if proc.returncode:
                os.unlink(tmp)
                failed.append(f"nvcc failed for {name}.cu:\n"
                              + out.with_suffix(".log").read_text())
            else:
                os.replace(tmp, out)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def ptxas_report(name: str) -> str:
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``lib<name>``, built and bound on
    first use (later calls are a dict lookup: wrappers call this on every
    launch)."""
    fn = _FUNCS.get((name, symbol))
    if fn is not None:
        return fn
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once per device)."""
    n = _SMS.get(device.index)
    if n is None:
        import torch
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def check(err: int, name: str):
    """Raise ``torch.AcceleratorError`` on a non-zero CUDA error code
    returned by a launch: the device fault that the resilience ladder and
    the scheduler's quarantine catch (a bare ``RuntimeError``, which a
    shape bug also raises, they do not)."""
    if err:
        import torch
        raise torch.AcceleratorError(f"{name}: CUDA launch failed with error "
                                     f"{err} (cudaError_t)")


def cuda_args(*tensors):
    """Raise unless every tensor is on one CUDA device; return it."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}: a kernel "
                             "takes all its inputs on one CUDA device")
    return dev
