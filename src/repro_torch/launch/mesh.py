"""Device meshes over ``torch.distributed`` ranks, and how ranks start.

Counterpart of ``repro/launch/mesh.py``.  A JAX mesh names the devices of
one program; here each device of the mesh is a rank (a process), and a
:class:`Mesh` holds this rank's coordinates and one process group for
every set of its axes (the ranks that differ only along those axes), over
which the collectives below run.  Ranks are numbered row-major over the
mesh's shape, as ``jax.make_mesh`` lays out a host's devices, so a
multi-axis band (``("pod", "model")``) is indexed pod-major, as a
``shard_map`` spec ``P(("pod", "model"))`` splits it.

Backend: NCCL where each rank has a CUDA card of its own; gloo on the CPU
and where ranks share one card (NCCL refuses two ranks on one GPU; gloo
takes CUDA tensors and stages them through the host).  Collectives over
gloo cannot be captured in a CUDA graph, so serving on a mesh runs its
steps eagerly.

Ranks start in one of two ways:
  * :func:`spawn` starts ``n`` processes with ``torch.multiprocessing``,
    joined through a ``FileStore`` in a temporary directory (no TCP port,
    so parallel test workers do not collide), runs a function in each and
    returns every rank's result;
  * :func:`init_from_env` joins the ranks that ``torchrun`` started
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).

``make_production_mesh`` builds the reference's 16×16 and 2×16×16 meshes
only when asked (256 and 512 ranks); :class:`AbstractMesh` is a mesh's
shape and axis names without ranks, which is all the partition rules read
(``sharding.partition``).

Training on a mesh (``train/steps.py``) adds the collectives of a ZeRO
step: ``all_to_all`` (the gradients' reduce-scatter), ``psum_diff``, a sum
whose backward sums the gradient over the same ranks (the MoE's global
statistics), ``pmin``/``pmax`` (exact, in any order), ``agree`` (a flag
OR-ed over the mesh: every control decision of the training loop),
``gather_host`` (a checkpoint's shards to its writer) and ``barrier``.
Each rank counts the bytes it receives by collective in ``Mesh.traffic``
and the wall seconds it spends in each in ``Mesh.seconds``.
"""
from __future__ import annotations

import collections
import itertools
import math
import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

AXIS_POD = "pod"
AXIS_DATA = "data"
AXIS_MODEL = "model"


class AbstractMesh:
    """A mesh's ``shape`` ({axis: size}, in axis order) and ``axis_names``
    without ranks: what the partition rules read."""

    def __init__(self, shape: tuple, axes: tuple):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} for axes {axes}")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


class Mesh(AbstractMesh):
    """This rank's place in a mesh of ``torch.distributed`` ranks.

    ``coords``: {axis: index}; ``groups``: {tuple of axes: the process
    group of the ranks that share this rank's coordinates on every other
    axis}, one for each non-empty set of axes of size > 1."""

    def __init__(self, shape: tuple, axes: tuple, rank: int, groups: dict):
        super().__init__(shape, axes)
        self.rank = rank
        idx = _unravel(rank, tuple(self.shape.values()))
        self.coords = dict(zip(self.axis_names, idx))
        self.groups = groups
        self.traffic: collections.Counter = collections.Counter()
        self.seconds: collections.Counter = collections.Counter()

    def axis_index(self, axes, coords: Optional[dict] = None) -> int:
        """This rank's (or the rank at ``coords``') index along ``axes``
        (one name or a tuple), row-major over them in the mesh's axis
        order."""
        coords = self.coords if coords is None else coords
        idx = 0
        for a in _ordered(self, axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _ordered(self, axes))

    def _start(self, t: torch.Tensor, group) -> float:
        """The clock at a collective's start.  A CUDA tensor that gloo
        stages through the host waits for the work queued before it: that
        wait is taken first, so ``seconds`` holds the collective's own
        time and the wait for its peers.  NCCL's collectives are queued,
        so on it ``seconds`` holds their launch alone."""
        if t.device.type == "cuda" and dist.get_backend(group) != "nccl":
            torch.cuda.synchronize(t.device)
        return time.perf_counter()

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``t`` along ``dim``, in the order of
        the ranks' index along ``axes`` (a no-op over axes of size 1)."""
        axes = tuple(a for a in _ordered(self, axes) if self.shape[a] > 1)
        if not axes:
            return t
        return torch.cat(self._gather(t, axes, "all_gather"), dim=dim)

    def _gather(self, t: torch.Tensor, axes: tuple, what: str) -> list:
        t = t.contiguous()
        n = self.axis_size(axes)
        parts = [torch.empty_like(t) for _ in range(n)]
        t0 = self._start(t, self.groups[axes])
        dist.all_gather(parts, t, group=self.groups[axes])
        self.seconds[what] += time.perf_counter() - t0
        self.traffic[what] += (n - 1) * t.numel() * t.element_size()
        return parts

    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Σ of every rank's ``t`` over ``axes``, in ``t``'s dtype, added
        in the order of the ranks' index: every rank gets the same bits."""
        axes = tuple(a for a in _ordered(self, axes) if self.shape[a] > 1)
        if not axes:
            return t
        parts = self._gather(t, axes, "psum")
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def pmean(self, t: torch.Tensor, axes) -> torch.Tensor:
        n = self.axis_size(tuple(a for a in _ordered(self, axes)))
        return self.psum(t, axes) / n if n > 1 else t

    def psum_diff(self, t: torch.Tensor, axes) -> torch.Tensor:
        """:meth:`psum` under autograd: its backward sums the gradient
        over the same ranks (each rank's loss reads the sum, so the sum's
        gradient is every rank's)."""
        return _PSum.apply(t, self, axes)

    def _reduce(self, t: torch.Tensor, axes, op) -> torch.Tensor:
        axes = tuple(a for a in _ordered(self, axes) if self.shape[a] > 1)
        if not axes:
            return t
        out = t.clone(memory_format=torch.contiguous_format)
        t0 = self._start(out, self.groups[axes])
        dist.all_reduce(out, op=op, group=self.groups[axes])
        self.seconds["all_reduce"] += time.perf_counter() - t0
        self.traffic["all_reduce"] += out.numel() * out.element_size()
        return out

    def pmin(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Elementwise min over ``axes`` (exact: the same bits in any
        order)."""
        return self._reduce(t, axes, dist.ReduceOp.MIN)

    def pmax(self, t: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce(t, axes, dist.ReduceOp.MAX)

    def agree(self, flag: bool) -> bool:
        """``flag`` OR-ed over every rank of the mesh (a collective: every
        rank must call it at the same point)."""
        live = tuple(a for a in self.axis_names if self.shape[a] > 1)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self._flag_device(live))
        return bool(self._reduce(t, live, dist.ReduceOp.MAX).item())

    def all_to_all(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Chunk j of ``t`` (its dim 0 cut into ``axis_size(axes)`` equal
        chunks) goes to the rank of index j along ``axes``: → the chunks
        this rank received, in the senders' index order along dim 0.
        gloo exchanges host tensors, so a CUDA tensor is staged through
        the host (as gloo stages its other collectives)."""
        axes = tuple(a for a in _ordered(self, axes) if self.shape[a] > 1)
        if not axes:
            return t
        group = self.groups[axes]
        staged = (t.device.type == "cuda"
                  and dist.get_backend(group) != "nccl")
        t0 = self._start(t, group)
        x = t.contiguous().cpu() if staged else t.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        out = out.to(t.device) if staged else out
        self.seconds["all_to_all"] += time.perf_counter() - t0
        n = self.axis_size(axes)
        self.traffic["all_to_all"] += (n - 1) * (x.numel() // n) \
            * x.element_size()
        return out

    def gather_host(self, t: torch.Tensor) -> Optional[list]:
        """Every rank's ``t``, copied to the host, to rank 0 of the mesh:
        → the list in rank order on rank 0, None on the others."""
        live = tuple(a for a in self.axis_names if self.shape[a] > 1)
        if not live:
            return [t.detach().cpu().contiguous()]
        t0 = self._start(t, self.groups[live])
        h = t.detach().cpu().contiguous()
        parts = ([torch.empty_like(h) for _ in range(self.size)]
                 if self.rank == 0 else None)
        dist.gather(h, parts, dst=0, group=self.groups[live])
        self.seconds["gather"] += time.perf_counter() - t0
        if parts is not None:
            self.traffic["gather"] += (self.size - 1) * h.numel() \
                * h.element_size()
        return parts

    def barrier(self) -> None:
        live = tuple(a for a in self.axis_names if self.shape[a] > 1)
        if live:
            dist.barrier(group=self.groups[live])

    def _flag_device(self, axes: tuple) -> torch.device:
        """Where a small host-side flag goes: NCCL reduces only CUDA
        tensors, gloo any."""
        if (axes and dist.get_backend(self.groups[axes]) == "nccl"):
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.psum(t, axes)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.psum(grad, ctx.axes), None, None


def _ordered(mesh: AbstractMesh, axes) -> tuple:
    """``axes`` (a name or a tuple) in the mesh's axis order; axes the mesh
    lacks are dropped."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    return tuple(a for a in mesh.axis_names if a in axes)


def _unravel(i: int, shape: tuple) -> tuple:
    out = []
    for s in reversed(shape):
        out.append(i % s)
        i //= s
    return tuple(reversed(out))


def backend_for(device, nranks: int) -> str:
    """NCCL where each of ``nranks`` ranks has a CUDA card of its own,
    else gloo (the CPU, or ranks that share a card)."""
    device = torch.device(device)
    if (device.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= nranks):
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: its own card where there are enough, else
    the cards round-robin (ranks then share), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def make_mesh(shape: tuple, axes: tuple) -> Optional[Mesh]:
    """A mesh of ``shape`` over the first prod(shape) ranks of the running
    ``torch.distributed`` world (the reference's ``make_mesh`` over
    devices).  Every rank of the world must call it, in the same order
    as its other collectives: the process groups are made collectively.
    A rank past the mesh gets ``None``.  A mesh of more ranks than were
    started is refused, with the reference launcher's message.  Without
    a world (no ranks started), a mesh of one device is this process."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    need = math.prod(shape)
    started = dist.get_world_size() if dist.is_initialized() else 1
    if need > started:
        raise ValueError(f"mesh {','.join(map(str, shape))} needs {need} "
                         f"devices, have {started} (start {need} ranks: "
                         "launch.mesh.spawn or torchrun)")
    rank = dist.get_rank() if dist.is_initialized() else 0
    groups = {}
    live = [a for a, s in zip(axes, shape) if s > 1]
    subsets = [tuple(c) for r in range(1, len(live) + 1)
               for c in itertools.combinations(live, r)]
    coords = [_unravel(r, shape) for r in range(need)]
    for sub in subsets:
        keep = [i for i, a in enumerate(axes) if a not in sub]
        classes: dict = {}
        for r, c in enumerate(coords):
            classes.setdefault(tuple(c[i] for i in keep), []).append(r)
        for members in classes.values():
            g = dist.new_group(members) if dist.is_initialized() else None
            if rank in members:
                groups[sub] = g
    if rank >= need:
        return None
    return Mesh(shape, axes, rank, groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks); built
    only when called, from ranks already started."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ((AXIS_POD, AXIS_DATA, AXIS_MODEL) if multi_pod
            else (AXIS_DATA, AXIS_MODEL))
    return make_mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """A mesh of one device, (1, 1) over (data, model)."""
    return make_mesh((1, 1), (AXIS_DATA, AXIS_MODEL))


def data_axes(mesh) -> tuple:
    """Axes that carry the batch (pod extends data across pods)."""
    return tuple(a for a in (AXIS_POD, AXIS_DATA) if a in mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    if name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


# ---------------------------------------------------------------------------
# Starting ranks.
# ---------------------------------------------------------------------------

def _entry(rank: int, fn: Callable, nranks: int, tmp: str, backend: str,
           device: str, args: tuple) -> None:
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:    # ranks on the CPU share its cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nranks))
    store = dist.FileStore(os.path.join(tmp, "store"), nranks)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=nranks)
    try:
        out = fn(rank, *args)
        dist.barrier()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nranks: int, *args, device="cpu") -> list:
    """Run ``fn(rank, *args)`` in ``nranks`` new processes joined into one
    ``torch.distributed`` world (backend from :func:`backend_for`; on
    CUDA each rank takes ``rank_device``), and return the ranks' results
    in rank order.  ``fn`` must be importable by name (a module-level
    function) and its results picklable by ``torch.save``; ``args`` are
    pickled to every rank.  A rank that raises makes this raise once every
    rank has ended."""
    device = str(device)
    tmp = tempfile.mkdtemp(prefix="repro_mesh_")
    try:
        torch.multiprocessing.start_processes(
            _entry, args=(fn, nranks, tmp, backend_for(device, nranks),
                          device, args),
            nprocs=nranks, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nranks)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def init_from_env(device="cpu") -> bool:
    """Join the world that ``torchrun`` started (``RANK``/``WORLD_SIZE``
    and its rendezvous in ``MASTER_ADDR``/``MASTER_PORT``), once; → True
    when this process is such a rank, False without those variables."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(device, world), rank=rank,
                            world_size=world)
    return True


def world_size() -> int:
    """Ranks started: the running world's size, or torchrun's
    ``WORLD_SIZE`` before it is joined, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))

