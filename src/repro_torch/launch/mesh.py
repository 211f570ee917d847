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
(``sharding.partition``).  :class:`PlannedMesh` reaches the production
shapes without ranks: one rank's coordinates on a mesh of any shape whose
collectives return empty tensors of their results' shapes and count what
they would move (the dry run, ``launch/dryrun.py``,
``PlannedMesh.production``).

Training on a mesh (``train/steps.py``) adds the collectives of a ZeRO
step: ``all_to_all`` (the gradients' reduce-scatter), ``psum_diff``, a sum
whose backward sums the gradient over the same ranks (the MoE's global
statistics), the four collectives of tensor-parallel training under
autograd (:func:`gather_on_use` over the data axes, :func:`copy_to_model`,
:func:`reduce_from_model`, :func:`gather_model`), ``pmin``/``pmax``
(exact, in any order), ``agree`` (a flag OR-ed over the mesh: every
control decision of the training loop),
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


# The reference's HLO collective kind of each of ``Mesh.traffic``'s keys
# that a step runs: an all-gather is an ``all-gather``; ``psum`` (a gather
# and a sum in rank order, here) and the ``pmin``/``pmax``/``agree``
# reductions are its ``all-reduce``; ``all_to_all`` (the gradients'
# reduce-scatter) is an ``all-to-all``.
HLO_KIND = {"all_gather": "all-gather", "psum": "all-reduce",
            "all_reduce": "all-reduce", "all_to_all": "all-to-all"}


class PlannedMesh(Mesh):
    """One rank (``rank``, row-major over ``shape``) of a mesh of any shape,
    with no process group and no ``torch.distributed`` world: a dry run's
    mesh (``launch/dryrun.py``).  Its collectives reach no peer: each
    returns empty tensors (fake under a ``FakeTensorMode``) of the real
    result's shape and dtype, counts in ``traffic`` what ``Mesh`` counts
    (the bytes this rank receives: (n − 1)·t for a gather), and counts
    the reference's measures by HLO kind (``HLO_KIND``): ``ops``, the
    result's bytes (``result_bytes``) and the operands' bytes
    (``operand_bytes``), as ``repro/launch/hlo_stats.py`` reads them from
    the compiled program — an all-gather's result n·t and operand t, an
    all-reduce's both t, an all-to-all's both t.  ``agree`` returns its
    own flag: a plan is one rank's view.  ``gather_host`` (a checkpoint's)
    is not planned: it needs the ranks' world."""

    def __init__(self, shape: tuple, axes: tuple, rank: int = 0):
        super().__init__(tuple(int(x) for x in shape), tuple(axes),
                         rank, {})
        self.ops: collections.Counter = collections.Counter()
        self.result_bytes: collections.Counter = collections.Counter()
        self.operand_bytes: collections.Counter = collections.Counter()

    @classmethod
    def production(cls, *, multi_pod: bool = False,
                   rank: int = 0) -> "PlannedMesh":
        """Rank ``rank`` of the 16×16 or 2×16×16 mesh
        (:func:`make_production_mesh`'s shapes)."""
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ((AXIS_POD, AXIS_DATA, AXIS_MODEL) if multi_pod
                else (AXIS_DATA, AXIS_MODEL))
        return cls(shape, axes, rank)

    def _count(self, what: str, received: int, result: int,
               operand: int) -> None:
        kind = HLO_KIND[what]
        self.traffic[what] += received
        self.ops[kind] += 1
        self.result_bytes[kind] += result
        self.operand_bytes[kind] += operand

    def _gather(self, t: torch.Tensor, axes: tuple, what: str) -> list:
        t = t.contiguous()
        n = self.axis_size(axes)
        size = t.numel() * t.element_size()
        self._count(what, (n - 1) * size, n * size if what == "all_gather"
                    else size, size)
        # one buffer of the n parts: the bytes Mesh's n buffers take
        return list(torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                                device=t.device).unbind(0))

    def _reduce(self, t: torch.Tensor, axes, op) -> torch.Tensor:
        axes = tuple(a for a in _ordered(self, axes) if self.shape[a] > 1)
        if not axes:
            return t
        out = torch.empty_like(t, memory_format=torch.contiguous_format)
        size = out.numel() * out.element_size()
        self._count("all_reduce", size, size, size)
        return out

    def agree(self, flag: bool) -> bool:
        live = tuple(a for a in self.axis_names if self.shape[a] > 1)
        self._reduce(torch.zeros(1, dtype=torch.int32), live, None)
        return bool(flag)

    def all_to_all(self, t: torch.Tensor, axes) -> torch.Tensor:
        axes = tuple(a for a in _ordered(self, axes) if self.shape[a] > 1)
        if not axes:
            return t
        n = self.axis_size(axes)
        size = t.numel() * t.element_size()
        self._count("all_to_all", (n - 1) * (t.numel() // n)
                    * t.element_size(), size, size)
        return torch.empty_like(t, memory_format=torch.contiguous_format)

    def barrier(self) -> None:
        return None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.psum(t, axes)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.psum(grad, ctx.axes), None, None


# ---------------------------------------------------------------------------
# Collectives under autograd for tensor-parallel training (``train/steps.py``,
# the training branches of ``models/layers.py``).
#
# The pitfall they avoid: ``Mesh.psum_diff`` sums the gradient over its ranks
# in the backward.  That is right over data ranks, each of which holds a
# share of the loss (the sum's gradient is every rank's).  It is wrong over
# model ranks: they all compute the same loss, so a sum there would count
# the loss ``model`` times.  Over ``model`` a sum in the forward has the
# identity backward (:func:`reduce_from_model`), and a replicated tensor that
# each model rank reads in part has its partial gradients summed in the
# backward (:func:`copy_to_model`).
# ---------------------------------------------------------------------------

class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.psum(t, AXIS_MODEL)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim, reduce):
        ctx.mesh, ctx.axes, ctx.dim, ctx.reduce = mesh, axes, dim, reduce
        ctx.per = t.shape[dim]
        return mesh.all_gather(t, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axes, dim, per = ctx.mesh, ctx.axes, ctx.dim, ctx.per
        if not ctx.reduce:
            i = mesh.axis_index(axes)
            return (grad.narrow(dim, i * per, per).contiguous(), None, None,
                    None, None)
        n = mesh.axis_size(axes)
        send = torch.cat([grad.narrow(dim, j * per, per).reshape(-1)
                          for j in range(n)])
        got = mesh.all_to_all(send, axes).view(n, -1)
        total = got[0]
        for row in got[1:]:
            total = total + row
        shape = list(grad.shape)
        shape[dim] = per
        return total.view(shape), None, None, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.psum(grad, ctx.axes), None, None


def copy_to_model(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The identity, whose backward sums the gradient over ``model`` (rank
    order): the input of a column-parallel product, or any tensor that
    every model rank holds whole and reads in part (its own heads, its own
    experts' gates), so each rank's gradient is a part of the whole."""
    return _SumGrad.apply(t, mesh, AXIS_MODEL)


def reduce_from_model(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ of every model rank's ``t`` (``Mesh.psum``: rank order, the same
    bits on every rank), whose backward is the identity: the output of a
    row-parallel product, each rank's part of a sum that every model rank
    then reads whole."""
    return _ReduceFromModel.apply(t, mesh)


def gather_model(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every model rank's ``t`` concatenated along ``dim``; the backward
    gives the rank its own slice of the gradient, which each model rank
    holds whole (a weight made whole on every rank and used whole)."""
    return _GatherOnUse.apply(t, mesh, AXIS_MODEL, dim, False)


def gather_on_use(t: torch.Tensor, mesh: Mesh, axes, dim: Optional[int],
                  reduce: bool = True) -> torch.Tensor:
    """A leaf's ZeRO-3 shard all-gathered over the data ``axes`` along
    ``dim`` (never over ``model``).  The backward reduce-scatters its
    gradient into the shard: each data rank's gradient of the whole leaf,
    cut to every peer's shard (``all_to_all``) and added in the peers'
    rank order, the bits of a sum of the whole gradients in rank order cut
    to the shard.  ``dim=None`` (a leaf its spec does not split over the
    data axes): the identity, whose backward sums the gradient over them
    in rank order.  ``reduce=False`` (every data rank computed the same
    rows, so its gradient is already the whole one) cuts the shard
    alone."""
    axes = tuple(a for a in _ordered(mesh, axes) if mesh.shape[a] > 1)
    if not axes or (dim is None and not reduce):
        return t
    if dim is None:
        return _SumGrad.apply(t, mesh, axes)
    return _GatherOnUse.apply(t, mesh, axes, dim, reduce)


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
    only when called, from ranks already started.  To plan one rank of
    these meshes without starting any: ``PlannedMesh.production``."""
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

