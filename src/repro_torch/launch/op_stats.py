"""What one planned step holds, computes and moves, read while it runs on
fake tensors.

Counterpart of ``repro/launch/hlo_stats.py``.  The reference compiles a
cell and reads XLA's optimized HLO: ``memory_analysis()``,
``cost_analysis()`` and the collective ops of the program text.  PyTorch
runs eagerly and has no HLO, so the port's dry run (``launch/dryrun.py``)
runs the cell's step once under a ``FakeTensorMode`` and a
:class:`Recording`, which reads the same measures off the ops as they
run:

  * :meth:`Recording.memory_stats`: a ``TorchDispatchMode`` sees every
    storage an op makes (born at its output) and a ``weakref.finalize`` on
    the storage sees it freed at its last reference, so the live bytes
    are known after every op.  ``argument_size_in_bytes`` is what the
    rank holds before the step (its placed parameters or state shards,
    the LUT, its caches, its batch rows: the distinct storages of the
    step's arguments); ``output_size_in_bytes`` the distinct storages of
    its results; ``alias_size_in_bytes`` the results that are arguments
    (caches written in place); ``temp_size_in_bytes`` the peak of what
    the step allocated, less the new results it leaves;
    ``total_hbm_bytes`` the reference's sum, argument + output + temp −
    alias: the arguments plus the step's peak.
  * :meth:`Recording.cost_stats`: ``flops`` and ``bytes accessed``.  The
    aten ops' FLOPs come from ``torch.utils.flop_counter``'s formulas (its
    ``flop_registry``: matmuls, convolutions, attention) and their bytes
    are each op's operands plus its result; a view moves nothing (as
    ``hlo_stats`` leaves out a bitcast), nor does a metadata query or an
    allocation, and an op that writes into an operand in place counts its
    other operands and as many bytes written, at most the operand's size.
    The port's kernels run no aten op under a plan: their FLOPs and bytes
    come from the plan hook (``kernels._build.planning``, each wrapper's
    ``work`` formula), reported by ``"<wrapper>:<kernel>"`` as
    ``{launches, flops, bytes}`` (:meth:`Recording.kernel_stats`).
  * :func:`collective_stats`: a ``launch.mesh.PlannedMesh``'s counts in
    the reference's ``CollectiveStats`` fields (``ops``,
    ``bytes_by_kind``, ``operand_bytes_by_kind``, ``total_bytes``, by HLO
    kind: ``mesh.HLO_KIND``), with ``received_bytes_by_kind``, the bytes
    the rank receives by collective (``Mesh.traffic``'s own measure and
    keys).

Eager ops are not fused, so the bytes are the unfused program's, above
what a compiled one moves; a loop over layers or microbatches is counted
as it runs, so nothing is trip-weighted.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import _build

# allocations: an output that no op writes
_ALLOC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
          torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
          torch.ops.aten.new_empty_strided.default}


def tensors(*trees) -> list:
    """The tensors of nested dicts, lists, tuples and dataclass containers
    (``PackedLinear`` and its kin: their tensor fields)."""
    out = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif hasattr(node, "__dataclass_fields__"):
            for name in node.__dataclass_fields__:
                walk(getattr(node, name))

    for t in trees:
        walk(t)
    return out


def _storages(ts) -> dict:
    """{id of storage: (storage, bytes)} of the distinct storages of
    ``ts``."""
    out = {}
    for t in ts:
        s = t.untyped_storage()
        out.setdefault(id(s), (s, s.nbytes()))
    return out


def tree_bytes(*trees) -> int:
    """Bytes of the distinct storages that the trees' tensors hold: what a
    rank holds of them (a view of another leaf counts once)."""
    return sum(b for _, b in _storages(tensors(*trees)).values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(x, out: list) -> list:
    """The tensors of an op's arguments or results (tensors, and lists
    and tuples of them)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _flat(v, out)
    return out


class _Tracker(TorchDispatchMode):
    """Live bytes of the storages the ops make, and each op's FLOPs and
    bytes."""

    def __init__(self, known: dict):
        super().__init__()
        self.known = set(known)        # argument storages: not the step's
        self.live = self.peak = 0
        self.born: dict = {}           # id -> bytes, while alive
        self.bytes = self.flops = 0

    def _free(self, key: int, nbytes: int) -> None:
        if self.born.pop(key, None) is not None:
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":     # metadata: a tensor's device
            return out
        outs = _flat(out, [])
        for t in outs:
            s = t.untyped_storage()
            key = id(s)
            if key in self.known or key in self.born:
                continue
            n = s.nbytes()
            self.born[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, key, n)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not func.is_view and func not in _ALLOC:
            self.bytes += _op_bytes(func, args, kwargs, outs)
        return out


def _op_bytes(func, args, kwargs, outs) -> int:
    ins, written = [], set()
    for i, a in enumerate(func._schema.arguments):
        v = args[i] if i < len(args) else kwargs.get(a.name)
        n = len(ins)
        _flat(v, ins)
        if a.alias_info is not None and a.alias_info.is_write:
            written.update(id(t) for t in ins[n:])
    read = sum(_nbytes(t) for t in ins if id(t) not in written)
    if written:
        dst = sum(_nbytes(t) for t in ins if id(t) in written)
        return read + min(read, dst)
    if not outs:                       # a query of metadata
        return 0
    return read + sum(_nbytes(t) for t in outs)


class Recording:
    """One planned step: enter it (under the ``FakeTensorMode`` the
    arguments were made in), run the step on ``arguments``, leave it, and
    call :meth:`finish` with the step's results; then read the stats.
    While it is open the kernel wrappers plan their launches
    (``kernels._build.planning``, ``sms`` SMs)."""

    def __init__(self, *arguments, sms: int = _build.PLAN_SMS):
        self.args = _storages(tensors(*arguments))
        self.sms = sms
        self.outputs: dict = {}

    def __enter__(self) -> "Recording":
        self._plan_ctx = _build.planning(self.sms)
        self.plan = self._plan_ctx.__enter__()
        self.tracker = _Tracker(self.args)
        self.tracker.__enter__()
        return self

    def __exit__(self, *exc):
        self.tracker.__exit__(*exc)
        self._plan_ctx.__exit__(*exc)
        return False

    def finish(self, *results) -> None:
        """Record the step's results (their storages are its output)."""
        self.outputs = _storages(tensors(*results))

    def memory_stats(self) -> dict:
        arg = sum(b for _, b in self.args.values())
        out = sum(b for _, b in self.outputs.values())
        alias = sum(b for k, (_, b) in self.outputs.items()
                    if k in self.args)
        temp = max(self.tracker.peak - (out - alias), 0)
        return {"argument_size_in_bytes": arg, "output_size_in_bytes": out,
                "temp_size_in_bytes": temp, "alias_size_in_bytes": alias,
                "total_hbm_bytes": arg + out + temp - alias}

    def kernel_stats(self) -> dict:
        return {k: dict(v) for k, v in sorted(self.plan.kernels.items())}

    def cost_stats(self) -> dict:
        kflops = sum(v["flops"] for v in self.plan.kernels.values())
        kbytes = sum(v["bytes"] for v in self.plan.kernels.values())
        aflops = int(self.tracker.flops)
        return {"flops": float(aflops + kflops),
                "bytes accessed": float(self.tracker.bytes + kbytes),
                "aten_flops": aflops, "aten_bytes": self.tracker.bytes,
                "kernel_flops": kflops, "kernel_bytes": kbytes}


def collective_stats(mesh) -> dict:
    """A ``PlannedMesh``'s collectives in the reference's
    ``CollectiveStats`` fields, with ``received_bytes_by_kind``."""
    return {"ops": dict(mesh.ops), "bytes_by_kind": dict(mesh.result_bytes),
            "operand_bytes_by_kind": dict(mesh.operand_bytes),
            "total_bytes": int(sum(mesh.result_bytes.values())),
            "received_bytes_by_kind": dict(mesh.traffic)}
