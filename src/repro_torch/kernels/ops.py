"""Public kernel entry points of the port — what the model layers call.

Counterpart of ``repro/kernels/ops.py`` (single device).  Dispatch follows
the tensors' device: a CUDA tensor launches the hand-written kernel (or the
wrapper raises), a CPU tensor takes the kernel's plain PyTorch version.

The compressed-weight matmuls also follow the dispatch lever, the
reference's degradation rungs (:class:`Impl`): ``auto`` runs the fused
kernels (K1, K3); ``unfused`` decodes the dense uint8 weight with K4 and
multiplies with K5 (grouped: K4, then a dense einsum); ``materialize``
decodes with the plain codec and multiplies with one dense
``torch.matmul``, so no port kernel runs for that weight.  The
materialize rung is the one place where plain code runs on CUDA tensors.
It is reached only through the resilience ladder
(``serve/resilience.py::ResilientEngine``), the only code that sets the
lever, and every call on it is counted (``DISPATCH_COUNTS``, and the
ladder's ``FALLBACK_COUNTS`` and ``health()``); ``chip_smoke.py`` holds
the lever unset and no fallback counted on every phase but its
resilience phase.  No wrapper catches a kernel's error and falls back to
a plain version.  Linear-layout planes (``tile_n == 0``), which the fused
kernels cannot read, take the unfused path at any lever.  A
``TiledPackedLinear`` (column groups) takes the same rungs in
:func:`decode_dequant_matmul`, K1 reading its G groups in one launch.

``DISPATCH_COUNTS`` counts which path each compressed matmul took (the
reference's probe); ``_build.LAUNCH_COUNTS`` counts kernel launches.  In
a captured step both count at each replay (``serve.engine.capture_step``).

On a mesh (``sharding.partition.active_mesh``, more than one rank) the
containers are each rank's share (``partition.place_params``) and the
wrappers take the reference's ``shard_map`` branches, with its placement
gates and probes: a ``PackedLinear``'s out-tile band on the (pod, model)
ranks runs K1 ('fused_shard_map'), a ``TiledPackedLinear``'s groups on
data and band on model run K1 with the f32 sum over data after it
('tiled_fused_shard_map'; rows split over data are gathered first, as
the reference reshards x's columns onto data), an expert stack's E/model
experts run K3 ('grouped_fused_shard_map'), and an int8 weight's band
runs K5 ('dequant_shard_map': a stored vocab band of the embedding or
head, ``partition.place_vocab``, or a band of a replicated weight taken
at each call).  Each launch is planned for the whole weight (its N, and
K3's E), so a column's products are summed in the order the one-device
launch sums them and a column-parallel output is bitwise the one-device
output.  ``gather=True`` (the default) all-gathers the outputs;
``gather=False`` leaves the rank's ``model`` band of the columns on it
(the reference's ``out_specs``), which the layers keep until the
row-parallel weight after them (``models/layers.py``).  The fused
branch's second gate, m ≤ max(N, 512) rows (``repro/kernels/ops.py:109``,
``:266-282``), is not applied (``ROADMAP.md`` queue 3, "Not port
faults"): it would send a prefill's rows of a narrow weight (Llama-3.2-1B's
k/v, N = 512, at M = 700) to the two-step path, whose K5 sums in another
order than one device's K1 (on the card the tokens then part from one
device's).  A container that the placement gates leave whole takes the
one-device two-step path on every rank, as the reference falls back.
"""
from __future__ import annotations

import collections
import enum

import torch

from .dequant_matmul import dequant_matmul as _dequant_matmul
from .dict_decode import dict_decode  # noqa: F401  (public entry point)
from .flash_attention import FlashAttentionFn
from .fused_decode_matmul import fused_decode_matmul as _fused
from .fused_decode_matmul import grouped_fused_decode_matmul as _grouped

DISPATCH_COUNTS = collections.Counter()


class Impl(str, enum.Enum):
    """The one home of the dispatch lever's values.

    ``AUTO``: the fused kernels.  ``UNFUSED``: the two-step decode →
    matmul path.  ``MATERIALIZE``: the plain decode and a dense product,
    no port kernel for the weight (the ladder's last functional rung).
    The reference's backend selectors (``ref``, ``pallas``,
    ``pallas_interpret``) have no counterpart: here the tensor's device
    chooses between a kernel and its plain version."""
    AUTO = "auto"
    UNFUSED = "unfused"
    MATERIALIZE = "materialize"

    __str__ = str.__str__


VALID_IMPLS = frozenset(i.value for i in Impl)

# the probe each rung counts under, on one device and on a rank's share
# (the fallback rungs keep their names)
_RUNG_PROBE = {Impl.AUTO.value: "fused"}
_SHARD_PROBE = {Impl.AUTO.value: "fused_shard_map"}

# The ladder's rungs.  'fused' is not an impl: it serves with the lever
# unset ('auto'); the fallback rungs pin it.
FUSED_RUNG = "fused"
DEFAULT_LADDER = (FUSED_RUNG, Impl.UNFUSED.value, Impl.MATERIALIZE.value)

_DEFAULT_IMPL = Impl.AUTO.value


def set_default_impl(impl) -> None:
    """Set the rung the compressed-weight matmuls take (the resilience
    ladder's lever).  It is read in Python, so a captured step keeps the
    rung it was captured under."""
    global _DEFAULT_IMPL
    _DEFAULT_IMPL = Impl(impl).value


def plain_decode() -> bool:
    """Whether a dense decode of a compressed weight must skip the port's
    kernels (the lever pins 'materialize'): read by the layers' absorb."""
    return _DEFAULT_IMPL == Impl.MATERIALIZE.value


def dequant_matmul(x, wq, scale, zero, *, out_dtype=torch.float32,
                   decode: bool = False, gather: bool = True,
                   mesh_axes=None):
    """y = x @ dequant(wq).T.  x: (..., K); wq: (N, K) uint8; scale/zero:
    (N, 1).  Leading dims of x flatten to M.  ``decode``: the M rows are a
    decode step's, one token a request (the kernels' plans keep each such
    row's bits what they are alone, at any M).

    On a mesh: ``mesh_axes`` names the axes a stored band's rows were
    split over (a placed embedding or head, ``partition.place_vocab``):
    K5 runs on the band, planned for the whole N.  Otherwise a weight
    whose rows split over the (pod, model) ranks runs K5 on the rank's
    band of it, a view taken at each call.  ``gather=False`` returns the
    rank's ``model`` band of the output columns (:func:`_band_out`)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if mesh_axes is not None:
        mesh = _mesh()
        if mesh is None:
            raise ValueError("dequant_matmul: a mesh rank's band of a "
                             "weight needs its mesh active "
                             "(sharding.partition.active_mesh)")
        n = wq.shape[0] * mesh.axis_size(mesh_axes)
        DISPATCH_COUNTS["dequant_shard_map"] += 1
        y = _band_out(_dequant_matmul(
            x2, wq, scale, zero, out_dtype=out_dtype, decode=decode,
            plan_n=n), mesh, tuple(mesh_axes), gather)
        return y.reshape(*lead, y.shape[-1])
    mesh, waxes, wsize = _weight_axes()
    n = wq.shape[0]
    if wsize > 1 and wq.ndim == 2 and n % wsize == 0:
        DISPATCH_COUNTS["dequant_shard_map"] += 1
        band = _band_rows(n, mesh, waxes, wsize)
        y = _band_out(_dequant_matmul(
            x2, wq[band], scale[band], zero[band], out_dtype=out_dtype,
            decode=decode, plan_n=n), mesh, waxes, gather)
    else:
        y = _dequant_matmul(x2, wq, scale, zero, out_dtype=out_dtype,
                            decode=decode)
        if not gather and mesh is not None:
            y = _model_cols(y, mesh)
    return y.reshape(*lead, y.shape[-1])


def _model_cols(y, mesh):
    """The rank's ``model`` band of the whole output's columns."""
    ms = mesh.shape.get("model", 1)
    if ms <= 1:
        return y
    per = y.shape[-1] // ms
    m = mesh.axis_index("model")
    return y[..., m * per:(m + 1) * per]


def _band_out(y, mesh, axes: tuple, gather: bool):
    """A product over the rank's out band along ``axes``: every rank's
    band gathered whole (``gather``), or the rank's ``model`` band of
    the columns, which is its own band where ``axes`` are the model axis
    alone.  A band over (pod, model) is pod-major, so a model band is
    not a union of pod bands: it is cut from the gathered whole."""
    if gather:
        return mesh.all_gather(y, axes, dim=-1)
    if all(mesh.shape[a] <= 1 for a in axes if a != "model"):
        return y
    return _model_cols(mesh.all_gather(y, axes, dim=-1), mesh)


def _mesh():
    """The active mesh of more than one rank, or None."""
    from ..sharding.partition import current_mesh
    _, mesh = current_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


def _weight_axes():
    """(mesh, weight axes, their size): the reference's ``waxes``, the
    (pod, model) axes of size > 1 over which a weight's out-tile bands
    split; (None, (), 1) without a mesh."""
    mesh = _mesh()
    if mesh is None:
        return None, (), 1
    from ..sharding.partition import weight_axes
    waxes = weight_axes(mesh)
    return mesh, waxes, mesh.axis_size(waxes)


def _band_rows(n: int, mesh, axes, size: int) -> slice:
    """This rank's rows of ``n`` split in ``size`` bands along ``axes``."""
    i, per = mesh.axis_index(axes), n // size
    return slice(i * per, (i + 1) * per)


def decode_dequant_matmul(x, packed, lut, *, out_dtype=torch.bfloat16,
                          decode: bool = False, gather: bool = True):
    """Compressed-weight matmul, the paper's serving hot path, over one
    layer's planes: a ``PackedLinear`` (codes (nb, slots)) or a
    ``TiledPackedLinear`` (codes (G, nb, slots), probes prefixed 'tiled_',
    the one-device branch of the reference's
    ``ops.tiled_decode_dequant_matmul``).

    Tile-major planes with the lever at ``auto``: the fused
    decode→dequant→matmul kernel, over all G column groups in one launch,
    one accumulator and one affine epilogue (probe 'fused').  ``unfused``
    or linear-layout planes: K4 decodes the dense uint8 weight, which K5
    multiplies (probe 'unfused'; the reference's tiled rung decodes with
    plain code and an einsum, which gives the same uint8 weight).
    ``materialize``: the plain decode, the weight dequantized to f32 and
    one f32 ``torch.matmul`` (probe 'materialize'; the reference
    multiplies in x's dtype, which at bf16 rounds every weight and moves
    greedy tokens away from the fused rung's).  ``decode``: as in
    :func:`dequant_matmul`, for the fused and unfused rungs.  On a mesh,
    ``gather=False`` returns the rank's ``model`` band of the output
    columns (column-parallel, the reference's ``out_specs``) instead of
    the whole output."""
    probe = packed.PROBE
    if packed.codes.ndim != 2 + packed.GROUP_AXES:
        raise ValueError(f"{probe}decode_dequant_matmul takes one layer's "
                         f"planes, got codes {tuple(packed.codes.shape)}")
    mesh = _mesh()
    if mesh is not None and packed.mesh_axes is not None:
        return _sharded_matmul(x, packed, lut, mesh, out_dtype=out_dtype,
                               decode=decode, gather=gather)
    if packed.mesh_axes is not None:
        raise ValueError(f"{probe}decode_dequant_matmul: a mesh rank's "
                         "share of a weight needs its mesh active "
                         "(sharding.partition.active_mesh)")
    impl = _DEFAULT_IMPL
    if mesh is not None:
        from ..sharding.partition import placement_ok
        if placement_ok(packed, mesh):
            raise ValueError(f"{probe}decode_dequant_matmul on a mesh "
                             "needs the rank's share of the weight "
                             "(sharding.partition.place_params)")
        # the gates keep this weight whole: the one-device two-step path
        # on every rank, as the reference falls back
        if impl == Impl.AUTO.value:
            impl = Impl.UNFUSED.value
    if impl == Impl.AUTO.value and not packed.tile_n:
        impl = Impl.UNFUSED.value
    DISPATCH_COUNTS[probe + _RUNG_PROBE.get(impl, impl)] += 1
    n, k = packed.shape
    lead = x.shape[:-1]
    y = _local_matmul(x.reshape(-1, k), packed, lut, impl,
                      out_dtype=out_dtype, decode=decode, plan_n=n)
    if not gather and mesh is not None:
        y = _model_cols(y, mesh)
    return y.reshape(*lead, y.shape[-1])


# the reference's name for the TiledPackedLinear branch
tiled_decode_dequant_matmul = decode_dequant_matmul


def _local_matmul(x2, packed, lut, impl: str, *, out_dtype, decode: bool,
                  plan_n: int) -> torch.Tensor:
    """One rank's product x2 (M, K_loc) over its planes on the rung
    ``impl``, planned for the whole weight's ``plan_n`` columns."""
    if impl == Impl.MATERIALIZE.value:
        w = packed.materialize(lut, dtype=torch.float32, plain=True)
        return torch.matmul(x2.to(torch.float32), w.T).to(out_dtype)
    if impl == Impl.UNFUSED.value:
        return _dequant_matmul(x2, packed.materialize_int8(lut),
                               packed.scale, packed.zero,
                               out_dtype=out_dtype, decode=decode,
                               plan_n=plan_n)
    return _fused(x2, packed.codes, packed.literals, lut, packed.scale,
                  packed.zero, shape=tuple(packed.shape),
                  tile_n=packed.tile_n, tile_k=packed.tile_k,
                  out_dtype=out_dtype, decode=decode, plan_n=plan_n)


def _sharded_matmul(x, packed, lut, mesh, *, out_dtype, decode: bool,
                    gather: bool = True):
    """``decode_dequant_matmul`` over a mesh rank's share of a weight (the
    reference's ``_fused_decode_matmul_sharded`` and
    ``_tiled_fused_sharded``): see the module's note.  ``gather=False``:
    the rank's model band of the columns, left on the rank."""
    lead, kdim = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, kdim)
    impl = _DEFAULT_IMPL
    if packed.GROUP_AXES:
        return _tiled_sharded(x2, packed, lut, mesh, impl,
                              out_dtype=out_dtype, decode=decode,
                              gather=gather).reshape(*lead, -1)
    waxes = tuple(packed.mesh_axes)
    n = packed.shape[0] * mesh.axis_size(waxes)
    DISPATCH_COUNTS[packed.PROBE + _SHARD_PROBE.get(impl, impl)] += 1
    y = _local_matmul(x2, packed, lut, impl, out_dtype=out_dtype,
                      decode=decode, plan_n=n)
    return _band_out(y, mesh, waxes, gather).reshape(*lead, -1)


def _tiled_sharded(x2, packed, lut, mesh, impl: str, *, out_dtype,
                   decode: bool, gather: bool = True):
    """A TiledPackedLinear on a mesh: this rank's column groups (on data)
    and out band (on model) in one launch over its x columns, the f32
    partial sums added over data (the reference's row-parallel ``psum``),
    the cast, then the columns gathered over model (``gather``) or left
    on the rank."""
    n_loc, k_loc = packed.shape
    msize = mesh.axis_size("model") if "model" in packed.mesh_axes else 1
    dsize = mesh.axis_size("data") if "data" in packed.mesh_axes else 1
    DISPATCH_COUNTS["tiled_" + _SHARD_PROBE.get(impl, impl)] += 1
    d = mesh.axis_index("data") if dsize > 1 else 0
    # x's columns go on data, so its rows must not be: rows split over
    # data (a served batch's, partition.rows_split) are gathered first,
    # as the reference reshards x to P(pod, data), and cut back after
    from ..sharding.partition import row_split
    split = row_split()
    rows = (dsize > 1 and split is not None and split[0] is mesh
            and "data" in split[1])
    m = x2.shape[0]
    if rows:
        x2 = mesh.all_gather(x2, "data", dim=0)
    y = _local_matmul(x2[:, d * k_loc:(d + 1) * k_loc], packed, lut, impl,
                      out_dtype=torch.float32, decode=decode,
                      plan_n=n_loc * msize)
    if dsize > 1:
        y = mesh.psum(y, "data")
    if rows:
        y = y[d * m:(d + 1) * m]
    y = y.to(out_dtype)
    return mesh.all_gather(y, "model", dim=1) if gather else y


def flash_attention(q, k, v, *, causal=True, sm_scale=None, q_offset=0):
    """(B, Hq, Tq, Dqk) × (B, Hkv, Tk, Dqk), (B, Hkv, Tk, Dv) →
    (B, Hq, Tq, Dv), through K2's ``autograd.Function``: the kernel
    forward, and where autograd records (training) the plain version's
    backward."""
    return FlashAttentionFn.apply(q, k, v, causal, sm_scale, q_offset)


def grouped_fused_local(xe, packed, lut, *, out_dtype=torch.bfloat16,
                        plan_experts=None, decode: bool = False):
    """Grouped expert fused matmul over a stacked tile-major PackedLinear
    (leading expert axis on every plane): xe (E, cap, K) → (E, cap, N), one
    launch of the grouped kernel, planned for ``plan_experts`` experts
    (default E: see ``grouped_fused_decode_matmul``); ``decode``: the
    capacity rows are a decode step's tokens.  No probe: callers count."""
    if not packed.tile_n or packed.codes.ndim != 3:
        raise ValueError("grouped_fused_local takes a stacked tile-major "
                         f"PackedLinear, got codes {tuple(packed.codes.shape)}"
                         f" tile_n {packed.tile_n}")
    return _grouped(xe, packed.codes, packed.literals, lut, packed.scale,
                    packed.zero, shape=tuple(packed.shape),
                    tile_n=packed.tile_n, tile_k=packed.tile_k,
                    out_dtype=out_dtype, plan_experts=plan_experts,
                    decode=decode)


def grouped_decode_dequant_matmul(xe, packed, lut, *,
                                  out_dtype=torch.bfloat16,
                                  plan_experts=None, decode: bool = False):
    """Per-expert compressed matmul y[e] = x[e] @ W[e].T — the MoE hot
    path.  ``packed``: a stacked PackedLinear (codes (E, nb, slots), scale
    (E, N, 1), …); ``xe`` the capacity-gathered token blocks (E, cap, K).
    Tile-major stacks with the lever at ``auto`` run the grouped fused kernel (probe
    'grouped_fused').  Otherwise the dense expert stack is decoded,
    dequantized to f32 and multiplied by one f32 einsum: decoded by K4 at
    ``unfused`` and for linear-layout stacks (probe 'grouped_unfused'), by
    the plain decode at ``materialize`` (probe 'grouped_materialize').
    ``plan_experts``: the fused kernel's planned expert count (a tiered
    cache stack's layer-wide count; default E).  ``decode``: the capacity
    rows are a decode step's tokens (each row's bits then do not depend on
    the capacity, above 16 too).

    On a mesh, over a rank's share of the stack (experts on model), each
    launch planned for the whole stack's E: ``xe`` of all E experts runs
    the rank's experts and gathers the expert axis back (probe
    'grouped_fused_shard_map'); ``xe`` of the rank's E/model experts
    alone (the local-routing MoE, ``layers.apply_moe_local``, which
    counts its call) stays on the rank."""
    if lut is None or packed.codes.ndim != 3:
        raise ValueError("grouped_decode_dequant_matmul takes a stacked "
                         "PackedLinear and its LUT, got codes "
                         f"{tuple(packed.codes.shape)}")
    impl = _DEFAULT_IMPL
    mesh = _mesh()
    if mesh is not None and packed.mesh_axes is not None:
        # experts on model: this rank's E/model experts, planned for the
        # whole stack
        size = mesh.axis_size(packed.mesh_axes)
        e_loc = packed.codes.shape[0]
        if xe.shape[0] == e_loc:
            # the rank's own experts' tokens (the local-routing MoE,
            # which counts its call): the product stays on the rank
            return _grouped_local(xe, packed, lut, impl, None,
                                  out_dtype=out_dtype,
                                  plan_experts=e_loc * size, decode=decode)
        rows = _band_rows(xe.shape[0], mesh, packed.mesh_axes, size)
        y = _grouped_local(xe[rows], packed, lut, impl,
                           "grouped_fused_shard_map", out_dtype=out_dtype,
                           plan_experts=xe.shape[0], decode=decode)
        return mesh.all_gather(y, packed.mesh_axes, dim=0)
    if packed.mesh_axes is not None:
        raise ValueError("grouped_decode_dequant_matmul: a mesh rank's "
                         "share of an expert stack needs its mesh active")
    if mesh is not None:
        from ..sharding.partition import placement_ok
        if placement_ok(packed, mesh):
            raise ValueError("grouped_decode_dequant_matmul on a mesh "
                             "needs the rank's share of the expert stack "
                             "(sharding.partition.place_params)")
        if impl == Impl.AUTO.value:      # the reference's fallback
            impl = Impl.UNFUSED.value
    return _grouped_local(xe, packed, lut, impl, "grouped_fused",
                          out_dtype=out_dtype, plan_experts=plan_experts,
                          decode=decode)


def _grouped_local(xe, packed, lut, impl: str, probe, *, out_dtype,
                   plan_experts, decode: bool):
    """The grouped product over the stack this rank holds, on the rung
    ``impl``: the fused kernel counted as ``probe`` (None: the caller
    counts it), the other rungs as the reference counts them on any
    mesh."""
    if impl == Impl.AUTO.value and packed.tile_n:
        if probe:
            DISPATCH_COUNTS[probe] += 1
        return grouped_fused_local(xe, packed, lut, out_dtype=out_dtype,
                                   plan_experts=plan_experts, decode=decode)
    plain = impl == Impl.MATERIALIZE.value
    DISPATCH_COUNTS["grouped_materialize" if plain
                    else "grouped_unfused"] += 1
    w = packed.materialize(lut, dtype=torch.float32, plain=plain)
    return torch.einsum("emk,enk->emn", xe.to(torch.float32), w).to(out_dtype)
