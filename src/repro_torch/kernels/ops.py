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
                   decode: bool = False):
    """y = x @ dequant(wq).T.  x: (..., K); wq: (N, K) uint8; scale/zero:
    (N, 1).  Leading dims of x flatten to M.  ``decode``: the M rows are a
    decode step's, one token a request (the kernels' plans keep each such
    row's bits what they are alone, at any M)."""
    lead = x.shape[:-1]
    y = _dequant_matmul(x.reshape(-1, x.shape[-1]), wq, scale, zero,
                        out_dtype=out_dtype, decode=decode)
    return y.reshape(*lead, wq.shape[0])


def decode_dequant_matmul(x, packed, lut, *, out_dtype=torch.bfloat16,
                          decode: bool = False):
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
    :func:`dequant_matmul`, for the fused and unfused rungs."""
    probe = packed.PROBE
    if packed.codes.ndim != 2 + packed.GROUP_AXES:
        raise ValueError(f"{probe}decode_dequant_matmul takes one layer's "
                         f"planes, got codes {tuple(packed.codes.shape)}")
    impl = _DEFAULT_IMPL
    n, k = packed.shape
    if impl == Impl.MATERIALIZE.value:
        DISPATCH_COUNTS[probe + "materialize"] += 1
        w = packed.materialize(lut, dtype=torch.float32, plain=True)
        return torch.matmul(x.to(torch.float32), w.T).to(out_dtype)
    if impl == Impl.UNFUSED.value or not packed.tile_n:
        DISPATCH_COUNTS[probe + "unfused"] += 1
        return dequant_matmul(x, packed.materialize_int8(lut), packed.scale,
                              packed.zero, out_dtype=out_dtype,
                              decode=decode)
    DISPATCH_COUNTS[probe + "fused"] += 1
    lead = x.shape[:-1]
    y = _fused(x.reshape(-1, k), packed.codes, packed.literals, lut,
               packed.scale, packed.zero, shape=tuple(packed.shape),
               tile_n=packed.tile_n, tile_k=packed.tile_k,
               out_dtype=out_dtype, decode=decode)
    return y.reshape(*lead, n)


# the reference's name for the TiledPackedLinear branch
tiled_decode_dequant_matmul = decode_dequant_matmul


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
    the capacity, above 16 too)."""
    if lut is None or packed.codes.ndim != 3:
        raise ValueError("grouped_decode_dequant_matmul takes a stacked "
                         "PackedLinear and its LUT, got codes "
                         f"{tuple(packed.codes.shape)}")
    impl = _DEFAULT_IMPL
    if impl == Impl.AUTO.value and packed.tile_n:
        DISPATCH_COUNTS["grouped_fused"] += 1
        return grouped_fused_local(xe, packed, lut, out_dtype=out_dtype,
                                   plan_experts=plan_experts, decode=decode)
    plain = impl == Impl.MATERIALIZE.value
    DISPATCH_COUNTS["grouped_materialize" if plain
                    else "grouped_unfused"] += 1
    w = packed.materialize(lut, dtype=torch.float32, plain=plain)
    return torch.einsum("emk,enk->emn", xe.to(torch.float32), w).to(out_dtype)
