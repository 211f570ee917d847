"""Quantization core — the paper's §3 ``Quantizer`` (Listing 1), generalized.

Counterpart of ``repro/core/quant.py``: the paper's per-tensor min/max
quantizer, per-channel and per-group granularity, symmetric mode, and the
ternary {w_min, 0, w_max} scheme (``bits=1.5``).  Everything is f32 on the
tensor's own device; ``torch.round`` rounds half to even, as ``jnp.round``
does, so the integer payload is byte-equal to the reference's.  The
per-channel 8-bit path (the packer's, ``core/compressed.py``) is the one
``build_serve_params`` serves.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantization configuration.  ``bits=1.5`` selects ternary
    quantization (the paper's ``configure(1.5)``); per-channel rows are
    along ``channel_axis`` (the rows of an (out, in) weight)."""

    bits: float = 8
    granularity: str = "per_channel"   # per_tensor | per_channel | per_group
    group_size: int = 128              # only for per_group
    symmetric: bool = False            # the paper's naive scheme: affine
    channel_axis: int = 0

    @property
    def is_ternary(self) -> bool:
        return self.bits == 1.5

    @property
    def maxq(self) -> int:
        if self.is_ternary:
            return -1  # the paper's sentinel
        return int(2 ** int(self.bits) - 1)

    @property
    def storage_dtype(self):
        if self.is_ternary or self.bits <= 8:
            return torch.uint8
        return torch.uint16


@dataclasses.dataclass
class QuantizedTensor:
    """Integer codes + affine params; :func:`dequantize` restores the float
    view.  ``values`` are laid out as the (channels, -1) or (groups,
    group_size) row view (per-tensor: flat), ``scale``/``zero`` broadcast
    against them.  Unpacks as ``(values, scale, zero)``, the per-channel
    triple the packer takes."""

    values: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    shape: tuple
    dtype: torch.dtype
    bits: float
    layout: tuple | None = None  # (granularity, axis, group_size, moved)

    def __iter__(self):
        return iter((self.values, self.scale, self.zero))


@dataclasses.dataclass
class TernaryTensor:
    """Ternary codes {0: zero, 1: w_min, 2: w_max}."""

    codes: torch.Tensor
    w_max: torch.Tensor
    w_min: torch.Tensor
    shape: tuple
    dtype: torch.dtype

    def dequant(self) -> torch.Tensor:
        x = torch.where(self.codes == 2, self.w_max,
                        torch.where(self.codes == 1, self.w_min,
                                    torch.zeros_like(self.w_max)))
        return x.reshape(self.shape).to(self.dtype)


def _rows(x: torch.Tensor, axis: int):
    """(channels, -1) rows of x along ``axis``, and the moved shape."""
    moved = torch.movedim(x, axis, 0)
    return moved.reshape(moved.shape[0], -1), tuple(moved.shape)


def _group_rows(rows: torch.Tensor, g: int) -> torch.Tensor:
    pad = (-rows.shape[1]) % g
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    return rows.reshape(-1, g)


def _affine(xmin, xmax, cfg: QuantConfig):
    """scale = (max − min)/maxq (1 where that is ≤ 0), zero =
    round(−min/scale), with min ≤ 0 ≤ max (symmetric: ±max|·|)."""
    xmin = torch.clamp(xmin, max=0.0)
    xmax = torch.clamp(xmax, min=0.0)
    if cfg.symmetric:
        m = torch.maximum(xmin.abs(), xmax.abs())
        xmin, xmax = -m, m
    scale = (xmax - xmin) / cfg.maxq
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    return scale, torch.round(-xmin / scale)


def find_params(x: torch.Tensor, cfg: QuantConfig):
    """The paper's ``find_params``: (scale, zero) for the configured
    granularity, shaped against the row view :func:`quantize` codes —
    (1,) per tensor, (channels, 1) per channel, (groups, 1) per group.
    Ternary: (w_max, w_min)."""
    x = x.to(torch.float32)
    if cfg.is_ternary:
        return x.max()[None], x.min()[None]
    if cfg.granularity == "per_tensor":
        scale, zero = _affine(x.min(), x.max(), cfg)
        return scale[None], zero[None]
    if cfg.granularity not in ("per_channel", "per_group"):
        raise ValueError(f"unknown granularity {cfg.granularity!r}")
    rows, _ = _rows(x, cfg.channel_axis)
    if cfg.granularity == "per_group":
        rows = _group_rows(rows, cfg.group_size)
    scale, zero = _affine(rows.amin(dim=1), rows.amax(dim=1), cfg)
    return scale[:, None], zero[:, None]


def quantize(x: torch.Tensor, cfg: QuantConfig = QuantConfig()):
    """Quantize a float tensor (paper Listing 1, generalized) →
    :class:`QuantizedTensor` (or :class:`TernaryTensor` at 1.5 bits)."""
    shape, dtype = tuple(x.shape), x.dtype
    xf = x.to(torch.float32)
    if cfg.is_ternary:
        w_max, w_min = find_params(xf, cfg)
        codes = (xf > w_max / 2).to(torch.uint8) * 2 \
            + (xf < w_min / 2).to(torch.uint8)
        return TernaryTensor(codes, w_max, w_min, shape, dtype)
    scale, zero = find_params(xf, cfg)
    if cfg.granularity == "per_tensor":
        q = torch.clamp(torch.round(xf.reshape(-1) / scale) + zero, 0,
                        cfg.maxq)
        return QuantizedTensor(q.to(cfg.storage_dtype), scale, zero, shape,
                               dtype, cfg.bits)
    rows, moved = _rows(xf, cfg.channel_axis)
    if cfg.granularity == "per_group":
        rows = _group_rows(rows, cfg.group_size)
    q = torch.clamp(torch.round(rows / scale) + zero, 0, cfg.maxq)
    return QuantizedTensor(q.to(cfg.storage_dtype), scale, zero, shape,
                           dtype, cfg.bits,
                           (cfg.granularity, cfg.channel_axis,
                            cfg.group_size, moved))


def dequantize(qt) -> torch.Tensor:
    """Inverse of :func:`quantize` for any granularity."""
    if isinstance(qt, TernaryTensor):
        return qt.dequant()
    x = (qt.values.to(torch.float32) - qt.zero) * qt.scale
    if qt.layout is None:                      # per tensor
        return x.reshape(qt.shape).to(qt.dtype)
    granularity, axis, _, moved = qt.layout
    if granularity == "per_group":
        inner = 1
        for s in moved[1:]:
            inner *= s
        x = x.reshape(moved[0], -1)[:, :inner]
    return torch.movedim(x.reshape(moved), 0, axis).to(qt.dtype)


def fake_quant(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """quantize → dequantize (the straight-through value of QAT)."""
    return dequantize(quantize(x, cfg))


def quantization_error(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Mean squared quantization error (the bit-width ablation's
    measure)."""
    return torch.mean((x - fake_quant(x, cfg)) ** 2)
