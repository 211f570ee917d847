"""ServeContext — one bundle for what a serving call needs beyond
(params, tokens).  Counterpart of ``repro/serve/context.py`` without the
mesh, verify and residency fields (multi-device, integrity and tiered
residency are not ported yet)."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True, eq=False)
class ServeContext:
    """cfg: the model config.  lut: the model-wide decode LUT for
    compressed weights, or None.  device: where serving runs (None means
    the CUDA card; pass "cpu" to run the kernels' plain versions)."""
    cfg: Any
    lut: Any = None
    device: Any = None

    @classmethod
    def from_state(cls, cfg, state, *, device=None) -> "ServeContext":
        """Build from an ``engine.ServeState`` (the LUT comes off it)."""
        return cls(cfg=cfg, lut=state.lut, device=device)
