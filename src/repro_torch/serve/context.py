"""ServeContext — one bundle for what a serving call needs beyond
(params, tokens).  Counterpart of ``repro/serve/context.py`` without its
``verify`` field, which nothing there reads either: the integrity gate's
level is ``ResiliencePolicy.verify``."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True, eq=False)
class ServeContext:
    """cfg: the model config.  lut: the model-wide decode LUT for
    compressed weights, or None.  device: where serving runs (None means
    the CUDA card; pass "cpu" to run the kernels' plain versions).
    mesh: a ``launch.mesh.Mesh`` of ranks for sharded serving (the params
    are then the rank's share, ``sharding.partition.place_params``), or
    None for one device.
    residency: a ``serve.residency.ResidencyManager`` for tiered expert
    residency, or None for fully resident serving; every serving entry
    point that sees it routes its steps through the manager's fetch/replay
    protocol, and ``with_cfg`` keeps it, so the ladder's rungs share one
    cache.

    Compared by identity (``eq=False``): two contexts over one artifact
    are interchangeable, not equal."""
    cfg: Any
    lut: Any = None
    device: Any = None
    residency: Any = None
    mesh: Any = None

    @classmethod
    def from_state(cls, cfg, state, *, device=None,
                   mesh=None) -> "ServeContext":
        """Build from an ``engine.ServeState`` (the LUT comes off it)."""
        return cls(cfg=cfg, lut=state.lut, device=device, mesh=mesh)

    def with_cfg(self, cfg) -> "ServeContext":
        """The same artifact under another (e.g. a ladder rung's) config."""
        return dataclasses.replace(self, cfg=cfg)
