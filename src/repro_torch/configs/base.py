"""Config registry scaffolding (counterpart of ``repro/configs/base.py``)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    full: ModelConfig
    smoke: ModelConfig
    source: str               # citation + verification tier from assignment
    notes: str = ""


_REGISTRY: dict[str, ArchEntry] = {}


def register(entry: ArchEntry) -> ArchEntry:
    _REGISTRY[entry.arch_id] = entry
    return entry


def get(arch_id: str) -> ArchEntry:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_archs() -> list[str]:
    return sorted(_REGISTRY)
