"""Compression policy — which tensors carry Tiny-QMoE compression — and
the device-memory budget split of tiered serving.

Counterpart of ``repro/core/policy.py``: ``CompressionPolicy`` (with its
``tiles``, the column groups of ``TiledPackedLinear`` storage), and
``DeviceBudget`` / ``device_budget`` (the same integer arithmetic).
The policy:

  * 2-D matmul weights >= min_weight_size  -> quantize + compress
  * embeddings / lm_head                   -> quant only by default
  * norms, biases, routers, rotary tables  -> keep dense
"""
from __future__ import annotations

import dataclasses
import re

EXCLUDE_PATTERNS = (
    r"norm", r"bias", r"router", r"gate_logit", r"a_log", r"dt", r"conv",
    r"\bD\b", r"rope", r"rotary", r"scale", r"zero", r"embed_pos",
    r"\bb[qkv]\b", r"d_skip",
)


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    mode: str = "compressed"          # dense | quant | compressed
    min_weight_size: int = 65536      # below this, keep dense
    compress_embeddings: bool = False # embeddings: quant-only by default
    bits: float = 8
    block_weights: int = 4096
    exclude_extra: tuple = ()
    # column-tile storage: split each compressed weight (experts excepted)
    # into this many column groups, one set of planes each, which K1 reads
    # in one launch; 0/1 = untiled planes
    tiles: int = 0

    def excluded(self, name: str) -> bool:
        pats = EXCLUDE_PATTERNS + tuple(self.exclude_extra)
        low = name.lower()
        return any(re.search(p, low) for p in pats)

    def action(self, name: str, shape: tuple) -> str:
        """-> 'dense' | 'quant' | 'compressed' for one named tensor."""
        if self.mode == "dense":
            return "dense"
        n = 1
        for s in shape:
            n *= s
        if len(shape) < 2 or n < self.min_weight_size or self.excluded(name):
            return "dense"
        if "embed" in name.lower() or "lm_head" in name.lower():
            if self.mode == "compressed" and self.compress_embeddings:
                return "compressed"
            return "quant"
        return self.mode


@dataclasses.dataclass(frozen=True)
class DeviceBudget:
    """Device-memory budget split for tiered-residency serving (bytes
    throughout; counterpart of ``repro/core/policy.py::DeviceBudget``).

    The paper's deployment regime is a 4–8 GB unified-memory edge device:
    the compressed model does not have to fit, only the *resident* slice
    does.  ``fits`` says whether what must stay on the device (non-expert
    weights + KV pages + activation headroom) leaves any room at all;
    ``expert_cache_bytes`` is what is left for the per-layer expert cache,
    and ``cache_experts_per_layer`` converts it at a given per-expert
    compressed footprint."""
    budget_bytes: int
    resident_bytes: int        # non-expert weights pinned on device
    kv_bytes: int              # KV pool / paged cache
    act_bytes: int             # activation + workspace headroom
    expert_bytes: int          # total compressed expert planes (all layers)

    @property
    def reserved_bytes(self) -> int:
        return self.resident_bytes + self.kv_bytes + self.act_bytes

    @property
    def expert_cache_bytes(self) -> int:
        """Bytes left for the device expert cache (may be 0)."""
        return max(0, self.budget_bytes - self.reserved_bytes)

    @property
    def fits(self) -> bool:
        """True when the reserved set + at least one cached expert's worth
        of planes fits the budget (expert_bytes == 0: just the reserve)."""
        return self.expert_cache_bytes > 0 or self.expert_bytes == 0

    @property
    def fully_resident(self) -> bool:
        """True when every compressed expert fits beside the reserve:
        tiering would only add bookkeeping."""
        return self.expert_cache_bytes >= self.expert_bytes

    def cache_experts_per_layer(self, n_layers: int,
                                bytes_per_expert: int) -> int:
        """Experts per MoE layer the leftover budget can cache (>= 0)."""
        if n_layers <= 0 or bytes_per_expert <= 0:
            return 0
        return int(self.expert_cache_bytes // (n_layers * bytes_per_expert))

    def resplit(self, budget_bytes: int, *,
                kv_bytes: int | None = None) -> "DeviceBudget":
        """Re-split under a moved runtime budget.  The class stays frozen:
        a re-split is a new value, which the ``MemoryGovernor`` swaps in at
        a step fence.  The resident and activation reserves are not
        elastic; ``kv_bytes`` may shrink and regrow with the paged pool."""
        return dataclasses.replace(
            self, budget_bytes=int(budget_bytes),
            kv_bytes=self.kv_bytes if kv_bytes is None else int(kv_bytes))

    def min_viable(self, *, kv_floor_bytes: int = 0,
                   expert_floor_bytes: int = 0) -> int:
        """The smallest budget the engine can run under at all: the
        inelastic reserve (resident weights + activation workspace) plus
        the floors of the two elastic tiers, one decode slot's KV pages
        and one cached expert per MoE layer.  Below it the governor
        refuses new work instead of pretending to fit."""
        return int(self.resident_bytes + self.act_bytes
                   + kv_floor_bytes + expert_floor_bytes)

    def summary(self, expert_cache_used: int | None = None) -> str:
        mib = 2.0 ** 20
        s = (f"device budget {self.budget_bytes / mib:.0f} MiB: "
             f"resident {self.resident_bytes / mib:.1f} + "
             f"kv {self.kv_bytes / mib:.1f} + "
             f"act {self.act_bytes / mib:.1f} MiB reserved -> "
             f"{self.expert_cache_bytes / mib:.1f} MiB expert cache "
             f"({'fully resident' if self.fully_resident else 'tiered'}"
             f"; experts total {self.expert_bytes / mib:.1f} MiB)")
        if expert_cache_used is not None \
                and expert_cache_used > self.expert_cache_bytes:
            over = expert_cache_used - self.expert_cache_bytes
            s += (f" — OVERSHOOT: cache holds "
                  f"{expert_cache_used / mib:.1f} MiB, "
                  f"{over / mib:.1f} MiB over the granted budget")
        return s


def device_budget(budget_bytes: int, *, expert_bytes: int,
                  resident_bytes: int = 0, kv_bytes: int = 0,
                  act_bytes: int = 0) -> DeviceBudget:
    """Split a device byte budget across what must and what may live on
    the device."""
    return DeviceBudget(budget_bytes=int(budget_bytes),
                        resident_bytes=int(resident_bytes),
                        kv_bytes=int(kv_bytes), act_bytes=int(act_bytes),
                        expert_bytes=int(expert_bytes))
