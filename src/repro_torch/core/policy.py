"""Compression policy — which tensors carry Tiny-QMoE compression.

Counterpart of ``repro/core/policy.py::CompressionPolicy``:

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
