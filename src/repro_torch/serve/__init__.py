"""Serving: packing, one-shot generation and the continuous-batching
engine (counterpart of ``repro.serve``).

  * Request level: ``Engine.submit(Request) / step() / drain()``, a
    continuous-batching scheduler over a paged KV pool (``scheduler``,
    ``kv_cache``); completions are bitwise-equal to one-shot ``generate``
    of the same prompt.
  * Fixed batch: ``build_serve_params`` / ``make_serve_fns`` /
    ``generate`` serve one rectangular batch end to end.
  * Resilience: ``ResilientEngine`` gates on the artifact's integrity and
    walks the degradation ladder (fused → unfused → materialize) on
    device faults, for ``generate``, the prefill and the scheduler.
  * Memory: ``residency.ResidencyManager`` (tiered expert residency, a
    pinned host store under a device cache of hot experts) and
    ``governor.MemoryGovernor`` (trims that cache and the paged KV pool
    when the device budget moves).
"""
from .context import ServeContext
from .engine import (ServeState, build_serve_params, generate,
                     make_serve_fns, sample_tokens)
from .kv_cache import PagedKVPool
from .resilience import (FALLBACK_COUNTS, DeadlineExceeded,
                         ResiliencePolicy, ResilientEngine, ServeRefused)
from .scheduler import Completion, Engine, Request

__all__ = ["ServeState", "build_serve_params", "make_serve_fns", "generate",
           "sample_tokens", "ServeContext", "Engine", "Request", "Completion",
           "PagedKVPool", "FALLBACK_COUNTS", "ServeRefused",
           "ResilientEngine", "ResiliencePolicy", "DeadlineExceeded"]
