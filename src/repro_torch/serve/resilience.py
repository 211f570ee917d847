"""Serving's fault and overload accounting.

Counterpart of the part of ``repro/serve/resilience.py`` that the
continuous-batching scheduler needs: the ``FALLBACK_COUNTS`` probe and the
``ServeRefused`` error.  Not ported yet: ``ResilientEngine``, its
degradation ladder and ``ResiliencePolicy``.
"""
from __future__ import annotations

import collections

# Event -> count.  The scheduler ticks 'quarantine' per poisoned request
# refused out of a batch, 'preempt' per in-flight request evicted under
# page pressure, 'shed' per request shed by the bounded queue and
# 'expired' per TTL or deadline expiry, under the reference's names.
FALLBACK_COUNTS: collections.Counter = collections.Counter()


class ServeRefused(RuntimeError):
    """Serving a call was refused; carries the diagnostics, a list of
    (rung, attempt, repr(exception))."""

    def __init__(self, errors):
        self.errors = list(errors)
        super().__init__(
            "degradation ladder exhausted: "
            + "; ".join(f"{r}#{a}: {e}" for r, a, e in self.errors))
