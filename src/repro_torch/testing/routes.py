"""The MoE's routing decisions, recorded for tests.

Inside :func:`recording`, every ``models.layers.apply_moe`` call appends
(expert ids (n_tok, k), kept (n_tok, k), aux loss) of its tokens to the
list the block yields: which (token, expert) choices the capacity kept,
seen through any entry point (a train step on a mesh included), without
a routing output on the call chain.  Outside the block nothing is kept.
"""
from __future__ import annotations

import contextlib

import torch

_ROUTES: list | None = None


@contextlib.contextmanager
def recording():
    """→ the list of each ``apply_moe`` call's (expert ids, kept, aux)
    made in the block."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def record(expert_ids: torch.Tensor, keep: torch.Tensor,
           aux: torch.Tensor) -> None:
    if _ROUTES is not None:
        _ROUTES.append((expert_ids.detach(), keep.detach(), aux.detach()))
