"""Where the port's entry points run: the card, unless the caller says."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none; the CPU
    is used only when the caller passes ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run the kernels' plain versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def upload(a, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``.  To a card it goes through
    pinned memory by an asynchronous copy, which does not synchronize
    (a copy from pageable memory does)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
