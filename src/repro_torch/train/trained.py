"""A briefly trained smoke model: weights with learned structure.

Counterpart of the reference's ``benchmarks/common.py::trained_tiny_model``
(which every reference benchmark starts from): the arch's smoke config
from ``init_lm(cfg, seed)``, trained ``steps`` steps of AdamW (lr 1e-2,
warmup 10) on the seeded Markov ``DataPipeline`` (batch 16 × 32 tokens).
Random-init weights are all but incompressible (they escape the
dictionary); the paper compresses trained checkpoints.
"""
from __future__ import annotations

from .._device import resolve_device
from ..configs import get_config
from ..models import lm as LM
from .data import DataConfig, DataPipeline
from .optimizer import AdamWConfig
from .steps import TrainConfig, init_train_state, make_train_step


def trained_tiny_model(arch_id: str = "llama3.2-1b", steps: int = 60,
                       seed: int = 0, device=None):
    """→ (cfg, params, data) after ``steps`` steps, on ``device`` (the card
    unless the caller passes another)."""
    device = resolve_device(device)
    cfg = get_config(arch_id).smoke
    params = LM.init_lm(cfg, seed=seed, device=device)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=16,
                                   seq_len=32, seed=seed))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-2, warmup_steps=10,
                                             total_steps=max(steps, 20)))
    state = init_train_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    for i in range(steps):
        state, _ = step(state, data.batch_at(i))
    return cfg, state["params"], data
