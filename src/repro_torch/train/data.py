"""Data pipeline — deterministic, step-indexed, restart-safe.

Counterpart of ``repro/train/data.py``: every batch is a pure function of
(seed, step), drawn with numpy exactly as the reference draws it, so
``batch_at(step)`` gives the reference's tokens; they are returned as
torch tensors (int32, on the CPU).  Two sources:

  * synthetic markov streams: each token follows one of four successors
    of the one before it (``order_mix`` of the time) or is uniform;
  * byte corpus: any local file served as uint8 tokens (vocab 256).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    kind: str = "markov"            # markov | bytes
    corpus_path: str | None = None
    order_mix: float = 0.7          # markov: P(follow chain) vs uniform


def _markov_table(vocab: int, seed: int) -> np.ndarray:
    """The four successors of every token (deterministic)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, 4))


class DataPipeline:
    """Host-side generator; ``batch_at(step)`` is random-access."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.kind == "markov":
            self._succ = _markov_table(cfg.vocab_size, cfg.seed)
        elif cfg.kind == "bytes":
            with open(cfg.corpus_path, "rb") as f:
                self._bytes = np.frombuffer(f.read(), dtype=np.uint8)
            if len(self._bytes) <= cfg.seq_len + 1:
                raise ValueError(f"corpus {cfg.corpus_path} holds "
                                 f"{len(self._bytes)} bytes, fewer than a "
                                 f"sequence of {cfg.seq_len} + 2")
        else:
            raise ValueError(cfg.kind)

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"}: (batch, seq_len) int32 tensors, labels the
        tokens shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        if cfg.kind == "bytes":
            starts = rng.integers(0, len(self._bytes) - cfg.seq_len - 1,
                                  size=cfg.batch)
            toks = np.stack([self._bytes[s:s + cfg.seq_len + 1]
                             for s in starts]).astype(np.int32)
        else:
            toks = np.empty((cfg.batch, cfg.seq_len + 1), np.int32)
            cur = rng.integers(0, cfg.vocab_size, size=cfg.batch)
            toks[:, 0] = cur
            for t in range(1, cfg.seq_len + 1):
                follow = rng.random(cfg.batch) < cfg.order_mix
                pick = rng.integers(0, 4, size=cfg.batch)
                nxt_chain = self._succ[cur, pick]
                nxt_rand = rng.integers(0, cfg.vocab_size, size=cfg.batch)
                cur = np.where(follow, nxt_chain, nxt_rand)
                toks[:, t] = cur
        return {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
                "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
