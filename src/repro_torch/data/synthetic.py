"""Deterministic synthetic token pipeline.

``batch_at`` is the reference's numpy generator (``repro/data/synthetic.py``)
line for line, so both packages see bitwise-identical batches at every
step; ``torch_batch`` hands the same batch to the port on a device.

The "task" is a noisy affine-progression language, so the training loss
measurably decreases.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig


class SyntheticTokens:
    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0):
        self.vocab = cfg.vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        start = rng.integers(0, self.vocab, (self.batch, 1))
        stride = rng.integers(1, 17, (self.batch, 1))
        seq = (start + stride * np.arange(self.seq + 1)) % self.vocab
        noise = rng.random((self.batch, self.seq + 1)) < 0.02
        seq = np.where(noise, rng.integers(0, self.vocab, seq.shape), seq)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}

    def torch_batch(self, step: int, device="cuda") -> dict[str, torch.Tensor]:
        """``batch_at(step)`` as int64 index tensors on ``device``."""
        return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
                for k, v in self.batch_at(step).items()}
