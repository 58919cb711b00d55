"""Deterministic synthetic token pipeline.

``batch_at`` is the reference's numpy generator (``repro/data/synthetic.py``)
line for line, so both packages see bitwise-identical batches at every
step; ``torch_batch`` hands the same batch to the port on a device.

A frontend architecture (``cfg.frontend``: vlm, audio) reads precomputed
embeddings before its tokens.  ``batch_specs`` says what one batch holds
(the reference's ``make_batch_specs``): the prefix ``extra_embeds`` (B,
frontend_tokens, d_model) bf16 in a train or prefill batch, none at
decode.  ``frontend_embeds`` draws one from an explicit
``torch.Generator``, and ``PrefixedTokens`` adds one to each training
batch, drawn from the step's own seed.

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


def batch_specs(cfg: ModelConfig, batch: int, seq_len: int,
                kind: str) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of one global batch of ``kind`` (train,
    prefill or decode), as the reference's ``make_batch_specs``: tokens
    (and a train batch's labels) (B, T) int, T 1 at decode; a frontend's
    ``extra_embeds`` (B, frontend_tokens, d_model) bf16 except at
    decode."""
    T = 1 if kind == "decode" else seq_len
    specs = {"tokens": ((batch, T), torch.int64)}
    if kind == "train":
        specs["labels"] = ((batch, T), torch.int64)
    if cfg.frontend and kind != "decode":
        specs["extra_embeds"] = ((batch, cfg.frontend_tokens, cfg.d_model),
                                 torch.bfloat16)
    return specs


def frontend_embeds(cfg: ModelConfig, batch: int, *,
                    generator: torch.Generator, device) -> torch.Tensor:
    """A frontend's embeddings (B, frontend_tokens, d_model) bf16, N(0, 1)
    drawn in f32 from ``generator`` (on ``device``)."""
    if not cfg.frontend:
        raise ValueError(f"{cfg.arch_id} has no frontend")
    x = torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                    generator=generator, device=device, dtype=torch.float32)
    return x.to(torch.bfloat16)


class PrefixedTokens(SyntheticTokens):
    """``SyntheticTokens`` whose ``torch_batch`` adds a frontend's
    ``extra_embeds``, drawn from a generator seeded with the step's own
    seed, so a batch does not depend on the steps before it."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0):
        super().__init__(cfg, batch, seq_len, seed)
        self.cfg = cfg

    def torch_batch(self, step: int, device="cuda") -> dict[str, torch.Tensor]:
        out = super().torch_batch(step, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed * 1_000_003 + step)
        out["extra_embeds"] = frontend_embeds(self.cfg, self.batch,
                                              generator=gen, device=device)
        return out
