"""Assigned input shapes and (arch x shape) applicability rules
(``repro/configs/shapes.py``; ``InputShape`` is the reference's
``configs/base.py`` dataclass)."""
from __future__ import annotations

from dataclasses import dataclass

from .base import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = InputShape("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = InputShape("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = InputShape("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = InputShape("long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) must lower; else a reason for the recorded skip.

    ``long_500k`` requires sub-quadratic attention: skipped for pure
    full-attention architectures."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full attention is quadratic; no SWA/SSM variant for this arch"
    return True, ""
