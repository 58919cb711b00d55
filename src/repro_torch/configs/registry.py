"""Architecture registry: --arch <id> -> ModelConfig.

The port holds the dense llama3.2-1b and h2o-danube-3-4b (sliding window
4096).  The reference's other eight architectures need model families the
port does not have yet (ROADMAP.md queue A, item 15), so asking for one
raises and says so.
"""
from __future__ import annotations

from . import h2o_danube3_4b, llama3_2_1b
from .base import ModelConfig

ARCHS: dict[str, ModelConfig] = {c.arch_id: c for c in (
    llama3_2_1b.CONFIG, h2o_danube3_4b.CONFIG)}

NOT_PORTED = ("arctic-480b", "granite-3-8b", "grok-1-314b", "hymba-1.5b",
              "internvl2-2b", "minitron-8b", "musicgen-medium", "rwkv6-3b")


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP.md queue A item 15: "
            f"other model families); ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
