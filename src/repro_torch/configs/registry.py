"""Architecture registry: --arch <id> -> ModelConfig.

The port holds the dense llama3.2-1b, h2o-danube-3-4b (sliding window
4096), granite-3-8b and minitron-8b, and the attention-free rwkv6-3b
(family ``ssm``).  The reference's other five architectures need model
families the port does not have yet (ROADMAP.md queue A item 8), so asking
for one raises and says so.
"""
from __future__ import annotations

from . import (granite3_8b, h2o_danube3_4b, llama3_2_1b, minitron_8b,
               rwkv6_3b)
from .base import ModelConfig

ARCHS: dict[str, ModelConfig] = {c.arch_id: c for c in (
    llama3_2_1b.CONFIG, h2o_danube3_4b.CONFIG, granite3_8b.CONFIG,
    minitron_8b.CONFIG, rwkv6_3b.CONFIG)}

NOT_PORTED = ("arctic-480b", "grok-1-314b", "hymba-1.5b", "internvl2-2b",
              "musicgen-medium")


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP.md queue A item 8: "
            f"other model families); ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
