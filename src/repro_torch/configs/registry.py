"""Architecture registry: --arch <id> -> ModelConfig.

The reference's ten architectures: the dense llama3.2-1b,
h2o-danube-3-4b (sliding window 4096), granite-3-8b and minitron-8b; the
attention-free rwkv6-3b (family ``ssm``); the top-k mixtures of experts
grok-1-314b and arctic-480b (family ``moe``, arctic with a dense residual
MLP); the hybrid hymba-1.5b (attention and SSM heads side by side); and
the prefix frontends internvl2-2b (``vlm``) and musicgen-medium
(``audio``), dense decoders whose input starts with precomputed
embeddings.
"""
from __future__ import annotations

from . import (arctic_480b, granite3_8b, grok1_314b, h2o_danube3_4b,
               hymba_1_5b, internvl2_2b, llama3_2_1b, minitron_8b,
               musicgen_medium, rwkv6_3b)
from .base import ModelConfig

ARCHS: dict[str, ModelConfig] = {m.CONFIG.arch_id: m.CONFIG for m in (
    llama3_2_1b, h2o_danube3_4b, minitron_8b, musicgen_medium, grok1_314b,
    arctic_480b, rwkv6_3b, granite3_8b, internvl2_2b, hymba_1_5b)}


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
