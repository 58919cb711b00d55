"""internvl2-2b [vlm] — the InternLM2 language backbone [arXiv:2404.16821].
The vision encoder and projector are not modelled: the patch embeddings
arrive precomputed (``frontend_tokens`` of them, ``data.frontend_embeds``)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92553,
    frontend="vision", frontend_tokens=256,
    source="arXiv:2404.16821",
)
