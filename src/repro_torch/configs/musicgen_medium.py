"""musicgen-medium [audio] — a decoder-only transformer over EnCodec tokens
[arXiv:2306.05284].  The conditioning frontend is not modelled: its frame
embeddings arrive precomputed (``data.frontend_embeds``)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    frontend="audio", frontend_tokens=256,
    source="arXiv:2306.05284",
)
