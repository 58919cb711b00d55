"""grok-1-314b [moe] — 8 experts, top-2 [hf:xai-org/grok-1]; bf16
parameters."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    n_experts=8, top_k=2, param_dtype="bfloat16",
    source="hf:xai-org/grok-1",
)
