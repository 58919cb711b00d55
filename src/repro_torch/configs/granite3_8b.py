"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49155,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
