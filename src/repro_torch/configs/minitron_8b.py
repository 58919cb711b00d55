"""minitron-8b [dense] — pruned nemotron [arXiv:2407.14679]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=256000,
    source="arXiv:2407.14679",
)
