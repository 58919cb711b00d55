"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay
[arXiv:2404.05892]. 40 heads of 64 (d_model/64)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=0, head_dim=64,
    d_ff=8960, vocab_size=65536, rwkv_decay_lora=64,
    source="arXiv:2404.05892",
)
