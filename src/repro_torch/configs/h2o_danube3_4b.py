"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]. SWA makes it long_500k-eligible."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000, sliding_window=4096,
    source="arXiv:2401.16818",
)
