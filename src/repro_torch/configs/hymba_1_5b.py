"""hymba-1.5b [hybrid] — parallel attention and SSM heads, sliding-window
attention with a few global layers, ssm_state=16 [arXiv:2411.13676]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, sliding_window=1024, global_layer_every=16,
    source="arXiv:2411.13676",
)
