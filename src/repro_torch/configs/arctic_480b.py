"""arctic-480b [moe] — 128 experts top-2 with a dense residual MLP in
parallel [hf:Snowflake/snowflake-arctic-base]; bf16 parameters."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    n_experts=128, top_k=2, dense_residual=True, param_dtype="bfloat16",
    source="hf:Snowflake/snowflake-arctic-base",
)
