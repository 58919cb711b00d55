from .attention import blockwise_attention
from .loss import chunked_cross_entropy
from .model import (GLOBAL_DECODE_CAP, DecoderLM, cache_capacity, init_cache,
                    init_params, layer_windows, param_specs, ssm_state_dtype)
from .moe import load_balance_loss, moe_mlp
from .ssm import ssm_branch, ssm_scan
