from .attention import blockwise_attention
from .loss import chunked_cross_entropy
from .model import (DecoderLM, cache_capacity, init_cache, init_params,
                    layer_windows, param_specs)
