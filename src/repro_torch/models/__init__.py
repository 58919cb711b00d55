from .attention import blockwise_attention
from .loss import chunked_cross_entropy
from .model import DecoderLM, init_params, param_specs
