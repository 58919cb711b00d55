from .ops import LAUNCHES, reset_launches, swa_attention
from .ref import swa_attention_ref
