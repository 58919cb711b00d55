from .ops import LAUNCHES, decode_attention, reset_launches
from .ref import decode_attention_ref
