from .ops import LAUNCHES, dequantize_int8, quantize_int8, reset_launches
from .ref import dequantize_int8_ref, quantize_int8_ref
