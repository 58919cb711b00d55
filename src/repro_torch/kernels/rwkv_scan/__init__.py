from .ops import LAUNCHES, reset_launches, rwkv_scan
from .ref import rwkv_scan_ref
