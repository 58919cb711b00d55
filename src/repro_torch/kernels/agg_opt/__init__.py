from .ops import LAUNCHES, fused_agg_opt, fused_multi_agg_opt, reset_launches
from .ref import agg_opt_ref, multi_agg_opt_ref
