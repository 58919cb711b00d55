from .ops import (LAUNCHES, fused_adam_opt, fused_agg_opt,
                  fused_dequant_agg_opt, fused_health_scan,
                  fused_multi_agg_opt, fused_sgd_opt, health_partials,
                  reset_launches)
from .ref import (adam_opt_ref, agg_opt_ref, block_diagonal,
                  dequant_agg_opt_ref, health_chunks_ref, health_scan_ref,
                  multi_agg_opt_ref, sgd_opt_ref)
