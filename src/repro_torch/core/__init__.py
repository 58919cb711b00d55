from .api import PHubConnectionManager, ServiceHandle
from .chunking import (ChunkPlan, GroupPlan, PackedGroup, TenantPackedDomain,
                       TenantSlot, build_plan, chunk_spans, flatten_groups,
                       pack_domains, shard_matrix, unflatten_groups)
from .client import PHubClient, module_tree, nest
from .comm import ProcessGroupComm, StackedComm
from .engine import PHubEngine, make_co_train_step
from .exchange import STRATEGIES, exchange_group
