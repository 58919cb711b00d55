from .chunking import (ChunkPlan, GroupPlan, build_plan, chunk_spans,
                       flatten_groups, shard_matrix, unflatten_groups)
from .client import PHubClient, module_tree, nest
from .comm import ProcessGroupComm, StackedComm
from .engine import PHubEngine
from .exchange import STRATEGIES, exchange_group
