from .protocol import (NesterovOptimizer, ShardedOptimizer, SlotSpec,
                       make_sharded_optimizer, tuple_update)
