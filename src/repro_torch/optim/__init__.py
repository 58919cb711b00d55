from .protocol import (OPTIMIZERS, AdamOptimizer, NesterovOptimizer,
                       SGDOptimizer, ShardedOptimizer, SlotSpec,
                       make_sharded_optimizer, tuple_update)
