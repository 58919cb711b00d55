from .protocol import (OPTIMIZERS, AdamOptimizer, NesterovOptimizer,
                       SGDOptimizer, ShardedOptimizer, SlotSpec,
                       make_sharded_optimizer, tree_init, tree_update,
                       tuple_update)
from .sgd import nesterov_init, nesterov_update, sgd_update
from .adam import adam_init, adam_update
from .api import make_optimizer
