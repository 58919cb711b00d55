"""Tree-level SGD and Nesterov wrappers over the sharded-optimizer protocol
(``repro/optim/sgd.py``).

The elementwise rules live in ``optim/protocol.py`` only, the same bodies
the exchange's plain versions repeat, so these are thin adapters over
nested dicts of tensors.  Weight decay is not ported (``protocol.py``'s
docstring says why), so the reference's ``weight_decay`` argument is
absent.
"""
from __future__ import annotations

from .protocol import (NesterovOptimizer, SGDOptimizer, tree_init,
                       tree_update)


def nesterov_init(params):
    return tree_init(NesterovOptimizer(), params)


def nesterov_update(params, grads, state, *, lr: float,
                    momentum: float = 0.9):
    return tree_update(NesterovOptimizer(), (lr, momentum), params, grads,
                       state)


def sgd_update(params, grads, state, *, lr: float, **_):
    new_p, _ = tree_update(SGDOptimizer(), (lr,), params, grads, {})
    return new_p, state
