"""Tree-level Adam wrappers over the sharded-optimizer protocol
(``repro/optim/adam.py``).

The rule lives in ``optim/protocol.py`` only.  The bias correction is kept
as per-position k1/k2 slots holding ``1 - b^t`` (so they shard and window
like every other slot of the exchange), and the tree state mirrors that
with per-leaf k trees rather than one step count.  Weight decay is not
ported.
"""
from __future__ import annotations

from .protocol import AdamOptimizer, tree_init, tree_update


def adam_init(params):
    return tree_init(AdamOptimizer(), params)


def adam_update(params, grads, state, *, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8):
    return tree_update(AdamOptimizer(b1=b1, b2=b2, eps=eps), (lr,), params,
                       grads, state)
