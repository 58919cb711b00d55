"""Optimizer factory keyed by ``TrainConfig.optimizer`` (the tree-level
entry, ``repro/optim/api.py``).

``make_optimizer`` returns the classic (init, update) pair applying the
protocol rule leaf by leaf over a nested dict of tensors: the
single-process reference for what the chunk-domain exchange computes on
flat buffers (``core/client.py``).
"""
from __future__ import annotations

from .protocol import make_sharded_optimizer, tree_init, tree_update


def make_optimizer(tc):
    """Returns (init_fn(params) -> state, update_fn(params, grads, state)
    -> (params', state'))."""
    opt = make_sharded_optimizer(tc)
    coefs = opt.coefs(tc)

    def init(params):
        return tree_init(opt, params)

    def update(params, grads, state):
        return tree_update(opt, coefs, params, grads, state)

    return init, update
