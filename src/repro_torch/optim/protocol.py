"""The sharded-optimizer protocol (``repro/optim/protocol.py``).

A ``ShardedOptimizer`` declares its per-dtype-group flat state ``slots``,
its per-tenant coefficients ``coef_names``, and ``update(p, g, slots,
coefs)``, the elementwise fused rule on flat vectors.  ``kernel_update`` is
the counterpart of the reference's ``pallas_update``: the rule through the
CUDA kernel at scalar coefficients.  Its ``update_fn(p, g, slots)`` takes
``g`` either pre-aggregated (same shape as ``p``) or as stacked worker
gradients ``(W, *p.shape)``, which the kernel averages over dim 0 (summed
in worker order, divided by W) before the rule: that is the tall
aggregation the stacked exchange fuses into the update
(``core/exchange.py``).  ``tuple_update`` closes the plain rule over its
coefficients, for a pre-aggregated ``g``.

Nesterov without weight decay is ported.  SGD and Adam are ROADMAP.md
queue A item 3 (with their kernels, queue B); weight decay needs a term in
the kernel and is queued with them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ClassVar, Optional

import torch


@dataclass(frozen=True)
class SlotSpec:
    """One flat optimizer-state buffer per dtype group."""
    name: str
    dtype: Optional[str] = None           # None -> the group's dtype

    def resolve_dtype(self, group_dtype: torch.dtype) -> torch.dtype:
        return getattr(torch, self.dtype) if self.dtype else group_dtype


@dataclass(frozen=True)
class ShardedOptimizer:
    """Base protocol.  Subclasses define ``name``, ``slots``,
    ``coef_names``, ``update`` and ``kernel_update``."""
    name: ClassVar[str] = "base"
    slots: ClassVar[tuple[SlotSpec, ...]] = ()
    coef_names: ClassVar[tuple[str, ...]] = ()

    @property
    def slot_names(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.slots)

    def coefs(self, tc) -> tuple[float, ...]:
        """This rule's coefficients from a TrainConfig."""
        return tuple(float(getattr(tc, n)) for n in self.coef_names)

    def update(self, p, g, slots: tuple, coefs: tuple):
        """Elementwise fused rule on same-shape tensors.
        Returns (p', slots')."""
        raise NotImplementedError

    def kernel_update(self, chunk_elems: int, coefs: tuple) -> Callable:
        """The rule through its CUDA kernel at scalar coefficients."""
        raise NotImplementedError


@dataclass(frozen=True)
class NesterovOptimizer(ShardedOptimizer):
    """The paper's optimizer (§4.2; MXNet's nesterov momentum)."""
    name = "nesterov"
    slots = (SlotSpec("m"),)
    coef_names = ("lr", "momentum")

    def update(self, p, g, slots, coefs):
        (m,) = slots
        lr, mu = coefs
        g32 = g.to(m.dtype)
        m2 = mu * m + g32
        p2 = p - (lr * (g32 + mu * m2)).to(p.dtype)
        return p2, (m2,)

    def kernel_update(self, chunk_elems, coefs):
        from ..kernels.agg_opt.ops import fused_agg_opt, fused_multi_agg_opt
        lr, mu = coefs

        def upd(p, g, slots):
            fused = (fused_multi_agg_opt if g.dim() == p.dim() + 1
                     else fused_agg_opt)
            p2, m2 = fused(p, g, slots[0], lr=lr, momentum=mu,
                           chunk_elems=chunk_elems)
            return p2, (m2,)
        return upd


def make_sharded_optimizer(tc) -> ShardedOptimizer:
    """TrainConfig -> protocol instance."""
    if tc.optimizer == "nesterov":
        return NesterovOptimizer()
    if tc.optimizer in ("sgd", "adam"):
        raise NotImplementedError(
            f"optimizer {tc.optimizer!r} is not ported yet (ROADMAP.md "
            f"queue A item 3; its kernel is in queue B)")
    raise ValueError(f"unknown optimizer {tc.optimizer!r}; expected one of "
                     f"('nesterov', 'sgd', 'adam')")


def tuple_update(opt: ShardedOptimizer, coefs: tuple) -> Callable:
    """Close scalar coefficients over ``opt.update`` — the exchange's
    plain update_fn(p, g, slots) -> (p', slots') for a pre-aggregated g."""
    def upd(p, g, slots):
        return opt.update(p, g, slots, coefs)
    return upd
