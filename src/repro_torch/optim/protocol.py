"""The sharded-optimizer protocol (``repro/optim/protocol.py``).

A ``ShardedOptimizer`` declares its per-dtype-group flat state ``slots``,
its per-tenant coefficients ``coef_names``, and ``update(p, g, slots,
coefs)``, the elementwise fused rule on flat vectors.  ``kernel_update`` is
the counterpart of the reference's ``pallas_update``: the rule through its
CUDA kernel at scalar coefficients, one kernel per TPU kernel --
Nesterov through ``agg_opt_chunks`` (pre-aggregated g) or
``multi_agg_opt_chunks`` (stacked g), SGD through ``sgd_opt_chunks`` and
Adam through ``adam_opt_chunks`` (either g).  Its ``update_fn(p, g,
slots, divisor=None)`` takes ``g`` either pre-aggregated (same shape as
``p``) or as stacked worker gradients ``(W, *p.shape)``, which the kernel
averages over dim 0 (summed in worker order, divided by W, or by
``divisor``, a one-element f32 tensor on the card) before the rule: that
is the tall aggregation the stacked exchange fuses into the update
(``core/exchange.py``).  It returns ``(p', slots')``; Adam's kernel updates
its slots in place and returns the same tensors.  ``tuple_update`` closes
the plain rule over its coefficients, for a pre-aggregated ``g``.
``kernel_dequant_update`` is the counterpart of ``pallas_dequant_update``:
the int8 wire's tail (decode the ring partial, add the owner's own rows,
take the mean, run the rule) in one kernel, ``dequant_agg_opt_chunks``
for Nesterov and ``None`` for the rules that have no such kernel (the
exchange then decodes and calls ``kernel_update``).

As in the reference, ``update`` is the protocol's body and the kernel
computes the TPU kernel's body; they agree to rounding, not bitwise.  For
Adam the protocol keeps the residual-form EMAs ``m + (1-b1)*(g-m)`` in the
group dtype, the kernel the textbook ``b1*m + (1-b1)*g`` in f32.

Weight decay is not ported: none of the kernels has a ``+wd*p`` term, and a
rule without its kernel would leave the card's one route through them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ClassVar, Optional

import torch

from ..kernels.agg_opt.ref import sqrt_rn


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar in ``like``'s dtype, as JAX's weakly typed scalars
    are: in a bf16 body the reference rounds 0.1 to bf16 before the
    product, where PyTorch would keep it in f32."""
    return torch.tensor(x, dtype=like.dtype)


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

    def kernel_dequant_update(self, chunk_elems: int, coefs: tuple,
                              inv_n: float) -> Optional[Callable]:
        """``upd(p, (q, scales), g_own, slots) -> (p', slots')``: the int8
        ring partial decoded, the owner's own rows ``g_own`` added, the
        mean taken as ``* inv_n`` and the rule run, in one kernel; or
        None where the rule has no such kernel."""
        return None


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

        def upd(p, g, slots, divisor=None):
            if g.dim() == p.dim() + 1:
                p2, m2 = fused_multi_agg_opt(
                    p, g, slots[0], lr=lr, momentum=mu,
                    chunk_elems=chunk_elems, divisor=divisor)
            elif divisor is not None:
                raise ValueError("a divisor needs stacked worker gradients")
            else:
                p2, m2 = fused_agg_opt(p, g, slots[0], lr=lr, momentum=mu,
                                       chunk_elems=chunk_elems)
            return p2, (m2,)
        return upd

    def kernel_dequant_update(self, chunk_elems, coefs, inv_n):
        from ..kernels.agg_opt.ops import fused_dequant_agg_opt
        lr, mu = coefs

        def upd(p, parts, g_own, slots):
            q, scales = parts
            p2, m2 = fused_dequant_agg_opt(
                p, q, scales, g_own, slots[0], lr=lr, momentum=mu,
                inv_n=inv_n, chunk_elems=chunk_elems)
            return p2, (m2,)
        return upd


@dataclass(frozen=True)
class SGDOptimizer(ShardedOptimizer):
    """Stateless SGD: zero slots, the exchange carries no optimizer state."""
    name = "sgd"
    slots = ()
    coef_names = ("lr",)

    def update(self, p, g, slots, coefs):
        (lr,) = coefs
        return p - (_const(lr, g) * g).to(p.dtype), ()

    def kernel_update(self, chunk_elems, coefs):
        from ..kernels.agg_opt.ops import fused_sgd_opt
        (lr,) = coefs

        def upd(p, g, slots, divisor=None):
            return fused_sgd_opt(p, g, lr=lr, chunk_elems=chunk_elems,
                                 divisor=divisor), ()
        return upd


@dataclass(frozen=True)
class AdamOptimizer(ShardedOptimizer):
    """Adam with bias correction.  k1/k2 hold ``1 - b^t`` per position
    (float32 whatever the group dtype), ticked as ``k' = b*k + (1-b)`` only
    where the position has seen gradient, so that dead pad tails keep the
    zero fixed point; the step is the epsilon-hat form
    ``lr*(sqrt(k2')/k1')*m' / (sqrt(v') + eps*sqrt(k2'))``, masked to an
    exact no-op where ``k1' == 0`` (the reference's module docstring says
    why)."""
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    name = "adam"
    slots = (SlotSpec("m"), SlotSpec("v"), SlotSpec("k1", "float32"),
             SlotSpec("k2", "float32"))
    coef_names = ("lr",)

    def update(self, p, g, slots, coefs):
        # the reference's protocol body: residual-form EMAs in the group
        # dtype, then the fenced reciprocal and square root and one division
        m, v, k1, k2 = slots
        (lr,) = coefs
        b1, b2 = self.b1, self.b2
        g = g.to(m.dtype)
        alive = (g != 0) | (k1 != 0)
        k1n = torch.where(alive, b1 * k1 + (1 - b1), k1)
        k2n = torch.where(alive, b2 * k2 + (1 - b2), k2)
        m2 = m + _const(1 - b1, m) * (g - m)
        v2 = v + _const(1 - b2, v) * (g * g - v)
        k1m = k1n.to(m.dtype)
        q1 = _const(1.0, k1m) / k1m
        rk2 = sqrt_rn(k2n).to(m.dtype)
        num = (_const(lr, q1) * q1) * rk2 * m2
        step = num / (sqrt_rn(v2) + _const(self.eps, rk2) * rk2)
        step = torch.where(k1n > 0, step, torch.zeros_like(step))
        return p - step.to(p.dtype), (m2, v2, k1n, k2n)

    def kernel_update(self, chunk_elems, coefs):
        from ..kernels.agg_opt.ops import fused_adam_opt
        (lr,) = coefs

        def upd(p, g, slots, divisor=None):
            p2, *slots2 = fused_adam_opt(p, g, *slots, lr=lr, b1=self.b1,
                                         b2=self.b2, eps=self.eps,
                                         chunk_elems=chunk_elems,
                                         divisor=divisor)
            return p2, tuple(slots2)
        return upd


OPTIMIZERS = {"nesterov": NesterovOptimizer, "sgd": SGDOptimizer,
              "adam": AdamOptimizer}


def make_sharded_optimizer(tc) -> ShardedOptimizer:
    """TrainConfig -> protocol instance (static fields bound here)."""
    if tc.optimizer == "nesterov":
        return NesterovOptimizer()
    if tc.optimizer == "sgd":
        return SGDOptimizer()
    if tc.optimizer == "adam":
        return AdamOptimizer(b1=tc.adam_b1, b2=tc.adam_b2, eps=tc.adam_eps)
    raise ValueError(f"unknown optimizer {tc.optimizer!r}; expected one of "
                     f"{tuple(OPTIMIZERS)}")


def tuple_update(opt: ShardedOptimizer, coefs: tuple) -> Callable:
    """Close scalar coefficients over ``opt.update`` — the exchange's
    plain update_fn(p, g, slots) -> (p', slots') for a pre-aggregated g."""
    def upd(p, g, slots):
        return opt.update(p, g, slots, coefs)
    return upd
