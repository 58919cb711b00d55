"""The sharded-optimizer protocol (``repro/optim/protocol.py``).

A ``ShardedOptimizer`` declares its per-dtype-group flat state ``slots``,
its per-tenant coefficients ``coef_names``, and ``update(p, g, slots,
coefs)``, the elementwise fused rule on flat vectors.  ``kernel_update`` is
the counterpart of the reference's ``pallas_update``: the rule through its
CUDA kernel at scalar coefficients, one kernel per TPU kernel --
Nesterov through ``agg_opt_chunks`` (pre-aggregated g) or
``multi_agg_opt_chunks`` (stacked g), SGD through ``sgd_opt_chunks`` and
Adam through ``adam_opt_chunks`` (either g).  Its ``update_fn(p, g,
slots, divisor=None, p_out=None, at=None)`` takes ``g`` either
pre-aggregated (same shape as ``p``) or as stacked worker gradients ``(W,
*p.shape)``, which the kernel
averages over dim 0 (summed in worker order, divided by W, or by
``divisor``, a one-element f32 tensor on the card) before the rule: that
is the tall aggregation the stacked exchange fuses into the update
(``core/exchange.py``); the rows of a stacked ``g`` may lie further apart
than ``p``'s length (a window's strip of the stacked buffer, read in
place).  It returns ``(p', slots')``; Adam's kernel updates its slots in
place and returns the same tensors.  ``update_fn(..., p_out=buf)`` is the
windowed exchange's form (``core/pipeline.py``): p' is written into
``buf`` and every slot is updated in place.  ``at``, the strip's offset
in its dtype group, is for the co-scheduled update and ignored here.
``tuple_update`` closes
the plain rule over its coefficients, for a pre-aggregated ``g``;
``tree_init`` and ``tree_update`` apply it leaf by leaf over a nested dict
of tensors (``optim/api.py``'s single-process oracle).
``kernel_dequant_update`` is the counterpart of ``pallas_dequant_update``:
the int8 wire's tail (decode the ring partial, add the owner's own rows,
take the mean, run the rule) in one kernel, ``dequant_agg_opt_chunks``
for Nesterov and ``None`` for the rules that have no such kernel (the
exchange then decodes and calls ``kernel_update``).

As in the reference, ``update`` is the protocol's body and the kernel
computes the TPU kernel's body; they agree to rounding, not bitwise.  For
Adam the protocol keeps the residual-form EMAs ``m + (1-b1)*(g-m)`` in the
group dtype, the kernel the textbook ``b1*m + (1-b1)*g`` in f32.

The co-scheduler's pieces (``core/engine.py::make_co_train_step``):
``union_slots`` (the attached tenants' slot sets, same-named slots shared),
``RuleBinding`` and two forms of the combined update over a packed tenant
domain.  ``make_combined_update`` is the reference's table form, the plain
version, on CPU tensors only: every rule runs over the whole vector at
per-position coefficient tables and mask tables select each position's
owner rule.  ``make_run_update`` is the port's kernel form: each tenant's
own rule kernel, at its own scalar coefficients, launched on each of its
runs that meets the strip (every tenant holds one contiguous run of each
shard it meets), pad runs copied through untouched.  The exchange tells it
where a strip starts in the packed group (``at=``); the solo rules ignore
that.  At every position it computes what the tenant's solo step computes
there, so a co-scheduled tenant equals its solo run bitwise.

Weight decay is the reference's: a frozen field of the rule
(``weight_decay``), so two tenants that differ only in it are two rules,
and ``_decayed`` adds ``wd * p`` to the gradient before Nesterov's and
Adam's update (SGD's has no such term, as in the reference).  The kernels
take it as one more coefficient (``kernels/agg_opt``): B1, B2, B4 and the
int8 tail B7 add the term after the mean, so a decayed update still runs in
the rule's CUDA kernel on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ClassVar, Optional, Sequence

import torch

from ..kernels.agg_opt.ref import sqrt_rn


def _const(x, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar in ``like``'s dtype, as JAX's weakly typed scalars
    are: in a bf16 body the reference rounds 0.1 to bf16 before the
    product, where PyTorch would keep it in f32.  A tensor (a coefficient
    table) is cast to it."""
    if isinstance(x, torch.Tensor):
        return x.to(like.dtype)
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
    ``coef_names``, ``update`` and ``kernel_update``; frozen-dataclass
    equality is the rule's identity (a static field such as
    ``weight_decay`` that differs makes another rule)."""
    weight_decay: float = 0.0

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
        """``upd(p, (q, scales), g_own, slots, divisor=None, p_out=None,
        at=None) -> (p', slots')``: the int8 ring partial decoded, the
        owner's own rows ``g_own`` added, the mean taken as ``* inv_n`` (or
        ``/ divisor``, the gate's live count on the card) and the rule
        run, in one kernel; p, g_own and the slots may be a window's runs,
        and with ``p_out`` p' goes there and the slots are updated in
        place; ``at`` (where the strip sits) is ignored.  None where the
        rule has no such kernel."""
        return None

    def _decayed(self, p, g):
        """``g + wd * p`` (p cast to g's dtype, wd in it as JAX's weakly
        typed scalar), or ``g`` at no decay."""
        if self.weight_decay:
            return g + _const(self.weight_decay, g) * p.to(g.dtype)
        return g


@dataclass(frozen=True)
class NesterovOptimizer(ShardedOptimizer):
    """The paper's optimizer (§4.2; MXNet's nesterov momentum)."""
    name = "nesterov"
    slots = (SlotSpec("m"),)
    coef_names = ("lr", "momentum")

    def update(self, p, g, slots, coefs):
        (m,) = slots
        lr, mu = coefs
        g32 = self._decayed(p, g.to(m.dtype))
        m2 = mu * m + g32
        p2 = p - (lr * (g32 + mu * m2)).to(p.dtype)
        return p2, (m2,)

    def kernel_update(self, chunk_elems, coefs):
        from ..kernels.agg_opt.ops import fused_agg_opt, fused_multi_agg_opt
        lr, mu = coefs
        wd = self.weight_decay

        def upd(p, g, slots, divisor=None, p_out=None, at=None):
            if g.dim() == p.dim() + 1:
                p2, m2 = fused_multi_agg_opt(
                    p, g, slots[0], lr=lr, momentum=mu,
                    chunk_elems=chunk_elems, divisor=divisor, p_out=p_out,
                    weight_decay=wd)
            elif divisor is not None:
                raise ValueError("a divisor needs stacked worker gradients")
            else:
                p2, m2 = fused_agg_opt(p, g, slots[0], lr=lr, momentum=mu,
                                       chunk_elems=chunk_elems, p_out=p_out,
                                       weight_decay=wd)
            return p2, (m2,)
        return upd

    def kernel_dequant_update(self, chunk_elems, coefs, inv_n):
        from ..kernels.agg_opt.ops import fused_dequant_agg_opt
        lr, mu = coefs

        def upd(p, parts, g_own, slots, divisor=None, p_out=None,
                at=None):
            q, scales = parts
            p2, m2 = fused_dequant_agg_opt(
                p, q, scales, g_own, slots[0], lr=lr, momentum=mu,
                inv_n=inv_n, chunk_elems=chunk_elems, divisor=divisor,
                p_out=p_out, weight_decay=self.weight_decay)
            return p2, (m2,)
        return upd


@dataclass(frozen=True)
class SGDOptimizer(ShardedOptimizer):
    """Stateless SGD: zero slots, the exchange carries no optimizer state.
    Its rule has no decay term (the reference's neither), so a
    ``weight_decay`` given to it changes nothing."""
    name = "sgd"
    slots = ()
    coef_names = ("lr",)

    def update(self, p, g, slots, coefs):
        (lr,) = coefs
        return p - (_const(lr, g) * g).to(p.dtype), ()

    def kernel_update(self, chunk_elems, coefs):
        from ..kernels.agg_opt.ops import fused_sgd_opt
        (lr,) = coefs

        def upd(p, g, slots, divisor=None, p_out=None, at=None):
            return fused_sgd_opt(p, g, lr=lr, chunk_elems=chunk_elems,
                                 divisor=divisor, p_out=p_out), ()
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
        g = self._decayed(p, g.to(m.dtype))
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

        def upd(p, g, slots, divisor=None, p_out=None, at=None):
            p2, *slots2 = fused_adam_opt(p, g, *slots, lr=lr, b1=self.b1,
                                         b2=self.b2, eps=self.eps,
                                         chunk_elems=chunk_elems,
                                         divisor=divisor, p_out=p_out,
                                         weight_decay=self.weight_decay)
            return p2, tuple(slots2)
        return upd


OPTIMIZERS = {"nesterov": NesterovOptimizer, "sgd": SGDOptimizer,
              "adam": AdamOptimizer}


def make_sharded_optimizer(tc) -> ShardedOptimizer:
    """TrainConfig -> protocol instance (static fields bound here)."""
    if tc.optimizer == "nesterov":
        return NesterovOptimizer(weight_decay=tc.weight_decay)
    if tc.optimizer == "sgd":
        return SGDOptimizer()
    if tc.optimizer == "adam":
        return AdamOptimizer(weight_decay=tc.weight_decay, b1=tc.adam_b1,
                             b2=tc.adam_b2, eps=tc.adam_eps)
    raise ValueError(f"unknown optimizer {tc.optimizer!r}; expected one of "
                     f"{tuple(OPTIMIZERS)}")


# ------------------------------------------------- the co-scheduler's update

def union_slots(opts: Sequence[ShardedOptimizer]) -> tuple[SlotSpec, ...]:
    """The union of the rules' slot sets, in order of first appearance.
    Same-named slots are shared buffers (Nesterov's m and Adam's m occupy
    one packed buffer; each tenant touches only its own ranges) and must
    agree on dtype."""
    out: list[SlotSpec] = []
    seen: dict[str, SlotSpec] = {}
    for o in opts:
        for s in o.slots:
            prev = seen.get(s.name)
            if prev is None:
                seen[s.name] = s
                out.append(s)
            elif prev.dtype != s.dtype:
                raise ValueError(
                    f"slot {s.name!r} declared with conflicting dtypes "
                    f"{prev.dtype!r} vs {s.dtype!r}")
    return tuple(out)


@dataclass(frozen=True)
class RuleBinding:
    """One rule of a combined update: the union-slot indices it reads and
    writes, its coefficients (a float, or ``("aux", i)``: table i of the
    table form), its member mask's table index (None for a single-rule
    update, which selects nothing) and, for the kernel form, the packed
    runs ``(packed_off, length)`` its tenant owns."""
    opt: ShardedOptimizer
    slot_idx: tuple[int, ...]
    coefs: tuple
    mask_aux: Optional[int] = None
    runs: tuple[tuple[int, int], ...] = ()


def make_combined_update(bindings: Sequence[RuleBinding]) -> Callable:
    """The reference's table form, the plain version: ``upd(p, g, slots,
    *aux) -> (p', slots')`` over the whole packed vector (g
    pre-aggregated), every rule's protocol body at its coefficients (a
    table index reads ``aux``) and, with more than one rule, each position
    selected from its owner's rule by the mask tables (exact 0/1
    selections); positions nobody owns (pad) keep their inputs in the
    multi-rule case and rely on the rules' zero fixed points in the
    single-rule case.  CPU tensors only: on the card the co-scheduled
    update is ``make_run_update``'s kernels."""
    single = len(bindings) == 1

    def upd(p, g, slots, *aux):
        if p.device.type != "cpu":
            raise ValueError(
                "the table form is the co-scheduled update's plain version "
                "and takes CPU tensors; a tensor on the card goes through "
                "make_run_update's kernels")
        new_p = p
        new_slots = list(slots)
        for b in bindings:
            coefs = tuple(aux[c[1]] if isinstance(c, tuple) else c
                          for c in b.coefs)
            sub = tuple(slots[i] for i in b.slot_idx)
            cand_p, cand_s = b.opt.update(p, g, sub, coefs)
            if single:
                new_p = cand_p
                for i, s2 in zip(b.slot_idx, cand_s):
                    new_slots[i] = s2
            else:
                mask = aux[b.mask_aux] != 0
                new_p = torch.where(mask, cand_p, new_p)
                for i, s2 in zip(b.slot_idx, cand_s):
                    new_slots[i] = torch.where(mask, s2, new_slots[i])
        return new_p, tuple(new_slots)
    return upd


def _meets(runs, at: int, n: int):
    """(lo, hi) of each run's part in the strip [at, at + n), relative to
    the strip."""
    for off, length in runs:
        lo, hi = max(off, at), min(off + length, at + n)
        if lo < hi:
            yield lo - at, hi - at


class RunUpdate:
    """The kernel form of the co-scheduled update for one packed dtype
    group: ``upd(p, g, slots, divisor=None, p_out=None, at=0)`` with the
    exchange's update contract (g pre-aggregated, or stacked rows any
    distance apart; ``at`` the strip's offset in the packed group).  Each
    binding's ``kernel_update``, at its scalar coefficients, is launched
    once on each of its runs that meets the strip, on its union slots
    (updated in place), p' into ``p_out`` (a new buffer when None); p is
    copied into the pad runs' part of p'.  ``dequant(inv_n)`` is the int8
    wire's tail in the same form (None when a bound rule has no tail
    kernel).  Returns (p', slots), the slots the tensors given."""

    def __init__(self, bindings: Sequence[RuleBinding], chunk_elems: int,
                 pad: tuple = ()):
        for b in bindings:
            if any(isinstance(c, tuple) for c in b.coefs):
                raise ValueError("the kernel form takes scalar coefficients, "
                                 "one binding a tenant")
        self.bindings, self.ce, self.pad = tuple(bindings), chunk_elems, pad
        self.kernels = tuple(b.opt.kernel_update(chunk_elems, b.coefs)
                             for b in self.bindings)

    def __call__(self, p, g, slots, divisor=None, p_out=None, at=0):
        n = p.numel()
        if p_out is None:
            p_out = torch.empty_like(p)
        for lo, hi in _meets(self.pad, at, n):
            p_out[lo:hi].copy_(p[lo:hi])
        for b, k in zip(self.bindings, self.kernels):
            for lo, hi in _meets(b.runs, at, n):
                k(p[lo:hi], g[..., lo:hi],
                  tuple(slots[i][lo:hi] for i in b.slot_idx),
                  divisor=divisor, p_out=p_out[lo:hi])
        return p_out, slots

    def dequant(self, inv_n: float) -> Optional[Callable]:
        """``upd(p, (q, scales), g_own, slots, divisor=None, p_out=None,
        at=0)``: each binding's ``kernel_dequant_update`` launched on each
        of its runs meeting each row of p (a 1-D strip at offset ``at``,
        or (R, Lr) runs at the offsets ``at[r]``, q and the scales packed
        row after row); None when a bound rule has no tail kernel."""
        ks = tuple(b.opt.kernel_dequant_update(self.ce, b.coefs, inv_n)
                   for b in self.bindings)
        if any(k is None for k in ks):
            return None
        ce = self.ce

        def upd(p, parts, g_own, slots, divisor=None, p_out=None, at=0):
            q, scales = parts
            if p_out is None:
                p_out = torch.empty_like(p)
            flat = p.dim() == 1
            two = (lambda t: t[None]) if flat else (lambda t: t)
            rows, own, out = two(p), two(g_own), two(p_out)
            sl = tuple(two(s) for s in slots)
            Lr = rows.shape[1]
            for r, a0 in enumerate((at,) if flat else at):
                base = r * Lr
                for lo, hi in _meets(self.pad, a0, Lr):
                    out[r, lo:hi].copy_(rows[r, lo:hi])
                for b, k in zip(self.bindings, ks):
                    for lo, hi in _meets(b.runs, a0, Lr):
                        k(rows[r, lo:hi],
                          (q[base + lo:base + hi],
                           scales[(base + lo) // ce:(base + hi) // ce]),
                          own[r, lo:hi],
                          tuple(sl[i][r, lo:hi] for i in b.slot_idx),
                          divisor=divisor, p_out=out[r, lo:hi])
            return p_out, slots
        return upd


def make_run_update(bindings: Sequence[RuleBinding], group) -> RunUpdate:
    """The kernel form for one ``PackedGroup`` (its chunk size and pad
    runs)."""
    return RunUpdate(bindings, group.chunk_elems, group.pad_runs())


def tuple_update(opt: ShardedOptimizer, coefs: tuple) -> Callable:
    """Close scalar coefficients over ``opt.update`` — the exchange's
    plain update_fn(p, g, slots) -> (p', slots') for a pre-aggregated g."""
    def upd(p, g, slots):
        return opt.update(p, g, slots, coefs)
    return upd


# ------------------------------------------------------- tree-level API

def _tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` leaf by leaf over nested dicts of one structure."""
    return {k: (_tree_map(fn, v, *(r[k] for r in rest))
                if isinstance(v, dict) else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def tree_init(opt: ShardedOptimizer, params: dict) -> dict:
    """{slot_name: tree of zeros like ``params``}, each leaf in its slot's
    dtype: the tree-level state."""
    return {s.name: _tree_map(
                lambda p, s=s: torch.zeros(p.shape,
                                           dtype=s.resolve_dtype(p.dtype),
                                           device=p.device), params)
            for s in opt.slots}


def tree_update(opt: ShardedOptimizer, coefs: tuple, params: dict,
                grads: dict, state: dict):
    """The protocol rule leaf by leaf over nested dicts (the reference,
    non-exchange path; the single-process oracle the chunk exchange is
    held against).  Returns (params', state')."""
    names = opt.slot_names
    with torch.no_grad():
        out = _tree_map(lambda p, g, *slots: opt.update(p, g, slots, coefs),
                        params, grads, *(state[n] for n in names))
    new_p = _tree_map(lambda t: t[0], out)
    new_state = {n: _tree_map(lambda t, i=i: t[1][i], out)
                 for i, n in enumerate(names)}
    return new_p, new_state
