"""PHubClient: PHub's framework-agnostic push/pull API
(``repro/core/client.py``; paper §2, §4).

PHub's headline interface is a kvstore-style push/pull that a training
framework drops in: workers push gradients, the PS runs the fused
aggregation + optimizer on its chunk shards, and workers pull the updated
parameters.  A client is built over any nested dict of tensors (no model,
no loss) and drives the whole exchange of ``core/exchange.py`` and
``core/pipeline.py`` (every strategy, wire, window count and the DCN
tier) with the optimizer protocol's CUDA kernels (``optim/protocol.py``):

    client = PHubClient(tc, StackedComm(W)).register(module_tree(model))
    opt = client.init_state()
    params, opt = client.push_pull(grads, module_tree(model), opt)

``grads`` leaves carry a leading axis of ``comm.local_workers()``: W on the
stacked Comm (the W workers' pushes, stacked on one card), 1 on a rank of
a ``ProcessGroupComm`` (this rank's push).  ``push_pull`` is the fused
push-wait-pull: one call aggregates every worker's push (the mean),
applies the rule on each shard's chunks and writes the pulled parameters
into the caller's tensors in place, so an ``nn.Module``'s parameters keep
their identity (the reference returns a new pytree of the same values).
``push_pull_flat`` takes the chunk-domain stores instead (``flatten``):
``{dtype_name: (local_workers, padded)}`` gradient rows and ``{dtype_name:
(padded,)}`` parameters, with no flatten or write-back.

``PHubEngine`` (``core/engine.py``) is a thin consumer: it builds a client
over its model's parameter specs and hands every per-group exchange to
``exchange_flats``, keeping the model, the loss, the per-worker backward,
the sanity gate, the chunk-ready hooks and flat residency.

The wire (``TrainConfig.wire_format``, or the ``wire_format=`` override)
decouples the dtype chunks travel in from the state's: an encoded wire
adds the ``wire_ef`` residual as the last slot, as does an encoded DCN
tier (``wire_format_dcn``, hierarchical only).  Chunk-ready dispatch
(``overlap_backward``) in a standalone ``push_pull`` dispatches each
window of the finished push as it becomes ready, stacked only (as the
engine's, ``core/comm.py::require_stacked``, ROADMAP.md queue A item 4b).

The co-scheduler (``core/engine.py::make_co_train_step``, the connection
manager of ``core/api.py``) hands the packed tenant domain through the
same ``exchange_flats``: its groups (``chunking.PackedGroup``), the
tenants' union slots (``slot_specs``, ``wire_ef`` still last) and one
update per group (``update_by_key``: the kernel form
``optim/protocol.py::RunUpdate``, whose per-run int8 tail keeps B7 on a
Nesterov tenant's runs; or, on CPU tensors, the reference's table form
with its ``aux_by_key`` tables).

Telemetry (``telemetry/``): ``push_pull`` and ``push_pull_flat`` run
under the ``exchange/push_pull`` span, and every step function the client
and its engine hand out (``dispatched``) under ``engine/dispatch``, the
reference's spans; with telemetry off both are no-ops.  Left out of the
reference's client: ``compile_count`` (ROADMAP.md queue A item 10): the
port builds no programs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.agg_opt.ref import worker_mean
from ..optim.protocol import make_sharded_optimizer
from . import chunking
from ..telemetry import get_tracer
from .comm import require_stacked
from .exchange import check_strategy, check_wire
from .pipeline import (check_pipeline, run_chunk_ready_exchange,
                       run_dcn_exchange, run_exchange, run_wire_exchange)
from .wire import (WIRE_EF_SLOT, exchange_extra_slots, make_dcn_wire_format,
                   make_wire_format)


def nest(named) -> dict:
    """(dotted name, tensor) pairs -> a nested dict, the names split on
    ``.``."""
    tree: dict = {}
    for name, t in named:
        *outer, leaf = name.split(".")
        node = tree
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def dispatched(fn):
    """``fn`` with every call under the ``engine/dispatch`` span, as the
    reference's compiled step wrapper: a host-side span around the call's
    enqueue, no synchronization."""
    def call(*args, **kwargs):
        with get_tracer().span("engine/dispatch"):
            return fn(*args, **kwargs)
    return call


def module_tree(module: torch.nn.Module) -> dict:
    """An ``nn.Module``'s ``named_parameters()`` as a nested dict; the
    leaves are the parameters themselves."""
    return nest(module.named_parameters())


def _table_update(upd, aux: tuple):
    """The reference's table form ``upd(p, g, slots, *aux)`` (CPU) under
    the exchange's update contract: a stacked g averaged as the kernels
    average it (``worker_mean``, in worker order, then divided), the
    tables' part at the strip ``[at, at + n)``, p' into ``p_out`` and the
    new slots copied into the given ones."""
    def step(p, g, slots, divisor=None, p_out=None, at=0):
        if g.dim() == p.dim() + 1:
            g = worker_mean(g, divisor)
        n = p.numel()
        p2, s2 = upd(p, g, slots, *(t[at:at + n] for t in aux))
        for s, v in zip(slots, s2):
            s.copy_(v)
        if p_out is None:
            return p2, slots
        return p_out.copy_(p2), slots
    return step


def _meta_tree(tree: dict) -> dict:
    return {k: (_meta_tree(v) if isinstance(v, dict) else
                torch.empty(tuple(v.shape), dtype=v.dtype, device="meta"))
            for k, v in tree.items()}


class PHubClient:
    """One job's handle onto the exchange over ``comm``
    (``StackedComm(W, pods)`` or ``ProcessGroupComm``).  Entry points run
    on the card unless ``device="cpu"`` is asked for; a CUDA tensor
    launches the rule's kernel or raises, a CPU tensor takes its plain
    version."""

    def __init__(self, tc, comm, *, device="cuda", wire_format=None,
                 wire_format_dcn=None):
        if wire_format is not None and wire_format != tc.wire_format:
            # a per-client wire: the slot layout, residual included,
            # follows it
            tc = dataclasses.replace(tc, wire_format=wire_format)
        if wire_format_dcn is not None and \
                wire_format_dcn != tc.wire_format_dcn:
            tc = dataclasses.replace(tc, wire_format_dcn=wire_format_dcn)
        if tc.strategy == "fsdp_stream":
            raise ValueError(
                "fsdp_stream shards leaves over 'data' and has no chunk "
                "domain; PHubClient serves the chunk-domain strategies")
        check_strategy(tc.strategy)
        check_pipeline(tc)
        self.wire = make_wire_format(tc)
        self.wire_dcn = make_dcn_wire_format(tc)
        check_wire(tc.strategy, self.wire, self.wire_dcn)
        self.tc, self.comm = tc, comm
        self.device = torch.device(device)
        self.sopt = make_sharded_optimizer(tc)
        # the rule's slots, then the wire's residual last, so the rule's
        # slot indices are stable
        self.exchange_slots = (self.sopt.slots
                               + exchange_extra_slots(self.wire,
                                                      self.wire_dcn))
        self.plan = None
        self.like = None
        self.membership = None          # static k-of-n (elastic/)
        self._gate = (None, None)       # its (mask, divisor), built once
        self.watchdog = None            # resilience.ExchangeWatchdog
        self._gbuf = None

    # ------------------------------------------------------------ register

    def register(self, tree: dict) -> "PHubClient":
        """Build the chunk plan over a nested dict of tensors (meta tensors
        too): every leaf split into ``chunk_size_bytes`` chunks, mapped to
        an owner shard, in ``chunking.leaf_paths``' sorted-key order (the
        reference's pytree order).  Returns self."""
        self.like = _meta_tree(tree)
        self.plan = chunking.build_plan(
            self.like, chunk_bytes=self.tc.chunk_size_bytes,
            n_shards=self.comm.n_shards(self.tc.strategy))
        self._gbuf = None
        return self

    def _require_plan(self) -> None:
        if self.plan is None:
            raise ValueError("call register(tree) first")

    # ------------------------------------------------- membership, watchdog

    def set_membership(self, membership) -> "PHubClient":
        """A static k-of-n ``elastic.Membership``: the excluded workers'
        pushes are zeroed and the mean divides by the live count.  None, or
        an all-live membership, takes the static full-rack path.  Returns
        self."""
        if membership is not None:
            membership.validate_world(self.comm.n_workers)
        mask, live = self.elastic_mask(membership)
        # built here, once: a copy to the card inside push_pull would make
        # the host wait for the caller's backward
        self._gate = (mask, None if mask is None else
                      self.live_divisor(live))
        self.membership = membership
        return self

    def set_watchdog(self, watchdog) -> "PHubClient":
        """Run every standalone ``push_pull`` / ``push_pull_flat`` under
        ``watchdog.run`` (retry with backoff; ``WatchdogExhausted`` when
        it gives up).  None uninstalls.  Returns self."""
        self.watchdog = watchdog
        return self

    def elastic_mask(self, membership):
        """(mask, n_live) for an elastic membership, or (None, None) on
        the static full-rack path: the all-live case runs the same
        exchange as no membership at all."""
        if membership is None or membership.all_live:
            return None, None
        membership.validate_world(self.comm.n_workers)
        membership.require_quorum()
        return membership.mask(), float(membership.n_live)

    def live_divisor(self, n_live: float):
        """A static live count as the exchange takes it: by value over an
        encoded wire (the int8 tail kernel bakes ``1/n_live``, as the
        reference's does), else a 0-dim tensor on the device."""
        if self.wire.error_feedback:
            return n_live
        return torch.tensor(n_live, device=self.device)

    def mask_rows(self, gbuf: dict, mask: np.ndarray) -> None:
        """The k-of-n push gate: zero every excluded worker's row that this
        process holds, in place, so it adds exactly nothing to the sums."""
        first = self.comm.rank * self.comm.local_workers()
        for w in np.nonzero(mask == 0)[0]:
            if first <= w < first + self.comm.local_workers():
                for v in gbuf.values():
                    v[w - first].zero_()

    # ----------------------------------------------------------- opt state

    def local_shards(self) -> int:
        """Shards whose state this process keeps: every one on the stacked
        Comm, the one a rank owns over a process group (under
        centralized_ps rank 0, the PS, keeps the one shard and the other
        ranks none)."""
        st = self.tc.strategy
        if self.comm.local_workers() == self.comm.n_workers:
            return self.comm.n_shards(st)
        if st == "centralized_ps":
            return 1 if self.comm.rank == 0 else 0
        return 1

    def slot_shape(self, group, spec) -> tuple[int, int]:
        """(rows, state_len) of slot ``spec`` of ``group`` in this
        process: ``local_shards`` rows, or for the DCN tier's ``wire_ef``
        (each pod's residual: an encoded DCN tier under the identity ICI
        wire) on the stacked Comm one row a (pod, shard), pod-major."""
        rows = self.local_shards()
        if (spec.name == WIRE_EF_SLOT and self.wire_dcn is not None
                and not self.wire.error_feedback
                and self.comm.local_workers() == self.comm.n_workers):
            rows *= self.comm.pods
        return rows, self.comm.state_len(self.tc.strategy, group.padded)

    def slot_shapes(self) -> dict:
        """{dtype_name: {slot_name: meta tensor}}: every exchange slot's
        shape (``slot_shape``) and dtype (Adam's k1/k2 and ``wire_ef`` are
        f32 in every group)."""
        self._require_plan()
        return {g.key: {s.name: torch.empty(self.slot_shape(g, s),
                                            dtype=s.resolve_dtype(g.dtype),
                                            device="meta")
                        for s in self.exchange_slots}
                for g in self.plan.groups}

    def init_state(self) -> dict:
        """Zero slots {dtype_name: {slot_name: (rows, state_len)}} on the
        client's device: row s the state of the chunks shard s owns (one
        row, this rank's shard, over a process group); as many slots as
        the rule declares (Nesterov 1, SGD 0, Adam 4), then ``wire_ef``."""
        return {k: {n: torch.zeros(t.shape, dtype=t.dtype,
                                   device=self.device)
                    for n, t in d.items()}
                for k, d in self.slot_shapes().items()}

    # ------------------------------------------------------ chunk domain

    def flatten(self, tree: dict, out: dict | None = None) -> dict:
        """Tree -> {dtype_name: (padded,)} store in the plan's order, the
        pad zero; ``out`` ({dtype_name: (padded,)}, e.g. one worker's row
        of a stacked gradient buffer) is written in place instead."""
        self._require_plan()
        with torch.no_grad():
            return chunking.flatten_leaves(
                self.plan, dict(chunking.leaf_paths(tree)), out)

    def unflatten(self, store: dict) -> dict:
        """Store -> tree of views of the store (no copy)."""
        self._require_plan()
        return chunking.unflatten_groups(self.plan, store, self.like)

    def write_params(self, tree: dict, new_p: dict) -> None:
        """The exchange's new parameters ``new_p`` ({dtype_name:
        (padded,)}, consumed group by group) copied into ``tree``'s
        tensors in place."""
        leaves = dict(chunking.leaf_paths(tree))
        with torch.no_grad():
            for g in self.plan.groups:
                for path, new in chunking.group_leaves(
                        g, new_p.pop(g.key)).items():
                    leaves[path].copy_(new)

    def grad_buffers(self) -> dict:
        """The stacked gradient buffers {dtype_name: (local_workers,
        padded)} (one row over a process group), allocated once and shared
        by every call; chunk-ready windows read their strips in place."""
        self._require_plan()
        if self._gbuf is None:
            W = self.comm.local_workers()
            self._gbuf = {g.key: torch.zeros((W, g.padded), dtype=g.dtype,
                                             device=self.device)
                          for g in self.plan.groups}
        return self._gbuf

    def release_buffers(self) -> None:
        """Drop the stacked gradient buffers (``grad_buffers`` allocates
        them again at the next use): a co-scheduled tenant pushes into the
        packed domain's buffers instead."""
        self._gbuf = None

    # -------------------------------------------------------- the exchange

    def update_fn(self, group):
        """The fused agg+opt for one dtype group, through the rule's CUDA
        kernel (``ShardedOptimizer.kernel_update``)."""
        return self.sopt.kernel_update(group.chunk_elems,
                                       self.sopt.coefs(self.tc))

    def fused_dequant(self, group, n_live=None, update=None):
        """The int8 wire's tail kernel for one group (decode + own rows +
        mean + rule), or None: another wire, or a rule without one.  A
        static live count ``n_live`` (a number) is baked in as
        ``1/n_live``, as the reference's ``_fused_dequant`` does; the
        gate's (a tensor on the card) goes to the kernel's divisor at the
        call.  ``update``: an override's update, whose own ``dequant``
        (the co-scheduler's per-run tail) is used, if it has one."""
        if not self.wire.has_scales:
            return None
        n = n_live if isinstance(n_live, (int, float)) else \
            self.comm.n_workers
        if update is not None:
            dequant = getattr(update, "dequant", None)
            return None if dequant is None else dequant(1.0 / n)
        return self.sopt.kernel_dequant_update(
            group.chunk_elems, self.sopt.coefs(self.tc), 1.0 / n)

    def _wire_args(self, group, opt, n_live, update=None) -> dict:
        """The encoded wire's (or the DCN tier's) arguments of one group's
        exchange."""
        args = dict(wire_dcn=self.wire_dcn,
                    residual=opt[group.key][WIRE_EF_SLOT].view(-1))
        if self.wire.error_feedback:
            args.update(wire=self.wire, fused_dequant=self.fused_dequant(
                group, n_live, update))
        return args

    def chunk_ready(self, group, gbuf: dict, p: torch.Tensor, opt: dict,
                    n_live=None, stream=None, *, update_fn=None):
        """One group's chunk-ready exchange (``pipeline.ChunkReadyExchange``)
        over its row of ``gbuf`` and the flat parameters ``p``, on any
        wire, or None when the group has one effective window.  Report
        each leaf with ``leaf_ready(i)``; ``exchange_flats(ready=)``
        finishes it.  ``update_fn``: a rule factory (group -> update) in
        place of this client's own."""
        slots = tuple(opt[group.key][n].view(-1)
                      for n in self.sopt.slot_names)
        wire = (self._wire_args(group, opt, n_live)
                if WIRE_EF_SLOT in opt[group.key] else {})
        return run_chunk_ready_exchange(
            self.tc.strategy, self.comm, gbuf[group.key], p, slots,
            (update_fn or self.update_fn)(group), group,
            self.tc.pipeline_windows, n_live, stream, **wire)

    def exchange_flats(self, gbuf: dict, flats_p: dict, opt: dict,
                       n_live=None, ready=None, *, update_fn=None,
                       groups=None, slot_specs=None, update_by_key=None,
                       aux_by_key=None):
        """Run the exchange per dtype group on the stacked gradients
        ``gbuf`` ({dtype_name: (local_workers, padded)}) and the flat
        parameters ``flats_p`` ({dtype_name: (padded,)}, consumed), over
        the identity wire (``run_exchange``), an encoded one
        (``run_wire_exchange``) or the DCN tier (``run_dcn_exchange``), at
        the effective window count.  ``n_live`` (a number: a static
        membership over an encoded wire; or a 0-dim tensor on the card)
        divides the worker sum instead of W.  ``ready``: {dtype_name:
        ChunkReadyExchange} of the groups whose windows were dispatched
        already (``chunk_ready``); they are finished here.
        ``update_fn``: a rule factory (group -> update) in place of
        ``self.update_fn``.  Returns ({dtype_name: p'}, the new optimizer
        state); a rule whose kernel updates its slots in place (Adam, and
        every rule in windows) returns the tensors of ``opt`` themselves.
        Under an encoded wire the slots' last entry, ``wire_ef``, is the
        residual the wire threads, not a slot of the rule.

        The co-scheduler's overrides: ``groups`` ({dtype_name: group},
        e.g. a packed tenant domain's ``PackedGroup``s) in place of the
        plan's; ``slot_specs`` (the exchange's slots, ``wire_ef`` last
        under an encoded wire) in place of ``exchange_slots``;
        ``update_by_key`` ({dtype_name: update}) in place of the factory,
        its int8 tail its own ``dequant`` if it has one; ``aux_by_key``
        ({dtype_name: tables}, CPU tensors): the update is the reference's
        table form (``optim/protocol.py::make_combined_update``), called
        on the worker mean with the tables' part at the strip, its slots
        copied back in place, and no fused int8 tail."""
        make = update_fn or self.update_fn
        specs = self.exchange_slots if slot_specs is None else slot_specs
        encoded = self.wire.error_feedback or self.wire_dcn is not None
        if encoded:
            if not specs or specs[-1].name != WIRE_EF_SLOT:
                raise ValueError(
                    f"encoded wire {self.wire.name!r} expects the "
                    f"{WIRE_EF_SLOT!r} residual as the last slot spec; got "
                    f"{[s.name for s in specs]}")
            specs = specs[:-1]
        names = tuple(s.name for s in specs)
        st, comm, windows = (self.tc.strategy, self.comm,
                             self.tc.pipeline_windows)
        new_p, new_opt = {}, {}
        with torch.no_grad():
            for g in (self.plan.groups if groups is None
                      else tuple(groups.values())):
                slots = tuple(opt[g.key][n].view(-1) for n in names)
                p = flats_p.pop(g.key)
                over = update_by_key is not None or aux_by_key is not None
                upd = update_by_key[g.key] if update_by_key else make(g)
                if aux_by_key is not None:
                    upd = _table_update(upd, aux_by_key[g.key])
                if ready and g.key in ready:
                    p2, s2, *r2 = ready[g.key].finish()
                elif self.wire.error_feedback:
                    p2, s2, *r2 = run_wire_exchange(
                        st, comm, gbuf[g.key], p, slots, upd, g,
                        windows=windows, n_live=n_live,
                        **self._wire_args(g, opt, n_live,
                                          upd if over else None))
                elif encoded:
                    p2, s2, *r2 = run_dcn_exchange(
                        st, comm, gbuf[g.key], p, slots, upd, g,
                        windows=windows, n_live=n_live,
                        **self._wire_args(g, opt, n_live))
                else:
                    p2, s2 = run_exchange(st, comm, gbuf[g.key], p, slots,
                                          upd, g, windows, n_live)
                del p
                new_p[g.key] = p2
                new_opt[g.key] = {n: v.view(opt[g.key][n].shape)
                                  for n, v in zip(names, s2)}
                if encoded:
                    new_opt[g.key][WIRE_EF_SLOT] = r2[0].view(
                        opt[g.key][WIRE_EF_SLOT].shape)
        return new_p, new_opt

    # --------------------------------------------------- standalone PushPull

    def push_pull(self, grads: dict, params: dict, opt: dict):
        """Fused push(gradients) + pull(new parameters) on caller trees.
        ``grads``: leaves ``(local_workers, *leaf)``, this process's
        pushes (flattened into ``grad_buffers`` row by row); ``params``:
        the parameter tree, written in place (under ``no_grad``); ``opt``:
        the state from ``init_state``.  Returns (params, opt')."""
        self._require_plan()
        return self._dispatch(self._push_pull_tree, grads, params, opt)

    def push_pull_flat(self, gstore: dict, pstore: dict, opt: dict):
        """Flat-residency push/pull: ``pstore`` {dtype_name: (padded,)}
        (``flatten``), ``gstore`` {dtype_name: (local_workers, padded)}
        rows, used as the exchange's scratch (hierarchical's in-pod adds
        and a membership's zeroed rows write them).  No flatten or
        write-back runs.  Returns (pstore', opt')."""
        self._require_plan()
        W = self.comm.local_workers()
        for g in self.plan.groups:
            if tuple(gstore[g.key].shape) != (W, g.padded) or \
                    tuple(pstore[g.key].shape) != (g.padded,):
                raise ValueError(
                    f"group {g.key}: gstore {tuple(gstore[g.key].shape)} "
                    f"and pstore {tuple(pstore[g.key].shape)} are not "
                    f"({W}, {g.padded}) and ({g.padded},)")
        return self._dispatch(self._exchange, gstore, dict(pstore), opt)

    def _dispatch(self, fn, *args):
        fn = dispatched(fn)
        with get_tracer().span("exchange/push_pull"):
            if self.watchdog is not None:
                return self.watchdog.run(fn, *args)
            return fn(*args)

    def _push_pull_tree(self, grads: dict, params: dict, opt: dict):
        gbuf = self.grad_buffers()
        W = self.comm.local_workers()
        leaves = dict(chunking.leaf_paths(grads))
        for path, g in leaves.items():
            if g.shape[0] != W:
                raise ValueError(f"gradient {path} has {g.shape[0]} pushes "
                                 f"on its leading axis, this process holds "
                                 f"{W} workers")
        with torch.no_grad():
            for w in range(W):
                chunking.flatten_leaves(
                    self.plan, {p: g[w] for p, g in leaves.items()},
                    out={k: v[w] for k, v in gbuf.items()})
        del leaves
        new_p, new_opt = self._exchange(gbuf, self.flatten(params), opt)
        self.write_params(params, new_p)
        return params, new_opt

    def _exchange(self, gbuf: dict, flats_p: dict, opt: dict):
        """The membership's push gate, chunk-ready dispatch of the
        finished push when configured, then ``exchange_flats``."""
        mask, n_live = self._gate
        if mask is not None:
            self.mask_rows(gbuf, mask)
        ready = None
        if self.tc.overlap_backward:
            require_stacked(self.comm, "chunk-ready dispatch")
            ready = {}
            for g in self.plan.groups:
                ex = self.chunk_ready(g, gbuf, flats_p[g.key], opt, n_live)
                if ex is not None:
                    for i in range(len(g.paths)):
                        ex.leaf_ready(i)
                    ready[g.key] = ex
        return self.exchange_flats(gbuf, flats_p, opt, n_live, ready)

    # ------------------------------------------------------------ accounting

    def registered_bytes(self) -> int:
        """Unpadded bytes this client exchanges per push_pull."""
        if self.plan is None:
            return 0
        return sum(g.total * g.dtype.itemsize for g in self.plan.groups)
