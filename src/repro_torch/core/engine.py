"""PHubEngine: the PHub train step on one device (``repro/core/engine.py``).

The step for W workers stacked on one card (``core/comm.py``):

1. each worker runs forward and backward on its slice B/W of the batch
   (``torch.autograd.grad`` on the shared parameters) and its gradient is
   flattened into row w of a ``(W, padded)`` buffer per dtype group — one
   worker's autograd gradients are freed before the next worker runs;
2. the exchange runs the rule's fused aggregate + update over that buffer
   through the engine's ``PHubClient`` (``core/client.py``: the engine is
   its thin consumer, as the reference's is; ``exchange_flats`` holds the
   dispatch over strategies, wires and windows): ``core/exchange.py``
   (``TrainConfig.strategy``: sharded_ps, hierarchical, allreduce or
   centralized_ps), through the rule's CUDA kernel: Nesterov through
   ``agg_opt_chunks`` (W == 1) or ``multi_agg_opt_chunks`` (W > 1), SGD
   through ``sgd_opt_chunks`` and Adam through ``adam_opt_chunks`` (any
   W); for W > 1 the kernel folds the reduce-scatter's sum and the /W
   into the update (hierarchical: the in-pod partials are added into each
   pod's first row first, and the kernel sums the P partial rows and
   divides by N);
3. the new parameters are unflattened back into the module in place (the
   all-gather is a no-op on one card).

Under an encoded wire (``TrainConfig.wire_format``, ``core/wire.py``) the
client's step 2 is the encoded exchange of ``core/pipeline.py``: the ring
partials hop the stacked workers encoded (inside each pod under
hierarchical), the int8 tail runs through ``dequant_agg_opt_chunks``
(Nesterov, no cross-pod leg) or is decoded for the rule's kernel, the
pull's parameter delta is encoded, and the parameters written back are p
plus the decoded delta; the optimizer state then has one more slot,
``wire_ef``, last.  Under an encoded DCN tier
(``TrainConfig.wire_format_dcn``, hierarchical only) with the identity
ICI wire, each pod's partial plus its residual crosses the pods encoded,
and ``wire_ef`` holds each pod's residual (``PHubClient.slot_shape``: P
rows a shard on the stacked Comm).

PHub's gradient processing pipeline (``TrainConfig``'s
``pipeline_windows``, ``flat_residency``, ``overlap_backward``;
``core/pipeline.py``), over every wire (an encoded one runs each window's
ring and tail, then one pull):
- windows: step 2 runs window by window (one launch per window and shard,
  the strips read in place in the stacked buffer) when the group has more
  than one effective window, else the monolithic exchange, unchanged;
- flat residency: the parameters are views of a flat store
  ``{dtype_name: (1, padded)}`` (``DecoderLM.flat_store``, made by
  ``resident``); the exchange takes the store as p, and the kernel's new
  p' becomes the next store, the parameters re-pointed at its views: no
  flatten before the exchange, no write-back after it;
- chunk-ready dispatch: workers 0..W-2 fill their rows as in step 1; the
  last worker's gradients are copied into its row leaf by leaf from
  autograd hooks as its backward produces them, and each window's update
  goes on a side CUDA stream once every leaf that meets its strips has
  arrived (``pipeline.ChunkReadyExchange``).  The sanity gate's verdict
  needs the whole backward, and a membership that excludes the last
  worker needs its row zeroed, so both dispatch after the backward.
Every mode runs the same arithmetic per element, so all of them equal the
monolithic tree-resident step bitwise.

The reported loss is the mean over the workers, as the reference's
``pmean``.

Gradient accumulation (``TrainConfig.microbatch`` = k > 1, the reference's
``_local_grads``): each worker's slice splits into k microbatches in order,
and its gradient accumulates as ``a + g / k`` in f32 (an f32 scratch for a
bf16 leaf, cast to the leaf's dtype once at the end) and its loss as
``sum(loss / k)``; the exchange runs once a step on the accumulated rows.
Every path takes it: the stacked step in every mode, a process-group rank
(local work only) and the co-step (each tenant its own k).  Under
chunk-ready dispatch with k > 1 the last worker's gradient is the sum of
its microbatches, so its rows join after its backward, as under the gate.

The ``fsdp_stream`` strategy (the reference's ``fsdp`` layout,
``core/sharding.py``) has no chunk domain.  The reference splits each large
leaf over ``data``, all-gathers a layer's shards in the forward (the Pull)
and reduce-scatters its gradient in the backward (the Push).  On the
stacked Comm the W shards of a leaf lie side by side and are the whole
leaf, so the Pull is the identity; each worker's backward accumulates into
one gradient a leaf (``.grad``, in worker order: the Push reduced inside
the backward, never W rows); then, leaf by leaf, ``g / N`` and the rule
through its CUDA kernel on the flattened leaf (``agg_opt_chunks``,
``sgd_opt_chunks`` or ``adam_opt_chunks`` at W = 1, the ragged tail
masked), replicated and split leaves alike (the reference's ``psum / N``).
The optimizer state is ``{slot: tree}``, the reference's
``opt_state_shapes``; the parameters are re-pointed at the kernel's p'.
It refuses what the reference refuses: flat residency, windows,
chunk-ready dispatch and encoded wires, a membership that is not all live,
the sanity gate, the zero-compute step, ``PHubClient`` and co-scheduling;
over a process group it raises (ROADMAP.md queue A item 4b).

Over a process group (``core/comm.py::ProcessGroupComm``, one worker a
process, ``launch/dist.py``) the step is the same with one local worker:
this rank takes its slice ``[rank*B/W, (rank+1)*B/W)`` of the global batch
(every rank draws the same batch and the same weights from the seed),
fills a ``(1, padded)`` gradient row, and keeps the slots of the one shard
it owns, ``(1, L)`` each (allreduce: the whole vector on every rank;
centralized_ps: on rank 0 only); the exchange pushes, updates and pulls
(``core/exchange.py``, ``core/pipeline.py``), so every rank ends the step
with the whole new parameter vector.  Ranks are pod-major: rank r is the
worker (pod r // D, data r % D), and it takes batch slice r.  The loss
is the mean of the all-gathered per-worker losses in worker order (not
an ``all_reduce``, whose order is the library's), so it equals the
stacked step's bitwise.
A static k-of-n membership zeroes an excluded rank's own row.  The sanity
gate, chunk-ready dispatch, the supervisor and checkpoints raise there
(ROADMAP.md queue A item 4b).

An elastic ``Membership`` (``make_train_step(membership=)``, over W = P·D
workers) that is not all live zeroes each excluded worker's row before
the exchange and divides the mean by the live count (the k-of-n push
mask): a zeroed row adds exactly zero to the in-pod and cross-pod sums of
every strategy.  The sanity-gated step
(``make_train_step(sanity=)``, the reference's ``sane_step``) takes a
fourth input ``health`` and, after every worker's backward: multiplies
each row by its chaos ``inject`` factor; reduces every row to its f32 sum
of squares (``health_chunks``, one launch per dtype group); marks a worker
ok when the sum is finite and its root within ``norm_hi`` (and the
membership counts it); zeroes a bad row (where-semantics: 0 * NaN would be
NaN); and divides the mean by ``max(ok count, 1)``, kept on the card, so
the step needs no host sync.  Over an encoded wire a static membership
passes its live count by value (the int8 tail kernel bakes ``1/n_live``,
as the reference's does), and the gate's count on the card goes to the
tail kernel's divisor pointer (the reference takes its jnp tail there,
``/ n_live``, the same arithmetic); the rules without a tail kernel
divide the decoded sum by the count.

Co-scheduled tenants (``make_co_train_step``, the reference's; §3.1
multi-tenancy, driven by ``core/api.py::PHubConnectionManager``): every
attached tenant's W workers run forward and backward in turn, each
worker's gradients written straight into its row of the packed ``(W,
padded)`` buffer of the shared tenant domain (``chunking.pack_domains``);
a static membership zeroes the excluded rows; one ``exchange_flats`` over
the packed groups, with the tenants' union slots, runs each tenant's own
rule kernel on its own runs at its own coefficients
(``optim/protocol.py::RunUpdate``); each tenant's p' is written back into
its module.  A co-scheduled tenant therefore equals its solo run bitwise
over the identity wire (each chunk is the same elementwise rule over the
same worker rows); over the int8 wire the packed layout moves a tenant's
chunks to other owner shards, whose ring starts at another worker, so
the re-quantized partials differ from the solo run's.

Every ported family trains: the attention-free (ssm) family through
autograd of its chunked scan (``models/rwkv.py::rwkv_chunked``), as the
reference trains it without Pallas; the scan kernel serves only (the
reference has no backward for it).  Serving (``make_prefill_step``,
``make_serve_step``) runs the model's prefill and decode forwards on one
card, for every ported family; the launcher builds the engine with
``StackedComm(1)``.

The ZeroComputeEngine (``make_zero_compute_step``, §4.4) is the train
step with the forward and backward replaced by the reference's synthetic
push ``p * 1e-4``: the exchange alone, PHub's throughput probe
(``launch/train.py --telemetry``, ``tuning/calibrate.py``).  Every step
function the engine hands out runs under the ``engine/dispatch``
telemetry span (``client.dispatched``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, TrainConfig
from ..kernels.agg_opt.ops import fused_health_scan
from ..kernels.agg_opt.ref import sqrt_rn
from ..models import DecoderLM, chunked_cross_entropy, param_specs
from ..optim.protocol import RuleBinding, _tree_map, \
    make_combined_update, make_run_update, make_sharded_optimizer, \
    union_slots
from . import chunking
from .client import PHubClient, dispatched
from .comm import require_stacked
from .exchange import check_strategy, check_wire
from .pipeline import check_pipeline
from .sharding import plan_params
from .wire import exchange_extra_slots, make_dcn_wire_format, \
    make_wire_format

FSDP = "fsdp_stream"


class PHubEngine:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, comm, *,
                 device="cuda"):
        check_pipeline(tc)
        check_strategy(tc.strategy)
        self.cfg, self.tc, self.comm = cfg, tc, comm
        self.device = torch.device(device)
        specs = param_specs(cfg)
        # the reference's parameter layout over its (pod, data, model) mesh
        sizes = {"data": comm.pod_size, "model": 1}
        axes = ("data", "model")
        if comm.pods > 1:
            sizes["pod"], axes = comm.pods, ("pod",) + axes
        self.plan = plan_params(specs, mesh_axes=axes, axis_sizes=sizes,
                                layout="fsdp" if tc.strategy == FSDP
                                else "replicated")
        self._side = None
        if tc.strategy == FSDP:
            require_stacked(comm, "the fsdp_stream strategy")
            self.wire = make_wire_format(tc)
            self.wire_dcn = make_dcn_wire_format(tc)
            check_wire(tc.strategy, self.wire, self.wire_dcn)
            # no chunk domain: the rule runs leaf by leaf
            self.client = self.chunk_plan = self.store_layout = None
            self.sopt = make_sharded_optimizer(tc)
            self.exchange_slots = self.sopt.slots
            return
        # the exchange, its slots and its buffers are the client's
        self.client = PHubClient(tc, comm, device=device).register(specs)
        self.chunk_plan = self.client.plan
        self.sopt = self.client.sopt
        self.wire, self.wire_dcn = self.client.wire, self.client.wire_dcn
        self.exchange_slots = self.client.exchange_slots
        self.store_layout = chunking.build_store_layout(self.chunk_plan, {},
                                                        1)

    # ------------------------------------------------------------------ state

    def slot_shape(self, group, spec) -> tuple[int, int]:
        """(rows, state_len) of one slot in this process
        (``PHubClient.slot_shape``)."""
        return self.client.slot_shape(group, spec)

    def init_opt(self) -> dict:
        """Zero optimizer slots (``PHubClient.init_state``): {dtype_name:
        {slot_name: (rows, state_len)}}, ``wire_ef`` last under an encoded
        wire or DCN tier; under fsdp_stream {slot_name: tree of zeros like
        the parameters}, each leaf in its slot's dtype."""
        if self.tc.strategy == FSDP:
            return {s.name: _tree_map(
                        lambda p, s=s: torch.zeros(
                            p.shape, dtype=s.resolve_dtype(p.dtype),
                            device=self.device), param_specs(self.cfg))
                    for s in self.exchange_slots}
        return self.client.init_state()

    def init_model(self, seed: int | None = None) -> DecoderLM:
        """Fresh weights drawn from ``seed`` (default ``tc.seed``), resident
        as the engine keeps them (``resident``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.tc.seed if seed is None else seed)
        return self.resident(DecoderLM(self.cfg, device=self.device,
                                       generator=gen))

    def init_state(self, seed: int | None = None):
        """(model, opt): fresh weights drawn from ``seed`` (default
        ``tc.seed``) and zero optimizer slots."""
        return self.init_model(seed), self.init_opt()

    # --------------------------------------------------------- flat residency

    def resident(self, model: DecoderLM) -> DecoderLM:
        """The model as this engine trains it: under flat residency its
        parameters are moved into a new flat store (one copy, the pad
        zero) and become views of it; otherwise, or when they already
        are, the model as it is."""
        if self.tc.flat_residency and model.flat_store is None:
            with torch.no_grad():
                store = self.store_layout.from_tree(model.param_tree())
            self._adopt_store(model, store)
        return model

    def _adopt_store(self, model: DecoderLM, store: dict) -> None:
        """Re-point every parameter at its view of ``store``."""
        views = dict(chunking.leaf_paths(
            self.store_layout.to_tree(store, model.param_tree())))
        with torch.no_grad():
            for path, param in chunking.leaf_paths(model.param_tree()):
                param.data = views[path]
        model.flat_store = store

    def _flat_params(self, model: DecoderLM) -> dict:
        """{dtype_name: (padded,)} parameters for the exchange: the store's
        row under flat residency, a fresh flatten of the tree otherwise."""
        if not self.tc.flat_residency:
            return self.client.flatten(model.param_tree())
        if model.flat_store is None:
            raise ValueError("flat_residency: the model's parameters are not "
                             "views of a flat store; pass it through "
                             "PHubEngine.resident first")
        return {k: v[0] for k, v in model.flat_store.items()}

    def _write_params(self, model: DecoderLM, new_p: dict) -> None:
        """The exchange's new parameters into the model: the next store
        under flat residency, copied into the leaves otherwise."""
        if self.tc.flat_residency:
            self._adopt_store(model, {k: v.view(1, -1)
                                      for k, v in new_p.items()})
            return
        self.client.write_params(model.param_tree(), new_p)

    # ------------------------------------------------------------ train step

    def build_loss_fn(self):
        """Per-worker loss ``loss_fn(model, tokens, labels[, extra_embeds])
        -> (total, loss)`` (the reference's ``build_loss_fn``): forward +
        chunked cross-entropy ``loss``; with ``extra_embeds`` (B, F, d) the
        labels get a -1 (masked) prefix of length F; ``total`` adds
        ``router_aux_weight`` times the experts' load-balance loss (with
        no experts it is ``loss``).  The gradient is ``total``'s, the
        step's reported loss ``loss``."""
        cfg, tc = self.cfg, self.tc

        def loss_fn(model: DecoderLM, tokens, labels, extra_embeds=None):
            out = model(tokens, extra_embeds=extra_embeds, remat=tc.remat,
                        with_aux=bool(cfg.n_experts))
            x, aux = out if cfg.n_experts else (out, None)
            if extra_embeds is not None:
                prefix = labels.new_full(
                    (labels.shape[0], extra_embeds.shape[1]), -1)
                labels = torch.cat([prefix, labels], dim=1)
            loss = chunked_cross_entropy(x, model.lm_head_weight(), labels,
                                         chunk=tc.loss_chunk)
            if not cfg.n_experts:
                return loss, loss
            return loss + cfg.router_aux_weight * aux, loss
        return loss_fn

    def local_grads(self, loss_fn, model: DecoderLM, batch: dict, sl: slice,
                    leaves) -> tuple:
        """(total, loss, grads) of one worker's slice ``sl`` of ``batch``,
        ``grads`` a tuple over ``leaves``: with ``tc.microbatch`` k > 1 the
        reference's accumulation (``_local_grads``): k microbatches of the
        slice in order, ``a + g / k`` in f32 for a bf16 leaf (cast back
        once) and in the leaf's dtype otherwise, ``total`` and ``loss``
        summed as ``x / k`` in f32.  The divisions are by a 0-dim tensor
        on the device (correctly rounded, as the reference's)."""
        k = self.tc.microbatch
        if k <= 1:
            total, loss = worker_loss(loss_fn, model, batch, sl)
            return total, loss, torch.autograd.grad(total, leaves)
        n = sl.stop - sl.start
        if n % k:
            # the reference's reshape of the slice into (k, n // k, ...)
            raise TypeError(f"cannot reshape a worker slice of {n} rows "
                            f"into {k} microbatches of {n // k}")
        mb = n // k
        k_t = torch.tensor(float(k), dtype=torch.float32, device=self.device)
        tot_a = torch.zeros((), dtype=torch.float32, device=self.device)
        loss_a = torch.zeros((), dtype=torch.float32, device=self.device)
        acc = [torch.zeros(l.shape, dtype=(torch.float32
                                           if l.dtype == torch.bfloat16
                                           else l.dtype), device=l.device)
               for l in leaves]
        for i in range(k):
            part = slice(sl.start + i * mb, sl.start + (i + 1) * mb)
            total, loss = worker_loss(loss_fn, model, batch, part)
            grads = torch.autograd.grad(total, leaves)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    a.add_(g / k_t)
            del grads
            tot_a = tot_a + total.detach().float() / k_t
            loss_a = loss_a + loss.detach().float() / k_t
        return tot_a, loss_a, tuple(a.to(l.dtype)
                                    for a, l in zip(acc, leaves))

    def update_fn(self, group):
        """The fused agg+opt for one dtype group, through the rule's CUDA
        kernel (``PHubClient.update_fn``)."""
        return self.client.update_fn(group)

    def grad_buffers(self) -> dict:
        """The stacked gradient buffers {dtype_name: (W, padded)} (one row
        over a process group): the client's, allocated once and shared by
        every step function of this engine (a step of another membership
        reuses them); the chunk-ready windows read their strips in
        place."""
        return self.client.grad_buffers()

    def side_stream(self):
        """The CUDA stream the chunk-ready windows run on (one per engine),
        or None on the CPU."""
        if self.device.type != "cuda":
            return None
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    def grad_sumsq(self, gbuf: dict) -> torch.Tensor:
        """(W,) f32 sum of squares of each worker's whole push through the
        health kernel, one launch per dtype group over the stacked
        buffer; the zero pad adds nothing, and a NaN/Inf anywhere in a
        row propagates into its entry."""
        return sum(fused_health_scan(gbuf[g.key], chunk_elems=g.chunk_elems)
                   for g in self.chunk_plan.groups)

    def sanity_gate(self, gbuf: dict, health: dict, sanity, mask):
        """The reference's ``sane_step`` between the backward and the
        exchange, on the stacked buffer in place: inject, scan, judge,
        zero the bad rows.  ``mask``: the membership's (W,) f32 mask on the
        card, or None.  Returns (ok_mask (W,), grad_norms (W,), n_live
        0-dim), all f32 on the card; nothing is copied to the card, so the
        host never waits for the backward here."""
        if sanity.allow_injection:
            inj = np.asarray(health["inject"], np.float32)
            for w in range(self.comm.n_workers):
                if inj[w] != 1.0:           # g * 1 == g: a clean row stays
                    for v in gbuf.values():
                        # the factor in the row's dtype, as the reference's
                        # g * inj.astype(g.dtype)
                        v[w].mul_(float(torch.tensor(float(inj[w]),
                                                     dtype=v.dtype)))
        sumsq = self.grad_sumsq(gbuf)
        norms = sqrt_rn(sumsq)
        # norm_hi is an f32 value, so the comparison in f32 with it as a
        # kernel argument is exact (a tensor would be a copy to the card)
        okf = (torch.isfinite(sumsq)
               & (norms <= float(np.float32(health["norm_hi"])))).float()
        if mask is not None:
            okf = okf * mask
        bad = (okf == 0)[:, None]
        for v in gbuf.values():
            v.masked_fill_(bad, 0)
        return okf, norms, okf.sum().clamp_min(1.0)

    def exchange_stage(self, gbuf: dict, flats_p: dict, opt: dict,
                       n_live=None, ready=None):
        """The exchange of one step: ``PHubClient.exchange_flats`` with
        this engine's ``update_fn``."""
        return self.client.exchange_flats(gbuf, flats_p, opt, n_live, ready,
                                          update_fn=self.update_fn)

    def _chunk_ready_backward(self, loss, paths, leaves, gbuf, flats_p, opt,
                              n_live) -> dict:
        """The last worker's backward with chunk-ready dispatch: each
        leaf's gradient is copied into the last row of its group's buffer
        from an autograd hook as the backward produces it (in the
        backward's stream), and each window with more than one effective
        window starts once its leaves are in.  Returns {dtype_name:
        ChunkReadyExchange} for ``exchange_stage``; a group with one
        effective window is not in it and exchanges after the backward."""
        last = self.comm.n_workers - 1
        ready, where = {}, {}
        for g in self.chunk_plan.groups:
            row = gbuf[g.key][last]
            row[g.total:].zero_()
            ex = self.client.chunk_ready(g, gbuf, flats_p[g.key], opt,
                                         n_live, self.side_stream(),
                                         update_fn=self.update_fn)
            if ex is not None:
                ready[g.key] = ex
            for i, (path, off) in enumerate(zip(
                    g.paths, self.store_layout.offsets[g.key])):
                where[path] = (row, off, i, ex)

        def hook(path):
            row, off, i, ex = where[path]

            def copy_in(grad):
                row[off:off + grad.numel()].copy_(grad.reshape(-1))
                if ex is not None:
                    ex.leaf_ready(i)
            return copy_in

        handles = [leaf.register_hook(hook(path))
                   for path, leaf in zip(paths, leaves)]
        try:
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for h in handles:
                h.remove()
        del grads
        return ready

    def make_train_step(self, membership=None, sanity=None):
        """``step(model, opt, batch) -> (model, opt, metrics)``, or with
        ``sanity`` (a ``resilience.SanityConfig``) ``step(model, opt,
        batch, health)``: ``health["norm_hi"]`` the norm ceiling and, when
        ``sanity.allow_injection``, ``health["inject"]`` the (W,) gradient
        factors; its metrics add ``ok_mask`` and ``grad_norms`` (W,) and
        ``n_live``.  ``membership``: an elastic ``Membership`` whose
        excluded workers' pushes are masked.  The model is updated in
        place (saves a second copy of the weights; under flat residency
        its parameters are re-pointed at the new store); ``opt`` is
        replaced.  The steps share the engine's (W, padded) gradient
        buffers."""
        W = self.comm.n_workers
        local = self.comm.local_workers()
        first = self.comm.rank * local       # this process's first worker
        if self.tc.strategy == FSDP:
            return self._make_fsdp_step(membership, sanity)
        if sanity is not None:
            require_stacked(self.comm, "the sanity gate")
        if self.tc.overlap_backward:
            require_stacked(self.comm, "chunk-ready dispatch")
        cp = self.chunk_plan
        loss_fn = self.build_loss_fn()
        mask, live = self.client.elastic_mask(membership)
        # built once: a copy to the card in the step would make the host
        # wait for the backward before it queues the exchange
        mask_t = divisor = None
        if mask is not None:
            mask_t = torch.from_numpy(mask).to(self.device)
            divisor = self.client.live_divisor(live)
        # chunk-ready dispatch needs the last worker's push to join as it
        # is: the gate judges the whole backward, an excluded worker's row
        # must stay zero, and k microbatches' gradient is whole only after
        # the last one
        chunk_ready = (self.tc.overlap_backward and sanity is None
                       and (mask is None or mask[-1] == 1)
                       and self.tc.microbatch <= 1)
        gbuf = self.grad_buffers()

        def step(model: DecoderLM, opt: dict, batch: dict, health=None):
            B = batch["tokens"].shape[0]
            if B % W:
                raise ValueError(f"global batch {B} does not split over "
                                 f"{W} workers")
            bw = B // W
            paths, leaves = zip(*chunking.leaf_paths(model.param_tree()))
            losses = []
            for w in range(local - 1 if chunk_ready else local):
                sl = slice((first + w) * bw, (first + w + 1) * bw)
                _, loss, grads = self.local_grads(loss_fn, model, batch, sl,
                                                  leaves)
                chunking.flatten_leaves(cp, dict(zip(paths, grads)),
                                        out={k: v[w] for k, v in gbuf.items()})
                del grads
                losses.append(loss.detach())
            n_live = divisor
            metrics = {}
            if sanity is not None:
                ok, norms, n_live = self.sanity_gate(gbuf, health, sanity,
                                                     mask_t)
                metrics.update(ok_mask=ok, grad_norms=norms, n_live=n_live)
            elif mask is not None:
                self.client.mask_rows(gbuf, mask)
            flats_p = self._flat_params(model)
            ready = None
            if chunk_ready:
                sl = slice((W - 1) * bw, W * bw)
                total, loss = worker_loss(loss_fn, model, batch, sl)
                ready = self._chunk_ready_backward(total, paths, leaves, gbuf,
                                                   flats_p, opt, n_live)
                losses.append(loss.detach())
            metrics["loss"] = self.comm.gather_small(
                torch.stack(losses)).reshape(-1).mean()
            new_p, new_opt = self.exchange_stage(gbuf, flats_p, opt, n_live,
                                                 ready)
            self._write_params(model, new_p)
            return model, new_opt, metrics

        return dispatched(step)

    def _make_fsdp_step(self, membership, sanity):
        """The fsdp_stream step (module docstring): every worker's backward
        into one gradient a leaf, then ``g / N`` and the rule's kernel leaf
        by leaf.  Refuses the gate and a membership that is not all live
        with the reference's errors."""
        if membership is not None and not membership.all_live:
            raise ValueError(
                "elastic membership needs a chunk-domain strategy: "
                "fsdp_stream reduce-scatters gradients inside the backward "
                "scan, before the push site where the worker mask applies")
        if sanity is not None:
            raise ValueError(
                "gradient sanity masking needs a chunk-domain strategy: "
                "fsdp_stream reduce-scatters gradients inside the backward "
                "scan, before the push site where the health gate applies")
        W, tc = self.comm.n_workers, self.tc
        loss_fn = self.build_loss_fn()
        names = self.sopt.slot_names
        coefs = self.sopt.coefs(tc)
        updates = {}                    # by dtype: the rule's kernel
        n_t = torch.tensor(float(W), dtype=torch.float32, device=self.device)

        def update(leaf_dtype):
            if leaf_dtype not in updates:
                ce = tc.chunk_size_bytes // torch.empty(
                    (), dtype=leaf_dtype).element_size()
                updates[leaf_dtype] = self.sopt.kernel_update(ce, coefs)
            return updates[leaf_dtype]

        def step(model: DecoderLM, opt: dict, batch: dict):
            B = batch["tokens"].shape[0]
            if B % W:
                raise ValueError(f"global batch {B} does not split over "
                                 f"{W} workers")
            bw = B // W
            paths, leaves = zip(*chunking.leaf_paths(model.param_tree()))
            for leaf in leaves:
                leaf.grad = None
            losses, acc = [], None
            for w in range(W):
                sl = slice(w * bw, (w + 1) * bw)
                if tc.microbatch <= 1:
                    # the backward adds into .grad in worker order
                    total, loss = worker_loss(loss_fn, model, batch, sl)
                    total.backward()
                else:
                    _, loss, grads = self.local_grads(loss_fn, model, batch,
                                                      sl, leaves)
                    with torch.no_grad():
                        if acc is None:
                            acc = list(grads)
                        else:
                            for a, g in zip(acc, grads):
                                a.add_(g)
                    del grads
                losses.append(loss.detach())
            if acc is None:
                acc = [leaf.grad for leaf in leaves]
            metrics = {"loss": torch.stack(losses).mean()}
            slot_leaves = [dict(chunking.leaf_paths(opt[n])) for n in names]
            with torch.no_grad():
                for i, (path, leaf) in enumerate(zip(paths, leaves)):
                    g = acc[i].div_(n_t)
                    acc[i] = None
                    leaf.grad = None
                    p = leaf.detach()
                    p2 = torch.empty_like(p)
                    update(p.dtype)(p.view(-1), g.view(-1),
                                    tuple(s[path].view(-1)
                                          for s in slot_leaves),
                                    p_out=p2.view(-1))
                    del g
                    leaf.data = p2
            return model, opt, metrics

        return dispatched(step)

    def make_zero_compute_step(self, membership=None):
        """ZeroComputeEngine (§4.4): the exchange of a train step with the
        forward and backward replaced by a synthetic push, the reference's
        ``p * 1e-4`` in every live worker's row: pure PS throughput.
        ``step(model, opt) -> (model, opt')``; one call is one exchange
        step over this engine's whole chunk domain, through
        ``exchange_stage`` (every strategy, wire and window count of the
        tree-state step), the model updated in place as the train step
        updates it.  ``membership``: an elastic ``Membership`` whose
        excluded workers' rows are zeroed, the mean divided by the live
        count.  Flat residency raises, as in the reference (its step
        covers the tree-state chunk strategies)."""
        if self.tc.strategy == FSDP or self.tc.flat_residency:
            raise ValueError("zero-compute step covers the tree-state chunk "
                             "strategies")
        local = self.comm.local_workers()
        mask, live = self.client.elastic_mask(membership)
        n_live = None if mask is None else self.client.live_divisor(live)
        gbuf = self.grad_buffers()
        # the constant in each group's dtype, as the reference's
        # ``x * 1e-4`` takes it (a Python float is weakly typed in JAX)
        scale = {g.key: float(torch.tensor(1e-4, dtype=g.dtype))
                 for g in self.chunk_plan.groups}

        def step(model: DecoderLM, opt: dict):
            flats_p = self._flat_params(model)
            with torch.no_grad():
                for key, rows in gbuf.items():
                    for w in range(local):
                        torch.mul(flats_p[key], scale[key], out=rows[w])
            if mask is not None:
                self.client.mask_rows(gbuf, mask)
            new_p, new_opt = self.exchange_stage(gbuf, flats_p, opt, n_live)
            self._write_params(model, new_p)
            return model, new_opt

        return dispatched(step)

    # ------------------------------------------------------------ serve step

    @staticmethod
    def _last_logits(model: DecoderLM, x: torch.Tensor) -> torch.Tensor:
        """The last position's logits (B, V) f32, as the reference's
        ``x[:, -1].astype(f32) @ lm_head.astype(f32)``."""
        with torch.inference_mode():
            return x[:, -1].float() @ model.lm_head_weight().float()

    def make_prefill_step(self, seq_len: int, max_new_tokens: int = 0):
        """``prefill_step(model, tokens (B, seq_len), extra_embeds=None) ->
        (logits (B, V) f32, cache)``: the prompt, after the frontend's
        ``extra_embeds`` (B, F, d) when given, through ``DecoderLM.prefill``
        into a ring cache with room for ``max_new_tokens`` more."""
        def prefill_step(model: DecoderLM, tokens: torch.Tensor,
                         extra_embeds=None):
            if tokens.shape[1] != seq_len:
                raise ValueError(f"prompt of {tokens.shape[1]} tokens, the "
                                 f"step was made for {seq_len}")
            x, cache = model.prefill(tokens, extra_embeds=extra_embeds,
                                     max_new_tokens=max_new_tokens)
            return self._last_logits(model, x), cache
        return dispatched(prefill_step)

    def make_serve_step(self):
        """``serve_step(model, cache, tokens (B, 1)) -> (logits (B, V) f32,
        cache)``: one decode token; the cache is updated in place and
        returned."""
        def serve_step(model: DecoderLM, cache: dict, tokens: torch.Tensor):
            x = model.decode(tokens, cache)
            return self._last_logits(model, x), cache
        return dispatched(serve_step)


def worker_loss(loss_fn, model: DecoderLM, batch: dict, sl: slice):
    """(total, loss) of one worker's slice ``sl`` of ``batch``: its
    tokens, labels and, when the batch has them, frontend embeddings
    through ``loss_fn``."""
    extra = batch.get("extra_embeds")
    return loss_fn(model, batch["tokens"][sl], batch["labels"][sl],
                   *(() if extra is None else (extra[sl],)))


# ---------------------------------------------------- co-scheduled exchange

def co_slot_specs(tenants: dict) -> tuple:
    """The union of the attached tenants' optimizer slot sets (same-named
    slots share one packed buffer; each tenant touches only its own
    ranges), then the shared wire's exchange slots (``wire_ef``) last, so
    the rules' slot indices stay stable.  All attached tenants share one
    wire (checked at attach, ``core/api.py``)."""
    specs = union_slots([e.sopt for e in tenants.values()])
    e0 = next(iter(tenants.values()))
    return specs + exchange_extra_slots(e0.wire, e0.wire_dcn)


def co_opt_state_shapes(e0: PHubEngine, domain, slots) -> dict:
    """{dtype_name: {slot_name: meta tensor}}: one shared buffer per
    (dtype, slot) over the packed domain, in the engine's own layout
    (``PHubClient.slot_shape`` over the packed groups)."""
    return {key: {s.name: torch.empty(e0.slot_shape(g, s),
                                      dtype=s.resolve_dtype(g.dtype),
                                      device="meta")
                  for s in slots}
            for key, g in domain.groups.items()}


def _table_updates(tenants: dict, domain, slot_index: dict) -> tuple:
    """The reference's table form of every packed group ({key: update},
    {key: aux tables}): the tenants grouped by rule, a coefficient that
    differs within a rule as a per-position table, and per-rule mask
    tables when the rules differ (the reference's ``coef_update``)."""
    names = list(tenants)
    rules: dict = {}
    for ns in names:
        rules.setdefault(tenants[ns].sopt, []).append(ns)
    multi = len(rules) > 1
    upd_by_key, aux_by_key = {}, {}
    for key in domain.groups:
        aux, bindings = [], []
        for sopt, members in rules.items():
            coefs = []
            for i in range(len(sopt.coef_names)):
                vals = {ns: sopt.coefs(tenants[ns].tc)[i] for ns in members}
                if len(set(vals.values())) == 1:
                    coefs.append(next(iter(vals.values())))
                else:
                    aux.append(domain.coef_vector(
                        key, {ns: vals.get(ns, 0.0) for ns in names}))
                    coefs.append(("aux", len(aux) - 1))
            mask_idx = None
            if multi:
                aux.append(domain.coef_vector(
                    key, {ns: 1.0 if ns in members else 0.0
                          for ns in names}))
                mask_idx = len(aux) - 1
            bindings.append(RuleBinding(
                opt=sopt, slot_idx=tuple(slot_index[n]
                                         for n in sopt.slot_names),
                coefs=tuple(coefs), mask_aux=mask_idx))
        upd_by_key[key] = make_combined_update(bindings)
        aux_by_key[key] = tuple(aux)
    return upd_by_key, aux_by_key


def _write_pieces(pieces, leaves: dict, out: torch.Tensor) -> None:
    """Each leaf's pieces into the packed vector ``out`` in place."""
    for path, loff, poff, n in pieces:
        out[poff:poff + n].copy_(leaves[path].reshape(-1)[loff:loff + n])


def make_co_train_step(tenants: dict, domain, membership=None, *,
                       gbuf: dict | None = None, tables: bool = False):
    """One step over every attached tenant (§3.1 multi-tenancy).

    ``tenants``: {namespace: PHubEngine}, already checked compatible (one
    Comm, one device, one exchange signature); ``domain``: the
    ``TenantPackedDomain`` over their chunk plans.  Each tenant's workers
    run forward and backward in turn, as the solo step's do, and each
    worker's gradients go straight into its row of the packed ``(local
    workers, padded)`` buffer (``gbuf``: a dict the buffers are allocated
    into once and shared by every step of this domain); the parameters
    are written into one packed vector the same way.  ``membership``: the
    rack's live set, one worker mask for every tenant: excluded rows are
    zeroed and the shared mean divides by the live count.  One
    ``exchange_flats`` runs over the packed groups with the tenants' union
    slots and ``RunUpdate`` (each tenant's rule kernel on its own runs);
    ``tables`` (CPU tensors only) takes the reference's table form
    instead.  Each tenant's p' is written back into its module in place.

    Returns ``step(models, packed_opt, batches) -> (models, packed_opt',
    metrics)``, {namespace: ...} each; the metrics hold each tenant's
    loss, the mean over its workers."""
    names = list(tenants)
    e0 = tenants[names[0]]
    tc0, comm = e0.tc, e0.comm
    if tc0.overlap_backward:
        raise ValueError(
            "co-scheduled tenants pack every tenant's full flat gradient "
            "into one shared domain before the exchange; the chunk-ready "
            "per-window assembly (overlap_backward) has no packed-domain "
            "seam yet — train tenants solo or drop overlap_backward")
    if tc0.flat_residency:
        raise NotImplementedError(
            "co-scheduling runs on tree-state tenants; flat_residency "
            "stores are not packed yet (DESIGN.md §9)")
    W, local = comm.n_workers, comm.local_workers()
    first = comm.rank * local
    mask, live = e0.client.elastic_mask(membership)
    divisor = None if mask is None else e0.client.live_divisor(live)
    slot_specs = co_slot_specs(tenants)
    slot_index = {s.name: i for i, s in enumerate(slot_specs)}
    if tables:
        upd_by_key, aux_by_key = _table_updates(tenants, domain,
                                                slot_index)
    else:
        aux_by_key = None
        upd_by_key = {
            key: make_run_update([RuleBinding(
                opt=tenants[sl.tenant].sopt,
                slot_idx=tuple(slot_index[n]
                               for n in tenants[sl.tenant].sopt.slot_names),
                coefs=tenants[sl.tenant].sopt.coefs(tenants[sl.tenant].tc),
                runs=tuple((poff, n) for _, poff, n in sl.runs))
                for sl in pg.slots], pg)
            for key, pg in domain.groups.items()}
    # per tenant and group: the leaves' pieces in the packed domain, and
    # the packed pieces that stay zero (its chunk tail)
    pieces = {ns: {g.key: domain.leaf_pieces(g.key, ns, g)
                   for g in tenants[ns].chunk_plan.groups}
              for ns in names}
    zero = {key: pg.pad_runs() + tuple(
                z for ns in names if key in pieces[ns]
                for z in pieces[ns][key][1])
            for key, pg in domain.groups.items()}
    loss_fns = {ns: tenants[ns].build_loss_fn() for ns in names}
    gbuf = {} if gbuf is None else gbuf

    def buffers() -> dict:
        if not gbuf:
            gbuf.update({key: torch.zeros((local, pg.padded), dtype=pg.dtype,
                                          device=e0.device)
                         for key, pg in domain.groups.items()})
        return gbuf

    def packed_params(models: dict) -> dict:
        flats = {}
        for key, pg in domain.groups.items():
            out = torch.empty(pg.padded, dtype=pg.dtype, device=e0.device)
            for off, n in zero[key]:
                out[off:off + n].zero_()
            flats[key] = out
        with torch.no_grad():
            for ns in names:
                leaves = dict(chunking.leaf_paths(models[ns].param_tree()))
                for key, (pcs, _) in pieces[ns].items():
                    _write_pieces(pcs, leaves, flats[key])
        return flats

    def step(models: dict, opt: dict, batches: dict):
        buf = buffers()
        metrics = {}
        for ns in names:
            model = models[ns]
            B = batches[ns]["tokens"].shape[0]
            if B % W:
                raise ValueError(f"tenant {ns!r}: global batch {B} does not "
                                 f"split over {W} workers")
            bw = B // W
            paths, leaves = zip(*chunking.leaf_paths(model.param_tree()))
            losses = []
            for w in range(local):
                sl = slice((first + w) * bw, (first + w + 1) * bw)
                _, loss, grads = tenants[ns].local_grads(
                    loss_fns[ns], model, batches[ns], sl, leaves)
                grads = dict(zip(paths, grads))
                with torch.no_grad():
                    for key, (pcs, _) in pieces[ns].items():
                        _write_pieces(pcs, grads, buf[key][w])
                del grads
                losses.append(loss.detach())
            metrics[ns] = {"loss": comm.gather_small(
                torch.stack(losses)).reshape(-1).mean()}
        with torch.no_grad():
            for key, rows in buf.items():
                for off, n in zero[key]:
                    rows[:, off:off + n].zero_()
        if mask is not None:
            e0.client.mask_rows(buf, mask)
        new_p, new_opt = e0.client.exchange_flats(
            buf, packed_params(models), opt, divisor,
            groups=domain.groups, slot_specs=slot_specs,
            update_by_key=upd_by_key, aux_by_key=aux_by_key)
        with torch.no_grad():
            for ns in names:
                leaves = dict(chunking.leaf_paths(models[ns].param_tree()))
                for key, (pcs, _) in pieces[ns].items():
                    flat = new_p[key]
                    for path, loff, poff, n in pcs:
                        leaves[path].view(-1)[loff:loff + n].copy_(
                            flat[poff:poff + n])
        return models, new_opt, metrics

    return dispatched(step)
