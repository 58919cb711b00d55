"""PHubEngine: the PHub train step on one device (``repro/core/engine.py``).

The step for W workers stacked on one card (``core/comm.py``):

1. each worker runs forward and backward on its slice B/W of the batch
   (``torch.autograd.grad`` on the shared parameters) and its gradient is
   flattened into row w of a ``(W, padded)`` buffer per dtype group — one
   worker's autograd gradients are freed before the next worker runs;
2. the exchange (``core/exchange.py``) runs the rule's fused aggregate +
   update over that buffer, through its CUDA kernel: Nesterov through
   ``agg_opt_chunks`` (W == 1) or ``multi_agg_opt_chunks`` (W > 1), SGD
   through ``sgd_opt_chunks`` and Adam through ``adam_opt_chunks`` (any W);
   for W > 1 the kernel folds the reduce-scatter's sum and the /W into the
   update;
3. the new parameters are unflattened back into the module in place (the
   all-gather is a no-op on one card).

Under an encoded wire (``TrainConfig.wire_format``, ``core/wire.py``) step
2 is ``core/pipeline.py::run_wire_exchange`` instead: the ring partials
hop the stacked workers encoded, the int8 tail runs through
``dequant_agg_opt_chunks`` (Nesterov) or is decoded for the rule's kernel,
the pull's parameter delta is encoded, and the parameters written back are
p plus the decoded delta; the optimizer state then has one more slot,
``wire_ef``, last.

The reported loss is the mean over the workers, as the reference's
``pmean``.

An elastic ``Membership`` (``make_train_step(membership=)``) that is not
all live zeroes each excluded worker's row before the exchange and divides
the mean by the live count (the k-of-n push mask).  The sanity-gated step
(``make_train_step(sanity=)``, the reference's ``sane_step``) takes a
fourth input ``health`` and, after every worker's backward: multiplies
each row by its chaos ``inject`` factor; reduces every row to its f32 sum
of squares (``health_chunks``, one launch per dtype group); marks a worker
ok when the sum is finite and its root within ``norm_hi`` (and the
membership counts it); zeroes a bad row (where-semantics: 0 * NaN would be
NaN); and divides the mean by ``max(ok count, 1)``, kept on the card, so
the step needs no host sync.  Both run over the identity wire only.  Tree
residency and one window only; the reference's flat residency, windows
and the DCN wire are queued in ROADMAP.md.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, TrainConfig
from ..kernels.agg_opt.ops import fused_health_scan
from ..kernels.agg_opt.ref import sqrt_rn
from ..models import DecoderLM, chunked_cross_entropy, param_specs
from ..optim.protocol import make_sharded_optimizer
from . import chunking
from .comm import StackedComm
from .exchange import check_strategy, check_wire, exchange_group
from .pipeline import run_wire_exchange
from .wire import WIRE_EF_SLOT, exchange_extra_slots, make_wire_format


class PHubEngine:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, comm: StackedComm,
                 *, device="cuda"):
        check_strategy(tc.strategy)
        self.cfg, self.tc, self.comm = cfg, tc, comm
        self.device = torch.device(device)
        self.sopt = make_sharded_optimizer(tc)
        self.wire = make_wire_format(tc)
        check_wire(tc.strategy, self.wire)
        self.exchange_slots = (self.sopt.slots
                               + exchange_extra_slots(self.wire))
        self.chunk_plan = chunking.build_plan(
            param_specs(cfg), chunk_bytes=tc.chunk_size_bytes,
            n_shards=comm.n_shards(tc.strategy))
        self._gbuf = None

    # ------------------------------------------------------------------ state

    def init_opt(self) -> dict:
        """Zero optimizer slots: {dtype_name: {slot_name: (S, state_len)}},
        row s the state of the chunks shard s owns; as many slots as the
        rule declares (Nesterov 1, SGD 0, Adam 4) and, under an encoded
        wire, ``wire_ef`` last, each in its own dtype (Adam's k1/k2 and
        ``wire_ef`` are f32 in every group)."""
        st = self.tc.strategy
        S = self.comm.n_shards(st)
        return {g.key: {s.name: torch.zeros(
                            (S, self.comm.state_len(st, g.padded)),
                            dtype=s.resolve_dtype(g.dtype), device=self.device)
                        for s in self.exchange_slots}
                for g in self.chunk_plan.groups}

    def init_state(self, seed: int | None = None):
        """(model, opt): fresh weights drawn from ``seed`` (default
        ``tc.seed``) and zero optimizer slots."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.tc.seed if seed is None else seed)
        model = DecoderLM(self.cfg, device=self.device, generator=gen)
        return model, self.init_opt()

    # ------------------------------------------------------------ train step

    def build_loss_fn(self):
        """Per-worker loss: forward + chunked cross-entropy."""
        tc = self.tc

        def loss_fn(model: DecoderLM, tokens, labels):
            x = model(tokens, remat=tc.remat)
            return chunked_cross_entropy(x, model.lm_head_weight(), labels,
                                         chunk=tc.loss_chunk)
        return loss_fn

    def update_fn(self, group):
        """The fused agg+opt for one dtype group, through the rule's CUDA
        kernel."""
        return self.sopt.kernel_update(group.chunk_elems,
                                       self.sopt.coefs(self.tc))

    def fused_dequant(self, group):
        """The int8 wire's tail kernel for one group (decode + own rows +
        mean + rule), or None: another wire, or a rule without one."""
        if not self.wire.has_scales:
            return None
        return self.sopt.kernel_dequant_update(
            group.chunk_elems, self.sopt.coefs(self.tc),
            1.0 / self.comm.n_workers)

    def grad_buffers(self) -> dict:
        """The stacked gradient buffers {dtype_name: (W, padded)}, allocated
        once and shared by every step function of this engine (a step of
        another membership reuses them)."""
        if self._gbuf is None:
            W = self.comm.n_workers
            self._gbuf = {g.key: torch.zeros((W, g.padded), dtype=g.dtype,
                                             device=self.device)
                          for g in self.chunk_plan.groups}
        return self._gbuf

    def elastic_mask(self, membership):
        """(mask, n_live) for an elastic membership, or (None, None) on
        the static full-rack path: the all-live case runs the same step as
        no membership at all."""
        if membership is None or membership.all_live:
            return None, None
        membership.validate_world(self.comm.n_workers)
        membership.require_quorum()
        return membership.mask(), float(membership.n_live)

    @staticmethod
    def _masked_grads(gbuf: dict, mask: np.ndarray) -> None:
        """The k-of-n push gate: zero every excluded worker's row in place,
        so it adds exactly nothing to the worker sum."""
        for w in np.nonzero(mask == 0)[0]:
            for v in gbuf.values():
                v[w].zero_()

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

    def exchange_stage(self, gbuf: dict, model: DecoderLM, opt: dict,
                       n_live=None):
        """Flatten the parameters into the chunk domain, run the exchange
        per dtype group on the stacked gradients ``gbuf`` ({dtype_name:
        (W, padded)}), and write the new parameters back into ``model``.
        ``n_live`` (a number or a 0-dim tensor on the card) divides the
        worker sum instead of W.  Returns the new optimizer state.  A rule
        whose kernel updates its slots in place (Adam) returns the tensors
        of ``opt`` themselves: four model-sized vectors that are never
        allocated twice."""
        cp = self.chunk_plan
        leaves = dict(chunking.leaf_paths(model.param_tree()))
        names = self.sopt.slot_names
        encoded = self.wire.error_feedback
        new_opt = {}
        with torch.no_grad():
            flats_p = chunking.flatten_leaves(cp, leaves)
            for g in cp.groups:
                slots = tuple(opt[g.key][n].view(-1) for n in names)
                if encoded:
                    p2, s2, r2 = run_wire_exchange(
                        self.tc.strategy, self.comm, gbuf[g.key],
                        flats_p.pop(g.key), slots, self.update_fn(g), g,
                        self.wire, opt[g.key][WIRE_EF_SLOT].view(-1),
                        self.fused_dequant(g))
                else:
                    p2, s2 = exchange_group(self.comm, gbuf[g.key],
                                            flats_p.pop(g.key), slots,
                                            self.update_fn(g), n_live)
                new_opt[g.key] = {n: v.view(opt[g.key][n].shape)
                                  for n, v in zip(names, s2)}
                if encoded:
                    new_opt[g.key][WIRE_EF_SLOT] = r2.view(
                        opt[g.key][WIRE_EF_SLOT].shape)
                for path, new in chunking.group_leaves(g, p2).items():
                    leaves[path].copy_(new)
        return new_opt

    def make_train_step(self, membership=None, sanity=None):
        """``step(model, opt, batch) -> (model, opt, metrics)``, or with
        ``sanity`` (a ``resilience.SanityConfig``) ``step(model, opt,
        batch, health)``: ``health["norm_hi"]`` the norm ceiling and, when
        ``sanity.allow_injection``, ``health["inject"]`` the (W,) gradient
        factors; its metrics add ``ok_mask`` and ``grad_norms`` (W,) and
        ``n_live``.  ``membership``: an elastic ``Membership`` whose
        excluded workers' pushes are masked.  The model is updated in
        place (saves a second copy of the weights); ``opt`` is replaced.
        The steps share the engine's (W, padded) gradient buffers."""
        W = self.comm.n_workers
        cp = self.chunk_plan
        loss_fn = self.build_loss_fn()
        mask, live = self.elastic_mask(membership)
        # built once: a copy to the card in the step would make the host
        # wait for the backward before it queues the exchange
        mask_t = divisor = None
        if mask is not None:
            mask_t = torch.from_numpy(mask).to(self.device)
            divisor = torch.tensor(live, device=self.device)
        if (mask is not None or sanity is not None) and \
                not self.wire.is_identity:
            raise NotImplementedError(
                f"elastic membership and the sanity gate over the "
                f"{self.wire.name!r} wire are not ported yet: the int8 "
                f"tail kernel takes 1/N by value (ROADMAP.md queue A items "
                f"13 and 14)")
        gbuf = self.grad_buffers()

        def step(model: DecoderLM, opt: dict, batch: dict, health=None):
            tokens, labels = batch["tokens"], batch["labels"]
            B = tokens.shape[0]
            if B % W:
                raise ValueError(f"global batch {B} does not split over "
                                 f"{W} workers")
            bw = B // W
            paths, leaves = zip(*chunking.leaf_paths(model.param_tree()))
            losses = []
            for w in range(W):
                sl = slice(w * bw, (w + 1) * bw)
                loss = loss_fn(model, tokens[sl], labels[sl])
                grads = torch.autograd.grad(loss, leaves)
                chunking.flatten_leaves(cp, dict(zip(paths, grads)),
                                        out={k: v[w] for k, v in gbuf.items()})
                del grads
                losses.append(loss.detach())
            metrics = {"loss": torch.stack(losses).mean()}
            n_live = divisor
            if sanity is not None:
                ok, norms, n_live = self.sanity_gate(gbuf, health, sanity,
                                                     mask_t)
                metrics.update(ok_mask=ok, grad_norms=norms, n_live=n_live)
            elif mask is not None:
                self._masked_grads(gbuf, mask)
            new_opt = self.exchange_stage(gbuf, model, opt, n_live)
            return model, new_opt, metrics

        return step
