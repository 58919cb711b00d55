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
``pmean``.  Tree residency and one window only; the reference's flat
residency, windows, the DCN wire, sanity gate and elastic membership are
queued in ROADMAP.md.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, TrainConfig
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

    def exchange_stage(self, gbuf: dict, model: DecoderLM, opt: dict):
        """Flatten the parameters into the chunk domain, run the exchange
        per dtype group on the stacked gradients ``gbuf`` ({dtype_name:
        (W, padded)}), and write the new parameters back into ``model``.
        Returns the new optimizer state.  A rule whose kernel updates its
        slots in place (Adam) returns the tensors of ``opt`` themselves:
        four model-sized vectors that are never allocated twice."""
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
                                            self.update_fn(g))
                new_opt[g.key] = {n: v.view(opt[g.key][n].shape)
                                  for n, v in zip(names, s2)}
                if encoded:
                    new_opt[g.key][WIRE_EF_SLOT] = r2.view(
                        opt[g.key][WIRE_EF_SLOT].shape)
                for path, new in chunking.group_leaves(g, p2).items():
                    leaves[path].copy_(new)
        return new_opt

    def make_train_step(self):
        """``step(model, opt, batch) -> (model, opt, metrics)``.  The model
        is updated in place (saves a second copy of the weights); ``opt``
        is replaced.  The step owns the (W, padded) gradient buffers."""
        W = self.comm.n_workers
        cp = self.chunk_plan
        loss_fn = self.build_loss_fn()
        gbuf = {g.key: torch.zeros((W, g.padded), dtype=g.dtype,
                                   device=self.device) for g in cp.groups}

        def step(model: DecoderLM, opt: dict, batch: dict):
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
            new_opt = self.exchange_stage(gbuf, model, opt)
            return model, new_opt, {"loss": torch.stack(losses).mean()}

        return step
