"""The PHub service API (§3.1): multi-tenant rendezvous, namespaces and
the co-scheduler (``repro/core/api.py``).

PHub is multi-tenant: several training jobs share one rack-scale PS,
isolated by namespace and nonce.  ``create_service`` provisions an engine
for a job (over a Comm: ``StackedComm`` or a rank's ``ProcessGroupComm``,
on the card unless ``device="cpu"``), ``connect_service`` rendezvouses a
worker group onto it, and ``push_pull`` (the fused push-wait-pull) is a
solo tenant's train step.

The connection manager is a co-scheduler too: attached tenants are packed
into one shared rack chunk domain (``chunking.TenantPackedDomain``,
LPT-balanced across shards by ``partition.cochunk_counts``) and stepped
together by ``engine.make_co_train_step``, one exchange carrying every
tenant's gradients; tenants may mix optimizers, and the packed optimizer
state holds their union slot set.  Attach and detach re-pack the domain,
move every attached tenant's slots to its new positions (on the device)
and start a new step cache; attaching also frees the tenant's solo
gradient buffers and cached solo steps (which hold them), so a pair of
full-width tenants fits the card; destroy reclaims the tenant's chunk
ranges.
``accounting`` reports each tenant's bytes (``cost_model``).  Steps are
cached per (batch shapes, membership) as the reference caches its
compiled programs, here as closures; a re-pack that lands on a layout
seen before gets that layout's cache back.

Over a process group each rank runs the manager with its own
``ProcessGroupComm`` and keeps its own shard of the packed slots: fresh
tenants attach and co-step there, but moving optimizer state into, out
of or across a packed domain needs every shard and raises (ROADMAP.md
queue A item 4b).

``resize`` moves the rack to another world size (a new ``StackedComm``):
every engine is rebuilt on it, the caller-held solo states and the packed
slots move through the minimal-movement rebalance plan
(``elastic/rebalance.py``) on the device, and ``last_rebalance`` records
the migration traffic (``cost_model.rebalance_traffic``).  A process
group cannot change its world inside a process, so ``resize`` over a
``ProcessGroupComm`` raises (queue A item 4b).

Telemetry (``telemetry/``, the reference's instruments): ``push_pull``
runs under the span ``exchange/push_pull`` (``ns``) and ``co_step`` under
``exchange/co_step`` (``tenants``); each adds its tenants' bytes a step to
the counter ``exchange.bytes`` by tenant and basis (``raw``, and ``wire``
as encoded: ``cost_model.tenant_step_traffic``); every membership
transition emits a ``membership`` event and sets the ``membership.epoch``
gauge (``demote`` counts ``membership.demotions``); ``resize`` adds the
plan's bytes to ``rebalance.moved_bytes`` and emits a ``rebalance`` event.
Left out of the reference's manager: ``compile_count`` (ROADMAP.md queue
A item 10).
"""
from __future__ import annotations

import secrets
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..configs.base import ModelConfig, TrainConfig
from ..elastic import Membership, plan_rebalance
from ..elastic.rebalance import check_resizable, migrate_engine_state
from ..telemetry import get_registry, get_tracer
from . import cost_model
from .chunking import TenantPackedDomain, pack_domains
from .comm import require_stacked
from .engine import (PHubEngine, co_opt_state_shapes, co_slot_specs,
                     make_co_train_step)


@dataclass
class ServiceHandle:
    namespace: str
    nonce: str


@dataclass
class _Service:
    engine: PHubEngine
    nonce: str
    connected: int = 0
    steps: dict = field(default_factory=dict)


def _domain_key(domain: TenantPackedDomain) -> tuple:
    """A packed domain's layout as a key: two domains with equal keys run
    the same co-step, so a detach and re-attach that comes back to a
    layout gets its step cache back."""
    return (domain.tenants, domain.n_shards, domain.chunk_bytes,
            tuple((key, g.key, g.chunk_elems, g.shard_len,
                   tuple((s.tenant, s.total, s.padded, s.runs)
                         for s in g.slots))
                  for key, g in sorted(domain.groups.items())))


@dataclass
class _CoSchedule:
    """The shared rack chunk domain of the attached tenants."""
    domain: TenantPackedDomain
    opt: dict                   # packed slots {key: {slot: tensor}}
    acct: dict                  # ns -> static per-step accounting
    steps: dict = field(default_factory=dict)       # step cache
    traffic: dict = field(default_factory=dict)     # ns -> counters
    gbuf: dict = field(default_factory=dict)        # packed gradient rows


_TRAFFIC_KEYS = ("push_bytes", "pull_bytes", "wire_push_bytes",
                 "wire_pull_bytes")


class PHubConnectionManager:
    """In-process stand-in for the rack's connection manager."""

    def __init__(self):
        self._services: dict[str, _Service] = {}
        self._attached: list[str] = []      # co-scheduled namespaces
        self._co: Optional[_CoSchedule] = None
        # the elastic rack: sized from the first created service's
        # workers; every step cache keys on the live set's program key
        self._membership: Optional[Membership] = None
        self.last_rebalance: Optional[dict] = None
        self._watchdog = None
        # a solo tenant's raw and wire bytes a step, for the telemetry
        # counters; computed once per namespace and engine
        self._traffic_cache: dict[str, dict] = {}
        # each domain layout's (step cache, gradient buffers), so that a
        # re-pack back to a layout reuses its steps
        self._co_memo: dict = {}

    # ------------------------------------------------------ elastic rack

    @property
    def membership(self) -> Optional[Membership]:
        return self._membership

    def set_membership(self, membership: Membership) -> Membership:
        """Install a membership snapshot directly (``join``, ``leave``,
        ``mark_slow`` ... are the incremental transitions)."""
        if self._services:
            world = next(iter(self._services.values())).engine.comm.n_workers
            membership.validate_world(world)
        self._membership = membership
        return membership

    def _require_membership(self) -> Membership:
        if self._membership is None:
            raise ValueError("no rack membership yet: create a service "
                             "first (membership is sized from its worker "
                             "count) or set_membership explicitly")
        return self._membership

    def _note_membership(self, kind: str, rank: int = None) -> None:
        """The telemetry record of a live-set change: a ``membership``
        event and the ``membership.epoch`` gauge."""
        reg = get_registry()
        reg.event("membership", kind=kind, rank=rank,
                  epoch=self._membership.epoch)
        reg.gauge("membership.epoch").set(float(self._membership.epoch))

    def join(self, rank: int) -> Membership:
        """Worker ``rank`` (re)joined the rack."""
        self._membership = self._require_membership().join(rank)
        self._note_membership("join", rank)
        return self._membership

    def leave(self, rank: int) -> Membership:
        """Worker ``rank`` left: its pushes are excluded from every later
        step until it joins back."""
        self._membership = self._require_membership().leave(rank)
        self._note_membership("leave", rank)
        return self._membership

    def mark_slow(self, rank: int, factor: float) -> Membership:
        """Worker ``rank`` straggles at ``factor`` x: stop waiting for it
        (k-of-n partial aggregation)."""
        self._membership = self._require_membership().mark_slow(rank, factor)
        self._note_membership("mark_slow", rank)
        return self._membership

    def mark_recovered(self, rank: int) -> Membership:
        self._membership = self._require_membership().mark_recovered(rank)
        self._note_membership("mark_recovered", rank)
        return self._membership

    def demote(self, rank: int) -> Membership:
        """Escalate worker ``rank`` one notch (live -> slow -> dead)."""
        self._membership = self._require_membership().demote(rank)
        get_registry().counter("membership.demotions").inc(rank=rank)
        self._note_membership("demote", rank)
        return self._membership

    # ------------------------------------------------------- resilience

    @property
    def watchdog(self):
        return self._watchdog

    def set_watchdog(self, watchdog) -> "PHubConnectionManager":
        """Run every later ``push_pull`` and ``co_step`` under
        ``watchdog.run`` (``resilience.ExchangeWatchdog``: retry with
        backoff); None removes it.  Returns self."""
        self._watchdog = watchdog
        return self

    def _dispatch(self, fn, *args):
        if self._watchdog is None:
            return fn(*args)
        return self._watchdog.run(fn, *args)

    def _membership_key(self):
        """The step cache's membership part: the live set's program key,
        None at full strength (the static step)."""
        m = self._membership
        return None if m is None or m.all_live else m.program_key()

    def _step_membership(self) -> Optional[Membership]:
        m = self._membership
        return None if m is None or m.all_live else m

    # -- PHub::CreateService -------------------------------------------------
    def create_service(self, namespace: str, cfg: ModelConfig,
                       tc: TrainConfig, comm, *,
                       device="cuda") -> ServiceHandle:
        if namespace in self._services:
            raise ValueError(f"namespace {namespace!r} already exists")
        nonce = secrets.token_hex(8)
        engine = PHubEngine(cfg, tc, comm, device=device)
        self._services[namespace] = _Service(engine=engine, nonce=nonce)
        if self._membership is None:
            self._membership = Membership.full(comm.n_workers)
        return ServiceHandle(namespace=namespace, nonce=nonce)

    def _auth(self, handle: ServiceHandle) -> _Service:
        svc = self._services.get(handle.namespace)
        if svc is None or svc.nonce != handle.nonce:
            raise PermissionError("bad namespace/nonce")
        return svc

    # -- PHub::ConnectService ------------------------------------------------
    def connect_service(self, handle: ServiceHandle) -> PHubEngine:
        svc = self._auth(handle)
        svc.connected += 1
        return svc.engine

    def service_info(self, handle: ServiceHandle) -> dict:
        svc = self._auth(handle)
        return {"namespace": handle.namespace, "connected": svc.connected,
                "attached": handle.namespace in self._attached,
                "cached_steps": len(svc.steps)}

    # -- PHub::InitService ---------------------------------------------------
    def init_service(self, handle: ServiceHandle, seed: int | None = None):
        """(model, opt): weights drawn from ``seed`` (default the
        TrainConfig's) and zero optimizer slots."""
        return self._auth(handle).engine.init_state(seed)

    # -- PHub::PushPull (fused) ---------------------------------------------
    def push_pull(self, handle: ServiceHandle, model, opt, batch: dict):
        """One fused push(gradients) + pull(new parameters) = one train
        step of a solo tenant.  Returns (model, opt', metrics)."""
        svc = self._auth(handle)
        if handle.namespace in self._attached:
            raise RuntimeError(
                f"namespace {handle.namespace!r} is attached to the "
                f"co-scheduled domain (its momentum lives in the packed "
                f"buffers); detach_service first or use co_step")
        key = (tuple(sorted((k, tuple(v.shape)) for k, v in batch.items())),
               self._membership_key())
        if key not in svc.steps:
            svc.steps[key] = svc.engine.make_train_step(
                membership=self._step_membership())
        with get_tracer().span("exchange/push_pull", ns=handle.namespace):
            out = self._dispatch(svc.steps[key], model, opt, batch)
        reg = get_registry()
        t = self._solo_step_traffic(svc, handle.namespace) \
            if reg.enabled else None
        if t:                           # fsdp_stream: no chunk traffic
            reg.counter("exchange.bytes").inc(
                t["push_bytes"] + t["pull_bytes"],
                tenant=handle.namespace, basis="raw")
            reg.counter("exchange.bytes").inc(
                t["wire_push_bytes"] + t["wire_pull_bytes"],
                tenant=handle.namespace, basis="wire")
        return out

    def _solo_step_traffic(self, svc: _Service, ns: str) -> dict:
        """A solo tenant's raw and wire bytes a step: the figures the
        co-scheduled accounting carries (``cost_model``), cached per
        namespace (a resize clears the cache)."""
        t = self._traffic_cache.get(ns)
        if t is None:
            eng = svc.engine
            if eng.chunk_plan is None:       # fsdp_stream: no chunk domain
                self._traffic_cache[ns] = {}
                return {}
            groups = eng.chunk_plan.groups
            padded = sum(g.padded * g.dtype.itemsize for g in groups)
            wire_b = cost_model.wire_bytes_for_groups(
                [(g.padded, g.dtype, g.chunk_elems) for g in groups],
                eng.wire)
            t = cost_model.tenant_step_traffic(
                eng.tc.strategy, padded, eng.comm.n_workers, wire_b)
            self._traffic_cache[ns] = t
        return t

    def destroy_service(self, handle: ServiceHandle) -> None:
        self._auth(handle)
        if handle.namespace in self._attached:
            self.detach_service(handle)     # reclaims its chunk ranges
        del self._services[handle.namespace]
        self._traffic_cache.pop(handle.namespace, None)
        if not self._services:
            # an empty rack has no workers; the next service sizes a fresh
            # membership from its own Comm
            self._membership = None

    # ------------------------------------------------- tenant co-scheduling

    def attach_service(self, handle: ServiceHandle, opt=None) -> None:
        """Join the shared rack chunk domain.  ``opt``, if given, is the
        tenant's engine-layout optimizer state (e.g. from solo training),
        moved into the packed buffers at its new ranges; otherwise it
        starts from zero.  Re-packs the domain (every attached tenant's
        state moves to its re-balanced positions)."""
        self.attach_services([handle], {handle.namespace: opt}
                             if opt is not None else None)

    def attach_services(self, handles, opts: Optional[dict] = None) -> None:
        """Attach several tenants with one re-pack.  ``opts``: {namespace:
        engine-layout optimizer state} of the tenants carrying state in."""
        # check everything before changing anything: a failure must not
        # leave tenants half-attached
        svcs = {}
        for handle in handles:
            svc = self._auth(handle)
            ns = handle.namespace
            if ns in self._attached or ns in svcs:
                raise ValueError(f"namespace {ns!r} already attached")
            svcs[ns] = svc
        anchor = (self._services[self._attached[0]].engine
                  if self._attached else None)
        for ns, svc in svcs.items():
            self._check_coschedulable(svc.engine, ns, anchor)
            anchor = anchor or svc.engine
        imported = dict(self._extract_all())
        for ns, svc in svcs.items():
            opt = (opts or {}).get(ns)
            if opt is not None:
                imported[ns] = self._engine_opt_to_flats(svc.engine, opt)
            self._attached.append(ns)
            # its pushes go into the packed buffers now: free its solo
            # gradient buffers, which its cached solo steps hold too
            svc.engine.client.release_buffers()
            svc.steps.clear()
        self._repack(imported)

    def detach_service(self, handle: ServiceHandle) -> dict:
        """Leave the co-scheduled domain.  Returns the tenant's optimizer
        state in its engine's layout (ready for a solo ``push_pull``); the
        remaining tenants are re-packed over the reclaimed ranges."""
        svc = self._auth(handle)
        ns = handle.namespace
        if ns not in self._attached:
            raise ValueError(f"namespace {ns!r} is not attached")
        flats = self._extract_all()
        self._attached.remove(ns)
        out = self._flats_to_engine_opt(svc.engine, flats.pop(ns))
        self._repack(flats)
        return out

    @property
    def attached(self) -> tuple[str, ...]:
        return tuple(self._attached)

    @property
    def packed_domain(self) -> Optional[TenantPackedDomain]:
        return self._co.domain if self._co else None

    def co_step(self, handles, models: dict, batches: dict):
        """One step of every attached tenant together.  ``handles``: the
        attached tenants' handles, every one; ``models`` / ``batches``:
        {namespace: DecoderLM} / {namespace: batch}.  The models are
        updated in place; the packed optimizer state is held here.
        Returns (models, metrics {namespace: {"loss": ...}})."""
        if self._co is None:
            raise ValueError("no tenants attached; attach_service first")
        by_ns = {h.namespace: h for h in handles}
        if set(by_ns) != set(self._attached):
            raise ValueError(
                f"co_step needs exactly the attached tenants "
                f"{tuple(self._attached)}; got {tuple(by_ns)}")
        for h in by_ns.values():
            self._auth(h)
        co = self._co
        key = (tuple((ns, tuple(sorted((k, tuple(v.shape))
                                       for k, v in batches[ns].items())))
                     for ns in self._attached),
               self._membership_key())
        if key not in co.steps:
            co.steps[key] = make_co_train_step(
                {ns: self._services[ns].engine for ns in self._attached},
                co.domain, self._step_membership(), gbuf=co.gbuf)
        with get_tracer().span("exchange/co_step",
                               tenants=len(self._attached)):
            models, co.opt, metrics = self._dispatch(co.steps[key], models,
                                                     co.opt, batches)
        reg = get_registry()
        for ns in self._attached:
            t = co.traffic.setdefault(
                ns, {"steps": 0, **{k: 0.0 for k in _TRAFFIC_KEYS}})
            per = co.acct[ns]["per_step"]
            t["steps"] += 1
            for k in _TRAFFIC_KEYS:
                t[k] += per[k]
            reg.counter("exchange.bytes").inc(
                per["push_bytes"] + per["pull_bytes"], tenant=ns,
                basis="raw")
            reg.counter("exchange.bytes").inc(
                per["wire_push_bytes"] + per["wire_pull_bytes"], tenant=ns,
                basis="wire")
        return models, metrics

    def accounting(self) -> dict:
        """Per-tenant bytes of the co-scheduled domain: its residency and
        per-step traffic (``cost_model.tenant_accounting``: the static
        figures flat, the traffic under ``"per_step"``) and a
        ``"cumulative"`` block with the stepped totals."""
        if self._co is None:
            return {}
        out = {}
        for ns in self._attached:
            cum = {"steps": 0, **{k: 0.0 for k in _TRAFFIC_KEYS}}
            cum.update(self._co.traffic.get(ns, {}))
            out[ns] = {**self._co.acct[ns], "cumulative": cum}
        return out

    # ------------------------------------------------------- rack resizing

    def resize(self, new_comm, states: Optional[dict] = None) -> dict:
        """Resize the rack: rebuild every service's engine on ``new_comm``
        (a ``StackedComm`` of another world size) and move the state
        across the chunk domain's repartition (DESIGN.md §12).

        ``states``: {namespace: (model, opt)}, the caller-held states of
        solo services to move (a solo tenant's optimizer state lives with
        its caller); returns the moved {namespace: (model, opt)} (each
        ``opt`` dict has its slots replaced in place, one at a time:
        ``elastic.migrate_engine_state``).  Attached tenants' packed slots
        move inside, through the extract / re-pack that attach and detach
        use, and the shared domain re-packs at the new shard count.  Every
        service's cached steps and gradient buffers (and the co-step's)
        are dropped before anything moves: they belong to the old world.
        The membership becomes all-live at the new world (epoch + 1, so
        every step cache re-keys); ``last_rebalance`` records the plan's
        migration traffic (``cost_model.rebalance_traffic``)."""
        if not self._services:
            raise ValueError("no services to resize")
        for ns in (states or {}):
            if ns not in self._services:
                raise ValueError(f"unknown namespace {ns!r} in states")
            if ns in self._attached:
                raise ValueError(
                    f"namespace {ns!r} is attached: its opt slots live in "
                    f"the packed domain and migrate internally — pass "
                    f"only solo tenants' states")
        for svc in self._services.values():
            require_stacked(svc.engine.comm, "resizing the rack")
        require_stacked(new_comm, "resizing the rack")
        # build every new engine before changing anything: a failure here
        # leaves the old rack as it was (an engine allocates no buffers)
        rebuilt = {}
        for ns, svc in self._services.items():
            new_eng = PHubEngine(svc.engine.cfg, svc.engine.tc, new_comm,
                                 device=svc.engine.device)
            check_resizable(svc.engine, new_eng)
            rebuilt[ns] = (svc.engine, new_eng)
        # the old world's steps, gradient rows and byte figures go first
        self._traffic_cache.clear()
        for svc in self._services.values():
            svc.steps.clear()
            if svc.engine.client is not None:
                svc.engine.client.release_buffers()
        if self._co is not None:
            self._co.gbuf.clear()
        self._co_memo.clear()
        flats = self._extract_all()           # packed slots, old domain
        old_domain = None
        if self._co is not None:
            old_domain = self._co.domain
            self._co.opt = {}                 # the flats are copies
        out, solo_traffic = {}, {}
        for ns, (old_eng, new_eng) in rebuilt.items():
            if states and ns in states:
                out[ns] = migrate_engine_state(old_eng, new_eng,
                                               *states[ns])
                if old_eng.chunk_plan is not None:
                    solo_traffic[ns] = cost_model.rebalance_traffic(
                        plan_rebalance(old_eng.chunk_plan,
                                       new_eng.chunk_plan),
                        new_eng.exchange_slots)
            self._services[ns].engine = new_eng
        world = new_comm.n_workers
        self._membership = (self._membership.resized(world)
                            if self._membership is not None
                            else Membership.full(world))
        self._repack(flats)                   # at the new shard count
        del flats
        co_traffic = None
        if old_domain is not None and self._co is not None:
            co_traffic = cost_model.rebalance_traffic(
                plan_rebalance(old_domain, self._co.domain),
                co_slot_specs({ns: self._services[ns].engine
                               for ns in self._attached}))
        self.last_rebalance = {"co": co_traffic, "solo": solo_traffic,
                               "world": world,
                               "epoch": self._membership.epoch}
        moved = ((co_traffic or {}).get("moved_bytes", 0.0)
                 + sum(t["moved_bytes"] for t in solo_traffic.values()))
        reg = get_registry()
        reg.counter("rebalance.moved_bytes").inc(moved)
        reg.event("rebalance", world=world, epoch=self._membership.epoch,
                  moved_bytes=moved)
        self._note_membership("resize")
        return out

    # ------------------------------------------------------------ internals

    def _check_coschedulable(self, eng: PHubEngine, ns: str,
                             anchor: Optional[PHubEngine] = None) -> None:
        if eng.tc.strategy == "fsdp_stream":
            raise ValueError(
                "fsdp_stream shards leaves over 'data' and has no chunk "
                "domain to pack; co-scheduling needs a chunk strategy")
        if eng.tc.flat_residency:
            raise NotImplementedError(
                "co-scheduling runs on tree-state tenants; flat_residency "
                "stores are not packed yet (DESIGN.md §9)")
        if eng.tc.overlap_backward:
            raise ValueError(
                "co-scheduled tenants pack every tenant's full flat "
                "gradient into one shared domain before the exchange; the "
                "chunk-ready per-window assembly (overlap_backward) has no "
                "packed-domain seam yet — train tenants solo or drop "
                "overlap_backward")
        e0 = anchor or (self._services[self._attached[0]].engine
                        if self._attached else None)
        if e0 is None:
            return
        if eng.comm != e0.comm or eng.device != e0.device:
            raise ValueError(
                f"tenant {ns!r} runs on a different Comm or device; "
                f"co-scheduled tenants share one rack")
        if eng.tc.wire_format != e0.tc.wire_format:
            raise ValueError(
                f"tenant {ns!r} wire_format {eng.tc.wire_format!r} != rack "
                f"wire format {e0.tc.wire_format!r}; co-scheduled tenants "
                f"share one packed chunk domain per dtype and must "
                f"exchange it over one wire")
        if (eng.tc.wire_format_dcn or "identity") != \
                (e0.tc.wire_format_dcn or "identity"):
            raise ValueError(
                f"tenant {ns!r} wire_format_dcn {eng.tc.wire_format_dcn!r} "
                f"!= rack DCN wire {e0.tc.wire_format_dcn!r}; co-scheduled "
                f"tenants share one cross-pod payload stream")
        if eng.tc.exchange_signature() != e0.tc.exchange_signature():
            raise ValueError(
                f"tenant {ns!r} exchange_signature "
                f"{eng.tc.exchange_signature()} != rack signature "
                f"{e0.tc.exchange_signature()}; co-scheduled tenants share "
                f"one collective schedule")

    def _drop_co(self) -> None:
        """Free the packed domain's slots and gradient buffers (a memoized
        step allocates the buffers again when it runs)."""
        if self._co is not None:
            self._co.opt = {}
            self._co.gbuf.clear()
            self._co = None

    def _repack(self, tenant_flats: dict) -> None:
        """(Re)build the packed domain of the attached set and place the
        given per-tenant slot flats ({ns: {key: {slot: (R, slot.padded)}}})
        at their runs in fresh packed buffers, one a (dtype, union slot);
        a tenant lacking a slot (an SGD tenant beside an Adam one) leaves
        its ranges of that buffer zero."""
        traffic = self._co.traffic if self._co else {}
        self._drop_co()
        if not self._attached:
            return
        engines = {ns: self._services[ns].engine for ns in self._attached}
        e0 = engines[self._attached[0]]
        domain = pack_domains(
            {ns: e.chunk_plan for ns, e in engines.items()},
            n_shards=e0.comm.n_shards(e0.tc.strategy),
            chunk_bytes=e0.tc.chunk_size_bytes)
        slots = co_slot_specs(engines)
        opt = {}
        for key, meta in co_opt_state_shapes(e0, domain, slots).items():
            pg = domain.groups[key]
            opt[key] = {}
            for name, m in meta.items():
                buf = torch.zeros(m.shape, dtype=m.dtype, device=e0.device)
                opt[key][name] = buf
                if not tenant_flats:
                    continue
                rows = buf.view(-1, pg.padded)
                for slot in pg.slots:
                    flat = tenant_flats.get(slot.tenant, {}).get(
                        key, {}).get(name)
                    if flat is None:
                        continue
                    for toff, poff, n in slot.runs:
                        rows[:, poff:poff + n].copy_(flat[:, toff:toff + n])
        del tenant_flats
        steps, gbuf = self._co_memo.setdefault(_domain_key(domain), ({}, {}))
        acct = cost_model.tenant_accounting(
            domain, e0.tc.strategy, e0.comm.n_workers, wire=e0.wire)
        self._co = _CoSchedule(domain=domain, opt=opt, acct=acct,
                               traffic=traffic, steps=steps, gbuf=gbuf)

    def _extract_all(self) -> dict:
        """The packed slots -> {ns: {key: {slot: (R, slot.padded)}}} (R:
        the rows of one chunk, 1, or a pod's each for the DCN tier's
        residual on the stacked Comm), copies on the device."""
        if self._co is None:
            return {}
        require_stacked(self._services[self._attached[0]].engine.comm,
                        "moving optimizer state across a packed domain")
        out = {ns: {} for ns in self._attached}
        for key, pg in self._co.domain.groups.items():
            for name, buf in self._co.opt[key].items():
                rows = buf.view(-1, pg.padded)
                for slot in pg.slots:
                    flat = rows.new_zeros((rows.shape[0], slot.padded))
                    for toff, poff, n in slot.runs:
                        flat[:, toff:toff + n].copy_(rows[:, poff:poff + n])
                    out[slot.tenant].setdefault(key, {})[name] = flat
        return out

    def _engine_opt_to_flats(self, eng: PHubEngine, opt: dict) -> dict:
        """Engine-layout slots -> (R, padded) flats (views).  The tail past
        the tenant's chunk padding is its solo shard padding, which never
        holds state."""
        require_stacked(eng.comm, "carrying optimizer state into a packed "
                                  "domain")
        return {g.key: {s.name: opt[g.key][s.name].view(-1, g.padded)
                        for s in eng.exchange_slots}
                for g in eng.chunk_plan.groups}

    def _flats_to_engine_opt(self, eng: PHubEngine, flats: dict) -> dict:
        """(R, slot.padded) flats -> the engine's slots (its own exchange
        slot set: union slots foreign to its rule are dropped)."""
        out = {}
        for g in eng.chunk_plan.groups:
            out[g.key] = {}
            for spec in eng.exchange_slots:
                buf = torch.zeros(eng.slot_shape(g, spec),
                                  dtype=spec.resolve_dtype(g.dtype),
                                  device=eng.device)
                flat = flats.get(g.key, {}).get(spec.name)
                if flat is not None:
                    buf.view(-1, g.padded)[:, :flat.shape[1]].copy_(flat)
                out[g.key][spec.name] = buf
        return out
