"""Worker substrate: where the reference has mesh axes, the port has a Comm.

The reference runs one worker per device and names them by mesh axes
(``repro/launch/mesh.py``, ``ExchangeContext`` in
``repro/core/exchange.py``).  The port has two Comms:

- ``StackedComm``: W workers in one process on one device, stacked as dim
  0 of one tensor; a reduce-scatter is a sum over that dim.  NCCL puts no
  two ranks on one GPU, so this is how one card runs W workers.
- ``ProcessGroupComm``: one worker per process over ``torch.distributed``
  (gloo, or NCCL across cards).  The sharded_ps push is one
  ``all_to_all_single`` (each rank receives every worker's run of the shard
  it owns, and the owner's fused kernel sums the rows in worker order,
  as the stacked step does), the pull one ``all_gather_into_tensor``, the
  int8 ring's hops ``batch_isend_irecv`` to the next rank, and the losses
  one ``all_gather`` (``launch/dist.py`` starts the processes).

Both lay the W workers out as P pods of D (``pods=P``, the reference's
``(pod, data)`` mesh): worker w is (pod w // D, data w % D), pod-major as
the reference's ``flat_rank`` over ``("pod", "data")``.  The shard layout
(``n_shards``, ``state_len``) follows the strategy: W shards for
sharded_ps (flat across pods), D for hierarchical (the in-pod shards; the
P owners of shard j hold the same update), one for allreduce and
centralized_ps (and fsdp_stream, which has no chunk domain: the
reference's ``ExchangeContext.n_shards`` gives it 1 too).
``ProcessGroupComm`` builds two kinds of subgroup when
P > 1: each pod's D ranks (``over="pod"``: the hierarchical push, pull and
int8 ring) and the P ranks that share a data index (``over="cross"``:
``cross_gather``, the cross-pod leg on the owner shard); every rank
creates every subgroup in the same order.  The baselines add
``all_reduce`` (allreduce's library collective) and ``gather_to`` /
``broadcast_from`` (centralized_ps's incast to rank 0 and its broadcast).

Both answer how many workers this process holds (``local_workers``: W
stacked, 1 a rank).  gloo hands its collectives host tensors: a tensor on
the card is staged through pinned host buffers allocated once per Comm;
NCCL takes the tensors on the card.  The sanity gate, the supervisor,
chunk-ready dispatch and checkpoints run on the stacked Comm only
(``require_stacked``, ROADMAP.md queue A item 4b).
"""
from __future__ import annotations

import datetime
import time
from dataclasses import dataclass, field

import torch

BACKENDS = ("gloo", "nccl")
# collectives carry wire words as int32: gloo has no uint32 (the bits are
# the same, a view)
_WORD = torch.int32


def _shard_layout(n_workers: int, pods: int, strategy: str) -> int:
    if strategy == "sharded_ps":
        return n_workers
    if strategy == "hierarchical":
        return n_workers // pods
    if strategy in ("allreduce", "centralized_ps", "fsdp_stream"):
        # the full-vector strategies; fsdp_stream has no chunk shard
        # matrix at all (its leaves are split, not its chunk domain)
        return 1
    raise ValueError(f"unknown exchange strategy {strategy!r}")


def _check_pods(n_workers: int, pods: int) -> None:
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if pods < 1 or n_workers % pods:
        raise ValueError(f"{n_workers} workers do not split into {pods} "
                         f"pods")


@dataclass(frozen=True)
class StackedComm:
    """W workers on one device, stacked along dim 0: P pods of D, row w
    the worker (pod w // D, data w % D).

    ``hops``: the one record of the link traffic the stacked exchange
    stands in for, {(op, kind, tier): {"calls", "bytes": {dtype: n}}}.
    The exchange (``core/exchange.py``, ``core/pipeline.py``) calls
    ``record`` once a hop of a collective it replaces, with the tensors
    worker 0 receives on that hop: over an encoded wire the payload each
    executed ring hop, gather or pull actually encoded; over the identity
    wire, where one stacked pass reads every row and no hop runs, the
    strips that pass reads from the other workers' rows, laid out as a
    ring's hops (``record_scatter``, ``record_gather``,
    ``record_all_reduce``).  ``traffic`` (by kind and tier, split by
    dtype: the rack lint's R1 and R5, ``analysis/rules.py``) and ``stats``
    (by operation, ``ProcessGroupComm.stats``'s schema; seconds 0: nothing
    crosses a link) are views of it.  Recording reads shapes only: it
    changes no value."""
    n_workers: int
    pods: int = 1
    hops: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        _check_pods(self.n_workers, self.pods)

    def record(self, op: str, kind: str, tier: str, parts) -> None:
        """One hop of a stand-in collective: ``parts``, the tensors (or
        views) worker 0 receives on it."""
        h = self.hops.setdefault((op, kind, tier), {"calls": 0, "bytes": {}})
        h["calls"] += 1
        for t in parts:
            name = str(t.dtype).replace("torch.", "")
            h["bytes"][name] = (h["bytes"].get(name, 0)
                                + t.numel() * t.element_size())

    def record_scatter(self, op: str, kind: str, tier: str, rows,
                       n: int) -> None:
        """A ring reduce-scatter over the ``n`` members' ``rows`` (dim 0)
        as member 0 receives it: piece 0 of every other member's row (each
        row cut in n along its dim 0), one hop each."""
        for k in range(1, n):
            self.record(op, kind, tier, (rows[k].tensor_split(n)[0],))

    def record_gather(self, op: str, kind: str, tier: str, parts,
                      n: int) -> None:
        """A ring all-gather over ``n`` members as member 0 receives it:
        each tensor of ``parts`` cut in n along dim 0, the n - 1 pieces
        that are not its own, one hop each."""
        for k in range(1, n):
            self.record(op, kind, tier,
                        tuple(t.tensor_split(n)[k] for t in parts))

    def record_all_reduce(self, op: str, kind: str, tier: str, rows,
                          n: int) -> None:
        """A ring all-reduce over the ``n`` members' ``rows``: their
        reduce-scatter, then the all-gather of member 0's row (the sums
        come back in its layout)."""
        self.record_scatter(op, kind, tier, rows, n)
        self.record_gather(op, kind, tier, (rows[0],), n)

    @property
    def traffic(self) -> dict:
        """{kind: {tier: {dtype: bytes}}}: worker 0's link bytes."""
        out: dict = {}
        for (_, kind, tier), h in self.hops.items():
            by_dtype = out.setdefault(kind, {}).setdefault(tier, {})
            for dt, b in h["bytes"].items():
                by_dtype[dt] = by_dtype.get(dt, 0) + b
        return out

    @property
    def stats(self) -> dict:
        """{op: {"calls", "bytes", "seconds"}}, as ``ProcessGroupComm``'s
        (calls are hops; seconds 0)."""
        out: dict = {}
        for (op, _, _), h in self.hops.items():
            s = out.setdefault(op, {"calls": 0, "bytes": 0, "seconds": 0.0})
            s["calls"] += h["calls"]
            s["bytes"] += sum(h["bytes"].values())
        return out

    def link_bytes(self) -> dict:
        """{kind: {"ici": bytes, "dcn": bytes}} summed over dtypes: the
        shape of the cost model's ``runtime_by_kind``."""
        return {kind: {tier: sum(tiers.get(tier, {}).values())
                       for tier in ("ici", "dcn")}
                for kind, tiers in self.traffic.items()}

    def reset_stats(self) -> None:
        self.hops.clear()

    @property
    def pod_size(self) -> int:
        """D: the workers of one pod."""
        return self.n_workers // self.pods

    @property
    def rank(self) -> int:
        """This process's rank: one process holds every worker."""
        return 0

    def local_workers(self) -> int:
        """Workers this process holds: all of them."""
        return self.n_workers

    def n_shards(self, strategy: str) -> int:
        """Rows of the chunk shard-matrix for this strategy (the
        reference's ``ExchangeContext.n_shards``)."""
        return _shard_layout(self.n_workers, self.pods, strategy)

    def state_len(self, strategy: str, padded: int) -> int:
        """Optimizer-state length per shard."""
        return padded // self.n_shards(strategy)

    def gather_small(self, t: torch.Tensor) -> torch.Tensor:
        """(1, *t.shape): the one process's values (``t`` holds every
        worker's already)."""
        return t[None]


class ProcessGroupComm:
    """One worker per process over a ``torch.distributed`` process group.

    ``init_process_group`` gets ``backend``, ``rank``, ``world``, an explicit
    ``init_method`` (``tcp://localhost:<port>`` or ``file://<path>``) and a
    ``timeout`` in seconds; nothing comes from environment variables.
    ``device``: where this rank's tensors live, the card unless the CPU is
    asked for (NCCL: a CUDA device, and without CUDA it raises).  gloo always hands its collectives host
    tensors: a CPU tensor as it is, a CUDA tensor through a pinned host
    buffer of this Comm (one a role, allocated at first use, grown to the
    largest request and reused by every later step).  ``pods``: P pods of
    D = world / P ranks, rank r the worker (pod r // D, data r % D); at
    P > 1 the pod and cross-pod subgroups are built here (``subgroups``
    lists them in creation order, the same on every rank).

    ``stats``: per operation its calls, payload bytes this rank sent, and
    (with ``timing``) wall seconds, the device synchronized before and
    after each collective so that the time is the collective's own
    (staging copies included)."""

    def __init__(self, rank: int, world: int, backend: str, init_method: str,
                 *, timeout: float = 600.0, device="cuda",
                 timing: bool = False, pods: int = 1):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a world of {world}")
        _check_pods(world, pods)
        self.device = torch.device(device)
        if backend == "nccl" and (not torch.cuda.is_available()
                                  or self.device.type != "cuda"):
            raise RuntimeError(
                f"the nccl backend needs a CUDA device, got {self.device} "
                f"(CUDA available: {torch.cuda.is_available()})")
        import torch.distributed as dist
        self._dist = dist
        self.rank, self.world, self.backend = rank, world, backend
        self.n_workers, self.pods = world, pods
        self.pod_size = D = world // pods
        self.pod, self.data_index = divmod(rank, D)
        self.timing = timing
        kw = {"device_id": self.device} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout), **kw)
        self.group = dist.group.WORLD
        # name -> (process group, its global ranks in member order)
        self._groups = {"world": (self.group, tuple(range(world)))}
        self.subgroups: list = []
        if pods > 1:
            # every rank creates every subgroup, in this order, including
            # the ones it is not in (new_group is collective over the world)
            for kind, members in (
                    [("pod", tuple(q * D + d for d in range(D)))
                     for q in range(pods)]
                    + [("cross", tuple(q * D + d for q in range(pods)))
                       for d in range(D)]):
                pg = dist.new_group(ranks=list(members))
                self.subgroups.append((kind, members))
                if rank in members:
                    self._groups[kind] = (pg, members)
        else:
            self._groups["pod"] = self._groups["world"]
            self._groups["cross"] = (None, (rank,))
        self._host: dict = {}
        self.stats: dict = {}

    # ------------------------------------------------------------ layout

    def local_workers(self) -> int:
        """Workers this process holds: one."""
        return 1

    def n_shards(self, strategy: str) -> int:
        """Rows of the chunk shard-matrix, as ``StackedComm.n_shards``; a
        rank owns one of them (none under centralized_ps but rank 0)."""
        return _shard_layout(self.n_workers, self.pods, strategy)

    def state_len(self, strategy: str, padded: int) -> int:
        """Optimizer-state length per shard."""
        return padded // self.n_shards(strategy)

    def members(self, over: str = "world") -> tuple:
        """The global ranks of this rank's group ``over`` ("world", "pod"
        or "cross"), in member order."""
        return self._groups[over][1]

    def close(self) -> None:
        """Destroy the process group (``launch/dist.py`` calls it when the
        rank's function returns or raises)."""
        if self._dist.is_initialized():
            self._dist.destroy_process_group()
        self._host.clear()

    # ------------------------------------------------------------ staging

    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _buffer(self, role: str, numel: int, dtype) -> torch.Tensor:
        """``numel`` elements of the pinned host buffer of ``role``: one
        buffer a role ("send", "recv", a ring hop's parts), shared by every
        collective (each lands its result on the device before the next
        starts), grown to the largest request and kept.  Pinned memory is
        allocated in powers of two and counts against the host's, which a
        card shared by several ranks makes scarce."""
        nbytes = numel * dtype.itemsize
        buf = self._host.get(role)
        if buf is None or buf.numel() < nbytes:
            self._host.pop(role, None)
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._host[role] = buf
        return buf[:nbytes].view(dtype)

    def _send(self, role: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the collective's contiguous input: a pinned copy under
        staged gloo, else ``t`` made contiguous."""
        if not self._staged():
            return t.contiguous().view(-1)
        buf = self._buffer(role, t.numel(), t.dtype)
        buf.view(t.shape).copy_(t)
        return buf

    def _recv(self, role: str, numel: int, dtype) -> torch.Tensor:
        if self._staged():
            return self._buffer(role, numel, dtype)
        return torch.empty(numel, dtype=dtype, device=self.device)

    def _land(self, buf: torch.Tensor, out: torch.Tensor | None = None
              ) -> torch.Tensor:
        """A received buffer on this rank's device (into ``out`` if given)."""
        if out is not None:
            out.view(-1).copy_(buf)
            return out
        if self._staged():
            return buf.to(self.device)
        return buf

    def _record(self, op: str, nbytes: int, start: float) -> None:
        s = self.stats.setdefault(op, {"calls": 0, "bytes": 0,
                                       "seconds": 0.0})
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        if self.timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            s["seconds"] += time.perf_counter() - start

    def _start(self) -> float:
        if self.timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    # ------------------------------------------------------------ operations

    def push(self, rows: torch.Tensor, over: str = "world") -> torch.Tensor:
        """The push: ``rows`` (m, n) is this rank's gradient run of every
        shard of its group ``over`` (m members; row j: shard j's run, any
        row stride); row j goes to member j in one ``all_to_all_single``.
        Returns the (m, n) runs of the shard this rank owns, row i member
        i's (a group of one posts nothing and returns ``rows``)."""
        pg, members = self._groups[over]
        m = len(members)
        if rows.dim() != 2 or rows.shape[0] != m:
            raise ValueError(f"push over {over!r} takes ({m}, n) rows, got "
                             f"{tuple(rows.shape)}")
        t0 = self._start()
        if m == 1:                     # a group of one: no collective
            self._record("push", 0, t0)
            return rows
        send = self._send("send", rows)
        recv = self._recv("recv", rows.numel(), rows.dtype)
        self._dist.all_to_all_single(recv, send, group=pg)
        out = self._land(recv).view(rows.shape)
        self._record("push", rows.numel() * rows.element_size() * (m - 1)
                     // m, t0)
        return out

    def pull(self, shard: torch.Tensor, out: torch.Tensor | None,
             over: str = "world") -> torch.Tensor:
        """The pull: one ``all_gather_into_tensor`` of this rank's (L,)
        ``shard`` into ``out`` (m*L,) over its group ``over``, member j's
        shard at [j*L, (j+1)*L).  A uint32 tensor travels as int32 (the
        same bits).  A group of one posts nothing: ``shard`` is copied
        into ``out``, or returned itself when ``out`` is None."""
        pg, members = self._groups[over]
        m = len(members)
        if out is None and m == 1:
            self._record("pull", 0, self._start())
            return shard
        if out.numel() != shard.numel() * m:
            raise ValueError(f"pull of {shard.numel()} elements a rank "
                             f"into {out.numel()} over {m}")
        t0 = self._start()
        if m == 1:                     # a group of one: no collective
            out.view(-1).copy_(shard.view(-1))
            self._record("pull", 0, t0)
            return out
        src, dst = shard, out
        if shard.dtype == torch.uint32:
            src, dst = shard.view(_WORD), out.view(_WORD)
        send = self._send("send", src)
        recv = (self._recv("recv", dst.numel(), dst.dtype)
                if self._staged() else dst.view(-1))
        self._dist.all_gather_into_tensor(recv, send, group=pg)
        if self._staged():
            self._land(recv, dst)
        self._record("pull", shard.numel() * shard.element_size() * (m - 1),
                     t0)
        return out

    def cross_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The cross-pod leg: one ``all_gather_into_tensor`` of this rank's
        (n,) ``t`` (the owner shard's partial, or its encoded words or
        scales) over the P ranks that share its data index.  Returns (P, n)
        rows in pod order (uint32 travels as int32, the same bits)."""
        pg, members = self._groups["cross"]
        P = len(members)
        out = t.new_empty((P, t.numel()))
        if P == 1:
            out[0].copy_(t.reshape(-1))
            return out
        t0 = self._start()
        src, dst = t.reshape(-1), out.view(-1)
        if t.dtype == torch.uint32:
            src, dst = src.view(_WORD), dst.view(_WORD)
        send = self._send("send", src)
        recv = (self._recv("recv", dst.numel(), dst.dtype)
                if self._staged() else dst)
        self._dist.all_gather_into_tensor(recv, send, group=pg)
        if self._staged():
            self._land(recv, dst)
        self._record("cross_gather", t.numel() * t.element_size() * (P - 1),
                     t0)
        return out

    def ring_hop(self, send_parts: tuple, recv_parts: tuple,
                 over: str = "world") -> tuple:
        """One hop of the ring over the group ``over``: every part of
        ``send_parts`` to the next member and ``recv_parts`` (the same
        shapes and dtypes, written in place) from the previous one, all in
        one ``batch_isend_irecv`` (every rank posts its sends and receives
        in the same order; peers are global ranks).  uint32 parts travel as
        int32.  Returns ``recv_parts``."""
        t0 = self._start()
        dist = self._dist
        pg, members = self._groups[over]
        i = members.index(self.rank)
        nxt = members[(i + 1) % len(members)]
        prv = members[(i - 1) % len(members)]
        sends, recvs = [], []
        for k, (s, r) in enumerate(zip(send_parts, recv_parts)):
            if s.shape != r.shape or s.dtype != r.dtype:
                raise ValueError(f"ring part {k}: sends {s.dtype} "
                                 f"{tuple(s.shape)}, receives {r.dtype} "
                                 f"{tuple(r.shape)}")
            if s.dtype == torch.uint32:
                s, r = s.view(_WORD), r.view(_WORD)
            sends.append(self._send(f"hop_send{k}", s))
            recvs.append(self._recv(f"hop_recv{k}", r.numel(), r.dtype)
                         if self._staged() else r.view(-1))
        ops = ([dist.P2POp(dist.isend, s, nxt, group=pg) for s in sends]
               + [dist.P2POp(dist.irecv, r, prv, group=pg) for r in recvs])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if self._staged():
            for r, buf in zip(recv_parts, recvs):
                self._land(buf, r.view(buf.dtype) if r.dtype == torch.uint32
                           else r)
        self._record("ring_hop", sum(s.numel() * s.element_size()
                                     for s in send_parts), t0)
        return recv_parts

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """allreduce's collective: ``t`` summed over every rank in place
        (one ``all_reduce``, in the library's order; at two ranks
        a + b = b + a, so the sum is the stacked kernel's).  The bytes
        counted are a ring all-reduce's, 2 (W-1)/W of ``t`` a rank."""
        W = self.world
        t0 = self._start()
        flat = t.view(-1)
        if self._staged():
            buf = self._send("send", flat)
            self._dist.all_reduce(buf, group=self.group)
            self._land(buf, flat)
        else:
            self._dist.all_reduce(flat, group=self.group)
        self._record("all_reduce", 2 * t.numel() * t.element_size()
                     * (W - 1) // W, t0)
        return t

    def gather_to(self, t: torch.Tensor, dst: int = 0):
        """centralized_ps's incast: every rank's (n,) ``t`` to rank
        ``dst`` in one ``gather``.  Returns the (W, n) rows in rank order
        on ``dst`` and None elsewhere."""
        W = self.world
        t0 = self._start()
        src = self._send("send", t.reshape(-1))
        if self.rank == dst:
            rows = self._recv("recv", W * t.numel(), t.dtype)
            self._dist.gather(src, list(rows.view(W, -1)), dst=dst,
                              group=self.group)
            out = self._land(rows).view(W, -1)
        else:
            self._dist.gather(src, None, dst=dst, group=self.group)
            out = None
        self._record("gather_to", 0 if self.rank == dst
                     else t.numel() * t.element_size(), t0)
        return out

    def broadcast_from(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """centralized_ps's reply: rank ``src``'s ``t`` to every rank, in
        place (one ``broadcast``).  The bytes counted are the root's
        W-1 copies."""
        t0 = self._start()
        flat = t.view(-1)
        if self._staged():
            buf = self._send("send", flat)
            self._dist.broadcast(buf, src=src, group=self.group)
            if self.rank != src:
                self._land(buf, flat)
        else:
            self._dist.broadcast(flat, src=src, group=self.group)
        self._record("broadcast_from", t.numel() * t.element_size()
                     * (self.world - 1) if self.rank == src else 0, t0)
        return t

    def gather_small(self, t: torch.Tensor) -> torch.Tensor:
        """(W, *t.shape): every rank's ``t`` (a few scalars: losses, live
        flags) in rank order, on ``t``'s device (one ``all_gather``)."""
        t0 = self._start()
        src = t.detach().to("cpu") if self._staged() else t.detach()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        self._dist.all_gather(parts, src.contiguous(), group=self.group)
        out = torch.stack(parts).to(t.device)
        self._record("gather_small", t.numel() * t.element_size()
                     * (self.world - 1), t0)
        return out


def require_stacked(comm, what: str) -> None:
    """Raise NotImplementedError unless ``comm`` holds every worker in this
    process: ``what`` runs on the stacked Comm only so far."""
    if isinstance(comm, ProcessGroupComm):
        raise NotImplementedError(
            f"{what} over a process group ({comm.backend}, "
            f"{comm.n_workers} ranks) is not ported yet (ROADMAP.md queue "
            f"A item 4b)")
