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
  int8 ring's hops ``batch_isend_irecv`` to rank+1, and the losses one
  ``all_gather`` (``launch/dist.py`` starts the processes).

Both answer the layout (``n_shards``, ``state_len``) and how many workers
this process holds (``local_workers``: W stacked, 1 a rank).  gloo hands
its collectives host tensors: a tensor on the card is staged through pinned
host buffers allocated once per Comm; NCCL takes the tensors on the card.
The sanity gate, the supervisor, chunk-ready dispatch and checkpoints run
on the stacked Comm only (``require_stacked``, ROADMAP.md queue A item 4b).
"""
from __future__ import annotations

import datetime
import time
from dataclasses import dataclass

import torch

BACKENDS = ("gloo", "nccl")
# collectives carry wire words as int32: gloo has no uint32 (the bits are
# the same, a view)
_WORD = torch.int32


def _shard_layout(n_workers: int, strategy: str) -> int:
    if strategy == "sharded_ps":
        return n_workers
    if strategy in ("allreduce", "centralized_ps"):
        return 1
    raise NotImplementedError(
        f"strategy {strategy!r} has no worker layout yet (ROADMAP.md queue "
        f"A item 5)")


@dataclass(frozen=True)
class StackedComm:
    """W workers on one device, stacked along dim 0."""
    n_workers: int

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")

    @property
    def rank(self) -> int:
        """This process's rank: one process holds every worker."""
        return 0

    def local_workers(self) -> int:
        """Workers this process holds: all of them."""
        return self.n_workers

    def n_shards(self, strategy: str) -> int:
        """Rows of the chunk shard-matrix for this strategy (the
        reference's ``ExchangeContext.n_shards`` on a flat data axis)."""
        return _shard_layout(self.n_workers, strategy)

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
    ``device``: where this rank's tensors live (NCCL: a CUDA device, and
    without CUDA it raises).  gloo always hands its collectives host
    tensors: a CPU tensor as it is, a CUDA tensor through a pinned host
    buffer of this Comm (one per role and size, allocated at first use and
    reused by every later step).

    ``stats``: per operation its calls, payload bytes sent, and (with
    ``timing``) wall seconds, the device synchronized before and after
    each collective so that the time is the collective's own (staging
    copies included)."""

    def __init__(self, rank: int, world: int, backend: str, init_method: str,
                 *, timeout: float = 600.0, device="cpu",
                 timing: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a world of {world}")
        self.device = torch.device(device)
        if backend == "nccl" and (not torch.cuda.is_available()
                                  or self.device.type != "cuda"):
            raise RuntimeError(
                f"the nccl backend needs a CUDA device, got {self.device} "
                f"(CUDA available: {torch.cuda.is_available()})")
        import torch.distributed as dist
        self._dist = dist
        self.rank, self.world, self.backend = rank, world, backend
        self.n_workers = world
        self.timing = timing
        kw = {"device_id": self.device} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout), **kw)
        self.group = dist.group.WORLD
        self._host: dict = {}
        self.stats: dict = {}

    # ------------------------------------------------------------ layout

    def local_workers(self) -> int:
        """Workers this process holds: one."""
        return 1

    def n_shards(self, strategy: str) -> int:
        """Rows of the chunk shard-matrix: one shard a rank (sharded_ps),
        as ``StackedComm.n_shards``."""
        return _shard_layout(self.n_workers, strategy)

    def state_len(self, strategy: str, padded: int) -> int:
        """Optimizer-state length per shard."""
        return padded // self.n_shards(strategy)

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
        """The pinned host buffer of ``role`` for ``numel`` elements: the
        push and the pull share theirs (each lands its result on the
        device before the next collective starts)."""
        key = (role, numel, dtype)
        buf = self._host.get(key)
        if buf is None:
            buf = torch.empty(numel, dtype=dtype, pin_memory=True)
            self._host[key] = buf
        return buf

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

    def push(self, rows: torch.Tensor) -> torch.Tensor:
        """The sharded_ps push: ``rows`` (W, n) is this rank's gradient run
        of every shard (row j: shard j's run, any row stride); row j goes
        to rank j in one ``all_to_all_single``.  Returns the (W, n) runs of
        the shard this rank owns, row w worker w's."""
        W = self.n_workers
        if rows.dim() != 2 or rows.shape[0] != W:
            raise ValueError(f"push takes ({W}, n) rows, got "
                             f"{tuple(rows.shape)}")
        t0 = self._start()
        send = self._send("send", rows)
        recv = self._recv("recv", rows.numel(), rows.dtype)
        self._dist.all_to_all_single(recv, send, group=self.group)
        out = self._land(recv).view(rows.shape)
        self._record("push", rows.numel() * rows.element_size() * (W - 1)
                     // W, t0)
        return out

    def pull(self, shard: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """The pull: one ``all_gather_into_tensor`` of this rank's (L,)
        ``shard`` into ``out`` (W*L,), rank j's shard at [j*L, (j+1)*L).
        A uint32 tensor travels as int32 (the same bits)."""
        if out.numel() != shard.numel() * self.n_workers:
            raise ValueError(f"pull of {shard.numel()} elements a rank "
                             f"into {out.numel()}")
        t0 = self._start()
        src, dst = shard, out
        if shard.dtype == torch.uint32:
            src, dst = shard.view(_WORD), out.view(_WORD)
        send = self._send("send", src)
        recv = (self._recv("recv", dst.numel(), dst.dtype)
                if self._staged() else dst.view(-1))
        self._dist.all_gather_into_tensor(recv, send, group=self.group)
        if self._staged():
            self._land(recv, dst)
        self._record("pull", shard.numel() * shard.element_size()
                     * (self.n_workers - 1), t0)
        return out

    def ring_hop(self, send_parts: tuple, recv_parts: tuple) -> tuple:
        """One hop of the ring: every part of ``send_parts`` to rank+1 and
        ``recv_parts`` (the same shapes and dtypes, written in place) from
        rank-1, all in one ``batch_isend_irecv`` (every rank posts its
        sends and receives in the same order).  uint32 parts travel as
        int32.  Returns ``recv_parts``."""
        t0 = self._start()
        dist = self._dist
        nxt, prv = (self.rank + 1) % self.world, (self.rank - 1) % self.world
        sends, recvs = [], []
        for i, (s, r) in enumerate(zip(send_parts, recv_parts)):
            if s.shape != r.shape or s.dtype != r.dtype:
                raise ValueError(f"ring part {i}: sends {s.dtype} "
                                 f"{tuple(s.shape)}, receives {r.dtype} "
                                 f"{tuple(r.shape)}")
            if s.dtype == torch.uint32:
                s, r = s.view(_WORD), r.view(_WORD)
            sends.append(self._send(f"hop_send{i}", s))
            recvs.append(self._recv(f"hop_recv{i}", r.numel(), r.dtype)
                         if self._staged() else r.view(-1))
        ops = ([dist.P2POp(dist.isend, s, nxt, group=self.group)
                for s in sends]
               + [dist.P2POp(dist.irecv, r, prv, group=self.group)
                  for r in recvs])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if self._staged():
            for r, buf in zip(recv_parts, recvs):
                self._land(buf, r.view(buf.dtype) if r.dtype == torch.uint32
                           else r)
        self._record("ring_hop", sum(s.numel() * s.element_size()
                                     for s in send_parts), t0)
        return recv_parts

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
