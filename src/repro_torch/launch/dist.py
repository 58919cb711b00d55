"""How workers are laid out over processes (the counterpart of the
reference's ``launch/mesh.py``).

``run(fn, world, backend, device, timeout)`` starts ``world`` processes
with the ``spawn`` start method (CUDA cannot be forked), one worker each,
laid out as ``pods`` pods of ``world / pods`` ranks (rank r the worker
(pod r // D, data r % D), the reference's ``(pod, data)`` mesh).
Rank r gets a ``core/comm.py::ProcessGroupComm`` over ``backend`` on
``cuda:(r % device_count)`` (or the CPU), initialised from a free
``tcp://localhost`` port or the given ``init_method``, and calls ``fn(comm,
device, *args)``; ``run`` returns every rank's result, in rank order.  A
result must be picklable and hold host objects (CPU tensors, numbers).

When a rank raises or dies, the parent kills the other ranks (they would
otherwise wait in a collective until the group's timeout) and raises a
``RuntimeError`` carrying the rank's traceback.  Every collective runs
under ``timeout`` seconds, so a group whose rank hangs ends too: the
others' collectives raise.  One card holds several gloo ranks; NCCL
wants one card a rank.
"""
from __future__ import annotations

import pickle
import queue
import socket
import traceback
from typing import Callable

import torch
import torch.multiprocessing as mp

from ..core.comm import ProcessGroupComm

_POLL_S = 0.2


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_device(rank: int, device: str) -> torch.device:
    """``cuda:(rank % device_count)`` for ``device="cuda"``, else the
    device as given."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return d


def _child(rank, world, backend, device, init_method, timeout, threads,
           timing, pods, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = _rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        comm = ProcessGroupComm(rank, world, backend, init_method,
                                timeout=timeout, device=dev, timing=timing,
                                pods=pods)
        try:
            out = fn(comm, dev, *args)
        finally:
            comm.close()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:                       # reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def run(fn: Callable, world: int, backend: str = "gloo",
        device: str = "cuda", timeout: float = 600.0, *, args: tuple = (),
        init_method: str | None = None, threads: int | None = None,
        timing: bool = False, pods: int = 1) -> list:
    """Run ``fn(comm, device, *args)`` on ``world`` spawned ranks and return
    their results in rank order.  ``fn`` must be importable by name (a
    module-level function).  ``init_method``: None picks a free
    ``tcp://localhost`` port; tests pass ``file://<path in a temporary
    directory>``.  ``timeout`` (seconds) bounds every collective of the
    group.  ``threads``: intra-op threads a rank (None
    leaves PyTorch's default).  ``timing``: the Comm times its
    collectives (``ProcessGroupComm.stats``).  ``pods``: P pods of
    world / P ranks (the hierarchical strategy's tiers)."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if pods < 1 or world % pods:
        raise ValueError(f"a world of {world} does not split into {pods} "
                         f"pods")
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(r, world, backend, device, init_method,
                               timeout, threads, timing, pods, fn, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    try:
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=_POLL_S)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} died with exit code "
                        f"{procs[dead[0]].exitcode} before reporting")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:                  # every rank reported: let it exit
            p.join(timeout)
    finally:
        _stop(procs)
        results.close()
    return [out[r] for r in range(world)]
