#!/usr/bin/env python3
"""Where the time of one PHub train step of the PyTorch port goes on the card.

    python3 scripts/torch_step_profile.py [--workers 4] [--batch 8] [--seq 512]
        [--optimizer nesterov|adam|sgd] [--lr LR]
        [--wire-format identity|bf16|f16|int8] [--sanity [--poison W]]

Runs the port's main path (full llama3.2-1b, sharded_ps, W workers stacked
on one card, Nesterov at the TrainConfig defaults over the identity wire
unless another rule or wire is asked for; ``--sanity``: the sanity-gated
step, worker ``--poison`` NaN-injected if given) for one warm-up step, one
timed step, and one step under torch.profiler.  Prints the timed step's
wall time, the profiled step's device time by kernel class and by kernel
(top 15), and the device busy share: kernel time over the timed (not the
profiled) step's wall time, since the profiler slows the host; kernels of
one stream do not overlap.  Where the device idles it also prints the
caching allocator's activity in the timed step (segments taken with
cudaMalloc and returned with cudaFree, and allocations retried after
freeing the cache: each such retry synchronizes the card) and the host time of the
CUDA runtime calls in the profiled step.  Needs a CUDA card; imports no
JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

CLASSES = (                      # first match wins
    ("update kernel", ("agg_opt_kernel", "sgd_opt_kernel",
                       "adam_opt_kernel")),   # dequant_agg_opt_kernel too
    ("wire codec", ("quantize_kernel",)),     # and dequantize_kernel
    ("health scan", ("health_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas", "sm90_")),
    ("reduction", ("reduce",)),
    ("index / gather / scatter", ("index", "gather", "scatter", "embedding")),
    ("copy / fill", ("copy", "memcpy", "memset", "fill", "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--optimizer", default="nesterov")
    ap.add_argument("--lr", type=float, default=None,
                    help="default: the TrainConfig's")
    ap.add_argument("--wire-format", default="identity")
    ap.add_argument("--sanity", action="store_true",
                    help="the sanity-gated step (health_chunks, the masked "
                         "fill, the live count)")
    ap.add_argument("--poison", type=int, default=None,
                    help="with --sanity: NaN-inject this worker's push")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_profile: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.data import SyntheticTokens

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    cfg = get_arch("llama3.2-1b")
    tc = TrainConfig(loss_chunk=min(1024, args.seq),
                     optimizer=args.optimizer, wire_format=args.wire_format,
                     **({} if args.lr is None else {"lr": args.lr}))
    engine = PHubEngine(cfg, tc, StackedComm(args.workers), device="cuda")
    model, opt = engine.init_state()
    extra = ()
    if args.sanity:
        from repro_torch.resilience import SanityConfig
        inject = np.ones(args.workers, np.float32)
        if args.poison is not None:
            inject[args.poison] = np.nan
        extra = ({"norm_hi": np.float32(np.inf), "inject": inject},)
        step = engine.make_train_step(
            sanity=SanityConfig(allow_injection=True))
    else:
        step = engine.make_train_step()
    data = SyntheticTokens(cfg, args.batch, args.seq, seed=tc.seed)
    model, opt, _ = step(model, opt, data.torch_batch(0), *extra)  # warm-up
    torch.cuda.synchronize()
    batch = data.torch_batch(1)
    before = torch.cuda.memory_stats()
    t0 = time.perf_counter()
    model, opt, _ = step(model, opt, batch, *extra)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    after = torch.cuda.memory_stats()
    alloc = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("segment.all.allocated", "segment.all.freed",
                       "num_alloc_retries")}
    batch = data.torch_batch(2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        model, opt, metrics = step(model, opt, batch, *extra)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    loss = float(metrics["loss"])

    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    runtime: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            if evt.name.startswith("cuda"):
                runtime[evt.name][0] += evt.cpu_time_total / 1e3
                runtime[evt.name][1] += 1
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        by_name[evt.name][0] += us / 1e3
        by_name[evt.name][1] += 1
    dev_ms = sum(v[0] for v in by_name.values())
    by_class: dict[str, float] = defaultdict(float)
    for name, (ms, _) in by_name.items():
        by_class[classify(name)] += ms
    gate = ""
    if args.sanity:
        gate = (f"sanity-gated (poisoned: {args.poison}, ok_mask "
                f"{metrics['ok_mask'].tolist()}), ")
    print(f"step: {gate}{args.optimizer} at lr {tc.lr}, "
          f"{args.wire_format} wire, "
          f"{args.workers} workers, "
          f"batch {args.batch} x {args.seq}, wall {step_ms:.1f} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; profiled "
          f"step: loss {loss:.6f}, wall {prof_ms:.1f} ms, device kernel time "
          f"{dev_ms:.1f} ms; busy share {dev_ms / step_ms:.3f} of the "
          f"unprofiled step "
          f"({dev_ms / prof_ms:.3f} of the profiled one)")
    if dev_ms == 0:
        raise SystemExit("the profiler recorded no device time")
    print("device time by kernel class:")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:<26} {ms:10.2f} ms  {ms / dev_ms:6.1%}")
    print(f"allocator in the timed step: {alloc['segment.all.allocated']} "
          f"segments taken (cudaMalloc), {alloc['segment.all.freed']} given "
          f"back (cudaFree), {alloc['num_alloc_retries']} allocations "
          f"retried after freeing the cache")
    print("host time of CUDA runtime calls in the profiled step:")
    for name, (ms, n) in sorted(runtime.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  {ms:10.2f} ms  {n:5d} calls  {name}")
    print("top kernels by device time:")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        print(f"  {ms:10.2f} ms  {n:5d} calls  {name[:110]}")


if __name__ == "__main__":
    main()
