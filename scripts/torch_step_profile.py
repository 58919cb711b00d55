#!/usr/bin/env python3
"""Where the time of one PHub train step of the PyTorch port goes on the card.

    python3 scripts/torch_step_profile.py [--workers 4] [--batch 8] [--seq 512]
        [--optimizer nesterov|adam|sgd] [--lr LR]
        [--wire-format identity|bf16|f16|int8] [--sanity [--poison W]]
        [--windows N] [--flat] [--overlap] [--arch ARCH] [--layers L]
    python3 scripts/torch_step_profile.py --serve [--arch ARCH]
        [--layers L] [--batch 8] [--seq 2048]

Runs the port's main path (full ``--arch``, llama3.2-1b by default, any
of the ten; ``--layers`` cuts its depth, never its width; sharded_ps, W workers stacked on one card, Nesterov at the TrainConfig
defaults over the identity wire unless another rule or wire is asked for; ``--sanity``: the sanity-gated
step, worker ``--poison`` NaN-injected if given; ``--windows``,
``--flat``, ``--overlap``: the gradient processing pipeline's
``pipeline_windows``, ``flat_residency`` and ``overlap_backward``) for one
warm-up step, one timed step, and one step under torch.profiler.  Prints
the timed step's wall time, the profiled step's device time by kernel
class and by kernel (top 15), and the device busy share: kernel time over
the timed (not the profiled) step's wall time, since the profiler slows
the host; kernels of one stream do not overlap, but under ``--overlap``
the update kernels run on a side stream, so it also prints how long they
ran beside another kernel (the overlap) and where they started.  Where the device idles it also prints the
caching allocator's activity in the timed step (segments taken with
cudaMalloc and returned with cudaFree, and allocations retried after
freeing the cache: each such retry synchronizes the card) and the host time of the
CUDA runtime calls in the profiled step.  For the attention-free family
(rwkv6-3b) it also times the chunked scan alone (``rwkv_chunked``, one
layer's shape for one worker, forward and forward + backward, CUDA events)
and scales it to the step's layers, workers and the remat's second
forward: the scan's share, which the kernel classes cannot separate from
the projections' matmuls and elementwise kernels.  For the hybrid
(hymba-1.5b) it times the SSM branch alone the same way (host time and
launches, scaled to the step, against the timed step's wall), and for
the MoE family (grok-1-314b, arctic-480b) it profiles one expert layer's
forward + backward, the expert products against the dispatch.  Needs a
CUDA card; imports no JAX.

``--serve``: the serving path instead (``--arch``, full width and depth,
a greedy batch of ``--batch`` prompts of ``--seq`` tokens): one prefill
and one decode step against its cache, each warmed up, timed unprofiled
(ending in a sync) and then profiled, with the same split by kernel class
and the busy share of each.
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
    ("attention kernel (prefill)", ("swa_kernel",)),
    ("attention kernel (decode)", ("decode_kernel",)),
    ("rwkv scan kernel", ("rwkv_scan_kernel",)),
    ("update kernel", ("agg_opt_kernel", "sgd_opt_kernel",
                       "adam_opt_kernel")),   # dequant_agg_opt_kernel too
    ("wire codec", ("quantize_kernel",)),     # and dequantize_kernel
    ("health scan", ("health_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas", "sm90_",
                         "nvjet")),
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


def device_split(prof, torch):
    """({kernel: [device ms, calls]}, {CUDA runtime call: [host ms,
    calls]}, total device ms) of a profile."""
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
    return by_name, runtime, sum(v[0] for v in by_name.values())


def update_overlap(prof, torch) -> str:
    """How the update kernels sat against the others in a profiled step:
    their own device ms, the ms during which one of them ran beside
    another kernel, and the start of the first and the end of the last
    relative to the end of the last other kernel before the first update
    (the backward's tail, under chunk-ready dispatch)."""
    upd, other = [], []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (evt.time_range.start, evt.time_range.end)
        (upd if classify(evt.name) == "update kernel" else other).append(
            span)
    if not upd:
        return "no update kernel in the profiled step"
    upd.sort()
    other.sort()
    overlap = 0.0
    for a, b in upd:
        cut = [(max(a, c), min(b, d)) for c, d in other if c < b and d > a]
        cut.sort()
        end = a
        for c, d in cut:                  # the union of the cut spans
            c = max(c, end)
            if d > c:
                overlap += d - c
                end = d
    first, last = upd[0][0], max(b for _, b in upd)
    before = [d for c, d in other if c < first]
    tail = max(before) if before else first
    return (f"update kernels: {len(upd)} launches, "
            f"{sum(b - a for a, b in upd) / 1e3:.3f} ms of device time, "
            f"{overlap / 1e3:.3f} ms beside another kernel; the first "
            f"started {(first - tail) / 1e3:+.3f} ms and the last ended "
            f"{(last - tail) / 1e3:+.3f} ms from the end of the last other "
            f"kernel that started before it")


def print_split(by_name: dict, dev_ms: float, top: int = 15) -> None:
    if dev_ms == 0:
        raise SystemExit("the profiler recorded no device time")
    by_class: dict[str, float] = defaultdict(float)
    for name, (ms, _) in by_name.items():
        by_class[classify(name)] += ms
    print("device time by kernel class:")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:<26} {ms:10.3f} ms  {ms / dev_ms:6.1%}")
    print("top kernels by device time:")
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:10.3f} ms  {n:5d} calls  {name[:110]}")
    print("top copy / fill kernels:")
    copies = [kv for kv in by_name.items() if classify(kv[0]) == "copy / fill"]
    for name, (ms, n) in sorted(copies, key=lambda kv: -kv[1][0])[:6]:
        print(f"  {ms:10.3f} ms  {n:5d} calls  {name[:110]}")


def cache_desc(cache: dict) -> str:
    """A KV ring's slots a layer, or the bytes of a recurrent state."""
    if "k" in cache:
        return f"cache {cache['k'].shape[2]} slots"
    n = sum(t.numel() * t.element_size() for t in cache.values()
            if hasattr(t, "numel"))
    return f"state cache {n / 1e6:.1f} MB"


def arch_config(args):
    """``--arch`` at full width, its depth cut to ``--layers`` if given."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = get_arch(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def serve_profile(args) -> None:
    """One prefill and one decode step of the serving path, profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import TrainConfig
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.data import SyntheticTokens

    cfg = arch_config(args)
    engine = PHubEngine(cfg, TrainConfig(), StackedComm(1), device="cuda")
    model = engine.init_model(seed=0)
    prompts = torch.from_numpy(SyntheticTokens(cfg, args.batch, args.seq,
                                               seed=7).batch_at(0)["tokens"]
                               ).to("cuda", torch.int64)
    prefill = engine.make_prefill_step(args.seq, max_new_tokens=32)
    step = engine.make_serve_step()

    def run_prefill():
        return prefill(model, prompts)

    cache = None

    def run_decode():
        logits, _ = step(model, cache, tok)
        return logits

    logits, cache = run_prefill()                      # warm-up
    tok = logits.argmax(-1)[:, None]
    for fn, label in ((run_prefill, f"prefill of {args.batch} x {args.seq}"),
                      (run_decode, "one decode step")):
        for _ in range(2):                             # warm-up
            out = fn()
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        del out
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        del out
        by_name, runtime, dev_ms = device_split(prof, torch)
        print(f"{cfg.arch_id} {label} ({cache_desc(cache)}, "
              f"next {cache['next']}): wall {wall:.3f} ms, peak {peak:.2f} "
              f"GiB; profiled wall {prof_ms:.3f} ms, device kernel time "
              f"{dev_ms:.3f} ms; busy share {dev_ms / wall:.3f} of the "
              f"unprofiled run ({dev_ms / prof_ms:.3f} of the profiled one)")
        print_split(by_name, dev_ms)
        print("host time of CUDA runtime calls in the profiled run:")
        for name, (ms, n) in sorted(runtime.items(),
                                    key=lambda kv: -kv[1][0])[:4]:
            print(f"  {ms:10.3f} ms  {n:5d} calls  {name}")


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
    ap.add_argument("--windows", type=int, default=1,
                    help="pipeline windows per dtype group")
    ap.add_argument("--flat", action="store_true",
                    help="flat parameter residency")
    ap.add_argument("--overlap", action="store_true",
                    help="chunk-ready dispatch of the windows")
    ap.add_argument("--serve", action="store_true",
                    help="profile the serving path: one prefill of "
                         "--batch x --seq and one decode step")
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="the architecture (full width and depth)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: all)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_profile: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import TrainConfig
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.data import SyntheticTokens

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    if args.serve:
        serve_profile(args)
        return
    cfg = arch_config(args)
    tc = TrainConfig(loss_chunk=min(1024, args.seq),
                     optimizer=args.optimizer, wire_format=args.wire_format,
                     pipeline_windows=args.windows,
                     flat_residency=args.flat,
                     overlap_backward=args.overlap,
                     **({} if args.lr is None else {"lr": args.lr}))
    engine = PHubEngine(cfg, tc, StackedComm(args.workers), device="cuda")
    from repro_torch.core.pipeline import effective_windows
    windows = [effective_windows(g, tc.pipeline_windows)
               for g in engine.chunk_plan.groups]
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
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()
    t0 = time.perf_counter()
    model, opt, _ = step(model, opt, batch, *extra)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
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

    by_name, runtime, dev_ms = device_split(prof, torch)
    gate = ""
    if args.sanity:
        gate = (f"sanity-gated (poisoned: {args.poison}, ok_mask "
                f"{metrics['ok_mask'].tolist()}), ")
    print(f"step: {cfg.arch_id}, {gate}{args.optimizer} at lr {tc.lr}, "
          f"{args.wire_format} wire, "
          f"{args.workers} workers, windows {tc.pipeline_windows} "
          f"(effective {windows}), flat residency {tc.flat_residency}, "
          f"chunk-ready {tc.overlap_backward}, "
          f"batch {args.batch} x {args.seq}, wall {step_ms:.1f} ms, peak "
          f"{peak:.2f} GiB; profiled "
          f"step: loss {loss:.6f}, wall {prof_ms:.1f} ms, device kernel time "
          f"{dev_ms:.1f} ms; busy share {dev_ms / step_ms:.3f} of the "
          f"unprofiled step "
          f"({dev_ms / prof_ms:.3f} of the profiled one)")
    print_split(by_name, dev_ms)
    print(update_overlap(prof, torch))
    print(f"allocator in the timed step: {alloc['segment.all.allocated']} "
          f"segments taken (cudaMalloc), {alloc['segment.all.freed']} given "
          f"back (cudaFree), {alloc['num_alloc_retries']} allocations "
          f"retried after freeing the cache")
    print("host time of CUDA runtime calls in the profiled step:")
    for name, (ms, n) in sorted(runtime.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  {ms:10.2f} ms  {n:5d} calls  {name}")
    if cfg.attn_free or cfg.family == "hybrid" or cfg.n_experts:
        del model, opt, metrics, step, engine
        torch.cuda.empty_cache()
    if cfg.attn_free:
        scan_share(cfg, args, torch)
    if cfg.family == "hybrid":
        ssm_share(cfg, args, step_ms, torch)
    if cfg.n_experts:
        moe_share(cfg, args, torch)


def host_ms(fn, torch, reps: int = 3) -> float:
    """Median host ms of ``fn`` between two synchronizations, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def profiled(fn, torch) -> dict:
    """{kernel: [device ms, launches]} of one ``fn`` call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_split(prof, torch)[0]


def ssm_share(cfg, args, step_ms: float, torch) -> None:
    """The hybrid's SSM branch alone (``models/ssm.py``) at one worker's
    shape of the step from the zero state: forward, and forward +
    backward, timed on the host and profiled for launches, scaled to the
    step (under remat a step runs the forward twice and the backward once
    a layer and worker) and set against the timed step's wall."""
    from repro_torch.models import ssm_branch
    d, H, hd, N = cfg.d_model, cfg.n_heads, cfg.hd, cfg.ssm_state
    B = args.batch // args.workers
    gen = torch.Generator(device="cuda").manual_seed(31)

    def w(*shape):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * shape[0] ** -0.5).requires_grad_()
    p = {"w_in": w(d, H * hd), "w_gate": w(d, H * hd), "w_dt": w(d, H),
         "dt_bias": torch.zeros(H, device="cuda", requires_grad=True),
         "a_log": torch.log(torch.linspace(1.0, 16.0, H, device="cuda"))
         .requires_grad_(),
         "w_B": w(d, N), "w_C": w(d, N), "w_out": w(H * hd, d)}
    x = torch.randn(B, args.seq, d, device="cuda", generator=gen).to(
        getattr(torch, cfg.dtype)).requires_grad_()
    S0 = torch.zeros(B, H, N, hd, device="cuda", dtype=x.dtype)

    def fwd():                      # the graph is built, then dropped
        ssm_branch(p, x, cfg, S0)

    def fwd_bwd():
        y, _ = ssm_branch(p, x, cfg, S0)
        torch.autograd.grad(y.float().sum(), [x, *p.values()])

    f_ms, fb_ms = host_ms(fwd, torch), host_ms(fwd_bwd, torch)
    kf, kfb = profiled(fwd, torch), profiled(fwd_bwd, torch)
    n_f, n_fb = (sum(v[1] for v in k.values()) for k in (kf, kfb))
    dev_f, dev_fb = (sum(v[0] for v in k.values()) for k in (kf, kfb))
    per_step = cfg.n_layers * args.workers
    ssm_ms = per_step * (f_ms + fb_ms)
    print(f"SSM branch alone (ssm_branch, one layer, B {B} T {args.seq} "
          f"{cfg.dtype}): forward {f_ms:.2f} ms on the host ({n_f} "
          f"launches, {dev_f:.2f} ms of device time), forward + backward "
          f"{fb_ms:.2f} ms ({n_fb} launches, {dev_fb:.2f} ms device); x "
          f"{cfg.n_layers} layers x {args.workers} workers, the forward "
          f"twice under remat: ~{per_step * (n_f + n_fb):,} launches, "
          f"~{ssm_ms:.0f} ms of host time, {ssm_ms / step_ms:.1%} of the "
          f"{step_ms:.0f} ms timed step")


def moe_share(cfg, args, torch) -> None:
    """One ``moe_mlp`` forward + backward at one worker's tokens of the
    step, profiled: the expert products (cuBLAS) against the routing,
    scatter, gather and the rest."""
    from repro_torch.models import moe_mlp
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    S = args.batch // args.workers * args.seq
    dt = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device="cuda").manual_seed(37)

    def w(*shape):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * shape[-2] ** -0.5).to(dt).requires_grad_()
    ws = [w(d, E), w(E, d, ff), w(E, d, ff), w(E, ff, d)]
    x = torch.randn(S, d, device="cuda", generator=gen).to(
        getattr(torch, cfg.dtype)).requires_grad_()

    def fwd_bwd():
        y, aux = moe_mlp(x, *ws, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor)
        torch.autograd.grad(y.float().sum() + aux, [x, *ws])

    ms = host_ms(fwd_bwd, torch)
    k = profiled(fwd_bwd, torch)
    prod = {n: v for n, v in k.items() if classify(n) == "matmul (cuBLAS)"}
    rest = {n: v for n, v in k.items() if n not in prod}
    p_ms, r_ms = (sum(v[0] for v in g.values()) for g in (prod, rest))
    p_n, r_n = (sum(v[1] for v in g.values()) for g in (prod, rest))
    top = sorted(((v[0], n) for n, v in rest.items()), reverse=True)[:4]
    print(f"expert layer alone (moe_mlp, {S} tokens, {E} experts top-"
          f"{cfg.top_k}, d {d}, d_ff {ff}), forward + backward: {ms:.2f} ms "
          f"on the host; device {p_ms + r_ms:.2f} ms: expert products "
          f"{p_ms:.2f} ms ({p_n} launches, {p_ms / (p_ms + r_ms):.1%}), "
          f"routing/scatter/gather and the rest {r_ms:.2f} ms ({r_n} "
          f"launches); the largest of those: "
          + "; ".join(f"{n[:60]} {t:.2f} ms" for t, n in top))


def scan_share(cfg, args, torch) -> None:
    """The chunked scan alone at one worker's shape of the step: forward
    and forward + backward of ``rwkv_chunked`` (CUDA events, median of
    10), scaled to the step (the layers, the workers, and a second forward
    under remat)."""
    from repro_torch.models.rwkv import rwkv_chunked
    B = args.batch // args.workers
    H, hd = cfg.n_heads, cfg.hd
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (B, args.seq, H, hd)
    r, k, v = (torch.randn(shape, device="cuda", generator=gen)
               .to(getattr(torch, cfg.dtype)).requires_grad_()
               for _ in range(3))
    w = (torch.rand(shape, device="cuda", generator=gen) * 0.1 + 0.9) \
        .to(r.dtype).requires_grad_()
    u = torch.randn(H, hd, device="cuda", generator=gen).requires_grad_()
    S0 = torch.zeros(B, H, hd, hd, device="cuda", dtype=r.dtype)

    def fwd():
        with torch.no_grad():
            rwkv_chunked(r, k, v, w, u, S0)

    def fwd_bwd():
        y, _ = rwkv_chunked(r, k, v, w, u, S0)
        torch.autograd.grad(y.float().sum(), (r, k, v, w, u))

    def median(fn):
        for _ in range(2):
            fn()
        times = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[5]
    f_ms, fb_ms = median(fwd), median(fwd_bwd)
    per_step = cfg.n_layers * args.workers * (f_ms + fb_ms)
    print(f"chunked scan alone (rwkv_chunked, B {B} T {args.seq} H {H} hd "
          f"{hd} {cfg.dtype}): forward {f_ms:.3f} ms, forward + backward "
          f"{fb_ms:.3f} ms (wall, events around the host's launches); x "
          f"{cfg.n_layers} layers x {args.workers} workers with the remat's "
          f"second forward: {per_step:.1f} ms a step")


if __name__ == "__main__":
    main()
