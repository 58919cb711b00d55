#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the CUDA kernels from
   the sources in this checkout (one nvcc per source, all started together).
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (full llama3.2-1b, 32 KB chunks, 4 workers: p/m
   (150860, 8192) f32, g (4, 150860, 8192)), bitwise, and times kernel,
   plain version, HBM bound and the torch.optim.SGD(nesterov, fused) step
   that computes the same update (a yardstick the port never calls).
   Small bf16 and W=3 cases are held bitwise too.
3. Holds one 4-worker step of a reduced llama3.2-1b on the card against
   the same step on the CPU (plain versions), from the same weights.
4. Main path: PHubEngine + fit, sharded_ps, full-width full-depth
   llama3.2-1b, 4 stacked workers, global batch 8 x 512 tokens, 3 steps,
   Nesterov at the TrainConfig defaults.  Checks finite losses, changed
   parameters, and that every step's update launched multi_agg_opt_chunks.
5. The same with 1 worker, 1 step, through agg_opt_chunks.
6. Prints the kernels line, then the device line last.

Any failed check raises and the script exits non-zero.  It needs one CUDA
card and refuses to run without one.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
CARD_SOURCE = "src/repro_torch/kernels/agg_opt/csrc/agg_opt.cu"
REPLACES = {"agg_opt_chunks": "src/repro/kernels/agg_opt/kernel.py:38",
            "multi_agg_opt_chunks": "src/repro/kernels/agg_opt/kernel.py:187"}

ARCH, WORKERS, BATCH, SEQ, STEPS = "llama3.2-1b", 4, 8, 512, 3


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def median_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_ulp(torch, a, b) -> int:
    """Largest distance in units in the last place between two float
    tensors of one dtype (f32 or bf16), in slices to bound memory."""
    ity = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    a, b = a.reshape(-1), b.reshape(-1)
    worst, step = 0, 1 << 26
    for i in range(0, a.numel(), step):
        ia = a[i:i + step].view(ity).to(torch.int64)
        ib = b[i:i + step].view(ity).to(torch.int64)
        sign = torch.iinfo(ity).min
        oa = torch.where(ia < 0, sign - ia, ia)
        ob = torch.where(ib < 0, sign - ib, ib)
        worst = max(worst, int((oa - ob).abs().max()))
    return worst


def compare(torch, got, want) -> tuple[float, int]:
    """(max |got - want|, max ulp) over pairs of tensors."""
    err, ulp = 0.0, 0
    for g, w in zip(got, want):
        err = max(err, float((g.float() - w.float()).abs().max()))
        if not torch.equal(g, w):
            ulp = max(ulp, max_ulp(torch, g, w))
    return err, ulp


def kernel_phase(torch, sizes: dict, lr: float, mu: float) -> dict:
    """Kernels vs plain versions at the main path's shapes ({kernel name:
    padded domain length}); timings."""
    from repro_torch.kernels.agg_opt import (agg_opt_ref, fused_agg_opt,
                                             fused_multi_agg_opt,
                                             multi_agg_opt_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_elems = max(sizes.values())
    p = torch.empty(n_elems, device=dev).normal_(0, 0.02, generator=gen)
    m = torch.empty(n_elems, device=dev).normal_(0, 1e-3, generator=gen)
    g = torch.empty(WORKERS, n_elems, device=dev).normal_(0, 1e-3,
                                                          generator=gen)
    n1, nw = sizes["agg_opt_chunks"], sizes["multi_agg_opt_chunks"]
    check(nw == n_elems, "the stacked domain is the largest")
    cases = {
        "agg_opt_chunks": (fused_agg_opt, agg_opt_ref, p[:n1], g[0, :n1],
                           m[:n1], 1),
        "multi_agg_opt_chunks": (fused_multi_agg_opt, multi_agg_opt_ref, p,
                                 g, m, WORKERS),
    }
    out = {}
    for name, (kern, plain, pp, gg, mm, W) in cases.items():
        got = kern(pp, gg, mm, lr=lr, momentum=mu)
        want = plain(pp, gg, mm, lr=lr, momentum=mu)
        torch.cuda.synchronize()
        err, ulp = compare(torch, got, want)
        del got, want
        log(f"{name}: p/m {(pp.numel() // 8192, 8192)} g "
            f"{(*gg.shape[:-1], pp.numel() // 8192, 8192)} f32: "
            f"max_abs {err:.3e} max_ulp {ulp}")
        check(ulp == 0, f"{name} differs from its plain version "
                        f"(max_ulp {ulp}); the kernel claims bitwise")
        kernel_ms = median_ms(torch, lambda: kern(pp, gg, mm, lr=lr,
                                                  momentum=mu), reps=10)
        plain_ms = median_ms(torch, lambda: plain(pp, gg, mm, lr=lr,
                                                  momentum=mu), reps=3)
        lp = torch.nn.Parameter(pp.clone())
        sgd = torch.optim.SGD([lp], lr=lr, momentum=mu, nesterov=True,
                              fused=True)

        def library_step():
            lp.grad = gg.mean(0) if W > 1 else gg
            sgd.step()
        library_ms = median_ms(torch, library_step, reps=5)
        del lp, sgd
        gc.collect()
        torch.cuda.empty_cache()
        n_bytes = (W + 4) * pp.numel() * pp.element_size()
        n_ops = (W - 1 + 7) * pp.numel()
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS_PER_S) * 1e3
        bound_by = ("bytes" if n_bytes / HBM_BYTES_PER_S
                    >= n_ops / F32_FLOPS_PER_S else "operations")
        log(f"{name}: kernel {kernel_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}, {n_bytes / 1e9:.2f} GB), plain {plain_ms:.3f} ms, "
            f"library {library_ms:.3f} ms (SGD nesterov fused"
            f"{' after g.mean(0)' if W > 1 else ''})")
        out[name] = {"name": name, "route": "cuda", "source": CARD_SOURCE,
                     "replaces": REPLACES[name], "launches": 0,
                     "max_abs_err": err, "max_ulp": ulp, "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
    del p, m, g, pp, gg, mm, cases
    gc.collect()
    torch.cuda.empty_cache()

    # small bitwise cases: bf16, W=3 (division, not 1/W), a ragged tail
    n = 8192 * 37 + 100
    for dtype, W in ((torch.bfloat16, 1), (torch.bfloat16, 4),
                     (torch.float32, 3)):
        p = torch.randn(n, device=dev, generator=gen).to(dtype)
        m = torch.randn(n, device=dev, generator=gen).to(dtype)
        g = torch.randn(W, n, device=dev, generator=gen).to(dtype)
        if W == 1:
            got = fused_agg_opt(p, g[0], m, lr=lr, momentum=mu)
            want = agg_opt_ref(p, g[0], m, lr=lr, momentum=mu)
        else:
            got = fused_multi_agg_opt(p, g, m, lr=lr, momentum=mu)
            want = multi_agg_opt_ref(p, g, m, lr=lr, momentum=mu)
        err, ulp = compare(torch, got, want)
        log(f"small case {dtype} W={W} n={n}: max_abs {err:.3e} "
            f"max_ulp {ulp}")
        check(ulp == 0, f"small case {dtype} W={W} not bitwise")
    return out


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict)
            else v.detach().clone().to(device) for k, v in tree.items()}


def reference_phase(torch) -> None:
    """One 4-worker step of a reduced model: card (kernel) vs CPU (plain
    versions), same weights and batch."""
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import DecoderLM

    cfg = reduced(get_arch(ARCH))
    tc = TrainConfig(loss_chunk=64)
    eng_cpu = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cpu")
    eng_gpu = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cuda")
    model_c, opt_c = eng_cpu.init_state()
    model_g = DecoderLM(cfg, device="cuda",
                        params=tree_to(model_c.param_tree(), "cuda"))
    opt_g = eng_gpu.init_opt()
    data = SyntheticTokens(cfg, BATCH, 64, seed=0)
    _, opt_c, met_c = eng_cpu.make_train_step()(model_c, opt_c,
                                                data.torch_batch(0, "cpu"))
    _, opt_g, met_g = eng_gpu.make_train_step()(model_g, opt_g,
                                                data.torch_batch(0, "cuda"))
    dloss = abs(float(met_c["loss"]) - float(met_g["loss"]))
    dparam = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for (_, a), (_, b) in zip(leaf_paths(model_g.param_tree()),
                                           leaf_paths(model_c.param_tree())))
    dmom = float((opt_g["float32"]["m"].cpu() - opt_c["float32"]["m"])
                 .abs().max())
    log(f"reduced {ARCH} (d_model={cfg.d_model}, {cfg.n_layers} layers), "
        f"{WORKERS} workers, 1 step, card vs CPU: loss {float(met_g['loss']):.6f}"
        f" |dloss| {dloss:.3e}, max |dparam| {dparam:.3e}, "
        f"max |dmomentum| {dmom:.3e}")
    # f32 products summed in another order on each device, bf16 activations
    check(dloss <= 1e-3, f"card loss differs from CPU loss by {dloss}")
    check(dparam <= 1e-4 and dmom <= 1e-2,
          f"card step differs from CPU step: params {dparam}, momentum {dmom}")


def main_path(torch, workers: int, steps: int, kernel: str) -> int:
    """PHubEngine + fit on the full model; returns how often ``kernel``
    launched in that run."""
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels.agg_opt import LAUNCHES, reset_launches
    from repro_torch.training import TrainState, fit

    cfg = get_arch(ARCH)
    tc = TrainConfig(loss_chunk=min(1024, SEQ))
    engine = PHubEngine(cfg, tc, StackedComm(workers), device="cuda")
    model, opt = engine.init_state()
    groups = engine.chunk_plan.groups
    log(f"main path: {ARCH} {cfg.n_params():,} params, {cfg.n_layers} "
        f"layers, d_model {cfg.d_model}; sharded_ps, {workers} stacked "
        f"worker(s), batch {BATCH} x {SEQ}, {steps} step(s), lr {tc.lr}, "
        f"momentum {tc.momentum}; groups "
        + ", ".join(f"{g.key}: {g.total:,} -> {g.padded:,} "
                    f"({g.n_chunks} chunks of {g.chunk_elems})"
                    for g in groups))
    before = {p: t.detach().reshape(-1)[:4096].clone()
              for p, t in leaf_paths(model.param_tree())}
    data = SyntheticTokens(cfg, BATCH, SEQ, seed=tc.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [time.perf_counter()]

    def on_step(state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        ms = (marks[-1] - marks[-2]) * 1e3
        log(f"step {state.step - 1}: loss {state.losses[-1]:.6f}  "
            f"{ms:.1f} ms  {BATCH * SEQ / (ms / 1e3):,.0f} tokens/s  "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats()

    reset_launches()
    state = fit(engine, TrainState(params=model, opt=opt), data,
                steps=steps, log_every=0, hooks=[on_step])
    launches = dict(LAUNCHES)
    check(all(math.isfinite(x) for x in state.losses),
          f"non-finite loss {state.losses}")
    check(len(state.losses) == steps, f"{len(state.losses)} losses")
    for p, t in leaf_paths(model.param_tree()):
        check(not torch.equal(before[p], t.detach().reshape(-1)[:4096]),
              f"parameter {p} did not change")
    want = steps * len(groups)
    check(launches[kernel] == want,
          f"{kernel} launched {launches[kernel]} times, want {want}")
    other = ({"agg_opt_chunks", "multi_agg_opt_chunks"} - {kernel}).pop()
    check(launches[other] == 0, f"{other} launched {launches[other]} times")
    log(f"{workers}-worker path: every update through {kernel} "
        f"({launches[kernel]} launches), parameters changed, losses finite")
    del model, opt, state, engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches[kernel]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script drives the "
                         "port on the card and has no CPU mode")
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = _build.build(["agg_opt"])
    log(f"kernels built from source in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name} ptxas: {line.strip()}")

    tc = TrainConfig()
    sizes = {}
    for name, W in (("agg_opt_chunks", 1), ("multi_agg_opt_chunks", WORKERS)):
        (group,) = PHubEngine(get_arch(ARCH), tc, StackedComm(W),
                              device="cuda").chunk_plan.groups
        sizes[name] = group.padded
    kernels = kernel_phase(torch, sizes, tc.lr, tc.momentum)
    reference_phase(torch)
    kernels["multi_agg_opt_chunks"]["launches"] = main_path(
        torch, WORKERS, STEPS, "multi_agg_opt_chunks")
    kernels["agg_opt_chunks"]["launches"] = main_path(
        torch, 1, 1, "agg_opt_chunks")
    for k in kernels.values():
        k["verdict"] = "bitwise" if k["max_ulp"] == 0 else "differs"
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
