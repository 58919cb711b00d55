#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the CUDA kernels from
   the sources in this checkout (one nvcc per source, all started together).
2. Holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (full llama3.2-1b, 32 KB chunks: p (150860, 8192) f32,
   g (4, 150860, 8192) for 4 workers; (150857, 8192) for 1), bitwise, and
   times kernel, plain version, HBM bound and the torch.optim step closest
   to the same update (a yardstick the port never calls):
   - Nesterov (agg_opt_chunks W=1, multi_agg_opt_chunks W=4) against
     torch.optim.SGD(nesterov, fused);
   - sgd_opt_chunks and adam_opt_chunks, W=4 and W=1, against
     torch.optim.SGD(fused) and torch.optim.Adam(fused).  Adam updates its
     slots in place, so its inputs are drawn span by span from seeds and
     drawn again for the comparison, which runs span by span.
   Small bf16, W=3 and ragged cases are held bitwise too.  The stacked
   rules (multi_agg_opt_chunks, and sgd/adam_opt_chunks at W=4) run again
   with the mean's divisor read from the card (set to W: the same bits).
   health_chunks (the sanity gate's sum of squares per chunk) at the
   gated W=4 step's domain (4 x 150860 chunks of 8192) with a NaN, an Inf,
   an overflowing (1e20) and an all-zero chunk in it, and at W=1 (150857
   chunks), against its plain version (the kernel's order, step by step),
   beside torch.linalg.vector_norm per chunk (it takes the root too: a
   yardstick); a small bf16 case.
   The int8 wire's kernels at the int8 W=4 main path's shapes (the whole
   stacked domain, 150860 chunks of 8192): quantize_chunks and
   dequantize_chunks (payload and scales equal), and dequant_agg_opt_chunks
   reading the owners' rows on the block diagonal of the (4, n) buffer,
   each against its plain version span by span, timed beside its bound
   and a PyTorch yardstick (torch.quantize_per_channel, QTensor.dequantize,
   the fused nesterov SGD step on a decoded g: none the same function).
3. Holds one 4-worker step of a reduced llama3.2-1b on the card against
   the same step on the CPU (plain versions), from the same weights, under
   Nesterov and under Adam (eps 1e-3, where the step is Lipschitz in the
   gradient: |dp| <= lr * |dg| / eps), and under Nesterov over the int8
   and the bf16 wires, within a bound built from the grid steps the
   script measures (a card-vs-CPU difference of an ulp can move an encoded
   entry by one step).  The sanity-gated step with worker 1 NaN-poisoned,
   under Nesterov, SGD and Adam, at f32 activations (so the two devices'
   gradients differ by summation order only): ok_mask [1, 0, 1, 1] and
   n_live 3 exact, grad_norms within rtol 1e-5, parameters within the
   rule's bound above (SGD's first step moves less than Nesterov's: the
   Nesterov bound); on the card the gated step equals the static k-of-n
   step with worker 1 dead, bitwise.
4. Rollback, on a reduced llama3.2-1b (a full-model snapshot is 9.9 GB of
   disk I/O, not device work): 4 workers, a snapshot every step, keep_k 2,
   every worker NaN-pushing for divergence_patience steps and the newest
   snapshot truncated: the supervisor skips the corrupt snapshot by name,
   restores the last verified one (parameters and every slot bitwise
   equal to load_checkpoint's) and finishes.
5. Main paths: PHubEngine + fit, sharded_ps, full-width full-depth
   llama3.2-1b, global batch 8 x 512 tokens:
   - Nesterov at the TrainConfig defaults, 4 stacked workers, 3 steps
     (multi_agg_opt_chunks), and 1 worker, 1 step (agg_opt_chunks);
   - Adam at lr 3e-4, 4 workers, 3 steps, and 1 worker, 1 step
     (adam_opt_chunks);
   - SGD at lr 1e-2, 4 workers, 1 step, and 1 worker, 1 step
     (sgd_opt_chunks);
   - over the int8 wire: Nesterov, 4 workers, 3 steps (each step 4
     quantize_chunks, 3 dequantize_chunks, 1 dequant_agg_opt_chunks) and
     1 worker, 1 step (1, 1 and agg_opt_chunks); SGD and Adam, 4 workers,
     1 step each (4 quantize, 4 dequantize and the rule's kernel);
   - the self-healing path: fit(supervisor=TrainSupervisor), Nesterov, 4
     workers, 4 steps, a FaultSchedule NaN-poisoning worker 1 at steps 1
     and 2, demote_after 2: ok_mask [1,1,1,1], [1,0,1,1], [1,0,1,1], a
     demotion at step 2, step 3 on the static 3-of-4 program (each step
     one health_chunks and one multi_agg_opt_chunks launch).
   Each checks finite losses, changed parameters, and that every kernel
   launched as often as the path's expected counts say, every other count
   staying 0.
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
QUANT_SOURCE = "src/repro_torch/kernels/quant/csrc/quant.cu"
REPLACES = {"agg_opt_chunks": "src/repro/kernels/agg_opt/kernel.py:38",
            "multi_agg_opt_chunks": "src/repro/kernels/agg_opt/kernel.py:187",
            "sgd_opt_chunks": "src/repro/kernels/agg_opt/kernel.py:60",
            "adam_opt_chunks": "src/repro/kernels/agg_opt/kernel.py:100",
            "quantize_chunks": "src/repro/kernels/quant/kernel.py:34",
            "dequantize_chunks": "src/repro/kernels/quant/kernel.py:55",
            "dequant_agg_opt_chunks":
                "src/repro/kernels/agg_opt/kernel.py:139",
            "health_chunks": "src/repro/kernels/agg_opt/kernel.py:173"}

ARCH, WORKERS, BATCH, SEQ, STEPS = "llama3.2-1b", 4, 8, 512, 3
ADAM_LR, SGD_LR = 3e-4, 1e-2
ADAM_REF_EPS = 1e-3              # card-vs-CPU Adam step (docstring, 3.)
SPAN = 1 << 26                   # elements per span of the Adam/SGD checks
NORM_RTOL = 1e-5                 # card vs CPU grad_norms (f32 sums' order)
POISONED = 1                     # the worker the gated phases poison


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


def bound(n: int, n_bytes_per: int, n_ops_per: int,
          extra_bytes: int = 0) -> tuple[float, str]:
    """(least ms, what bounds it) for n elements (and ``extra_bytes``
    beside them, such as one scale a chunk)."""
    t_bytes = (n * n_bytes_per + extra_bytes) / HBM_BYTES_PER_S
    t_ops = n * n_ops_per / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
        divisor_ms = None
        if W > 1:
            # the mean's divisor read from the card, set to W: same bits
            d = torch.tensor([float(W)], device=dev)
            got = kern(pp, gg, mm, lr=lr, momentum=mu)
            got_d = kern(pp, gg, mm, lr=lr, momentum=mu, divisor=d)
            check(all(torch.equal(a, b) for a, b in zip(got, got_d)),
                  f"{name} with the device divisor {W} differs from /W")
            del got, got_d
            divisor_ms = median_ms(torch, lambda: kern(
                pp, gg, mm, lr=lr, momentum=mu, divisor=d), reps=10)
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
        n_bytes = (W + 4) * pp.element_size()
        bound_ms, bound_by = bound(pp.numel(), n_bytes, W - 1 + 7)
        log(f"{name}: kernel {kernel_ms:.3f} ms"
            + (f" ({divisor_ms:.3f} ms with the device divisor)"
               if divisor_ms else "")
            + f", bound {bound_ms:.3f} ms "
            f"({bound_by}, {n_bytes * pp.numel() / 1e9:.2f} GB), plain "
            f"{plain_ms:.3f} ms, "
            f"library {library_ms:.3f} ms (SGD nesterov fused"
            f"{' after g.mean(0)' if W > 1 else ''})")
        out[name] = {"name": name, "route": "cuda", "source": CARD_SOURCE,
                     "replaces": REPLACES[name], "launches": 0,
                     "max_abs_err": err, "max_ulp": ulp, "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
        if divisor_ms:
            out[name]["divisor_ms"] = divisor_ms
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


def draw(torch, kind: str, n: int, seed: int):
    """``n`` f32 values of one kernel-phase input, from their own seed, so
    a span drawn into a full vector can be drawn again to compare it.
    Gradients have exact zeros (every 17th entry) and k1/k2 dead runs
    (every 11th), so Adam's alive gate and its k1' == 0 mask both fire."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.empty(n, device="cuda")
    if kind == "p":
        x.normal_(0, 0.02, generator=gen)
    elif kind in ("g", "m"):
        x.normal_(0, 1e-3, generator=gen)
    elif kind == "v":
        x.uniform_(0, 1e-6, generator=gen)
    else:                                       # k1, k2
        x.uniform_(0, 1, generator=gen)
    if kind in ("g", "k1", "k2"):
        x[::17 if kind == "g" else 11] = 0
    return x


KINDS = ("p", "g", "m", "v", "k1", "k2")


def span_seed(kind: str, w: int, i: int) -> int:
    return 1_000_000 + 1000 * i + 10 * KINDS.index(kind) + w


def spans(n: int):
    return [(i, lo, min(lo + SPAN, n)) for i, lo in enumerate(range(0, n,
                                                                    SPAN))]


def fill(torch, t, kind: str, w: int = 0) -> None:
    for i, lo, hi in spans(t.numel()):
        t[lo:hi].copy_(draw(torch, kind, hi - lo, span_seed(kind, w, i)))


def rule_kernel_phase(torch, sizes: dict) -> dict:
    """sgd_opt_chunks and adam_opt_chunks against their plain versions at
    the main paths' shapes (W=4 over ``sizes[4]`` elements, W=1 over
    ``sizes[1]``), span by span; timings.  Returns the kernels-line
    entries, with the W=4 numbers at the top level and the W=1 ones under
    "w1"."""
    from repro_torch.kernels.agg_opt import (adam_opt_ref, fused_adam_opt,
                                             fused_sgd_opt, sgd_opt_ref)
    n4 = sizes[WORKERS]
    check(sizes[1] <= n4, "the stacked domain is the largest")
    adam_kw = dict(lr=ADAM_LR, b1=0.9, b2=0.999, eps=1e-8)
    p = torch.empty(n4, device="cuda")
    g = torch.empty(WORKERS, n4, device="cuda")
    slots = [torch.empty(n4, device="cuda") for _ in range(4)]
    fill(torch, p, "p")
    for w in range(WORKERS):
        fill(torch, g[w], "g", w)

    def fill_slots():
        for t, kind in zip(slots, KINDS[2:]):
            fill(torch, t, kind)

    def drawn(i, lo, hi, W):
        """The inputs of span i, drawn again: p, g ((W, len) or (len,)),
        m, v, k1, k2."""
        gs = torch.stack([draw(torch, "g", hi - lo, span_seed("g", w, i))
                          for w in range(W)])
        return (draw(torch, "p", hi - lo, span_seed("p", 0, i)),
                gs if W > 1 else gs[0],
                *(draw(torch, k, hi - lo, span_seed(k, 0, i))
                  for k in KINDS[2:]))

    def held(name, W, n, run, plain, n_bytes, n_ops, state, timed=True):
        """Run the kernel once over n elements, hold every output against
        ``plain`` on the span's inputs drawn again, then time both (the
        plain version span by span over the current ``state``)."""
        got = run()
        torch.cuda.synchronize()
        err, ulp = 0.0, 0
        for i, lo, hi in spans(n):
            e, u = compare(torch, [t[lo:hi] for t in got],
                           plain(*drawn(i, lo, hi, W)))
            err, ulp = max(err, e), max(ulp, u)
        del got
        log(f"{name} W={W}: p ({n // 8192}, 8192) f32, g "
            f"{(W, n // 8192, 8192) if W > 1 else (n // 8192, 8192)}"
            f"{'' if timed else ', divisor read from the card'}: "
            f"max_abs {err:.3e} max_ulp {ulp}")
        check(ulp == 0, f"{name} W={W} differs from its plain version "
                        f"(max_ulp {ulp}); the kernel claims bitwise")
        kernel_ms = median_ms(torch, run, reps=10)
        if not timed:
            return {"divisor_ms": kernel_ms}

        def plain_spans():
            for _, lo, hi in spans(n):
                plain(*(t[..., lo:hi] for t in state))
        plain_ms = median_ms(torch, plain_spans, reps=3, warmup=1)
        bound_ms, bound_by = bound(n, n_bytes, n_ops)
        return {"max_abs_err": err, "max_ulp": ulp, "ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}

    out = {name: {"name": name, "route": "cuda", "source": CARD_SOURCE,
                  "replaces": REPLACES[name], "launches": 0}
           for name in ("adam_opt_chunks", "sgd_opt_chunks")}
    for W in (WORKERS, 1):
        n = sizes[W]
        pp, gg = p[:n], (g[:, :n] if W > 1 else g[0, :n])
        check(gg.is_contiguous(), "the gradients are whole rows")
        ss = [t[:n] for t in slots]
        fill_slots()          # Adam updates them in place: draw them afresh
        nums = {
            "adam_opt_chunks": held(
                "adam_opt_chunks", W, n,
                lambda: (fused_adam_opt(pp, gg, *ss, **adam_kw)[0], *ss),
                lambda *a: adam_opt_ref(*a, **adam_kw),
                4 * (W + 10), W + 22, (pp, gg, *ss)),
            "sgd_opt_chunks": held(
                "sgd_opt_chunks", W, n,
                lambda: (fused_sgd_opt(pp, gg, lr=SGD_LR),),
                lambda p_, g_, *_: (sgd_opt_ref(p_, g_, lr=SGD_LR),),
                4 * (W + 2), W + 2, (pp, gg))}
        if W > 1:
            # the mean's divisor read from the card, set to W: the plain
            # version divides by W too, so the bits are the /W path's
            d = torch.tensor([float(W)], device="cuda")
            fill_slots()
            nums["adam_opt_chunks"].update(held(
                "adam_opt_chunks", W, n,
                lambda: (fused_adam_opt(pp, gg, *ss, divisor=d,
                                        **adam_kw)[0], *ss),
                lambda *a: adam_opt_ref(*a, **adam_kw),
                0, 0, (), timed=False))
            nums["sgd_opt_chunks"].update(held(
                "sgd_opt_chunks", W, n,
                lambda: (fused_sgd_opt(pp, gg, lr=SGD_LR, divisor=d),),
                lambda p_, g_, *_: (sgd_opt_ref(p_, g_, lr=SGD_LR),),
                0, 0, (), timed=False))
        for name, e in nums.items():
            if W > 1:
                out[name].update(e)
            else:
                out[name]["w1"] = e
    del slots, ss
    gc.collect()
    torch.cuda.empty_cache()

    # the closest torch.optim steps: textbook Adam (scalar bias correction,
    # eps outside the root) moves 7 arrays, not 11; SGD without momentum
    for W in (WORKERS, 1):
        n = sizes[W]
        gg = g[:, :n] if W > 1 else g[0, :n]
        for name, make in (
                ("adam_opt_chunks", lambda ps: torch.optim.Adam(
                    ps, lr=ADAM_LR, fused=True)),
                ("sgd_opt_chunks", lambda ps: torch.optim.SGD(
                    ps, lr=SGD_LR, fused=True))):
            lp = torch.nn.Parameter(p[:n].clone())
            opt = make([lp])

            def library_step():
                lp.grad = gg.mean(0) if W > 1 else gg
                opt.step()
            library_ms = median_ms(torch, library_step, reps=5)
            del lp, opt
            gc.collect()
            torch.cuda.empty_cache()
            nums = out[name] if W > 1 else out[name]["w1"]
            nums["library_ms"] = library_ms
    for name, e in out.items():
        for W, nums in ((WORKERS, e), (1, e["w1"])):
            if "divisor_ms" in nums:
                log(f"{name} W={W}: {nums['divisor_ms']:.3f} ms with the "
                    f"device divisor")
            log(f"{name} W={W}: kernel {nums['ms']:.3f} ms, bound "
                f"{nums['bound_ms']:.3f} ms ({nums['bound_by']}), plain "
                f"{nums['plain_ms']:.3f} ms, library {nums['library_ms']:.3f}"
                f" ms (torch.optim.{'Adam' if 'adam' in name else 'SGD'} "
                f"fused{' after g.mean(0)' if W > 1 else ''})")
    del p, g
    gc.collect()
    torch.cuda.empty_cache()

    # small bitwise cases: bf16, W=3 (division, not 1/W), ragged tails
    # (the wrapper pads copies of the slots and copies them back)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for dtype, W, n in ((torch.bfloat16, 1, 8192 * 37 + 100),
                        (torch.bfloat16, 4, 8192 * 37),
                        (torch.float32, 3, 8192 * 37 + 100)):
        pp = torch.randn(n, device="cuda", generator=gen).to(dtype)
        gs = (torch.randn(W, n, device="cuda", generator=gen) * 1e-2)
        gs[:, ::13] = 0
        gs = gs.to(dtype)
        gg = gs if W > 1 else gs[0]
        m = (torch.randn(n, device="cuda", generator=gen) * 1e-2).to(dtype)
        v = (torch.rand(n, device="cuda", generator=gen) * 1e-4).to(dtype)
        k1, k2 = (torch.rand(n, device="cuda", generator=gen)
                  for _ in range(2))
        k1[::7] = 0
        k2[::7] = 0
        want = adam_opt_ref(pp, gg, m, v, k1, k2, **adam_kw)
        got = fused_adam_opt(pp, gg, m, v, k1, k2, **adam_kw)
        check(all(a is b for a, b in zip(got[1:], (m, v, k1, k2))),
              "fused_adam_opt returns its slots, updated in place")
        err, ulp = compare(torch, got, want)
        e2, u2 = compare(torch, (fused_sgd_opt(pp, gg, lr=SGD_LR),),
                         (sgd_opt_ref(pp, gg, lr=SGD_LR),))
        log(f"small case {dtype} W={W} n={n}: adam max_abs {err:.3e} "
            f"max_ulp {ulp}; sgd max_abs {e2:.3e} max_ulp {u2}")
        check(ulp == 0 and u2 == 0, f"small case {dtype} W={W} not bitwise")
    return out


def diag_span(torch, g, lo: int, hi: int):
    """Elements [lo, hi) of the block diagonal of the stacked (S, n)
    buffer g: element i of shard j = i // (n / S) lies in row j."""
    S, n = g.shape
    L = n // S
    return torch.cat([g[j, max(lo, j * L):min(hi, (j + 1) * L)]
                      for j in range(S) if j * L < hi and lo < (j + 1) * L])


def wire_kernel_phase(torch, n: int, ce: int, lr: float, mu: float) -> dict:
    """The int8 wire's kernels at the int8 W=4 main path's shapes: the
    whole (n,) stacked domain in chunks of ``ce``; span by span against
    their plain versions; timings.  Returns the kernels-line entries."""
    from repro_torch.kernels.agg_opt import (dequant_agg_opt_ref,
                                             fused_dequant_agg_opt)
    from repro_torch.kernels.quant import (dequantize_int8,
                                           dequantize_int8_ref,
                                           quantize_int8, quantize_int8_ref)
    check(SPAN % ce == 0, "spans are whole chunks")
    nc = n // ce
    x = torch.empty(n, device="cuda")
    fill(torch, x, "g")
    x[:ce] = 0                                 # an all-zero chunk: scale 1
    q, s = quantize_int8(x, chunk_elems=ce)
    d = dequantize_int8(q, s, chunk_elems=ce)
    torch.cuda.synchronize()
    q_err = s_ulp = d_err = d_ulp = 0
    for _, lo, hi in spans(n):
        qr, sr = quantize_int8_ref(x[lo:hi], ce)
        q_err = max(q_err, int((q[lo:hi].int() - qr.int()).abs().max()))
        s_ulp = max(s_ulp, compare(torch, [s[lo // ce:hi // ce]], [sr])[1])
        e, u = compare(torch, [d[lo:hi]],
                       [dequantize_int8_ref(q[lo:hi], s[lo // ce:hi // ce],
                                            ce)])
        d_err, d_ulp = max(d_err, e), max(d_ulp, u)
    log(f"quantize_chunks: x ({nc}, {ce}) f32 -> q int8, scales ({nc},): "
        f"max |dq| {q_err}, scales max_ulp {s_ulp}; scale of the zero chunk "
        f"{float(s[0])}")
    log(f"dequantize_chunks: ({nc}, {ce}) int8 -> f32: max_abs {d_err:.3e} "
        f"max_ulp {d_ulp}")
    check(q_err == 0 and s_ulp == 0 and float(s[0]) == 1.0,
          "quantize_chunks differs from its plain version")
    check(d_ulp == 0, "dequantize_chunks differs from its plain version")
    del d
    out = {}

    def timed(name, run, plain_spans, library, library_label, n_bytes,
              n_ops, extra_bytes, err, ulp, source):
        kernel_ms = median_ms(torch, run, reps=10)
        plain_ms = median_ms(torch, plain_spans, reps=3, warmup=1)
        library_ms = median_ms(torch, library, reps=5)
        bound_ms, bound_by = bound(n, n_bytes, n_ops, extra_bytes)
        log(f"{name}: kernel {kernel_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}, {(n * n_bytes + extra_bytes) / 1e9:.2f} GB), "
            f"plain {plain_ms:.3f} ms, library {library_ms:.3f} ms "
            f"({library_label})")
        out[name] = {"name": name, "route": "cuda", "source": source,
                     "replaces": REPLACES[name], "launches": 0,
                     "max_abs_err": err, "max_ulp": ulp, "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "library": library_label}

    def plain_quant():
        for _, lo, hi in spans(n):
            quantize_int8_ref(x[lo:hi], ce)

    def plain_dequant():
        for _, lo, hi in spans(n):
            dequantize_int8_ref(q[lo:hi], s[lo // ce:hi // ce], ce)

    zeros = torch.zeros(nc, dtype=torch.int64, device="cuda")
    x2 = x.view(nc, ce)
    # read 4 bytes and write 1 an element, one f32 scale a chunk; abs, max,
    # divide, round, two clamps an element
    timed("quantize_chunks", lambda: quantize_int8(x, chunk_elems=ce),
          plain_quant,
          lambda: torch.quantize_per_channel(x2, s, zeros, 0, torch.qint8),
          "torch.quantize_per_channel qint8 at the kernel's scales: "
          "multiplies by 1/scale and clamps to [-128, 127], not the same "
          "function", 5, 6, 4 * nc, float(q_err), s_ulp, QUANT_SOURCE)
    qt = torch.quantize_per_channel(x2, s, zeros, 0, torch.qint8)
    del x, x2
    timed("dequantize_chunks", lambda: dequantize_int8(q, s, chunk_elems=ce),
          plain_dequant, lambda: qt.dequantize(),
          "QTensor.dequantize of the per-channel qint8 tensor: "
          "(q - 0) * scale, the same values", 5, 1, 4 * nc, d_err, d_ulp,
          QUANT_SOURCE)
    del qt, zeros
    gc.collect()
    torch.cuda.empty_cache()

    # the tail: p, m, the (4, n) stacked gradients read on the diagonal
    p = torch.empty(n, device="cuda")
    m = torch.empty(n, device="cuda")
    g = torch.empty(WORKERS, n, device="cuda")
    fill(torch, p, "p")
    fill(torch, m, "m")
    for w in range(WORKERS):
        fill(torch, g[w], "g", w)
    kw = dict(lr=lr, momentum=mu, inv_n=1.0 / WORKERS, chunk_elems=ce)
    got = fused_dequant_agg_opt(p, q, s, g, m, **kw)
    torch.cuda.synchronize()
    err, ulp = 0.0, 0
    for _, lo, hi in spans(n):
        e, u = compare(torch, [t[lo:hi] for t in got], dequant_agg_opt_ref(
            p[lo:hi], q[lo:hi], s[lo // ce:hi // ce],
            diag_span(torch, g, lo, hi), m[lo:hi], **kw))
        err, ulp = max(err, e), max(ulp, u)
    del got
    log(f"dequant_agg_opt_chunks: p/m ({nc}, {ce}) f32, q int8, g_own on "
        f"the diagonal of g ({WORKERS}, {nc}, {ce}): max_abs {err:.3e} "
        f"max_ulp {ulp}")
    check(ulp == 0, f"dequant_agg_opt_chunks differs from its plain version "
                    f"(max_ulp {ulp}); the kernel claims bitwise")

    def plain_tail():
        for _, lo, hi in spans(n):
            dequant_agg_opt_ref(p[lo:hi], q[lo:hi], s[lo // ce:hi // ce],
                                diag_span(torch, g, lo, hi), m[lo:hi], **kw)

    lp = torch.nn.Parameter(p.clone())
    sgd = torch.optim.SGD([lp], lr=lr, momentum=mu, nesterov=True,
                          fused=True)
    dq = dequantize_int8(q, s, chunk_elems=ce)

    def library_step():
        lp.grad = dq
        sgd.step()
    # read p, m, g_own (4 bytes each) and q (1), write p and m; per element
    # a product, a sum and a product for g, then the 5 of Nesterov
    timed("dequant_agg_opt_chunks",
          lambda: fused_dequant_agg_opt(p, q, s, g, m, **kw), plain_tail,
          library_step, "torch.optim.SGD nesterov fused, on the decoded "
          "partial as g: not the same function (no own rows, no mean)",
          21, 9, 4 * nc, err, ulp, CARD_SOURCE)
    del p, m, g, q, s, lp, sgd, dq
    gc.collect()
    torch.cuda.empty_cache()
    return out


def health_kernel_phase(torch, sizes: dict, ce: int) -> dict:
    """health_chunks at the gated steps' domains: the stacked (W, padded)
    buffer's W * n_chunks rows at W=4 and the n_chunks rows at W=1, each a
    chunk of ``ce`` f32; partials against the plain version span by span
    (it does not write its input, so the same tensor is read again);
    timings.  Returns the kernels-line entry (W=4 at the top, W=1 under
    "w1")."""
    from repro_torch.kernels.agg_opt import (fused_health_scan,
                                             health_chunks_ref,
                                             health_partials)
    check(SPAN % ce == 0, "spans are whole chunks")
    n4 = sizes[WORKERS]
    g = torch.empty(WORKERS, n4, device="cuda")
    for w in range(WORKERS):
        fill(torch, g[w], "g", w)
    rows4 = g.view(-1, ce)
    # special chunks of worker 0: one NaN, one Inf, 1e20 values whose
    # squares overflow, and all zeros
    rows4[0, 7] = float("nan")
    rows4[1, 100] = float("inf")
    rows4[2] = 1e20
    rows4[3] = 0
    out = {"name": "health_chunks", "route": "cuda", "source": CARD_SOURCE,
           "replaces": REPLACES["health_chunks"], "launches": 0}
    for W, rows in ((WORKERS, rows4), (1, g[1, :sizes[1]].view(-1, ce))):
        nc = rows.shape[0]
        got = health_partials(rows)
        torch.cuda.synchronize()
        err, ulp, nonfinite_ok = 0.0, 0, True
        for _, lo, hi in spans(nc * ce):
            a, b = got[lo // ce:hi // ce], health_chunks_ref(
                rows[lo // ce:hi // ce])
            fin = torch.isfinite(b)
            nonfinite_ok &= (torch.equal(torch.isnan(a), torch.isnan(b))
                             and torch.equal(torch.isposinf(a),
                                             torch.isposinf(b)))
            e, u = compare(torch, [a[fin]], [b[fin]])
            err, ulp = max(err, e), max(ulp, u)
        if W == WORKERS:
            special = got[:4].tolist()
            check(math.isnan(special[0]) and special[1] == math.inf
                  and special[2] == math.inf and special[3] == 0.0,
                  f"special chunks: {special}, want [nan, inf, inf, 0]")
            sums = fused_health_scan(g, chunk_elems=ce)
            check(math.isnan(float(sums[0]))
                  and bool(torch.isfinite(sums[1:]).all()),
                  f"per-worker sums {sums.tolist()}")
        log(f"health_chunks W={W}: g ({nc}, {ce}) f32 -> ({nc},) partials: "
            f"max_abs {err:.3e} max_ulp {ulp}, NaN and Inf where the plain "
            f"version has them: {nonfinite_ok}"
            + (f"; special chunks {special}" if W == WORKERS else ""))
        check(ulp == 0 and nonfinite_ok, f"health_chunks W={W} differs from "
                                         f"its plain version (max_ulp {ulp})")
        del got
        kernel_ms = median_ms(torch, lambda: health_partials(rows), reps=10)

        def plain_spans():
            for _, lo, hi in spans(nc * ce):
                health_chunks_ref(rows[lo // ce:hi // ce])
        plain_ms = median_ms(torch, plain_spans, reps=3, warmup=1)
        library_ms = median_ms(torch, lambda: torch.linalg.vector_norm(
            rows, dim=1, dtype=torch.float32), reps=10)
        # read 4 bytes an element, write 4 a chunk; a product and a sum
        bound_ms, bound_by = bound(nc * ce, 4, 2, 4 * nc)
        log(f"health_chunks W={W}: kernel {kernel_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}, {(4 * nc * ce + 4 * nc) / 1e9:.2f}"
            f" GB), plain {plain_ms:.3f} ms, library {library_ms:.3f} ms "
            f"(torch.linalg.vector_norm per chunk: takes the root too)")
        e = {"max_abs_err": err, "max_ulp": ulp, "ms": kernel_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library_ms,
             "library": "torch.linalg.vector_norm(rows, dim=1): the root of "
                        "each chunk's sum of squares, not the same function"}
        if W == WORKERS:
            out.update(e)
        else:
            out["w1"] = e
    del g, rows4, rows
    gc.collect()
    torch.cuda.empty_cache()

    # a small bf16 case: a bf16 group's chunk (16384), a ragged tail
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    gb = torch.randn(2, 16384 * 5 + 77, device="cuda",
                     generator=gen).bfloat16()
    rows = torch.nn.functional.pad(gb, (0, -gb.shape[1] % 16384)) \
        .reshape(-1, 16384)
    got, want = health_partials(rows), health_chunks_ref(rows)
    ulp = compare(torch, [got], [want])[1]
    sums_ok = torch.equal(fused_health_scan(gb, chunk_elems=16384),
                          want.view(2, -1).sum(1))
    log(f"health_chunks small bf16 case {tuple(rows.shape)}: max_ulp {ulp}, "
        f"sums equal {sums_ok}")
    check(ulp == 0 and sums_ok, "health_chunks bf16 case not bitwise")
    return out


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict)
            else v.detach().clone().to(device) for k, v in tree.items()}


def reference_phase(torch, optimizer: str, gated: bool = False) -> None:
    """One 4-worker step of a reduced model: card (kernel) vs CPU (plain
    versions), same weights and batch.  ``gated``: the sanity-gated step
    with worker ``POISONED`` NaN-injected; its verdicts must agree, and on
    the card it must equal the static k-of-n step with that worker dead,
    bitwise.  The gated step runs at f32 activations: with bf16 ones the
    two devices' gradients differ by up to 2e-2 of a leaf's largest entry
    (tests/test_torch_model.py), so their norms would test the model's
    precision, not the scan; at f32 they differ by summation order only,
    and the norms are held within NORM_RTOL."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import SyntheticTokens
    from repro_torch.elastic import Membership
    from repro_torch.models import DecoderLM
    from repro_torch.resilience import SanityConfig

    cfg = reduced(get_arch(ARCH))
    if gated:
        cfg = dataclasses.replace(cfg, dtype="float32")
    if optimizer == "adam":
        tc = TrainConfig(loss_chunk=64, optimizer="adam", lr=ADAM_LR,
                         adam_eps=ADAM_REF_EPS)
    elif optimizer == "sgd":
        tc = TrainConfig(loss_chunk=64, optimizer="sgd", lr=SGD_LR)
    else:
        tc = TrainConfig(loss_chunk=64)
    eng_cpu = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cpu")
    eng_gpu = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cuda")
    model_c, opt_c = eng_cpu.init_state()
    init = model_c.param_tree()
    model_g = DecoderLM(cfg, device="cuda", params=tree_to(init, "cuda"))
    opt_g = eng_gpu.init_opt()
    data = SyntheticTokens(cfg, BATCH, 64, seed=0)
    extra = ()
    if gated:
        inject = np.ones(WORKERS, np.float32)
        inject[POISONED] = np.nan
        extra = ({"norm_hi": np.float32(np.inf), "inject": inject},)
        sanity = SanityConfig(allow_injection=True)
        # the static k-of-n step from the same weights, on the card
        eng_dead = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cuda")
        model_d = DecoderLM(cfg, device="cuda", params=tree_to(init, "cuda"))
        _, opt_d, met_d = eng_dead.make_train_step(
            membership=Membership.full(WORKERS).leave(POISONED))(
                model_d, eng_dead.init_opt(), data.torch_batch(0, "cuda"))
    else:
        sanity = None
    _, opt_c, met_c = eng_cpu.make_train_step(sanity=sanity)(
        model_c, opt_c, data.torch_batch(0, "cpu"), *extra)
    _, opt_g, met_g = eng_gpu.make_train_step(sanity=sanity)(
        model_g, opt_g, data.torch_batch(0, "cuda"), *extra)
    if gated:
        ok_c, ok_g = met_c["ok_mask"].tolist(), met_g["ok_mask"].cpu().tolist()
        nl_c, nl_g = float(met_c["n_live"]), float(met_g["n_live"])
        want_ok = [0.0 if w == POISONED else 1.0 for w in range(WORKERS)]
        norms_c = met_c["grad_norms"].numpy()
        norms_g = met_g["grad_norms"].cpu().numpy()
        live = [w for w in range(WORKERS) if w != POISONED]
        drel = float(np.max(np.abs(norms_g[live] - norms_c[live])
                            / norms_c[live]))
        log(f"gated {optimizer} step, worker {POISONED} NaN-injected: "
            f"ok_mask card {ok_g} CPU {ok_c}, n_live card {nl_g:g} CPU "
            f"{nl_c:g}, grad_norms card {norms_g.tolist()} (max rel diff "
            f"to the CPU's {drel:.2e})")
        check(ok_c == ok_g == want_ok and nl_c == nl_g == WORKERS - 1,
              "gated verdicts differ from the expected [1, 0, 1, 1], n_live 3")
        check(np.isnan(norms_c[POISONED]) and np.isnan(norms_g[POISONED])
              and drel <= NORM_RTOL, f"grad_norms differ by {drel}")
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaf_paths(model_g.param_tree()), leaf_paths(model_d.param_tree())))
        same &= all(torch.equal(opt_g["float32"][n], opt_d["float32"][n])
                    for n in opt_g["float32"])
        same &= torch.equal(met_g["loss"], met_d["loss"])
        log(f"  gated card step == static k-of-n card step (worker "
            f"{POISONED} dead), parameters, slots and loss bitwise: {same}")
        check(same, "the gated step differs from the static k-of-n step")
        del model_d, opt_d, eng_dead
    dloss = abs(float(met_c["loss"]) - float(met_g["loss"]))
    dparam = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for (_, a), (_, b) in zip(leaf_paths(model_g.param_tree()),
                                           leaf_paths(model_c.param_tree())))
    dslot = {n: float((t.cpu().float() - opt_c["float32"][n].float())
                      .abs().max()) for n, t in opt_g["float32"].items()}
    log(f"reduced {ARCH} (d_model={cfg.d_model}, {cfg.n_layers} layers, "
        f"{cfg.dtype} activations), {WORKERS} workers, 1 "
        f"{'gated ' if gated else ''}{optimizer} step, card vs CPU: loss "
        f"{float(met_g['loss']):.6f} |dloss| {dloss:.3e}, max |dparam| "
        f"{dparam:.3e}, "
        + ", ".join(f"max |d{n}| {d:.3e}" for n, d in dslot.items()))
    # f32 products summed in another order on each device, bf16 activations
    check(dloss <= 1e-3, f"card loss differs from CPU loss by {dloss}")
    if optimizer == "sgd":
        # p' = p - lr g moves less than Nesterov's first p - lr (1 + mu) g
        check(dparam <= 1e-4, f"card SGD step differs from CPU step: "
                              f"params {dparam}")
        return
    if optimizer == "nesterov":
        dmom = dslot["m"]
        check(dparam <= 1e-4 and dmom <= 1e-2,
              f"card step differs from CPU step: params {dparam}, "
              f"momentum {dmom}")
        return
    # from zero slots m' = (1-b1) g, and the first Adam step is
    # lr * g / (|g| + eps): |dp| <= lr * |dg| / eps, |dg| = |dm'| / (1-b1)
    dg = dslot["m"] / (1 - tc.adam_b1)
    bound = tc.lr * dg / tc.adam_eps * 1.01 + 1e-6
    k1_c, k1_g = opt_c["float32"]["k1"], opt_g["float32"]["k1"].cpu()
    log(f"  Adam bound: |dg| {dg:.3e} -> |dparam| <= {bound:.3e}; k1 "
        f"differs at {int((k1_c != k1_g).sum())} of {k1_c.numel()} positions")
    check(dg <= 1e-2, f"card gradients differ from CPU gradients by {dg}")
    check(dparam <= bound, f"card Adam step differs from CPU step: params "
                           f"{dparam} > {bound}")


def wire_reference_phase(torch, wire_name: str) -> None:
    """One 4-worker Nesterov step of a reduced model over an encoded wire:
    card (kernels) vs CPU (plain versions), same weights and batch.  The
    gradients differ by f32 summation order, and an ulp can move an
    encoded entry across a rounding boundary: by one grid step of a pushed
    partial, which moves p' by lr * (1 + mu) / N times it, or by one grid
    step of the pull's delta.  The bound sums those steps, as measured
    here on the CPU's run (for int8 a chunk's scale, max|x| / 127; for
    bf16 an ulp, at most 2^-7 max|x|), plus the identity wire's 1e-4."""
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.core.chunking import (flatten_groups, flatten_leaves,
                                           leaf_paths)
    from repro_torch.core.pipeline import add_ring_rows_, ring_rows
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import DecoderLM

    cfg = reduced(get_arch(ARCH))
    tc = TrainConfig(loss_chunk=64, wire_format=wire_name)
    eng_cpu = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cpu")
    eng_gpu = PHubEngine(cfg, tc, StackedComm(WORKERS), device="cuda")
    model_c, opt_c = eng_cpu.init_state()
    model_g = DecoderLM(cfg, device="cuda",
                        params=tree_to(model_c.param_tree(), "cuda"))
    opt_g = eng_gpu.init_opt()
    check(list(opt_g["float32"]) == ["m", "wire_ef"], "the wire_ef slot")
    data = SyntheticTokens(cfg, BATCH, 64, seed=0)
    batch = data.torch_batch(0, "cpu")
    (group,) = eng_cpu.chunk_plan.groups
    ce, wire = group.chunk_elems, eng_cpu.wire

    def grid(x):
        amax = float(x.detach().abs().max())
        return amax / 127 if wire.has_scales else amax * 2.0 ** -7

    # the CPU's stacked gradients, to measure the push's grid steps
    loss_fn = eng_cpu.build_loss_fn()
    paths, leaves = zip(*leaf_paths(model_c.param_tree()))
    bw = BATCH // WORKERS
    G = torch.empty(WORKERS, group.padded)
    for w in range(WORKERS):
        sl = slice(w * bw, (w + 1) * bw)
        grads = torch.autograd.grad(loss_fn(model_c, batch["tokens"][sl],
                                            batch["labels"][sl]), leaves)
        (G[w],) = flatten_leaves(eng_cpu.chunk_plan,
                                 dict(zip(paths, grads))).values()
    acc = ring_rows(G, 1)
    push = grid(acc)
    for k in range(2, WORKERS):
        acc = add_ring_rows_(wire.decode(wire.encode(acc, ce), ce), G, k)
        push += grid(acc)
    del acc, grads

    (p_prev,) = flatten_groups(eng_cpu.chunk_plan,
                               model_c.param_tree()).values()
    p_prev = p_prev.clone()
    _, opt_c, met_c = eng_cpu.make_train_step()(model_c, opt_c, batch)
    _, opt_g, met_g = eng_gpu.make_train_step()(model_g, opt_g,
                                                data.torch_batch(0, "cuda"))
    (p_c,) = flatten_groups(eng_cpu.chunk_plan, model_c.param_tree()).values()
    (p_g,) = flatten_groups(eng_gpu.chunk_plan, model_g.param_tree()).values()
    ef_c = opt_c["float32"]["wire_ef"].reshape(-1)
    ef_g = opt_g["float32"]["wire_ef"].reshape(-1).cpu()
    pull = grid((p_c - p_prev) + ef_c)
    limit = pull + tc.lr * (1 + tc.momentum) / WORKERS * push + 1e-4
    dloss = abs(float(met_c["loss"]) - float(met_g["loss"]))
    dparam = float((p_g.detach().cpu() - p_c.detach()).abs().max())
    def_ = float((ef_g - ef_c).abs().max())
    dmom = float((opt_g["float32"]["m"].cpu() - opt_c["float32"]["m"])
                 .abs().max())
    log(f"reduced {ARCH}, {WORKERS} workers, 1 nesterov step over the "
        f"{wire_name} wire, card vs CPU: loss {float(met_g['loss']):.6f} "
        f"|dloss| {dloss:.3e}, max |dparam| {dparam:.3e}, max |dwire_ef| "
        f"{def_:.3e}, max |dm| {dmom:.3e}; grid steps: pull {pull:.3e}, "
        f"push (sum over {WORKERS - 1} hops) {push:.3e} -> bound "
        f"{limit:.3e}; max |wire_ef| {float(ef_c.abs().max()):.3e}")
    check(dloss <= 1e-3, f"card loss differs from CPU loss by {dloss}")
    check(float(ef_c.abs().max()) > 0, "error feedback did not engage")
    check(dparam <= limit and def_ <= limit,
          f"card {wire_name} step differs from CPU step: params {dparam}, "
          f"wire_ef {def_} > {limit}")
    # m' = g (from zero momentum), so |dm| <= one push grid step / N
    check(dmom <= push / WORKERS + 1e-2, f"momentum differs by {dmom}")


def main_path(torch, workers: int, steps: int, expect: dict,
              optimizer: str = "nesterov", wire: str = "identity",
              faults=None) -> dict:
    """PHubEngine + fit on the full model under ``optimizer`` over
    ``wire``; ``expect`` holds each kernel's launches per step and group
    (every other count must stay 0).  ``faults``: a FaultSchedule; the
    run then goes through fit(supervisor=TrainSupervisor) with injection
    on and demote_after 2, and the supervisor's record is checked.
    Returns the run's launch counts."""
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import agg_opt, quant
    from repro_torch.resilience import (SanityConfig, SupervisorConfig,
                                        TrainSupervisor)
    from repro_torch.training import TrainState, fit

    cfg = get_arch(ARCH)
    lr = {"adam": ADAM_LR, "sgd": SGD_LR}.get(optimizer)
    tc = TrainConfig(loss_chunk=min(1024, SEQ), optimizer=optimizer,
                     wire_format=wire, **({"lr": lr} if lr else {}))
    engine = PHubEngine(cfg, tc, StackedComm(workers), device="cuda")
    model, opt = engine.init_state()
    state = TrainState(params=model, opt=opt)
    del opt          # fit replaces state.opt; a second reference would
    #                  keep the first step's slots alive through the run
    groups = engine.chunk_plan.groups
    rule = {"nesterov": f"momentum {tc.momentum}",
            "adam": f"b1 {tc.adam_b1}, b2 {tc.adam_b2}, eps {tc.adam_eps}",
            "sgd": "no momentum"}[optimizer]
    sup = None
    if faults is not None:
        sup = TrainSupervisor(engine, SupervisorConfig(
            sanity=SanityConfig(allow_injection=True), demote_after=2),
            faults=faults, log_fn=log)
    log(f"main path: {ARCH} {cfg.n_params():,} params, {cfg.n_layers} "
        f"layers, d_model {cfg.d_model}; sharded_ps, {workers} stacked "
        f"worker(s), {wire} wire, batch {BATCH} x {SEQ}, {steps} step(s), "
        f"{optimizer} at lr {tc.lr}, {rule}"
        f"{'; supervised, faults ' + str(faults.events) if sup else ''}; "
        f"groups "
        + ", ".join(f"{g.key}: {g.total:,} -> {g.padded:,} "
                    f"({g.n_chunks} chunks of {g.chunk_elems})"
                    for g in groups))
    before = {p: t.detach().reshape(-1)[:4096].clone()
              for p, t in leaf_paths(model.param_tree())}
    data = SyntheticTokens(cfg, BATCH, SEQ, seed=tc.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [time.perf_counter()]

    health = []

    def on_step(state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        ms = (marks[-1] - marks[-2]) * 1e3
        gated = ""
        if sup is not None:
            health.append(metrics)
            gated = (f"  ok_mask {metrics['ok_mask'].tolist()} n_live "
                     f"{metrics['n_live']:g} grad_norms "
                     f"{metrics['grad_norms'].tolist()}")
        log(f"step {state.step - 1}: loss {state.losses[-1]:.6f}  "
            f"{ms:.1f} ms  {BATCH * SEQ / (ms / 1e3):,.0f} tokens/s  "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            + gated)
        torch.cuda.reset_peak_memory_stats()

    agg_opt.reset_launches()
    quant.reset_launches()
    state = fit(engine, state, data, steps=steps, log_every=0,
                hooks=[on_step], supervisor=sup)
    launches = {**agg_opt.LAUNCHES, **quant.LAUNCHES}
    if sup is not None:
        masks = [h["ok_mask"].tolist() for h in health]
        live = [h["n_live"] for h in health]
        demotes = [(e["step"], e["worker"], e["status"])
                   for e in sup.incident_history("demote")]
        log(f"supervised: ok_mask {masks}, n_live {live}, demotions "
            f"{demotes}, live ranks {sup.membership.live_ranks}, "
            f"{len(sup._steps)} step functions, events {sup.event_kinds()}")
        check(masks == [[1, 1, 1, 1], [1, 0, 1, 1], [1, 0, 1, 1],
                        [1, 0, 1, 1]] and live == [4, 3, 3, 3],
              f"verdicts {masks}, n_live {live}")
        check(demotes == [(2, POISONED, "slow")],
              f"demotions {demotes}, want worker {POISONED} at step 2")
        check(sup.membership.live_ranks == (0, 2, 3) and len(sup._steps) == 2
              and sup.rollbacks == 0,
              "step 3 did not run on the static 3-of-4 program")
    check(all(math.isfinite(x) for x in state.losses),
          f"non-finite loss {state.losses}")
    check(len(state.losses) == steps, f"{len(state.losses)} losses")
    for p, t in leaf_paths(model.param_tree()):
        check(not torch.equal(before[p], t.detach().reshape(-1)[:4096]),
              f"parameter {p} did not change")
    for name, count in launches.items():
        want = expect.get(name, 0) * steps * len(groups)
        check(count == want, f"{name} launched {count} times on the "
                             f"{workers}-worker {optimizer} {wire} path, "
                             f"want {want}")
    log(f"{workers}-worker {optimizer} {wire}-wire path: launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + " as expected; parameters changed, losses finite")
    del model, state, engine, sup
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def rollback_phase(torch) -> None:
    """The supervisor's recovery on the card, at reduced size (a
    full-model snapshot is 9.9 GB of disk I/O, not device work): 4
    workers, a snapshot after every step (keep_k 2), every worker
    NaN-pushing at steps 3-5 (divergence_patience 3) and the newest
    snapshot truncated at step 5.  The supervisor must skip the corrupt
    step-5 snapshot by name, restore step 4 (parameters and every slot
    bitwise equal to load_checkpoint's) and finish the 6 steps."""
    import shutil
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.core.chunking import leaf_paths
    from repro_torch.data import SyntheticTokens
    from repro_torch.elastic import (CKPT_CORRUPT, FaultEvent, FaultSchedule,
                                     NAN_PUSH)
    from repro_torch.resilience import (SanityConfig, SupervisorConfig,
                                        TrainSupervisor)
    from repro_torch.training import TrainState, fit

    d = os.path.join(ROOT, "build", "chip_smoke_checkpoints")
    shutil.rmtree(d, ignore_errors=True)
    cfg = reduced(get_arch(ARCH))
    engine = PHubEngine(cfg, TrainConfig(loss_chunk=64), StackedComm(WORKERS),
                        device="cuda")
    model, opt = engine.init_state()
    faults = FaultSchedule((*(FaultEvent(3, NAN_PUSH, w, duration=3)
                              for w in range(WORKERS)),
                            FaultEvent(5, CKPT_CORRUPT)), world=WORKERS)
    sup = TrainSupervisor(engine, SupervisorConfig(
        sanity=SanityConfig(allow_injection=True), checkpoint_dir=d,
        checkpoint_every=1, keep_k=2, divergence_patience=3),
        faults=faults, log_fn=log)
    restored = []

    def on_step(state, host):
        if sup.rollbacks and not restored:
            step, tree = load_checkpoint(d, state.step)
            saved = dict(leaf_paths(tree["params"]))
            same = all(torch.equal(t.detach().cpu(), saved[p])
                       for p, t in leaf_paths(state.params.param_tree()))
            same &= all(torch.equal(t.cpu(), tree["opt"]["float32"][n])
                        for n, t in state.opt["float32"].items())
            restored.append((step, same))

    data = SyntheticTokens(cfg, BATCH, 64, seed=0)
    state = fit(engine, TrainState(params=model, opt=opt), data, steps=6,
                log_every=0, supervisor=sup, hooks=[on_step])
    rb = sup.incident_history("rollback")
    log(f"rollback: {[(e['step'], e['restored_step'], e['skipped']) for e in rb]}"
        f" (step, restored, skipped); restored state bitwise equal to "
        f"load_checkpoint's: {restored}; finished at step {state.step}, "
        f"losses {state.losses}")
    check(len(rb) == 1 and rb[0]["restored_step"] == 4
          and rb[0]["skipped"] == [5], f"rollback record {rb}")
    check(restored == [(4, True)], f"restored state {restored}")
    check(state.step == 6 and all(math.isfinite(x) for x in state.losses),
          "the supervised run did not finish")
    shutil.rmtree(d)


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
    logs = _build.build(["agg_opt", "quant"])
    log(f"kernels built from source in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name} ptxas: {line.strip()}")

    tc = TrainConfig()
    padded = {}
    for W in (1, WORKERS):
        (group,) = PHubEngine(get_arch(ARCH), tc, StackedComm(W),
                              device="cuda").chunk_plan.groups
        padded[W] = group.padded
    ce = group.chunk_elems
    kernels = kernel_phase(torch, {"agg_opt_chunks": padded[1],
                                   "multi_agg_opt_chunks": padded[WORKERS]},
                           tc.lr, tc.momentum)
    kernels.update(rule_kernel_phase(torch, padded))
    kernels.update(wire_kernel_phase(torch, padded[WORKERS], ce, tc.lr,
                                     tc.momentum))
    kernels["health_chunks"] = health_kernel_phase(torch, padded, ce)
    reference_phase(torch, "nesterov")
    reference_phase(torch, "adam")
    wire_reference_phase(torch, "int8")
    wire_reference_phase(torch, "bf16")
    for rule in ("nesterov", "sgd", "adam"):
        reference_phase(torch, rule, gated=True)
    rollback_phase(torch)

    from repro_torch.elastic import FaultEvent, FaultSchedule, NAN_PUSH
    # (label, workers, steps, rule, wire, launches per step, faults)
    paths = (
        ("W=4", WORKERS, STEPS, "nesterov", "identity",
         {"multi_agg_opt_chunks": 1}),
        ("supervised W=4", WORKERS, 4, "nesterov", "identity",
         {"health_chunks": 1, "multi_agg_opt_chunks": 1},
         FaultSchedule((FaultEvent(1, NAN_PUSH, POISONED, duration=2),),
                       world=WORKERS)),
        ("W=1", 1, 1, "nesterov", "identity", {"agg_opt_chunks": 1}),
        ("W=4", WORKERS, STEPS, "adam", "identity", {"adam_opt_chunks": 1}),
        ("W=1", 1, 1, "adam", "identity", {"adam_opt_chunks": 1}),
        ("W=4", WORKERS, 1, "sgd", "identity", {"sgd_opt_chunks": 1}),
        ("W=1", 1, 1, "sgd", "identity", {"sgd_opt_chunks": 1}),
        ("int8 W=4", WORKERS, STEPS, "nesterov", "int8",
         {"quantize_chunks": WORKERS, "dequantize_chunks": WORKERS - 1,
          "dequant_agg_opt_chunks": 1}),
        ("int8 W=1", 1, 1, "nesterov", "int8",
         {"quantize_chunks": 1, "dequantize_chunks": 1,
          "agg_opt_chunks": 1}),
        ("int8 W=4", WORKERS, 1, "sgd", "int8",
         {"quantize_chunks": WORKERS, "dequantize_chunks": WORKERS,
          "sgd_opt_chunks": 1}),
        ("int8 W=4", WORKERS, 1, "adam", "int8",
         {"quantize_chunks": WORKERS, "dequantize_chunks": WORKERS,
          "adam_opt_chunks": 1}),
    )
    for k in kernels.values():
        k["launches_by_path"] = {}
    for label, workers, steps, rule, wire, expect, *faults in paths:
        launches = main_path(torch, workers, steps, expect, rule, wire,
                             *faults)
        for name, count in launches.items():
            if count:
                by = kernels[name]["launches_by_path"]
                by[f"{rule} {label}"] = count
                kernels[name]["launches"] += count
    for k in kernels.values():
        k["verdict"] = "bitwise" if k["max_ulp"] == 0 else "differs"
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
