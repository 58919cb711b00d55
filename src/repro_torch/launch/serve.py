"""Serving launcher for the PyTorch port: batched prefill + decode with the
ring KV cache (``repro/launch/serve.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --batch 8 --prompt-len 2048 --decode-steps 32
  ... --reduced --device cpu      # small same-family model on the CPU
  ... --telemetry --telemetry-out out   # spans + latency histogram

The prompts are ``SyntheticTokens(cfg, batch, prompt_len, seed=7)``'s
first batch and the weights are drawn from seed 0, as the reference's;
``--arch`` takes any of the ten architectures.  A frontend architecture
(internvl2-2b, musicgen-medium) is served from its tokens alone, with no
prefix, as the reference's launcher serves it; ``generate`` takes one.
The prefill's logits give the first token; each of the ``decode_steps - 1``
decode steps gives one more.  The decode chain is queued without a host
sync and synchronized once at its end.

With ``--telemetry`` the run is traced (``telemetry/``, the reference's
spans and histogram): the span ``prefill`` (ending in the prefill's
sync), one ``decode/step`` a decode step (the host's enqueue: no sync is
added) and the histogram ``serve.latency`` by ``phase`` (``prefill``,
``decode_dispatch`` a step, ``decode_total``); ``serve_trace.json`` and
``serve_metrics.jsonl`` go to ``--telemetry-out`` (default
``results/torch/telemetry``).  The launcher restores
the null telemetry pair before it returns.
"""
from __future__ import annotations

import argparse
import time

from ..paths import TELEMETRY_DIR


def generate(engine, model, prompts, decode_steps: int, *,
             greedy: bool = True, temperature: float = 1.0,
             generator=None, extra_embeds=None) -> dict:
    """Prefill ``prompts`` (B, T) int64 on the model's device, after a
    frontend's ``extra_embeds`` (B, F, d) when given, then decode
    ``decode_steps - 1`` tokens.  Greedy takes the argmax; otherwise a
    token is drawn from softmax(logits / temperature) with ``generator``.
    Returns ``tokens`` (B, decode_steps) int32 on the device, the first
    and last steps' logits (B, V) f32, and the prefill's and the decode
    chain's seconds, each ending in a device sync on a card.  Traced under
    the installed telemetry pair (module docstring)."""
    import torch

    from .. import telemetry
    tracer, registry = telemetry.get_tracer(), telemetry.get_registry()
    dev = prompts.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    prefill_step = engine.make_prefill_step(
        prompts.shape[1], max_new_tokens=decode_steps)
    serve_step = engine.make_serve_step()

    def pick(logits):
        if greedy:
            tok = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return tok[:, None]

    sync()
    t0 = time.perf_counter()
    with tracer.span("prefill", batch=prompts.shape[0],
                     prompt_len=prompts.shape[1]):
        logits, cache = prefill_step(model, prompts, extra_embeds)
        sync()
    t_prefill = time.perf_counter() - t0
    registry.histogram("serve.latency").observe(t_prefill, phase="prefill")
    first = logits
    tok = pick(logits)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(decode_steps - 1):
        td = time.perf_counter()
        # the step's enqueue: the chain syncs once, at its end
        with tracer.span("decode/step", i=i):
            logits, cache = serve_step(model, cache, tok)
            tok = pick(logits)
        registry.histogram("serve.latency").observe(
            time.perf_counter() - td, phase="decode_dispatch")
        out.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    registry.histogram("serve.latency").observe(t_decode,
                                                phase="decode_total")
    return {"tokens": torch.cat(out, dim=1).to(torch.int32),
            "first_logits": first, "last_logits": logits,
            "prefill_s": t_prefill, "decode_s": t_decode}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family variant (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--greedy", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="argmax decoding; --no-greedy samples from the "
                         "temperature-scaled logits")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the sampling generator")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--telemetry", action="store_true",
                    help="trace the prefill and decode spans and the "
                         "serving-latency histogram; artifacts under "
                         "--telemetry-out")
    ap.add_argument("--telemetry-out", default=TELEMETRY_DIR,
                    help="artifact directory for --telemetry (default "
                         "results/torch/telemetry)")
    args = ap.parse_args(argv)

    from .. import telemetry
    if not args.telemetry:
        return _serve(args)
    telemetry.enable(seed=args.seed, meta={
        "argv": list(argv) if argv is not None else [], "arch": args.arch,
        "mode": "serve"})
    try:
        return _serve(args)
    finally:
        telemetry.disable()


def _serve(args):
    import torch

    from .. import telemetry
    from ..configs import TrainConfig, get_arch, reduced
    from ..core import PHubEngine, StackedComm
    from ..data import SyntheticTokens

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    engine = PHubEngine(cfg, TrainConfig(), StackedComm(1),
                        device=args.device)
    model = engine.init_model(seed=0)
    data = SyntheticTokens(cfg, args.batch, args.prompt_len, seed=7)
    prompts = torch.from_numpy(data.batch_at(0)["tokens"]).to(
        device=args.device, dtype=torch.int64)
    gen = torch.Generator(device=args.device)
    gen.manual_seed(args.seed)
    on_card = engine.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(engine.device)
    res = generate(engine, model, prompts, args.decode_steps,
                   greedy=args.greedy, temperature=args.temperature,
                   generator=gen)
    gen_tokens = res["tokens"].cpu().numpy()
    t_prefill, t_decode = res["prefill_s"], res["decode_s"]
    n_dec = args.decode_steps - 1
    where = (torch.cuda.get_device_name(engine.device) if on_card
             else "the CPU")
    print(f"[serve] arch={cfg.arch_id} batch={args.batch} "
          f"prompt={args.prompt_len} on {where}")
    print(f"[serve] prefill: {t_prefill * 1e3:.1f} ms "
          f"({args.batch * args.prompt_len / t_prefill:,.0f} tok/s)")
    print(f"[serve] decode:  {n_dec} steps in {t_decode * 1e3:.1f} ms "
          f"({t_decode * 1e3 / max(n_dec, 1):.2f} ms/step, "
          f"{args.batch * n_dec / max(t_decode, 1e-9):,.0f} tok/s)")
    if on_card:
        print(f"[serve] peak device memory "
              f"{torch.cuda.max_memory_allocated(engine.device) / 2**30:.2f}"
              f" GiB")
    print(f"[serve] sample generations (first 10 tokens): "
          f"{gen_tokens[:, :10].tolist()}")
    if telemetry.enabled():
        import os
        tracer, registry = telemetry.get_tracer(), telemetry.get_registry()
        tracer.meta["card"] = where
        os.makedirs(args.telemetry_out, exist_ok=True)
        tracer.write(os.path.join(args.telemetry_out, "serve_trace.json"))
        registry.dump_jsonl(
            os.path.join(args.telemetry_out, "serve_metrics.jsonl"))
        st = registry.histogram("serve.latency").summary(
            phase="decode_dispatch")
        if st["count"]:
            print(f"[serve] decode dispatch: mean "
                  f"{st['sum'] / st['count'] * 1e3:.3f} ms (min "
                  f"{st['min'] * 1e3:.3f}, max {st['max'] * 1e3:.3f}) over "
                  f"{st['count']} steps")
        print(f"[telemetry] artifacts: {args.telemetry_out}/"
              f"{{serve_trace.json, serve_metrics.jsonl}}")
    return gen_tokens


if __name__ == "__main__":
    main()
