"""Training launcher for the PyTorch port.

Runs PHub's sharded_ps train step with W workers stacked on one device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 3 --batch 8 --seq 512 --workers 4
  ... --reduced --device cpu      # small same-family model on the CPU

Values the port does not implement (another strategy or architecture, a
batch that does not split over the workers) raise.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--strategy", default="sharded_ps")
    ap.add_argument("--chunk-kb", type=int, default=32)
    ap.add_argument("--wire-format", default="identity",
                    help="identity | bf16 | f16 | int8 (core/wire.py)")
    ap.add_argument("--workers", type=int, default=1,
                    help="workers stacked on the one device")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=1)
    args = ap.parse_args(argv)

    from ..configs import TrainConfig, get_arch, reduced
    from ..core import PHubEngine, StackedComm
    from ..data import SyntheticTokens
    from ..training import TrainState, fit

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tc = TrainConfig(strategy=args.strategy, lr=args.lr,
                     chunk_size_bytes=args.chunk_kb * 1024,
                     wire_format=args.wire_format,
                     loss_chunk=min(1024, args.seq))
    engine = PHubEngine(cfg, tc, StackedComm(args.workers), device=args.device)
    params, opt = engine.init_state()
    data = SyntheticTokens(cfg, args.batch, args.seq, seed=tc.seed)
    print(f"[train] arch={cfg.arch_id} params={cfg.n_params() / 1e6:.1f}M "
          f"workers={args.workers} strategy={tc.strategy} "
          f"wire={tc.wire_format} "
          f"device={engine.device}")
    state = fit(engine, TrainState(params=params, opt=opt), data,
                steps=args.steps, log_every=args.log_every)
    losses = state.losses
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
