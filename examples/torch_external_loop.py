"""A hand-rolled PyTorch training loop (no model of the port, no
PHubEngine) driving the exchange through the framework-agnostic
``PHubClient`` (the port's counterpart of ``examples/external_loop.py``).

The model is a plain 2-layer ``nn.Module`` MLP (32 -> 128 -> 8, tanh) on a
synthetic regression task, written as any PyTorch user would write it: its
own init from a ``torch.Generator``, its own loss, its own
``torch.autograd.grad`` on each worker's slice of the batch.  PHub's part
is the kvstore-style contract of the paper (§2, §4):

    client = PHubClient(tc, StackedComm(W)).register(module_tree(model))
    opt = client.init_state()                       # the PS's slots
    _, opt = client.push_pull(grads, module_tree(model), opt)  # push/pull

The W workers are stacked on one device; each pushes its own gradient
(the ``(W, ...)`` leading axis of ``grads``), the PS averages them and
runs the fused Adam update on its chunk shards, and the new parameters are
written into the module's own tensors.

Run:  PYTHONPATH=src python examples/torch_external_loop.py [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
from torch import nn  # noqa: E402

from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.core import (PHubClient, StackedComm, module_tree,  # noqa: E402
                              nest)

D_IN, D_HIDDEN, D_OUT, BATCH = 32, 128, 8, 16     # BATCH: a worker's


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, gen: torch.Generator, device):
        super().__init__()
        self.w = nn.Parameter(torch.randn(d_in, d_out, generator=gen,
                                          device=device) / math.sqrt(d_in))
        self.b = nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x):
        return x @ self.w + self.b


class MLP(nn.Module):
    def __init__(self, seed: int, device):
        super().__init__()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.fc1 = Dense(D_IN, D_HIDDEN, gen, device)
        self.fc2 = Dense(D_HIDDEN, D_OUT, gen, device)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


def main(argv=None) -> list:
    """Train for ``--steps`` steps; returns every step's mse (the mean of
    the workers' losses before the step's update)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    device, W = torch.device(args.device), args.workers

    tc = TrainConfig(optimizer="adam", lr=3e-3, strategy="sharded_ps",
                     chunk_size_bytes=4096, pipeline_windows=2)
    model = MLP(seed=0, device=device)
    teacher = MLP(seed=42, device=device)
    client = PHubClient(tc, StackedComm(W), device=device).register(
        module_tree(model))
    opt = client.init_state()
    print(f"workers={W} optimizer={tc.optimizer} "
          f"registered={client.registered_bytes() / 1e3:.1f} KB "
          f"slots={[s.name for s in client.sopt.slots]} device={device}")

    names, params = zip(*model.named_parameters())
    # the push: one gradient a worker on a leading axis, filled in place
    stacked = {n: torch.empty((W,) + p.shape, device=device)
               for n, p in zip(names, params)}
    grads = nest(stacked.items())             # the model's nesting

    data = torch.Generator(device=device)
    data.manual_seed(1)
    losses = []
    for step in range(args.steps):
        x = torch.randn(W, BATCH, D_IN, generator=data, device=device)
        with torch.no_grad():
            y = teacher(x)
        step_loss = []
        for w in range(W):
            loss = torch.mean((model(x[w]) - y[w]) ** 2)
            for n, g in zip(names, torch.autograd.grad(loss, params)):
                stacked[n][w].copy_(g)
            step_loss.append(loss.detach())
        _, opt = client.push_pull(grads, module_tree(model), opt)
        losses.append(float(torch.stack(step_loss).mean()))
        if step % 40 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  mse {losses[-1]:.5f}", flush=True)
    return losses


if __name__ == "__main__":
    main()
