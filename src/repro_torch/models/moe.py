"""Top-k Mixture-of-Experts with capacity-based dispatch
(``repro/models/moe.py``).

Each token's top-k experts come from an argmax sweep over the router's
softmax (the lowest index wins a tie); assignment (token, j) takes the
next free slot of its expert, counted by a cumulative sum over the
assignments in token order, and an assignment past the expert's capacity
``C = max(1, int(capacity_factor * S * top_k / E))`` is dropped.  The kept
tokens are scattered into an ``(E, C, d)`` buffer, the three expert
products run batched over E, and each token sums its experts' outputs
weighted by its renormalised gates.

The scatter writes each kept assignment into its own slot and every
dropped one into a spare row past the buffer, which is cut off: the same
values as the reference's add of zeros into slot (0, 0), and no slot the
products read is written twice, so nothing depends on the order of an
accumulation.  The
combine reads the slots back by index and sums each token's k outputs in
the order of its assignments.  Both directions of the step are
deterministic on the card: a read by index differentiates into the sorted
accumulation of ``index_put_``, and the token's copies into a sum over k.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import matmul


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e (1.0 when uniform); f_e
    the fraction of tokens whose first choice is e."""
    one_hot = F.one_hot(idx[..., 0], n_experts).float()
    f = one_hot.mean(dim=0)
    p = probs.mean(dim=0)
    return n_experts * torch.sum(f * p)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, as k
    argmax passes, each masking its pick to -inf (the lowest index wins a
    tie, as ``torch.argmax`` and the reference's sweep both do)."""
    vals, idxs = [], []
    p = probs
    for _ in range(k):
        i = torch.argmax(p, dim=-1)
        vals.append(torch.gather(p, -1, i[..., None])[..., 0])
        idxs.append(i)
        p = p.masked_fill(F.one_hot(i, p.shape[-1]).bool(), float("-inf"))
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def routing(x: torch.Tensor, router_w: torch.Tensor, *, top_k: int,
            capacity_factor: float) -> dict:
    """The router's decisions for x (S, d): ``probs`` (S, E) f32, ``gate``
    and ``idx`` (S, k), the capacity ``C``, and per assignment (token-major,
    S * k of them) ``pos`` (its slot in its expert) and ``keep``
    (``pos < C``)."""
    S = x.shape[0]
    E = router_w.shape[-1]
    C = max(1, int(capacity_factor * S * top_k / E))
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    gate, idx = _top_k(probs, top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    one_hot = F.one_hot(idx.reshape(-1), E)                 # (S*k, E)
    pos = (torch.cumsum(one_hot, dim=0) * one_hot).sum(-1) - 1
    return {"probs": probs, "gate": gate, "idx": idx, "C": C, "pos": pos,
            "keep": pos < C}


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w1: torch.Tensor,
            w3: torch.Tensor, w2: torch.Tensor, *, top_k: int,
            capacity_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (S, d); router_w: (d, E); w1/w3: (E, d, ff); w2: (E, ff, d).

    Returns (y (S, d) in x's dtype, aux_loss f32 scalar)."""
    S, d = x.shape
    E = router_w.shape[-1]
    r = routing(x, router_w, top_k=top_k, capacity_factor=capacity_factor)
    C, keep = r["C"], r["keep"]
    aux = load_balance_loss(r["probs"], r["idx"], E)

    # the slot of each assignment in the flat (E * C) buffer; a dropped
    # one writes the spare row E * C and reads back slot 0 (times 0)
    slot = r["idx"].reshape(-1) * C + r["pos"]
    dest = torch.where(keep, slot, E * C)
    src = torch.where(keep, slot, 0)
    tokens = x[:, None, :].expand(S, top_k, d).reshape(S * top_k, d)
    buf = x.new_zeros((E * C + 1, d)).index_put(
        (dest,), tokens)[:E * C].view(E, C, d)

    # batched over E (``matmul`` of 3-d operands is ``torch.bmm``)
    h = F.silu(matmul(buf, w1)) * matmul(buf, w3)
    y_buf = matmul(h, w2).reshape(E * C, d)                  # (E*C, d)

    g = torch.where(keep, r["gate"].reshape(-1), 0.0)
    pulled = (y_buf[src] * g[:, None]).to(x.dtype).view(S, top_k, d)
    y = pulled[:, 0]
    for j in range(1, top_k):
        y = y + pulled[:, j]
    return y, aux
