"""Dense decoder model (the ``dense`` branches of ``repro/models/model.py``).

Parameters stay **stacked over layers** (``blocks.wq`` is
``(L, d, nh*hd)``, ...) as in the reference, so the chunk domain built from
``param_tree()`` matches the reference's leaf for leaf.  The forward walks
the layers in a Python loop over ``unbind`` views of the stacks, each block
under ``torch.utils.checkpoint`` when ``remat``.

The residual stream is rounded to the activation dtype where the
reference rounds it: after the embedding and at every block's end (and
``rms_norm`` returns its input's dtype).  Inside a block the attention
output is f32, so the residual is f32 until the block's end, as in JAX.

Serving (the dense branches of the reference's ``init_cache``,
``prefill``/``_prefill_forward`` and ``forward(cache=)``) keeps a
ring-buffer KV cache per layer whose slots carry global positions (-1 =
empty), so a sliding window's eviction needs no special handling.
``DecoderLM.prefill`` runs the prompt through the flash attention kernel
(``kernels/swa_attn``) and fills the ring from the last ``min(T, C)``
tokens; ``DecoderLM.decode`` inserts one token at slot ``next % C`` of each
layer's cache **in place** (JAX donates the cache; the port never copies
it) and attends through the decode kernel (``kernels/decode_attn``).
``next`` stays a host int, so the slot costs no device-to-host sync.  Both
run under ``torch.inference_mode()``; the training forward keeps
``blockwise_attention`` under autograd.

The MoE, SSM, hybrid and modality branches are ROADMAP.md queue A item 15.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
# modules, not names: the kernels' plain versions import models.attention
from ..kernels.decode_attn import ops as decode_ops
from ..kernels.swa_attn import ops as swa_ops
from .attention import blockwise_attention
from .layers import (apply_rope, dense_init, full_f32_matmuls, matmul,
                     rms_norm, swiglu)


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.n_experts or cfg.frontend
            or cfg.global_layer_every):
        raise NotImplementedError(
            f"{cfg.arch_id}: only the dense decoder is ported (family "
            f"{cfg.family!r}); the others are ROADMAP.md queue A item 15")


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = full causal attention)."""
    w = np.full((cfg.n_layers,), cfg.sliding_window, np.int32)
    if cfg.global_layer_every:
        w[::cfg.global_layer_every] = 0
        w[-1] = 0
    return w


def cache_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """KV-cache slots per layer for decode at context ``seq_len``: the
    context where a layer attends to all of it, else the largest window."""
    _check_supported(cfg)
    wins = layer_windows(cfg)
    cap = seq_len if (wins == 0).any() else min(seq_len, int(wins.max()))
    return max(cap, 1)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Decode cache for a context of ``seq_len`` tokens (ring buffers):
    ``k``/``v`` (L, B, C, kv, hd) zeros in ``dtype``, ``pos`` (L, B, C)
    int32 all -1, ``next`` the host int 0."""
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    C = cache_capacity(cfg, seq_len)
    return {"k": torch.zeros((L, batch, C, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((L, batch, C, kv, hd), dtype=dtype,
                             device=device),
            "pos": torch.full((L, batch, C), -1, dtype=torch.int32,
                              device=device),
            "next": 0}


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator],
                device) -> dict:
    """A fresh parameter tree with the reference's names, shapes and
    init scales (the random bits differ: the reference draws from JAX's
    threefry, the port from ``generator``)."""
    _check_supported(cfg)
    dt = getattr(torch, cfg.param_dtype)
    d, ff, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def stack(shape, fan_in=None):
        return dense_init((L, *shape), dt, generator=generator, device=device,
                          fan_in=fan_in or shape[0])

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    blocks = dict(
        ln1=ones(L, d), ln2=ones(L, d),
        wq=stack((d, nh * hd)), wk=stack((d, kv * hd)),
        wv=stack((d, kv * hd)), wo=stack((nh * hd, d), fan_in=nh * hd),
        w1=stack((d, ff)), w3=stack((d, ff)), w2=stack((ff, d), fan_in=ff),
    )
    params = {
        "embed": dense_init((V, d), dt, generator=generator, device=device,
                            fan_in=d),
        "blocks": blocks,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, V), dt, generator=generator,
                                       device=device)
    return params


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree as storage-free meta tensors (shapes/dtypes)."""
    return init_params(cfg, generator=None, device="meta")


def _qkv(cfg: ModelConfig, bp: dict, x: torch.Tensor, q_pos: torch.Tensor):
    """The block's q (B, T, nh, hd) and k, v (B, T, kv, hd), RoPE applied
    to q and k at ``q_pos``."""
    B, T, _ = x.shape
    nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = matmul(x, bp["wq"]).reshape(B, T, nh, hd)
    k = matmul(x, bp["wk"]).reshape(B, T, kv, hd)
    v = matmul(x, bp["wv"]).reshape(B, T, kv, hd)
    return (apply_rope(q, q_pos, cfg.rope_theta),
            apply_rope(k, q_pos, cfg.rope_theta), v)


def _attend(cfg: ModelConfig, bp: dict, x: torch.Tensor, window: int,
            q_pos: torch.Tensor) -> torch.Tensor:
    B, T, _ = x.shape
    q, k, v = _qkv(cfg, bp, x, q_pos)
    out = blockwise_attention(q, k, v, q_pos=q_pos, k_pos=q_pos,
                              window=window)
    return matmul(out.reshape(B, T, -1), bp["wo"])


def _mlp_tail(cfg: ModelConfig, bp: dict, x: torch.Tensor) -> torch.Tensor:
    """The block after its attention: x + MLP(norm(x)), in the activation
    dtype."""
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    x = x + swiglu(h, bp["w1"], bp["w3"], bp["w2"])
    return x.to(getattr(torch, cfg.dtype))


def _block(cfg: ModelConfig, bp: dict, x: torch.Tensor, window: int,
           q_pos: torch.Tensor) -> torch.Tensor:
    """One dense decoder block; returns x in the activation dtype."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    x = x + _attend(cfg, bp, h, window, q_pos)
    return _mlp_tail(cfg, bp, x)


def _fill_ring(ck: torch.Tensor, cv: torch.Tensor, cpos: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a prompt's K/V (B, T, kv, hd) into one layer's ring (B, C,
    kv, hd) in place, position p at slot p % C: all of it at slot 0 when
    T < C (``pos`` -1 past T), else its last C tokens, rotated (the
    reference's tail slice + roll) with ``pos = T-1-((T-1-slot) % C)``."""
    B, T = k.shape[:2]
    C = ck.shape[1]
    slots = torch.arange(C, dtype=torch.int32, device=ck.device)
    if T >= C:
        r = (T - C) % C         # the slot of the tail's first token
        for dst, src in ((ck, k), (cv, v)):
            dst[:, r:].copy_(src[:, T - C:T - r])
            dst[:, :r].copy_(src[:, T - r:])
        cpos.copy_((T - 1 - ((T - 1 - slots) % C)).expand(B, C))
    else:
        ck[:, :T].copy_(k)
        cv[:, :T].copy_(v)
        cpos.copy_(torch.where(slots < T, slots, -1).expand(B, C))


class DecoderLM(nn.Module):
    """The dense decoder.  ``params`` (a tree as ``init_params`` returns,
    e.g. from ``convert.params_from_numpy``) is adopted as is; otherwise
    the weights are drawn from ``generator`` on ``device``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 params: Optional[dict] = None):
        super().__init__()
        _check_supported(cfg)
        full_f32_matmuls()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, generator=generator, device=device)
        self.embed = nn.Parameter(params["embed"])
        self.blocks = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params["blocks"].items()})
        self.final_norm = nn.Parameter(params["final_norm"])
        self.lm_head = (nn.Parameter(params["lm_head"])
                        if "lm_head" in params else None)

    def param_tree(self) -> dict:
        """The parameters as the reference's nested dict (same keys)."""
        tree = {"embed": self.embed, "blocks": dict(self.blocks.items()),
                "final_norm": self.final_norm}
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head
        return tree

    def lm_head_weight(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head

    def forward(self, tokens: torch.Tensor, *, remat: bool = True
                ) -> torch.Tensor:
        """tokens: (B, T) int.  Returns the final-normed hidden state
        (B, T, d); the LM head is applied by the loss."""
        cfg = self.cfg
        x = self.embed[tokens].to(getattr(torch, cfg.dtype))
        q_pos = torch.arange(x.shape[1], device=x.device)
        wins = layer_windows(cfg)
        for i, bp in enumerate(self._layers()):
            w = int(wins[i])
            if remat:
                x = checkpoint(_block, cfg, bp, x, w, q_pos,
                               use_reentrant=False)
            else:
                x = _block(cfg, bp, x, w, q_pos)
        return rms_norm(x, self.final_norm, cfg.norm_eps)

    def _layers(self) -> list[dict]:
        """Each layer's parameters: views of the stacks."""
        layers = {k: v.unbind(0) for k, v in self.blocks.items()}
        return [{k: v[i] for k, v in layers.items()}
                for i in range(self.cfg.n_layers)]

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, max_new_tokens: int = 0,
                cache_dtype=torch.bfloat16) -> tuple[torch.Tensor, dict]:
        """Process a prompt (B, T) and return (the final-normed hidden
        state (B, T, d), a cache ready for decode).  The cache holds
        ``T + max_new_tokens`` slots a layer (capped at the window), so a
        full-attention model does not evict prompt tokens while it
        generates.  Attention runs through ``swa_attn.ops.swa_attention``
        once a layer, on the f32 q/k/v (the cache holds them in
        ``cache_dtype``)."""
        cfg = self.cfg
        B, T = tokens.shape
        cache = init_cache(cfg, B, T + max_new_tokens, dtype=cache_dtype,
                           device=tokens.device)
        x = self.embed[tokens].to(getattr(torch, cfg.dtype))
        q_pos = torch.arange(T, device=x.device)
        wins = layer_windows(cfg)
        for i, bp in enumerate(self._layers()):
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            q, k, v = _qkv(cfg, bp, h, q_pos)
            a = swa_ops.swa_attention(q, k, v, window=int(wins[i]))
            x = x + matmul(a.reshape(B, T, -1), bp["wo"])
            _fill_ring(cache["k"][i], cache["v"][i], cache["pos"][i], k, v)
            x = _mlp_tail(cfg, bp, x)
        cache["next"] = T
        return rms_norm(x, self.final_norm, cfg.norm_eps), cache

    @torch.inference_mode()
    def decode(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """One token a row, tokens (B, 1), against ``cache``, which is
        updated in place (k/v/pos at slot ``next % C`` of every layer, and
        ``next``).  Returns the final-normed hidden state (B, 1, d).
        Attention runs through ``decode_attn.ops.decode_attention`` once a
        layer."""
        cfg = self.cfg
        B, T = tokens.shape
        if T != 1:
            raise ValueError(f"decode takes one token a row, got {T}")
        nxt = cache["next"]
        slot = nxt % cache["k"].shape[2]
        x = self.embed[tokens].to(getattr(torch, cfg.dtype))
        q_pos = torch.arange(nxt, nxt + 1, device=x.device)
        qp = torch.full((B,), nxt, dtype=torch.int32, device=x.device)
        wins = layer_windows(cfg)
        for i, bp in enumerate(self._layers()):
            ck, cv, cpos = cache["k"][i], cache["v"][i], cache["pos"][i]
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            q, k, v = _qkv(cfg, bp, h, q_pos)
            ck[:, slot] = k[:, 0]
            cv[:, slot] = v[:, 0]
            cpos[:, slot] = nxt
            a = decode_ops.decode_attention(q, ck, cv, cpos, qp,
                                            window=int(wins[i]))
            x = x + matmul(a.reshape(B, 1, -1), bp["wo"])
            x = _mlp_tail(cfg, bp, x)
        cache["next"] = nxt + 1
        return rms_norm(x, self.final_norm, cfg.norm_eps)
