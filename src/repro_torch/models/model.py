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

The MoE, SSM, hybrid and modality branches are ROADMAP.md queue A item 15.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import blockwise_attention
from .layers import (apply_rope, dense_init, full_f32_matmuls, matmul,
                     rms_norm, swiglu)


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.n_experts or cfg.frontend
            or cfg.global_layer_every):
        raise NotImplementedError(
            f"{cfg.arch_id}: only the dense decoder is ported (family "
            f"{cfg.family!r}); the others are ROADMAP.md queue A item 15")


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


def _attend(cfg: ModelConfig, bp: dict, x: torch.Tensor,
            q_pos: torch.Tensor) -> torch.Tensor:
    B, T, _ = x.shape
    nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = matmul(x, bp["wq"]).reshape(B, T, nh, hd)
    k = matmul(x, bp["wk"]).reshape(B, T, kv, hd)
    v = matmul(x, bp["wv"]).reshape(B, T, kv, hd)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)
    out = blockwise_attention(q, k, v, q_pos=q_pos, k_pos=q_pos,
                              window=cfg.sliding_window)
    return matmul(out.reshape(B, T, nh * hd), bp["wo"])


def _block(cfg: ModelConfig, bp: dict, x: torch.Tensor,
           q_pos: torch.Tensor) -> torch.Tensor:
    """One dense decoder block; returns x in the activation dtype."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    x = x + _attend(cfg, bp, h, q_pos)
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    x = x + swiglu(h, bp["w1"], bp["w3"], bp["w2"])
    return x.to(getattr(torch, cfg.dtype))


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
        layers = {k: v.unbind(0) for k, v in self.blocks.items()}
        for i in range(cfg.n_layers):
            bp = {k: v[i] for k, v in layers.items()}
            if remat:
                x = checkpoint(_block, cfg, bp, x, q_pos, use_reentrant=False)
            else:
                x = _block(cfg, bp, x, q_pos)
        return rms_norm(x, self.final_norm, cfg.norm_eps)
