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

The ``ssm`` family (RWKV6, ``models/rwkv.py``) has the reference's ssm
branches: its parameter tree, a block of time-mix and channel-mix, and a
decode cache of a recurrent state instead of a KV ring: ``S`` (L, B, H,
hd, hd) f32 and the last token's normed inputs ``x_prev_att`` (activation
dtype) and ``x_prev_ffn`` (f32), the dtypes the reference's cache holds
after its prefill.  ``DecoderLM.prefill`` runs each layer's scan through
the kernel (``kernels/rwkv_scan``) from the zero state and writes the
cache in place; ``DecoderLM.decode`` takes one recurrence step a layer in
plain tensor ops, as the reference decodes, and updates the cache in
place.

The ``moe`` family (grok-1-314b, arctic-480b) replaces the block's MLP
by top-k experts (``models/moe.py``), arctic's beside a dense residual
MLP; each block's load-balance loss is returned beside x, and the
forward's ``aux`` is their mean over layers.  The ``hybrid`` family
(hymba-1.5b) runs attention and a selective SSM (``models/ssm.py``) on the
same normed input, norms each and adds half their sum; its layers are
sliding-window but for the first, every ``global_layer_every``-th and the
last, and its decode cache adds the SSM state ``ssm_S`` (L, B, H, N, hd)
beside the KV ring, whose capacity is the context capped at
``GLOBAL_DECODE_CAP``.  The state is stored in the scan's output dtype
(the activation and parameter dtypes promoted: f32 for hymba), the dtype
the reference's cache holds after a decode step; the prefill writes it
rounded through ``cache_dtype``, as the reference's prefill stores it, so
every decode step starts from the reference's values.  The ``vlm`` and
``audio`` frontends (internvl2-2b, musicgen-medium) are dense decoders
whose input starts with ``extra_embeds`` (B, F, d), precomputed
embeddings concatenated before the tokens' in the forward and the prefill
(never at decode).
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
from . import moe, rwkv
from .layers import (apply_rope, dense_init, full_f32_matmuls, matmul,
                     rms_norm, swiglu)
from .ssm import ssm_branch

# hybrid global-attention layers decode against a capped cache
# (StreamingLLM-style) when the context exceeds this
GLOBAL_DECODE_CAP = 32_768


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = full causal attention)."""
    w = np.full((cfg.n_layers,), cfg.sliding_window, np.int32)
    if cfg.global_layer_every:
        w[::cfg.global_layer_every] = 0
        w[-1] = 0
    return w


def cache_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """KV-cache slots per layer for decode at context ``seq_len``: the
    context where a layer attends to all of it (a hybrid's capped at
    ``GLOBAL_DECODE_CAP``), else the largest window."""
    if cfg.attn_free:
        return 0
    wins = layer_windows(cfg)
    if (wins == 0).any():
        cap = seq_len if cfg.global_layer_every == 0 else \
            min(seq_len, GLOBAL_DECODE_CAP)
    else:
        cap = min(seq_len, int(wins.max()))
    return max(cap, 1)


def ssm_state_dtype(cfg: ModelConfig) -> torch.dtype:
    """The hybrid's SSM state dtype: the scan's output, the activation
    and parameter dtypes promoted."""
    return torch.promote_types(getattr(torch, cfg.dtype),
                               getattr(torch, cfg.param_dtype))


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Decode cache for a context of ``seq_len`` tokens (ring buffers):
    ``k``/``v`` (L, B, C, kv, hd) zeros in ``dtype``, ``pos`` (L, B, C)
    int32 all -1, ``next`` the host int 0; a hybrid adds ``ssm_S`` (L, B,
    H, N, hd) zeros in ``ssm_state_dtype``.  For the ssm family, whose
    state does not grow with the context: ``S`` (L, B, H, hd, hd) f32,
    ``x_prev_att`` (L, B, 1, d) in the activation dtype and ``x_prev_ffn``
    (L, B, 1, d) f32, all zeros (``dtype`` does not apply: these are the
    dtypes the computation gives them)."""
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    if cfg.family == "ssm":
        d, H = cfg.d_model, cfg.n_heads
        act = getattr(torch, cfg.dtype)
        return {"S": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                                 device=device),
                "x_prev_att": torch.zeros((L, batch, 1, d), dtype=act,
                                          device=device),
                "x_prev_ffn": torch.zeros((L, batch, 1, d),
                                          dtype=torch.float32, device=device),
                "next": 0}
    C = cache_capacity(cfg, seq_len)
    cache = {"k": torch.zeros((L, batch, C, kv, hd), dtype=dtype,
                              device=device),
             "v": torch.zeros((L, batch, C, kv, hd), dtype=dtype,
                              device=device),
             "pos": torch.full((L, batch, C), -1, dtype=torch.int32,
                               device=device),
             "next": 0}
    if cfg.family == "hybrid":
        cache["ssm_S"] = torch.zeros(
            (L, batch, cfg.n_heads, cfg.ssm_state, hd),
            dtype=ssm_state_dtype(cfg), device=device)
    return cache


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator],
                device) -> dict:
    """A fresh parameter tree with the reference's names, shapes and
    init scales (the random bits differ: the reference draws from JAX's
    threefry, the port from ``generator``)."""
    dt = getattr(torch, cfg.param_dtype)
    d, ff, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def stack(shape, fan_in=None):
        return dense_init((L, *shape), dt, generator=generator, device=device,
                          fan_in=fan_in or shape[0])

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dt, device=device)

    if cfg.family == "ssm":                     # RWKV6
        lora = cfg.rwkv_decay_lora
        ramp = torch.linspace(0.0, 1.5, d, dtype=torch.float32,
                              device=device).to(dt)
        w0 = full(-6.0, L, d) + ramp[None, :]
        blocks = dict(
            ln1=ones(L, d), ln2=ones(L, d), ln_x=ones(L, d),
            **{f"mu_{c}": full(0.5, L, d) for c in "rkvgw"},
            mu_ck=full(0.5, L, d), mu_cr=full(0.5, L, d),
            w_r=stack((d, d)), w_k=stack((d, d)), w_v=stack((d, d)),
            w_g=stack((d, d)), w_o=stack((d, d)),
            wa=stack((d, lora)),
            wb=dense_init((L, lora, d), dt, generator=generator,
                          device=device, fan_in=lora) * 0.01,
            w0=w0,
            u=dense_init((L, nh, hd), dt, generator=generator, device=device,
                         fan_in=hd),
            ck=stack((d, ff)), cv=stack((ff, d), fan_in=ff), cr=stack((d, d)),
        )
    else:
        E = cfg.n_experts
        blocks = dict(
            ln1=ones(L, d), ln2=ones(L, d),
            wq=stack((d, nh * hd)), wk=stack((d, kv * hd)),
            wv=stack((d, kv * hd)), wo=stack((nh * hd, d), fan_in=nh * hd),
        )
        if E:
            def experts(a, b):
                return dense_init((L, E, a, b), dt, generator=generator,
                                  device=device, fan_in=a)
            blocks.update(router=stack((d, E)), moe_w1=experts(d, ff),
                          moe_w3=experts(d, ff), moe_w2=experts(ff, d))
        if not E or cfg.dense_residual:
            blocks.update(w1=stack((d, ff)), w3=stack((d, ff)),
                          w2=stack((ff, d), fan_in=ff))
        if cfg.family == "hybrid":
            dssm, N = nh * hd, cfg.ssm_state
            a_log = torch.log(torch.linspace(1.0, 16.0, nh,
                                             dtype=torch.float32,
                                             device=device)).to(dt)
            blocks.update(
                ln_attn=ones(L, dssm), ln_ssm=ones(L, dssm),
                w_in=stack((d, dssm)), w_gate=stack((d, dssm)),
                w_dt=stack((d, nh)), dt_bias=full(0.0, L, nh),
                a_log=full(0.0, L, nh) + a_log[None, :],
                w_B=stack((d, N)), w_C=stack((d, N)),
                w_out=dense_init((L, dssm, d), dt, generator=generator,
                                 device=device, fan_in=dssm),
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


def _mlp(cfg: ModelConfig, bp: dict, x: torch.Tensor):
    """The MLP or the experts (and arctic's dense residual MLP beside
    them) on the normed x; returns (out, aux): aux is the experts' f32
    load-balance loss, None without experts."""
    if not cfg.n_experts:
        return swiglu(x, bp["w1"], bp["w3"], bp["w2"]), None
    B, T, d = x.shape
    y, aux = moe.moe_mlp(x.reshape(B * T, d), bp["router"], bp["moe_w1"],
                         bp["moe_w3"], bp["moe_w2"], top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor)
    y = y.reshape(B, T, d)
    if cfg.dense_residual:
        y = y + swiglu(x, bp["w1"], bp["w3"], bp["w2"])
    return y, aux


def _mlp_tail(cfg: ModelConfig, bp: dict, x: torch.Tensor):
    """The block after its attention: (x + MLP(norm(x)) in the activation
    dtype, aux as ``_mlp`` returns it)."""
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    y, aux = _mlp(cfg, bp, h)
    return (x + y).to(getattr(torch, cfg.dtype)), aux


def _hybrid_mix(cfg: ModelConfig, bp: dict, x: torch.Tensor,
                a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The hybrid's parallel heads: x + (norm(a) + norm(s)) / 2."""
    a = rms_norm(a, bp["ln_attn"], cfg.norm_eps)
    s = rms_norm(s, bp["ln_ssm"], cfg.norm_eps)
    return x + 0.5 * (a + s)


def _hybrid_cached(cfg: ModelConfig, bp: dict, x: torch.Tensor,
                   h: torch.Tensor, a: torch.Tensor, S: torch.Tensor,
                   round_to: torch.dtype) -> torch.Tensor:
    """The hybrid's parallel heads at prefill or decode: the SSM on h from
    the cached state S, which takes the new state in place, rounded
    through ``round_to``."""
    s, S_new = ssm_branch(bp, h, cfg, S)
    S.copy_(S_new.to(round_to))
    return _hybrid_mix(cfg, bp, x, a, s)


def _block(cfg: ModelConfig, bp: dict, x: torch.Tensor, window: int,
           q_pos: torch.Tensor):
    """One attention decoder block (dense, moe, hybrid, the frontends'),
    the hybrid's SSM from the zero state; returns (x in the activation
    dtype, aux)."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    a = _attend(cfg, bp, h, window, q_pos)
    if cfg.family == "hybrid":
        S = torch.zeros((x.shape[0], cfg.n_heads, cfg.ssm_state, cfg.hd),
                        dtype=x.dtype, device=x.device)
        s, _ = ssm_branch(bp, h, cfg, S)
        x = _hybrid_mix(cfg, bp, x, a, s)
    else:
        x = x + a
    return _mlp_tail(cfg, bp, x)


def _ssm_block(cfg: ModelConfig, bp: dict, x: torch.Tensor):
    """One RWKV6 block from the zero state (the training forward); returns
    (x in the activation dtype, None)."""
    B = x.shape[0]
    S = torch.zeros((B, cfg.n_heads, cfg.hd, cfg.hd), dtype=x.dtype,
                    device=x.device)
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    y, _ = rwkv.time_mix(bp, h, cfg, S)
    x = x + y
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    x = x + rwkv.channel_mix(bp, h)
    return x.to(getattr(torch, cfg.dtype)), None


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
    the weights are drawn from ``generator`` on ``device``.

    ``flat_store`` is None, or under flat residency the flat parameter
    store ``{dtype_name: (1, padded)}`` whose views the parameters are
    (``PHubEngine.resident`` sets it, and the train step re-points the
    parameters at each new store)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 params: Optional[dict] = None):
        super().__init__()
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
        self.flat_store: Optional[dict] = None

    def param_tree(self) -> dict:
        """The parameters as the reference's nested dict (same keys)."""
        tree = {"embed": self.embed, "blocks": dict(self.blocks.items()),
                "final_norm": self.final_norm}
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head
        return tree

    def lm_head_weight(self) -> torch.Tensor:
        return self.embed.t() if self.cfg.tie_embeddings else self.lm_head

    def forward(self, tokens: torch.Tensor, *,
                extra_embeds: Optional[torch.Tensor] = None,
                remat: bool = True, with_aux: bool = False):
        """tokens: (B, T) int; ``extra_embeds``: (B, F, d) frontend
        embeddings put before the tokens' (the sequence is then F + T
        long).  Returns the final-normed hidden state (B, F + T, d) (the
        LM head is applied by the loss), and with ``with_aux`` also the
        mean over layers of the experts' load-balance loss, an f32 scalar
        (0 without experts)."""
        cfg = self.cfg
        x = self._embed(tokens, extra_embeds)
        q_pos = torch.arange(x.shape[1], device=x.device)
        wins = layer_windows(cfg)
        auxs = []
        for i, bp in enumerate(self._layers()):
            if cfg.family == "ssm":
                fn, args = _ssm_block, (cfg, bp, x)
            else:
                fn, args = _block, (cfg, bp, x, int(wins[i]), q_pos)
            if remat:
                x, aux = checkpoint(fn, *args, use_reentrant=False)
            else:
                x, aux = fn(*args)
            auxs.append(aux)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if not with_aux:
            return x
        if cfg.n_experts:
            return x, torch.stack(auxs).mean()
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def _embed(self, tokens: torch.Tensor,
               extra_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        """The tokens' embeddings in the activation dtype, after the
        frontend's when given."""
        x = self.embed[tokens].to(getattr(torch, self.cfg.dtype))
        if extra_embeds is None:
            return x
        if self.cfg.family == "ssm":
            raise ValueError(f"{self.cfg.arch_id}: the ssm family takes no "
                             f"frontend embeddings")
        return torch.cat([extra_embeds.to(x.dtype), x], dim=1)

    def _layers(self) -> list[dict]:
        """Each layer's parameters: views of the stacks."""
        layers = {k: v.unbind(0) for k, v in self.blocks.items()}
        return [{k: v[i] for k, v in layers.items()}
                for i in range(self.cfg.n_layers)]

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *,
                extra_embeds: Optional[torch.Tensor] = None,
                max_new_tokens: int = 0,
                cache_dtype=torch.bfloat16) -> tuple[torch.Tensor, dict]:
        """Process a prompt (B, T), after ``extra_embeds`` (B, F, d) when
        given, and return (the final-normed hidden state (B, F + T, d), a
        cache ready for decode).  The cache holds ``F + T +
        max_new_tokens`` slots a layer (capped at the window), so a
        full-attention model does not evict prompt tokens while it
        generates.  Attention runs through ``swa_attn.ops.swa_attention``
        once a layer, on the f32 q/k/v (the cache holds them in
        ``cache_dtype``); a hybrid's SSM runs from the zero state and its
        last state is stored rounded through ``cache_dtype``.  The ssm
        family's cache has no slots; its scan runs through
        ``rwkv_scan.ops.rwkv_scan`` once a layer."""
        cfg = self.cfg
        x = self._embed(tokens, extra_embeds)
        B, T = x.shape[:2]
        cache = init_cache(cfg, B, T + max_new_tokens, dtype=cache_dtype,
                           device=tokens.device)
        if cfg.family == "ssm":
            return self._ssm_layers(x, cache, use_kernel=True), cache
        q_pos = torch.arange(T, device=x.device)
        wins = layer_windows(cfg)
        for i, bp in enumerate(self._layers()):
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            q, k, v = _qkv(cfg, bp, h, q_pos)
            a = swa_ops.swa_attention(q, k, v, window=int(wins[i]))
            a = matmul(a.reshape(B, T, -1), bp["wo"])
            _fill_ring(cache["k"][i], cache["v"][i], cache["pos"][i], k, v)
            if cfg.family == "hybrid":
                x = _hybrid_cached(cfg, bp, x, h, a, cache["ssm_S"][i],
                                   cache_dtype)
            else:
                x = x + a
            x, _ = _mlp_tail(cfg, bp, x)
        cache["next"] = T
        return rms_norm(x, self.final_norm, cfg.norm_eps), cache

    @torch.inference_mode()
    def decode(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """One token a row, tokens (B, 1), against ``cache``, which is
        updated in place (k/v/pos at slot ``next % C`` of every layer, a
        hybrid's ``ssm_S``, and ``next``).  Returns the final-normed hidden
        state (B, 1, d).  Attention runs through
        ``decode_attn.ops.decode_attention`` once a layer; the ssm family
        takes one recurrence step a layer instead."""
        cfg = self.cfg
        B, T = tokens.shape
        if T != 1:
            raise ValueError(f"decode takes one token a row, got {T}")
        x = self._embed(tokens, None)
        if cfg.family == "ssm":
            return self._ssm_layers(x, cache, use_kernel=False)
        nxt = cache["next"]
        slot = nxt % cache["k"].shape[2]
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
            a = matmul(a.reshape(B, 1, -1), bp["wo"])
            if cfg.family == "hybrid":
                S = cache["ssm_S"][i]
                x = _hybrid_cached(cfg, bp, x, h, a, S, S.dtype)
            else:
                x = x + a
            x, _ = _mlp_tail(cfg, bp, x)
        cache["next"] = nxt + 1
        return rms_norm(x, self.final_norm, cfg.norm_eps)

    def _ssm_layers(self, x: torch.Tensor, cache: dict, *,
                    use_kernel: bool) -> torch.Tensor:
        """The ssm layers over x (B, T, d) against ``cache``, updated in
        place (S, both x_prev, ``next``), the token shifts carried from
        the cache's x_prev (zeros after ``init_cache``): the prefill runs
        each layer's scan through ``rwkv_scan`` (``use_kernel``), a decode
        step one recurrence step in plain tensor ops, y from S before the
        update.  Returns the final-normed hidden state."""
        cfg = self.cfg
        for i, bp in enumerate(self._layers()):
            h = rms_norm(x, bp["ln1"], cfg.norm_eps)
            y, S = rwkv.time_mix(bp, h, cfg, cache["S"][i],
                                 x_prev=cache["x_prev_att"][i],
                                 use_kernel=use_kernel)
            cache["S"][i].copy_(S)
            cache["x_prev_att"][i].copy_(h[:, -1:])
            x = x + y
            h = rms_norm(x, bp["ln2"], cfg.norm_eps)
            x = x + rwkv.channel_mix(bp, h, x_prev=cache["x_prev_ffn"][i])
            cache["x_prev_ffn"][i].copy_(h[:, -1:])
            x = x.to(getattr(torch, cfg.dtype))
        cache["next"] += x.shape[1]
        return rms_norm(x, self.final_norm, cfg.norm_eps)
