"""Configuration dataclasses for the PyTorch port.

``ModelConfig`` is the reference's (``repro/configs/base.py``) field for
field, so one architecture means the same widths in both packages.
``TrainConfig`` keeps only the fields this port implements: the
sharded_ps, hierarchical, allreduce, centralized_ps and fsdp_stream
exchanges, the three rules of the sharded-optimizer protocol (Nesterov,
SGD, Adam) with the reference's ``weight_decay`` (Nesterov and Adam; the
reference's SGD takes none), whose fused aggregate+update always runs
through the rule's CUDA kernel (the reference's ``use_pallas``/
``fused_agg_opt`` switches have no counterpart), gradient accumulation
over ``microbatch`` steps, the wire format of the exchange and of the
hierarchical strategy's cross-pod (DCN) tier, and the gradient processing
pipeline's windows, chunk-ready dispatch and flat parameter residency.
The reference's other knobs (``dp_over_model``: the stacked Comm has no
``model`` axis; ``grad_clip``, a field the reference never reads) are not
fields here, so a config cannot ask for them and be silently ignored.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                      # attention query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM / RWKV ---
    ssm_state: int = 0
    rwkv_decay_lora: int = 64

    # --- attention variants ---
    sliding_window: int = 0           # 0 = full attention
    global_layer_every: int = 0

    # --- misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"           # activation dtype
    param_dtype: str = "float32"      # parameter storage dtype

    # --- modality frontend ---
    frontend: Optional[str] = None
    frontend_tokens: int = 0

    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is o(seq): SSM / hybrid / sliding-window."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def n_params(self) -> int:
        """Total parameter count (analytic), as the reference counts it."""
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            per_layer = 4 * d * d + 2 * d * self.rwkv_decay_lora + 2 * d * ff + 2 * d
        else:
            nh, kv, hd = self.n_heads, self.n_kv_heads, self.hd
            attn = d * nh * hd + 2 * d * kv * hd + nh * hd * d
            if self.family == "hybrid":
                dssm = nh * hd
                attn += d * 2 * dssm + 2 * d * self.ssm_state + dssm + dssm * d
            if self.n_experts:
                mlp = self.n_experts * 3 * d * ff + d * self.n_experts
                if self.dense_residual:
                    mlp += 3 * d * ff
            else:
                mlp = 3 * d * ff
            per_layer = attn + mlp + 2 * d
        return emb + L * per_layer + d

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: top-k of the experts)."""
        if not self.n_experts:
            return self.n_params()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        dense_total = self.n_params() - L * self.n_experts * 3 * d * ff
        return dense_total + L * self.top_k * 3 * d * ff


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + parameter-exchange (PHub) configuration."""
    optimizer: str = "nesterov"       # nesterov (the paper's) | sgd | adam
    lr: float = 1e-2
    momentum: float = 0.9             # nesterov only
    weight_decay: float = 0.0         # g + wd * p before the rule: nesterov
                                      # and adam (the reference's sgd takes
                                      # none, so sgd ignores it)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8

    # --- PHub exchange (the paper's contribution) ---
    # allreduce | sharded_ps | centralized_ps | hierarchical | fsdp_stream
    strategy: str = "sharded_ps"
    chunk_size_bytes: int = 32 * 1024 # paper default: 32 KB (§3.2.3)
    # the dtype a chunk travels in (core/wire.py): identity | bf16 | f16 |
    # int8; a non-identity wire adds the f32 ``wire_ef`` slot
    wire_format: str = "identity"
    wire_format_dcn: Optional[str] = None
                                      # per-tier wire format (DESIGN.md §16):
                                      # the dtype the *cross-pod (DCN)* leg
                                      # of the hierarchical strategy travels
                                      # in, independent of the in-rack (ICI)
                                      # wire_format above — e.g. identity
                                      # in-rack + int8 across racks.  None or
                                      # "identity" keeps the legacy psum
                                      # datapath byte-for-byte; a non-
                                      # identity value requires
                                      # strategy="hierarchical" and rides the
                                      # encoded cross-pod all-gather with a
                                      # per-pod error-feedback residual in
                                      # the 'wire_ef' slot (owned by the DCN
                                      # tier only when the ICI wire is
                                      # identity; an encoded ICI wire keeps
                                      # the slot for its pull delta and the
                                      # DCN leg runs scales-only)

    # --- gradient processing pipeline (§3.2, DESIGN.md §8) ---
    pipeline_windows: int = 1         # split each dtype group's chunk domain
                                      # into this many windows: window w's
                                      # ring reduce-scatter overlaps window
                                      # w-1's fused agg+opt (1 = monolithic
                                      # collectives, today's behavior);
                                      # sharded_ps / hierarchical only
    overlap_backward: bool = False    # chunk-ready dispatch (DESIGN.md §14):
                                      # each window's reduce-scatter depends
                                      # only on the cotangents of the leaves
                                      # it covers, so XLA can start window
                                      # rings while the rest of the backward
                                      # is still running; sharded_ps /
                                      # hierarchical, single model shard
    flat_residency: bool = False      # params live as flat chunk-domain
                                      # vectors across steps: the forward
                                      # pass consumes per-leaf slice views
                                      # and the train step donates the flat
                                      # store, eliminating the per-step
                                      # flatten/unflatten round trip

    # --- memory policy ---
    microbatch: int = 1               # gradient-accumulation steps per
                                      # exchange (activations shrink 1/k;
                                      # one PHub exchange per global batch)
    remat: bool = True                # activation checkpointing on blocks
    loss_chunk: int = 1024            # chunked cross-entropy block (tokens)

    seed: int = 0

    def exchange_signature(self) -> tuple:
        """The fields that define the shared collective schedule (the
        reference's, less the fields the port has not).  Tenants
        co-scheduled onto one rack chunk domain (``core/api.py``) must
        agree on these, one wire format included; lr, momentum, the
        architecture, the batch and the optimizer itself may differ per
        tenant."""
        return (self.strategy, self.chunk_size_bytes, self.pipeline_windows,
                self.flat_residency, self.wire_format, self.overlap_backward,
                self.wire_format_dcn or "identity")


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            n_experts: int = 4) -> ModelConfig:
    """The reference's reduced same-family variant (<=2 layers,
    d_model<=512, <=4 experts), field for field."""
    nh = max(2, min(cfg.n_heads, 4)) if cfg.n_heads else 0
    kv = max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads else 0
    hd = d_model // nh if nh else 64
    return dataclasses.replace(
        cfg,
        n_layers=layers,
        d_model=d_model,
        n_heads=nh,
        n_kv_heads=kv,
        head_dim=hd,
        d_ff=d_model * 3,
        vocab_size=min(cfg.vocab_size, 512),
        n_experts=min(cfg.n_experts, n_experts) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        rwkv_decay_lora=16,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        frontend_tokens=min(cfg.frontend_tokens, 16) if cfg.frontend_tokens else 0,
        param_dtype="float32",
    )
