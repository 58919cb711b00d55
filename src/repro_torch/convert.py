"""Carry state over from the JAX package: numpy in, the port's tensors out.

``params_from_numpy`` takes the reference's parameter tree as a nested
dict of numpy arrays (as ``jax.device_get`` returns it) and builds the
port's model from it; ``opt_from_numpy`` takes the reference's optimizer
slots (``{dtype: {slot: array}}`` of shape ``(mo, S, Lr)`` or
``(mo, padded)``, ``repro/core/engine.py`` ``opt_state_shapes``) and lays
them out as the port's ``(S, state_len)``, any slots in their own dtypes
(Adam's m/v in the group dtype, k1/k2 and an encoded wire's ``wire_ef``
f32 in every group).  Given the engine's ``exchange_slots``, it checks
that the reference's state holds exactly those slots, in those dtypes.
``packed_opt_from_numpy`` and ``packed_opt_to_numpy`` carry the
co-scheduler's packed optimizer state of a ``TenantPackedDomain`` across
(the reference's ``{dtype: {slot: (mo, S, Lr) or (mo, padded)}}`` over
its domain, the port's stacked ``(S, state_len)`` over the same layout),
so both packages can start a co-scheduled step from the same momentum.
``fsdp_opt_from_numpy`` takes an fsdp_stream engine's state (``{slot:
parameter tree}``, the reference's ``opt_state_shapes`` there) leaf for
leaf.  ``cache_from_numpy`` takes the reference's decode cache (``init_cache`` /
``prefill``'s ``cache``: a KV ring, a hybrid's with its SSM state, or the
ssm family's state) and returns the port's, ``next`` as a host int.
bfloat16 arrays (numpy's ``ml_dtypes`` extension type) are carried bit for
bit.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.chunking import ChunkPlan, leaf_paths
from .models import DecoderLM, init_cache, param_specs, ssm_state_dtype


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":        # torch.from_numpy has no bf16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(cfg: ModelConfig, tree: dict, *,
                      device="cuda") -> DecoderLM:
    """The reference's parameter tree -> the port's DecoderLM."""
    want = dict(leaf_paths(param_specs(cfg)))
    got = dict(leaf_paths(tree))
    if set(want) != set(got):
        raise ValueError(f"parameter paths differ: missing "
                         f"{sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    for path, spec in want.items():
        if tuple(np.shape(got[path])) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {np.shape(got[path])} != "
                             f"{tuple(spec.shape)}")

    def convert(node):
        return {k: convert(v) if isinstance(v, dict)
                else _tensor(v, device) for k, v in node.items()}
    return DecoderLM(cfg, device=device, params=convert(tree))


def opt_from_numpy(plan: ChunkPlan, opt: dict, *, slots=None,
                   device="cuda") -> dict:
    """The reference's optimizer slots -> {dtype: {slot: (S, L) tensor}}.
    ``slots``: the engine's ``exchange_slots`` (SlotSpecs) to check the
    slot names and dtypes against, or None."""
    return _slots_from_numpy(plan.groups, opt, slots, device)


def packed_opt_from_numpy(domain, opt: dict, *, slots=None,
                          device="cuda") -> dict:
    """The reference's packed optimizer state over a TenantPackedDomain
    (``{dtype: {slot: (1, S, Lr) or (1, padded)}}``, the union slots and
    ``wire_ef``) -> the port's {dtype: {slot: (S, L) tensor}} over the
    same domain (``PHubConnectionManager``'s, on the stacked Comm).
    ``slots``: ``engine.co_slot_specs`` to check against, or None."""
    return _slots_from_numpy(domain.groups.values(), opt, slots, device)


def packed_opt_to_numpy(domain, opt: dict) -> dict:
    """The port's packed optimizer state -> the reference's layout over
    the same domain, ``{dtype: {slot: (1, padded) array}}`` (bf16 slots
    as numpy's ``bfloat16``, bit for bit)."""
    out = {}
    for key, g in domain.groups.items():
        out[key] = {}
        for name, t in opt[key].items():
            t = t.detach().to("cpu").reshape(1, g.padded)
            if t.dtype == torch.bfloat16:
                import ml_dtypes
                a = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            else:
                a = t.numpy()
            out[key][name] = a.copy()
    return out


def _slots_from_numpy(groups, opt: dict, slots, device) -> dict:
    out = {}
    for g in groups:
        if slots is not None:
            want = {s.name: s.resolve_dtype(g.dtype) for s in slots}
            got = {n: _tensor(np.asarray(a).reshape(-1)[:1], "cpu").dtype
                   for n, a in opt[g.key].items()}
            if got != want:
                raise ValueError(f"{g.key}: slots {got} are not the "
                                 f"engine's {want}")
        res = {}
        for name, a in opt[g.key].items():
            a = np.asarray(a)
            if a.shape[0] != 1 or a[0].size != g.padded:
                raise ValueError(
                    f"{g.key}/{name}: shape {a.shape} is not (1, S, Lr) or "
                    f"(1, padded) with padded={g.padded}")
            res[name] = _tensor(a.reshape(g.n_shards, g.shard_len), device)
        out[g.key] = res
    return out


def fsdp_opt_from_numpy(cfg: ModelConfig, opt: dict, *, slots=None,
                        device="cuda") -> dict:
    """The reference's fsdp_stream optimizer state ``{slot: tree}`` (each
    leaf the parameter's shape) -> the port's, the same tree of tensors.
    ``slots``: the engine's ``exchange_slots`` to check the slot names
    and each leaf's dtype against, or None."""
    want = dict(leaf_paths(param_specs(cfg)))
    if slots is not None and set(opt) != {s.name for s in slots}:
        raise ValueError(f"slots {sorted(opt)} are not the engine's "
                         f"{[s.name for s in slots]}")
    out = {}
    for name, tree in opt.items():
        got = dict(leaf_paths(tree))
        if set(got) != set(want):
            raise ValueError(f"slot {name}: leaf paths differ from the "
                             f"model's")
        spec = {s.name: s for s in slots or ()}.get(name)
        leaves = {}
        for path, a in got.items():
            t = _tensor(a, device)
            if tuple(t.shape) != tuple(want[path].shape) or (
                    spec is not None
                    and t.dtype != spec.resolve_dtype(want[path].dtype)):
                raise ValueError(f"{name}{path}: {t.dtype} "
                                 f"{tuple(t.shape)} does not fit the "
                                 f"leaf {tuple(want[path].shape)}")
            leaves[path] = t
        out[name] = _nest(leaves)
    return out


def _nest(flat: dict) -> dict:
    """{"['blocks']['wq']": v} -> {"blocks": {"wq": v}}."""
    tree: dict = {}
    for path, v in flat.items():
        keys = [k.strip("'") for k in path[1:-1].split("][")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def cache_from_numpy(cfg: ModelConfig, cache: dict, *,
                     device="cuda") -> dict:
    """The reference's decode cache (numpy ``k``/``v`` (L, B, C, kv, hd),
    ``pos`` (L, B, C) int32, ``next`` a scalar; for the ssm family ``S``
    (L, B, H, hd, hd), ``x_prev_att`` and ``x_prev_ffn`` (L, B, 1, d),
    ``next``; a hybrid's also ``ssm_S`` (L, B, H, N, hd)) -> the port's
    dict, every array in its own dtype (bf16 bit for bit) but a hybrid's
    ``ssm_S``, which is held in ``ssm_state_dtype`` (the values the
    reference's carry, ``models/model.py``), and ``next`` a host int."""
    if cfg.family == "ssm":
        names = ("S", "x_prev_att", "x_prev_ffn")
        want = init_cache(cfg, np.shape(cache["S"])[1], 0, device="meta")
    else:
        names = ("k", "v", "pos") + (("ssm_S",) if cfg.family == "hybrid"
                                     else ())
        k = np.asarray(cache["k"])
        want = init_cache(cfg, k.shape[1], k.shape[2], device="meta")
    out = {}
    for name in names:
        a = np.asarray(cache[name])
        if a.shape != tuple(want[name].shape):
            raise ValueError(f"cache {name}: shape {a.shape} is not "
                             f"{tuple(want[name].shape)}")
        out[name] = _tensor(a, device)
    if "ssm_S" in out:
        out["ssm_S"] = out["ssm_S"].to(ssm_state_dtype(cfg))
    if "pos" in out and out["pos"].dtype != torch.int32:
        raise TypeError(f"cache pos is {out['pos'].dtype}, not int32")
    out["next"] = int(np.asarray(cache["next"]))
    return out
