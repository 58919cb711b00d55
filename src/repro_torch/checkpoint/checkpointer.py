"""Durable, verified checkpoints (``repro/checkpoint/checkpointer.py``).

The on-disk format is the reference's: ``<dir>/step_<N>/arrays.npz`` plus
``manifest.json`` (sorted keys, per-array CRC32, shapes, dtypes, and the
rack membership's epoch and world when one is given), written in two
phases — a hidden tmp directory, every file fsync'd, then one atomic
rename — and pruned to the newest ``keep_k``.  Array keys are tree paths
joined by ``/`` (``params/blocks/wq``, ``opt/float32/m``).  A snapshot
written here passes the reference's ``verify_checkpoint``, and one the
reference wrote loads here.

Tensors are pulled to the host (``.cpu()``); a bf16 array is stored as
its 16-bit pattern (uint16) with ``"bfloat16"`` in the manifest's dtypes,
so neither side needs numpy's bf16 extension (a reference snapshot's bf16
arrays load as 2-byte void and are read the same way).
``load_checkpoint`` returns CPU tensors.

``restore_train_state`` restores a tree-resident state in place: the
snapshot's parameters are copied into the model (``copy_``) and the
optimizer slots are rebuilt on the engine's device in the engine's
``(S, state_len)`` layout, whatever the reference's layout of the same
elements was.  As in the reference, an encoded-wire snapshot restores
into an identity-wire engine by dropping ``wire_ef`` and a pre-wire one
into an encoded-wire engine with a zero ``wire_ef``.  Restoring at
another world size (the rebalance plan) and converting between tree and
flat residency are ROADMAP.md queue A item 11.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib

import numpy as np
import torch

from ..core.chunking import leaf_paths
from ..core.wire import WIRE_EF_SLOT
from ..models import DecoderLM, param_specs

BF16 = "bfloat16"


class CheckpointError(RuntimeError):
    """Base class for checkpoint read/write failures."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint on disk is truncated, bit-flipped, or half-written.

    Raised *by name* from every load path — a partial write must never
    surface as a raw zipfile/unpickle/shape traceback — so callers
    (``restore_latest_valid``, the resilience supervisor) can skip to the
    previous good snapshot instead of dying on an opaque exception.
    """


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"#\d+", k) for k in node):
            return tuple(fix(node[f"#{i}"]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}
    return fix(tree)


def _to_numpy(v) -> tuple[np.ndarray, str]:
    """(array as stored, manifest dtype name) of a tensor or array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), BF16
        return v.numpy(), str(v.numpy().dtype)
    a = np.asarray(v)
    if a.dtype.name == BF16:                      # numpy's bf16 extension
        return a.view(np.uint16), BF16
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype_name: str | None) -> torch.Tensor:
    if dtype_name == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _array_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, tree, membership=None, *,
                    keep_k: int | None = None) -> str:
    """Durable two-phase write of ``tree`` (nested dicts of tensors or
    arrays): arrays + manifest land in a hidden tmp directory (whose name
    never matches the ``step_*`` pattern, so a crash mid-write is
    invisible to ``latest_step``), every file is fsync'd, and only then is
    the tmp dir atomically renamed into place — a checkpoint either exists
    completely or not at all.  The manifest carries a per-array CRC32 so
    a later truncation or bit-flip is detected by ``verify_checkpoint`` /
    ``load_checkpoint`` instead of surfacing as silently wrong weights.

    ``membership``: the rack's Membership at save time; its (epoch, world)
    is recorded so a restore can tell membership drift from a resize.
    ``keep_k``: after a successful commit, prune to the newest ``keep_k``
    snapshots (None keeps everything)."""
    final = _step_dir(directory, step)
    tmp = os.path.join(directory, f".tmp-step_{step:08d}-{os.getpid()}")
    os.makedirs(directory, exist_ok=True)
    if os.path.isdir(tmp):                       # stale tmp from a crash
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        arrays[k], dtypes[k] = _to_numpy(v)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    _fsync_path(os.path.join(tmp, "arrays.npz"))
    manifest = {"step": step, "keys": sorted(arrays),
                "checksums": {k: _array_crc(v) for k, v in arrays.items()},
                "shapes": {k: list(v.shape) for k, v in arrays.items()},
                "dtypes": dtypes}
    if membership is not None:
        manifest["membership"] = {"epoch": membership.epoch,
                                  "world": membership.world}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.isdir(final):                     # re-save of the same step
        trash = final + ".stale"
        if os.path.isdir(trash):
            shutil.rmtree(trash)
        os.rename(final, trash)
        os.rename(tmp, final)
        shutil.rmtree(trash)
    else:
        os.rename(tmp, final)                    # the commit point
    _fsync_path(directory)
    if keep_k is not None:
        prune_checkpoints(directory, keep_k)
    return final


def checkpoint_steps(directory: str) -> list[int]:
    """All committed snapshot steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def prune_checkpoints(directory: str, keep_k: int) -> list[int]:
    """Delete all but the newest ``keep_k`` snapshots; returns the steps
    removed."""
    if keep_k < 1:
        raise ValueError(f"keep_k must be >= 1, got {keep_k}")
    victims = checkpoint_steps(directory)[:-keep_k]
    for s in victims:
        shutil.rmtree(_step_dir(directory, s))
    return victims


def latest_step(directory: str) -> int | None:
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None


def _resolve(directory: str, step: int | None) -> int:
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return step


def verify_checkpoint(directory: str, step: int | None = None) -> dict:
    """Validate one snapshot end to end: manifest present and parseable,
    archive readable, every manifest key present with the recorded shape,
    and — when the manifest carries checksums (every durable write does)
    — a per-array CRC32 match.  Returns the manifest on success; raises
    ``CheckpointCorruptError`` naming the first failure otherwise."""
    step = _resolve(directory, step)
    path = _step_dir(directory, step)
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        raise CheckpointCorruptError(
            f"checkpoint step_{step:08d}: manifest.json missing "
            f"(half-written snapshot?)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError(
            f"checkpoint step_{step:08d}: manifest.json unreadable: "
            f"{e}") from e
    checksums = manifest.get("checksums", {})
    shapes = manifest.get("shapes", {})
    try:
        with np.load(os.path.join(path, "arrays.npz")) as data:
            files = set(data.files)
            for key in manifest.get("keys", sorted(files)):
                if key not in files:
                    raise CheckpointCorruptError(
                        f"checkpoint step_{step:08d}: array {key!r} listed "
                        f"in manifest but missing from archive (truncated "
                        f"write)")
                arr = data[key]                  # decompress => CRC-checked
                if key in shapes and list(arr.shape) != shapes[key]:
                    raise CheckpointCorruptError(
                        f"checkpoint step_{step:08d}: array {key!r} shape "
                        f"{list(arr.shape)} != manifest {shapes[key]}")
                if key in checksums and _array_crc(arr) != checksums[key]:
                    raise CheckpointCorruptError(
                        f"checkpoint step_{step:08d}: array {key!r} fails "
                        f"CRC32 (bit-flip or partial write)")
    except CheckpointCorruptError:
        raise
    except Exception as e:   # BadZipFile, zlib.error, EOFError, OSError...
        raise CheckpointCorruptError(
            f"checkpoint step_{step:08d}: arrays.npz unreadable "
            f"({type(e).__name__}: {e}) — truncated or corrupt "
            f"archive") from e
    return manifest


def load_manifest(directory: str, step: int | None = None) -> dict:
    path = os.path.join(_step_dir(directory, _resolve(directory, step)),
                        "manifest.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_checkpoint(directory: str, step: int | None = None, *,
                    verify: bool = True):
    """Load one snapshot as (step, tree of CPU tensors); with ``verify``
    (default) the read is gated on ``verify_checkpoint``, so a truncated
    archive or a bit-flipped array raises ``CheckpointCorruptError`` by
    name."""
    step = _resolve(directory, step)
    manifest = (verify_checkpoint(directory, step) if verify
                else load_manifest(directory, step))
    dtypes = manifest.get("dtypes", {})
    try:
        with np.load(os.path.join(_step_dir(directory, step),
                                  "arrays.npz")) as data:
            flat = {k: _to_tensor(data[k], dtypes.get(k)) for k in data.files}
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint step_{step:08d}: arrays.npz unreadable "
            f"({type(e).__name__}: {e})") from e
    return step, _unflatten(flat)


def _check_membership(manifest: dict, membership) -> None:
    rec = manifest.get("membership")
    if membership is None or rec is None:
        return
    if rec["world"] == membership.world and rec["epoch"] != membership.epoch:
        raise ValueError(
            f"checkpoint membership epoch {rec['epoch']} != rack "
            f"membership epoch {membership.epoch} at world "
            f"{membership.world}: the worker set churned between save and "
            f"restore; rejoin the rack to the saved membership or restore "
            f"with an explicit override (membership=None)")


def _params_from(engine, params) -> dict:
    """{path: tensor} of the snapshot's parameters, checked against the
    engine's model (paths, shapes, dtypes)."""
    want = dict(leaf_paths(param_specs(engine.cfg)))
    got = dict(leaf_paths(params))
    if set(want) != set(got):
        raise ValueError(f"checkpoint parameters differ from the model's: "
                         f"missing {sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    for path, spec in want.items():
        t = got[path]
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
            raise ValueError(f"checkpoint parameter {path}: {t.dtype} "
                             f"{tuple(t.shape)}, the model's {spec.dtype} "
                             f"{tuple(spec.shape)}")
    return got


def _opt_from(engine, opt: dict, step: int) -> dict:
    """The engine's optimizer state {dtype: {slot: (S, state_len)}} on its
    device, from the snapshot's slots, element for element."""
    flat = _flatten(opt)
    comm, st = engine.comm, engine.tc.strategy
    S = comm.n_shards(st)
    out, consumed = {}, set()
    for g in engine.chunk_plan.groups:
        shape = (S, comm.state_len(st, g.padded))
        slots = {}
        for spec in engine.exchange_slots:
            path = f"{g.key}/{spec.name}"
            dtype = spec.resolve_dtype(g.dtype)
            if path not in flat:
                if spec.name != WIRE_EF_SLOT:
                    raise ValueError(
                        f"checkpoint step_{step} has no opt slot {path!r}; "
                        f"it was written by another optimizer than the "
                        f"engine's ({engine.tc.optimizer!r}: slots "
                        f"{list(engine.sopt.slot_names)})")
                # a pre-wire (or identity-wire) snapshot: the residual is
                # accumulated rounding, and a fresh run starts it at zero
                slots[spec.name] = torch.zeros(shape, dtype=dtype,
                                               device=engine.device)
                continue
            t = flat[path]
            consumed.add(path)
            if t.dtype != dtype or t.numel() != shape[0] * shape[1]:
                raise ValueError(
                    f"opt slot {path!r}: {t.dtype} {tuple(t.shape)}, the "
                    f"engine's {dtype} {shape}; restoring at another world "
                    f"size is ROADMAP.md queue A item 11")
            slots[spec.name] = t.reshape(shape).to(engine.device)
        out[g.key] = slots
    # an encoded-wire snapshot into an identity-wire engine: wire_ef holds
    # one step's untransmitted delta tail and is dropped by design
    extra = {p for p in set(flat) - consumed
             if not p.endswith("/" + WIRE_EF_SLOT)}
    if extra:
        raise ValueError(
            f"checkpoint step_{step} carries opt slots {sorted(extra)} the "
            f"engine's optimizer ({engine.tc.optimizer!r}: slots "
            f"{list(engine.sopt.slot_names)}) does not declare; restoring "
            f"would silently drop optimizer state")
    return out


def _to_device(tree: dict, device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def restore_train_state(directory: str, engine, step: int | None = None,
                        membership=None, model: DecoderLM | None = None):
    """Load a {"params", "opt"} snapshot for ``engine`` (tree residency).
    The parameters are copied into ``model`` in place, or into a new
    ``DecoderLM`` on the engine's device when ``model`` is None; the
    optimizer slots are rebuilt on the engine's device.  Everything is
    checked before anything is written.  ``membership``: the restoring
    rack's Membership; a snapshot that records the same world at another
    epoch fails fast (the worker set churned between save and restore).
    With ``engine=None`` the verified tensors come back as saved.
    Returns (step, model, opt)."""
    _check_membership(load_manifest(directory, step), membership)
    step, tree = load_checkpoint(directory, step)
    params, opt = tree["params"], tree.get("opt", {})
    if engine is None:
        return step, params, opt
    loaded = _params_from(engine, params)
    new_opt = _opt_from(engine, opt, step)
    if model is None:
        model = DecoderLM(engine.cfg, device=engine.device,
                          params=_to_device(params, engine.device))
    else:
        with torch.no_grad():
            for path, leaf in leaf_paths(model.param_tree()):
                leaf.copy_(loaded[path])
    return step, model, new_opt


def restore_latest_valid(directory: str, engine, membership=None,
                         model: DecoderLM | None = None):
    """Walk snapshots newest-first and restore the first one that passes
    verification — the recovery entry point after a crash or a detected
    corruption.  Corrupt or partial snapshots (``CheckpointCorruptError``)
    are skipped; other failures (membership drift, a slot mismatch)
    propagate, because an older snapshot would fail the same way.
    Returns (step, model, opt, skipped), ``skipped`` the corrupt steps
    passed over; raises ``CheckpointError`` when none is valid."""
    steps = checkpoint_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    skipped = []
    for s in reversed(steps):
        try:
            step, model, opt = restore_train_state(
                directory, engine, step=s, membership=membership,
                model=model)
            return step, model, opt, skipped
        except CheckpointCorruptError:
            skipped.append(s)
    raise CheckpointError(
        f"no valid checkpoint under {directory}: all of "
        f"{[f'step_{s:08d}' for s in reversed(steps)]} failed "
        f"verification")
