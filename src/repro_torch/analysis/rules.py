"""The rack lint's gate on a tuned exchange config: rules R1, R3 and R5
(``repro/analysis/rules.py``) and ``lint_tuned_config``
(``repro/launch/lint.py``).

The reference compiles a candidate's zero-compute step and parses its
HLO.  The port builds no program: it runs one
``PHubEngine.make_zero_compute_step()`` under the candidate's config on
the caller's device and records what the step did (``StepArtifact``),
then checks what each rule checks:

  R1 traffic   the bytes the stacked exchange hands across worker rows,
               by collective kind and tier (``StackedComm.traffic``,
               recorded hop by hop as worker 0 receives them), against
               ``cost_model.predicted_exchange_traffic``'s
               ``runtime_by_kind`` within ``rel_tol`` (+ ``abs_tol``).
               On an encoded tier each record is the payload an
               executed hop, gather or pull encoded, so R1 checks the
               codec's sizes and the hop count the schedule ran (one
               hop too many, or a window skipped, is flagged).  On an
               identity tier the stacked pass runs no hops: the records
               are the strips the executed windows' passes read from the
               other workers' rows, cut as a ring's hops, so there R1
               checks the chunk plan's padded sizes and that every
               window ran, not a link;
  R3 in place  every parameter, store tensor and slot keeps its
               ``data_ptr``, shape and dtype through the step (the
               reference: every donated buffer aliases an output); on the
               card, a warning when the step allocates more than
               ``bytes_slack`` of the registered bytes beyond one copy of
               them (the reference's alias-bytes warning);
  R5 hygiene   no f64 in the store, the slots or the wire payloads, and
               each encoded tier's payloads in its format's dtypes: int8
               codes with f32 scales (within the scale sidecar's bound),
               bf16, f16.

Rules never raise on a bad artifact: they return ``Diagnostic``s, and
``seeded_fixtures`` corrupts a clean artifact on purpose (bytes off by 5%,
one slot re-allocated, one f64 payload) so that each rule is shown to
fire.  R2, R4, the lint matrix and the CLI are ROADMAP.md queue A item 10.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..core import cost_model

SEVERITIES = ("error", "warning", "info")
RULES = ("R1", "R3", "R5")
# the dtypes each encoded wire's payloads may carry (int8: the codes and
# the per-chunk f32 scales)
WIRE_DTYPES = {"int8": ("int8", "float32"), "bf16": ("bfloat16",),
               "f16": ("float16",)}


@dataclass
class Diagnostic:
    """One finding (the reference's): rule id, severity, the config it
    fired on, a message and machine-readable evidence."""
    rule: str
    severity: str
    config: str
    message: str
    evidence: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"expected one of {SEVERITIES}")

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "config": self.config, "message": self.message,
                "evidence": self.evidence}


@dataclass
class StepArtifact:
    """What one zero-compute step did: its exchange config and chunk
    groups, the traffic recorded by the Comm ({kind: {tier: {dtype:
    bytes}}}, one worker's link bytes), every parameter and slot as
    (name, data_ptr, shape, dtype) before and after the step, and on the
    card the bytes it allocated above what was allocated before it."""
    tag: str
    strategy: str
    wire: object                 # core/wire.py WireFormat
    wire_dcn: Optional[object]
    windows: int
    n_workers: int
    pod_size: int
    groups: tuple
    traffic: dict
    before: list
    after: list
    registered_bytes: int
    extra_bytes: Optional[int] = None
    config: dict = field(default_factory=dict)

    @property
    def wire_name(self) -> str:
        return getattr(self.wire, "name", "identity")

    @property
    def wire_dcn_name(self) -> str:
        return getattr(self.wire_dcn, "name", "identity")


def _rows(model, opt: dict) -> list:
    """(name, data_ptr, shape, dtype name) of every parameter and slot."""
    from ..core.chunking import leaf_paths
    out = [(f"param{path}", t.data_ptr(), tuple(t.shape),
            str(t.dtype).replace("torch.", ""))
           for path, t in leaf_paths(model.param_tree())]
    out += [(f"slot{path}", t.data_ptr(), tuple(t.shape),
             str(t.dtype).replace("torch.", ""))
            for path, t in leaf_paths(opt)]
    return out


def artifact_from_engine(engine, tag: str, model=None, opt=None
                         ) -> StepArtifact:
    """Run one zero-compute step of ``engine`` (on a fresh state unless
    ``model`` and ``opt`` are given) and record it.  The Comm's traffic
    is reset first; on the card the device is synchronized around the
    step and its peak allocation read."""
    if model is None:
        model, opt = engine.init_state()
    comm, dev = engine.comm, engine.device
    step = engine.make_zero_compute_step()
    comm.reset_stats()
    before = _rows(model, opt)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    model, opt = step(model, opt)
    extra = None
    if cuda:
        torch.cuda.synchronize(dev)
        extra = torch.cuda.max_memory_allocated(dev) - base
    after = _rows(model, opt)
    tc = engine.tc
    client = engine.client
    return StepArtifact(
        tag=tag, strategy=tc.strategy, wire=client.wire,
        wire_dcn=client.wire_dcn, windows=tc.pipeline_windows,
        n_workers=comm.n_workers, pod_size=comm.pods,
        groups=tuple(engine.chunk_plan.groups),
        traffic=copy.deepcopy(comm.traffic), before=before, after=after,
        registered_bytes=client.registered_bytes(), extra_bytes=extra,
        config={"strategy": tc.strategy,
                "pipeline_windows": tc.pipeline_windows,
                "wire_format": tc.wire_format,
                "wire_format_dcn": tc.wire_format_dcn,
                "chunk_size_bytes": tc.chunk_size_bytes,
                "pods": comm.pods, "data": comm.pod_size,
                "device": str(dev), "registered_bytes":
                client.registered_bytes(), "extra_bytes": extra,
                "traffic": copy.deepcopy(comm.traffic)})


def _link(traffic: dict, kind: str, tier: str) -> float:
    return sum(traffic.get(kind, {}).get(tier, {}).values())


# ------------------------------------------------------------------- R1

def check_traffic(artifact: StepArtifact, *, rel_tol: float = 0.02,
                  abs_tol: float = 4096.0) -> list:
    """R1: per (kind, tier), the recorded link bytes of one worker must
    match ``predicted_exchange_traffic``'s runtime bytes within
    ``rel_tol`` (+ ``abs_tol``, the reference's slack for scalars the model
    ignores); traffic the model does not predict is an error."""
    try:
        pred = cost_model.predicted_exchange_traffic(
            artifact.groups, strategy=artifact.strategy,
            wire=artifact.wire, windows=artifact.windows,
            n_workers=artifact.n_workers, pod_size=artifact.pod_size,
            wire_dcn=artifact.wire_dcn)["runtime_by_kind"]
    except ValueError as e:
        return [Diagnostic("R1", "info", artifact.tag,
                           f"traffic model does not cover this cell: {e}")]
    diags = []
    for kind in sorted(set(pred) | set(artifact.traffic)):
        for tier in ("ici", "dcn"):
            want = pred.get(kind, {}).get(tier, 0.0)
            got = _link(artifact.traffic, kind, tier)
            if want == 0.0:
                if got > abs_tol:
                    diags.append(Diagnostic(
                        "R1", "error", artifact.tag,
                        f"unmodeled {kind} traffic on {tier}: {got:.0f} "
                        f"link bytes (model predicts none)",
                        {"kind": kind, "tier": tier, "recorded_bytes": got}))
                continue
            if abs(got - want) > rel_tol * want + abs_tol:
                diags.append(Diagnostic(
                    "R1", "error", artifact.tag,
                    f"{kind} on {tier}: recorded {got:.0f} link bytes vs "
                    f"predicted {want:.0f} ({(got - want) / want:+.1%})",
                    {"kind": kind, "tier": tier, "recorded_bytes": got,
                     "predicted_bytes": want}))
    return diags


# ------------------------------------------------------------------- R3

def check_in_place(artifact: StepArtifact, *,
                   bytes_slack: float = 0.25) -> list:
    """R3: every parameter, store tensor and slot after the step is the
    buffer it was before (``data_ptr``), with its shape and dtype; a
    missing or new entry is an error too.  On the card, a warning when
    the step's allocation exceeds the registered bytes by more than
    ``bytes_slack`` of them."""
    diags = []
    before = {r[0]: r[1:] for r in artifact.before}
    after = {r[0]: r[1:] for r in artifact.after}
    moved = [n for n in before if n in after and after[n] != before[n]]
    lost = sorted(set(before) - set(after))
    new = sorted(set(after) - set(before))
    if moved or lost or new:
        diags.append(Diagnostic(
            "R3", "error", artifact.tag,
            f"{len(moved)} of {len(before)} state tensors re-allocated or "
            f"reshaped by the step ({moved[:4]}"
            f"{'...' if len(moved) > 4 else ''}), {len(lost)} dropped, "
            f"{len(new)} new: the step does not keep its state in place",
            {"moved": moved, "lost": lost, "new": new}))
    reg, extra = artifact.registered_bytes, artifact.extra_bytes
    if extra is not None and reg and extra - reg > bytes_slack * reg:
        diags.append(Diagnostic(
            "R3", "warning", artifact.tag,
            f"the step allocated {extra} bytes above what it started with, "
            f"{extra / reg:.2f}x the {reg} registered bytes (more than "
            f"{1 + bytes_slack:.2f}x)",
            {"extra_bytes": extra, "registered_bytes": reg}))
    return diags


# ------------------------------------------------------------------- R5

def check_hygiene(artifact: StepArtifact, *,
                  scale_slack: float = 2.0) -> list:
    """R5: no f64 in the state or on the wire; on an encoded tier the ring
    and gather payloads carry only its format's dtypes, an int8 tier's f32
    bytes no more than ``scale_slack`` times the scale sidecar of the
    domain (one f32 a chunk)."""
    diags = []
    f64 = [r[0] for r in artifact.after if r[3] == "float64"]
    if f64:
        diags.append(Diagnostic(
            "R5", "error", artifact.tag,
            f"{len(f64)} f64 state tensors (no f64 belongs in the f32 "
            f"exchange): {f64[:4]}", {"tensors": f64}))
    for kind, tiers in sorted(artifact.traffic.items()):
        for tier, by_dtype in sorted(tiers.items()):
            if by_dtype.get("float64", 0.0) > 0:
                diags.append(Diagnostic(
                    "R5", "error", artifact.tag,
                    f"{kind} on {tier} carries {by_dtype['float64']:.0f} "
                    f"bytes of f64", {"kind": kind, "tier": tier}))
    scale_bound = scale_slack * sum(
        (g.padded // g.chunk_elems) * 4 for g in artifact.groups)
    dcn = artifact.wire_dcn_name != "identity"
    for kind in ("collective-permute", "all-gather"):
        for tier, by_dtype in sorted(artifact.traffic.get(kind, {}).items()):
            name = (artifact.wire_dcn_name if tier == "dcn" and dcn
                    else artifact.wire_name)
            if name == "identity":
                continue                 # this tier rides the state dtype
            allowed = WIRE_DTYPES[name]
            wide = {dt: b for dt, b in by_dtype.items()
                    if b > 0 and (dt not in allowed or (
                        name == "int8" and dt == "float32"
                        and b > scale_bound))}
            if wide:
                diags.append(Diagnostic(
                    "R5", "error", artifact.tag,
                    f"{kind} on {tier} carries {wide} bytes outside the "
                    f"{name!r} wire's dtypes {allowed} (scale sidecar "
                    f"bound {scale_bound:.0f} B): raw chunks leaked past "
                    f"the encoder",
                    {"kind": kind, "tier": tier, "wide_bytes": wide,
                     "scale_bound": scale_bound}))
    return diags


def lint_artifact(artifact: StepArtifact) -> list:
    """R1, R3 and R5 on one artifact."""
    return (check_traffic(artifact) + check_in_place(artifact)
            + check_hygiene(artifact))


# -------------------------------------------------------------- fixtures

@dataclass
class Fixture:
    """A corrupted twin that ``rule`` must flag, beside its clean twin
    that must pass (the reference's fixtures)."""
    name: str
    rule: str
    bad: list
    clean: list

    @property
    def flagged(self) -> bool:
        return any(d.rule == self.rule and d.severity == "error"
                   for d in self.bad)

    @property
    def false_positive(self) -> bool:
        return any(d.severity == "error" for d in self.clean)

    @property
    def ok(self) -> bool:
        return self.flagged and not self.false_positive


def seeded_fixtures(artifact: StepArtifact) -> list:
    """The three seeded faults on a copy of a clean ``artifact`` each: R1
    every recorded byte 5% more, R3 one slot re-allocated, R5 one wire
    payload's bytes f64."""
    clean = lint_artifact(artifact)
    out = []

    bad = copy.deepcopy(artifact)
    for tiers in bad.traffic.values():
        for by_dtype in tiers.values():
            for dt in by_dtype:
                by_dtype[dt] *= 1.05
    out.append(Fixture("bytes_off_5pct", "R1", check_traffic(bad), clean))

    bad = copy.deepcopy(artifact)
    i = next(i for i, r in enumerate(bad.after) if r[0].startswith("slot"))
    name, ptr, shape, dt = bad.after[i]
    bad.after[i] = (name, ptr + 4096, shape, dt)
    out.append(Fixture("slot_reallocated", "R3", check_in_place(bad),
                       clean))

    bad = copy.deepcopy(artifact)
    for kind in ("collective-permute", "all-gather", "reduce-scatter",
                 "all-reduce"):
        tiers = {t: d for t, d in bad.traffic.get(kind, {}).items() if d}
        if tiers:
            by_dtype = next(iter(tiers.values()))
            dt = max(by_dtype, key=by_dtype.get)
            by_dtype["float64"] = by_dtype.pop(dt)
            break
    out.append(Fixture("f64_payload", "R5", check_hygiene(bad), clean))
    return out


# --------------------------------------------------- tuned-config gating

def lint_tuned_config(cand: dict, *, device="cuda",
                      tag: str = "tuned/candidate"):
    """Lint-gate one autotuner candidate: build its engine on its layout
    (``tuning.cost.context_for``) on ``device``, run and record one
    zero-compute step, and check R1, R3 and R5, the contract a cached
    winner must pass.  ``cand``: {strategy, pipeline_windows, wire_format,
    wire_format_dcn, chunk_size_bytes, pods, data[, arch, d_model]}; no
    arch lints the reduced llama3.2-1b, as the reference; ``d_model`` 0 or
    absent takes the arch at its full width.  Returns (verdict dict,
    diagnostics); the engine and its state are released before it
    returns."""
    from ..configs import TrainConfig, get_arch, reduced
    from ..core import PHubEngine
    from ..tuning.cost import context_for
    from ..tuning.space import Candidate

    c = Candidate.from_dict(cand)
    if cand.get("arch"):
        d_model = int(cand.get("d_model") or 0)
        cfg = get_arch(cand["arch"])
        if d_model:
            cfg = reduced(cfg, d_model=d_model)
    else:
        cfg = reduced(get_arch("llama3.2-1b"))
    engine = PHubEngine(cfg, TrainConfig(**c.tc_kwargs()),
                        context_for(c), device=device)
    art = artifact_from_engine(engine, tag)
    del engine
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    diags = lint_artifact(art)
    errors = [d.to_dict() for d in diags if d.severity == "error"]
    verdict = {"tag": tag, "candidate": dict(cand), "ok": not errors,
               "rules": list(RULES), "errors": errors,
               "warnings": [d.to_dict() for d in diags
                            if d.severity == "warning"],
               "config": art.config}
    return verdict, diags
