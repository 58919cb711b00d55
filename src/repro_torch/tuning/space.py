"""Search space for the exchange autotuner (``repro/tuning/space.py``,
DESIGN.md §16).

A ``Candidate`` is one point in the (strategy x pipeline_windows x
wire_format x wire_format_dcn x chunk_size_bytes x mesh shape) product;
``enumerate_space`` walks the product over a fixed device count and keeps
only the points the exchange actually supports:

  * the mesh factors the device count exactly (pods x data, data >= 2);
  * ``hierarchical`` needs a pod axis, ``allreduce`` runs flat only, and
    ``sharded_ps`` takes either (its ring simply spans the pod boundary,
    which the cost model prices as DCN-tier hops);
  * encoded wires and windowed schedules exist only for the pipelined
    strategies (core/pipeline.PIPELINED_STRATEGIES);
  * a DCN-tier wire needs both the hierarchical strategy and an actual
    pod boundary to cross (configs/base.py).

On one card a candidate's (pods, data) is the layout of
``StackedComm(pods * data, pods)`` (``launch/mesh.py``): its workers are
rows of one tensor.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional

from ..core.pipeline import PIPELINED_STRATEGIES

STRATEGIES = ("allreduce", "sharded_ps", "hierarchical")
WIRES = ("identity", "bf16", "int8")
DCN_WIRES = (None, "int8")
CHUNK_KBS = (8, 32, 64)
WINDOWS = (1, 2, 4)


@dataclass(frozen=True)
class Candidate:
    strategy: str
    pipeline_windows: int
    wire_format: str
    wire_format_dcn: Optional[str]
    chunk_size_bytes: int
    pods: int
    data: int

    @property
    def n_workers(self) -> int:
        return self.pods * self.data

    def tc_kwargs(self) -> dict:
        """kwargs for TrainConfig / dataclasses.replace."""
        return dict(strategy=self.strategy,
                    pipeline_windows=self.pipeline_windows,
                    wire_format=self.wire_format,
                    wire_format_dcn=self.wire_format_dcn,
                    chunk_size_bytes=self.chunk_size_bytes)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        return cls(strategy=d["strategy"],
                   pipeline_windows=int(d["pipeline_windows"]),
                   wire_format=d.get("wire_format") or "identity",
                   wire_format_dcn=d.get("wire_format_dcn"),
                   chunk_size_bytes=int(d["chunk_size_bytes"]),
                   pods=int(d.get("pods", 1)), data=int(d["data"]))


def mesh_shapes(n_devices: int) -> list:
    """(pods, data) factorizations with at least 2 workers per pod."""
    return [(p, n_devices // p) for p in range(1, n_devices // 2 + 1)
            if n_devices % p == 0 and n_devices // p >= 2]


def valid(c: Candidate, n_devices: int) -> bool:
    if c.pods * c.data != n_devices or c.data < 2:
        return False
    if c.strategy == "hierarchical" and c.pods == 1:
        return False
    if c.strategy == "allreduce" and c.pods != 1:
        return False
    if c.strategy not in PIPELINED_STRATEGIES:
        if c.pipeline_windows != 1 or c.wire_format != "identity":
            return False
    if c.wire_format_dcn not in (None, "identity"):
        if c.strategy != "hierarchical" or c.pods == 1:
            return False
    return True


def enumerate_space(n_devices: int, *, strategies=STRATEGIES,
                    windows=WINDOWS, wires=WIRES, dcn_wires=DCN_WIRES,
                    chunk_kbs=CHUNK_KBS) -> list:
    """All valid candidates over the product, deterministic order."""
    out = []
    for pods, data in mesh_shapes(n_devices):
        for strategy in strategies:
            for w in windows:
                for wire in wires:
                    for dcn in dcn_wires:
                        for kb in chunk_kbs:
                            c = Candidate(
                                strategy=strategy, pipeline_windows=w,
                                wire_format=wire, wire_format_dcn=dcn,
                                chunk_size_bytes=kb * 1024,
                                pods=pods, data=data)
                            if valid(c, n_devices):
                                out.append(c)
    return out
