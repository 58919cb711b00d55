"""Worker layouts (``repro/launch/mesh.py``).

The reference names its workers by mesh axes (``pod``, ``data``,
``model``) over jax devices.  The port has no meshes: a layout is a
``Comm``, and on one card ``make_comm(pods, data)`` is
``StackedComm(pods * data, pods)``, the ``pods * data`` workers rows of
one tensor, pod-major as the reference's ``flat_rank`` over ``("pod",
"data")``.  The model axis (tensor parallelism) is ROADMAP.md queue A item
5b; a layout of one worker a process is ``core/comm.py::ProcessGroupComm``
(``launch/dist.py``).
"""
from __future__ import annotations

from ..core.comm import StackedComm


def make_comm(pods: int, data: int) -> StackedComm:
    """``pods`` pods of ``data`` workers stacked on one device (an
    autotuner candidate's (pods, data), the reference's ``(pod, data)``
    mesh)."""
    return StackedComm(pods * data, pods)
