"""The port's sharding planner (``core/sharding.py``) against the JAX
package's (``repro/core/sharding.py``), leaf for leaf.

For every registered architecture, at its full and its reduced widths:
``plan_params`` under the ``replicated`` and ``fsdp`` layouts on a data
axis of 2 and of 4 (and a model axis of 1 and 2, which exercises the
column/row rules the port keeps for its plan), the spec entries, the
``model_dim`` and ``fsdp_dim`` of every leaf, ``specs()``, ``fsdp_dims()``
and ``local_shapes``.  The reference's shapes come from ``jax.eval_shape``
of its initializer, the port's from ``param_specs`` on the meta device;
nothing is allocated, and the comparison is exact.  The Pull hook
(``make_gather_fn``) is None for the replicated layout and the identity
for the fsdp one on the stacked Comm.
"""
import functools

import jax
import jax.numpy as jnp
import pytest

from repro.configs import ARCHS, reduced as jreduced
from repro.core import sharding as jsharding
from repro.models import init as jax_init
from repro_torch.configs import get_arch, reduced as preduced
from repro_torch.core import sharding
from repro_torch.core.chunking import leaf_paths
from repro_torch.models import param_specs

NAMES = sorted(ARCHS)
CASES = [(a, r) for a in NAMES for r in (False, True)]


@functools.lru_cache(maxsize=None)
def _shapes(arch: str, small: bool):
    jcfg, pcfg = ARCHS[arch], get_arch(arch)
    if small:
        jcfg, pcfg = jreduced(jcfg), preduced(pcfg)
    jshapes = jax.eval_shape(lambda k: jax_init(jcfg, k),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    return jshapes, param_specs(pcfg)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(kp): v for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,small", CASES,
                         ids=[f"{a}-{'reduced' if r else 'full'}"
                              for a, r in CASES])
def test_plan_matches_reference_leaf_for_leaf(arch, small):
    jshapes, pshapes = _shapes(arch, small)
    assert [p for p, _ in leaf_paths(pshapes)] == list(_flat(jshapes))
    split = 0
    for layout in sharding.LAYOUTS:
        for data in (2, 4):
            for mo in (1, 2):
                sizes = {"data": data, "model": mo}
                axes = ("data", "model")
                jplan = jsharding.plan_params(jshapes, mesh_axes=axes,
                                              axis_sizes=sizes,
                                              layout=layout)
                pplan = sharding.plan_params(pshapes, mesh_axes=axes,
                                             axis_sizes=sizes,
                                             layout=layout)
                assert list(pplan.leaves) == list(jplan.leaves)
                for path, jl in jplan.leaves.items():
                    pl = pplan.leaves[path]
                    assert pl.spec == tuple(jl.spec), (path, layout)
                    assert pl.model_dim == jl.model_dim, path
                    assert pl.fsdp_dim == jl.fsdp_dim, path
                    split += pl.fsdp_dim is not None
                assert dict(leaf_paths(pplan.specs())) == {
                    p: tuple(s) for p, s in _flat(jplan.specs()).items()}
                jdims = {jax.tree_util.keystr(kp): v for kp, v in
                         jax.tree_util.tree_flatten_with_path(
                             jplan.fsdp_dims(),
                             is_leaf=lambda x: x is None)[0]}
                assert dict(leaf_paths(pplan.fsdp_dims())) == jdims
                jlocal = _flat(jsharding.local_shapes(jshapes, jplan, sizes))
                plocal = dict(leaf_paths(sharding.local_shapes(
                    pshapes, pplan, sizes)))
                assert plocal == {p: tuple(s.shape)
                                  for p, s in jlocal.items()}
                assert pplan.data_axes == jplan.data_axes
    assert split > 0, "no leaf was split over data"


def test_gather_hook_is_none_replicated_and_identity_fsdp():
    _, pshapes = _shapes("llama3.2-1b", True)
    sizes = {"data": 4, "model": 1}
    rep = sharding.plan_params(pshapes, mesh_axes=("data", "model"),
                               axis_sizes=sizes)
    assert sharding.make_gather_fn(rep) is None
    fsdp = sharding.plan_params(pshapes, mesh_axes=("data", "model"),
                                axis_sizes=sizes, layout="fsdp")
    gather = sharding.make_gather_fn(fsdp)
    sub = pshapes["blocks"]
    assert gather("blocks", sub) is sub
    with pytest.raises(ValueError, match="layout"):
        sharding.plan_params(pshapes, mesh_axes=("data",), axis_sizes=sizes,
                             layout="zero3")
