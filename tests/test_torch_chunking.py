"""The port's chunk domain and worker substrate against the JAX package's,
on the reduced llama3.2-1b tree: identical plans, bitwise-equal flat
vectors, and an unflatten that round-trips."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core import chunking as jchunk
from repro.core.exchange import ExchangeContext
from repro.models import init as jax_init
from repro_torch.configs import get_arch, reduced as port_reduced
from repro_torch.core import chunking
from repro_torch.core.comm import StackedComm
from repro_torch.models import param_specs

CHUNK_BYTES = 32 * 1024


@pytest.fixture(scope="module")
def cfgs():
    return (reduced(ARCHS["llama3.2-1b"], d_model=128),
            port_reduced(get_arch("llama3.2-1b"), d_model=128))


@pytest.fixture(scope="module")
def jax_shapes(cfgs):
    return jax.eval_shape(lambda k: jax_init(cfgs[0], k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def test_reduced_config_matches_reference(cfgs):
    import dataclasses
    assert dataclasses.asdict(cfgs[0]) == dataclasses.asdict(cfgs[1])
    assert cfgs[0].n_params() == cfgs[1].n_params()


@pytest.mark.parametrize("S", [1, 2, 4])
def test_plan_matches_reference(cfgs, jax_shapes, S):
    ref = jchunk.build_plan(jax_shapes, chunk_bytes=CHUNK_BYTES, n_shards=S)
    got = chunking.build_plan(param_specs(cfgs[1]), chunk_bytes=CHUNK_BYTES,
                              n_shards=S)
    assert [str(g.dtype) for g in ref.groups] == [g.key for g in got.groups]
    for r, g in zip(ref.groups, got.groups):
        assert g.paths == r.paths
        assert g.shapes == r.shapes and g.sizes == r.sizes
        assert (g.total, g.padded, g.shard_len, g.chunk_elems, g.n_shards) \
            == (r.total, r.padded, r.shard_len, r.chunk_elems, r.n_shards)
        assert g.n_chunks == r.n_chunks
        assert chunking.chunk_spans(g.padded, g.chunk_elems) \
            == jchunk.chunk_spans(r.padded, r.chunk_elems)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_flatten_bitwise_and_unflatten_round_trips(cfgs, jax_shapes, S):
    rng = np.random.default_rng(S)
    np_tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), jax_shapes)
    ref_plan = jchunk.build_plan(jax_shapes, chunk_bytes=CHUNK_BYTES,
                                 n_shards=S)
    ref = jchunk.flatten_groups(ref_plan, jax.tree.map(jnp.asarray, np_tree))
    t_tree = jax.tree.map(torch.from_numpy, np_tree)
    plan = chunking.build_plan(t_tree, chunk_bytes=CHUNK_BYTES, n_shards=S)
    flats = chunking.flatten_groups(plan, t_tree)
    assert flats.keys() == ref.keys()
    for k in flats:
        np.testing.assert_array_equal(flats[k].numpy(), np.asarray(ref[k]))
        g = plan.groups[0]
        mat = chunking.shard_matrix(g, flats[k])
        np.testing.assert_array_equal(
            mat.numpy(), np.asarray(jchunk.shard_matrix(ref_plan.groups[0],
                                                        ref[k])))
    back = chunking.unflatten_groups(plan, flats, t_tree)
    for (pa, a), (pb, b) in zip(chunking.leaf_paths(back),
                                chunking.leaf_paths(t_tree)):
        assert pa == pb and torch.equal(a, b)
    # writing into a caller's buffer gives the same vector, pad tail zeroed
    out = {k: torch.full_like(v, 7.0) for k, v in flats.items()}
    chunking.flatten_leaves(plan, dict(chunking.leaf_paths(t_tree)), out=out)
    for k in flats:
        assert torch.equal(out[k], flats[k])


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("strategy", ["sharded_ps", "allreduce",
                                      "centralized_ps"])
def test_stacked_comm_matches_exchange_context(W, strategy):
    ctx = ExchangeContext(data_axes=("data",),
                          axis_sizes={"data": W, "model": 1})
    comm = StackedComm(W)
    padded = 8192 * 8
    assert comm.n_workers == ctx.n_workers
    assert comm.n_shards(strategy) == ctx.n_shards(strategy)
    assert comm.state_len(strategy, padded) == ctx.state_len(strategy, padded)


def test_stacked_comm_rejects_unported_strategies():
    """fsdp_stream has no chunk shard matrix: one row, as the reference's
    ExchangeContext gives it; an unknown strategy raises."""
    ctx = ExchangeContext(data_axes=("data",),
                          axis_sizes={"data": 4, "model": 1})
    assert StackedComm(4).n_shards("fsdp_stream") == \
        ctx.n_shards("fsdp_stream") == 1
    with pytest.raises(ValueError, match="unknown exchange strategy"):
        StackedComm(4).n_shards("ring_of_rings")
