"""The port's gradient processing pipeline against the JAX package's.

1. ``TrainConfig``'s three pipeline fields: names, types and defaults.
2. Window planning (``effective_windows``, ``split_windows``,
   ``window_chunks``, ``chunk_ready_schedule``) and the flat store
   (``FlatParamStore.from_tree``/``to_tree``/``grad_from_tree``/
   ``window_flats``) over hypothesis-drawn plans, bitwise against
   ``repro.core.chunking`` / ``repro.core.pipeline``; ``to_tree``'s leaves
   are views of the store.
3. The rules' plain versions with a row stride: a stacked ``g`` that is a
   strip of a wider buffer, read in place, equals the contiguous copy
   bitwise, and the ``p_out`` form (p' into a given buffer, slots in place)
   equals the out-of-place one.
4. The stacked windowed and chunk-ready exchanges (plain versions, CPU)
   equal the monolithic ``exchange_group`` bitwise, under Nesterov, SGD and
   Adam, with and without a device divisor; and the pipeline's gates.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

hyp = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core import chunking as jchunk  # noqa: E402
from repro.core.pipeline import (  # noqa: E402
    effective_windows as jax_effective_windows)
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.core import StackedComm, chunking, pipeline  # noqa: E402
from repro_torch.core.exchange import exchange_group  # noqa: E402
from repro_torch.core.wire import make_wire_format  # noqa: E402
from repro_torch.kernels.agg_opt import (fused_adam_opt,  # noqa: E402
                                         fused_multi_agg_opt, fused_sgd_opt)
from repro_torch.optim.protocol import make_sharded_optimizer  # noqa: E402

PIPELINE_FIELDS = ("pipeline_windows", "overlap_backward", "flat_residency")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run many small steps, and with the
    default (one thread a core) next to other test processes the threads'
    barriers spin against each other, 50x slower; the results do not
    depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_train_config_pipeline_fields_match_reference():
    jf = {f.name: f for f in dataclasses.fields(JaxTrainConfig)}
    pf = {f.name: f for f in dataclasses.fields(TrainConfig)}
    for name in PIPELINE_FIELDS:
        assert (pf[name].type, pf[name].default) == \
            (jf[name].type, jf[name].default), name


def _tree_strategy():
    shapes = st.lists(st.tuples(st.integers(1, 5), st.integers(1, 17)),
                      min_size=1, max_size=6)
    dtypes = st.sampled_from(["float32", "bfloat16"])
    return st.tuples(shapes, st.lists(dtypes, min_size=1, max_size=6))


def _trees(spec, seed=0):
    """The same values as a jax tree and a torch tree (bf16 leaves rounded
    from the same f32 draws on both sides)."""
    shapes, dtypes = spec
    rng = np.random.default_rng(seed)
    jt, pt = {}, {}
    for i, s in enumerate(shapes):
        v = rng.standard_normal(s).astype(np.float32)
        dt = dtypes[i % len(dtypes)]
        jt[f"k{i}"] = jnp.asarray(v, dtype=dt)
        pt[f"k{i}"] = torch.from_numpy(v).to(getattr(torch, dt))
    return jt, pt


def _np(x) -> np.ndarray:
    """f32 numpy values of a jax array or a torch tensor (bf16 exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _plans(spec, n_shards, chunk_bytes, seed=0):
    jt, pt = _trees(spec, seed)
    jplan = jchunk.build_plan(jt, chunk_bytes=chunk_bytes, n_shards=n_shards)
    pplan = chunking.build_plan(pt, chunk_bytes=chunk_bytes,
                                n_shards=n_shards)
    assert [g.key for g in pplan.groups] == [str(g.dtype)
                                             for g in jplan.groups]
    return jt, pt, jplan, pplan


@settings(max_examples=40, deadline=None)
@given(_tree_strategy(), st.integers(1, 4), st.sampled_from([64, 256]),
       st.integers(1, 6))
def test_window_planning_matches_reference(spec, n_shards, chunk_bytes,
                                           requested):
    jt, pt, jplan, pplan = _plans(spec, n_shards, chunk_bytes)
    jflats = jchunk.flatten_groups(jplan, jt)
    pflats = chunking.flatten_groups(pplan, pt)
    for jg, pg in zip(jplan.groups, pplan.groups):
        assert pg.chunks_per_shard == jg.chunks_per_shard
        W = pipeline.effective_windows(pg, requested)
        assert W == jax_effective_windows(jg, requested)
        assert chunking.window_chunks(pg, W) == jchunk.window_chunks(jg, W)
        assert chunking.chunk_ready_schedule(pg, W) == \
            jchunk.chunk_ready_schedule(jg, W)
        got = chunking.split_windows(pflats[pg.key], pg, W)
        want = jchunk.split_windows(jflats[pg.key], jg, W)
        assert len(got) == len(want) == W
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), _np(b))
        # a window waits for exactly the leaves that meet its strips, the
        # earliest of which sets the reference's readiness
        offs = chunking.leaf_offsets(pg)
        for w, ix in enumerate(chunking.window_leaves(pg, W)):
            runs = pipeline.window_runs(pg, W, w)
            for i, (o, sz) in enumerate(zip(offs, pg.sizes)):
                meets = any(o < r.stop and o + sz > r.start for r in runs)
                assert (i in ix) == meets


def test_window_planning_rejects_non_tiling_windows():
    (g,) = chunking.build_plan({"w": torch.zeros(64)}, chunk_bytes=64,
                               n_shards=2).groups
    with pytest.raises(ValueError):
        chunking.window_chunks(g, g.chunks_per_shard + 1)
    with pytest.raises(ValueError):
        chunking.chunk_ready_schedule(g, g.shard_len + 1)
    with pytest.raises(ValueError):
        chunking.split_windows(torch.zeros(g.padded), g, g.shard_len + 1)


@settings(max_examples=25, deadline=None)
@given(_tree_strategy(), st.integers(1, 4), st.integers(1, 4),
       st.integers(0, 2**16))
def test_flat_store_matches_reference(spec, n_shards, requested, seed):
    jt, pt, jplan, pplan = _plans(spec, n_shards, 64, seed)
    jlayout = jchunk.build_store_layout(
        jplan, {p: None for g in jplan.groups for p in g.paths}, 1)
    layout = chunking.build_store_layout(pplan, {}, 1)
    assert layout.offsets == jlayout.offsets
    assert layout.store_shapes() == {
        k: tuple(v.shape) for k, v in jlayout.store_shapes().items()}

    store, jstore = layout.from_tree(pt), jlayout.from_tree(jt)
    for k, v in store.items():
        np.testing.assert_array_equal(_np(v), _np(jstore[k]))
    tree = layout.to_tree(store, pt)
    jtree = jlayout.to_tree(jstore, jt)
    for (path, leaf), (_, jleaf) in zip(chunking.leaf_paths(tree),
                                        chunking.leaf_paths(jtree)):
        np.testing.assert_array_equal(_np(leaf), _np(jleaf))
        # a view of the store, not a copy
        key = chunking.dtype_name(leaf.dtype)
        assert leaf.untyped_storage().data_ptr() == \
            store[key].untyped_storage().data_ptr()

    # gradients: the flat assembly and the per-window one
    jg, pg = _trees(spec, seed + 1)
    grad, jgrad = layout.grad_from_tree(pg), jlayout.grad_from_tree(jg)
    for k, v in grad.items():
        assert tuple(v.shape) == tuple(jgrad[k].shape)
        np.testing.assert_array_equal(_np(v), _np(jgrad[k]))
    rows = {g.key: torch.full((g.padded,), 7.0, dtype=g.dtype)
            for g in pplan.groups}
    into = layout.grad_from_tree(pg, out=rows)
    for k, v in into.items():
        assert v.data_ptr() == rows[k].data_ptr()
        np.testing.assert_array_equal(_np(v), _np(grad[k]))
    wins = {g.key: pipeline.effective_windows(g, requested)
            for g in pplan.groups}
    got = layout.window_flats(pg, wins)
    want = jlayout.window_flats(jg, wins)
    for k in wins:
        assert len(got[k]) == len(want[k]) == wins[k]
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(_np(a), _np(b))


def test_store_with_model_sharded_rows_raises():
    plan = chunking.build_plan({"w": torch.zeros(8, 8)}, chunk_bytes=64,
                               n_shards=1)
    for dims, mo in (({}, 2), ({"['w']": 0}, 1)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            chunking.build_store_layout(plan, dims, mo)


# ---------------------------------------------- the rules with a row stride

def _draw(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _rule_call(rule, p, g, slots, **kw):
    """(p', slots') of one rule's wrapper; Adam's slots are copied first,
    since it updates them in place."""
    if rule == "nesterov":
        p2, m2 = fused_multi_agg_opt(p, g, slots[0], lr=0.05, momentum=0.9,
                                     **kw)
        return p2, (m2,)
    if rule == "sgd":
        return fused_sgd_opt(p, g, lr=0.05, **kw), ()
    m, v, k1, k2 = slots
    p2, *s2 = fused_adam_opt(p, g, m, v, k1, k2, lr=1e-3, eps=1e-3, **kw)
    return p2, tuple(s2)


def _slots(rule, rng, n, dtype):
    if rule == "nesterov":
        return (_draw(rng, n, dtype),)
    if rule == "sgd":
        return ()
    k = torch.from_numpy(rng.uniform(0, 0.5, n).astype(np.float32))
    return (_draw(rng, n, dtype), _draw(rng, n, dtype).abs(), k,
            k * 0.01)


@pytest.mark.parametrize("rule", ["nesterov", "sgd", "adam"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W, n, lo", [(1, 1024, 512), (3, 3000, 1024),
                                      (4, 1283, 4096)])
def test_plain_rules_take_a_row_stride(rule, dtype, W, n, lo):
    """g[:, lo:lo+n] of a (W, N) buffer, read in place (rows N apart),
    equals the contiguous copy bitwise, with and without a divisor; the
    p_out form writes p' there and updates the slots in place."""
    rng = np.random.default_rng(W + n)
    buf = _draw(rng, (W, lo + n + 333), dtype)
    g = buf[:, lo:lo + n]
    assert g.stride(0) == buf.shape[1] and (W == 1 or not g.is_contiguous())
    p = _draw(rng, n, dtype)
    slots = _slots(rule, rng, n, dtype)
    for divisor in (None, torch.tensor([W - 0.5])):
        kw = {} if divisor is None else {"divisor": divisor}
        want = _rule_call(rule, p, g.contiguous(),
                          tuple(s.clone() for s in slots), **kw)
        got = _rule_call(rule, p, g, tuple(s.clone() for s in slots), **kw)
        inplace = tuple(s.clone() for s in slots)
        p_out = torch.empty_like(p)
        got_out = _rule_call(rule, p, g, inplace, p_out=p_out, **kw)
        for a in (got, got_out):
            assert torch.equal(a[0], want[0])
            assert all(torch.equal(x, y) for x, y in zip(a[1], want[1]))
        assert got_out[0] is p_out
        assert all(x is y for x, y in zip(got_out[1], inplace))
        assert all(torch.equal(x, y) for x, y in zip(inplace, want[1]))


def test_rules_refuse_overlapping_rows():
    p, m = torch.zeros(64), torch.zeros(64)
    g = torch.zeros(200).as_strided((3, 64), (32, 1))
    with pytest.raises(ValueError, match="overlap"):
        fused_multi_agg_opt(p, g, m, lr=0.1, momentum=0.9)


# ------------------------------------------------ the stacked exchanges

def _group(S, chunk_bytes=64):
    """One f32 group of four leaves (1530 elements) at S shards, in chunks
    of 16: 96 chunks at S=1, 24 a shard at S=4, so 2, 3, 4 and 6 windows
    all take effect."""
    tree = {"a": torch.zeros(5, 37), "b": torch.zeros(600), "c":
            torch.zeros(3, 241), "d": torch.zeros(22)}
    (g,) = chunking.build_plan(tree, chunk_bytes=chunk_bytes,
                               n_shards=S).groups
    return g


@pytest.mark.parametrize("rule", ["nesterov", "sgd", "adam"])
@pytest.mark.parametrize("S, windows", [(1, 4), (4, 3), (4, 6)])
@pytest.mark.parametrize("live", [None, 3.0])
def test_windowed_and_chunk_ready_exchanges_equal_monolithic(rule, S,
                                                             windows, live):
    g = _group(S)
    assert pipeline.effective_windows(g, windows) == windows
    rng = np.random.default_rng(S * windows)
    grads = _draw(rng, (S, g.padded), torch.float32)
    p = _draw(rng, g.padded, torch.float32)
    slots0 = _slots(rule, rng, g.padded, torch.float32)
    comm = StackedComm(S)
    tc = TrainConfig(optimizer=rule, lr=1e-3, adam_eps=1e-3)
    sopt = make_sharded_optimizer(tc)
    upd = sopt.kernel_update(g.chunk_elems, sopt.coefs(tc))
    n_live = None if S == 1 or live is None else torch.tensor(live)

    mono = exchange_group(comm, grads, p, tuple(s.clone() for s in slots0),
                          upd, n_live)
    runs = {"windowed": pipeline.run_exchange(
        "sharded_ps", comm, grads, p, tuple(s.clone() for s in slots0), upd,
        g, windows, n_live)}
    # chunk-ready: the leaves arrive in reverse concat order, as a
    # backward produces them; each window launches once its leaves are in
    ex = pipeline.run_chunk_ready_exchange(
        "sharded_ps", comm, grads, p, tuple(s.clone() for s in slots0), upd,
        g, windows, n_live)
    for i in reversed(range(len(g.paths))):
        ex.leaf_ready(i)
    assert sorted(ex.order) == list(range(windows))
    runs["chunk-ready"] = ex.finish()
    for name, (p2, s2) in runs.items():
        assert torch.equal(p2, mono[0]), name
        assert all(torch.equal(a, b) for a, b in zip(s2, mono[1])), name


def test_chunk_ready_waits_for_every_leaf_of_a_window():
    g = _group(4)
    comm, W = StackedComm(4), 4
    grads, p = torch.zeros(4, g.padded), torch.zeros(g.padded)
    launched = []

    def upd(p, g_, slots, divisor=None, p_out=None, at=None):
        launched.append(p.storage_offset())
        return p_out, slots

    ex = pipeline.ChunkReadyExchange(comm, grads, p, (), upd, g, W)
    need = chunking.window_leaves(g, W)
    for i in range(len(g.paths) - 1):
        ex.leaf_ready(i)
    # every window needs some leaf; the last leaf is still missing
    assert sorted(ex.order) == [w for w in range(W)
                                if len(g.paths) - 1 not in need[w]]
    with pytest.raises(RuntimeError, match="never became ready"):
        ex.finish()
    ex.leaf_ready(len(g.paths) - 1)
    ex.finish()
    assert sorted(ex.order) == list(range(W))
    assert len(launched) == W * comm.n_workers


def test_pipeline_gates_raise_where_the_reference_raises():
    """The strategy gates raise as the reference's do; every wire runs in
    windows and with chunk-ready dispatch (the encoded wire's windowed
    schedule, ``pipelined_wire_exchange``), but only on a strategy with a
    shard dimension."""
    for kw in (dict(strategy="allreduce", overlap_backward=True),
               dict(strategy="centralized_ps", pipeline_windows=4),
               dict(strategy="fsdp_stream", flat_residency=True)):
        with pytest.raises(ValueError):
            pipeline.check_pipeline(TrainConfig(**kw))
    for kw in (dict(pipeline_windows=2), dict(overlap_backward=True),
               dict(flat_residency=True)):
        pipeline.check_pipeline(TrainConfig(wire_format="int8", **kw))
    with pytest.raises(ValueError, match="shard dimension"):
        pipeline.run_chunk_ready_exchange(
            "allreduce", StackedComm(1), None, None, (), None, _group(1), 2)
    int8 = make_wire_format(TrainConfig(wire_format="int8"))
    with pytest.raises(ValueError, match="shard dimension"):
        pipeline.run_chunk_ready_exchange(
            "allreduce", StackedComm(1), None, None, (), None, _group(1), 2,
            wire=int8)
    with pytest.raises(ValueError, match="identity"):
        pipeline.run_chunk_ready_exchange(
            "sharded_ps", StackedComm(1), None, None, (), None, _group(1), 2,
            wire=make_wire_format(TrainConfig()))
