"""The port's rebalance plans (``elastic/rebalance.py``) and their traffic
(``core/cost_model.py::rebalance_traffic``) against the JAX package's.

1. On plans built from the same specs (packed domains of 2-3 tenants at
   two shard counts, solo chunk plans of reduced llama3.2-1b, the solo
   resize plan, and compositions), the port's runs, ``moved_elems``,
   ``chunk_placements`` and sizes equal the reference's, exactly (Python
   ints on both sides); so does ``rebalance_traffic``.
2. ``RebalancePlan.apply`` on a torch tensor equals the reference's numpy
   ``apply`` bitwise, and moves each tenant's content to its new runs.
3. The reference's hypothesis properties (``tests/test_elastic_
   properties.py``) hold for the port: a chunk moves at most once, the
   moving runs cover exactly the chunks whose placement changed, and plans
   compose.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import chunking as jax_chunking
from repro.core import cost_model as jax_cost
from repro.elastic import rebalance as jax_rebalance
from repro.optim.protocol import SlotSpec as JaxSlotSpec
from repro_torch.configs import get_arch, reduced
from repro_torch.core import cost_model
from repro_torch.core.chunking import build_plan, leaf_paths, pack_domains
from repro_torch.elastic import (SOLO_TENANT, plan_rebalance,
                                 solo_resize_plan)
from repro_torch.models import param_specs
from repro_torch.optim.protocol import SlotSpec

CE = 256


def domains(counts, n_shards, ce=CE):
    """The same packed domain in both packages: tenant i holds counts[i]
    chunks of ``ce`` f32 elements."""
    port, ref = {}, {}
    for i, c in enumerate(counts):
        port[f"t{i}"] = build_plan({"w": torch.empty(c * ce, device="meta")},
                                   chunk_bytes=ce * 4, n_shards=n_shards)
        ref[f"t{i}"] = jax_chunking.build_plan(
            {"w": jax.ShapeDtypeStruct((c * ce,), jnp.float32)},
            chunk_bytes=ce * 4, n_shards=n_shards)
    return (pack_domains(port, n_shards=n_shards, chunk_bytes=ce * 4),
            jax_chunking.pack_domains(ref, n_shards=n_shards,
                                      chunk_bytes=ce * 4))


def solo_plans(d_model, n_shards, chunk=1024):
    """A reduced llama3.2-1b's chunk plan in both packages."""
    specs = param_specs(reduced(get_arch("llama3.2-1b"), d_model=d_model))
    tree: dict = {}
    for path, t in leaf_paths(specs):
        keys = [k.strip("'") for k in path[1:-1].split("][")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32)
    return (build_plan(specs, chunk_bytes=chunk, n_shards=n_shards),
            jax_chunking.build_plan(tree, chunk_bytes=chunk,
                                    n_shards=n_shards))


def same_plan(port, ref) -> None:
    assert set(port.groups) == set(ref.groups)
    for key, g in port.groups.items():
        r = ref.groups[key]
        assert (g.chunk_elems, g.old_padded, g.new_padded) == \
            (r.chunk_elems, r.old_padded, r.new_padded)
        assert g.dtype == getattr(torch, str(r.dtype))
        assert g.moves == r.moves
        assert g.moved_elems() == r.moved_elems()
        assert g.total_elems() == r.total_elems()
        for t in g.moves:
            assert g.delta(t) == r.delta(t)
        assert port.chunk_placements(key) == ref.chunk_placements(key)
    assert port.moved_elems() == ref.moved_elems()


SLOT_SETS = {
    "none": ((), ()),
    "nesterov+wire_ef": ((SlotSpec("m"), SlotSpec("wire_ef", "float32")),
                         (JaxSlotSpec("m"),
                          JaxSlotSpec("wire_ef", "float32"))),
    "adam": (tuple(SlotSpec(n) for n in ("m", "v")) + (
        SlotSpec("k1", "float32"), SlotSpec("k2", "float32")),
        tuple(JaxSlotSpec(n) for n in ("m", "v")) + (
        JaxSlotSpec("k1", "float32"), JaxSlotSpec("k2", "float32"))),
}


def same_traffic(port, ref) -> None:
    for name, (ps, rs) in SLOT_SETS.items():
        for mo in (1, 2):
            assert cost_model.rebalance_traffic(port, ps, mo=mo) == \
                jax_cost.rebalance_traffic(ref, rs, mo=mo), (name, mo)


# ------------------------------------------------- 1. plans and traffic

PACKED = [([3, 5], 4, 2), ([3, 5], 2, 4), ([7, 2, 11], 4, 3),
          ([7, 2, 11], 3, 6), ([1, 1], 5, 2), ([23, 4], 8, 8),
          ([5, 9, 13], 6, 8)]


@pytest.mark.parametrize("counts,s_old,s_new", PACKED,
                         ids=[f"{c}-{a}to{b}" for c, a, b in PACKED])
def test_packed_plan_equals_the_reference(counts, s_old, s_new):
    po, ro = domains(counts, s_old)
    pn, rn = domains(counts, s_new)
    port, ref = plan_rebalance(po, pn), jax_rebalance.plan_rebalance(ro, rn)
    same_plan(port, ref)
    same_traffic(port, ref)


@pytest.mark.parametrize("d_model,s_old,s_new", [(64, 8, 6), (64, 6, 12),
                                                 (128, 4, 3), (128, 3, 2)])
def test_solo_plan_equals_the_reference(d_model, s_old, s_new):
    (po, ro), (pn, rn) = solo_plans(d_model, s_old), solo_plans(d_model,
                                                                s_new)
    port, ref = plan_rebalance(po, pn), jax_rebalance.plan_rebalance(ro, rn)
    same_plan(port, ref)
    same_traffic(port, ref)
    (g,) = port.groups.values()
    assert g.moves == {SOLO_TENANT: ((0, 0, 0, po.groups[0].live_elems),)}
    assert g.moved_elems() == 0          # the live extent keeps its offsets
    assert po.groups[0].live_elems == ro.groups[0].live_elems


@pytest.mark.parametrize("live,old,new", [(1024, 2048, 1536),
                                          (2560, 2560, 3072),
                                          (256, 512, 256)])
def test_solo_resize_plan_equals_the_reference(live, old, new):
    port = solo_resize_plan(torch.float32, 256, live, old, new)
    ref = jax_rebalance.solo_resize_plan(np.dtype(np.float32), 256, live,
                                         old, new)
    same_plan(port, ref)
    rows = torch.arange(2 * old, dtype=torch.float32).view(2, old)
    out = port.apply("float32", rows)
    np.testing.assert_array_equal(out.numpy(),
                                  ref.apply("float32", rows.numpy()))
    assert torch.equal(out[:, :live], rows[:, :live])
    assert not out[:, live:].any()


def test_solo_resize_plan_refuses_a_ragged_live_extent():
    for args in ((1000, 2048, 1536), (0, 512, 512), (2048, 2048, 1536)):
        with pytest.raises(ValueError, match="live extent"):
            solo_resize_plan(torch.float32, 256, *args)


@pytest.mark.parametrize("counts,shards", [([3, 5], (4, 2, 3)),
                                           ([7, 2, 11], (3, 6, 4)),
                                           ([4, 4], (2, 5, 2))])
def test_composed_plan_equals_the_reference(counts, shards):
    port = [domains(counts, s)[0] for s in shards]
    ref = [domains(counts, s)[1] for s in shards]
    pc = plan_rebalance(port[0], port[1]).compose(
        plan_rebalance(port[1], port[2]))
    rc = jax_rebalance.plan_rebalance(ref[0], ref[1]).compose(
        jax_rebalance.plan_rebalance(ref[1], ref[2]))
    same_plan(pc, rc)
    same_traffic(pc, rc)


def test_plans_refuse_what_the_reference_refuses():
    old, _ = domains([3, 5], 4)
    with pytest.raises(ValueError, match="tenant sets differ"):
        plan_rebalance(old, domains([3, 5, 2], 4)[0])
    with pytest.raises(ValueError, match="extents"):
        plan_rebalance(old, domains([3, 6], 4)[0])
    with pytest.raises(ValueError, match="chunk_elems"):
        plan_rebalance(old, domains([3 * 2, 5 * 2], 4, ce=CE // 2)[0])
    p = plan_rebalance(old, domains([3, 5], 3)[0])      # 8 -> 9 chunks
    with pytest.raises(ValueError, match="intermediate"):
        p.compose(p)
    with pytest.raises(ValueError, match="expected"):
        p.apply("float32", torch.zeros(1, 5))


# ------------------------------------------------------------- 2. apply

@pytest.mark.parametrize("counts,s_old,s_new", PACKED[:4],
                         ids=[f"{c}-{a}to{b}" for c, a, b in PACKED[:4]])
def test_apply_on_a_tensor_equals_the_reference(counts, s_old, s_new):
    po, ro = domains(counts, s_old)
    pn, rn = domains(counts, s_new)
    port, ref = plan_rebalance(po, pn), jax_rebalance.plan_rebalance(ro, rn)
    (key,) = port.groups
    rng = np.random.default_rng(len(counts) * 31 + s_old)
    rows = rng.standard_normal((3, po.groups[key].padded)).astype(np.float32)
    out = port.apply(key, torch.from_numpy(rows))
    assert out.dtype == torch.float32 and out.shape == (
        3, pn.groups[key].padded)
    np.testing.assert_array_equal(out.numpy(), ref.apply(key, rows))
    for t in po.tenants:
        assert torch.equal(pn.unpack(key, out[1], t),
                           po.unpack(key, torch.from_numpy(rows[1]), t))
    for off, n in pn.groups[key].pad_runs():
        assert not out[:, off:off + n].any()


def test_apply_keeps_the_dtype():
    po, _ = domains([3, 5], 4)
    pn, _ = domains([3, 5], 3)
    plan = plan_rebalance(po, pn)
    rows = torch.arange(po.groups["float32"].padded).to(torch.bfloat16)[None]
    out = plan.apply("float32", rows)
    assert out.dtype == torch.bfloat16
    want = plan.apply("float32", rows.float())
    assert torch.equal(out.float(), want)


# --------------------------------------------------- 3. the properties

def _placement_map(domain, key):
    g = domain.groups[key]
    ce = g.chunk_elems
    out = {}
    for s in g.slots:
        m = {}
        for toff, poff, ln in s.runs:
            for k in range(ln // ce):
                m[(toff + k * ce) // ce] = (poff + k * ce) // ce
        out[s.tenant] = m
    return out


chunk_counts = st.lists(st.integers(1, 23), min_size=1, max_size=4)


@settings(max_examples=40, deadline=None)
@given(chunk_counts, st.integers(2, 9), st.integers(2, 9))
def test_plan_moves_each_chunk_at_most_once(counts, s_old, s_new):
    old, new = domains(counts, s_old)[0], domains(counts, s_new)[0]
    plan = plan_rebalance(old, new)
    for key, g in plan.groups.items():
        ce = g.chunk_elems
        for tenant, runs in g.moves.items():
            toffs, srcs, dsts = set(), set(), set()
            ext = 0
            for toff, src, dst, ln in runs:
                assert ln % ce == 0 and ln > 0
                for k in range(0, ln, ce):
                    for acc, v in ((toffs, toff + k), (srcs, src + k),
                                   (dsts, dst + k)):
                        assert v not in acc
                        acc.add(v)
                ext += ln
            assert ext == old.groups[key].slot(tenant).padded


@settings(max_examples=40, deadline=None)
@given(chunk_counts, st.integers(2, 9), st.integers(2, 9))
def test_plan_delta_is_exactly_the_symmetric_difference(counts, s_old,
                                                        s_new):
    old, new = domains(counts, s_old)[0], domains(counts, s_new)[0]
    plan = plan_rebalance(old, new)
    for key in plan.groups:
        pm_old, pm_new = _placement_map(old, key), _placement_map(new, key)
        for tenant, pairs in plan.chunk_placements(key).items():
            changed = {c for c in pm_old[tenant]
                       if pm_old[tenant][c] != pm_new[tenant][c]}
            moved = set()
            for i, (src, dst) in enumerate(pairs):
                assert pm_old[tenant][i] == src
                assert pm_new[tenant][i] == dst
                if src != dst:
                    moved.add(i)
            assert moved == changed


@settings(max_examples=25, deadline=None)
@given(chunk_counts, st.integers(2, 9), st.integers(2, 9),
       st.integers(2, 9))
def test_plans_compose(counts, s_a, s_b, s_c):
    da, db, dc = (domains(counts, s)[0] for s in (s_a, s_b, s_c))
    p_ab, p_bc = plan_rebalance(da, db), plan_rebalance(db, dc)
    p_ac = plan_rebalance(da, dc)
    comp = p_ab.compose(p_bc)
    for key in p_ac.groups:
        assert comp.chunk_placements(key) == p_ac.chunk_placements(key)
        rows = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (1, p_ac.groups[key].old_padded)).astype(np.float32))
        assert torch.equal(p_bc.apply(key, p_ab.apply(key, rows)),
                           p_ac.apply(key, rows))
        assert torch.equal(comp.apply(key, rows), p_ac.apply(key, rows))
