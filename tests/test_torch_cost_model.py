"""The port's analytic models (``core/cost_model.py``) against the JAX
package's, on the same inputs.

Every function is host arithmetic written in the reference's order, so
the figures are equal exactly (``==`` on floats and on the result dicts);
RTOL (1e-12) is there for a sum whose order could differ, and no case
needs it today.  Covered: Table 2's four configurations over the paper's
models (``repro/configs/phub_paper.py``); the §3.4 condition and the
cross-rack bytes over a grid of topologies; ``predicted_exchange_traffic``
(the reference's ``predicted_exchange_hlo``) and ``predicted_step_seconds``
for sharded_ps, hierarchical (with and without the int8 DCN tier),
allreduce and centralized_ps (which both refuse), in 1 and 3 windows,
over the identity, int8 and bf16 wires, on the chunk plans of reduced
llama3.2-1b and on a packed domain of two tenants;
``backward_overlap_fraction``; Table 5's throughput per dollar.
"""
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.phub_paper import PAPER_MODELS
from repro.core import chunking as jax_chunking
from repro.core import cost_model as ref
from repro.core.wire import WireFormat as JaxWire
from repro_torch.configs import get_arch, reduced
from repro_torch.core import cost_model as port
from repro_torch.core.chunking import build_plan, leaf_paths, pack_domains
from repro_torch.core.wire import WireFormat
from repro_torch.models import param_specs

RTOL = 1e-12


def close(a, b) -> bool:
    """Equal dicts, lists or numbers, floats within RTOL."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0)
    return a == b


# -------------------------------------------------------- §2.3.1 Table 2

@pytest.mark.parametrize("config", ["CC", "CS", "NCC", "NCS"])
def test_table2_bandwidth_equals_the_reference(config):
    for m in PAPER_MODELS.values():
        for n in (2, 4, 8, 16):
            args = (config, m.model_bytes, m.time_per_batch_s, n)
            assert port.min_bandwidth_bits(*args) == \
                ref.min_bandwidth_bits(*args)
    with pytest.raises(ValueError):
        port.min_bandwidth_bits("XX", 1.0, 1.0, 2)


# ---------------------------------------------------------------- §3.4

TOPOLOGIES = list(itertools.product((2, 4, 8, 16), (1, 2, 4),
                                    (1.25e9, 12.5e9), (1.25e9, 12.5e9),
                                    (1.25e9, 1e12)))


def topo_pair(N, r, bw_w, bw_p, bw_c, **kw):
    fields = dict(n_workers_per_rack=N, n_racks=r, bw_worker=bw_w,
                  bw_pbox=bw_p, bw_core=bw_c, **kw)
    return port.RackTopology(**fields), ref.RackTopology(**fields)


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "flat"])
def test_hierarchical_condition_equals_the_reference(ring):
    wins = 0
    for N, r, bw_w, bw_p, bw_c in TOPOLOGIES:
        if r < 2:
            continue
        pt, rt = topo_pair(N, r, bw_w, bw_p, bw_c)
        got = port.hierarchical_beneficial(pt, ring=ring)
        assert got == ref.hierarchical_beneficial(rt, ring=ring)
        wins += got
    assert 0 < wins < len(TOPOLOGIES)      # the grid has both verdicts


def test_cross_rack_bytes_equal_the_reference():
    for (N, r, *_), hier in itertools.product(TOPOLOGIES, (True, False)):
        for M in (1.0, 100 * 2**20, 4.9e9):
            assert port.cross_rack_bytes(M, N, r, hier) == \
                ref.cross_rack_bytes(M, N, r, hier)


def test_topology_holds_no_numbers_of_its_own():
    t = port.RackTopology(n_workers_per_rack=4, n_racks=2, bw_worker=1.0,
                          bw_pbox=2.0, bw_core=3.0)
    assert (t.lat_ici, t.lat_dcn, t.bw_codec) == (None, None, None)
    assert (t.ici_bandwidth, t.dcn_bandwidth) == (2.0, 3.0)
    (g,) = build_plan({"w": torch.empty(4096, device="meta")},
                      chunk_bytes=1024, n_shards=4).groups
    with pytest.raises(ValueError, match="no default topology"):
        port.predicted_step_seconds([g], strategy="sharded_ps", topo=t)


# ------------------------------------- exchange traffic and step time

def llama_plans(d_model, n_shards, chunk):
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


def group_pairs(kind, S):
    """(port groups, reference groups) over S shards: a solo plan, or the
    packed domain of two tenants."""
    if kind == "solo":
        p, r = llama_plans(64, S, 512)
        return p.groups, r.groups
    plans = [llama_plans(d, S, 512) for d in (64, 128)]
    p = pack_domains({"A": plans[0][0], "B": plans[1][0]}, n_shards=S,
                     chunk_bytes=512)
    r = jax_chunking.pack_domains({"A": plans[0][1], "B": plans[1][1]},
                                  n_shards=S, chunk_bytes=512)
    return tuple(p.groups.values()), tuple(r.groups.values())


def wires(name):
    if name == "identity":
        return None, None
    return WireFormat(name=name), JaxWire(name=name, use_pallas=False)


# (strategy, pods, DCN wire) x windows x ICI wire
CASES = [(s, P, dcn) for s, P, dcn in (
    ("sharded_ps", 1, None), ("sharded_ps", 2, None),
    ("hierarchical", 2, None), ("hierarchical", 2, "int8"),
    ("allreduce", 1, None), ("centralized_ps", 1, None))]

TOPO = dict(n_workers_per_rack=4, n_racks=2, bw_worker=12.5e9,
            bw_pbox=12.5e9, bw_core=1.25e9, bw_ici=50e9, bw_dcn=3e9,
            lat_ici=2e-6, lat_dcn=30e-6)


@pytest.mark.parametrize("kind", ["solo", "packed"])
@pytest.mark.parametrize("wire", ["identity", "int8", "bf16"])
@pytest.mark.parametrize("windows", [1, 3])
@pytest.mark.parametrize("strategy,pods,dcn", CASES,
                         ids=[f"{s}-P{P}-{d or 'f32'}" for s, P, d in CASES])
def test_exchange_traffic_and_step_time_equal_the_reference(
        strategy, pods, dcn, windows, wire, kind):
    S = 6 if pods == 1 else 3                # 6 workers: 1 x 6 or 2 x 3
    pg, rg = group_pairs(kind, S)
    pw, rw = wires(wire)
    pd, rd = wires(dcn) if dcn else (None, None)
    kw = dict(strategy=strategy, windows=windows, n_workers=6,
              pod_size=pods)
    try:
        want = ref.predicted_exchange_hlo(rg, wire=rw, wire_dcn=rd, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:30]):
            port.predicted_exchange_traffic(pg, wire=pw, wire_dcn=pd, **kw)
        with pytest.raises(ValueError, match=str(e)[:30]):
            port.predicted_step_seconds(pg, topo=port.RackTopology(**TOPO),
                                        wire=pw, wire_dcn=pd, **kw)
        assert strategy == "centralized_ps" or (
            strategy == "allreduce" and wire != "identity")
        return
    got = port.predicted_exchange_traffic(pg, wire=pw, wire_dcn=pd, **kw)
    assert close(got, want)
    assert got["runtime_by_kind"]            # something crosses the links
    for codec in (None, 5e9):
        for factor in (1.0, 2.0):
            topo = dict(TOPO, bw_codec=codec, allreduce_factor=factor)
            g = port.predicted_step_seconds(
                pg, topo=port.RackTopology(**topo), wire=pw, wire_dcn=pd,
                compute_s=0.25, **kw)
            r = ref.predicted_step_seconds(
                rg, topo=ref.RackTopology(**topo), wire=rw, wire_dcn=rd,
                compute_s=0.25, **kw)
            assert close(g, r)
            assert g["seconds"] > 0.25


# -------------------------------------------------- backward overlap

@pytest.mark.parametrize("seed", range(6))
def test_backward_overlap_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(1, 9))
        ready = sorted(rng.uniform(0, 1, n).tolist())
        comm = rng.uniform(0, 0.3, n).tolist()
        back = float(rng.uniform(0.05, 1.0))
        assert port.backward_overlap_fraction(ready, comm, back) == \
            ref.backward_overlap_fraction(ready, comm, back)
    zero = port.backward_overlap_fraction([0.5], [0.0], 1.0)
    assert zero == ref.backward_overlap_fraction([0.5], [0.0], 1.0)
    with pytest.raises(ValueError, match="windows"):
        port.backward_overlap_fraction([0.1, 0.2], [0.1], 1.0)


# ---------------------------------------------------------- §4.9 Table 5

def test_throughput_per_dollar_equals_the_reference():
    for tput, oversub, k, phub in itertools.product(
            (100.0, 338.0, 1234.5), (1.0, 2.0, 3.0), (20, 44, 65),
            (True, False)):
        assert port.throughput_per_dollar(
            tput, phub=phub, oversub=oversub, workers_per_phub=k) == \
            ref.throughput_per_dollar(tput, phub=phub, oversub=oversub,
                                      workers_per_phub=k)
    n, rn = port.CostInputs(), ref.CostInputs()
    for nic, cable, oversub, breakout in ((260.0, 31.25, 2.0, 4),
                                          (795.0, 94.0, 1.0, 1)):
        assert port.amortized_network(n, nic, cable, oversub=oversub,
                                      breakout=breakout) == \
            ref.amortized_network(rn, nic, cable, oversub=oversub,
                                  breakout=breakout)
    # Table 5: the 25 Gb PHub at 2:1 beats 100 Gb sharded
    base = port.throughput_per_dollar(338.0, phub=False, oversub=1.0)
    phub = port.throughput_per_dollar(338.0 * 0.98, phub=True, oversub=2.0,
                                      workers_per_phub=65)
    assert (phub - base) / base > 0.10
