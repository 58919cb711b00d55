"""The port's allreduce, centralized_ps and hierarchical strategies on the
stacked Comm (``core/exchange.py``, ``core/pipeline.py``) against the JAX
package's.

1. The reference's ``exchange_group`` (the three strategies),
   ``pipelined_exchange`` (hierarchical in 3 windows) and
   ``pipelined_dcn_exchange`` (hierarchical with the int8 DCN tier, 1 and 3
   windows) under ``shard_map`` on a ``(pod, data)`` mesh of forced host
   devices (``AxisType.Auto``), in one subprocess, equal the port's
   exchange bitwise for P x D in {1x4, 2x2, 4x1, 2x1}, Nesterov and SGD,
   f32 and bf16 groups, on integer-valued g, p and m at lr 0.25 and
   momentum 0.5 (every sum, product and quotient exact, so the two
   frameworks' FMA contraction cannot differ).  A 3-of-4 membership (one
   row zero, the mean over 3: a tensor divisor and a number) draws
   multiples of 3, whose quotient by 3 is exact however XLA divides.  The
   DCN cases draw every chunk of every pod's partial with its largest
   magnitude 127, so the int8 scale is 1 both ways (XLA turns ``/127`` into
   ``* (1/127)``) and the codec is exact.
2. The int8 tiers on random inputs, against an eager composition of the
   reference's ``WireFormat`` encode and decode in pod and ring order
   (``cross_pod_reduce``, ``pipelined_dcn_exchange`` and
   ``pipelined_wire_exchange``'s ring, written window by window): the DCN
   tier with its per-pod residual, the int8 ring inside the pods with
   the identity and the scales-only DCN cross-pod leg; Nesterov, SGD and
   Adam, f32 and bf16, 1 and 3 windows; p, the slots and ``wire_ef``.
3. The reference's ``PHubEngine`` on a ``(pod=2, data=2, model=1)`` mesh
   (same subprocess): reduced llama3.2-1b, one hierarchical step, against
   the port's W=4 2x2 step within ``check_engine.py``'s 2e-4 (params) and
   3e-4 (loss); allreduce and centralized_ps against the reference's too.
The steps inside the port (modes, memberships, checkpoints, the launcher)
are ``tests/test_torch_engine_strategies.py``.
"""
import functools
import itertools
import json
import os
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.wire import WireFormat as JaxWire
from repro.kernels.agg_opt.ref import (adam_opt_ref as jax_adam_ref,
                                       agg_opt_ref as jax_agg_opt_ref,
                                       sgd_opt_ref as jax_sgd_ref)
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import PHubEngine, StackedComm, chunking
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import (effective_windows, run_dcn_exchange,
                                       run_exchange, run_wire_exchange)
from repro_torch.core.wire import WireFormat
from repro_torch.data import SyntheticTokens
from repro_torch.optim.protocol import make_sharded_optimizer

CE, CPS = 128, 3                # chunk elements; chunks a shard
LAYOUTS = ((1, 4), (2, 2), (4, 1), (2, 1))     # (P pods, D workers a pod)
BASELINES = ("allreduce", "centralized_ps")
REF_LR, REF_MU = 0.25, 0.5      # exact on integer-valued inputs
REF_RULES = ("nesterov", "sgd")
DTYPES = ("float32", "bfloat16")
RULES = ("nesterov", "sgd", "adam")
LR = {"nesterov": 0.05, "sgd": 0.05, "adam": 1e-3}
ADAM_EPS = 1e-3
DEAD = 1                        # the worker a 3-of-4 membership leaves out
ENGINE_PARAM_ATOL, ENGINE_LOSS_ATOL = 2e-4, 3e-4   # check_engine.py's
ENGINE_STRATEGIES = ("hierarchical", "allreduce", "centralized_ps")
ENGINE_B, ENGINE_T = 8, 32
TIMEOUT = 600


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def deterministic():
    """The CPU embedding backward sums its rows in parallel, in an order
    that changes from run to run; deterministic mode fixes it."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def plan(comm, strategy: str, dtype):
    """One group of CPS chunks a shard, the last chunk ragged."""
    S = comm.n_shards(strategy)
    tree = {"w": torch.empty(S * CPS * CE - 50, dtype=dtype)}
    (group,) = chunking.build_plan(
        tree, chunk_bytes=CE * dtype.itemsize, n_shards=S).groups
    return group


def _rule(rule: str, lr=None, mu=None):
    tc = TrainConfig(optimizer=rule, lr=LR[rule] if lr is None else lr,
                     momentum=0.9 if mu is None else mu, adam_eps=ADAM_EPS)
    sopt = make_sharded_optimizer(tc)
    return sopt, sopt.coefs(tc)


def port_exchange(strategy, P, D, rule, dtype, windows, tier, g, p, slots,
                  residual=None, n_live=None, lr=None, mu=None):
    """One group's stacked exchange as the engine dispatches it; returns
    (p', slots', wire_ef' or None)."""
    comm = StackedComm(P * D, P)
    group = plan(comm, strategy, dtype)
    assert group.padded == p.numel()
    sopt, coefs = _rule(rule, lr, mu)
    upd = sopt.kernel_update(CE, coefs)
    if tier == "identity":
        p2, s2 = run_exchange(strategy, comm, g, p, slots, upd, group,
                              windows, n_live)
        return p2, tuple(s2), None
    if tier == "dcn":
        return run_dcn_exchange(strategy, comm, g, p, slots, upd, group,
                                WireFormat("int8"), residual, windows,
                                n_live)
    fused = sopt.kernel_dequant_update(CE, coefs,
                                       1.0 / (n_live or comm.n_workers))
    dcn = WireFormat("int8") if tier == "int8+dcn" else None
    return run_wire_exchange(strategy, comm, g, p, slots, upd, group,
                             WireFormat("int8"), residual, fused, windows,
                             n_live, wire_dcn=dcn)


# ------------------------------------------- 1. the reference's shard_map

def ref_cases() -> list:
    """(name, spec) of every shard_map case."""
    out = []
    for (P, D), strategy in itertools.product(LAYOUTS,
                                              BASELINES + ("hierarchical",)):
        for rule, dt in itertools.product(REF_RULES, DTYPES):
            out.append(dict(kind="exchange", strategy=strategy, P=P, D=D,
                            rule=rule, dtype=dt, windows=1, n_live=None))
        if P * D == 4:
            for n_live in ("tensor", "number"):
                out.append(dict(kind="exchange", strategy=strategy, P=P, D=D,
                                rule="nesterov", dtype="float32", windows=1,
                                n_live=n_live))
        if strategy == "hierarchical":
            for rule in REF_RULES:
                out.append(dict(kind="exchange", strategy=strategy, P=P,
                                D=D, rule=rule, dtype="float32", windows=3,
                                n_live=None))
            if P > 1:
                for windows in (1, 3):
                    out.append(dict(kind="dcn", strategy=strategy, P=P, D=D,
                                    rule="nesterov", dtype="float32",
                                    windows=windows, n_live=None))
    return [(_case_name(c), c) for c in out]


def _case_name(c) -> str:
    return (f"{c['kind']}-{c['strategy']}-{c['P']}x{c['D']}-{c['rule']}-"
            f"{c['dtype']}-win{c['windows']}"
            + (f"-live3{c['n_live']}" if c["n_live"] else ""))


def ref_inputs(name: str, c) -> dict:
    """Integer-valued g (W, padded), p, m (padded,) and the DCN residual
    (P*padded,) for one case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    W = c["P"] * c["D"]
    group = plan(StackedComm(W, c["P"]), c["strategy"],
                 getattr(torch, c["dtype"]))
    n = group.padded
    scale = 3 if c["n_live"] else 1
    g = scale * rng.integers(-8, 9, (W, n)).astype(np.float32)
    if c["n_live"]:
        g[DEAD] = 0
    p = rng.integers(-8, 9, n).astype(np.float32)
    m = rng.integers(-4, 5, n).astype(np.float32)
    res = np.zeros(c["P"] * n, np.float32)
    if c["kind"] == "dcn":
        # every chunk of every pod's partial peaks at 127 (its first
        # element), the rest small: the int8 scale is 1, the codec exact
        g = rng.integers(-4, 5, (W, n)).astype(np.float32)
        lead = np.zeros(n, bool)
        lead[::CE] = True
        for q in range(c["P"]):
            rows = g[q * c["D"]:(q + 1) * c["D"]]
            rows[:, lead] = 0
            rows[0, lead] = 127 - (c["D"] - 1) * 3
            rows[1:, lead] = 3
        res = rng.integers(-2, 3, c["P"] * n).astype(np.float32)
        res.reshape(c["P"], n)[:, lead] = 0
    return dict(g=g, p=p, m=m, res=res)


_REF_SCRIPT = r"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS, TrainConfig, reduced
from repro.core import PHubEngine
from repro.core.exchange import ExchangeContext, exchange_group, flat_rank
from repro.core.pipeline import pipelined_dcn_exchange, pipelined_exchange
from repro.core.wire import WireFormat
from repro.data import SyntheticTokens
from repro.optim.protocol import NesterovOptimizer, SGDOptimizer, tuple_update
from repro.utils import compat

spec_path, src, dst, lr, mu = sys.argv[1:6]
lr, mu = float(lr), float(mu)
cases = json.load(open(spec_path))
d = np.load(src)
out = {}
Auto = jax.sharding.AxisType.Auto


def run_case(name, c):
    Pn, Dn = c["P"], c["D"]
    W = Pn * Dn
    mesh = jax.make_mesh((Pn, Dn), ("pod", "data"), axis_types=(Auto, Auto),
                         devices=jax.devices()[:W])
    sizes = {"pod": Pn, "data": Dn}
    ctx = ExchangeContext(data_axes=("pod", "data"), axis_sizes=sizes)
    st = c["strategy"]
    dt = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
    opt, coefs = ((NesterovOptimizer(), (lr, mu)) if c["rule"] == "nesterov"
                  else (SGDOptimizer(), (lr,)))
    upd = tuple_update(opt, coefs)
    n_live = 3.0 if c["n_live"] else None
    hier = st == "hierarchical"
    m_spec = P("data") if hier else P()

    def body(g, p, m, res):
        rank = flat_rank(("data",) if hier else ("pod", "data"), sizes)
        slots = (m,) if opt.slots else ()
        if c["kind"] == "dcn":
            p2, s2, r2 = pipelined_dcn_exchange(
                ctx, g.reshape(-1), p, slots, upd, rank, c["windows"],
                WireFormat("int8"), 128, res.reshape(-1), n_live=n_live)
        elif c["windows"] > 1:
            p2, s2 = pipelined_exchange(st, ctx, g.reshape(-1), p, slots,
                                        upd, rank, c["windows"],
                                        n_live=n_live)
            r2 = res.reshape(-1)
        else:
            p2, s2 = exchange_group(st, ctx, g.reshape(-1), p, slots, upd,
                                    rank, n_live=n_live)
            r2 = res.reshape(-1)
        return p2, (s2[0] if s2 else m), r2

    # the DCN residual: device (pod q, data d) holds pod q's of shard d,
    # the port's (P*S, L) rows pod-major
    f = jax.jit(compat.shard_map(
        body, mesh=mesh,
        in_specs=(P(("pod", "data")), P(), m_spec, P(("pod", "data"))),
        out_specs=(P(), m_spec, P(("pod", "data"))),
        axis_names={"pod", "data"}))
    with compat.set_mesh(mesh):
        p2, m2, r2 = f(jnp.asarray(d[name + "/g"]).astype(dt),
                       jnp.asarray(d[name + "/p"]).astype(dt),
                       jnp.asarray(d[name + "/m"]).astype(dt),
                       jnp.asarray(d[name + "/res"]))
    out[name + "/p"] = np.asarray(p2.astype(jnp.float32))
    out[name + "/m"] = np.asarray(m2.astype(jnp.float32))
    out[name + "/res"] = np.asarray(r2)


for name, c in cases["exchange"]:
    run_case(name, c)

mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                     axis_types=(Auto,) * 3)
cfg = reduced(ARCHS["llama3.2-1b"])
for st in cases["engine"]:
    eng = PHubEngine(cfg=cfg, tc=TrainConfig(strategy=st, use_pallas=False),
                     mesh=mesh)
    params, opt = eng.init_state(jax.random.PRNGKey(0))
    if st == cases["engine"][0]:
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                jax.device_get(params)):
            out["engine/init/" + jax.tree_util.keystr(path)] = np.asarray(
                leaf, np.float32)
    data = SyntheticTokens(cfg, cases["B"], cases["T"], seed=3)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in data.batch_at(0).items()}
    params, opt, m = eng.make_train_step(shapes)(params, opt,
                                                  data.device_batch(0))
    out[f"engine/{st}/loss"] = np.asarray(float(m["loss"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(params)):
        out[f"engine/{st}/" + jax.tree_util.keystr(path)] = np.asarray(
            leaf, np.float32)
np.savez(dst, **out)
"""


@functools.lru_cache(maxsize=None)
def reference_results(tmp: str) -> dict:
    cases = ref_cases()
    arrays = {}
    for name, c in cases:
        for k, v in ref_inputs(name, c).items():
            arrays[f"{name}/{k}"] = v
    spec, src, dst = (os.path.join(tmp, f) for f in
                      ("cases.json", "in.npz", "out.npz"))
    with open(spec, "w") as f:
        json.dump({"exchange": cases, "engine": ENGINE_STRATEGIES,
                   "B": ENGINE_B, "T": ENGINE_T}, f)
    np.savez(src, **arrays)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT, spec, src, dst,
                          str(REF_LR), str(REF_MU)], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(dst))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_results(str(tmp_path_factory.mktemp("ref")))


REF_CASES = ref_cases()


@pytest.mark.parametrize("name,case", REF_CASES,
                         ids=[n for n, _ in REF_CASES])
def test_stacked_exchange_equals_reference_shard_map(name, case, reference):
    x = ref_inputs(name, case)
    dtype = getattr(torch, case["dtype"])
    P, D = case["P"], case["D"]
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    g, p = t["g"].to(dtype), t["p"].to(dtype)
    slots = (t["m"].to(dtype),) if case["rule"] == "nesterov" else ()
    n_live = {None: None, "tensor": torch.tensor(3.0),
              "number": 3.0}[case["n_live"]]
    tier = "dcn" if case["kind"] == "dcn" else "identity"
    p2, s2, r2 = port_exchange(case["strategy"], P, D, case["rule"], dtype,
                               case["windows"], tier, g, p, slots,
                               residual=t["res"], n_live=n_live, lr=REF_LR,
                               mu=REF_MU)
    want_p = reference[name + "/p"]
    assert not np.array_equal(want_p, x["p"]), "the reference did not update"
    assert p2.dtype == dtype
    assert p2.float().numpy().tobytes() == want_p.tobytes(), \
        "p' differs from the reference's"
    if slots:
        assert (s2[0].float().numpy().tobytes()
                == reference[name + "/m"].tobytes()), \
            "m' differs from the reference's"
    if tier == "dcn":
        assert r2.numpy().tobytes() == reference[name + "/res"].tobytes(), \
            "the DCN residual differs from the reference's"


@pytest.mark.parametrize("strategy", ENGINE_STRATEGIES)
def test_engine_step_matches_reference_engine(strategy, reference,
                                              deterministic):
    """One reduced llama3.2-1b step at W=4 (2 pods x 2 for hierarchical)
    from the reference's weights, against the reference's PHubEngine on a
    (pod=2, data=2, model=1) mesh."""
    cfg = reduced(get_arch("llama3.2-1b"))
    init = {k[len("engine/init/"):]: v for k, v in reference.items()
            if k.startswith("engine/init/")}
    tree = _tree_from_keystr(init)
    eng = PHubEngine(cfg, TrainConfig(strategy=strategy),
                     StackedComm(4, 2), device="cpu")
    model = params_from_numpy(cfg, tree, device="cpu")
    opt = eng.init_opt()
    data = SyntheticTokens(cfg, ENGINE_B, ENGINE_T, seed=3)
    model, opt, metrics = eng.make_train_step()(
        model, opt, data.torch_batch(0, "cpu"))
    want_loss = float(reference[f"engine/{strategy}/loss"])
    assert abs(float(metrics["loss"]) - want_loss) <= ENGINE_LOSS_ATOL
    want = _tree_from_keystr(
        {k[len(f"engine/{strategy}/"):]: v for k, v in reference.items()
         if k.startswith(f"engine/{strategy}/") and not k.endswith("/loss")})
    got = dict(leaf_paths(model.param_tree()))
    for path, w in leaf_paths(want):
        err = np.abs(got[path].detach().numpy() - w).max()
        assert err <= ENGINE_PARAM_ATOL, (path, err)
    moved = max(np.abs(got[path].detach().numpy() - w0).max()
                for path, w0 in leaf_paths(tree))
    assert moved > 5 * ENGINE_PARAM_ATOL, "the step barely moved"


def _tree_from_keystr(flat: dict) -> dict:
    """{"['blocks']['wq']": array} -> nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        parts = [k.strip("'\"") for k in key.strip("[]").split("][")]
        node = tree
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return tree


# ---------------------------------------- 2. the int8 tiers, eager codec

def _rule_oracle(rule, pw, gin, sw, coefs):
    if rule == "nesterov":
        p2, m2 = jax_agg_opt_ref(pw, gin, sw[0], lr=coefs[0],
                                 momentum=coefs[1])
        return p2, (m2,)
    if rule == "sgd":
        return jax_sgd_ref(pw, gin, lr=coefs[0]), ()
    p2, *s2 = jax_adam_ref(pw, gin, *sw, lr=coefs[0], eps=ADAM_EPS)
    return p2, tuple(s2)


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def codec_reference(tier, P, D, rule, g, p, slots, res, windows):
    """The reference's per-device schedule written window by window from
    its eager jnp codec (``WireFormat("int8")``): ``tier`` "dcn" (the
    in-pod sum, each pod's partial plus its residual encoded, the decoded
    rows summed in pod order, / N) or "int8" / "int8+dcn" (the ring inside
    each pod from worker j+1, the owner's decode plus its own rows, the
    cross-pod sum (through the DCN codec, scales-only), / N, the pull's
    encoded delta plus residual).  Returns numpy f32 (p', slots',
    residual')."""
    wire = JaxWire("int8")
    _, coefs = _rule(rule)
    W, n = P * D, p.numel()
    L = n // D
    Lw = L // windows
    G = _j(g)
    dt = G.dtype
    Pv, SL = _j(p), [_j(t) for t in slots]
    R = jnp.asarray(res.numpy())
    p_new = np.zeros(n, np.float32)
    s_new = [np.zeros(n, np.float32) for _ in slots]
    r_new = np.array(res.numpy())
    for w in range(windows):
        for j in range(D):
            cols = slice(j * L + w * Lw, j * L + (w + 1) * Lw)
            partials = []
            for q in range(P):
                row = lambda k: G[q * D + (k % D), cols]
                if tier == "dcn":
                    x = row(0)
                    for k in range(1, D):
                        x = x + row(k)                  # in the group dtype
                    if P == 1:
                        partials.append(x.astype(jnp.float32))
                        continue
                    rq = slice(q * n + cols.start, q * n + cols.stop)
                    xf = x.astype(jnp.float32) + R[rq]
                    dq = wire.decode(wire.encode(xf, CE), CE)
                    r_new[rq] = np.asarray(xf - dq)
                    partials.append(dq)
                else:
                    f32 = lambda k: row(k).astype(jnp.float32)
                    if D == 1:
                        gq = f32(0)
                    else:
                        parts = wire.encode(f32(j + 1), CE)
                        for k in range(2, D):
                            parts = wire.encode(
                                wire.decode(parts, CE) + f32(j + k), CE)
                        gq = wire.decode(parts, CE) + f32(j)
                    if tier == "int8+dcn" and P > 1:
                        gq = wire.decode(wire.encode(gq, CE), CE)
                    partials.append(gq)
            total = partials[0]
            for x in partials[1:]:
                total = total + x                       # in pod order
            gin = total / W
            pw, sw = Pv[cols], tuple(t[cols] for t in SL)
            p2, s2 = _rule_oracle(rule, pw, gin, sw, coefs)
            for acc, t in zip(s_new, s2):
                acc[cols] = np.asarray(t.astype(jnp.float32))
            if tier == "dcn":
                p_new[cols] = np.asarray(p2.astype(jnp.float32))
            else:
                e = (p2.astype(jnp.float32) - pw.astype(jnp.float32)) \
                    + R[cols]
                dlt = wire.decode(wire.encode(e, CE), CE)
                r_new[cols] = np.asarray(e - dlt)
                p_new[cols] = np.asarray(
                    (pw.astype(jnp.float32) + dlt).astype(pw.dtype)
                    .astype(jnp.float32))
    return p_new, tuple(s_new), r_new


CODEC_LAYOUTS = ((2, 2), (2, 1), (4, 1), (1, 2))
CODEC_CASES = [(tier, P, D, rule, dt, win)
               for tier in ("dcn", "int8", "int8+dcn")
               for (P, D) in CODEC_LAYOUTS
               for rule in RULES for dt in DTYPES for win in (1, 3)
               if not (tier == "int8+dcn" and P == 1)
               and (dt == "float32" or win == 1)]


def codec_inputs(case):
    tier, P, D, rule, dt, win = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    dtype = getattr(torch, dt)
    n = plan(StackedComm(P * D, P), "hierarchical", dtype).padded

    def draw(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    g = draw(P * D, n, scale=1e-2).to(dtype)
    g[:, ::11] = 0
    p = draw(n).to(dtype)
    sopt, _ = _rule(rule)
    slots = []
    for spec in sopt.slots:
        t = draw(n, scale=1e-2)
        if spec.name in ("v", "k1", "k2"):
            t = t.abs()
        slots.append(t.to(spec.resolve_dtype(dtype)))
    rows = P if tier == "dcn" else 1
    return g, p, tuple(slots), draw(rows * n, scale=1e-4)


@pytest.mark.parametrize("case", CODEC_CASES,
                         ids=["-".join(map(str, c)) for c in CODEC_CASES])
def test_int8_tiers_equal_eager_reference_codec(case):
    tier, P, D, rule, dt, win = case
    g, p, slots, res = codec_inputs(case)
    dtype = getattr(torch, dt)
    group = plan(StackedComm(P * D, P), "hierarchical", dtype)
    assert effective_windows(group, win) == win
    want_p, want_s, want_r = codec_reference(tier, P, D, rule, g, p, slots,
                                             res, win)
    p2, s2, r2 = port_exchange("hierarchical", P, D, rule, dtype, win, tier,
                               g.clone(), p, tuple(s.clone() for s in slots),
                               residual=res.clone())
    assert p2.dtype == dtype and r2.dtype == torch.float32
    np.testing.assert_array_equal(p2.float().numpy(), want_p)
    for a, b in zip(s2, want_s):
        np.testing.assert_array_equal(a.float().numpy(), b)
    np.testing.assert_array_equal(r2.numpy(), want_r)
    if tier != "dcn" or P > 1:
        assert float(r2.abs().max()) > 0       # error feedback engaged
    else:
        assert torch.equal(r2, res), "one pod passes its residual through"
