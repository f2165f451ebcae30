"""The port's EPS subproblem table and cap calibrator against the JAX
package.

The same model and configuration (table on, a pinned subproblem power
and stack depth, the (D, V) layout) go through ``turbo_tpu``'s
``build_table`` / ``dive_level`` and the port's. Tolerance is zero:
every ``SubTable`` field but the wall-clock ``build_time`` must be
equal (the port's table planes are tensors, read back with
``.cpu().numpy()``), also on shards whose range starts past 0.
``dive_level`` outputs are compared on the same random inputs:
``bot``, ``ent`` and ``iters`` on every row, the rest on rows that are
not bot (the JAX fixpoint keeps sweeping a bot row while others
converge, the port freezes it). The calibrators get the same
observation sequences and must take the same decisions.
"""
import collections
import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.fzn import parse_fzn_text as jax_parse
from turbo_tpu.solver import eps_table as jax_eps_table
from turbo_tpu.solver.engine import AutoCapCalibrator as JaxCalibrator
from turbo_tpu.solver.engine import BatchedSolver as JaxSolver
from turbo_tpu.solver.engine import EngineConfig as JaxConfig
from turbo_tpu.solver.oracle import solve as oracle_solve
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.core.ops import INF, NINF
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.instances import GOLOMB_OPT, golomb, random_model
from turbo_tpu_torch.solver import eps_table
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.engine import AutoCapCalibrator, BatchedSolver

CASES = {
    "rand10": (random_model(10, n_vars=8, n_cons=22),
               dict(num_dives=8, subproblems_power=4)),
    "rand12_eps": (random_model(12, n_vars=9, n_cons=26),
                   dict(num_dives=8, subproblems_power=5, seed=4,
                        eps_var_order="first_fail")),
    "golomb6": (golomb(6), dict(num_dives=8, subproblems_power=6)),
}


@functools.lru_cache(maxsize=None)
def _pair(name, fp_mode="fixpoint", num_shards=1):
    """One JAX and one port table-mode solver per case, propagation mode
    and shard count (the JAX dive program compiles once per solver)."""
    text, kw = CASES[name]
    kw = dict(kw, max_depth=96, fp_max_iters=10000, use_table=True,
              fp_cap_auto=False, fp_mode=fp_mode)
    js = JaxSolver(jax_compile(jax_parse(text)),
                   JaxConfig(fp_layout="dv", **kw), num_shards=num_shards)
    ts = BatchedSolver(compile_model(parse_fzn_text(text)), EngineConfig(**kw),
                       device="cpu", num_shards=num_shards)
    assert js.use_table and ts.use_table
    return js, ts


def _assert_same_table(want, got):
    """Every field but ``build_time`` equal, dtypes too; the port's
    tensor fields read back to the host."""
    assert want is not None and got is not None
    for f in eps_table.SubTable.__dataclass_fields__:
        if f == "build_time":
            continue
        w, g = getattr(want, f), getattr(got, f)
        if isinstance(g, torch.Tensor):
            g = g.cpu().numpy()
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            assert w.dtype == g.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, (f, g, w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_table_matches_jax(name):
    js, ts = _pair(name)
    want, got = js.get_table(0), ts.get_table()
    _assert_same_table(want, got)
    assert got.solved + got.skipped + got.n_live == 1 << ts.k
    assert got.build_time > 0


# (case, shards, shard) -> what its leaf level holds: live rows from
# several chunks, then padding ("padded"); live rows only ("full"); no
# live row, every parent pruned ("empty").
SHARDED = {("golomb6", 3, 1): "padded", ("golomb6", 3, 2): "padded",
           ("golomb6", 2, 1): "full", ("rand12_eps", 2, 0): "empty"}


@pytest.mark.parametrize("name,num_shards,shard", sorted(SHARDED))
def test_build_table_leaf_order_matches_jax(name, num_shards, shard,
                                            monkeypatch):
    """A shard's table against JAX's where the leaf level's row order has
    something to get wrong: the shard's range does not start at 0, the
    last propagated level is wider than W (its parents lie in several
    chunks), padding rows follow the live ones, or none are live."""
    js, ts = _pair(name, num_shards=num_shards)
    seen = []
    leaf = eps_table.table_leaf
    monkeypatch.setattr(eps_table, "table_leaf", lambda chunks, rows, *a: (
        seen.append((len(chunks), rows)), leaf(chunks, rows, *a))[1])
    got = ts.get_table(shard)
    _assert_same_table(js.get_table(shard), got)
    (n_chunks, rows), = seen
    assert len(rows) == got.n_live
    base, limit = eps_table.shard_range(ts, shard)
    assert (rows[:, 3] >= base).all() and (rows[:, 3] < limit).all()
    kind = SHARDED[name, num_shards, shard]
    if kind == "empty":
        assert got.n_live == 0
        return
    assert base > 0 and n_chunks > 1 and len(set(rows[:, 0].tolist())) > 1
    assert (got.n_live < got.n_pad) == (kind == "padded") and got.n_live > 0


def test_init_state_copies_the_table():
    """A state's table rows are its own: writing into them in place (as a
    rebalance or a checkpoint restore does) leaves the cached table, and
    the next state of the shard seeds from the table as built."""
    _, ts = _pair("golomb6")
    tb = ts.get_table()
    built = [t.clone() for t in (tb.lb, tb.ub, tb.strat, tb.path)]
    names = ("tab_lb", "tab_ub", "tab_strat", "tab_path")
    st = ts.init_state()
    for f in names:
        getattr(st, f).fill_(-7)
    st2 = ts.init_state()
    for f, t, w in zip(names, (tb.lb, tb.ub, tb.strat, tb.path), built):
        assert torch.equal(t, w), f
        assert torch.equal(getattr(st2, f), w), f
    m = min(tb.n_live, ts.cfg.num_dives)
    assert m > 0
    for f in ("lb", "root_lb"):
        assert torch.equal(getattr(st2, f)[:m], built[0][:m]), f
    for f in ("ub", "root_ub"):
        assert torch.equal(getattr(st2, f)[:m], built[1][:m]), f
    assert torch.equal(st2.strat[:m], built[2][:m])
    assert torch.equal(st2.subp[:m], built[3][:m])


def _dive_inputs(ts, seed):
    """Random parent stores (narrowed root boxes, one bot row), branch
    variables, child intervals (some neutral), parent indices and bits."""
    rng = np.random.default_rng(seed)
    plan, W = ts.plan, ts.cfg.num_dives
    lb = np.tile(plan.lb0, (W, 1)).astype(np.int32)
    ub = np.tile(plan.ub0, (W, 1)).astype(np.int32)
    for d in range(W):
        for v in rng.choice(plan.n_active, size=3, replace=False):
            if lb[d, v] < ub[d, v]:
                lo = rng.integers(lb[d, v], ub[d, v] + 1)
                lb[d, v], ub[d, v] = lo, rng.integers(lo, ub[d, v] + 1)
    lb[1, 0] = ub[1, 0] + 1
    var = rng.integers(0, plan.n_active, W).astype(np.int32)
    lo, hi = lb[np.arange(W), var], ub[np.arange(W), var]
    mid = lo + (hi - lo) // 2
    c0l, c0u, c1l, c1u = lo, mid, mid + 1, hi
    neutral = rng.random(W) < 0.25
    c0l, c1l = (np.where(neutral, NINF, c).astype(np.int32) for c in (c0l, c1l))
    c0u, c1u = (np.where(neutral, INF, c).astype(np.int32) for c in (c0u, c1u))
    strat = rng.integers(0, len(ts.dp.strat_ids) + 1, W).astype(np.int32)
    pidx = rng.integers(0, W, W).astype(np.int32)
    pbit = rng.integers(0, 2, W).astype(np.int32)
    return lb, ub, strat, var, c0l, c0u, c1l, c1u, pidx, pbit


@pytest.mark.parametrize("name,fp_mode", [
    pytest.param(n, m, id=n if m == "fixpoint" else f"{n}-{m}")
    for m in ("fixpoint", "wac1") for n in sorted(CASES)])
def test_dive_level_matches_jax(name, fp_mode):
    """The port's dive_level (its plain version on the CPU) against JAX's
    dive program, under the default AC-1 fixpoint and under WAC1."""
    js, ts = _pair(name, fp_mode)
    prog = jax_eps_table._make_programs(js)["dive"]
    for seed in range(3):
        args = _dive_inputs(ts, seed)
        want = [np.asarray(a) for a in prog(*map(jnp.asarray, args))]
        got = [a.numpy() for a in eps_table.dive_level(
            ts, *map(torch.as_tensor, args))]
        assert len(got) == len(want) == 13
        bot = want[8]
        assert bot.any()
        for i in (8, 9, 11):  # bot, ent, iters
            np.testing.assert_array_equal(got[i], want[i], err_msg=str(i))
        for i in (0, 1, 2, 3, 4, 5, 6, 7, 10, 12):
            np.testing.assert_array_equal(got[i][~bot], want[i][~bot],
                                          err_msg=str(i))


def test_embed_plain_matches_the_numpy_leaf_embed():
    """The first stage of dive_level on its own (K4's plain version)
    against the numpy embed that build_table applies at the leaf level
    (turbo_tpu/solver/eps_table.py:342-349): rows copy their parent and
    meet one bound."""
    _, ts = _pair("golomb6")
    lb, ub, strat, var, c0l, c0u, c1l, c1u, pidx, pbit = _dive_inputs(ts, 7)
    got = [a.numpy() for a in eps_table.embed_plain(*map(
        torch.as_tensor, (lb, ub, strat, var, c0l, c0u, c1l, c1u, pidx,
                          pbit)))]
    rows = np.arange(len(pidx))
    want_l, want_u = lb[pidx].copy(), ub[pidx].copy()
    vp = var[pidx]
    cl = np.where(pbit == 1, c1l[pidx], c0l[pidx])
    cu = np.where(pbit == 1, c1u[pidx], c0u[pidx])
    want_l[rows, vp] = np.maximum(want_l[rows, vp], cl)
    want_u[rows, vp] = np.minimum(want_u[rows, vp], cu)
    for g, w in zip(got, (want_l, want_u, strat[pidx])):
        np.testing.assert_array_equal(g, w)


def test_expired_deadline_falls_back_to_dive_mode():
    text = golomb(6)
    s = BatchedSolver(compile_model(parse_fzn_text(text)),
                      EngineConfig(num_dives=8, subproblems_power=5,
                                   max_depth=96), device="cpu")
    assert s.use_table
    s._table_deadline = time.monotonic() - 1.0
    r = s.solve()
    assert not s.use_table
    assert (r.status, r.objective) == ("optimal", GOLOMB_OPT[6])
    assert r.table_build_time > 0 and r.dive_time >= r.table_build_time
    assert (r.eps_solved_subproblems + r.eps_skipped_subproblems
            == r.eps_num_subproblems == 1 << s.k)
    ro = oracle_solve(s.tnf, timeout_s=60)
    assert (r.status, r.objective) == (ro.status, ro.objective)


def test_table_budget_gate(monkeypatch):
    """TURBO_TPU_TABLE_BUDGET=0 turns the table off, as in JAX."""
    text, kw = CASES["rand10"]
    monkeypatch.setenv("TURBO_TPU_TABLE_BUDGET", "0")
    js = JaxSolver(jax_compile(jax_parse(text)), JaxConfig(**kw))
    ts = BatchedSolver(compile_model(parse_fzn_text(text)), EngineConfig(**kw),
                       device="cpu")
    assert not js.use_table and not ts.use_table
    assert ts.init_state().tab_lb.shape == (1, ts.plan.V)


# -- the cap calibrator -------------------------------------------------

_S = collections.namedtuple("_S", "fp_cap")

# (cap -> nodes/s, chunk durations, chunks observed with skip=True)
SCENARIOS = {
    "rise_then_fall": ({2: 100, 3: 150, 4: 200, 8: 180, 16: 50},
                       [0.5] * 12, ()),
    "falls_at_once": ({2: 1000, 3: 600, 4: 900, 8: 100, 16: 10},
                      [0.5] * 8, ()),
    "flat_picks_larger": ({2: 500, 3: 500, 4: 500, 8: 500, 16: 500},
                          [0.5] * 10, ()),
    "short_chunks_accumulate": ({2: 300, 3: 100, 4: 700, 8: 650, 16: 100},
                                [0.05, 0.05, 0.3, 0.05, 0.05, 0.05, 0.05,
                                 0.2, 0.25, 0.1, 0.1, 0.1, 0.1, 0.5, 0.5,
                                 0.5, 0.5, 0.5], (3, 9)),
}


def _drive(observe, cap, rates, durs, skips):
    nodes, log = 0, []
    for i, dur in enumerate(durs):
        nodes += int(rates[cap] * dur)
        cap, hint = observe(cap, nodes, dur, i == 0, i in skips)
        log.append((cap, hint))
    return log


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("fp_max_iters,override", [(10000, 0), (4, 0),
                                                   (10000, 3)])
def test_calibrator_decisions_match_jax(name, fp_max_iters, override,
                                        monkeypatch):
    monkeypatch.setenv("TURBO_TPU_CAL_SAMPLE_S", "0.4")
    rates, durs, skips = SCENARIOS[name]
    jc = JaxCalibrator(JaxConfig(fp_max_iters=fp_max_iters), override)
    tc = AutoCapCalibrator(EngineConfig(fp_max_iters=fp_max_iters), override)
    cap0 = override or fp_max_iters
    jst = jc.arm(_S(jnp.full((4,), cap0, dtype=jnp.int32)))
    tcap = tc.arm(cap0)
    assert int(jst.fp_cap[0]) == tcap

    def jax_observe(cap, nodes, dur, warmup, skip):
        nonlocal jst
        assert int(jst.fp_cap[0]) == cap
        jst, hint = jc.observe(jst, nodes, dur, warmup, skip=skip)
        return int(jst.fp_cap[0]), hint

    def port_observe(cap, nodes, dur, warmup, skip):
        return tc.observe(cap, nodes, dur, warmup, skip=skip)

    rates = {c: rates.get(c, 1.0) for c in (2, 3, 4, 8, 16, cap0)}
    want = _drive(jax_observe, tcap, rates, durs, skips)
    got = _drive(port_observe, tcap, rates, durs, skips)
    assert got == want
    assert (tc.chosen, tc.rates, tc.done) == (jc.chosen, jc.rates, jc.done)
    if override == 0:
        assert tc.chosen is not None
