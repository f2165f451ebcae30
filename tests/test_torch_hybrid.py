"""The port's hybrid solver against ``turbo_tpu.solver.hybrid``.

Both run the same host search (cubes, EPS accounting, branch and bound)
around batched propagation, so with the same configuration every
statistic must be equal (tolerance zero), under ``node_limit`` too: AC-1
and WAC1, optimisation and satisfaction, ``enumerate_all`` on queens(6),
and the resume from the solver's own checkpoint.
"""
import os

import numpy as np
import pytest

from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.fzn import parse_fzn_text as jax_parse
from turbo_tpu.solver.engine import EngineConfig as JaxConfig
from turbo_tpu.solver.hybrid import HybridSolver as JaxHybrid
from turbo_tpu.solver.oracle import solve as oracle_solve
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.instances import (GOLOMB_OPT, QUEENS_COUNT, golomb,
                                       queens, random_model)
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.hybrid import HybridSolver

STATS = ("status", "objective", "exhaustive", "nodes", "fails", "solutions",
         "depth_max", "fixpoint_iterations", "num_deductions",
         "eps_num_subproblems", "eps_solved_subproblems",
         "eps_skipped_subproblems", "num_blocks", "num_blocks_done")
MODELS = {
    "golomb5": (golomb(5), dict(num_dives=4, subproblems_power=3)),
    "golomb6": (golomb(6), dict(num_dives=6, subproblems_power=5)),
    "rand10": (random_model(10, n_vars=8, n_cons=22),
               dict(num_dives=4, subproblems_power=4)),
    "rand12_eps": (random_model(12, n_vars=9, n_cons=26),
                   dict(num_dives=5, subproblems_power=4, seed=4,
                        eps_var_order="first_fail")),
    "rand13_probe": (random_model(13, n_vars=8, n_cons=22),
                     dict(num_dives=4)),  # k from the root-tree probe
}
FP = {"ac1": dict(), "wac1": dict(fp_mode="wac1"),
      "wac1_inner1": dict(fp_mode="wac1", wac1_inner_cap=1),
      "wac1_below_threshold": dict(fp_mode="wac1", wac1_threshold=10 ** 6)}


def _solvers(text, kw):
    kw = dict(kw, max_depth=96)
    js = JaxHybrid(jax_compile(jax_parse(text)), JaxConfig(**kw))
    ts = HybridSolver(compile_model(parse_fzn_text(text)), EngineConfig(**kw),
                      device="cpu")
    return js, ts


def _same(rj, rt):
    for k in STATS:
        assert getattr(rt, k) == getattr(rj, k), k
    if rj.best_lb is None:
        assert rt.best_lb is None
    else:
        np.testing.assert_array_equal(rt.best_lb, rj.best_lb)


@pytest.mark.parametrize("fp", sorted(FP))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_hybrid_matches_jax(name, fp):
    text, kw = MODELS[name]
    js, ts = _solvers(text, dict(kw, **FP[fp]))
    assert ts.k == js.k
    assert ts.wac1 == (fp in ("wac1", "wac1_inner1"))
    rj, rt = js.solve(), ts.solve()
    _same(rj, rt)
    ro = oracle_solve(ts.tnf, timeout_s=60)
    assert (rt.status, rt.objective) == (ro.status, ro.objective)
    if name.startswith("golomb"):
        assert (rt.status, rt.objective) == ("optimal",
                                             GOLOMB_OPT[int(name[-1])])


@pytest.mark.parametrize("fp", ["ac1", "wac1"])
@pytest.mark.parametrize("limit", [1, 25, 60])
def test_hybrid_under_node_limit_matches_jax(limit, fp):
    text, kw = MODELS["golomb6"]
    js, ts = _solvers(text, dict(kw, **FP[fp]))
    rj, rt = js.solve(node_limit=limit), ts.solve(node_limit=limit)
    _same(rj, rt)
    assert not rt.exhaustive and limit <= rt.nodes < limit + ts.cfg.num_dives


@pytest.mark.parametrize("fp", ["ac1", "wac1"])
def test_hybrid_enumerates_all_queens(fp):
    kw = dict(num_dives=4, subproblems_power=3, enumerate_all=True, **FP[fp])
    js, ts = _solvers(queens(6), kw)
    seen_j, seen_t = [], []
    rj = js.solve(stop_after_n_solutions=0,
                  on_improve=lambda s: seen_j.append(tuple(s)))
    rt = ts.solve(stop_after_n_solutions=0,
                  on_improve=lambda s: seen_t.append(tuple(s)))
    _same(rj, rt)
    assert rt.solutions == QUEENS_COUNT[6] == len(set(seen_t))
    assert seen_t == seen_j
    # Satisfaction without -a stops at the first solution.
    js1, ts1 = _solvers(queens(6), dict(num_dives=4, subproblems_power=3,
                                        **FP[fp]))
    r1j, r1t = js1.solve(), ts1.solve()
    _same(r1j, r1t)
    assert (r1t.status, r1t.solutions, r1t.exhaustive) == ("sat", 1, False)


def test_hybrid_unsat_and_root_unsat():
    text = """
var 1..3: x; var 1..3: y; var 1..3: z;
constraint int_lt(x, y); constraint int_lt(y, z); constraint int_lt(z, x);
solve satisfy;
"""
    js, ts = _solvers(text, dict(num_dives=4, subproblems_power=2))
    rj, rt = js.solve(), ts.solve()
    assert rt.status == rj.status == "unsat"
    if not ts.plan.root_unsat:
        _same(rj, rt)


def test_hybrid_streams_improving_solutions():
    text, kw = MODELS["golomb6"]
    js, ts = _solvers(text, kw)
    got_j, got_t = [], []
    js.solve(on_improve=lambda s: got_j.append(list(s)))
    rt = ts.solve(on_improve=lambda s: got_t.append(list(s)))
    assert got_t == got_j and len(got_t) == rt.solutions >= 1
    assert got_t[-1] == list(rt.best_lb)


def test_hybrid_one_round_is_fp_then_post(monkeypatch):
    """A round is one propagation call and one classification call on
    the (C_active, V) batch."""
    text, kw = MODELS["golomb5"]
    _, ts = _solvers(text, kw)
    calls = []
    fp, post = ts._fp, ts._post
    monkeypatch.setattr(ts, "_fp", lambda l, u: calls.append(
        ("fp", tuple(l.shape))) or fp(l, u))
    monkeypatch.setattr(ts, "_post", lambda l, u: calls.append(
        ("post", tuple(l.shape))) or post(l, u))
    r = ts.solve()
    assert r.status == "optimal"
    kinds = [c[0] for c in calls]
    assert kinds == ["fp", "post"] * (len(calls) // 2)
    assert all(1 <= c[1][0] <= ts.cfg.num_dives and c[1][1] == ts.plan.V
               for c in calls)
    assert len({c[1][0] for c in calls}) > 1  # the batch size varies


@pytest.mark.parametrize("fp", ["ac1", "wac1"])
def test_hybrid_checkpoint_resume(tmp_path, capsys, fp):
    text, kw = MODELS["golomb6"]
    kw = dict(kw, **FP[fp])
    path = str(tmp_path / "hyb.pkl")
    js, ts = _solvers(text, kw)
    full = ts.solve()
    r1 = ts.solve(node_limit=40, checkpoint_path=path)
    assert r1.status in ("unknown", "sat") and r1.nodes >= 40
    assert os.path.exists(path)
    # Resumed, not restarted: the counters cover both runs, and the
    # cut-and-resumed search is the uncut one.
    _, ts2 = _solvers(text, kw)
    r2 = ts2.solve(checkpoint_path=path)
    assert "resumed hybrid checkpoint" in capsys.readouterr().err
    assert (r2.status, r2.objective) == ("optimal", GOLOMB_OPT[6])
    assert r2.nodes > r1.nodes
    for k in ("nodes", "fails", "fixpoint_iterations",
              "eps_solved_subproblems", "eps_skipped_subproblems"):
        assert getattr(r2, k) == getattr(full, k), k
    # The JAX package's solver resumes the port's file, and the port the
    # JAX package's: the snapshot is the same pickle.
    ts.solve(node_limit=40, checkpoint_path=path)
    rj = js.solve(checkpoint_path=path)
    assert (rj.status, rj.objective, rj.nodes) == ("optimal", GOLOMB_OPT[6],
                                                   full.nodes)
    js.solve(node_limit=40, checkpoint_path=path)
    _, ts3 = _solvers(text, kw)
    r3 = ts3.solve(checkpoint_path=path)
    assert (r3.status, r3.objective, r3.nodes) == ("optimal", GOLOMB_OPT[6],
                                                   full.nodes)
    # A mismatched configuration refuses the snapshot (fresh run).
    ts.solve(node_limit=40, checkpoint_path=path)
    capsys.readouterr()
    _, other = _solvers(text, dict(kw, num_dives=8))
    r4 = other.solve(node_limit=8, checkpoint_path=path)
    assert "could not resume checkpoint" in capsys.readouterr().err
    assert r4.nodes <= 16
