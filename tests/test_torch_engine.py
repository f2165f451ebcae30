"""The port's batched engine against the JAX package, step by step.

Both engines get the same configuration: table off, no cap calibration,
the (D, V) layout, a pinned subproblem power and stack depth, a cap high
enough that no lane is held. After ``init_state`` and after 1, 7 and 40
steps every ``SearchState`` field the port carries must be equal
(tolerance zero; ``JAX_ONLY`` lists the JAX fields the port does not
carry). ``lb``/``ub`` are compared on lanes whose store is not bot
only: the JAX fixpoint keeps sweeping a lane after it went bot while
other lanes converge, the port freezes it; the engine never reads a bot
store (the lane backtracks, refills or idles).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.fzn import parse_fzn_text as jax_parse
from turbo_tpu.solver.engine import BatchedSolver as JaxSolver
from turbo_tpu.solver.engine import EngineConfig as JaxConfig
from turbo_tpu.solver.oracle import solve as oracle_solve
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.instances import GOLOMB_OPT, golomb, random_model
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.convert import (search_state_from_numpy,
                                            search_state_to_numpy)
from turbo_tpu_torch.solver.engine import BatchedSolver, SearchState

CASES = {"rand10": (random_model(10, n_vars=8, n_cons=22), 0),
         "rand11": (random_model(11, n_vars=8, n_cons=22), 0),
         "rand12": (random_model(12, n_vars=9, n_cons=26), 3),
         "rand13": (random_model(13, n_vars=8, n_cons=22), 0),
         "golomb6": (golomb(6), 0)}
# The port keeps the objective and its kind in the plan and the fixpoint
# cap as a host int.
JAX_ONLY = {"obj", "is_opt", "fp_cap"}
STATS = ("status", "objective", "exhaustive", "nodes", "fails", "solutions",
         "depth_max", "fixpoint_iterations", "num_deductions",
         "eps_solved_subproblems", "eps_skipped_subproblems")


@functools.lru_cache(maxsize=None)
def _pair(name):
    """One JAX and one port solver per case, shared by the tests (the
    JAX step program compiles once per solver)."""
    text, eps_seed = CASES[name]
    kw = dict(num_dives=8, subproblems_power=4, max_depth=96,
              fp_max_iters=10000, seed=1 + eps_seed,
              eps_var_order="first_fail" if eps_seed else "default")
    js = JaxSolver(jax_compile(jax_parse(text)),
                   JaxConfig(use_table=False, fp_cap_auto=False,
                             fp_layout="dv", **kw))
    # Stack steal and tail resplit are timed by the wall clock: off on
    # both sides, so that both walk the same steps.
    ts = BatchedSolver(compile_model(parse_fzn_text(text)),
                       EngineConfig(use_table=False, fp_cap_auto=False, **kw),
                       device="cpu")
    for s in (js, ts):
        s._steal_open_branches = lambda *a, **k: None
        s._tail_resplit = lambda *a, **k: None
    return js, ts


def _assert_same_state(jst, tst, where):
    want = {k: np.asarray(v) for k, v in jax.device_get(jst)._asdict().items()}
    got = search_state_to_numpy(tst)
    assert set(want) - set(got) == JAX_ONLY, where
    ok = ~(want["lb"] > want["ub"]).any(axis=1)
    assert np.array_equal(ok, ~(got["lb"] > got["ub"]).any(axis=1)), where
    for f in dataclasses.fields(SearchState):
        w, g = want[f.name], got[f.name]
        assert w.dtype == g.dtype, (where, f.name, w.dtype, g.dtype)
        if f.name in ("lb", "ub"):
            w, g = w[ok], g[ok]
        np.testing.assert_array_equal(g, w, err_msg=f"{where}: {f.name}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_after_steps_matches_jax(name):
    js, ts = _pair(name)
    jst, tst = js.init_state(), ts.init_state()
    _assert_same_state(jst, tst, "init")
    done = 0
    for n in (1, 7, 40):
        jst = js.make_step_n(n - done)(jst)
        tst, _ = ts.run_steps(tst, n - done)
        done = n
        _assert_same_state(jst, tst, f"after {n} steps")


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_matches_jax_and_oracle(name):
    js, ts = _pair(name)
    rj = js.solve(chunk=16)
    rt = ts.solve(chunk=16)
    for k in STATS:
        assert getattr(rt, k) == getattr(rj, k), k
    ro = oracle_solve(ts.tnf, timeout_s=60)
    assert (rt.status, rt.objective) == (ro.status, ro.objective)
    if name == "golomb6":
        assert rt.objective == GOLOMB_OPT[6] and rt.status == "optimal"


def test_state_round_trips_through_numpy():
    js, ts = _pair("rand10")
    st, _ = ts.run_steps(ts.init_state(), 5)
    fields = search_state_to_numpy(st)
    back = search_state_from_numpy(fields, "cpu")
    for k, v in search_state_to_numpy(back).items():
        np.testing.assert_array_equal(v, fields[k])
    # A JAX state converts too (extra JAX-only fields are ignored).
    jst = jax.device_get(js.init_state())._asdict()
    port = search_state_from_numpy(jst, "cpu")
    _assert_same_state(js.init_state(), port, "converted")
