"""The port's engine under ``fp_mode="wac1"``, ``"fixed"`` and
``fp_layout="vd"`` against the JAX package's.

Both engines get the same configuration (a pinned subproblem power and
stack depth, no cap calibration), table on and off: after ``init_state``
and after 1, 7 and 40 steps every ``SearchState`` field the port carries
must be equal (tolerance zero; bot-lane stores excepted, see
``test_torch_engine``), and ``solve`` must give equal statistics
uncapped and, where a cap applies, at cap 2.
"""
import functools

import pytest

from test_torch_engine import STATS, _assert_same_state
from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.fzn import parse_fzn_text as jax_parse
from turbo_tpu.solver.engine import BatchedSolver as JaxSolver
from turbo_tpu.solver.engine import EngineConfig as JaxConfig
from turbo_tpu.solver.oracle import solve as oracle_solve
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.instances import GOLOMB_OPT, golomb, random_model
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.engine import AutoCapCalibrator, BatchedSolver

MODELS = {
    "rand10": (random_model(10, n_vars=8, n_cons=22),
               dict(num_dives=8, subproblems_power=4)),
    "rand12_eps": (random_model(12, n_vars=9, n_cons=26),
                   dict(num_dives=8, subproblems_power=5, seed=4,
                        eps_var_order="first_fail")),
    "golomb6": (golomb(6), dict(num_dives=8, subproblems_power=6)),
}
# name: (JAX keywords, port keywords); the JAX engine's "dv" fixpoint is
# the reference of the port's "vd" route.
MODES = {
    "wac1": (dict(fp_mode="wac1", fp_layout="dv"), dict(fp_mode="wac1")),
    "wac1_inner1": (dict(fp_mode="wac1", fp_layout="dv", wac1_inner_cap=1),
                    dict(fp_mode="wac1", wac1_inner_cap=1)),
    "fixed": (dict(fp_mode="fixed", fp_layout="dv"), dict(fp_mode="fixed")),
    "fixed3": (dict(fp_mode="fixed", fp_layout="dv", fp_fixed_iters=3),
               dict(fp_mode="fixed", fp_fixed_iters=3)),
    "vd": (dict(fp_layout="vd"), dict(fp_layout="vd")),
    "vd_vs_dv": (dict(fp_layout="dv"), dict(fp_layout="vd")),
}
ENGINE_CASES = ([(m, mode, table) for m in sorted(MODELS)
                 for mode in ("fixed", "vd", "wac1") for table in (True, False)]
                + [("golomb6", mode, True)
                   for mode in ("fixed3", "vd_vs_dv", "wac1_inner1")])


@functools.lru_cache(maxsize=None)
def _engines(model, mode, table):
    text, kw = MODELS[model]
    kw = dict(kw, max_depth=96, fp_max_iters=10000, use_table=table,
              fp_cap_auto=False)
    jkw, tkw = MODES[mode]
    js = JaxSolver(jax_compile(jax_parse(text)), JaxConfig(**kw, **jkw))
    ts = BatchedSolver(compile_model(parse_fzn_text(text)),
                       EngineConfig(**kw, **tkw), device="cpu")
    for s in (js, ts):  # timed by the wall clock: off on both sides
        s._steal_open_branches = lambda *a, **k: None
        s._tail_resplit = lambda *a, **k: None
    return js, ts


@pytest.mark.parametrize("model,mode,table", ENGINE_CASES)
def test_state_after_steps_matches_jax(model, mode, table):
    js, ts = _engines(model, mode, table)
    # "fixed" builds no table: the build needs true fixpoints.
    assert ts.use_table == js.use_table == (table and "fixed" not in mode)
    jst, tst = js.init_state(), ts.init_state()
    _assert_same_state(jst, tst, "init")
    done = 0
    for n in (1, 7, 40):
        jst = js.make_step_n(n - done)(jst)
        tst, _ = ts.run_steps(tst, n - done)
        done = n
        _assert_same_state(jst, tst, f"after {n} steps")


@pytest.mark.parametrize("model,mode,table", ENGINE_CASES)
def test_solve_matches_jax_and_oracle(model, mode, table):
    js, ts = _engines(model, mode, table)
    caps = (0,) if "fixed" in mode else (0, 2)
    for cap in caps:
        rj = js.solve(chunk=16, fp_cap=cap)
        rt = ts.solve(chunk=16, fp_cap=cap)
        for k in STATS + ("eps_num_subproblems",):
            assert getattr(rt, k) == getattr(rj, k), (k, cap)
    ro = oracle_solve(ts.tnf, timeout_s=60)
    assert (rt.status, rt.objective) == (ro.status, ro.objective)
    if model == "golomb6":
        assert (rt.status, rt.objective) == ("optimal", GOLOMB_OPT[6])


def test_wac1_threshold_falls_back_to_ac1():
    text, kw = MODELS["golomb6"]
    kw = dict(kw, max_depth=96, fp_cap_auto=False, fp_mode="wac1")
    tnf = compile_model(parse_fzn_text(text))
    props = BatchedSolver(tnf, EngineConfig(**kw), device="cpu"
                          ).plan.num_real_props
    below = BatchedSolver(tnf, EngineConfig(wac1_threshold=props + 1, **kw),
                          device="cpu")
    at = BatchedSolver(tnf, EngineConfig(wac1_threshold=props, **kw),
                       device="cpu")
    assert (below.cfg.fp_mode, at.cfg.fp_mode) == ("fixpoint", "wac1")
    js = JaxSolver(jax_compile(jax_parse(text)),
                   JaxConfig(fp_layout="dv", wac1_threshold=props + 1, **kw))
    assert js.cfg.fp_mode == "fixpoint"
    rj, rt = js.solve(fp_cap=10000), below.solve(fp_cap=10000)
    ac1 = BatchedSolver(tnf, EngineConfig(**dict(kw, fp_mode="fixpoint")),
                        device="cpu").solve(fp_cap=10000)
    for k in STATS:
        assert getattr(rt, k) == getattr(rj, k) == getattr(ac1, k), k


def test_calibrator_is_off_for_fixed_sweeps():
    assert AutoCapCalibrator(EngineConfig(fp_mode="fixed"), 0).done
    assert not AutoCapCalibrator(EngineConfig(fp_mode="wac1"), 0).done
    assert AutoCapCalibrator(EngineConfig(fp_mode="wac1"), 4).done


@pytest.mark.parametrize("kw", [dict(fp_mode="ac3"), dict(fp_layout="dd")])
def test_unknown_mode_or_layout_is_refused(kw):
    with pytest.raises(ValueError):
        EngineConfig(**kw)
