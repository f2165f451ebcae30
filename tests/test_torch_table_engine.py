"""The port's table-mode engine and EPS tail against the JAX package.

Both engines run the JAX CLI's default search with a pinned subproblem
power, stack depth and fixpoint cap (calibration off) and the (D, V)
layout. After ``init_state`` and after 1, 7 and 40 steps every
``SearchState`` field the port carries must be equal, the table planes
included (tolerance zero; bot-lane stores excepted, see
``test_torch_engine``); ``solve`` must give equal statistics at cap
10000 and at cap 2, which holds lanes that the capped fixpoint leaves
unconverged. Stack steal and tail resplit are timed by the wall clock,
so they are off for that comparison and held equal on their own, on
the same drained state. With them on, the default ``solve`` must agree
with the numpy oracle.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
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
from turbo_tpu_torch.solver.convert import search_state_to_numpy
from turbo_tpu_torch.solver.engine import (IDLE, SOLVE, STEAL_FIELDS,
                                           BatchedSolver, open_branch_count)

CASES = {
    "rand10": (random_model(10, n_vars=8, n_cons=22),
               dict(num_dives=8, subproblems_power=4)),
    "rand12_eps": (random_model(12, n_vars=9, n_cons=26),
                   dict(num_dives=8, subproblems_power=5, seed=4,
                        eps_var_order="first_fail")),
    "golomb6": (golomb(6), dict(num_dives=8, subproblems_power=6)),
}


def _solvers(text, kw):
    kw = dict(kw, max_depth=96, fp_max_iters=10000, use_table=True,
              fp_cap_auto=False)
    js = JaxSolver(jax_compile(jax_parse(text)),
                   JaxConfig(fp_layout="dv", **kw))
    ts = BatchedSolver(compile_model(parse_fzn_text(text)), EngineConfig(**kw),
                       device="cpu")
    return js, ts


@functools.lru_cache(maxsize=None)
def _pair(name):
    """One JAX and one port solver per case (the JAX step program
    compiles once per solver)."""
    return _solvers(*CASES[name])


def _no_tail(monkeypatch, *solvers):
    for s in solvers:
        monkeypatch.setattr(s, "_steal_open_branches", lambda *a, **k: None)
        monkeypatch.setattr(s, "_tail_resplit", lambda *a, **k: None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_table_state_after_steps_matches_jax(name):
    js, ts = _pair(name)
    jst, tst = js.init_state(), ts.init_state()
    assert tst.tab_lb.shape == (ts._table.n_pad, ts.plan.V)
    _assert_same_state(jst, tst, "init")
    done = 0
    for n in (1, 7, 40):
        jst = js.make_step_n(n - done)(jst)
        tst, _ = ts.run_steps(tst, n - done)
        done = n
        _assert_same_state(jst, tst, f"after {n} steps")


@pytest.mark.parametrize("cap", [10000, 2])
@pytest.mark.parametrize("name", sorted(CASES))
def test_table_solve_matches_jax_and_oracle(name, cap, monkeypatch):
    js, ts = _pair(name)
    _no_tail(monkeypatch, js, ts)
    rj = js.solve(chunk=16, fp_cap=cap)
    rt = ts.solve(chunk=16, fp_cap=cap)
    for k in STATS + ("eps_num_subproblems", "eps_redistributions"):
        assert getattr(rt, k) == getattr(rj, k), k
    assert rj.table_build_time > 0 and rt.table_build_time > 0
    assert rt.dive_time >= rt.table_build_time
    ro = oracle_solve(ts.tnf, timeout_s=60)
    assert (rt.status, rt.objective) == (ro.status, ro.objective)
    if name == "golomb6":
        assert (rt.status, rt.objective) == ("optimal", GOLOMB_OPT[6])


# (model, config, condition the drained state must meet)
TAIL_CASES = {
    "golomb6": (golomb(6), dict(num_dives=16, subproblems_power=4)),
    "golomb7": (golomb(7), dict(num_dives=16, subproblems_power=4)),
    "golomb6_k3": (golomb(6), dict(num_dives=16, subproblems_power=3)),
}


@functools.lru_cache(maxsize=None)
def _drained(name):
    """Port solvers stepped to the first drained state with at least
    3/4 of the lanes idle and an open branch left, and that state in
    numpy."""
    js, ts = _solvers(*TAIL_CASES[name])
    D = ts.cfg.num_dives
    st = ts.init_state()
    for _ in range(2000):
        ph = st.phase.numpy()
        if (int(st.next_sub[0]) >= int(st.sub_limit[0])
                and (ph == IDLE).sum() >= 3 * D // 4
                and int(open_branch_count(st.dec_cur, st.depth,
                                          st.phase)) > 0):
            return js, ts, search_state_to_numpy(st)
        st = ts.step(st)
    raise AssertionError(f"{name}: no drained state with open branches")


def _jax_state(js, fields):
    """The port's state as a JAX SearchState (JAX-only fields from a
    fresh JAX state)."""
    base = js.init_state()
    return base._replace(**{k: jnp.asarray(v) for k, v in fields.items()})


def _both(js, ts, fields, method):
    from turbo_tpu_torch.solver.convert import search_state_from_numpy
    phase = fields["phase"].copy()
    want = getattr(js, method)(_jax_state(js, fields), phase)
    got = getattr(ts, method)(search_state_from_numpy(fields, "cpu"), phase)
    return want, got


@pytest.mark.parametrize("name", sorted(TAIL_CASES))
def test_open_branch_count_matches_jax(name):
    js, ts, fields = _drained(name)
    from turbo_tpu_torch.solver.convert import search_state_from_numpy
    st = search_state_from_numpy(fields, "cpu")
    want = int(jax.device_get(js._open_branch_counter()(
        jnp.asarray(fields["dec_cur"]), jnp.asarray(fields["depth"]),
        jnp.asarray(fields["phase"]))))
    assert want > 0
    assert int(open_branch_count(st.dec_cur, st.depth, st.phase)) == want
    # Lanes outside SOLVE phase do not count.
    off = dict(fields, phase=np.where(fields["phase"] == SOLVE, IDLE,
                                      fields["phase"]).astype(np.int32))
    st2 = search_state_from_numpy(off, "cpu")
    assert int(open_branch_count(st2.dec_cur, st2.depth, st2.phase)) == 0


@pytest.mark.parametrize("method", ["_steal_open_branches", "_tail_resplit"])
@pytest.mark.parametrize("name", sorted(TAIL_CASES))
def test_steal_and_resplit_match_jax(name, method):
    js, ts, fields = _drained(name)
    want, got = _both(js, ts, fields, method)
    assert want is not None and got is not None
    assert want[1] == got[1] > 0
    _assert_same_state(want[0], got[0], method)
    assert not np.array_equal(search_state_to_numpy(got[0])["phase"],
                              fields["phase"])


@pytest.mark.parametrize("method", ["_steal_open_branches", "_tail_resplit"])
@pytest.mark.parametrize("name", sorted(TAIL_CASES))
def test_steal_and_resplit_are_in_place(name, method):
    """Both rounds return the state they were given, every field in its
    own memory (the same ``data_ptr()``, so a CUDA state keeps its
    StepView and its chunk's CUDA graph), and still equal JAX's."""
    import dataclasses

    from turbo_tpu_torch.solver.convert import search_state_from_numpy
    js, ts, fields = _drained(name)
    st = search_state_from_numpy(fields, "cpu")
    ptrs = {f.name: getattr(st, f.name).data_ptr()
            for f in dataclasses.fields(st)}
    phase = fields["phase"].copy()
    got = getattr(ts, method)(st, phase)
    want = getattr(js, method)(_jax_state(js, fields), phase)
    assert got is not None and got[0] is st and got[1] == want[1]
    assert {f: getattr(st, f).data_ptr() for f in ptrs} == ptrs
    _assert_same_state(want[0], st, method)


@functools.lru_cache(maxsize=None)
def _golomb8_d64():
    """golomb(8) at D=64 over 2^4 subproblems (the drain-forcing case of
    chip_smoke.py phase 8) after 10 steps: drained, 49 lanes idle, 30
    open branches on 15 SOLVE lanes."""
    s = BatchedSolver(compile_model(parse_fzn_text(golomb(8))),
                      EngineConfig(num_dives=64, subproblems_power=4,
                                   fp_cap_auto=False), device="cpu")
    st, _ = s.run_steps(s.init_state(), 10)
    assert int(st.next_sub[0]) >= int(st.sub_limit[0])
    return search_state_to_numpy(st)


@pytest.mark.parametrize("name", sorted(TAIL_CASES) + ["golomb8_d64"])
def test_steal_kernel_emulation_matches_host_steal(name):
    """K5's plan and K9's steals as transliterated
    (``test_torch_kernels.emulate_open_count``, ``emulate_steal``) and
    the plain torch versions equal the host steal on drained states of
    the solver: ``TAIL_CASES`` and golomb(8) at D=64 over 2^4."""
    from test_torch_kernels import steal_rounds_agree
    fields = (_golomb8_d64() if name == "golomb8_d64"
              else _drained(name)[2])
    n = steal_rounds_agree({k: fields[k].copy() for k in STEAL_FIELDS},
                           name)
    assert n > 0


def test_steal_without_idle_lanes_or_open_branches_is_none():
    js, ts, fields = _drained("golomb6")
    busy = dict(fields, phase=np.full_like(fields["phase"], SOLVE))
    closed = dict(fields, dec_cur=np.ones_like(fields["dec_cur"]))
    for f in (busy, closed):
        want, got = _both(js, ts, f, "_steal_open_branches")
        assert want is None and got is None


def _lin_model(rng):
    """A small random model (the pattern of tests/test_engine.py's
    stealing test): D = 8 lanes over 2^1 subproblems drain at once."""
    n = 4
    lines = [f"var {rng.integers(-4, 0)}..{rng.integers(3, 8)}: x{i};"
             for i in range(n)]
    for _ in range(3):
        cs = ",".join(str(int(v)) for v in rng.integers(-3, 4, size=n))
        xs = ",".join(f"x{i}" for i in range(n))
        lines.append(f"constraint int_lin_le([{cs}], [{xs}], "
                     f"{int(rng.integers(-4, 18))});")
    lines.append("constraint int_times(x0, x1, x2);")
    lines.append(f"solve minimize x{int(rng.integers(0, n))};")
    return "\n".join(lines)


def test_default_solve_with_steal_and_resplit_matches_oracle():
    rng = np.random.default_rng(23)
    redistributed = 0
    for trial in range(6):
        text = _lin_model(rng)
        tnf = compile_model(parse_fzn_text(text))
        ro = oracle_solve(tnf, timeout_s=30)
        s = BatchedSolver(tnf, EngineConfig(num_dives=8, subproblems_power=1,
                                            max_depth=64),
                          device="cpu")
        assert s.use_table and s.cfg.fp_cap_auto
        r = s.solve(timeout_s=60, chunk=4)
        assert (r.status, r.objective) == (ro.status, ro.objective), trial
        if r.exhaustive:
            assert (r.eps_solved_subproblems + r.eps_skipped_subproblems
                    == r.eps_num_subproblems == 2), trial
        redistributed += r.eps_redistributions
    assert redistributed > 0  # the tail path ran

