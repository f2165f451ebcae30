"""The port's sharded solver (``turbo_tpu_torch/parallel/mesh.py``)
against the JAX package's mesh solver.

JAX runs its ``ShardedSolver`` on the 8 virtual CPU devices of
``tests/conftest.py``; the port runs 8 lane groups of one state on the
CPU (``devices=["cpu"] * 8``). Both get the same configuration: a
pinned subproblem power, stack depth and fixpoint cap (calibration off),
the (D, V) layout. After ``init_state`` and after 1, 7 and 40 steps
every ``SearchState`` field the port carries must be equal, with the
table on and off (tolerance zero; bot-lane stores excepted, see
``test_torch_engine``); ``solve`` must give equal statistics with a D
and k that leave shards dry, so that ``rebalance_ranges`` runs. Only
in-repo instances are used.
"""
import dataclasses
import functools
import time

import jax
import numpy as np
import pytest

from test_torch_engine import JAX_ONLY, STATS, _assert_same_state
from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.fzn import parse_fzn_text as jax_parse
from turbo_tpu.parallel import mesh as jax_mesh
from turbo_tpu.solver.engine import EngineConfig as JaxConfig
from turbo_tpu.solver.oracle import solve as oracle_solve
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.instances import (GOLOMB_OPT, QUEENS_COUNT, golomb,
                                       queens, random_model)
from turbo_tpu_torch.parallel.mesh import ShardedSolver, rebalance_ranges
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.convert import search_state_to_numpy
from turbo_tpu_torch.solver.engine import DIVE, IDLE, SearchState

S = 8  # the virtual CPU devices of tests/conftest.py
# D = 2 lanes a shard over 2^6 subproblems: the shards' ranges drain at
# different times, so rebalance_ranges runs (see DRY).
CASES = {"golomb6": (golomb(6), {}),
         "rand10": (random_model(10, n_vars=8, n_cons=22), {}),
         "rand12": (random_model(12, n_vars=9, n_cons=26),
                    dict(seed=4, eps_var_order="first_fail"))}
KW = dict(num_dives=2, subproblems_power=6, max_depth=96,
          fp_max_iters=10000, fp_cap_auto=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs many tiny ops; one torch thread keeps them
    from fighting the suite's other workers for the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solvers(text, **kw):
    js = jax_mesh.ShardedSolver(jax_compile(jax_parse(text)),
                                JaxConfig(fp_layout="dv", **kw))
    assert js.n_shards == S
    ts = ShardedSolver(compile_model(parse_fzn_text(text)),
                       EngineConfig(**kw), devices=["cpu"] * S)
    assert ts.solver.use_table == js.solver.use_table == kw["use_table"]
    return js, ts


@functools.lru_cache(maxsize=None)
def _pair(name, use_table):
    """One JAX and one port solver per case, shared by the tests (the
    JAX programs compile once per solver)."""
    text, extra = CASES[name]
    return _solvers(text, use_table=use_table, **KW, **extra)


@pytest.mark.parametrize("use_table", [True, False], ids=["table", "dive"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_state_after_steps_matches_jax(name, use_table):
    js, ts = _pair(name, use_table)
    jst, tst = js.init_state(), ts.init_state()
    D = ts.solver.cfg.num_dives
    assert tst.phase.shape == (S * D,)
    if use_table:
        n_pad = ts.solver.get_table(0).n_pad
        assert tst.tab_lb.shape == (S * n_pad, ts.plan.V)
    _assert_same_state(jst, tst, "init")
    step = js.make_step_n(1)
    done = 0
    for n in (1, 7, 40):
        for _ in range(n - done):
            jst = step(jst)
        tst, _ = ts.run_steps(tst, n - done)
        done = n
        _assert_same_state(jst, tst, f"after {n} steps")
        # The batch-wide incumbent min is the pmin only while ext_bound
        # is the same on every lane.
        ext = tst.ext_bound.numpy()
        assert (ext == ext[0]).all()
    # Each shard's subproblems (table mode: its table's bit-paths) lie
    # in its own range.
    from turbo_tpu_torch.solver.eps_table import shard_range
    got = search_state_to_numpy(ts.init_state())
    seen = 0
    for g in range(S):
        base, limit = shard_range(ts.solver, g)
        if use_table:
            tb = ts.solver.get_table(g)
            paths = got["tab_path"][g * tb.n_pad:g * tb.n_pad + tb.n_live]
        else:
            paths = got["subp"][g * D:(g + 1) * D][
                got["phase"][g * D:(g + 1) * D] != IDLE]
        assert (paths >= base).all() and (paths < limit).all()
        seen += len(paths)
    assert seen > 0


# The solves in which a shard runs dry while another holds two or more
# subproblems (the others end without a rebalance).
DRY = {("golomb6", True, 10000), ("golomb6", True, 2), ("golomb6", False, 2),
       ("rand10", False, 10000), ("rand12", False, 10000)}


@pytest.mark.parametrize("name,use_table,cap", [
    (name, use_table, 10000) for name in sorted(CASES)
    for use_table in (True, False)] + [
    ("golomb6", use_table, 2) for use_table in (True, False)])
def test_sharded_solve_matches_jax_and_oracle(name, use_table, cap):
    """At cap 10000 and, on golomb(6), at cap 2, which holds lanes the
    capped fixpoint leaves unconverged."""
    js, ts = _pair(name, use_table)
    rj = js.solve(chunk=4, fp_cap=cap)
    rt = ts.solve(chunk=4, fp_cap=cap)
    for k in STATS + ("eps_num_subproblems", "eps_redistributions"):
        assert getattr(rt, k) == getattr(rj, k), k
    if (name, use_table, cap) in DRY:
        # A shard ran dry and was revived.
        assert rt.eps_redistributions > 0 and ts.rebalance_rounds > 0
    ro = oracle_solve(ts.tnf, timeout_s=60)
    assert (rt.status, rt.objective) == (ro.status, ro.objective)
    if rt.exhaustive:
        assert (rt.eps_solved_subproblems + rt.eps_skipped_subproblems
                == rt.eps_num_subproblems)
    if name == "golomb6":
        assert (rt.status, rt.objective) == ("optimal", GOLOMB_OPT[6])


def _jax_state(js, fields):
    """The port's fields as a JAX SearchState (JAX-only fields from a
    fresh JAX state)."""
    base = jax.device_get(js.init_state())
    return base._replace(**{k: np.array(v) for k, v in fields.items()})


@pytest.mark.parametrize("use_table", [True, False], ids=["table", "dive"])
def test_rebalance_ranges_matches_jax(use_table):
    js, ts = _pair("golomb6", use_table)
    D = ts.solver.cfg.num_dives
    st, _ = ts.run_steps(ts.init_state(), 1)
    fields = search_state_to_numpy(st)
    # Shards 0 and 5 dry: every lane IDLE, the counter at the limit.
    for g in (0, 5):
        sl = slice(g * D, (g + 1) * D)
        fields["phase"][sl] = IDLE
        fields["next_sub"][sl] = fields["sub_limit"][sl]
    want, wmoves = jax_mesh.rebalance_ranges(
        _jax_state(js, fields), D, S, js.plan.lb0, js.plan.ub0,
        use_table=use_table)
    got, moves = rebalance_ranges(fields, D, S, ts.plan.lb0, ts.plan.ub0,
                                  use_table=use_table)
    assert moves == wmoves == 2
    want = want._asdict()
    assert set(want) - set(got) == JAX_ONLY
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    live = got["phase"][:D] != IDLE
    assert live.any()
    assert (got["phase"][:D][live] == (1 if use_table else DIVE)).all()
    # Nothing moves when no shard is dry.
    busy = dict(fields, phase=np.full_like(fields["phase"], DIVE))
    same, none = rebalance_ranges(busy, D, S, ts.plan.lb0, ts.plan.ub0,
                                  use_table)
    assert none == 0 and same is busy


PAIRS = """
var 1..4: x :: output_var; var 1..4: y :: output_var;
constraint int_lt(x, y);
solve satisfy;
"""
RING_KW = dict(num_dives=2, subproblems_power=4, max_depth=64,
               fp_max_iters=32, enumerate_all=True, sol_ring_size=8)


@pytest.mark.parametrize("model", ["pairs", "queens5"])
def test_sharded_ring_streams_like_jax(model):
    """``-a`` through the per-shard rings: the same solution multiset as
    the JAX mesh, each solution once; ``-n 2`` stops at exactly 2 on
    both (tests/test_round5.py:184-228)."""
    text = PAIRS if model == "pairs" else queens(5)
    tj = jax_compile(jax_parse(text))
    tt = compile_model(parse_fzn_text(text))
    js = jax_mesh.ShardedSolver(tj, JaxConfig(**RING_KW))
    ts = ShardedSolver(tt, EngineConfig(**RING_KW), devices=["cpu"] * S)
    for n in (0, 2):
        got = {"jax": [], "port": []}
        for key, s in (("jax", js), ("port", ts)):
            r = s.solve(timeout_s=120, stop_after_n_solutions=n,
                        on_solution=lambda lb, k=key: got[k].append(
                            tuple(int(v) for v in lb)))
            if n == 0:
                assert r.exhaustive and r.solutions == len(got[key])
        assert sorted(got["port"]) == sorted(got["jax"])
        if n == 2:
            assert len(got["port"]) == 2
        else:
            want = 6 if model == "pairs" else QUEENS_COUNT[5]
            assert len(set(got["port"])) == len(got["port"]) == want


def test_sharded_checkpoint_resume(tmp_path):
    """A sharded solve cut by ``node_limit`` writes its checkpoint; a new
    solver resumes from it and closes with the uncut run's result. A file
    of another shard count is refused."""
    kw = dict(num_dives=4, subproblems_power=5, max_depth=96,
              fp_max_iters=10000, fp_cap_auto=False)
    tnf = compile_model(parse_fzn_text(golomb(6)))

    def solver(shards=4):
        return ShardedSolver(tnf, EngineConfig(**kw), devices=["cpu"] * shards)

    full = solver().solve(chunk=8)
    ck = str(tmp_path / "mesh.ckpt")
    cut = solver().solve(chunk=8, node_limit=60, checkpoint_path=ck)
    assert not cut.exhaustive and cut.nodes < full.nodes
    res = solver().solve(chunk=8, checkpoint_path=ck)
    for k in ("status", "objective", "exhaustive", "nodes", "fails",
              "solutions", "fixpoint_iterations"):
        assert getattr(res, k) == getattr(full, k), k
    assert (res.status, res.objective) == ("optimal", GOLOMB_OPT[6])
    # Another shard count: the file is refused and the run starts fresh.
    other = solver(2)
    from turbo_tpu_torch.solver.checkpoint import load_state
    assert load_state(other.solver, ck, num_shards=2) is None
    assert load_state(solver().solver, ck, num_shards=4) is not None


def test_table_deadline_fallback_leaves_every_shard_in_dive_mode():
    """A table build past its deadline drops table mode for the whole
    run: every shard's state is rebuilt in dive mode (mesh.py:168-182)
    and the search still proves the optimum."""
    tnf = compile_model(parse_fzn_text(golomb(6)))
    s = ShardedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=6,
                                        max_depth=96), devices=["cpu"] * 4)
    assert s.solver.use_table
    s.solver._table_deadline = time.monotonic() - 1.0
    st = s.init_state()
    assert not s.solver.use_table and not s.solver._tables
    assert st.tab_lb.shape == (4, s.plan.V)  # one placeholder row a shard
    assert ((st.phase == DIVE) | (st.phase == IDLE)).all()
    s.solver._table_deadline = time.monotonic() - 1.0
    r = s.solve(timeout_s=300, chunk=8)
    assert (r.status, r.objective) == ("optimal", GOLOMB_OPT[6])
    assert r.exhaustive and r.table_build_time > 0


def test_non_consecutive_devices_raise():
    """A card group's shards are a run of global shards: a flat device
    list whose shards of one device are not consecutive is refused
    before any solver is built."""
    tnf = compile_model(parse_fzn_text(golomb(4)))
    with pytest.raises(ValueError, match="not consecutive"):
        ShardedSolver(tnf, EngineConfig(num_dives=4),
                      devices=["cpu", "meta", "cpu"])


def test_one_shard_equals_the_batched_solver():
    """S = 1: the sharded solver walks what ``BatchedSolver`` walks (the
    step's segmented tail reduces to the single-shard one)."""
    from turbo_tpu_torch.solver.engine import BatchedSolver
    tnf = compile_model(parse_fzn_text(golomb(6)))
    cfg = EngineConfig(**KW)
    ms = ShardedSolver(tnf, cfg, devices=["cpu"])
    bs = BatchedSolver(tnf, cfg, device="cpu")
    a, _ = ms.run_steps(ms.init_state(), 25)
    b, _ = bs.run_steps(bs.init_state(), 25)
    for f in dataclasses.fields(SearchState):
        np.testing.assert_array_equal(getattr(a, f.name).numpy(),
                                      getattr(b, f.name).numpy(), f.name)


def _holds(model, tnf, lb):
    """Whether the printed solution of TNF store ``lb`` satisfies every
    constraint of ``model``."""
    import contextlib
    import io
    import re
    from turbo_tpu_torch.host.utils.checker import Checker
    from turbo_tpu_torch.host.utils.output import print_solution
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_solution(tnf, lb)
    values = {k: int(v) for k, v in
              re.findall(r"^(\w+) = (-?\d+);$", buf.getvalue(), re.M)}
    ck = Checker(model, values)
    return all(ck.holds(c) for c in model.constraints)


@pytest.mark.parametrize("sharded", [False, True], ids=["one", "sharded"])
def test_on_improve_reports_only_solutions(sharded):
    """``on_improve`` fires on a real incumbent only: never with the root
    store of a chunk that found none (the JAX loops start their gate
    above INF, so their first chunk without a solution reports one)."""
    from turbo_tpu_torch.solver.engine import BatchedSolver
    text = golomb(6)
    model = parse_fzn_text(text)
    tnf = compile_model(model)
    cfg = EngineConfig(num_dives=16, subproblems_power=6, max_depth=96,
                       use_table=False, fp_cap_auto=False)
    s = (ShardedSolver(tnf, cfg, devices=["cpu"] * 4) if sharded
         else BatchedSolver(tnf, cfg, device="cpu"))
    got = []
    r = s.solve(chunk=1, on_improve=got.append)
    assert (r.status, r.objective) == ("optimal", GOLOMB_OPT[6])
    assert got and all(_holds(model, tnf, lb) for lb in got)
    objs = [int(lb[tnf.obj_var]) for lb in got]
    assert objs == sorted(set(objs), reverse=True)
    assert objs[-1] == GOLOMB_OPT[6]
