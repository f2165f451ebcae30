"""Card groups of the port's sharded solver (``turbo_tpu_torch/parallel/
mesh.py``) against the JAX package's mesh solver.

JAX runs its ``ShardedSolver`` on the 8 virtual CPU devices of
``tests/conftest.py``; the port runs the 8 shards as card groups on the
CPU, each group a state of its own with its own ``BatchedSolver``
(``devices=[["cpu"] * 2] * 4`` and the like), stepped in lockstep with
the plain exchange of the incumbent min and the live flag
(``exchange_plain``, K10's reference). The groupings are 8 x 1, 2 x 4,
4 x 2 and 3 + 5 shards. After ``init_state`` and 1, 7 and 40 steps the
groups' states concatenated in shard order (``global_state``) must
equal JAX's global state in every field, with the table on and off;
``solve`` must give JAX's statistics in the cases where a shard runs
dry and is rebalanced; the per-shard rings must stream the lane groups'
solutions (which ``test_torch_mesh`` holds to JAX's);
a checkpoint must resume across groupings; a table build past its
deadline must leave every group's shards in dive mode. Tolerance zero
throughout. K10 (``csrc/xcard.cu``) and its parity slots are
transliterated below and held to the plain exchange on seeded words.
The JAX solvers are ``test_torch_mesh``'s (``_pair``).
"""
import functools
import time

import jax
import numpy as np
import pytest
import torch

from test_torch_engine import STATS, _assert_same_state
from test_torch_mesh import DRY, PAIRS, RING_KW, S, _pair
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.instances import GOLOMB_OPT, golomb
from turbo_tpu_torch.parallel.mesh import (ShardedSolver, card_groups,
                                           exchange_plain, xcard_plain)
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.engine import DIVE, IDLE, SOLVE

GROUPINGS = {"8x1": [1] * 8, "2x4": [4, 4], "4x2": [2] * 4, "3+5": [3, 5]}
# The state tests' fixpoint cap: lanes the capped fixpoint leaves
# unconverged are held, and the plain fixpoint's sweeps stay few.
CAP = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As in test_torch_mesh: one torch thread for the many tiny ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _devices(grouping):
    return [["cpu"] * n for n in GROUPINGS[grouping]]


@functools.lru_cache(maxsize=None)
def _groups(grouping, use_table):
    """The port's card-group solver of golomb(6) at test_torch_mesh's
    configuration, shared by the tests. The 8 x 1 groups build their
    tables, one shard's each; the other groupings take those (a
    ``SubTable`` is one shard's, whichever solver holds it), which
    saves this file a table build a grouping."""
    js, ts = _pair("golomb6", use_table)
    gs = ShardedSolver(ts.tnf, ts.solver.cfg, devices=_devices(grouping))
    if use_table and grouping != "8x1":
        built = _groups("8x1", True)
        for g in gs.groups:
            g.solver._tables = {i: built.solvers[i].get_table(i) for i in
                                range(g.offset, g.offset + g.n_shards)}
    assert [g.n_shards for g in gs.groups] == GROUPINGS[grouping]
    assert gs.n_shards == S and len(gs.solvers) == len(gs.groups)
    assert gs.solver.use_table == use_table
    assert {s.k for s in gs.solvers} == {ts.solver.k}
    return gs


@functools.lru_cache(maxsize=None)
def _jax_states(use_table):
    """JAX's global state after 0, 1, 7 and 40 steps at cap ``CAP``."""
    from turbo_tpu.solver.engine import AutoCapCalibrator
    js, _ = _pair("golomb6", use_table)
    st = AutoCapCalibrator._set_cap(js.init_state(), CAP)
    out = {0: jax.device_get(st)}
    step = js.make_step_n(1)
    for n in range(1, 41):
        st = step(st)
        if n in (1, 7, 40):
            out[n] = jax.device_get(st)
    return out


@pytest.mark.parametrize("use_table", [True, False], ids=["table", "dive"])
@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_card_groups_state_after_steps_matches_jax(grouping, use_table):
    gs = _groups(grouping, use_table)
    want = _jax_states(use_table)
    st = gs.init_state()
    assert isinstance(st, list) and len(st) == len(gs.groups)
    D = gs.solver.cfg.num_dives
    for g, x in zip(gs.groups, st):
        assert x.phase.shape == (g.n_shards * D,)
        if use_table:
            # Each group's table rows are indexed by its local shard.
            n_pad = g.solver.get_table(g.offset).n_pad
            assert x.tab_lb.shape == (g.n_shards * n_pad, gs.plan.V)
    _assert_same_state(want[0], gs.global_state(st), "init")
    done = 0
    for n in (1, 7, 40):
        st, _ = gs.run_steps(st, n - done, CAP)
        done = n
        _assert_same_state(want[n], gs.global_state(st), f"after {n} steps")


# Solves in which a shard runs dry and is revived (test_torch_mesh's DRY),
# one grouping each; chunks of one step, JAX's program of the state tests.
SOLVES = [("8x1", True, 10000), ("3+5", True, 2), ("2x4", False, 2)]


@pytest.mark.parametrize("grouping,use_table,cap", SOLVES)
def test_card_groups_solve_matches_jax(grouping, use_table, cap):
    assert ("golomb6", use_table, cap) in DRY
    js, _ = _pair("golomb6", use_table)
    gs = _groups(grouping, use_table)
    rj = js.solve(chunk=1, fp_cap=cap)
    rt = gs.solve(chunk=1, fp_cap=cap)
    for k in STATS + ("eps_num_subproblems", "eps_solved_subproblems",
                      "eps_skipped_subproblems", "eps_redistributions"):
        assert getattr(rt, k) == getattr(rj, k), k
    assert rt.eps_redistributions > 0 and gs.rebalance_rounds > 0
    assert (rt.status, rt.objective) == ("optimal", GOLOMB_OPT[6])


def test_card_groups_ring_streams_like_lane_groups():
    """``-a`` and ``-n 2`` through the per-shard rings of 3 + 5 card
    groups: the solution multiset of the 8 lane groups, each solution
    once (``test_torch_mesh.test_sharded_ring_streams_like_jax`` holds
    the lane groups' streams to JAX's mesh; a JAX solver of its own here
    would cost this file a compile)."""
    tnf = compile_model(parse_fzn_text(PAIRS))
    lanes = ShardedSolver(tnf, EngineConfig(**RING_KW), devices=["cpu"] * S)
    cards = ShardedSolver(tnf, EngineConfig(**RING_KW),
                          devices=_devices("3+5"))
    for n in (0, 2):
        got = {"lanes": [], "cards": []}
        for key, s in (("lanes", lanes), ("cards", cards)):
            r = s.solve(timeout_s=120, stop_after_n_solutions=n,
                        on_solution=lambda lb, k=key: got[k].append(
                            tuple(int(v) for v in lb)))
            if n == 0:
                assert r.exhaustive and r.solutions == len(got[key])
        assert got["cards"] == got["lanes"]
        assert len(set(got["cards"])) == len(got["cards"]) == (
            2 if n == 2 else 6)


def test_checkpoint_resumes_across_groupings(tmp_path):
    """A lane-group run cut by ``node_limit`` resumes in 2 x 2 card groups,
    and a card-group run cut the same way resumes as lane groups; both
    close with the uncut run's result."""
    kw = dict(num_dives=4, subproblems_power=5, max_depth=96,
              fp_max_iters=10000, fp_cap_auto=False)
    tnf = compile_model(parse_fzn_text(golomb(5)))

    def lanes():
        return ShardedSolver(tnf, EngineConfig(**kw), devices=["cpu"] * 4)

    def cards():
        return ShardedSolver(tnf, EngineConfig(**kw),
                             devices=[["cpu"] * 2] * 2)

    full = lanes().solve(chunk=1)
    for cut_by, resume_by in ((lanes, cards), (cards, lanes)):
        ck = str(tmp_path / f"{cut_by.__name__}.ckpt")
        cut = cut_by().solve(chunk=1, node_limit=30, checkpoint_path=ck)
        assert not cut.exhaustive and cut.nodes < full.nodes
        res = resume_by().solve(chunk=1, checkpoint_path=ck)
        for k in ("status", "objective", "exhaustive", "nodes", "fails",
                  "solutions", "fixpoint_iterations"):
            assert getattr(res, k) == getattr(full, k), (cut_by, k)
    assert (full.status, full.objective) == ("optimal", GOLOMB_OPT[5])


def test_table_deadline_fallback_leaves_every_group_in_dive_mode():
    """The second group's table build past its deadline drops table mode
    for every group: the first group's shards, built with tables, are
    rebuilt in dive mode too, and the search still proves the
    optimum."""
    tnf = compile_model(parse_fzn_text(golomb(5)))
    gs = ShardedSolver(tnf, EngineConfig(num_dives=4, subproblems_power=5,
                                         max_depth=96),
                       devices=[["cpu"] * 2] * 2)
    assert all(s.use_table for s in gs.solvers)
    gs.solvers[1]._table_deadline = time.monotonic() - 1.0
    st = gs.init_state()
    for s, x in zip(gs.solvers, st):
        assert not s.use_table and not s._tables
        assert x.tab_lb.shape == (2, gs.plan.V)  # a placeholder row a shard
        assert ((x.phase == DIVE) | (x.phase == IDLE)).all()
    r = gs.solve(timeout_s=300, chunk=8)
    assert (r.status, r.objective) == ("optimal", GOLOMB_OPT[5])
    assert r.exhaustive


def test_device_lists_group_by_device():
    """A flat list groups consecutive shards by device (distinct cards:
    a group each; one repeated device: one group); a list of lists is a
    group a list. Non-consecutive shards of a device, a group over two
    devices, mixed forms, device types or nothing raise."""
    cpu = torch.device("cpu")
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert card_groups(["cpu"] * 3) == [(cpu, 3)]
    assert card_groups([["cpu"] * 2] * 3) == [(cpu, 2)] * 3
    assert card_groups(["cuda:0", "cuda:0", "cuda:1"]) == [(c0, 2), (c1, 1)]
    assert card_groups([c1, c0]) == [(c1, 1), (c0, 1)]
    for bad in (["cuda:0", "cuda:1", "cuda:0"], [["cuda:0", "cuda:1"]],
                [["cpu"], "cpu"], ["cpu", "cuda:0"], []):
        with pytest.raises(ValueError):
            card_groups(bad)


# -- K10 and the parity slots, transliterated --------------------------


def publish(slots, par, g, m, live):
    """step.cuh xpublish: group g's (min, live) into slot [par][g] of
    every group's slot array."""
    for arr in slots:
        arr[par, g] = (m, int(live))


def k10(arr, par):
    """csrc/xcard.cu xcard_kernel over one group's array: a lane a slot,
    the min and OR reductions of the warp."""
    n = arr.shape[1]
    m, any_ = [2 ** 31 - 1] * 32, [0] * 32
    for g in range(n):
        m[g % 32] = min(m[g % 32], int(arr[par, g, 0]))
        any_[g % 32] |= int(arr[par, g, 1] != 0)
    return int(any(any_)), min(m)


def run_schedule(words, rng, parity=True):
    """N groups step T times: K7 live (publishing step 0's words), then
    per step K10 and the post (publishing the next step's words). A
    group's K10 of step t may run only after every group's post of step
    t - 1 (K7 live for t = 0), as the streams' event waits order them;
    the host picks the next ready op at random. Returns what each
    group's K10 read, [t][g] = (live, min). ``parity=False``: one slot
    set for every step."""
    T, N = words.shape[:2]
    slots = [np.zeros((2, N, 2), np.int64) for _ in range(N)]
    # Each group runs: live, then (k10 t, post t) for t < T.
    ops = [[("live", 0)] + [(k, t) for t in range(T)
                            for k in ("k10", "post")] for _ in range(N)]
    pos = [0] * N
    posted = [-2] * N   # the last step each group published for
    got = [[None] * N for _ in range(T)]
    while any(p < len(o) for p, o in zip(pos, ops)):
        ready = []
        for g in range(N):
            if pos[g] == len(ops[g]):
                continue
            kind, t = ops[g][pos[g]]
            if kind != "k10" or min(posted) >= t:
                ready.append(g)
        g = ready[rng.integers(len(ready))]
        kind, t = ops[g][pos[g]]
        pos[g] += 1
        par = t % 2 if parity else 0
        if kind == "live":
            publish(slots, 0, g, *words[0, g])
            posted[g] = 0
        elif kind == "k10":
            got[t][g] = k10(slots[g], par)
        elif t + 1 < T:
            publish(slots, (t + 1) % 2 if parity else 0, g, *words[t + 1, g])
            posted[g] = t + 1
        else:
            posted[g] = T
    return got


@pytest.mark.parametrize("n_groups", [2, 3, 5, 33])
def test_k10_parity_slots_equal_the_plain_exchange(n_groups):
    """Every group's K10 reads, at every step, the plain exchange of that
    step's published words (``xcard_plain`` over them, as
    ``exchange_plain`` reduces the groups' states), whatever the
    interleaving the events allow; with one slot set in place of two
    parities a group running a step ahead overwrites words a slower
    group has still to read."""
    rng = np.random.default_rng(n_groups)
    T = 12
    words = np.stack([rng.integers(-50, 1000, size=(T, n_groups)),
                      rng.random((T, n_groups)) < 0.3], axis=2)
    want = []
    for t in range(T):
        slots = torch.zeros((2, n_groups, 2), dtype=torch.int32)
        slots[t % 2] = torch.from_numpy(words[t].astype(np.int32))
        live, m = xcard_plain(slots, t % 2)
        want.append((int(live), int(m)))
    raced = False
    for trial in range(8):
        got = run_schedule(words, rng)
        assert all(got[t][g] == want[t] for t in range(T)
                   for g in range(n_groups)), trial
        one = run_schedule(words, rng, parity=False)
        raced |= any(one[t][g] != want[t] for t in range(T)
                     for g in range(n_groups))
    assert raced


def test_exchange_plain_is_the_batch_min_and_any():
    """``exchange_plain`` over card groups gives the lane-group step's
    incumbent min (best_bound over every lane, met with ext_bound) and
    its live flag."""
    gs = _groups("3+5", True)
    st, _ = gs.run_steps(gs.init_state(), 7)
    g, live = exchange_plain(st, torch.device("cpu"))
    glob = gs.global_state(st)
    assert int(g) == min(int(glob.best_bound.min()), int(glob.ext_bound[0]))
    assert bool(live) == bool((glob.phase != IDLE).any())
    assert bool(live) and ((glob.phase == SOLVE).any())


def test_multihost_solver_takes_card_groups():
    """``MultiHostSolver(devices=...)`` runs a host's shards as card
    groups through the same ``ShardedSolver``: in one process (no
    group) 2 x 2 groups give the statistics of 4 lane groups."""
    from turbo_tpu_torch.parallel.multihost import MultiHostSolver
    tnf = compile_model(parse_fzn_text(golomb(4)))
    cfg = EngineConfig(num_dives=4, subproblems_power=5, max_depth=96,
                       fp_cap_auto=False)
    lanes = MultiHostSolver(tnf, cfg, devices=["cpu"] * 4)
    cards = MultiHostSolver(tnf, cfg, devices=[["cpu"] * 2] * 2)
    assert cards.S == 4 and len(cards.sharded.groups) == 2
    a, b = lanes.solve(chunk=2), cards.solve(chunk=2)
    for k in STATS + ("eps_solved_subproblems", "eps_skipped_subproblems"):
        assert getattr(b, k) == getattr(a, k), k
    assert (b.status, b.objective) == ("optimal", GOLOMB_OPT[4])
