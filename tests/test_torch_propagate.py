"""The port's plain propagation rules against the JAX package.

On seeded random models that cover every rule family the plan compiles,
the same randomly narrowed (D=16) stores, made with numpy, go through
``turbo_tpu``'s ``PropagatorKernels.fixpoint`` / ``fixpoint_t`` and the
port's plain ``fixpoint``. Tolerance is zero: everything is int32/int64.
The JAX loop keeps sweeping lanes that went bot while others converge,
so stores are compared on lanes that are not bot; ``bot``, ``iters`` and
``unconv`` on all lanes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.fzn import parse_fzn_text as jax_parse
from turbo_tpu.solver.engine import BatchedSolver as JaxSolver
from turbo_tpu.solver.engine import EngineConfig as JaxConfig
from turbo_tpu.solver.oracle import PropTable
from turbo_tpu.solver.oracle import solve as oracle_solve
from turbo_tpu.solver.propagate_jax import PropagatorKernels as JaxKernels
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.core.ops import NUM_OPS
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.instances import golomb, random_model
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.engine import BatchedSolver

D = 16
SEEDS = [0, 1, 2, 3, 4, 5, 6]


def _model(seed):
    return golomb(5) if seed == 6 else random_model(seed, n_vars=8,
                                                     n_cons=22)


def _stores(plan, tnf, seed):
    """Root box narrowed at random; a lane at a solution (entailed) and
    a lane narrowed to bot. Returns permuted (D, V) int32 planes."""
    rng = np.random.default_rng(seed)
    lb = np.tile(plan.lb0, (D, 1)).astype(np.int32)
    ub = np.tile(plan.ub0, (D, 1)).astype(np.int32)
    sol = oracle_solve(tnf, timeout_s=30).best_lb
    for d in range(D):
        if d == 0 and sol is not None:
            keep = ~plan.dropped
            lb[d, plan.perm[keep]] = ub[d, plan.perm[keep]] = sol[keep]
            continue
        for v in rng.choice(plan.n_active, size=min(plan.n_active, 3),
                            replace=False):
            if lb[d, v] < ub[d, v]:
                lo = rng.integers(lb[d, v], ub[d, v] + 1)
                lb[d, v], ub[d, v] = lo, rng.integers(lo, ub[d, v] + 1)
        if d == 1:
            lb[d, 0] = ub[d, 0] + 1
    return lb, ub


def _pair(seed, **cfg):
    text = _model(seed)
    kw = dict(num_dives=D, subproblems_power=3, max_depth=64)
    kw.update(cfg)
    js = JaxSolver(jax_compile(jax_parse(text)),
                   JaxConfig(use_table=False, fp_cap_auto=False,
                             fp_layout="dv", **kw))
    ts = BatchedSolver(compile_model(parse_fzn_text(text)),
                       EngineConfig(use_table=False, fp_cap_auto=False, **kw),
                       device="cpu")
    return js, ts


def test_models_cover_every_rule_family():
    ops, lin_kinds, conf, E, M = set(), set(), False, 0, 0
    for seed in SEEDS:
        _, ts = _pair(seed)
        p = ts.plan
        n_real = {op: 0 for op in range(NUM_OPS)}
        for op, xs, _, _ in p.groups:
            n_real[op] += int((xs != p.V - 1).sum() if op not in (5, 6)
                              else (xs != p.V - 2).sum())
        ops |= {op for op, n in n_real.items() if n}
        lin_kinds |= {(b.unit, b.fit32) for b in ts.dp.lin}
        conf |= p.conf_idx is not None
        E += len(ts.tnf.elements)
        M += len(ts.tnf.members)
    assert ops == set(range(NUM_OPS))
    assert {u for u, _ in lin_kinds} == {True, False}
    assert {f for _, f in lin_kinds} == {True, False}
    assert conf and E and M


@pytest.mark.parametrize("seed", SEEDS)
def test_fixpoint_matches_jax(seed):
    js, ts = _pair(seed)
    lb, ub = _stores(ts.plan, ts.tnf, seed)
    jk = JaxKernels(js.plan)
    fp, fp_t = jax.jit(jk.fixpoint), jax.jit(jk.fixpoint_t)  # cap traced
    seen_unconv = False
    for cap in (10000, 2):
        want = [np.asarray(a) for a in fp(jnp.asarray(lb), jnp.asarray(ub),
                                          jnp.int32(cap))]
        want_t = [np.asarray(a) for a in fp_t(jnp.asarray(lb.T),
                                              jnp.asarray(ub.T), jnp.int32(cap))]
        got = [a.numpy() for a in ts.kernels.fixpoint(
            torch.as_tensor(lb), torch.as_tensor(ub), cap)]
        bot = (got[0] > got[1]).any(1)
        for jl, ju, ji, jm in (want, (want_t[0].T, want_t[1].T) + tuple(want_t[2:])):
            np.testing.assert_array_equal((jl > ju).any(1), bot)
            np.testing.assert_array_equal(ji, got[2])
            np.testing.assert_array_equal(jm, got[3])
            np.testing.assert_array_equal(jl[~bot], got[0][~bot])
            np.testing.assert_array_equal(ju[~bot], got[1][~bot])
        seen_unconv |= cap == 2 and bool(got[3].any())
        for a, b in ((lb, ub), (got[0], got[1])):
            np.testing.assert_array_equal(
                np.asarray(jk.all_entailed(jnp.asarray(a), jnp.asarray(b))),
                ts.kernels.all_entailed(torch.as_tensor(a), torch.as_tensor(b)).numpy())
            np.testing.assert_array_equal(
                np.asarray(jk.is_bot(jnp.asarray(a), jnp.asarray(b))),
                ts.kernels.is_bot(torch.as_tensor(a), torch.as_tensor(b)).numpy())
    assert seen_unconv or seed == 6  # the cap of 2 leaves lanes unconverged


@pytest.mark.parametrize("seed", SEEDS)
def test_select_and_children_match_jax(seed):
    js, ts = _pair(seed, eps_var_order="first_fail" if seed % 3 == 0
                   else "default")
    lb, ub = _stores(ts.plan, ts.tnf, seed)
    fl, fu = [a.numpy() for a in ts.kernels.fixpoint(
        torch.as_tensor(lb), torch.as_tensor(ub), 10000)[:2]]
    S = len(ts.dp.strat_ids)
    strat = np.random.default_rng(seed).integers(0, S + 1, D).astype(np.int32)
    for a, b in ((lb, ub), (fl, fu)):
        has, var, chosen, valo = (np.asarray(x) for x in js._select(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(strat)))
        lo = np.take_along_axis(a, var[:, None].astype(np.int64), 1)[:, 0]
        hi = np.take_along_axis(b, var[:, None].astype(np.int64), 1)[:, 0]
        kids = [np.asarray(x) for x in js._children(jnp.asarray(valo),
                                                    jnp.asarray(lo),
                                                    jnp.asarray(hi))]
        got = [x.numpy() for x in ts._select(torch.as_tensor(a),
                                             torch.as_tensor(b),
                                             torch.as_tensor(strat))]
        for w, g in zip([has, var, chosen, valo] + kids, got):
            np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("seed", SEEDS)
def test_fixpoint_matches_numpy_oracle(seed):
    """The rules equal the numpy oracle's PropTable.propagate (the
    pattern of tests/test_engine.py:84), on the variables of live
    propagators."""
    _, ts = _pair(seed)
    tnf, plan = ts.tnf, ts.plan
    rng = np.random.default_rng(seed + 100)
    table = PropTable(tnf)
    # Narrow inside the plan's root box (the root fixpoint): the plan
    # dropped root-entailed propagators and folded root-fixed terms.
    lb0, ub0 = plan.store_to_tnf(plan.lb0, plan.ub0)
    lbs, ubs = [], []
    for _ in range(D):
        lb, ub = lb0.copy(), ub0.copy()
        for v in rng.choice(tnf.num_vars, size=min(tnf.num_vars, 4),
                            replace=False):
            if lb[v] < ub[v]:
                lo = rng.integers(lb[v], ub[v] + 1)
                lb[v], ub[v] = lo, rng.integers(lo, ub[v] + 1)
        lbs.append(lb)
        ubs.append(ub)
    lbp = np.tile(plan.lb0, (D, 1)).astype(np.int32)
    ubp = np.tile(plan.ub0, (D, 1)).astype(np.int32)
    keep = ~plan.dropped
    for d in range(D):
        lbp[d, plan.perm[keep]] = lbs[d][keep]
        ubp[d, plan.perm[keep]] = ubs[d][keep]
    gl, gu, _, _ = ts.kernels.fixpoint(torch.as_tensor(lbp),
                                       torch.as_tensor(ubp), 100000)
    gl, gu = gl.numpy(), gu.numpy()
    for d in range(D):
        nl, nu = lbs[d].copy(), ubs[d].copy()
        _, _, bot = table.propagate(nl, nu)
        assert bot == bool((gl[d] > gu[d]).any()), d
        if not bot:
            np.testing.assert_array_equal(gl[d][plan.perm][keep], nl[keep])
            np.testing.assert_array_equal(gu[d][plan.perm][keep], nu[keep])
