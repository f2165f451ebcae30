"""The port's WAC1, fixed-sweeps and (V, D)-layout propagation against
the JAX package.

The same randomly narrowed (D=16) stores, made with numpy, go through
``fixpoint_wac1``, ``fixed_sweeps`` and ``fixpoint_t`` of ``turbo_tpu``'s
``PropagatorKernels`` (jitted on the CPU) and through the port's
functions. Tolerance is zero: everything is integer. The JAX loops keep
sweeping a lane after it went bot, the port freezes it, so stores are
compared on lanes that are not bot; ``bot``, ``iters`` and ``unconv`` on
all lanes. ``test_torch_wac1_engine.py`` holds the engines in these modes
against each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_propagate import SEEDS, _pair, _stores
from turbo_tpu.solver.propagate_jax import PropagatorKernels as JaxKernels


def _same_propagation(want, got):
    """want: the JAX outputs, got: the port's, both (lb, ub, iters,
    unconv) in numpy."""
    bot = (got[0] > got[1]).any(1)
    np.testing.assert_array_equal((want[0] > want[1]).any(1), bot)
    np.testing.assert_array_equal(want[2], got[2])
    np.testing.assert_array_equal(want[3], got[3])
    np.testing.assert_array_equal(want[0][~bot], got[0][~bot])
    np.testing.assert_array_equal(want[1][~bot], got[1][~bot])
    return bot


@pytest.mark.parametrize("inner_cap", [1, 16])
@pytest.mark.parametrize("seed", SEEDS)
def test_fixpoint_wac1_matches_jax(seed, inner_cap):
    js, ts = _pair(seed)
    lb, ub = _stores(ts.plan, ts.tnf, seed)
    jk = JaxKernels(js.plan)
    fw = jax.jit(lambda l, u, c: jk.fixpoint_wac1(l, u, c, inner_cap))
    for cap in (10000, 2):
        want = [np.asarray(a) for a in fw(jnp.asarray(lb), jnp.asarray(ub),
                                          jnp.int32(cap))]
        got = [a.numpy() for a in ts.kernels.fixpoint_wac1(
            torch.as_tensor(lb), torch.as_tensor(ub), cap, inner_cap)]
        bot = _same_propagation(want, got)
        assert bot.any() and not bot.all()
        if cap == 10000:
            assert not got[3].any()
            # A WAC1 fixpoint is an AC-1 fixpoint: one more AC-1 sweep
            # changes no lane that is not bot.
            l2, u2 = ts.kernels.iteration(torch.as_tensor(got[0]),
                                          torch.as_tensor(got[1]))
            np.testing.assert_array_equal(l2.numpy()[~bot], got[0][~bot])
            np.testing.assert_array_equal(u2.numpy()[~bot], got[1][~bot])


@pytest.mark.parametrize("seed", SEEDS)
def test_fixed_sweeps_matches_jax(seed):
    js, ts = _pair(seed)
    lb, ub = _stores(ts.plan, ts.tnf, seed)
    jk = JaxKernels(js.plan)
    for n in (1, 3):
        want = [np.asarray(a) for a in jax.jit(
            lambda l, u: jk.fixed_sweeps(l, u, n))(jnp.asarray(lb),
                                                   jnp.asarray(ub))]
        got = [a.numpy() for a in ts.kernels.fixed_sweeps(
            torch.as_tensor(lb), torch.as_tensor(ub), n)]
        # No lane is frozen: every store is equal, bot or not.
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
        assert (got[2] == n).all() and not got[3].any()


@pytest.mark.parametrize("seed", SEEDS)
def test_fixpoint_t_matches_jax(seed):
    js, ts = _pair(seed)
    lb, ub = _stores(ts.plan, ts.tnf, seed)
    lbT, ubT = np.ascontiguousarray(lb.T), np.ascontiguousarray(ub.T)
    fp_t = jax.jit(JaxKernels(js.plan).fixpoint_t)
    for cap in (10000, 2):
        want = [np.asarray(a) for a in fp_t(jnp.asarray(lbT),
                                            jnp.asarray(ubT), jnp.int32(cap))]
        got = [a.numpy() for a in ts.kernels.fixpoint_t(
            torch.as_tensor(lbT), torch.as_tensor(ubT), cap)]
        assert got[0].shape == lbT.shape
        _same_propagation((want[0].T, want[1].T, want[2], want[3]),
                          (got[0].T, got[1].T, got[2], got[3]))
        dv = ts.kernels.fixpoint(torch.as_tensor(lb), torch.as_tensor(ub), cap)
        for a, b in zip(dv, (torch.as_tensor(got[0].T),
                             torch.as_tensor(got[1].T),
                             torch.as_tensor(got[2]), torch.as_tensor(got[3]))):
            assert torch.equal(a, b)
