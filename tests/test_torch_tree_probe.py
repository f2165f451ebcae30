"""The native EPS tree probe (``turbo_tpu_torch/solver/tree_probe.py``)
against the numpy oracle it runs node for node (``host/solver/oracle.py``
``solve``): equal nodes, exhaustion, fails, solutions and best objective
on the host tests' models, golomb proofs, golomb(8) and golomb(12) cut at
node limits, and models with element, membership and linear rows under
every variable and value order; ``probe_tree_power`` through the numpy
oracle when the library is unavailable, and with no time at all."""
import numpy as np
import pytest

from test_torch_host import MODELS
from turbo_tpu_torch import trace
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.host.solver import oracle
from turbo_tpu_torch.instances import (_VAL_ORDERS, _VAR_ORDERS, golomb,
                                       random_model)
from turbo_tpu_torch.solver import config, tree_probe

NO_LIMIT = 1 << 62


def _tnf(text):
    return compile_model(parse_fzn_text(text))


def _same_as_oracle(tnf, node_limit=NO_LIMIT):
    """Both searches on ``tnf`` give equal counts; returns the native
    one's."""
    r = oracle.solve(tnf, node_limit=node_limit)
    best = (int(r.best_lb[tnf.obj_var])
            if r.best_lb is not None and tnf.obj_var >= 0 else None)
    want = (r.stats.nodes, r.stats.exhaustive, r.stats.fails,
            r.stats.solutions, best)
    p = tree_probe.solve(tnf, timeout_s=1e18, node_limit=node_limit)
    assert p is not None, tree_probe.load_error
    assert (p.nodes, p.exhaustive, p.fails, p.solutions, p.best) == want
    return p


@pytest.mark.parametrize("mi", range(len(MODELS)))
def test_host_models_to_exhaustion(mi):
    assert _same_as_oracle(_tnf(MODELS[mi])).exhaustive


@pytest.mark.parametrize("m", (5, 6, 7))
def test_golomb_proofs(m):
    p = _same_as_oracle(_tnf(golomb(m)))
    assert p.exhaustive and p.best == {5: 11, 6: 17, 7: 25}[m]


@pytest.mark.parametrize("m", (8, 12))
def test_golomb_cut_at_node_limits(m):
    tnf = _tnf(golomb(m))
    for limit in (1, 50, 300):
        p = _same_as_oracle(tnf, limit)
        assert p.nodes == limit and not p.exhaustive


def _with_search(seed, var_order, val_order, goal):
    """random_model(seed) (every constraint family: element, membership
    and linear rows among them) under its own search annotation."""
    text = random_model(seed, n_vars=8, n_cons=20)
    lines = text.strip().split("\n")[:-1]
    ids = ", ".join(f"v{i}" for i in np.random.default_rng(seed)
                    .permutation(8)[:6])
    lines.append(f"solve :: int_search([{ids}], {var_order}, {val_order}, "
                 f"complete) {goal};")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("var_order", _VAR_ORDERS)
def test_every_var_and_value_order(var_order):
    for i, val_order in enumerate(_VAL_ORDERS):
        for seed, goal in ((11 + i, "minimize v0"), (23 + i, "maximize v1"),
                           (37 + i, "satisfy")):
            tnf = _tnf(_with_search(seed, var_order, val_order, goal))
            assert tnf.elements and tnf.members and tnf.linears
            _same_as_oracle(tnf)


def test_fallback_to_the_oracle(monkeypatch):
    """The library made unavailable: the numpy oracle answers, with the
    same k, and ``probe_native`` says so."""
    tnf = _tnf(golomb(5))
    trace.enable()
    try:
        with trace.request():
            k_native = config.probe_tree_power(tnf)
            native = trace.counters()
        monkeypatch.setattr(tree_probe, "load", lambda: None)
        with trace.request():
            k_oracle = config.probe_tree_power(tnf)
            fallback = trace.counters()
    finally:
        trace.disable()
    assert k_native == k_oracle == int(np.ceil(np.log2(23))) + 1
    assert native == {"probe_native": 1, "probe_nodes": 23,
                      "probe_exhaustive": 1}
    assert fallback == dict(native, probe_native=0)


def test_no_time_gives_no_power():
    assert config.probe_tree_power(_tnf(golomb(5)), probe_timeout_s=0) is None
