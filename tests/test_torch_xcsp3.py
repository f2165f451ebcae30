"""XCSP3 ``<ordered>`` in the port's frontend, by exact solution counts.

``x_i + l_i OP x_{i+1}`` for every i, OP in lt/le/gt/ge, with and
without ``<lengths>``: the port's frontend, through the numpy oracle and
the batched engine on the CPU, must count what a brute-force enumeration
of the domains counts. The JAX frontend reverses the chain for gt/ge
without negating the lengths (ROADMAP fault C2), so gt/ge with lengths
is checked against the brute force only; the other combinations are
also held equal to the JAX frontend.
"""
import itertools
import operator

import pytest

from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.xcsp3 import parse_xcsp3 as jax_parse_xcsp3
from turbo_tpu.solver.oracle import solve as jax_oracle
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.xcsp3 import parse_xcsp3
from turbo_tpu_torch.host.solver.oracle import solve
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.engine import BatchedSolver

OPS = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
       "ge": operator.ge}
DOM = range(0, 6)
N = 4


def _xml(op, lens):
    lengths = (f"<lengths> {' '.join(map(str, lens))} </lengths>"
               if lens is not None else "")
    return f"""<instance format="XCSP3" type="CSP">
<variables><array id="x" size="[{N}]"> {DOM[0]}..{DOM[-1]} </array></variables>
<constraints><ordered><list> x[] </list>{lengths}<operator> {op} </operator>
</ordered></constraints>
</instance>"""


def _brute(op, lens):
    lens = lens or [0] * (N - 1)
    return sum(all(OPS[op](x[i] + lens[i], x[i + 1]) for i in range(N - 1))
               for x in itertools.product(DOM, repeat=N))


def _count(tmp_path, parse, compile_, oracle, op, lens):
    p = tmp_path / "m.xml"
    p.write_text(_xml(op, lens))
    tnf = compile_(parse(str(p)))
    r = oracle(tnf, timeout_s=120, stop_after_n_solutions=0)
    assert r.stats.exhaustive
    return r.stats.solutions, tnf


LENGTHS = [None, [1, 1, 1], [2, -1, 0], [-2, 1, 3]]


@pytest.mark.parametrize("lens", LENGTHS, ids=lambda l: str(l))
@pytest.mark.parametrize("op", sorted(OPS))
def test_ordered_counts_match_brute_force(op, lens, tmp_path):
    want = _brute(op, lens)
    got, tnf = _count(tmp_path, parse_xcsp3, compile_model, solve, op, lens)
    assert got == want, (op, lens)
    if op in ("gt", "ge") and lens is not None:
        return  # C2: the JAX frontend differs here on purpose
    jax_got, _ = _count(tmp_path, jax_parse_xcsp3, jax_compile, jax_oracle,
                        op, lens)
    assert jax_got == got


@pytest.mark.parametrize("op", ["gt", "ge"])
def test_ordered_gt_with_lengths_through_the_engine(op, tmp_path):
    """The corrected lowering through the batched engine (all solutions,
    on the CPU): the brute-force count, and a count the uncorrected
    lowering (lengths reversed, not negated) does not give."""
    lens = [2, -1, 0]
    want = _brute(op, lens)
    flipped = _brute(op, [-l for l in lens])
    assert want != flipped
    p = tmp_path / "m.xml"
    p.write_text(_xml(op, lens))
    tnf = compile_model(parse_xcsp3(str(p)))
    s = BatchedSolver(tnf, EngineConfig(num_dives=8, subproblems_power=3,
                                        max_depth=64, enumerate_all=True),
                      device="cpu")
    r = s.solve(timeout_s=120, stop_after_n_solutions=0)
    assert r.exhaustive and r.solutions == want
