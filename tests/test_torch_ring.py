"""The solution ring, enumeration and streaming against the JAX package.

- ``SearchState`` (``sol_ring`` and ``sol_w`` included) equals the JAX
  engine's after 1, 7 and 40 steps with ``enumerate_all`` (table off)
  and with an ``-i``-style ring (table on), each with a ring and with
  ``sol_ring_size=0`` (tolerance 0; bot-lane stores excepted, see
  ``test_torch_engine``);
- the port's CLI: ``-a`` on queens(6) and queens(7) prints the known
  number of blocks (OEIS A000170) and the same set as the JAX CLI and
  the JAX package's oracle; ``-n 3`` prints 3 blocks; ``-i`` on golomb(6)
  prints the JAX CLI's blocks in the JAX CLI's order (cap pinned, steal
  and resplit stubbed: both are timed by the wall clock);
- a ring too small for one step's solutions reports its overflow;
- ``run_steps`` reads nothing back to the host inside a chunk.
"""
import collections
import dataclasses
import functools
import traceback

import pytest
import torch

import turbo_tpu.cli as jax_cli
import turbo_tpu.solver.engine as jax_engine
import turbo_tpu_torch.cli as port_cli
import turbo_tpu_torch.solver.engine as port_engine
from test_torch_engine import _assert_same_state
from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.fzn import parse_fzn_text as jax_parse
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.instances import QUEENS_COUNT, golomb, queens
from turbo_tpu_torch.solver.config import EngineConfig

CONFIGS = {
    # name: (model, EngineConfig keywords)
    "enumerate_ring": (queens(6), dict(enumerate_all=True, use_table=False,
                                       sol_ring_size=32)),
    "enumerate_no_ring": (queens(6), dict(enumerate_all=True,
                                          use_table=False, sol_ring_size=0)),
    "improve_ring_table": (golomb(6), dict(use_table=True, sol_ring_size=32)),
    "improve_no_ring_table": (golomb(6), dict(use_table=True,
                                              sol_ring_size=0)),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    text, kw = CONFIGS[name]
    kw = dict(kw, num_dives=8, subproblems_power=4, max_depth=96,
              fp_max_iters=10000, fp_cap_auto=False)
    js = jax_engine.BatchedSolver(jax_compile(jax_parse(text)),
                                  jax_engine.EngineConfig(fp_layout="dv",
                                                          **kw))
    ts = port_engine.BatchedSolver(compile_model(parse_fzn_text(text)),
                                   EngineConfig(**kw), device="cpu")
    assert js.use_table == ts.use_table == kw["use_table"]
    return js, ts


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ring_state_after_steps_matches_jax(name):
    js, ts = _pair(name)
    jst, tst = js.init_state(), ts.init_state()
    _assert_same_state(jst, tst, "init")
    done = 0
    for n in (1, 7, 40):
        jst = js.make_step_n(n - done)(jst)
        tst, _ = ts.run_steps(tst, n - done)
        done = n
        _assert_same_state(jst, tst, f"after {n} steps")
    if CONFIGS[name][1]["sol_ring_size"]:
        assert int(tst.sol_w[0]) > 0  # the ring took solutions


def _blocks(out):
    """(solution blocks, lines after the last block)."""
    body = [l for l in out.splitlines() if not l.startswith("%")]
    blocks, cur = [], []
    for line in body:
        if line == "----------":
            blocks.append("\n".join(cur))
            cur = []
        else:
            cur.append(line)
    return blocks, cur


def _run(main, path, capsys, *args):
    assert main([str(path), "-platform", "cpu", "-or", "16", *args]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("n", [6, 7])
def test_cli_all_solutions_match_jax_and_oracle(n, tmp_path, capsys):
    path = tmp_path / f"queens{n}.fzn"
    path.write_text(queens(n))
    port, tail = _blocks(_run(port_cli.main, path, capsys, "-a"))
    jax, jtail = _blocks(_run(jax_cli.main, path, capsys, "-a", "-arch",
                              "tpu"))
    oracle, otail = _blocks(_run(jax_cli.main, path, capsys, "-a", "-arch",
                                 "cpu"))
    assert len(port) == len(set(port)) == QUEENS_COUNT[n]
    assert set(port) == set(jax) == set(oracle)
    assert tail == jtail == otail == ["=========="]


def test_cli_n_solutions(tmp_path, capsys):
    from turbo_tpu.utils.checker import Checker
    text = queens(7)
    path = tmp_path / "queens7.fzn"
    path.write_text(text)
    port, tail = _blocks(_run(port_cli.main, path, capsys, "-n", "3"))
    assert len(port) == len(set(port)) == 3 and tail == []
    model = jax_parse(text)
    for block in port:  # "q = array1d(1..7, [...]);"
        rows = block.split("[")[1].split("]")[0].split(",")
        ck = Checker(model, {f"q{i}": int(v) for i, v in enumerate(rows)})
        assert all(ck.holds(c) for c in model.constraints), block


def _pinned(cls):
    """The CLI's solver with the cap pinned and steal/resplit off: the
    calibrator and the steal gate are timed by the wall clock."""
    class Pinned(cls):
        def __init__(self, tnf, cfg, *a, **k):
            super().__init__(tnf, dataclasses.replace(cfg, fp_cap_auto=False),
                             *a, **k)

        def _steal_open_branches(self, *a, **k):
            return None

        def _tail_resplit(self, *a, **k):
            return None
    return Pinned


def test_cli_intermediate_solutions_match_jax(tmp_path, capsys, monkeypatch):
    for mod in (jax_engine, port_engine):
        monkeypatch.setattr(mod, "BatchedSolver", _pinned(mod.BatchedSolver))
    path = tmp_path / "golomb6.fzn"
    path.write_text(golomb(6))
    port, tail = _blocks(_run(port_cli.main, path, capsys, "-i"))
    jax, jtail = _blocks(_run(jax_cli.main, path, capsys, "-i", "-arch",
                              "tpu"))
    assert len(port) > 1 and port == jax
    assert port[-1].startswith("m0 = 0;") and "m5 = 17;" in port[-1]
    assert tail == jtail == ["=========="]


def test_tiny_ring_reports_its_overflow(tmp_path, capsys, monkeypatch):
    """A ring of one row under enumeration: the solutions that land two
    or more in one step overflow it; the solve counts them, the CLI warns
    and prints the count, and does not treat the stream as complete."""
    tnf = compile_model(parse_fzn_text(queens(7)))
    s = port_engine.BatchedSolver(tnf, EngineConfig(
        num_dives=16, subproblems_power=4, enumerate_all=True,
        sol_ring_size=1), device="cpu")
    got = []
    r = s.solve(stop_after_n_solutions=0, on_solution=got.append)
    assert r.solutions == QUEENS_COUNT[7] and r.exhaustive
    assert r.sol_ring_overflow > 0
    assert len(got) + r.sol_ring_overflow == r.solutions
    assert "% warning: solution ring overflow" in capsys.readouterr().out

    class OneRow(port_engine.BatchedSolver):
        def __init__(self, tnf, cfg, *a, **k):
            super().__init__(tnf, dataclasses.replace(cfg, sol_ring_size=1),
                             *a, **k)
    monkeypatch.setattr(port_engine, "BatchedSolver", OneRow)
    path = tmp_path / "queens7.fzn"
    path.write_text(queens(7))
    out = _run(port_cli.main, path, capsys, "-a", "-s")
    assert "%%%mzn-stat: sol_ring_overflow=" in out
    blocks, _ = _blocks(out)
    lost = int(out.split("sol_ring_overflow=")[1].split()[0])
    # The streamed blocks, then the final block unless it is the last
    # one streamed: an incomplete stream is not taken for all solutions.
    assert len(blocks) in (QUEENS_COUNT[7] - lost, QUEENS_COUNT[7] - lost + 1)
    assert 0 < lost < QUEENS_COUNT[7]


@pytest.mark.parametrize("name", ["enumerate_ring", "improve_ring_table"])
def test_run_steps_reads_nothing_back_inside_a_chunk(name, monkeypatch):
    """Tensor.item / __bool__ / tolist (and int, index, float) are not
    called by a chunk of run_steps, except inside fixpoint_plain: the
    plain stand-in of K1 checks its own convergence per sweep, where K1
    loops on the card."""
    _, ts = _pair(name)
    st = ts.init_state()
    calls = collections.Counter()
    for meth in ("item", "__bool__", "tolist", "__int__", "__index__",
                 "__float__"):
        orig = getattr(torch.Tensor, meth)

        def counted(self, *a, _orig=orig, _meth=meth, **k):
            frames = {f.name for f in traceback.extract_stack()}
            calls["fixpoint_plain" if "fixpoint_plain" in frames
                  else _meth] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, meth, counted)
    st, ran = ts.run_steps(st, 24, 4)
    monkeypatch.undo()
    assert calls["fixpoint_plain"] > 0  # the patch sees reads
    assert set(calls) == {"fixpoint_plain"}, calls
    assert 0 < int(ran) <= 24
