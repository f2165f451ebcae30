"""The port's spans and counters (``turbo_tpu_torch/trace.py``): their
nesting, parents, request ids and self times; nothing kept with tracing
off; the profiler's clock; the CLI's ``% trace`` lines under ``-v`` only,
with the engine's own step count; every span of the request, the solver
set-up, the table build and the chunk loop in a CPU solve, with the
table leaf's counters; and, on the card, the device's idle time of a
golomb(12) window laid over the spans.
"""
import re
import sys
import time

import pytest
import torch

from turbo_tpu_torch import cli, trace
from turbo_tpu_torch.instances import golomb
from turbo_tpu_torch.solver.engine import BatchedSolver

STAT = re.compile(r"^%%%mzn-stat: (\w+)=(.*)$", re.M)
TRACE = re.compile(r"^% trace: (\S+) n=(\d+) total_ms=([\d.]+) "
                   r"self_ms=([-\d.]+)$", re.M)
COUNTERS = re.compile(r"^% trace counters:(.*)$", re.M)
# The statistics whose timers read a span since tracing came in.
TIMED = ("initTime", "table_build_time", "dive_time",
         "transfer_cpu2gpu_time", "transfer_gpu2cpu_time", "fixpoint_time",
         "search_time", "wait_cpu_time", "solveTime")
SPANS = ("request", "parse", "compile", "output", "init.solver",
         "init.plan", "init.probe", "init.upload", "init.warm_up", "solve",
         "init_state",
         "table", "table.level", "table.read", "table.leaf", "chunk",
         "chunk.enqueue", "chunk.wait", "chunk.read", "split", "ring",
         "calibrate", "tail.steal", "tail.resplit", "checkpoint")


@pytest.fixture(autouse=True)
def tracing_off():
    """Each test starts and ends with tracing off and no record kept. The
    plain versions run on one thread: the CPU is shared by several test
    workers (the number of threads is put back after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.enable()
    trace.disable()
    yield
    trace.disable()
    torch.set_num_threads(n)


@pytest.fixture
def no_split(monkeypatch):
    """The measured split off: on the CPU it runs ``torch.profiler``."""
    monkeypatch.setenv("TURBO_TPU_PROFILE_SPLIT", "0")


def _solve(tmp_path, capsys, m, *flags):
    """The CLI on golomb(m) on the CPU at 16 lanes; returns (stdout,
    stderr, statistics by name)."""
    path = tmp_path / f"golomb{m}.fzn"
    path.write_text(golomb(m))
    assert cli.main([str(path), "-platform", "cpu", "-or", "16", "-s",
                     *flags]) == 0
    out, err = capsys.readouterr()
    return out, err, dict(STAT.findall(out))


def _lines(err):
    """{span name: (n, total ms, self ms)} and the counters of ``% trace``
    lines."""
    spans = {m[1]: (int(m[2]), float(m[3]), float(m[4]))
             for m in TRACE.finditer(err)}
    c = COUNTERS.search(err)
    counters = {k: int(v) for k, v in
                (kv.split("=") for kv in c[1].split())} if c else None
    return spans, counters


def test_spans_nest_with_parent_request_and_self_time():
    trace.enable()
    with trace.request():
        with trace.span("outer") as outer:
            with trace.span("inner") as inner:
                time.sleep(0.002)
            with trace.span("inner"):
                pass
            trace.count("things", 3)
            trace.count("things")
    with trace.request():
        with trace.span("other"):
            pass
    recs = trace.spans()
    assert [r.name for r in recs] == [
        "inner", "inner", "outer", "request", "other", "request"]
    inner1, inner2, outer_r, first, other, second = recs
    assert first.parent == second.parent == 0
    assert outer_r.parent == first.span and other.parent == second.span
    assert inner1.parent == inner2.parent == outer_r.span
    assert {r.request for r in recs[:4]} == {first.request}
    assert other.request == second.request != first.request
    assert outer.s >= inner.s >= 0.002
    assert (outer_r.start_ns, outer_r.end_ns) == (outer.start_ns,
                                                  outer.end_ns)
    # The totals and counters are the current request's.
    assert set(trace.totals()) == {"other", "request"}
    assert trace.counters() == {}


def test_self_time_is_duration_less_children(capsys):
    trace.enable()
    with trace.request():
        with trace.span("a"):
            with trace.span("b"):
                time.sleep(0.003)
            time.sleep(0.002)
        trace.count("n", 2)
    t = trace.totals()
    n, total_a, self_a = t["a"]
    assert n == 1 and total_a == pytest.approx(t["b"][1] + self_a)
    assert self_a >= 0.002 and t["b"][1] >= 0.003
    trace.report(sys.stderr)
    spans, counters = _lines(capsys.readouterr().err)
    assert counters == {"n": 2}
    assert set(spans) == {"a", "b", "request"}
    assert spans["a"][1] == pytest.approx(total_a * 1e3, abs=1e-3)


def test_tracing_off_keeps_nothing(tmp_path, capsys, no_split):
    """Off: no record and no counter over a golomb(5) solve, and every
    statistic is there with its meaning."""
    t0 = time.monotonic()
    out, err, stats = _solve(tmp_path, capsys, 5)
    wall = time.monotonic() - t0
    assert trace.spans() == [] and trace.counters() == {}
    assert "% trace" not in err
    assert set(TIMED) <= set(stats)
    assert stats["objective"] == "11" and "==========" in out
    # initTime: parse, compile and the solver's construction, before the
    # solve; the table build inside the solve.
    init, solve = float(stats["initTime"]), float(stats["solveTime"])
    assert 0 < init and init + solve <= wall
    assert 0 < float(stats["table_build_time"]) <= solve
    # The same names as a traced run's.
    _, _, traced = _solve(tmp_path, capsys, 5, "-v")
    assert set(traced) == set(stats)


def test_timers_read_the_spans(tmp_path, capsys, no_split):
    _, err, stats = _solve(tmp_path, capsys, 5, "-v")
    spans, _ = _lines(err)
    init = sum(spans[k][1] for k in ("parse", "compile", "init.solver"))
    assert float(stats["initTime"]) == pytest.approx(init / 1e3, abs=2e-3)
    assert float(stats["table_build_time"]) == pytest.approx(
        spans["table"][1] / 1e3, abs=2e-6)
    assert float(stats["transfer_cpu2gpu_time"]) * 16 == pytest.approx(
        spans["init_state"][1] / 1e3, abs=2e-5)
    assert float(stats["transfer_gpu2cpu_time"]) * 16 == pytest.approx(
        spans["chunk.read"][1] / 1e3, abs=2e-5)


def test_span_shares_the_profiler_clock():
    """A span and a ``record_function`` opened back to back start within
    2 ms on the profiler's timeline."""
    from torch.profiler import ProfilerActivity, profile, record_function
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("probe") as sp:
            with record_function("probe"):
                pass
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "probe"]
    assert abs(ev.start_ns() - sp.start_ns) < 2_000_000


def test_trace_lines_under_v_only_with_the_engines_steps(
        tmp_path, capsys, monkeypatch):
    _, err, _ = _solve(tmp_path, capsys, 6)
    assert "% trace" not in err
    ran = []
    run_steps = BatchedSolver.run_steps

    def counted(self, st, n, cap=0):
        res = run_steps(self, st, n, cap)
        ran.append(int(res[1]))
        return res
    monkeypatch.setattr(BatchedSolver, "run_steps", counted)
    _, err, _ = _solve(tmp_path, capsys, 6, "-v")
    spans, counters = _lines(err)
    assert counters["steps"] == sum(ran) > 0
    assert counters["chunks"] == len(ran)
    assert spans["chunk"][0] + 2 * ("split" in spans) == len(ran)
    assert not trace.enabled() and trace.spans()


def test_every_span_appears(tmp_path, capsys, monkeypatch):
    """A golomb(7) solve with the table on, streamed (``-i``: the ring)
    and with nothing to steal (so the resplit is tried), then a golomb(6)
    cut by ``-cutnodes`` (its checkpoint): every span of the request, the
    solver set-up (the tree probe's too), the table build and the chunk
    loop, each under its parent and with its request's id."""
    monkeypatch.setattr(BatchedSolver, "_steal_open_branches",
                        lambda self, st, phase: None)
    trace.enable()
    _, err1, stats = _solve(tmp_path, capsys, 7, "-i", "-v")
    assert stats["objective"] == "25"
    ckpt = tmp_path / "ckpt.npz"
    _, err2, _ = _solve(tmp_path, capsys, 6, "-v", "-checkpoint", str(ckpt),
                        "-cutnodes", "100")
    recs = trace.spans()
    names = {r.name for r in recs}
    assert set(SPANS) <= names, set(SPANS) - names
    roots = [r for r in recs if r.name == "request"]
    assert len(roots) == 2 and all(r.parent == 0 for r in roots)
    assert {r.request for r in recs} == {r.request for r in roots}
    by_id = {r.span: r for r in recs}
    parent = {"parse": "request", "compile": "request", "output": "request",
              "init.solver": "request", "solve": "request",
              "init.plan": "init.solver", "init.probe": "init.plan",
              "init.upload": "init.solver",
              "init.warm_up": "init.solver", "init_state": "solve",
              "table": "init_state", "table.level": "table",
              "table.read": "table", "table.leaf": "table",
              "chunk": "solve", "chunk.enqueue": "chunk",
              "chunk.wait": "chunk", "chunk.read": "chunk",
              "split": "chunk", "ring": "chunk", "calibrate": "chunk",
              "tail.steal": "chunk", "tail.resplit": "chunk"}
    for r in recs:
        if r.name in parent:
            p = by_id[r.parent]
            assert p.name == parent[r.name] and p.request == r.request
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        elif r.name == "checkpoint":
            assert by_id[r.parent].name in ("chunk", "solve")
    # The tree probe: native, golomb(7)'s and golomb(6)'s whole trees. The
    # table's leaf level: once a request, on the CPU here, and as many
    # rows as the table has live ones.
    for err, nodes in ((err1, 717), (err2, 95)):
        spans, counters = _lines(err)
        assert counters["chunks"] >= spans["chunk"][0] > 0
        assert (counters["probe_native"], counters["probe_nodes"],
                counters["probe_exhaustive"]) == (1, nodes, 1)
        n_live = int(re.search(r"^% eps table: n_live=(\d+) ", err, re.M)[1])
        assert spans["table.leaf"][0] == 1 and n_live > 0
        assert (counters["table_leaf_device"],
                counters["table_leaf_rows"]) == (0, n_live)
        for n, total, self_ms in spans.values():
            assert n > 0 and -1e-3 <= self_ms <= total + 1e-3
    assert "resplit_rounds" in _lines(err1)[1]


@pytest.mark.cuda
def test_window_idle_lies_in_spans_on_the_card(tmp_path, capsys):
    """A 10 s golomb(12) window with ``-v`` under ``torch.profiler``: at
    least 90 % of the device's idle time between its first and last
    operation lies inside some program span on the shared clock. Prints
    that idle by the innermost span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.host.utils.config import parse_args
    kernels.load()
    path = tmp_path / "golomb12.fzn"
    path.write_text(golomb(12))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        assert cli.run(parse_args([str(path), "-s", "-t", "10000",
                                   "-v"])) == 0
    out, err = capsys.readouterr()
    busy = []
    for e in prof.profiler.kineto_results.events():
        kind = str(getattr(e, "activity_type", lambda: "")())
        if str(e.device_type()).endswith("CUDA") and "annotation" not in kind:
            busy.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    busy.sort()
    gaps, cur = [], busy[0][1]
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    by_span, covered = trace.idle_by_span(gaps, trace.spans())
    idle = sum(g1 - g0 for g0, g1 in gaps)
    with capsys.disabled():
        print(f"\nidle {idle / 1e9:.4f} s of {(cur - busy[0][0]) / 1e9:.4f}"
              f" s, in spans {100 * covered / idle:.2f} %")
        for name, ns in sorted(by_span.items(), key=lambda kv: -kv[1]):
            print(f"  {name}: {ns / 1e9:.4f} s")
    assert covered >= 0.9 * idle
    assert "% trace: chunk " in err
    # The table's leaf level ran on the card.
    assert _lines(err)[1]["table_leaf_device"] == 1
