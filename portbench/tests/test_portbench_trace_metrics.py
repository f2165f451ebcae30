"""The readers of the program's own spans and counters (``-v``'s
``% trace`` lines): a traced CPU run of a golomb(7) window reports
``chunk_host_ms``, one of golomb(5) proofs ``solver_init_s`` and
``table_host_s``; the CPU has no CUDA graph to count; and each reader
returns None where a run printed no ``% trace`` line."""
import json
import pathlib
import types

import pytest

from portbench import harness, run

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**33 + 17
READERS = ("chunk_host_ms", "graph_replay_pct.window",
           "graph_replay_pct.proofs", "solver_init_s", "table_host_s")
TRACED = """\
% trace: chunk n=4 total_ms=40.000 self_ms=1.000
% trace: chunk.wait n=4 total_ms=30.000 self_ms=30.000
% trace: init.solver n=1 total_ms=500.000 self_ms=2.000
% trace: table n=1 total_ms=80.000 self_ms=1.000
% trace: table.read n=12 total_ms=20.000 self_ms=20.000
% trace counters: chunks=5 eager_chunks=2 graph_captures=1 \
graph_replays=2 steps=80
"""


def spec_of(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def reader(name):
    return harness.load_module(ROOT / "portbench/metrics" / f"{name}.py",
                               "metric")


def cell_with(*errs):
    return types.SimpleNamespace(requests=[
        harness.Request("m.fzn", [], 0.0, err=e) for e in errs])


def test_traced_window_reports_chunk_host_ms(small_root, monkeypatch):
    # On the CPU the program's own split runs torch.profiler too.
    monkeypatch.setenv("TURBO_TPU_PROFILE_SPLIT", "0")
    res = run.run_cell(spec_of(small_root), "small.window", SEED, 6, True,
                       platform="cpu", root=small_root)
    assert res["correct"]
    m = res["metrics"]
    assert m["chunk_host_ms"]["value"] > 0
    assert m["chunk_host_ms"]["unit"] == "ms"
    # The plain steps run no CUDA graph, and count none.
    assert "graph_replay_pct.window" not in m


def test_traced_proofs_report_init_and_table(small_root, monkeypatch):
    monkeypatch.setenv("TURBO_TPU_PROFILE_SPLIT", "0")
    res = run.run_cell(spec_of(small_root), "small.proofs", SEED, 8, True,
                       platform="cpu", root=small_root)
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 < m["solver_init_s"] <= m["request_init_s"]
    assert 0 < m["table_host_s"] <= m["table_build_s"] + 1e-6
    assert "graph_replay_pct.proofs" not in m


@pytest.mark.parametrize("name", READERS)
def test_reader_without_trace_lines_is_none(name):
    untraced = "% D=16 k=6 MAXD=64 device=cuda:0 shards=1 setup=0.52s\n"
    assert reader(name).read(cell_with(untraced, "")) is None


@pytest.mark.parametrize("name,value", [
    ("chunk_host_ms", 2.5), ("graph_replay_pct.window", 40.0),
    ("graph_replay_pct.proofs", 40.0), ("solver_init_s", 0.5),
    ("table_host_s", 0.06)])
def test_reader_reads_trace_lines(name, value):
    assert reader(name).read(cell_with(TRACED, TRACED)) == \
        pytest.approx(value)
