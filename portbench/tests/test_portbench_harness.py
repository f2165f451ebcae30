"""The harness: driven by data, refusing to run without a card or with
JAX loaded, and a well-formed ``BENCHMARK.json``."""
import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from portbench import harness, run

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_new_files_are_found(small_root):
    """A configuration, a traffic mix and a metric added as files and
    entries alone, with no edit to a file that was there."""
    before = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    (small_root / "portbench/metrics/requests_sent.py").write_text(
        "def read(cell):\n    return len(cell.requests)\n")
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "requests_sent", "unit": "requests",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["small.proofs"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run.run_cell(spec, "small.proofs", 2**33 + 5, 8, False,
                       platform="cpu", root=small_root)
    assert res["correct"], res
    assert res["metrics"]["requests_sent"]["value"] == res["attempted"] >= 1
    assert {"setup_s", "proofs_per_s", "proof_s_p90"} <= set(res["metrics"])
    after = {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after


def test_unread_traffic_key_is_refused(small_root):
    """A traffic file with a key that no part reads (here a second
    client, which no regime sends from) is refused, not run as if the
    key were not there."""
    path = small_root / "portbench/traffic/golomb5_proofs.json"
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    harness.Cell(spec, "small.proofs", 1, 1, False, root=small_root)
    t = json.loads(path.read_text())
    path.write_text(json.dumps(dict(t, clients=4)))
    with pytest.raises(ValueError, match="clients"):
        harness.Cell(spec, "small.proofs", 1, 1, False, root=small_root)


def test_cell_metrics_follow_the_spec():
    spec = harness.load_spec()
    for wl in spec["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(spec, wl["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = run.cell_metrics(spec, wl["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer)
        for m in list(layer) + [{"name": n} for n in e2e]:
            assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()


def test_forbidden_modules_compare_whole_names(monkeypatch):
    for name in ("turbo_tpu_torch", "turbo_tpu_torch.cli", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not any(m.startswith(("turbo_tpu_torch", "jaxtyping"))
                   for m in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "turbo_tpu.solver", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"turbo_tpu.solver", "jax.numpy"} <= set(harness.forbidden_modules())


def test_nothing_run_loads_imports_jax():
    """Every module of the harness and the program's path, loaded in a
    fresh process, loads no module of JAX or of the JAX package."""
    code = f"""
import pathlib, sys
sys.path[0] = {str(ROOT)!r}
from portbench import harness, run, control, reference, roofline
bench = pathlib.Path(harness.BENCH)
for kind in ("metrics", "regimes", "generators"):
    for p in sorted((bench / kind).glob("*.py")):
        if p.name != "__init__.py":
            harness.load_module(p, kind)
import turbo_tpu_torch.cli, turbo_tpu_torch.kernels
import turbo_tpu_torch.solver.engine, turbo_tpu_torch.solver.eps_table
print(harness.forbidden_modules())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    bench = ROOT / "portbench"
    files = [bench / "reference.py", bench / "roofline.py",
             *sorted((bench / "generators").glob("*.py"))]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "turbo_tpu_torch", "turbo_tpu", "jax", "torch"), (f, n)


def test_run_refuses_without_a_card(tmp_path):
    """No card (none here, or none visible): no result, exit not 0. The
    same in a directory that holds only BENCHMARK.json and portbench/."""
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "default.golomb12_window", "--seed", str(2**31 + 11),
             "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, env=env, timeout=300)
        assert out.returncode != 0
        assert out.stdout.strip() == ""


def test_benchmark_json_is_well_formed():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "portbench/run.py"]
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads") for x in spec[k]]
    names += [m["name"] for k in ("end_to_end", "per_layer") for m in spec[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    configs = {c["name"] for c in spec["configs"]}
    used = {w["config"] for w in spec["workloads"]}
    assert used == configs
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in spec["end_to_end"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"])
        assert m["better"] in ("lower", "higher")
