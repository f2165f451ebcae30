"""Fixtures of the harness's tests: a copy of the benchmark with small
cells that the CPU can run, and the look for a card."""
import json
import pathlib
import shutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]

# Small cells for the CPU: the plain versions of the kernels are far too
# slow for golomb(12) and golomb(9).
SMALL_CONFIG = {"name": "small", "flags": ["-or", "16"],
                "source": "the default configuration at 16 lanes"}
SMALL_TRAFFIC = {
    "golomb7_window": {"regime": "window", "generator": "golomb", "size": 7,
                       "expect": "solution",
                       "warmup_cutnodes": 100, "warmup_timeout_ms": 10000,
                       "trace_slice": [0.2, 0.8]},
    "golomb5_proofs": {"regime": "proofs", "generator": "golomb", "size": 5,
                       "expect": "proof", "distinct_orders": 3,
                       "trace_slice": [0.0, 0.5]},
}


def add_cell(spec: dict, name: str, config: str, traffic: str,
             like: str) -> None:
    """Adds workload ``name`` to ``spec``, listed by every metric that
    lists workload ``like``."""
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)


@pytest.fixture
def small_root(tmp_path, few_threads):
    """A checkout-like directory: ``BENCHMARK.json`` and a copy of
    ``portbench/`` with the small configuration, the small traffic mixes
    and their cells added as new files and entries."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "portbench/configs/small.json").write_text(
        json.dumps(SMALL_CONFIG))
    for name, t in SMALL_TRAFFIC.items():
        (tmp_path / f"portbench/traffic/{name}.json").write_text(json.dumps(t))
    spec["configs"].append({"name": "small", "source": "test",
                            "file": "portbench/configs/small.json",
                            "reduced": [], "why": "test"})
    add_cell(spec, "small.window", "small", "golomb7_window",
             "default.golomb12_window")
    add_cell(spec, "small.proofs", "small", "golomb5_proofs",
             "default.golomb_proofs")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


@pytest.fixture
def few_threads():
    """The plain versions on a CPU shared by several test workers: one
    thread each keeps a small proof inside its window. The number of
    threads is put back after the test."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is there."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
