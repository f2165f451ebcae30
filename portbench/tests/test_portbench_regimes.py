"""Each regime end to end on the CPU at a tiny size, the planted faults
and the control coming out not correct, and one short cell on the card."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from portbench import control, run

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**31 + 101
# Windows long enough for a golomb(5) proof on a loaded CPU: a request's
# -t is the whole window.
SECONDS = {"small.window": 6, "small.proofs": 8}


def spec_of(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_window_regime_on_cpu(small_root):
    res = run.run_cell(spec_of(small_root), "small.window", SEED,
                       SECONDS["small.window"], False,
                       platform="cpu", root=small_root)
    assert res["correct"] and res["attempted"] == 1 and res["failed"] == 0
    assert res["metrics"]["nodes_per_s"]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0
    assert list(res)[-1] == "checks"
    assert all(c == {"value": 0, "limit": 0} for c in res["checks"].values())


def test_proofs_regime_on_cpu(small_root):
    res = run.run_cell(spec_of(small_root), "small.proofs", SEED,
                       SECONDS["small.proofs"], False,
                       platform="cpu", root=small_root)
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    m = res["metrics"]
    assert m["proofs_per_s"]["value"] > 0 and m["proof_s_p90"]["value"] > 0


def test_traced_proofs_on_cpu(small_root, monkeypatch):
    # On the CPU the program's own split runs torch.profiler too.
    monkeypatch.setenv("TURBO_TPU_PROFILE_SPLIT", "0")
    res = run.run_cell(spec_of(small_root), "small.proofs", SEED,
                       SECONDS["small.proofs"], True,
                       platform="cpu", root=small_root)
    assert res["correct"]
    assert {"table_build_s", "tail_s", "request_init_s"} <= set(res["metrics"])
    # No device here: the device metrics find nothing to read.
    assert "device_idle_pct.proofs" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


# The faults each cell can have, and the control. A search ended early is
# the window's: golomb(5)'s table build finds its optimum, so a proof
# ended early is still right at this size. Half the lanes left out of a
# window shows as the objective it reaches, which only the full-size
# window separates (the test on the card below).
PLANTED = [("small.window", p) for p in ("frozen_step", "early_exhaust",
                                          "altered_answer",
                                          "dropped_constraints")]
PLANTED += [("small.proofs", p) for p in ("frozen_step", "half_batch",
                                          "altered_answer",
                                          "dropped_constraints")]


@pytest.mark.parametrize("cell,plant", PLANTED)
def test_planted_fault_is_not_correct(small_root, cell, plant):
    with control.PLANTS[plant]():
        res = run.run_cell(spec_of(small_root), cell, SEED, SECONDS[cell],
                           False,
                           platform="cpu", root=small_root)
    assert not res["correct"], res
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.cuda
def test_window_on_the_card(card):
    """One run of the main cell as the benchmark makes it: the window's
    objective gap has its limit at the benchmark's window length."""
    seconds = spec_of(ROOT)["run_seconds"]
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "default.golomb12_window", "--seed", str(SEED), "--seconds",
         str(seconds), "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=seconds + 600, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["metrics"]["nodes_per_s"]["value"] > 0


@pytest.mark.cuda
def test_half_batch_window_on_the_card(card):
    """Half the lanes left out: every printed solution is still right,
    and the search falls short of the objective sound runs reach."""
    from portbench import harness
    harness.cache_env()
    spec = spec_of(ROOT)
    with control.PLANTS["half_batch"]():
        res = run.run_cell(spec, "default.golomb12_window", SEED + 1,
                           spec["run_seconds"], False)
    gap = res["checks"]["objective_gap"]
    assert not res["correct"] and gap["value"] > gap["limit"], res
