#!/usr/bin/env python3
"""Table on/off and calibrated/pinned-cap runs of turbo_tpu_torch on one
CUDA card: ``python3 chip_measure.py [--reps N] [--seconds S] [--big M]
[--configs a,b] [--ab DIR]``.

Run from the root of the repository, after ``chip_smoke.py`` has shown
that the kernels build and agree. For golomb(8) (a proof) and golomb(M)
(default 12, a ``-t`` window of S seconds, default 60), each of four
configurations runs N times (default 2), interleaved so that a drift of
the host falls on all of them alike:

- ``cli``: the default CLI (EPS table, cap calibration, steal, resplit);
- ``cli_table_off``: the same with ``TURBO_TPU_TABLE_BUDGET=0``;
- ``api_table_cap10000``: the solver API, table on, cap pinned at 10000;
- ``api_table_off_cap10000``: the solver API, table off, cap pinned.

D is the CLI's auto D for every configuration; ``--configs`` runs a
subset. Each run prints one JSON line: status, objective, nodes,
nodes/s, solveTime, the table build time, the calibrator's choices with
their swept rates, and the steal and resplit rounds. The card's name and
power limit come first; the full output of each run goes to the
directory ``OUT``.

``--ab DIR`` (a checkout of another commit, for example the parent)
then runs the default CLI on golomb(M) for S seconds as a separate
process in DIR and in this checkout, in the order DIR, this, this, DIR,
so that both trees meet the same card and host in turn; one JSON line
each, with ``"tree"`` the directory.
"""
import argparse
import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "measure"
CONFIGS = ("cli", "cli_table_off", "api_table_cap10000",
           "api_table_off_cap10000")


def run_one(name, path, text, seconds):
    """One run of configuration ``name``; returns (record, full output)."""
    import torch
    from turbo_tpu_torch import cli
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.host.solver.plan import auto_num_dives
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.engine import BatchedSolver

    out, err = io.StringIO(), io.StringIO()
    if name.startswith("cli"):
        if name == "cli_table_off":
            os.environ["TURBO_TPU_TABLE_BUDGET"] = "0"
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main([path, "-s", "-t", str(int(seconds * 1000)),
                               "-v", "-v"])
        finally:
            os.environ.pop("TURBO_TPU_TABLE_BUDGET", None)
        if rc != 0:
            raise RuntimeError(f"{name}: the CLI returned {rc}")
        stats = dict(re.findall(r"^%%%mzn-stat: (\w+)=(.*)$",
                                out.getvalue(), re.M))
        status = ("optimal" if "==========" in out.getvalue() else
                  "sat" if "----------" in out.getvalue() else "unknown")
        rec = {"status": status,
               "objective": int(stats["objective"]) if "objective" in stats
               else None,
               "nodes": int(stats["nodes"]),
               "solve_time": float(stats["solveTime"]),
               "table_build_time": float(stats.get("table_build_time", 0.0))}
    else:
        tnf = compile_model(parse_fzn_text(text))
        s = BatchedSolver(tnf, EngineConfig(
            num_dives=auto_num_dives(tnf), fp_cap_auto=False,
            use_table=name == "api_table_cap10000"), device="cuda:0")
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            r = s.solve(timeout_s=seconds, fp_cap=10000, verbose=True)
        torch.cuda.synchronize()
        rec = {"status": r.status, "objective": r.objective,
               "nodes": r.nodes, "solve_time": r.solve_time,
               "table_build_time": r.table_build_time}
    text_out = out.getvalue() + err.getvalue()
    rec["nodes_per_s"] = rec["nodes"] / rec["solve_time"]
    rec["auto_cap"] = re.findall(r"^% auto fp_cap=(.*)$", text_out, re.M)
    rec["steal_rounds"] = len(re.findall(r"^% stack steal #", text_out, re.M))
    rec["resplit_rounds"] = len(re.findall(r"^% tail resplit #", text_out,
                                           re.M))
    return rec, text_out


def run_tree(tree, path, seconds):
    """The default CLI as a process of its own in checkout ``tree``."""
    r = subprocess.run([sys.executable, "-m", "turbo_tpu_torch.cli",
                        str(path), "-s", "-t", str(int(seconds * 1000))],
                       cwd=tree, capture_output=True, text=True,
                       timeout=seconds * 3 + 300)
    if r.returncode != 0:
        raise RuntimeError(f"{tree}: the CLI returned {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    stats = dict(re.findall(r"^%%%mzn-stat: (\w+)=(.*)$", r.stdout, re.M))
    nodes, solve = int(stats["nodes"]), float(stats["solveTime"])
    return {"objective": int(stats["objective"]) if "objective" in stats
            else None, "nodes": nodes, "solve_time": solve,
            "nodes_per_s": nodes / solve,
            "init_time": float(stats["initTime"]),
            "table_build_time": float(stats.get("table_build_time", 0.0))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--big", type=int, default=12)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--ab", default="")
    args = ap.parse_args()
    configs = args.configs.split(",")
    unknown = set(configs) - set(CONFIGS)
    if unknown:
        ap.error(f"unknown configs {sorted(unknown)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_measure: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import nvidia_smi
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.instances import golomb
    print(f"card: {nvidia_smi()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    kernels.load()
    OUT.mkdir(parents=True, exist_ok=True)
    for m in (8, args.big):
        text = golomb(m)
        path = OUT / f"golomb{m}.fzn"
        path.write_text(text)
        for rep in range(args.reps):
            for name in configs:
                rec, full = run_one(name, str(path), text, args.seconds)
                (OUT / f"g{m}_{name}_{rep}.log").write_text(full)
                print(json.dumps({"instance": f"golomb({m})", "config": name,
                                  "rep": rep, **rec}), flush=True)
    if args.ab:
        path = OUT / f"golomb{args.big}.fzn"
        for tree in (args.ab, str(ROOT), str(ROOT), args.ab):
            rec = run_tree(pathlib.Path(tree).resolve(), path, args.seconds)
            print(json.dumps({"instance": f"golomb({args.big})",
                              "config": "cli", "tree": tree, **rec}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
