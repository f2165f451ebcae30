#!/usr/bin/env python3
"""Table on/off and calibrated/pinned-cap runs of turbo_tpu_torch on one
CUDA card: ``python3 chip_measure.py [--reps N] [--seconds S] [--big M]
[--configs a,b] [--ab DIR [--opts "-fp wac1"]]``.

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
their swept rates, the steal and resplit rounds (counted from the
``-v -v`` lines) and their seconds (``steal_s``, ``resplit_s``: the sums
of the wall ms that end those lines). The card's name and power limit
come first; the full output of each run goes to the directory ``OUT``.

``--ab DIR`` (a checkout of another commit, for example the parent)
then runs the default CLI on golomb(M) for S seconds as a separate
process in DIR and in this checkout, in the order DIR, this, this, DIR,
so that both trees meet the same card and host in turn; one JSON line
each, with ``"tree"`` the directory, and the steal and resplit rounds
with their seconds timed the same way in both trees: around the
solver's ``_steal_open_branches`` and ``_tail_resplit`` calls that made
a round, up to a synchronize after them (``ROUND_TIMER``); with
``--opts="-v -v"`` also the caps the calibrator locked (``auto_cap``)
and, as in the configurations' runs, ``chunk_stats``: the mean share of
idle lanes after a chunk, when the range drained and the steps and
nodes after it. Each run's output goes to ``OUT/ab_<turn>.log``. ``--opts`` adds CLI options to
those runs (``--opts="-fp wac1"``: the WAC1 path; ``--big 8`` with it:
the golomb(8) proof, whose ``solve_time`` is the time to the optimum).

``--k1-ab DIR`` runs only K1 and the EPS table build of DIR against this
checkout, each tree in a process of its own (its own
``turbo_tpu_torch``), in the order DIR, this, this, DIR. A process
prints one JSON line: K1's ``-Xptxas -v`` line; for golomb(12) at D=512
and 2048 and golomb(8) at D=1024 the time to upload the kernel tables
and three table builds in turn (the first cold: lazy module loads and
first allocations), each with its K1 launches, rows and K1 ms (CUDA
events; a tree whose table levels run K1's level entry counts none) and
the wall time of its first ``dive_level`` call against the others';
before them, the process's first upload of the kernel tables, table by
table; and K1 alone (median of 15) on ``chip_smoke.random_stores``
at the shapes, seeds and caps of ``K1_CASES``, with the sweeps its
slowest dive needed. Then the default CLI on golomb(12) with ``-t 5000``
in each tree in the same order, for its cold ``table_build_time``.

``--table-ab DIR`` times the EPS table build of DIR against this
checkout, each run the CLI in a new process (``chip_smoke.fresh_cli``):
the golomb(8) proof and golomb(12) with ``-t 3000``, under the default
options and ``-fp wac1``, in the order DIR, this, this without its
kernel warm-up (``--cold``), the same again, this, DIR. One JSON line a
run: ``initTime``, ``table_build_time``, solveTime, status and
objective, the warm-up's parts, the table levels (each one's wall s up
to a synchronize and device ms by CUDA events), the first level against
the others, the host's share of the build (``table_build_time`` less
the levels' wall) and its time before, between and after the levels,
and the caching allocator's reserved MB after each level. Each tree's
kernels are built first, in a process of their own.

``--sass-ab DIR`` builds the kernels of DIR and of this checkout, each
in a process of its own, and compares the SASS of every kernel the two
libraries share (``cuobjdump -sass``, function by function): one JSON
line with the kernels whose code is the same, those that differ (with
their SASS lines in each tree and the lines only one of them has), and
those of one tree only.
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
# (golomb marks, D, seed of the stores, cap): phase 3's stores of
# chip_smoke.py (golomb(12) seed 4, golomb(8) seed 5), other seeds, and
# the table build's cap over more than one wave of blocks.
K1_CASES = ((12, 512, 4, 10000), (12, 512, 5, 10000), (12, 1024, 5, 1 << 30),
            (12, 2048, 5, 1 << 30), (8, 1024, 5, 10000), (8, 2048, 5, 1 << 30))


# Runs the CLI (argv) with the solver's two EPS tail rounds timed, in
# the checkout that is the working directory, and prints their counts
# and seconds as a last line on stderr.
ROUND_TIMER = """
import json, sys, time
from turbo_tpu_torch import cli
from turbo_tpu_torch.solver.engine import BatchedSolver
rounds = {}


def timed(name):
    fn = getattr(BatchedSolver, name)

    def run(self, *a, **k):
        t0 = time.monotonic()
        res = fn(self, *a, **k)
        if res is not None:
            self._sync()
            n, sec = rounds.get(name, (0, 0.0))
            rounds[name] = (n + 1, sec + time.monotonic() - t0)
        return res
    setattr(BatchedSolver, name, run)


for name in ("_steal_open_branches", "_tail_resplit"):
    timed(name)
rc = cli.main(sys.argv[1:])
print("%rounds " + json.dumps(rounds), file=sys.stderr)
sys.exit(rc)
"""


def round_seconds(text, prefix):
    """(rounds, seconds) of the ``-v -v`` lines that start with
    ``prefix``; seconds is None when the lines carry no wall ms."""
    lines = re.findall(rf"^{prefix}.*$", text, re.M)
    ms = [float(m) for m in re.findall(rf"^{prefix}.*\(([\d.]+) ms\)$",
                                       text, re.M)]
    return len(lines), (sum(ms) / 1e3 if len(ms) == len(lines) and lines
                        else None if lines else 0.0)


def chunk_stats(text):
    """From the chunk lines of a ``-v -v`` run (empty without them): the
    mean over the chunks of the share of IDLE lanes after each
    (``idle_share``), the wall time at which the subproblem range was
    drained (``drain_s``), and the steps and nodes after it."""
    rows = re.findall(r"^% t=\s*([\d.]+)s steps=(\d+) \S+ nodes=(\d+) .* "
                      r"idle=(\d+)/(\d+) next_sub=(\d+)/(\d+)$", text, re.M)
    if not rows:
        return {}
    rows = [(float(r[0]),) + tuple(map(int, r[1:])) for r in rows]
    out = {"idle_share": sum(r[3] / r[4] for r in rows) / len(rows)}
    drain = next((r for r in rows if r[5] >= r[6]), None)
    if drain is not None:
        out.update(drain_s=drain[0],
                   steps_after_drain=rows[-1][1] - drain[1],
                   nodes_after_drain=rows[-1][2] - drain[2])
    return out


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
    rec["steal_rounds"], rec["steal_s"] = round_seconds(text_out,
                                                        "% stack steal #")
    rec["resplit_rounds"], rec["resplit_s"] = round_seconds(
        text_out, "% tail resplit #")
    rec.update(chunk_stats(text_out))
    return rec, text_out


def run_tree(tree, path, seconds, opts=(), log=None):
    """The CLI (the default search, with the options ``opts``) as a
    process of its own in checkout ``tree``, its EPS tail rounds timed
    (``ROUND_TIMER``); ``log``: a file for its output."""
    r = subprocess.run([sys.executable, "-c", ROUND_TIMER,
                        str(path), "-s", "-t", str(int(seconds * 1000)),
                        *opts],
                       cwd=tree, capture_output=True, text=True,
                       timeout=seconds * 3 + 300)
    if log is not None:
        log.write_text(r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"{tree}: the CLI returned {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    stats = dict(re.findall(r"^%%%mzn-stat: (\w+)=(.*)$", r.stdout, re.M))
    nodes, solve = int(stats["nodes"]), float(stats["solveTime"])
    rounds = json.loads(re.findall(r"^%rounds (.*)$", r.stderr, re.M)[-1])
    steal = rounds.get("_steal_open_branches", (0, 0.0))
    resplit = rounds.get("_tail_resplit", (0, 0.0))
    return {"status": "optimal" if "==========" in r.stdout else "sat"
            if "----------" in r.stdout else "unknown",
            "objective": int(stats["objective"]) if "objective" in stats
            else None, "nodes": nodes, "solve_time": solve,
            "nodes_per_s": nodes / solve,
            "init_time": float(stats["initTime"]),
            "table_build_time": float(stats.get("table_build_time", 0.0)),
            "steal_rounds": steal[0], "steal_s": steal[1],
            "resplit_rounds": resplit[0], "resplit_s": resplit[1],
            "auto_cap": re.findall(r"^% auto fp_cap=(\d+)", r.stdout, re.M),
            **chunk_stats(r.stdout)}


def k1_child(tree, dev="cuda:0"):
    """K1 and the table build of checkout ``tree``, imported from there,
    in this process, on ``dev``; one JSON line."""
    import time
    import numpy as np
    import torch
    from chip_smoke import median_ms, ptxas_lines, random_stores
    sys.path.insert(0, str(tree))  # after chip_smoke: this checkout's
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.instances import golomb
    from turbo_tpu_torch.kernels import build as kbuild
    from turbo_tpu_torch.solver import eps_table
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.engine import BatchedSolver
    kernels.load()
    log_file = kbuild.BUILD_DIR / "build.log"
    rec = {"tree": str(tree), "module": str(pathlib.Path(kernels.__file__)),
           "k1_ptxas": ptxas_lines(log_file.read_text() if log_file.exists()
                                   else "", "fixpoint_kernel")}
    solvers = {}
    for m, D in ((12, 512), (12, 2048), (8, 1024)):
        s = BatchedSolver(compile_model(parse_fzn_text(golomb(m))),
                          EngineConfig(num_dives=D), device=dev)
        if not solvers:
            # The process's first upload of kernel tables, table by table
            # (the four slowest): what a one-time cost of the first
            # KernelPlan is made of.
            up = {}
            for name, v in kernels.kernel_tables(s.dp).items():
                if isinstance(v, np.ndarray):
                    t0 = time.monotonic()
                    torch.as_tensor(v).to(dev)
                    torch.cuda.synchronize()
                    up[name] = (v.nbytes, time.monotonic() - t0)
            rec["first upload (bytes, s)"] = dict(sorted(
                up.items(), key=lambda kv: -kv[1][1])[:4])
        solvers.setdefault(m, s)
        t0 = time.monotonic()
        s.kernels.kernel_plan  # noqa: B018 (uploads the tables)
        torch.cuda.synchronize()
        out = {"tables_s": time.monotonic() - t0, "builds": []}
        for _ in range(3):
            launches = []
            plain = s.kernels.fixpoint

            def timed(lb, ub, cap):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                res = plain(lb, ub, cap)
                ev[1].record()
                launches.append((ev, lb.shape[0]))
                return res
            levels = []  # wall s of each dive_level call, synchronized
            level = eps_table.dive_level

            def timed_level(*args):
                t0 = time.monotonic()
                res = level(*args)
                torch.cuda.synchronize()
                levels.append(time.monotonic() - t0)
                return res
            s.kernels.fixpoint = timed
            eps_table.dive_level = timed_level
            try:
                tab = eps_table.build_table(s)
            finally:
                del s.kernels.fixpoint
                eps_table.dive_level = level
            torch.cuda.synchronize()
            out["builds"].append({
                "s": tab.build_time, "k1_launches": len(launches),
                "rows": sum(n for _, n in launches),
                "k1_ms": sum(a.elapsed_time(b) for (a, b), _ in launches),
                "first_level_s": levels[0], "other_levels_s": sum(levels[1:])})
        rec[f"golomb({m}) D={D} table build"] = out
    for m, D, seed, cap in K1_CASES:
        s = solvers[m]
        kp = s.kernels.kernel_plan
        lb, ub = (torch.as_tensor(a, device=dev) for a in random_stores(
            s.plan, None, D, np.random.default_rng(seed), None))
        iters = kernels.fixpoint(kp, lb, ub, cap)[2]
        rec[f"K1 golomb({m}) D={D} seed {seed} cap {cap}"] = {
            "ms": median_ms(lambda: kernels.fixpoint(kp, lb, ub, cap)),
            "max_sweeps": int(iters.max()) - 1,
            "sweeps": int(iters.long().sum()) - D}
    print(json.dumps(rec), flush=True)


def k1_ab(other, seconds=5.0):
    """``--k1-ab``: ``k1_child`` and a short default CLI run on golomb(12)
    in checkout ``other`` and in this one, in turns."""
    from turbo_tpu_torch.instances import golomb
    trees = [pathlib.Path(t).resolve() for t in (other, ROOT, ROOT, other)]
    for tree in trees:
        r = subprocess.run([sys.executable, str(ROOT / "chip_measure.py"),
                            "--k1-child", str(tree)], capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"{tree}: --k1-child returned {r.returncode}:"
                               f" {r.stderr[-3000:]}")
        print(r.stdout.strip().splitlines()[-1], flush=True)
    path = OUT / "golomb12.fzn"
    path.write_text(golomb(12))
    for tree in trees:
        print(json.dumps({"instance": "golomb(12)", "config": "cli",
                          "tree": str(tree),
                          **run_tree(tree, path, seconds)}), flush=True)


def table_ab(other):
    """``--table-ab``: the table build of checkout ``other`` and of this
    one, a new process a run, in turns (see the module's docstring)."""
    from chip_smoke import fresh_cli
    from turbo_tpu_torch.instances import golomb
    other = pathlib.Path(other).resolve()
    for tree in (other, ROOT):
        r = subprocess.run([sys.executable, "-c", "from turbo_tpu_torch "
                            "import kernels; kernels.load()"], cwd=tree,
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"{tree}: kernel build failed: "
                               f"{r.stderr[-3000:]}")
    turns = ((other, False), (ROOT, False), (ROOT, True), (ROOT, True),
             (ROOT, False), (other, False))
    for m, limit in ((8, ()), (12, ("-t", "3000"))):
        path = OUT / f"golomb{m}.fzn"
        path.write_text(golomb(m))
        for opts in ((), ("-fp", "wac1")):
            for tree, cold in turns:
                rec = fresh_cli(tree, [str(path), "-s", *limit, *opts],
                                cold=cold)
                walls = [w for w, _ in rec["levels"]]
                dev_ms = [d for _, d in rec["levels"]]
                print(json.dumps({
                    "instance": f"golomb({m})", "opts": " ".join(opts),
                    "tree": str(tree), "cold": cold,
                    **{k: rec[k] for k in (
                        "status", "objective", "init_time",
                        "table_build_time", "solve_time", "nodes",
                        "process_s", "warm_up")},
                    "warm_up_s": sum(rec["warm_up"].values()),
                    "levels": len(walls),
                    "first_level": rec["levels"][0],
                    "other_levels_wall_s": sum(walls[1:]),
                    "other_levels_median": [
                        sorted(walls[1:])[(len(walls) - 1) // 2],
                        sorted(dev_ms[1:])[(len(walls) - 1) // 2]]
                    if len(walls) > 1 else None,
                    "levels_device_ms": sum(dev_ms),
                    "host_s": rec["table_build_time"] - sum(walls),
                    "level_ms": [[round(1e3 * w, 4), round(d, 4)]
                                 for w, d in rec["levels"]],
                    "host_gaps_ms": [round(g, 3)
                                     for g in rec["host_gaps_ms"]],
                    "reserved_mb": [round(b / 2 ** 20, 1)
                                    for b in rec["reserved"]]}), flush=True)


def sass_by_kernel(lib):
    """{mangled kernel name: its SASS lines} of a built library."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", lib],
                         capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and line.strip():
            funcs[name].append(line.strip())
    return funcs


def sass_ab(other):
    """The SASS of each kernel of ``other``'s library against this
    checkout's, each built in a process of its own."""
    libs = []
    for tree in (pathlib.Path(other).resolve(), ROOT):
        r = subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]); "
             "from turbo_tpu_torch.kernels import build; "
             "print(build.load()._name)", str(tree)],
            capture_output=True, text=True, cwd=tree)
        if r.returncode != 0:
            raise RuntimeError(f"{tree}: the kernel build failed:\n"
                               f"{r.stderr[-4000:]}")
        libs.append(r.stdout.strip().splitlines()[-1])
    a, b = (sass_by_kernel(lib) for lib in libs)
    both = sorted(set(a) & set(b))
    print(json.dumps({
        "tree": other,
        "same": [k for k in both if a[k] == b[k]],
        # (its SASS lines there, here; lines in one and not the other)
        "differ": {k: (len(a[k]), len(b[k]),
                       len(set(a[k]) ^ set(b[k])))
                   for k in both if a[k] != b[k]},
        "only_other": sorted(set(a) - set(b)),
        "only_this": sorted(set(b) - set(a))}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--big", type=int, default=12)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--ab", default="")
    ap.add_argument("--opts", default="")
    ap.add_argument("--k1-ab", default="")
    ap.add_argument("--k1-child", default="", help=argparse.SUPPRESS)
    ap.add_argument("--table-ab", default="")
    ap.add_argument("--sass-ab", default="")
    args = ap.parse_args()
    if args.sass_ab:
        sass_ab(args.sass_ab)
        return 0
    if args.k1_child:
        k1_child(pathlib.Path(args.k1_child))
        return 0
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
    if args.k1_ab:
        k1_ab(args.k1_ab)
        return 0
    if args.table_ab:
        table_ab(args.table_ab)
        return 0
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
        for i, tree in enumerate((args.ab, str(ROOT), str(ROOT), args.ab)):
            rec = run_tree(pathlib.Path(tree).resolve(), path, args.seconds,
                           args.opts.split(), OUT / f"ab_{i}.log")
            print(json.dumps({"instance": f"golomb({args.big})",
                              "config": f"cli {args.opts}".strip(),
                              "tree": tree, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
