#!/usr/bin/env python3
"""What tracing costs end to end: ``nodes_per_s`` of a window cell of
``BENCHMARK.json`` (the CLI through ``portbench``'s harness, in process,
no profiler) with ``-v`` and without, in the order given.

    python3 scripts/trace_cost.py --root <checkout> --workload <cell> \\
        --seed <n> --seconds <s> --order off,on,on,off [--cap 8]

runs the program and the harness of the checkout at ``--root`` (this
tree by default), one warm-up solve first as the window regime makes,
and prints one JSON line a window on standard output. ``--cap`` pins the
fixpoint cap (``BatchedSolver.solve(fp_cap=...)``), so that the runs do
not split by the cap the calibrator locks.
"""
import argparse
import json
import pathlib
import re
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                         .parent.parent))
    p.add_argument("--workload", default="default.golomb12_window")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--order", default="off,on,on,off")
    p.add_argument("--cap", type=int, default=0)
    a = p.parse_args(argv)
    root = pathlib.Path(a.root).resolve()
    sys.path.insert(0, str(root))
    from portbench import harness
    harness.cache_env()
    import torch
    from turbo_tpu_torch.kernels import build
    build.load()
    if a.cap:
        from turbo_tpu_torch.solver.engine import BatchedSolver
        solve = BatchedSolver.solve
        BatchedSolver.solve = lambda self, *args, **kw: solve(
            self, *args, **dict(kw, fp_cap=a.cap))
    import tempfile
    cell = harness.Cell(harness.load_spec(root), a.workload, a.seed,
                        a.seconds, False, root=root)
    t = cell.traffic
    with tempfile.TemporaryDirectory(prefix="trace-cost-") as wd:
        cell.workdir = pathlib.Path(wd)
        (path,) = cell.write_models(1)
        cell.solve(path, timeout_ms=t["warmup_timeout_ms"],
                   extra=["-cutnodes", str(t["warmup_cutnodes"])])
        for mode in a.order.split(","):
            req = cell.solve(path, timeout_ms=a.seconds * 1000,
                             extra=["-v"] if mode == "on" else [])
            cap = re.search(r"; fp_cap=(\d+)$", req.err, re.M)
            print(json.dumps({
                "root": str(root), "mode": mode, "seed": a.seed,
                "device": torch.cuda.get_device_name(0),
                "nodes_per_s": req.stat("nodes") / req.wall_s,
                "wall_s": req.wall_s,
                "fp_cap": int(cap[1]) if cap else (a.cap or None),
                "at": time.time()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
