#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the CUDA card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell names a configuration
(``configs/<config>.json``: the CLI flags of a deployment) and a traffic
mix (``traffic/<mix>.json``: a generator, its size, the regime that
sends it). The regime (``regimes/<regime>.py``) makes the set-up, opens
the window and sends the requests through the program's CLI entry,
``turbo_tpu_torch.cli.run``, in this process. Once the window has closed
the plain reference (``reference.py``) judges every request's output,
and the metrics of the cell (``metrics/<metric>.py``, one reader each)
are read: with ``--trace 0`` its end-to-end metrics, with ``--trace 1``
its per-layer metrics from a traced run.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit); the numbers compared are also the last lines of standard error.
Without a card, or with fewer cards than the cell asks for, or when a
module of JAX or of the JAX package was loaded, it exits with a code
other than 0 and prints no result.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: with ``trace`` the
    per-layer metrics that list it (or, without a list, that move one of
    its end-to-end metrics), else its end-to-end metrics."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, platform=None, t_process=None,
             root: pathlib.Path = ROOT, setup_parts=None) -> dict:
    """One run of the cell; returns the result object. ``platform``
    "cpu" runs the program's plain versions (the harness's tests); the
    benchmark itself always runs on the card. ``setup_parts``: the
    seconds of set-up already spent, by part, to which the profiler's
    first start and the cell's warm-up are added."""
    import torch

    from portbench import harness

    cell = harness.Cell(spec, workload, seed, seconds, trace,
                        platform=platform,
                        t_process=T0 if t_process is None else t_process,
                        root=root)
    cuda = platform is None
    with tempfile.TemporaryDirectory(prefix="portbench-") as wd:
        cell.workdir = pathlib.Path(wd)
        parts = dict(setup_parts or {})
        t = time.monotonic()
        if trace:
            cell.tracer = harness.Tracer(torch)
            cell.tracer.install()
            cell.tracer.first_start()
            parts["profiler_first_start"] = time.monotonic() - t
            t = time.monotonic()
        try:
            cell.regime.run(cell)
        finally:
            if trace:
                cell.tracer.uninstall()
        parts["warmup"] = cell.window_open - t
        summary = cell.tracer.reduce() if trace else None
        if cuda:
            torch.cuda.synchronize()
            device = {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": cell.workload["chips"],
                      "memory_peak_bytes": max(
                          torch.cuda.max_memory_allocated(i)
                          for i in range(cell.workload["chips"]))}
        else:
            device = {"platform": "cpu", "kind": "cpu", "count": 1,
                      "memory_peak_bytes": 0}
        if summary is not None:
            device.update(busy_s=summary.busy_s, window_s=summary.window_s)
        checks = cell.judge()
        metrics = {}
        for m in cell_metrics(spec, workload, trace):
            reader = harness.load_module(
                cell.bench / "metrics" / f"{m['name']}.py", "metric")
            v = reader.read(cell)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(cell.requests) and all(
                  c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(cell.requests), "failed": cell.failed(),
              "metrics": metrics, "device": device}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["setup_parts"] = parts
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from portbench import harness

    ago = harness.process_start_s()
    t_process = T0 if ago is None else time.monotonic() - ago
    spec = harness.load_spec()
    wl = {w["name"]: w for w in spec["workloads"]}.get(a.workload)
    if wl is None:
        print(f"portbench: no workload {a.workload!r}", file=sys.stderr)
        return 2
    harness.cache_env()
    parts = {"interpreter": T0 - t_process}
    t = time.monotonic()
    import torch
    parts["torch_import"] = time.monotonic() - t
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: {a.workload} needs {wl['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 2
    t = time.monotonic()
    for i in range(wl["chips"]):
        torch.zeros(1, device=f"cuda:{i}")
        torch.cuda.synchronize(i)
    parts["cuda_context"] = time.monotonic() - t
    t = time.monotonic()
    import turbo_tpu_torch.cli  # noqa: F401
    from turbo_tpu_torch.kernels import build
    parts["program_import"] = time.monotonic() - t
    t = time.monotonic()
    build.load()
    # Apart: a run that built the kernel library (a checkout's first).
    parts["kernel_build" if build.build_log else "kernel_load"] = \
        time.monotonic() - t
    result = run_cell(spec, a.workload, a.seed, a.seconds, bool(a.trace),
                      t_process=t_process, setup_parts=parts)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package were "
              f"loaded: {', '.join(bad[:20])}", file=sys.stderr)
        return 3
    for name, v in result["setup_parts"].items():
        print(f"setup {name} {v:.4f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
