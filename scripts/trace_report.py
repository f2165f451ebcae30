#!/usr/bin/env python3
"""A traced run of a cell of ``BENCHMARK.json`` (the run of
``portbench/run.py --trace 1``), read against the program's own spans
(``turbo_tpu_torch/trace.py``): the device's idle time in the traced
slice by the innermost program span around it, the share of it that
some span covers, the chunks that start in the slice, and each span's
mean total and self time a request from the ``% trace`` lines.

    python3 scripts/trace_report.py --workload <cell> --seed <n> \\
        --seconds <s>

from the root of a checkout, on the CUDA card. Prints the result line's
metrics and these figures as one JSON line on standard output.
"""
import argparse
import json
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SPAN_LINE = re.compile(r"^% trace: (\S+) n=(\d+) total_ms=([\d.]+) "
                       r"self_ms=([-\d.]+)$", re.M)


def slice_report(events, records) -> dict:
    """The traced slice's device idle laid over the program's spans."""
    from portbench import harness
    from turbo_tpu_torch import trace
    # The slice's range as the harness reads it (its first record).
    s0, s1 = [(s, e) for n, dev, s, e in events
              if not dev and n == harness.SPAN + "slice"][0]
    busy = sorted((max(s, s0), min(e, s1)) for n, dev, s, e in events
                  if dev and e > s0 and s < s1)
    gaps, cur = [], s0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if s1 > cur:
        gaps.append((cur, s1))
    by_span, covered = trace.idle_by_span(gaps, records)
    idle = sum(g1 - g0 for g0, g1 in gaps)
    chunks = [r for r in records if r.name == "chunk" and s0 <= r.start_ns
              < s1]
    waits = {r.parent: r.end_ns - r.start_ns for r in records
             if r.name == "chunk.wait"}
    host = sum(r.end_ns - r.start_ns - waits.get(r.span, 0) for r in chunks)
    return {"slice_s": (s1 - s0) / 1e9, "idle_s": idle / 1e9,
            "covered_pct": 100.0 * covered / idle if idle else None,
            "idle_by_span": {str(k): v / 1e9 for k, v in sorted(
                by_span.items(), key=lambda kv: -kv[1])},
            "slice_chunks": len(chunks), "slice_chunk_host_s": host / 1e9}


def span_means(requests) -> dict:
    """Each span name's mean (n, total ms, self ms) a request."""
    sums = {}
    for req in requests:
        for m in SPAN_LINE.finditer(req.err):
            s = sums.setdefault(m[1], [0, 0.0, 0.0])
            s[0] += int(m[2])
            s[1] += float(m[3])
            s[2] += float(m[4])
    n = max(len(requests), 1)
    return {k: [v / n for v in s] for k, s in sorted(sums.items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    from portbench import harness, run
    harness.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("trace_report: needs the CUDA card", file=sys.stderr)
        return 2
    from turbo_tpu_torch import trace
    from turbo_tpu_torch.kernels import build
    build.load()
    kept = {}
    reduce, judge = harness.Tracer.reduce, harness.Cell.judge

    def reduce_kept(tracer):
        if tracer.prof is not None:
            kept["events"] = harness._events(tracer.prof)
            kept["records"] = trace.spans()
        return reduce(tracer)

    def judge_kept(cell):
        kept["cell"] = cell
        return judge(cell)
    harness.Tracer.reduce, harness.Cell.judge = reduce_kept, judge_kept
    # On for the whole run, so that the records of every request in the
    # slice stay (the CLI then leaves tracing on between requests).
    trace.enable()
    res = run.run_cell(harness.load_spec(), a.workload, a.seed, a.seconds,
                       True)
    out = {"workload": a.workload, "seed": a.seed,
           "device": torch.cuda.get_device_name(0),
           "correct": res["correct"], "attempted": res["attempted"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "busy_s": res["device"].get("busy_s"),
           "window_s": res["device"].get("window_s"),
           "idle_gaps": res["breakdown"]["idle_gaps"],
           "span_means": span_means(kept["cell"].requests)}
    if "events" in kept:
        out.update(slice_report(kept["events"], kept["records"]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
