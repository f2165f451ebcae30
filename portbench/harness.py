"""The harness behind ``run.py``: finds a cell's files by the names in
``BENCHMARK.json``, drives the program's CLI entry in process
(``turbo_tpu_torch.cli.run``, its standard output captured and stamped),
traces a run with ``torch.profiler`` and the harness's own spans, and
reduces the trace to device busy time, kernel time and idle gaps.

Everything a configuration, a traffic mix, a regime or a metric needs is
a file of its own: ``configs/<config>.json``, ``traffic/<mix>.json``,
``regimes/<regime>.py``, ``generators/<generator>.py`` and
``metrics/<metric>.py``, found by name.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import pathlib
import random
import re
import statistics
import sys
import time

from . import reference

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# Fixed cache directories inside the checkout, so that only a cell's
# first run there builds.
CACHE = ROOT / ".portbench_cache"
# Top-level module names that must not be loaded by a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "turbo_tpu")
SPAN = "portbench."
# The keys of every traffic file; a regime reads its own ``PARAMS`` too.
TRAFFIC_KEYS = ("regime", "generator", "size", "expect", "limits", "source",
                "why")


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: pathlib.Path, kind: str):
    """Import ``path`` (a file named after a benchmark name, which may
    hold dots) as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no {kind} file {path}")
    name = f"portbench_{kind}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is one of ``FORBIDDEN``."""
    return sorted(k for k in list(sys.modules)
                  if k.split(".", 1)[0] in FORBIDDEN)


def cache_env():
    """Every build and kernel cache the run may touch, in fixed
    directories inside the checkout. The kernel library of the program
    builds into ``turbo_tpu_torch/kernels/_build`` by itself."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def process_start_s() -> float | None:
    """Seconds since this process started, from ``/proc`` (10 ms steps);
    None where it cannot be read."""
    try:
        fields = pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
        start_ticks = int(fields.split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class StampedText(io.TextIOBase):
    """A text sink that keeps what is written and the time at which the
    first final separator ``==========`` was written."""

    def __init__(self):
        self.parts = []
        self.t_final = None

    def writable(self):
        return True

    def write(self, s):
        if self.t_final is None and "==========" in s:
            self.t_final = time.monotonic()
        self.parts.append(s)
        return len(s)

    def text(self) -> str:
        return "".join(self.parts)


@dataclasses.dataclass
class Request:
    path: str
    argv: list
    t_start: float
    t_end: float = 0.0
    t_final: float | None = None   # when ``==========`` was printed
    out: str = ""
    err: str = ""
    stats: dict = dataclasses.field(default_factory=dict)
    steps: int = 0                 # traced runs: steps the program ran
    launches: int = 0              # traced runs: kernel launches
    tail_s: float = 0.0            # traced runs: steal and resplit rounds
    judged: reference.Judged | None = None

    @property
    def wall_s(self) -> float:
        return self.t_end - self.t_start

    def stat(self, key, default=None):
        v = self.stats.get(key)
        return default if v is None else float(v)


def quantile(values, q: int, n: int) -> float:
    """The q-th of the n-quantiles, as ``statistics.quantiles`` gives
    them (its default, exclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=n)[q - 1]


class Cell:
    """One run of one cell: its configuration, traffic, generator and
    regime, the requests it made and what the trace read."""

    def __init__(self, spec: dict, workload: str, seed: int, seconds: float,
                 trace: bool, platform: str | None = None,
                 workdir: str | None = None, t_process: float = 0.0,
                 root: pathlib.Path = ROOT):
        wl = {w["name"]: w for w in spec["workloads"]}
        if workload not in wl:
            raise KeyError(f"portbench: no workload {workload!r} in "
                           "BENCHMARK.json")
        self.spec = spec
        self.workload = wl[workload]
        self.bench = bench = pathlib.Path(root) / BENCH.name
        conf = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        self.config = json.loads((pathlib.Path(root) / conf["file"]).read_text())
        self.traffic = json.loads(
            (bench / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.generator = load_module(
            bench / "generators" / f"{self.traffic['generator']}.py",
            "generator")
        self.regime = load_module(
            bench / "regimes" / f"{self.traffic['regime']}.py", "regime")
        unread = set(self.traffic) - set(TRAFFIC_KEYS) - set(self.regime.PARAMS)
        if unread:
            raise ValueError(f"portbench: traffic {self.workload['traffic']!r}"
                             f" has keys that no part reads: {sorted(unread)}")
        self.seed = seed
        self.seconds = seconds
        self.trace = bool(trace)
        self.platform = platform
        self.workdir = pathlib.Path(workdir) if workdir else None
        self.t_process = t_process
        self.requests = []          # the window's requests
        self.window_open = self.window_close = None
        self.tracer = None
        self.models = {}            # path -> reference.Model

    # -- inputs --------------------------------------------------------

    def model_text(self, i: int) -> str:
        """Request i's model: the traffic's instance, its constraints in
        an order drawn from (seed, i)."""
        order = random.Random(f"{self.seed}/{i}").getrandbits(63)
        return self.generator.generate(self.traffic["size"], order)

    def write_models(self, n: int) -> list:
        paths = []
        for i in range(n):
            p = self.workdir / f"{self.workload['traffic']}_{i}.fzn"
            text = self.model_text(i)
            p.write_text(text)
            self.models[str(p)] = reference.parse(text)
            paths.append(str(p))
        return paths

    # -- the program ---------------------------------------------------

    def argv(self, path: str, timeout_ms: int | None, extra=()) -> list:
        argv = [path, *self.config["flags"], "-s",
                "-seed", str(self.seed % (1 << 62))]
        if timeout_ms is not None:
            argv += ["-t", str(int(timeout_ms))]
        argv += list(extra)
        if self.trace:
            argv.append("-v")
        if self.platform is not None:
            argv += ["-platform", self.platform]
        return argv

    def solve(self, path: str, timeout_ms: int | None = None,
              extra=()) -> Request:
        """One request: the CLI entry on ``path``, in this process, its
        standard output and error captured."""
        from turbo_tpu_torch import cli
        from turbo_tpu_torch.host.utils.config import parse_args
        argv = self.argv(path, timeout_ms, extra)
        cfg = parse_args(argv)
        out, err = StampedText(), io.StringIO()
        req = Request(path, argv, time.monotonic())
        tr = self.tracer
        if tr is not None:
            tr.begin_request(req)
        run = cli.run if tr is None else tr.wrap(cli.run, "request")
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run(cfg)
        req.t_end = time.monotonic()
        if tr is not None:
            tr.end_request(req)
        req.t_final, req.out, req.err = out.t_final, out.text(), err.getvalue()
        req.stats = reference.stats(req.out)
        if rc != 0:
            raise RuntimeError(f"portbench: the CLI returned {rc}: "
                               f"{req.err[-2000:]}")
        return req

    def open_window(self):
        self.window_open = time.monotonic()

    def close_window(self):
        self.window_close = time.monotonic()

    # -- the verdict ---------------------------------------------------

    def judge(self) -> dict:
        """Each window request judged by the reference; returns the
        compared numbers, each with its limit."""
        expect = self.traffic["expect"]
        optimum = getattr(self.generator, "OPTIMUM", {}).get(
            self.traffic["size"])
        limits = self.limits()
        totals = dict.fromkeys(limits, 0)
        for req in self.requests:
            model = self.models[req.path]
            req.judged = reference.judge(
                model, reference.read_output(model, req.out), expect, optimum)
            for k in totals:
                totals[k] += getattr(req.judged, k)
        if not self.requests:
            totals["unproved" if expect == "proof" else "unanswered"] = 1
        return {k: {"value": v, "limit": limits[k]}
                for k, v in totals.items()}

    def limits(self) -> dict:
        """The numbers compared for this traffic, each with its limit:
        the reference's, and those the traffic file states."""
        limits = {**reference.LIMITS, **self.traffic.get("limits", {})}
        return {k: limits[k] for k in reference.COMPARED[
            self.traffic["expect"]] if k in limits}

    def failed(self) -> int:
        limits = self.limits()
        return sum(r.judged.failed(limits) for r in self.requests)


class Tracer:
    """A traced run: spans around the calls into each layer of the
    program (``torch.profiler.record_function``, and the harness's own
    clock where a metric needs it), the steps and launches the program
    counted, and ``torch.profiler`` over one slice of the window."""

    LAYERS = (  # (module, attribute, span)
        ("turbo_tpu_torch.cli", "parse_fzn", "parse"),
        ("turbo_tpu_torch.cli", "compile_model", "compile"),
        ("turbo_tpu_torch.solver.eps_table", "build_table", "table_build"),
    )
    METHODS = (  # BatchedSolver methods: (attribute, span)
        ("__init__", "solver_init"),
        ("solve", "solve"),
    )

    def __init__(self, torch_mod):
        self.torch = torch_mod
        self.prof = None
        self.active = False
        self.slice_rf = None
        self.slice_steps = 0
        self.summary = None
        self.req = None
        self._acc = None
        self._in_steps = False
        self._saved = []            # (owner, attribute, original)
        self.on_chunk = None        # called before each chunk of steps
        self.stack = []             # the spans open now, innermost last
        self.outer = "harness"      # the innermost span open at the slice

    def _span(self, name):
        return self.torch.profiler.record_function(SPAN + name)

    def install(self):
        """Wraps the layer entry points, in this process, until
        ``uninstall``."""
        import importlib

        from turbo_tpu_torch.solver.engine import BatchedSolver

        def put(owner, attr, make):
            orig = getattr(owner, attr)
            self._saved.append((owner, attr, orig))
            setattr(owner, attr, make(orig))
        for modname, attr, span in self.LAYERS:
            put(importlib.import_module(modname), attr,
                lambda f, span=span: self.wrap(f, span))
        for attr, span in self.METHODS:
            put(BatchedSolver, attr, lambda f, span=span: self.wrap(f, span))
        for attr, span in (("_steal_open_branches", "steal"),
                           ("_tail_resplit", "resplit")):
            put(BatchedSolver, attr, lambda f, span=span: self._tail(f, span))
        for attr in ("run_steps", "_profiled_steps"):
            put(BatchedSolver, attr, self._steps)

    def uninstall(self):
        while self._saved:
            owner, attr, orig = self._saved.pop()
            setattr(owner, attr, orig)

    def wrap(self, fn, span):
        """``fn`` run inside span ``span``."""
        def run(*a, **k):
            self.stack.append(span)
            try:
                with self._span(span):
                    return fn(*a, **k)
            finally:
                self.stack.pop()
        run.__wrapped__ = fn
        return run

    def _tail(self, fn, span):
        """A steal or resplit round, timed up to a synchronize when it
        made a round (``chip_measure.py``'s ``ROUND_TIMER``)."""
        def run(solver, *a, **k):
            t0 = time.monotonic()
            with self._span(span):
                res = fn(solver, *a, **k)
                if res is not None:
                    solver._sync()
            if res is not None and self.req is not None:
                self.req.tail_s += time.monotonic() - t0
            return res
        return run

    def _steps(self, fn):
        """A chunk of steps: its enqueue as a span, and the steps it ran
        added on the device (no host read) to the request's count and,
        while the slice is traced, to the slice's."""
        def run(solver, *a, **k):
            if self._in_steps:
                return fn(solver, *a, **k)
            if self.on_chunk is not None:
                self.on_chunk()
            self._in_steps = True
            try:
                with self._span("steps"):
                    res = fn(solver, *a, **k)
            finally:
                self._in_steps = False
            ran = res[1]
            if self._acc is None or self._acc.device != ran.device:
                self._acc = self.torch.zeros(2, dtype=self.torch.int64,
                                             device=ran.device)
            self._acc.select(0, int(self.active)).add_(ran)
            return res
        return run

    def begin_request(self, req):
        from turbo_tpu_torch import kernels
        self.req = req
        self._launch0 = sum(v for k, v in kernels.launch_counts().items()
                            if "." not in k)
        if self._acc is not None:
            self._acc.zero_()

    def end_request(self, req):
        from turbo_tpu_torch import kernels
        req.launches = sum(v for k, v in kernels.launch_counts().items()
                           if "." not in k) - self._launch0
        if self._acc is not None:
            off, on = (int(x) for x in self._acc.tolist())
            req.steps = off + on
            self.slice_steps += on
            self._acc.zero_()
        self.req = None

    # -- the profiler --------------------------------------------------

    def _profile(self):
        tp = self.torch.profiler
        acts = [tp.ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(tp.ProfilerActivity.CUDA)
        return tp.profile(activities=acts)

    def first_start(self):
        """Set-up: the profiler's first start in a process is slow
        (CUPTI's initialisation), so it is paid here, once."""
        with self._profile():
            if self.torch.cuda.is_available():
                x = self.torch.ones(1024, device="cuda")
                (x + 1).sum().item()

    def start_slice(self):
        if self.prof is not None:
            return
        # Spans opened before the profiler started are not in its trace.
        self.outer = self.stack[-1] if self.stack else "harness"
        self.prof = self._profile()
        self.prof.start()
        self.slice_rf = self._span("slice")
        self.slice_rf.__enter__()
        self.active = True

    def stop_slice(self):
        if not self.active:
            return
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.slice_rf.__exit__(None, None, None)
        self.active = False
        self.prof.stop()

    def reduce(self):
        """The slice's device busy and idle time, device time by
        operation, and idle gaps by the innermost harness span around
        them."""
        if self.prof is None:
            return None
        self.summary = reduce_events(_events(self.prof), self.outer)
        return self.summary


def _events(prof):
    """(name, on_device, start_ns, end_ns) of every event the profiler
    kept."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = e.start_us() * 1000, e.duration_us() * 1000
        name = e.name()
        # A span's copy on the device's timeline is no device operation.
        dev = (str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"
               and not name.startswith(SPAN)
               and "annotation" not in str(getattr(e, "activity_type",
                                                   lambda: "")()))
        out.append((name, dev, int(s), int(s) + int(d)))
    return out


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: float            # device operations' time summed
    device_ops: list           # [[name, seconds]], the ten largest
    idle_gaps: list            # [[span, seconds]], the ten largest


def reduce_events(events, outer: str = "harness") -> TraceSummary | None:
    """``outer``: the label of a gap that no span in the trace covers
    (the innermost span open when the slice began)."""
    slices = [(s, e) for n, dev, s, e in events
              if not dev and n == SPAN + "slice"]
    if not slices:
        return None
    s0, s1 = slices[0]
    dev = sorted((max(s, s0), min(e, s1), n) for n, d, s, e in events
                 if d and e > s0 and s < s1)
    by_name = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0) + (e - s)
    busy, gaps, cur = 0, [], s0
    for s, e, _ in dev:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if s1 > cur:
        gaps.append((cur, s1))
    # The spans of one thread nest: sweep them and the gaps in time
    # order, with the spans open at a gap's middle on a stack.
    spans = sorted(((s, e, n[len(SPAN):]) for n, d, s, e in events
                    if not d and n.startswith(SPAN) and n != SPAN + "slice"),
                   key=lambda x: (x[0], -x[1]))
    idle, stack, j = {}, [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while j < len(spans) and spans[j][0] <= mid:
            s, e, n = spans[j]
            j += 1
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((e, n))
        while stack and stack[-1][0] < mid:
            stack.pop()
        label = stack[-1][1] if stack else outer
        idle[label] = idle.get(label, 0) + (g1 - g0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=(s1 - s0) / 1e9, busy_s=busy / 1e9,
        device_s=sum(by_name.values()) / 1e9,
        device_ops=[[n, t / 1e9] for n, t in top],
        idle_gaps=[[n, t / 1e9] for n, t in
                   sorted(idle.items(), key=lambda kv: -kv[1])[:10]])


def idle_pct(cell):
    """The traced slice's share with no device operation running; None
    where the slice saw no device operation."""
    s = cell.tracer.summary if cell.tracer is not None else None
    if s is None or s.busy_s <= 0 or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
