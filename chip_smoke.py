#!/usr/bin/env python3
"""Smoke test of turbo_tpu_torch on one CUDA card: ``python3 chip_smoke.py``.

Run from the root of the repository (``--kernels-only`` stops after
phase 3c; ``--hosts-only`` runs phases 1, 2 and 13). Phases (any failure
exits non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the kernel build with nvcc (one per source, in parallel) from a cold
   ``turbo_tpu_torch/kernels/_build``;
3. each kernel against its plain torch version on the same CUDA tensors,
   every output exactly equal (tolerance 0: all integer), with the median
   time of both: K1-K3 on 4 seeded random models at D=1024 with randomly
   narrowed stores and stores fixed at a solution, and on golomb(8) at
   D=1024 and golomb(12) at D=512; K4 (embed and table refill) and K5 (open-branch count) on
   random stores, table rows, masks and stacks at golomb(12)'s shapes
   (W=D=512, V=2560, 2048 table rows, MAXD=10000); on the same stores
   K8 (WAC1: outer caps 2 and 10000, inner caps 1 and 16; iters, unconv
   and bot of every lane, the store of every lane that is not bot) and
   K1's other entries (2 and 5 fixed sweeps; the fixpoint on transposed
   (V, D) planes at caps 2 and 10000), each on the shared-memory and the
   global-memory path (K1's fixpoint entry at caps 2 and 10000 on both).
   K1's ``-Xptxas -v`` lines (registers, shared memory, spills) are
   printed. The golomb(12) times go into the JSON line;
3b. K6 and K7 (the step's own kernels) against the plain step on the
   same CUDA state, every SearchState field exactly equal after 1, 7 and
   40 steps, and the kernels' step counter equal to the plain steps
   that found a live lane: golomb(12) at D=512 with the table on, the 6
   random models of phase 4 with the table off, queens(8) with
   enumerate_all and the solution ring; the same for the step with K8
   (``fp_mode="wac1"``), with fixed sweeps and with the transposed entry
   (``fp_layout="vd"``) on golomb(12) and on random models; then, on
   each golomb(12) state, the time of each kernel entry inside real
   steps (CUDA events between the launches) against the plain step's
   three parts, and the fixpoint iterations per node; then the K1 step
   again from the same state with K1 built with ``-DTT_K1_NO_SKIP`` (no
   skip of unmoved rules) and as built, in turns (on, off, off, on);
3d. the step over S=4 EPS shards, lane groups of one state (K6 over
   every lane, K7 per shard: ``parallel/mesh.py``), against the plain
   sharded step on the same CUDA state, every field equal after 1, 7
   and 40 steps and three chunks of 8 (CUDA graph): golomb(12) at D=512
   a shard with the table on, the 6 random models with the table off,
   queens(8) with enumerate_all and the rings; then each kernel's time
   inside 20 real golomb(12) steps at S=4, K7's against 3b's S=1;
3c. the step loop on golomb(12), D=512, table on, cap 16: chunks of 16
   steps under ``torch.cuda.set_sync_debug_mode("error")`` (any host
   sync inside a chunk fails the phase), launches per step, wall time
   per step, and from ``torch.profiler`` the device kernels and busy
   time per step, for the kernel route and for the plain step; then the
   same chunk captured once in a CUDA graph and replayed; the same loop
   (without the plain step) under ``wac1``, ``fixed`` and ``vd``, the
   last against ``dv`` in turns (dv, vd, vd, dv), then K1 without the
   skip against K1 as built (off, off, on);
4. the solver API on the card against the port's engine on the CPU with
   the plain versions, on 6 small seeded models, steal and resplit
   stubbed out on both: nodes, failures, solutions and fixpoint
   iterations equal, (a) in the default table mode with the cap pinned
   at 4 and (b) with the table off at cap 10000; (c) the default CLI
   (``turbo_tpu_torch.cli.main``: EPS table, cap calibration, steal and
   resplit) on the same models against the shared numpy oracle: status
   and objective equal;
5. golomb(8) through the default CLI proven optimal at 34;
5b. golomb(8) with the cap pinned at 16 (table on, auto D, steal and
   resplit stubbed out): the kernel engine and the plain engine
   (``step_plain`` and the plain fixpoint, classify and select, also in
   the table build) on the card give the same status, objective, nodes,
   failures, solutions and fixpoint iterations;
6. the main path: golomb(12) through the default CLI at full width
   (``-or 0``, ``-t 60000``): every printed solution checked against the
   model by ``utils/checker.py``; the table build time, live table rows,
   the calibrator's sweep and steal/resplit rounds are printed;
7. the table-off path: golomb(12) at D=512 through the solver API with
   ``use_table=False``, ``fp_cap_auto=False`` for 15 s, its best
   solution checked;
8. a drain-forcing case (golomb(8), D=64 lanes over 2^4 subproblems, the
   default configuration) proven optimal at 34, so that the steal gate
   and K5 run; then the host round trip of a golomb(12) table-mode state
   (D=512, MAXD=10000) and one steal round on it, timed;
9. ``-a`` on queens(8) through the card CLI: 92 distinct checker-valid
   solution blocks and the final separator;
10. ``-i -t 30000`` on golomb(9) through the card CLI: every streamed
   block checker-valid, the last one at the final objective (44 when
   the run closes);
10b. ``-fp wac1`` on golomb(12) through the card CLI at full width
   (``-or 0``, ``-t 30000``): every solution checker-valid, K8 launched
   once per table level and once per step, K1 never;
10c. ``fp_mode="fixed"`` and ``fp_layout="vd"`` on golomb(12), D=512,
   through the solver API for 8 s each, the best solution checked;
10d. ``-arch hybrid`` on golomb(12) through the card CLI (``-or 0``,
   ``-t 15000``): solutions checker-valid, one K1 and one K2 launch per
   round;
10e. golomb(8) proven optimal at 34 under ``-fp wac1``, ``-arch hybrid``
   and both together (the hybrid searches with 128 cubes over 2^10
   subproblems);
10f. ``-checkpoint``: golomb(9) cut by ``-cutnodes``, resumed from the
   file and closed at 44, on the batched engine and under
   ``-arch hybrid``;
12. ``-arch multi``, S=4 EPS shards as lane groups on the card
   (``ShardedSolver(devices=[cuda:0] * 4)``): (a) golomb(12) at full
   width (auto D=512 a shard, table on) for 20 s, every improving
   solution checker-valid, with the table's live rows by shard, the
   rebalance rounds and their time, the state's bytes and one rebalance
   round timed on it with shard 0 made dry; one solver of
   D=512 and one of D=2048 for 20 s each, for their nodes/s; (b) golomb(8)
   proven optimal at 34 under S=4 and through the CLI's ``-arch multi``
   (one shard a card); (c) ``-a`` on queens(8) under S=4: 92 distinct
   checker-valid solutions through the shards' rings; (d) golomb(8), S=4
   x D=8 over 2^8 subproblems (shards drain apart, so ranges are
   rebalanced), cap pinned at 16: the kernel and plain engines on the
   card give the same status, objective, nodes, failures, solutions,
   iterations and redistributions;
13. ``-hosts 2``, two processes sharing the card (one shard and one CUDA
   context each, joined over gloo; any child that fails or hangs fails
   the phase): (a) golomb(8) through the CLI proven optimal at 34, its
   subproblems all solved or skipped, host 1 silent; (b) golomb(12) at
   full width (auto D a process, k as host 0 chooses it) for 20 s
   through the solver API (``--hosts-worker``), every improving solution
   checker-valid, with the summed nodes/s, the exchanges, the median
   ``dcn_allgather`` in the loop and alone, the exchange's share of the
   wall and the steal moves, beside one process of the same D for 20 s;
   (c) golomb(8) on hosts of 1 and 2 lane groups of 16 over 2^7
   subproblems (one steal): the kernel and plain engines give equal
   statistics; (d) golomb(9) cut by ``-cutnodes``, resumed from the
   per-host checkpoints, closes at 44;
11. the launch counts of each path driven in phases 4c-13, each set to
   0 just before the path and read just after it: the seven kernels of
   the default search (and every entry point of K4, K6 and K7) on the
   main path (6) and on the drain case (8), K1-K3, K6 and K7 on the
   table-off path (7) and on ``-a``, K4 too on ``-i``; K8 in place of K1
   on 10b, K1's fixed-sweeps and transposed entries on 10c, K1 and K2 on
   the hybrid paths, K1-K3, K6 and K7 in each process of 13b (summed
   over both processes into the path ``hosts2``).

It prints a JSON line of the kernels (with each one's bound: the larger
of the bytes it must move over 3.35 TB/s and its int32 operations over
67 T/s, at the timed shapes and this run's data; ``launches`` is the
count on the main path, or on the kernel's own path (``path``) where the
default search does not run it; K7 per shard, ``step_tail.sharded``,
reads K7's launches on the ``-arch multi`` golomb(12) path and its times
from 3d; ``transports`` holds ``dcn_allgather``, a host transport and
not a kernel, with its times from 13b), the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import io
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "chiprun_out" / "chip_smoke"
# The path whose launch counts the JSON line's ``launches`` reports.
MAIN = "default CLI, golomb(12)"
# The paths of K8 and of K1's other entries, read for their ``launches``.
WAC1 = "-fp wac1, golomb(12)"
FIXED = "fp_mode fixed, golomb(12)"
VD = "fp_layout vd, golomb(12)"
# -arch multi: EPS shards as lane groups on one card, and the path whose
# launch counts K7 per shard reports.
SHARDS = 4
MULTI = f"-arch multi, golomb(12), S={SHARDS}"
# -hosts 2: the main path's launch counts (both processes), and the
# (lanes, k, lane groups by host) of the golomb(8) kernels-vs-plain run,
# whose hosts steal.
HOSTS2 = "hosts2"
HOSTS_PIN = (16, 7, (1, 2))


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T0 = time.monotonic()


def log(msg):
    """Print, and keep a copy in ``chiprun_out/chip_smoke/log.txt``."""
    if msg.startswith("["):  # a phase heading: the time since the start
        msg = f"{msg}  (t+{time.monotonic() - T0:.0f} s)"
    print(msg, flush=True)
    if WORK.is_dir():
        with open(WORK / "log.txt", "a") as f:
            f.write(msg + "\n")


def nvidia_smi():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
            f"nvidia-smi failed: {r.stderr.strip()}"
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


def ptxas_lines(log_text, kernel):
    """The ``-Xptxas -v`` lines of one kernel in a build log: its entry,
    stack and spills, registers and shared memory."""
    out, on = [], False
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            on = kernel in line
        if on and ("Compiling entry" in line or "spill" in line
                   or "registers" in line):
            out.append(line.strip())
    return out


def median_ms(fn, reps=15):
    import torch
    fn()  # warm-up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT_OPS_PER_S = 67e12      # CUDA-core rate (the float32 figure; int32's
                           # is lower, so the bound stays a lower bound)


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    int32 operations over the CUDA-core rate."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def plan_bytes(kp):
    return sum(t.numel() * t.element_size() for t in kp.tensors.values())


def sweep_ops(dp):
    """int32 operations of one AC-1 sweep of one dive (K1): about 15 per
    TNF propagator, 6 per element-table entry, 20 per membership row, 15
    per linear term, 2 per incidence slot and 8 per variable."""
    terms = sum(b.coef.numel() for b in dp.lin)
    slots = sum(idx.numel() for _, _, idx in dp.buckets)
    return (15 * dp.P + 6 * dp.E * int(dp.e_tab.shape[1]) + 20 * dp.M
            + 15 * terms + 2 * slots + 8 * dp.V)


def run_cli(args):
    """Run the port's CLI in-process; returns (stdout, stderr, stats)."""
    from turbo_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    if rc != 0:
        fail(f"cli {args} returned {rc}")
    stats = dict(re.findall(r"^%%%mzn-stat: (\w+)=(.*)$", out.getvalue(), re.M))
    return out.getvalue(), err.getvalue(), stats


def check_solution(model, block):
    """Fail unless the solution block satisfies every constraint."""
    from turbo_tpu_torch.host.utils.checker import Checker
    values = {k: int(v) for k, v in
              re.findall(r"^(\w+) = (-?\d+);$", block, re.M)}
    arrays = {a.name: a for a in model.arrays}
    for name, vals in re.findall(r"^(\w+) = array\d+d\([^\[]*\[([^\]]*)\]\);$",
                                 block, re.M):
        for e, v in zip(arrays[name].elems, vals.split(",")):
            if isinstance(e, str):
                values[e] = int(v)
    ck = Checker(model, values)
    bad = [c.name for c in model.constraints if not ck.holds(c)]
    if bad:
        fail(f"printed solution violates {bad[:5]}")


def status_of(out, is_opt):
    if "=====UNSATISFIABLE=====" in out:
        return "unsat"
    if "==========" in out:
        return "optimal" if is_opt else "sat"
    return "sat" if "----------" in out else "unknown"


def write_model(name, text):
    p = WORK / f"{name}.fzn"
    p.write_text(text)
    return str(p)


def random_stores(plan, tnf, D, rng, solution):
    """(D, V) int32 stores: root box narrowed at random; every 4th lane
    fixed at a solution (entailed), every 8th narrowed to bot."""
    import numpy as np
    lb = np.tile(plan.lb0, (D, 1)).astype(np.int32)
    ub = np.tile(plan.ub0, (D, 1)).astype(np.int32)
    n = plan.n_active
    for d in range(D):
        if solution is not None and d % 4 == 0:
            keep = ~plan.dropped
            lb[d, plan.perm[keep]] = solution[keep]
            ub[d, plan.perm[keep]] = solution[keep]
            continue
        for v in rng.choice(n, size=min(n, int(rng.integers(1, 6))),
                            replace=False):
            if lb[d, v] < ub[d, v]:
                lo = int(rng.integers(lb[d, v], ub[d, v] + 1))
                hi = int(rng.integers(lo, ub[d, v] + 1))
                lb[d, v], ub[d, v] = lo, hi
        if d % 8 == 1:
            v = int(rng.integers(n))
            lb[d, v] = ub[d, v] + 1
    return lb, ub


def phase_kernels(torch, dev):
    """Each kernel vs its plain version on the same CUDA tensors."""
    import numpy as np
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.kernels import build as kbuild
    log("  K1 (-Xptxas -v): " + " | ".join(
        ptxas_lines(kbuild.build_log, "fixpoint_kernel")))
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.host.solver import oracle
    from turbo_tpu_torch.instances import golomb, random_model
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.engine import BatchedSolver

    errs = dict.fromkeys(("fixpoint", "classify", "select", "wac1",
                          "fixpoint.fixed_sweeps", "fixpoint.transposed"), 0)
    times = {}
    sweeps = {}
    # Exactness on 4 random models at D=1024; exactness and times at
    # golomb(8)'s auto D=1024; exactness and the reported times at the
    # main path's full-width shape, golomb(12) at D=512 (the last).
    # (label, model, D, seed of the stores): golomb(12) keeps seed 4, the
    # stores of the earlier times in PERF.md.
    models = [(f"random_model({100 + i})", random_model(100 + i, n_vars=10,
                                                        n_cons=40), 1024, i)
              for i in range(4)] + [("golomb(8)", golomb(8), 1024, 5),
                                    ("golomb(12)", golomb(12), 512, 4)]
    for label, text, D, seed in models:
        tnf = compile_model(parse_fzn_text(text))
        sol = (oracle.solve(tnf, timeout_s=30).best_lb
               if label.startswith("random") else None)
        s = BatchedSolver(tnf, EngineConfig(num_dives=D, subproblems_power=4,
                                            max_depth=128), device=dev)
        rng = np.random.default_rng(seed)
        lb_np, ub_np = random_stores(s.plan, tnf, D, rng, sol)
        lb = torch.as_tensor(lb_np, device=dev)
        ub = torch.as_tensor(ub_np, device=dev)
        strat = torch.as_tensor(rng.integers(0, len(s.dp.strat_ids) + 1, D),
                                dtype=torch.int32, device=dev)
        pk = s.kernels
        kp = pk.kernel_plan
        cases = [
            ("fixpoint", lambda: kernels.fixpoint(kp, lb, ub, 10000),
             lambda: pk.fixpoint_plain(lb, ub, 10000)),
            ("fixpoint", lambda: kernels.fixpoint(kp, lb, ub, 2),
             lambda: pk.fixpoint_plain(lb, ub, 2)),
            ("fixpoint", lambda: kernels.fixpoint(kp, lb, ub, 10000,
                                                  smem=False),
             lambda: pk.fixpoint_plain(lb, ub, 10000)),
            ("fixpoint", lambda: kernels.fixpoint(kp, lb, ub, 2, smem=False),
             lambda: pk.fixpoint_plain(lb, ub, 2)),
            ("classify", lambda: kernels.classify(kp, lb, ub),
             lambda: pk.classify_plain(lb, ub)),
        ]
        fl, fu = pk.fixpoint_plain(lb, ub, 10000)[:2]
        for st_lb, st_ub in ((lb, ub), (fl, fu)):
            cases.append(("select",
                          lambda a=st_lb, b=st_ub: kernels.select(kp, a, b, strat),
                          lambda a=st_lb, b=st_ub: s._select_plain(a, b, strat)))
        # K8 and K1's other entries: caps 2 and 10000, inner caps 1 and
        # 16, 2 and 5 fixed sweeps, shared- and global-memory paths. The
        # first case of each name is the timed one.
        lbT, ubT = lb.t().contiguous(), ub.t().contiguous()

        def untransposed(res):
            return (res[0].t(), res[1].t()) + tuple(res[2:])

        def nonbot(res):
            # WAC1: iters, unconv and bot on every lane, the store on the
            # lanes that are not bot.
            b = pk.is_bot(res[0], res[1])
            keep = (~b)[:, None].to(res[0].dtype)
            return (res[0] * keep, res[1] * keep, res[2], res[3], b)

        # A 4th element keys the plain result (it does not depend on the
        # memory path, so it is computed once for both); a 5th is applied
        # to both results before they are compared, outside the timing.
        memo = {}
        for smem in (True, False):
            for cap in (10000, 2):
                cases.append((
                    "fixpoint.transposed",
                    lambda c=cap, m=smem: kernels.fixpoint.transposed(
                        kp, lbT, ubT, c, smem=m),
                    lambda c=cap: pk.fixpoint_t_plain(lbT, ubT, c),
                    ("t", cap), untransposed))
                for inner in (16, 1):
                    cases.append((
                        "wac1",
                        lambda c=cap, i=inner, m=smem: kernels.wac1(
                            kp, lb, ub, c, i, smem=m),
                        lambda c=cap, i=inner: pk.fixpoint_wac1_plain(
                            lb, ub, c, i),
                        ("w", cap, inner), nonbot))
            for n in (2, 5):
                cases.append((
                    "fixpoint.fixed_sweeps",
                    lambda n=n, m=smem: kernels.fixpoint.fixed_sweeps(
                        kp, lb, ub, n, smem=m),
                    lambda n=n: pk.fixed_sweeps_plain(lb, ub, n), ("f", n)))
        timed = set()
        for name, kern, plain, *rest in cases:
            key = rest[0] if rest else None
            post = rest[1] if len(rest) > 1 else tuple
            if key is None:
                want = post(plain())
            else:
                if key not in memo:
                    memo[key] = post(plain())
                want = memo[key]
            got = post(kern())
            torch.cuda.synchronize()
            for i, (g, w) in enumerate(zip(got, want)):
                if g.dtype != w.dtype or g.shape != w.shape:
                    fail(f"{name} seed {seed}: {g.dtype}{tuple(g.shape)} vs "
                         f"{w.dtype}{tuple(w.shape)}")
                diff = (g.long() - w.long()).abs()
                err = int(diff.max()) if g.numel() else 0
                errs[name] = max(errs[name], err)
                if err != 0:
                    lanes = diff.reshape(D, -1).amax(dim=1).nonzero()[:, 0]
                    d = int(lanes[0])
                    cols = diff.reshape(D, -1)[d].nonzero()[:, 0][:8].tolist()
                    fail(f"{name} seed {seed}: output {i} differs from plain "
                         f"(max abs err {err}) on {len(lanes)} lanes; lane {d}"
                         f" cols {cols}: kernel "
                         f"{g.reshape(D, -1)[d, cols].tolist()} plain "
                         f"{w.reshape(D, -1)[d, cols].tolist()}")
            if name not in timed:  # time the first case of each kernel
                timed.add(name)
                times[label, name] = (median_ms(kern), median_ms(plain, reps=3))
                # Sweeps this run's stores needed: iters is sweeps + 1,
                # under fixed sweeps the sweeps themselves.
                if name not in ("classify", "select"):
                    fixed = name == "fixpoint.fixed_sweeps"
                    sweeps[label, name] = int(got[2].long().sum()) - (
                        0 if fixed else D)
        n_bot = int(pk.is_bot(fl, fu).sum())
        n_ent = int(pk.all_entailed(fl, fu).sum())
        log(f"  {label}: D={D} V={s.dp.V} P={s.dp.P} lin_fit32="
            f"{[b.fit32 for b in s.dp.lin]} bot lanes={n_bot} "
            f"entailed lanes={n_ent}: fixpoint (3 entries)/classify/select/"
            f"wac1 exact; sweeps over all lanes: AC-1 "
            f"{sweeps[label, 'fixpoint']}, WAC1 outer {sweeps[label, 'wac1']}"
            f"; ms " + ", ".join(f"{k} {times[label, k][0]:.4f} (plain "
                                 f"{times[label, k][1]:.4f})" for k in errs))
    # Bounds at golomb(12), D=512: the planes read and written once, the
    # plan's tables once; K1's operations for the sweeps this run's
    # stores needed.
    dp, D = s.dp, 512
    planes = 2 * D * dp.V * 4
    tabs = plan_bytes(kp)
    fp_bytes = 2 * planes + tabs + 5 * D
    g12 = "golomb(12)"
    bounds = {
        "fixpoint": bound(fp_bytes, sweeps[g12, "fixpoint"] * sweep_ops(dp)),
        "fixpoint.transposed": bound(
            fp_bytes, sweeps[g12, "fixpoint.transposed"] * sweep_ops(dp)),
        "fixpoint.fixed_sweeps": bound(
            fp_bytes, sweeps[g12, "fixpoint.fixed_sweeps"] * sweep_ops(dp)),
        # One pass over every propagator per outer sweep: the inner
        # iterations beyond a group's first are not counted (the kernel
        # does not return them), so this stays a lower bound.
        "wac1": bound(fp_bytes, sweeps[g12, "wac1"] * sweep_ops(dp)),
        "classify": bound(planes + tabs + 2 * D,
                          D * (10 * dp.P + 4 * sum(b.coef.numel()
                                                   for b in dp.lin) + dp.V)),
        "select": bound(planes + 9 * 4 * D,
                        6 * D * sum(int(t.numel()) for t in dp.strat_ids)),
    }
    kres = {k: (errs[k],) + times["golomb(12)", k] + bounds[k] for k in errs}
    kres.update(phase_table_kernels(torch, dev, s, tnf))
    return kres


def exact(name, got, want):
    """Max abs error of got vs want (each a tensor or a tuple of them);
    fails unless 0."""
    import torch
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{name}: output {i} {g.dtype}{tuple(g.shape)} vs "
                 f"{w.dtype}{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    torch.cuda.synchronize()
    if err != 0:
        fail(f"{name}: differs from its plain version (max abs err {err})")
    return err


def phase_table_kernels(torch, dev, s, tnf):
    """K4 (both entry points) and K5 against their plain versions at
    golomb(12)'s shapes: W = D = 512 rows of V = 2560, 2048 table rows,
    (512, 10000) stacks."""
    import numpy as np
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.solver.engine import (open_branch_count_plain,
                                               table_refill_plain)
    from turbo_tpu_torch.host.solver.plan import quantize
    from turbo_tpu_torch.solver.eps_table import embed_plain
    rng = np.random.default_rng(42)
    plan, D, MAXD = s.plan, 512, 10000
    n_pad = quantize(1 << 11)  # golomb(12) at D=512 splits 2^11 ways
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                  device=dev)
    lb, ub = random_stores(plan, tnf, D, rng, None)
    var = rng.integers(0, plan.n_active, D)
    lo, hi = lb[np.arange(D), var], ub[np.arange(D), var]
    mid = lo + (hi - lo) // 2
    args = (t(lb), t(ub), t(rng.integers(0, len(s.dp.strat_ids) + 1, D)),
            t(var), t(lo), t(mid), t(mid + 1), t(hi),
            t(rng.integers(0, D, D)), t(rng.integers(0, 2, D)))
    out = {}
    err = exact("embed", kernels.embed(*args), embed_plain(*args))
    ms = (median_ms(lambda: kernels.embed(*args)),
          median_ms(lambda: embed_plain(*args)))
    # Two parent planes read and two child planes written, per row.
    out["embed"] = (err,) + ms + bound(4 * D * plan.V * 4 + 11 * 4 * D,
                                       2 * D * plan.V)
    tlb, tub = random_stores(plan, tnf, n_pad, rng, None)
    tab = (t(tlb), t(tub))
    idx = t(rng.integers(-3, n_pad + 3, D))
    refill = torch.as_tensor(rng.random(D) < 0.5, device=dev)
    planes = [t(a) for a in random_stores(plan, tnf, D, rng, None) * 2]
    mine = [p.clone() for p in planes]
    kernels.embed.refill(*tab, idx, refill, *mine)
    table_refill_plain(*tab, idx, refill, *planes)
    exact("embed.refill", mine, planes)
    refill_ms = (median_ms(lambda: kernels.embed.refill(*tab, idx, refill,
                                                        *mine)),
                 median_ms(lambda: table_refill_plain(*tab, idx, refill,
                                                      *planes)))
    dec_cur = t(rng.integers(0, 2, (D, MAXD)))
    depth = t(rng.integers(0, MAXD + 1, D))
    phase = t(rng.integers(0, 3, D))
    err = exact("open_count", kernels.open_count(dec_cur, depth, phase),
                open_branch_count_plain(dec_cur, depth, phase))
    # The live prefixes of the SOLVE lanes' stacks, read once.
    live = int(depth.clamp(max=MAXD)[phase == 1].long().sum())
    out["open_count"] = (err,) + (
        median_ms(lambda: kernels.open_count(dec_cur, depth, phase)),
        median_ms(lambda: open_branch_count_plain(dec_cur, depth, phase))
    ) + bound(4 * live + 8 * D, live)
    # A refilled lane reads two table rows and writes four planes.
    n_refill = int(refill.sum())
    refill_bound = bound(n_refill * 6 * plan.V * 4 + 5 * D, 0)
    log(f"  golomb(12) shapes: W=D={D} V={plan.V} n_pad={n_pad} MAXD={MAXD}:"
        f" embed/refill/open_count exact; ms embed {out['embed'][1]:.4f} "
        f"(plain {out['embed'][2]:.4f}, bound {out['embed'][3]:.5f}), "
        f"table_refill {refill_ms[0]:.4f} (plain {refill_ms[1]:.4f}, bound "
        f"{refill_bound[0]:.5f} for {n_refill} lanes), open_count "
        f"{out['open_count'][1]:.4f} (plain {out['open_count'][2]:.4f}, "
        f"bound {out['open_count'][3]:.5f})")
    return out


def clone_state(st):
    import dataclasses
    return dataclasses.replace(st, **{f.name: getattr(st, f.name).clone()
                                      for f in dataclasses.fields(st)})


def same_state(label, a, b):
    """Fails unless every SearchState field of a equals b's; returns the
    max abs error (0)."""
    import dataclasses
    import torch
    torch.cuda.synchronize()
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype != y.dtype or x.shape != y.shape:
            fail(f"{label}: {f.name} {x.dtype}{tuple(x.shape)} vs "
                 f"{y.dtype}{tuple(y.shape)}")
        if not torch.equal(x, y):
            diff = (x.double() - y.double()).abs()
            rows = diff.reshape(diff.shape[0], -1).amax(dim=1).nonzero()[:, 0]
            fail(f"{label}: {f.name} differs from the plain step (max abs "
                 f"err {float(diff.max())}) on {len(rows)} rows, first "
                 f"{rows[:8].tolist()}")
    return 0


def steps_equal(label, s, st_k, cap):
    """Fails unless the kernels' steps of ``st_k`` (solver ``s``) equal
    the plain step's on a copy, every field after 1, 7 and 40 steps and
    after three chunks of 8 (eager, captured into a CUDA graph, replayed),
    with the kernels' step counter equal to the plain steps that found a
    live lane. Returns the kernels' state."""
    st_p = clone_state(st_k)
    done = 0
    for n in (1, 7, 40):
        st_k, ran = s.run_steps(st_k, n - done, cap)
        live = 0
        for _ in range(n - done):
            st_p, lv = s.step_plain(st_p, cap)
            live += int(lv)
        if int(ran) != live:
            fail(f"{label}: the kernels counted {int(ran)} steps, the "
                 f"plain step {live}")
        done = n
        same_state(f"{label}, after {n} steps", st_k, st_p)
    for _ in range(3):
        st_k, _ = s.run_steps(st_k, 8, cap)
        for _ in range(8):
            st_p, _ = s.step_plain(st_p, cap)
    same_state(f"{label}, after 64 steps (CUDA graph)", st_k, st_p)
    if not s._ws.graphs:
        fail(f"{label}: no chunk was captured into a CUDA graph")
    log(f"  {label}: K6+K7 equal the plain step after 1, 7, 40 steps "
        f"and 3 chunks of 8 through a CUDA graph "
        f"(nodes {int(st_k.nodes.sum())}, solutions "
        f"{int(st_k.sols.sum())}, idle lanes "
        f"{int((st_k.phase == 2).sum())}/{st_k.phase.shape[0]})")
    return st_k


def phase_step_kernels(torch, dev):
    """3b: K6 + K7 against the plain step on the same CUDA state, and
    their times inside real golomb(12) steps. Returns the kres entries of
    step and step_tail."""
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.instances import golomb, queens, random_model
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.engine import BatchedSolver
    # The first four are timed below: the step with K1, with K8, with
    # K1's fixed-sweeps entry (no table under "fixed") and with K1's
    # transposed entry.
    cases = ([("golomb(12), D=512, table on, cap 16", golomb(12),
               dict(num_dives=512), 16),
              ("golomb(12), D=512, table on, cap 16, fp_mode wac1",
               golomb(12), dict(num_dives=512, fp_mode="wac1"), 16),
              ("golomb(12), D=512, fp_mode fixed (2 sweeps)", golomb(12),
               dict(num_dives=512, fp_mode="fixed"), 16),
              ("golomb(12), D=512, table on, cap 16, fp_layout vd",
               golomb(12), dict(num_dives=512, fp_layout="vd"), 16)]
             + [(f"random_model({200 + i}), table off, cap 4, fp_mode {mode}",
                 random_model(200 + i, n_vars=8, n_cons=24),
                 dict(num_dives=64, subproblems_power=8, use_table=False,
                      fp_mode=mode), 4)
                for i in range(2) for mode in ("wac1", "fixed")]
             + [(f"random_model({200 + i}), table off, cap 4",
                 random_model(200 + i, n_vars=8, n_cons=24),
                 dict(num_dives=64, subproblems_power=8, use_table=False), 4)
                for i in range(6)]
             + [("queens(8), enumerate_all, ring 256", queens(8),
                 dict(num_dives=64, subproblems_power=6, enumerate_all=True,
                      sol_ring_size=256), 10000)])
    big = []
    for label, text, kw, cap in cases:
        s = BatchedSolver(compile_model(parse_fzn_text(text)),
                          EngineConfig(fp_cap_auto=False, **kw), device=dev)
        st_k = steps_equal(label, s, s.init_state(), cap)
        if len(big) < 4:
            big.append((label, s, st_k, cap))
    out = None
    for label, s, st, cap in big:
        st0 = clone_state(st)
        res = time_step_parts(torch, label, s, st, cap)
        if out is None:  # the JSON line's K6 and K7: the step with K1
            out = res
            k1_turns(torch, label, s, st0, cap)
    return out


def phase_sharded_step_kernels(torch, dev, single):
    """3d: the step over S EPS shards, lane groups of one state (K6 over
    every lane, K7 per shard), against the plain sharded step on the same
    CUDA state; then each kernel's time inside real golomb(12) steps at
    S x D=512, K7's against S=1 (``single``: 3b's entry). Returns the
    JSON entry of K7 per shard."""
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.instances import golomb, queens, random_model
    from turbo_tpu_torch.parallel.mesh import ShardedSolver
    from turbo_tpu_torch.solver.config import EngineConfig
    cases = ([(f"golomb(12), S={SHARDS} x D=512, table on, cap 16",
               golomb(12), dict(num_dives=512), 16)]
             + [(f"random_model({200 + i}), S={SHARDS} x D=64, table off, "
                 "cap 4", random_model(200 + i, n_vars=8, n_cons=24),
                 dict(num_dives=64, subproblems_power=8, use_table=False), 4)
                for i in range(6)]
             + [(f"queens(8), S={SHARDS} x D=64, enumerate_all, ring 256",
                 queens(8), dict(num_dives=64, subproblems_power=6,
                                 enumerate_all=True, sol_ring_size=256),
                 10000)])
    first = None
    for label, text, kw, cap in cases:
        ms = ShardedSolver(compile_model(parse_fzn_text(text)),
                           EngineConfig(fp_cap_auto=False, **kw),
                           devices=[dev] * SHARDS)
        st = steps_equal(label, ms.solver, ms.init_state(), cap)
        if first is None:
            first = (label, ms.solver, st, cap)
    res = time_step_parts(torch, *first)["step_tail"]
    log(f"  K7 (scan + copy) per step, golomb(12), D=512 a shard: S={SHARDS} "
        f"{res[1]:.4f} ms (plain {res[2]:.4f}, bound {res[3]:.5f}), S=1 "
        f"{single[1]:.4f} ms (plain {single[2]:.4f}, bound {single[3]:.5f})")
    return res


def k1_turns(torch, label, s, st, cap):
    """K1's time in the step from the same state ``st``, built without
    the skip and as built in turns (on, off, off, on)."""
    from turbo_tpu_torch import kernels
    kp = s.kernels.kernel_plan
    for no_skip in (False, True, True, False):
        name = "without the skip" if no_skip else "as built"
        with k1_build(no_skip):
            time_step_parts(torch, f"{label}, K1 {name}", s,
                            clone_state(st), cap)
            # K1 alone on the state's stores, by cap: the first sweep
            # against the later ones.
            ms = {c: median_ms(lambda c=c: kernels.fixpoint(
                kp, st.lb, st.ub, c)) for c in (1, 2, 4, 16)}
            log(f"    K1 alone ({name}), ms by cap: " + ", ".join(
                f"{c}: {t:.4f}" for c, t in ms.items()))


@contextlib.contextmanager
def k1_build(no_skip):
    """The wrappers launch from the build without K1's skip (its
    ``-Xptxas -v`` line logged) when ``no_skip``, else as built."""
    from turbo_tpu_torch.kernels import build as kbuild
    if not no_skip:
        yield
        return
    with kbuild.k1_without_skip():
        log("  -DTT_K1_NO_SKIP: K1 (-Xptxas -v): " + " | ".join(
            ptxas_lines(kbuild.build_log, "fixpoint_kernel")))
        yield


def time_step_parts(torch, label, s, st, cap, steps=20):
    """Each kernel entry's time inside ``steps`` real steps of ``st``:
    CUDA events between the launches, all steps enqueued before one
    synchronize (so the card does not wait on the host between them);
    and the plain step's three parts on a copy of the same state. The
    propagation launch is the configuration's (K1, one of its entries
    with the ``vd`` copies, or K8)."""
    import dataclasses
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.solver import step_cuda
    dev = st.lb.device
    ws, kp = s._ws, s.kernels.kernel_plan
    sv = step_cuda.view(s, st, ws)
    plain_st = clone_state(st)
    names = ("step.pre", "propagation", "classify", "select", "step.post",
             "step_tail.scan", "step_tail.copy")
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(8)]
          for _ in range(steps)]
    n_impr = torch.zeros((), dtype=torch.int64, device=dev)
    n_refill = torch.zeros((), dtype=torch.int64, device=dev)
    nodes0, fpit0 = int(st.nodes.long().sum()), int(st.fpit.long().sum())
    kernels.step_tail.live(st.phase, ws.live[0], ws.steps)
    for i in range(steps):
        cur, nxt = ws.live[i % 2], ws.live[1 - i % 2]
        ev[i][0].record()
        kernels.step.pre(sv, cur, dev)
        ev[i][1].record()
        step_cuda.propagate(s, st, cap, cur)
        ev[i][2].record()
        kernels.classify(kp, st.lb, st.ub, live=cur, out=(ws.bot, ws.ent))
        ev[i][3].record()
        kernels.select(kp, st.lb, st.ub, ws.strat0, live=cur, out=ws.sel)
        ev[i][4].record()
        kernels.step.post(sv, cur, dev, kp.smem_limit)
        ev[i][5].record()
        kernels.step_tail.scan(sv, cur, nxt, dev)
        ev[i][6].record()
        kernels.step_tail.copy(sv, cur, dev)
        ev[i][7].record()
        n_impr += ws.impr.sum()
        n_refill += ws.havework.sum()
    torch.cuda.synchronize()
    acc = {n: sum(ev[i][j].elapsed_time(ev[i][j + 1])
                  for i in range(steps)) / steps
           for j, n in enumerate(names)}
    plain = dict.fromkeys(("pre", "post", "tail"), 0.0)
    for _ in range(steps):
        pe = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        p = plain_st
        pe[0].record()
        phase, strat0, ub = s.step_pre_plain(p)
        pe[1].record()
        lb, ub, iters, unconv = s.propagate(p.lb, ub, cap)
        bot, ent = s.kernels.classify(lb, ub)
        sel = s._select(lb, ub, strat0)
        pe[2].record()
        new, flags = s.step_post_plain(p, phase, strat0, lb, ub, iters,
                                       unconv, bot, ent, sel)
        pe[3].record()
        new = s.step_tail_plain(p, new, *flags)
        pe[4].record()
        torch.cuda.synchronize()
        plain_st = dataclasses.replace(p, **new)
        plain["pre"] += pe[0].elapsed_time(pe[1]) / steps
        plain["post"] += pe[2].elapsed_time(pe[3]) / steps
        plain["tail"] += pe[3].elapsed_time(pe[4]) / steps
    D, V = st.phase.shape[0], s.dp.V  # every lane of every shard
    impr, refill = int(n_impr) / steps, int(n_refill) / steps
    # K6: about 10 scalar words per lane before K1 and 52 after, the
    # incumbent rows of improving lanes (two planes read, two written);
    # snapshot and rebuild rows are not counted (a lower bound). K7: 28
    # bytes per lane in the scan, six table-row planes per refilled lane
    # (two read, four written) and a ring row per improvement.
    k6 = bound(D * 62 * 4 + impr * 16 * V + 4 * D, 100 * D)
    k7 = bound(28 * D + refill * 24 * V + impr * 8 * V, 30 * D)
    nodes = int(st.nodes.long().sum()) - nodes0
    fpit = int(st.fpit.long().sum()) - fpit0
    log(f"  {label}: D={D} V={V}, {steps} steps (per step: "
        f"{impr:.2f} improving, {refill:.2f} refilled lanes, "
        f"{nodes / steps:.1f} nodes; {fpit / max(nodes, 1):.2f} "
        f"fixpoint_iterations per node), ms per step: "
        + ", ".join(f"{n} {acc[n]:.4f}" for n in names)
        + f"; plain parts: pre {plain['pre']:.4f}, post {plain['post']:.4f},"
        f" tail {plain['tail']:.4f}; bound ms K6 {k6[0]:.5f} ({k6[1]}), K7 "
        f"{k7[0]:.5f} ({k7[1]})")
    return {"step": (0, acc["step.pre"] + acc["step.post"],
                     plain["pre"] + plain["post"]) + k6,
            "step_tail": (0, acc["step_tail.scan"] + acc["step_tail.copy"],
                          plain["tail"]) + k7}


def profile_steps(torch, fn, steps):
    """(device kernels, device busy ms) per step of ``fn`` under
    torch.profiler, or None when the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        return None
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    return len(dev_events) / steps, busy_us / 1e3 / steps


def phase_step_loop(torch, dev, label, kw, full=True, chunk=16, cap=16,
                    no_skip=False):
    """3c: the step loop on golomb(12), D=512, under the configuration
    ``kw``: no host sync inside a chunk (sync debug mode "error"),
    launches, wall and device time per step, for the kernels launched one
    by one and the same chunk replayed as a CUDA graph (the route
    ``run_steps`` takes once a chunk repeats); ``full``: the profile of
    both routes and the plain step too; ``no_skip``: K1 from the build
    without its skip. Returns the graph route's wall ms per step."""
    with k1_build(no_skip):
        return _step_loop(torch, dev, label, kw, full, chunk, cap)


def _step_loop(torch, dev, label, kw, full, chunk, cap):
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.instances import golomb
    from turbo_tpu_torch.solver import step_cuda
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.engine import BatchedSolver
    s = BatchedSolver(compile_model(parse_fzn_text(golomb(12))),
                      EngineConfig(num_dives=512, fp_cap_auto=False, **kw),
                      device=dev)
    st = s.init_state()
    log(f"  {label}:")
    for _ in range(2):  # warm: the second chunk is captured
        step_cuda.run(s, st, chunk, cap)
    torch.cuda.synchronize()
    out = {}
    for route, graph in (("kernels one by one", False), ("CUDA graph", True),
                         ("kernels one by one", False), ("CUDA graph", True)):
        kernels.reset_launches()
        t0 = time.monotonic()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ran = step_cuda.run(s, st, chunk, cap, graph=graph)
        except RuntimeError as e:
            fail(f"a host sync inside a chunk ({route}): {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        enq = time.monotonic() - t0
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        n = int(ran)
        per = sum(kernels.launch_counts()[k.name] for k in kernels.KERNELS)
        log(f"    {route}: {n} steps, {per / chunk:.2f} launches of the "
            f"port's kernels per step, wall {wall / n * 1e3:.3f} ms per step "
            f"(enqueue {enq / n * 1e3:.3f}); no host sync")
        out.setdefault(route, []).append(wall / n * 1e3)
    routes = (("kernels one by one", False), ("CUDA graph", True))
    for route, graph in routes if full else routes[1:]:
        prof = profile_steps(
            torch, lambda: step_cuda.run(s, st, chunk, cap, graph=graph),
            chunk)
        log(f"    {route} under torch.profiler: " + (
            f"{prof[0]:.1f} device kernels and {prof[1]:.3f} ms device busy"
            " per step" if prof else "no device time (not measured)"))
    if not full:
        return out["CUDA graph"]
    plain = clone_state(st)

    def plain_chunk():
        nonlocal plain
        for _ in range(chunk):
            plain, _ = s.step_plain(plain, cap)

    plain_chunk()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    plain_chunk()
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / chunk * 1e3
    pprof = profile_steps(torch, plain_chunk, chunk)
    log(f"    plain step on the card: wall {wall:.3f} ms per step; " + (
        f"{pprof[0]:.1f} device kernels and {pprof[1]:.3f} ms device busy "
        "per step" if pprof else "profiler: no device time"))
    # The chunk's live flag (K7 live, once per chunk): it reads the
    # phases and writes two words.
    ws, D = s._ws, s.cfg.num_dives
    live_ms = median_ms(lambda: kernels.step_tail.live(st.phase, ws.live[0],
                                                       ws.steps))
    live_bound = bound(4 * D + 8, D)
    log(f"    K7 live (once per chunk): {live_ms:.4f} ms, bound "
        f"{live_bound[0]:.7f} ms ({live_bound[1]})")
    return out["CUDA graph"]


def plain_engine(s):
    """Solver ``s`` with the plain versions in place of the kernels: the
    step is ``step_plain`` and the fixpoint, classify and select (also in
    the table build) are the plain torch functions. Returns ``s``."""
    import torch
    pk = s.kernels
    pk.fixpoint, pk.classify = pk.fixpoint_plain, pk.classify_plain
    s._select = s._select_plain

    def run_steps(st, n, cap=0):
        count = torch.zeros((), dtype=torch.int32, device=st.lb.device)
        for _ in range(n):
            st, live = s.step_plain(st, cap)
            count += live.to(torch.int32)
        return st, count
    s.run_steps = run_steps
    return s


def counted(label, fn, required=()):
    """Drive one path: every launch count is set to 0 just before ``fn``
    and read just after; fails unless each kernel (or ``embed.<entry>``)
    in ``required`` was launched. Returns the counts."""
    from turbo_tpu_torch import kernels
    kernels.reset_launches()
    fn()
    counts = kernels.launch_counts()
    log(f"  launches on {label}: " + ", ".join(f"{k} {n}"
                                               for k, n in counts.items()))
    missing = [k for k in required if counts[k] <= 0]
    if missing:
        fail(f"{label}: {missing} not launched on this path")
    return counts


STEP_KERNELS = ("fixpoint", "classify", "select", "step", "step_tail",
                "step.pre", "step.post", "step_tail.scan", "step_tail.copy",
                "step_tail.live")
TABLE_KERNELS = ("embed", "embed.embed", "embed.table_refill")


def api_run(dev, big, tnf, model, seconds, **kw):
    """A path: golomb(big) at D=512 through the solver API under ``kw``
    for ``seconds``; its best solution checked."""
    from turbo_tpu_torch.host.utils.output import print_solution
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.engine import BatchedSolver

    def run():
        s = BatchedSolver(tnf, EngineConfig(num_dives=512, **kw), device=dev)
        r = s.solve(timeout_s=seconds)
        if r.best_lb is None:
            fail(f"golomb({big}) under {kw}: no solution")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            print_solution(tnf, r.best_lb)
        check_solution(model, buf.getvalue())
        log(f"  objective {r.objective}, checker-valid; nodes {r.nodes}, "
            f"nodes/s {r.nodes / r.solve_time:.0f}, solveTime "
            f"{r.solve_time:.3f} s, k {s.k}, fixpoint_iterations "
            f"{r.fixpoint_iterations}, table "
            f"{'on' if s.use_table else 'off'}")
    return run


def run_path(torch, dev, big=12):
    """Phases 4-8: the port's paths on ``dev``; ``big`` is the golomb
    ruler of phases 6-8 (12: full width). Returns the launch counts of
    each driven path, by label."""
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.host.solver import oracle
    from turbo_tpu_torch.host.solver.plan import auto_num_dives
    from turbo_tpu_torch.instances import (GOLOMB_OPT, QUEENS_COUNT, golomb,
                                           queens, random_model)
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.engine import BatchedSolver
    step_kernels, table_kernels = STEP_KERNELS, TABLE_KERNELS
    all_kernels = step_kernels + table_kernels + ("open_count",)
    paths = {}

    def no_tail(solver):
        solver._steal_open_branches = lambda *a, **k: None
        solver._tail_resplit = lambda *a, **k: None
        return solver

    models = [random_model(200 + seed, n_vars=8, n_cons=24)
              for seed in range(6)]
    pinned = (("4a", "table mode, pinned cap 4", True, 4),
              ("4b", "table off, cap 10000", False, 0))
    for ph, label, use_table, fp_cap in pinned:
        log(f"[{ph}] {label}: card vs the port's CPU engine")
        for seed, text in enumerate(models):
            tnf = compile_model(parse_fzn_text(text))
            cfg = EngineConfig(num_dives=64, subproblems_power=8,
                               use_table=use_table, fp_cap_auto=False)
            solvers = {d: no_tail(BatchedSolver(tnf, cfg, device=d))
                       for d in (dev, "cpu")}
            res = {d: s.solve(fp_cap=fp_cap) for d, s in solvers.items()}
            gpu, cpu = ((r.status, r.objective, r.nodes, r.fails,
                         r.solutions, r.fixpoint_iterations)
                        for r in res.values())
            log(f"  model {seed}: status/obj/nodes/fails/sols/fp_iters card "
                f"{gpu} cpu {cpu}; table_build_time card "
                f"{res[dev].table_build_time:.3f} s")
            if gpu != cpu:
                fail(f"[{ph}] model {seed}: card statistics {gpu} != CPU "
                     f"engine {cpu}")
            built = res[dev].table_build_time > 0
            if use_table and not solvers[dev].plan.root_unsat and not built:
                fail(f"[{ph}] model {seed}: no table was built")
            if not use_table and built:
                fail(f"[{ph}] model {seed}: a table was built")

    log("[4c] default CLI vs the oracle")

    def small_models():
        for seed, text in enumerate(models):
            tnf = compile_model(parse_fzn_text(text))
            ro = oracle.solve(tnf, timeout_s=120)
            out, _, stats = run_cli([write_model(f"rand{seed}", text), "-s",
                                     "-or", "64", "-sub", "6", "-t",
                                     "120000"])
            st = status_of(out, tnf.obj_var >= 0)
            obj = int(stats["objective"]) if "objective" in stats else None
            log(f"  model {seed}: port {st} {obj}, oracle {ro.status} "
                f"{ro.objective}; nodes {stats['nodes']}, table_build_time "
                f"{stats.get('table_build_time', 'absent')}")
            if st != ro.status or obj != ro.objective:
                fail(f"model {seed}: port ({st}, {obj}) != oracle "
                     f"({ro.status}, {ro.objective})")
    paths["default CLI, 6 small models"] = counted(
        "the default CLI, 6 small models", small_models)

    def golomb8_proof():
        out, _, stats = run_cli([write_model("golomb8", golomb(8)), "-s"])
        if "==========" not in out or int(stats.get("objective", -1)) != 34:
            fail(f"golomb(8): expected optimal 34, got "
                 f"{stats.get('objective')}")
        log(f"  optimal 34: nodes {stats['nodes']}, solveTime "
            f"{float(stats['solveTime']):.3f} s, nodes/s "
            f"{int(stats['nodes']) / float(stats['solveTime']):.0f}, "
            f"num_blocks {stats['num_blocks']}, table_build_time "
            f"{stats.get('table_build_time')}")

    log("[5] golomb(8) proof, default CLI")
    paths["default CLI, golomb(8)"] = counted("the default CLI, golomb(8)",
                                              golomb8_proof)

    log("[5b] golomb(8), cap pinned at 16: kernel engine vs plain engine")

    def golomb8_pinned():
        tnf8 = compile_model(parse_fzn_text(golomb(8)))
        cfg = EngineConfig(num_dives=auto_num_dives(tnf8), fp_cap_auto=False)
        res = {}
        for name in ("kernels", "plain"):
            s = no_tail(BatchedSolver(tnf8, cfg, device=dev))
            if name == "plain":
                plain_engine(s)
            t0 = time.monotonic()
            r = s.solve(fp_cap=16)
            res[name] = (r.status, r.objective, r.nodes, r.fails,
                         r.solutions, r.fixpoint_iterations)
            log(f"  {name}: status/obj/nodes/fails/sols/fp_iters {res[name]}"
                f", {time.monotonic() - t0:.1f} s")
        if res["kernels"] != res["plain"] or res["kernels"][:2] != (
                "optimal", 34):
            fail(f"golomb(8) pinned: kernels {res['kernels']} vs plain "
                 f"{res['plain']}")
    paths["golomb(8), cap 16, kernels vs plain"] = counted(
        "golomb(8), cap 16, kernel engine vs plain engine", golomb8_pinned,
        required=step_kernels + table_kernels)

    text = golomb(big)
    model = parse_fzn_text(text)

    def golomb_big():
        out, err, stats = run_cli([write_model(f"golomb{big}", text), "-s",
                                   "-or", "0", "-t", "60000", "-v", "-v"])
        blocks = [b for b in out.split("----------\n")[:-1]]
        if not blocks:
            fail(f"golomb({big}): no solution printed")
        for b in blocks:
            check_solution(model, b)
        dk = re.search(r"% D=(\d+) k=(\d+)", err)
        tbl = re.search(r"% eps table: (.*)", err)
        cal = re.findall(r"^% auto fp_cap=.*$", out, re.M)
        nodes, solve_t = int(stats["nodes"]), float(stats["solveTime"])
        log(f"  {len(blocks)} solution(s) checked; objective "
            f"{stats.get('objective')} (optimum {GOLOMB_OPT[big]}); nodes "
            f"{nodes}, nodes/s {nodes / solve_t:.0f}, solveTime "
            f"{solve_t:.3f} s, fixpoint_iterations "
            f"{stats['fixpoint_iterations']}, D "
            f"{dk.group(1) if dk else '?'}, k {dk.group(2) if dk else '?'}")
        log(f"  table_build_time {stats.get('table_build_time')} s; "
            f"{tbl.group(1) if tbl else 'no table line'}; calibration: "
            f"{cal or 'none'}; steal rounds "
            f"{len(re.findall('^% stack steal #', out, re.M))}, resplit "
            f"rounds {len(re.findall('^% tail resplit #', out, re.M))}, "
            f"eps_redistributions {stats.get('eps_redistributions')}")

    # The main path: the default CLI at full width, which builds the
    # table, refills from it, drains the range and reaches the steal gate.
    log(f"[6] golomb({big}), default CLI, -or 0, -t 60000")
    paths[MAIN] = counted(f"the default CLI, golomb({big})", golomb_big,
                          required=all_kernels)

    tnf_big = compile_model(model)

    log(f"[7] table-off path: golomb({big}), D=512, solver API, 15 s")
    paths[f"table off, golomb({big})"] = counted(
        f"the table-off path, golomb({big})",
        api_run(dev, big, tnf_big, model, 15, use_table=False,
                fp_cap_auto=False),
        required=step_kernels)

    def drain():
        s = BatchedSolver(compile_model(parse_fzn_text(golomb(8))),
                          EngineConfig(num_dives=64, subproblems_power=4),
                          device=dev)
        r = s.solve()
        if (r.status, r.objective) != ("optimal", 34):
            fail(f"drain case: expected optimal 34, got {r.status} "
                 f"{r.objective}")
        log(f"  optimal 34: nodes {r.nodes}, solveTime {r.solve_time:.3f} s,"
            f" eps_redistributions {r.eps_redistributions}, auto cap "
            f"{s.last_auto_cap}")

    log("[8] drain-forcing case: golomb(8), D=64 over 2^4 subproblems")
    paths["drain-forcing, golomb(8)"] = counted(
        "the drain-forcing case, golomb(8)", drain, required=all_kernels)
    steal_round_trip(torch, dev, big, tnf_big)

    def all_queens():
        text = queens(8)
        qmodel = parse_fzn_text(text)
        out, _, stats = run_cli([write_model("queens8", text), "-a", "-s"])
        blocks = out.split("----------\n")[:-1]
        bodies = set()
        for b in blocks:
            body = "\n".join(l for l in b.splitlines()
                             if not l.startswith("%"))
            check_solution(qmodel, body)
            bodies.add(body)
        if len(blocks) != QUEENS_COUNT[8] or len(bodies) != len(blocks):
            fail(f"queens(8) -a: {len(blocks)} blocks, {len(bodies)} "
                 f"distinct, expected {QUEENS_COUNT[8]}")
        if "==========" not in out:
            fail("queens(8) -a: no final separator")
        log(f"  {len(blocks)} distinct checker-valid solutions (OEIS A000170:"
            f" 92); nodes {stats['nodes']}, solveTime "
            f"{float(stats['solveTime']):.3f} s")

    log("[9] -a on queens(8), card CLI")
    paths["-a, queens(8)"] = counted("-a, queens(8)", all_queens,
                                     required=step_kernels)

    def improving_golomb():
        text = golomb(9)
        gmodel = parse_fzn_text(text)
        out, _, stats = run_cli([write_model("golomb9", text), "-i", "-s",
                                 "-t", "30000"])
        blocks = out.split("----------\n")[:-1]
        if not blocks:
            fail("golomb(9) -i: no solution printed")
        objs = []
        for b in blocks:
            body = "\n".join(l for l in b.splitlines()
                             if not l.startswith("%"))
            check_solution(gmodel, body)
            objs.append(int(re.search(r"^m8 = (-?\d+);$", body, re.M)[1]))
        closed = "==========" in out
        final = int(stats["objective"])
        if objs[-1] != final or (closed and final != GOLOMB_OPT[9]):
            fail(f"golomb(9) -i: blocks {objs}, objective {final}, closed "
                 f"{closed}")
        log(f"  {len(blocks)} checker-valid blocks, objectives {objs}; "
            f"{'optimal' if closed else 'not closed'} at {final}; nodes "
            f"{stats['nodes']}, solveTime {float(stats['solveTime']):.3f} s")

    log("[10] -i -t 30000 on golomb(9), card CLI")
    paths["-i, golomb(9)"] = counted(
        "-i, golomb(9)", improving_golomb,
        required=step_kernels + table_kernels)
    paths.update(run_option_paths(torch, dev, big))
    return paths


def run_option_paths(torch, dev, big=12):
    """Phases 10b-10f: the paths of ``-fp wac1``, ``fp_mode="fixed"``,
    ``fp_layout="vd"``, ``-arch hybrid`` and ``-checkpoint``. Returns
    their launch counts by label."""
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.instances import GOLOMB_OPT, golomb
    step_kernels, table_kernels = STEP_KERNELS, TABLE_KERNELS
    rest = tuple(k for k in step_kernels if k != "fixpoint")
    paths = {}
    text = golomb(big)
    model = parse_fzn_text(text)
    tnf_big = compile_model(model)

    def checked_blocks(out, what, m=model):
        blocks = out.split("----------\n")[:-1]
        if not blocks:
            fail(f"{what}: no solution printed")
        for b in blocks:
            check_solution(m, "\n".join(l for l in b.splitlines()
                                        if not l.startswith("%")))
        return len(blocks)

    def cli_big(what, seconds, *opts):
        def run():
            out, _, stats = run_cli([write_model(f"golomb{big}", text), "-s",
                                     "-or", "0", "-t", str(seconds * 1000),
                                     *opts])
            n = checked_blocks(out, what)
            nodes, solve_t = int(stats["nodes"]), float(stats["solveTime"])
            log(f"  {n} solution(s) checked; objective "
                f"{stats.get('objective')} (optimum {GOLOMB_OPT[big]}); nodes "
                f"{nodes}, nodes/s {nodes / solve_t:.0f}, solveTime "
                f"{solve_t:.3f} s, fixpoint_iterations "
                f"{stats['fixpoint_iterations']} "
                f"({int(stats['fixpoint_iterations']) / max(nodes, 1):.2f} "
                f"per node), table_build_time "
                f"{stats.get('table_build_time', 'absent')}; per block: "
                f"solve_time {stats['solve_time']}, fixpoint_time "
                f"{stats['fixpoint_time']}, search_time "
                f"{stats['search_time']}")
        return run

    log(f"[10b] -fp wac1: golomb({big}), card CLI, -or 0, -t 30000")
    c = paths[WAC1] = counted(
        f"-fp wac1, golomb({big})", cli_big("-fp wac1", 30, "-fp", "wac1"),
        required=("wac1",) + rest + table_kernels)
    # K8 ran in every level of the table build and in every step, K1 never.
    if c["fixpoint"] != 0 or c["wac1"] != c["step.pre"] + c["embed.embed"]:
        fail(f"-fp wac1: K8 launches {c['wac1']} != steps {c['step.pre']} + "
             f"table levels {c['embed.embed']}, or K1 ran ({c['fixpoint']})")

    log(f"[10c] fp_mode fixed and fp_layout vd: golomb({big}), D=512, solver "
        f"API, 8 s each")
    paths[FIXED] = counted(
        f"fp_mode fixed, golomb({big})",
        api_run(dev, big, tnf_big, model, 8, fp_mode="fixed"),
        required=("fixpoint.fixed_sweeps",) + rest)
    paths[VD] = counted(
        f"fp_layout vd, golomb({big})",
        api_run(dev, big, tnf_big, model, 8, fp_layout="vd"),
        required=("fixpoint.transposed",) + rest + table_kernels)

    log(f"[10d] -arch hybrid: golomb({big}), card CLI, -or 0, -t 15000")
    c = paths[f"-arch hybrid, golomb({big})"] = counted(
        f"-arch hybrid, golomb({big})",
        cli_big("-arch hybrid", 15, "-arch", "hybrid"),
        required=("fixpoint", "classify"))
    # One K1 and one K2 launch per round, and nothing else.
    if c["fixpoint"] != c["classify"] or c["step"] or c["select"]:
        fail(f"-arch hybrid: launches {c}")
    # The card's share of a hybrid round: 3 s of the same search through
    # the solver API under torch.profiler.
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.hybrid import HybridSolver
    hs = HybridSolver(tnf_big, EngineConfig(num_dives=512), device=dev)
    res = []
    prof = profile_steps(torch, lambda: res.append(hs.solve(timeout_s=3)), 1)
    r = res[0]
    log(f"  3 s under torch.profiler: {r.nodes} nodes, solveTime "
        f"{r.solve_time:.3f} s; " + (
            f"{prof[0]:.0f} device kernels and copies, {prof[1]:.1f} ms device "
            f"busy: {prof[1] / (r.solve_time * 1e3) * 100:.2f} % of the solve "
            f"time" if prof else "no device time (not measured)"))

    g8 = write_model("golomb8", golomb(8))
    few = ("-or", "128", "-sub", "10")

    def proofs():
        # The hybrid search dives every subproblem from the root on the
        # host: 128 cubes over 2^10 subproblems keep the proof short.
        for opts in (["-fp", "wac1"], ["-arch", "hybrid", *few],
                     ["-arch", "hybrid", *few, "-fp", "wac1"]):
            out, _, stats = run_cli([g8, "-s"] + opts)
            if "==========" not in out or int(stats.get("objective", -1)) != 34:
                fail(f"golomb(8) {opts}: expected optimal 34, got "
                     f"{stats.get('objective')}")
            log(f"  {' '.join(opts)}: optimal 34: nodes {stats['nodes']}, "
                f"fails {stats['failures']}, solveTime "
                f"{float(stats['solveTime']):.3f} s, fixpoint_iterations "
                f"{stats['fixpoint_iterations']}")

    log("[10e] golomb(8) proven optimal under -fp wac1, -arch hybrid and both")
    paths["golomb(8) proofs: wac1, hybrid, hybrid wac1"] = counted(
        "the golomb(8) proofs", proofs,
        required=("wac1", "fixpoint", "classify") + rest + table_kernels)

    g9 = write_model("golomb9", golomb(9))
    g9model = parse_fzn_text(golomb(9))

    def resume(arch, cut, *opts):
        def run():
            ck = WORK / f"golomb9.{arch}.ckpt"
            ck.unlink(missing_ok=True)
            base = [g9, "-s", "-arch", arch, "-checkpoint", str(ck), *opts]
            out, _, st1 = run_cli(base + ["-cutnodes", str(cut)])
            if "==========" in out or not ck.exists():
                fail(f"-checkpoint ({arch}): the cut run closed or wrote no "
                     f"file")
            out, err, st2 = run_cli(base)
            checked_blocks(out, f"-checkpoint ({arch})", g9model)
            if "==========" not in out or int(st2.get("objective", -1)) != \
                    GOLOMB_OPT[9]:
                fail(f"-checkpoint ({arch}): the resumed run did not close at "
                     f"{GOLOMB_OPT[9]}: {st2.get('objective')}")
            # The resumed run carries the cut run's counters on.
            if "ignored" in err or "could not resume" in err or \
                    int(st2["nodes"]) <= int(st1["nodes"]):
                fail(f"-checkpoint ({arch}): the file was not resumed: "
                     f"{err.strip()[-300:]}")
            log(f"  -arch {arch}: cut at {st1['nodes']} nodes, file "
                f"{ck.stat().st_size} bytes; resumed and closed at "
                f"{st2['objective']} with {st2['nodes']} nodes in all, "
                f"solveTime {float(st2['solveTime']):.3f} s")
            ck.unlink()  # the batched state with its stacks is large
        return run

    log("[10f] -checkpoint: golomb(9) cut by -cutnodes, resumed, closes at 44")
    paths["-checkpoint, golomb(9)"] = counted(
        "-checkpoint, golomb(9)", resume("tpu", 5000),
        required=step_kernels + table_kernels)
    paths["-checkpoint -arch hybrid, golomb(9)"] = counted(
        "-checkpoint -arch hybrid, golomb(9)", resume("hybrid", 5000, *few),
        required=("fixpoint", "classify"))
    return paths


def run_multi_paths(torch, dev, big=12):
    """Phase 12: the paths of ``-arch multi``, S EPS shards as lane groups
    on one card. Returns their launch counts by label."""
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.host.solver.plan import auto_num_dives
    from turbo_tpu_torch.host.utils.output import print_solution
    from turbo_tpu_torch.instances import (GOLOMB_OPT, QUEENS_COUNT, golomb,
                                           queens)
    from turbo_tpu_torch.parallel.mesh import ShardedSolver, rebalance_ranges
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.convert import (search_state_from_numpy,
                                                search_state_to_numpy)
    from turbo_tpu_torch.solver.engine import IDLE, BatchedSolver
    paths = {}
    text = golomb(big)
    model = parse_fzn_text(text)
    tnf = compile_model(model)
    D = auto_num_dives(tnf)

    def block(t, lb):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            print_solution(t, lb)
        return buf.getvalue()

    def rate(r):
        return r.nodes / max(r.solve_time, 1e-9)

    def sharded_big():
        ms = ShardedSolver(tnf, EngineConfig(num_dives=D),
                           devices=[dev] * SHARDS)
        found = []
        r = ms.solve(timeout_s=20, on_improve=found.append)
        if r.best_lb is None:
            fail(f"-arch multi, golomb({big}): no solution")
        for lb in found + [r.best_lb]:
            check_solution(model, block(tnf, lb))
        s = ms.solver
        tb = [s.get_table(g) for g in range(SHARDS)] if s.use_table else []
        st = ms.init_state()  # the tables are built: shapes only
        nbytes = sum(getattr(st, f.name).nbytes
                     for f in dataclasses.fields(st))
        # One rebalance round as the loop runs it, with shard 0 made dry:
        # the state to the host, rebalance_ranges, the state back.
        st, _ = ms.run_steps(st, 30, 8)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fields = search_state_to_numpy(st)
        fields["phase"][:D] = IDLE
        fields["next_sub"][:D] = fields["sub_limit"][:D]
        t1 = time.monotonic()
        fields, moves = rebalance_ranges(fields, D, SHARDS, s.plan.lb0,
                                         s.plan.ub0, use_table=s.use_table)
        t2 = time.monotonic()
        search_state_from_numpy(fields, dev)
        torch.cuda.synchronize()
        t3 = time.monotonic()
        del st, fields
        log(f"  one rebalance round on a golomb({big}) S={SHARDS} state "
            f"({moves} shard revived): {t3 - t0:.3f} s (to the host "
            f"{t1 - t0:.3f}, rebalance_ranges {t2 - t1:.3f}, back "
            f"{t3 - t2:.3f})")
        log(f"  S={SHARDS} x D={D}, k={s.k}, MAXD={s.cfg.max_depth}: "
            f"{len(found)} improving solution(s) and the best checked; "
            f"objective {r.objective} (optimum {GOLOMB_OPT[big]}); nodes "
            f"{r.nodes}, nodes/s {rate(r):.0f}, solveTime {r.solve_time:.3f}"
            f" s, fixpoint_iterations {r.fixpoint_iterations}, auto cap "
            f"{s.last_auto_cap}, table_build_time {r.table_build_time:.3f} s"
            f" (live rows by shard {[t.n_live for t in tb]}, n_pad "
            f"{tb[0].n_pad if tb else None}); rebalance rounds "
            f"{ms.rebalance_rounds} ({ms.rebalance_s:.3f} s), "
            f"eps_redistributions {r.eps_redistributions}; the state "
            f"{nbytes / 1e6:.1f} MB ({nbytes / SHARDS / 1e6:.1f} MB a shard)")

    def single_big(lanes):
        def run():
            s = BatchedSolver(tnf, EngineConfig(num_dives=lanes), device=dev)
            r = s.solve(timeout_s=20)
            if r.best_lb is None:
                fail(f"golomb({big}), D={lanes}: no solution")
            check_solution(model, block(tnf, r.best_lb))
            log(f"  one solver, D={lanes}, k={s.k}: objective {r.objective},"
                f" nodes {r.nodes}, nodes/s {rate(r):.0f}, solveTime "
                f"{r.solve_time:.3f} s, auto cap {s.last_auto_cap}, "
                f"eps_redistributions {r.eps_redistributions}")
        return run

    step_kernels = STEP_KERNELS + TABLE_KERNELS
    log(f"[12a] -arch multi: golomb({big}) at full width, S={SHARDS} lane "
        f"groups x D={D}, table on, 20 s, against one solver of D={D} and "
        f"of D={SHARDS * D} for 20 s each")
    paths[MULTI] = counted(MULTI, sharded_big, required=step_kernels)
    for lanes in (D, SHARDS * D):
        counted(f"one solver, golomb({big}), D={lanes}", single_big(lanes),
                required=step_kernels)

    t8 = compile_model(parse_fzn_text(golomb(8)))
    D8 = auto_num_dives(t8)

    def golomb8_multi():
        ms = ShardedSolver(t8, EngineConfig(num_dives=D8),
                           devices=[dev] * SHARDS)
        r = ms.solve()
        if (r.status, r.objective) != ("optimal", GOLOMB_OPT[8]):
            fail(f"-arch multi, golomb(8): {r.status} {r.objective}")
        log(f"  S={SHARDS} x D={D8}: optimal 34, nodes {r.nodes}, solveTime "
            f"{r.solve_time:.3f} s, eps_redistributions "
            f"{r.eps_redistributions}, rebalance rounds "
            f"{ms.rebalance_rounds} ({ms.rebalance_s:.3f} s)")
        out, _, stats = run_cli([write_model("golomb8", golomb(8)), "-s",
                                 "-arch", "multi"])
        if "==========" not in out or int(stats.get("objective", -1)) != 34:
            fail(f"-arch multi CLI, golomb(8): {stats.get('objective')}")
        log(f"  CLI -arch multi (one shard a card): optimal 34, nodes "
            f"{stats['nodes']}, solveTime {float(stats['solveTime']):.3f} s")

    log(f"[12b] golomb(8) proven optimal, S={SHARDS} (solver API) and "
        "-arch multi (CLI)")
    paths["-arch multi, golomb(8)"] = counted(
        "-arch multi, golomb(8)", golomb8_multi, required=step_kernels)

    def queens_multi():
        q = queens(8)
        qm = parse_fzn_text(q)
        qt = compile_model(qm)
        Dq = auto_num_dives(qt)
        ms = ShardedSolver(qt, EngineConfig(
            num_dives=Dq, enumerate_all=True,
            sol_ring_size=min(4 * Dq, 8192)), devices=[dev] * SHARDS)
        got = []
        r = ms.solve(stop_after_n_solutions=0, on_solution=got.append)
        bodies = set()
        for lb in got:
            b = block(qt, lb)
            check_solution(qm, b)
            bodies.add(b)
        if not (len(got) == len(bodies) == r.solutions == QUEENS_COUNT[8]
                and r.exhaustive):
            fail(f"-arch multi -a, queens(8): {len(got)} streamed, "
                 f"{len(bodies)} distinct, {r.solutions} counted")
        log(f"  S={SHARDS} x D={Dq}: {len(got)} distinct checker-valid "
            f"solutions through the shards' rings; nodes {r.nodes}, "
            f"solveTime {r.solve_time:.3f} s")

    log(f"[12c] -a on queens(8), S={SHARDS}, through the rings")
    paths["-arch multi -a, queens(8)"] = counted(
        "-arch multi -a, queens(8)", queens_multi,
        required=STEP_KERNELS)

    # 8 lanes a shard over 2^8 subproblems: shards drain at different
    # times, so rebalance rounds run on both engines.
    pin = dict(num_dives=8, subproblems_power=8)

    def golomb8_pinned_multi():
        cfg = EngineConfig(fp_cap_auto=False, **pin)
        res = {}
        for name in ("kernels", "plain"):
            ms = ShardedSolver(t8, cfg, devices=[dev] * SHARDS)
            if name == "plain":
                plain_engine(ms.solver)
            t0 = time.monotonic()
            r = ms.solve(fp_cap=16)
            res[name] = (r.status, r.objective, r.nodes, r.fails,
                         r.solutions, r.fixpoint_iterations,
                         r.eps_redistributions)
            log(f"  {name}: status/obj/nodes/fails/sols/fp_iters/"
                f"redistributions {res[name]}, "
                f"{time.monotonic() - t0:.1f} s; rebalance rounds "
                f"{ms.rebalance_rounds} ({ms.rebalance_s:.3f} s)")
        if res["kernels"] != res["plain"] or res["kernels"][:2] != (
                "optimal", 34):
            fail(f"golomb(8) S={SHARDS} pinned: kernels {res['kernels']} vs "
                 f"plain {res['plain']}")

    log(f"[12d] golomb(8), S={SHARDS} x D={pin['num_dives']} over 2^"
        f"{pin['subproblems_power']} subproblems, cap pinned at 16: kernel "
        "engine vs plain engine")
    paths[f"-arch multi, golomb(8), cap 16, kernels vs plain"] = counted(
        "-arch multi, golomb(8), cap 16", golomb8_pinned_multi,
        required=step_kernels)
    return paths


def hosts_worker(argv):
    """``chip_smoke.py --hosts-worker PID N PORT SPEC``: host PID of N of a
    multi-host run (``parallel/multihost.py``) through the solver API,
    joined over gloo at localhost:PORT (N=1: no group). SPEC is JSON:
    the model file, ``num_dives`` (0: auto), ``k`` (0: host 0 chooses),
    ``seconds``, ``plain`` (the plain engine in place of the kernels),
    ``platform``, ``shards`` (lane groups by host; default one each). Every improving solution and the best are checked; the
    last line of stdout is a JSON object of the result, the exchange's
    times and this process's launch counts."""
    import torch
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.device import pick_device
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn
    from turbo_tpu_torch.host.solver.plan import auto_num_dives
    from turbo_tpu_torch.host.utils.output import print_solution
    from turbo_tpu_torch.parallel.multihost import (MultiHostSolver,
                                                    init_distributed,
                                                    shutdown_distributed)
    from turbo_tpu_torch.solver.config import EngineConfig
    pid, n, port = int(argv[0]), int(argv[1]), argv[2]
    spec = json.loads(argv[3])
    init_distributed(f"localhost:{port}", n, pid)
    model = parse_fzn(spec["model"])
    tnf = compile_model(model)
    D = spec["num_dives"] or auto_num_dives(tnf)
    dev = pick_device(spec.get("platform", ""), pid)
    shards = spec.get("shards", [1] * n)[pid]
    mh = MultiHostSolver(tnf, EngineConfig(
        num_dives=D, subproblems_power=spec["k"]), devices=[dev] * shards)
    if spec["plain"]:
        plain_engine(mh.sharded.solver)
    found = []
    kernels.reset_launches()
    t0 = time.monotonic()
    r = mh.solve(timeout_s=spec["seconds"], on_improve=found.append)
    wall = time.monotonic() - t0
    counts = kernels.launch_counts()
    for lb in found + ([r.best_lb] if r.best_lb is not None else []):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            print_solution(tnf, lb)
        check_solution(model, buf.getvalue())
    ag = sorted(mh.allgather_s)
    # The transport alone: back-to-back allgathers of a snapshot-sized
    # vector after a barrier, no device work between them.
    alone = []
    if n > 1:
        import numpy as np
        import torch.distributed as dist
        from turbo_tpu_torch.parallel.multihost import dcn_allgather
        vec = np.zeros(6 + 2 * mh.S_max + int(mh.plan.V), dtype=np.int64)
        dist.barrier()
        for _ in range(201):
            t1 = time.monotonic()
            dcn_allgather(vec)
            alone.append(time.monotonic() - t1)
        alone.sort()
    out = dict(
        pid=pid, hosts=n, D=D, k=mh.sharded.solver.k,
        MAXD=mh.sharded.solver.cfg.max_depth, status=r.status,
        objective=r.objective, exhaustive=r.exhaustive, nodes=r.nodes,
        fails=r.fails, solutions=r.solutions,
        fixpoint_iterations=r.fixpoint_iterations, depth_max=r.depth_max,
        eps_solved=r.eps_solved_subproblems,
        eps_skipped=r.eps_skipped_subproblems,
        eps_redistributions=r.eps_redistributions,
        solve_time=r.solve_time, wall=wall, improvements=len(found),
        exchanges=len(ag), allgather_ms_median=(ag[len(ag) // 2] * 1e3
                                                 if ag else None),
        allgather_ms_max=(ag[-1] * 1e3 if ag else None),
        transport_ms_median=(alone[len(alone) // 2] * 1e3 if alone
                             else None),
        exchange_s=mh.exchange_s, steal_moves=mh.steal_moves,
        steal_s=mh.steal_s, snapshot_bytes=8 * (6 + 2 * mh.S_max
                                                + int(mh.plan.V)),
        launches=counts)
    shutdown_distributed()
    print(json.dumps(out), flush=True)


def free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def run_hosts(argvs, timeout=300):
    """Start one process per argv (host i gets argv i) and wait for all;
    fails if any exits non-zero or outlives ``timeout`` (then every one
    is killed). Returns each one's (stdout, stderr)."""
    procs = [subprocess.Popen(a, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a in argvs]
    outs, bad = [], []
    deadline = time.monotonic() + timeout
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            bad.append(f"host {i} ran past {timeout} s")
        if p.returncode != 0:
            bad.append(f"host {i} exited {p.returncode}: {err[-3000:]}")
        outs.append((out, err))
    if bad:
        fail("; ".join(bad))
    return outs


def api_hosts(n, spec, timeout=300):
    """``hosts_worker`` in n processes on the card; their results."""
    port = str(free_port())
    outs = run_hosts([[sys.executable, str(ROOT / "chip_smoke.py"),
                       "--hosts-worker", str(i), str(n), port,
                       json.dumps(spec)] for i in range(n)], timeout)
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def cli_hosts(args, n=2, timeout=300):
    """The port's CLI as n hosts (``-hosts n -host_id i``); returns each
    host's stdout."""
    port = free_port()
    return [out for out, _ in run_hosts([
        [sys.executable, "-m", "turbo_tpu_torch.cli", *args, "-hosts",
         str(n), "-host_id", str(i), "-coordinator", f"localhost:{port}"]
        for i in range(n)], timeout)]


def run_hosts_paths(torch, dev, big=12, platform=""):
    """Phase 13: ``-hosts 2``, two processes sharing the one card, each
    one shard and its own CUDA context, joined over gloo. Returns the
    launch counts of the main -hosts path (golomb(big), both processes
    summed) under ``HOSTS2``, and the dcn_allgather entry of the JSON
    line."""
    from turbo_tpu_torch.instances import GOLOMB_OPT, golomb
    plat = ["-platform", platform] if platform else []
    on_card = dev.type == "cuda"

    g8 = write_model("golomb8", golomb(8))
    log("[13a] golomb(8) through the CLI, -hosts 2 (two processes, one "
        "card)")
    t0 = time.monotonic()
    outs = cli_hosts([g8, "-s", *plat])
    stats = dict(re.findall(r"^%%%mzn-stat: (\w+)=(.*)$", outs[0], re.M))
    done = (int(stats.get("eps_solved_subproblems", -1))
            + int(stats.get("eps_skipped_subproblems", -1)))
    if ("==========" not in outs[0] or stats.get("objective") != "34"
            or done != int(stats.get("eps_num_subproblems", 0))):
        fail(f"-hosts 2, golomb(8): objective {stats.get('objective')}, "
             f"solved+skipped {done} of {stats.get('eps_num_subproblems')}")
    if outs[1].strip():
        fail(f"-hosts 2: host 1 printed {outs[1][:200]!r}")
    log(f"  optimal 34; solved+skipped {done} = 2^k; nodes {stats['nodes']},"
        f" solveTime {float(stats['solveTime']):.3f} s, eps_redistributions "
        f"{stats['eps_redistributions']}; host 1 silent; "
        f"{time.monotonic() - t0:.1f} s with the processes' start")

    spec = dict(model=write_model(f"golomb{big}", golomb(big)), num_dives=0,
                k=0, seconds=20, plain=False, platform=platform)
    log(f"[13b] golomb({big}) at full width (auto D a process, k by host "
        "0), 20 s as two processes, then one process alone")
    res = api_hosts(2, spec)
    paths = {}
    for r in res:
        missing = [k for k in STEP_KERNELS if on_card and
                   r["launches"][k] <= 0]
        if missing:
            fail(f"-hosts 2, host {r['pid']}: {missing} not launched")
    counts = {k: sum(r["launches"][k] for r in res)
              for k in res[0]["launches"]}
    paths[HOSTS2] = counts
    log(f"  launches on {HOSTS2} (both processes): " + ", ".join(
        f"{k} {n}" for k, n in counts.items()))
    h0 = res[0]
    for r in res:
        log(f"  host {r['pid']}: D={r['D']} k={r['k']} MAXD={r['MAXD']} "
            f"objective {r['objective']} (optimum {GOLOMB_OPT[big]}), "
            f"{r['improvements']} improving solution(s) and the best "
            f"checked; global nodes {r['nodes']}, solveTime "
            f"{r['solve_time']:.3f} s, exchanges {r['exchanges']}, "
            f"dcn_allgather median {r['allgather_ms_median']:.4f} ms (max "
            f"{r['allgather_ms_max']:.4f}; alone, after a barrier "
            f"{r['transport_ms_median']:.4f}), exchange {r['exchange_s']:.3f} s "
            f"({100 * r['exchange_s'] / r['wall']:.2f} % of the solve's "
            f"wall {r['wall']:.3f} s), steal moves {r['steal_moves']} "
            f"({r['steal_s']:.3f} s), eps_redistributions "
            f"{r['eps_redistributions']}, snapshot {r['snapshot_bytes']} B")
    rate2 = h0["nodes"] / h0["solve_time"]
    one = api_hosts(1, spec)[0]
    rate1 = one["nodes"] / one["solve_time"]
    log(f"  -hosts 2 summed: {rate2:.0f} nodes/s; one process of D="
        f"{one['D']} (k={one['k']}): {rate1:.0f} nodes/s, objective "
        f"{one['objective']}, exchanges {one['exchanges']} (no peer); "
        f"ratio {rate2 / rate1:.3f}")
    allgather = dict(
        name="dcn_allgather",
        route="gloo all_gather, host transport (no device arithmetic)",
        source="turbo_tpu_torch/parallel/multihost.py",
        replaces="turbo_tpu/parallel/multihost.py:39",
        path=HOSTS2, exchanges=h0["exchanges"],
        exchanges_per_s=h0["exchanges"] / h0["wall"],
        ms=h0["allgather_ms_median"], ms_host1=res[1]["allgather_ms_median"],
        transport_alone_ms=h0["transport_ms_median"],
        exchange_share_of_wall=h0["exchange_s"] / h0["wall"],
        snapshot_bytes=h0["snapshot_bytes"], bound_ms=None,
        bound="n/a (host transport)", steal_moves=h0["steal_moves"],
        steal_s=h0["steal_s"])

    # golomb(8) over 2^7 subproblems, hosts of one and two lane groups of
    # 16 lanes: a host drains its range first and steals once (so does
    # the port's run of this configuration on the CPU).
    pin = dict(model=g8, num_dives=HOSTS_PIN[0], k=HOSTS_PIN[1],
               shards=HOSTS_PIN[2], seconds=600, platform=platform)
    log(f"[13c] golomb(8), two processes of {pin['shards']} lane groups of "
        f"D={pin['num_dives']} over 2^{pin['k']} subproblems: kernel engine "
        "vs plain engine (exact)")
    got = {}
    for name in ("kernels", "plain"):
        t0 = time.monotonic()
        r = api_hosts(2, dict(pin, plain=name == "plain"), timeout=600)
        got[name] = [tuple(x[k] for k in (
            "status", "objective", "nodes", "fails", "solutions",
            "fixpoint_iterations", "depth_max", "eps_solved", "eps_skipped",
            "eps_redistributions")) for x in r]
        log(f"  {name}: status/obj/nodes/fails/sols/fp_iters/depth/solved/"
            f"skipped/redistributions {got[name][0]}, "
            f"{time.monotonic() - t0:.1f} s with the processes' start")
    if (got["kernels"] != got["plain"] or got["kernels"][0] != got[
            "kernels"][1] or got["kernels"][0][:2] != ("optimal", 34)
            or got["kernels"][0][-1] < 1):
        fail(f"-hosts 2 golomb(8): kernels {got['kernels']} vs plain "
             f"{got['plain']} (a steal is required)")

    g9 = write_model("golomb9", golomb(9))
    ck = WORK / "hosts.ckpt"
    log("[13d] -checkpoint over two processes: golomb(9) cut by -cutnodes, "
        "resumed, closes at 44")
    base = [g9, "-s", "-checkpoint", str(ck), *plat]
    cut = cli_hosts(base + ["-cutnodes", "5000"])
    files = [pathlib.Path(f"{ck}.h{i}").exists() for i in range(2)]
    if "==========" in cut[0] or not all(files):
        fail(f"-hosts 2 -checkpoint: the cut run closed or wrote no files "
             f"{files}")
    st1 = dict(re.findall(r"^%%%mzn-stat: (\w+)=(.*)$", cut[0], re.M))
    res2 = cli_hosts(base)
    st2 = dict(re.findall(r"^%%%mzn-stat: (\w+)=(.*)$", res2[0], re.M))
    if "==========" not in res2[0] or st2.get("objective") != "44":
        fail(f"-hosts 2 -checkpoint: resumed run {st2.get('objective')}")
    log(f"  cut at {st1['nodes']} nodes (objective {st1.get('objective')}),"
        f" resumed: optimal 44, nodes {st2['nodes']}, solveTime "
        f"{float(st2['solveTime']):.3f} s")
    for i in range(2):  # the states are large: keep them out of WORK
        pathlib.Path(f"{ck}.h{i}").unlink()
    return paths, allgather


def steal_round_trip(torch, dev, big, tnf):
    """The host round trip of a golomb(big) table-mode state (D=512) and
    one steal round on it, timed."""
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.convert import (search_state_from_numpy,
                                                search_state_to_numpy)
    from turbo_tpu_torch.solver.engine import IDLE, SOLVE, BatchedSolver
    s = BatchedSolver(tnf, EngineConfig(num_dives=512), device=dev)
    st, _ = s.run_steps(s.init_state(), 30, 4)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fields = search_state_to_numpy(st)
    search_state_from_numpy(fields, dev)
    torch.cuda.synchronize()
    rt_s = time.monotonic() - t0
    fields["phase"][::2] = IDLE  # half the lanes as thieves
    thieves = search_state_from_numpy(fields, dev)
    t0 = time.monotonic()
    res = s._steal_open_branches(thieves, fields["phase"])
    torch.cuda.synchronize()
    steal_s = time.monotonic() - t0
    nbytes = sum(a.nbytes for a in fields.values())
    log(f"  golomb({big}) table-mode state ({nbytes / 1e6:.1f} MB, MAXD "
        f"{s.cfg.max_depth}, {int((st.phase == SOLVE).sum())} SOLVE lanes): "
        f"host round trip {rt_s:.3f} s; one steal round "
        f"{steal_s:.3f} s ({res[1] if res else 0} branches reseeded)")


def main():
    if sys.argv[1:2] == ["--hosts-worker"]:
        sys.path.insert(0, str(ROOT))
        return hosts_worker(sys.argv[2:])
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    sys.path.insert(0, str(ROOT))
    try:
        import turbo_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"turbo_tpu_torch not found next to chip_smoke.py: {e}")
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.kernels import build as kbuild

    dev = torch.device("cuda:0")
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {kind}")
    shutil.rmtree(kbuild.BUILD_DIR, ignore_errors=True)
    t0 = time.monotonic()
    kernels.load()
    log(f"[2] kernel build (cold, nvcc sm_90a): {time.monotonic() - t0:.1f} s")
    for line in kbuild.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"    {line.strip()}")

    if "--hosts-only" in sys.argv[1:]:
        run_hosts_paths(torch, dev)
        log("--hosts-only: stopping after phase 13")
        sys.exit(0)
    log("[3] kernels vs plain torch (exact)")
    kres = phase_kernels(torch, dev)
    log("[3b] K6 + K7 vs the plain step on the same CUDA state (exact)")
    kres.update(phase_step_kernels(torch, dev))
    log(f"[3d] the step over S={SHARDS} EPS shards (K7 per shard) vs the "
        "plain sharded step on the same CUDA state (exact)")
    kres["step_tail.sharded"] = phase_sharded_step_kernels(
        torch, dev, kres["step_tail"])
    log("[3c] step loop, golomb(12), D=512, cap 16: K1 (dv), K8, fixed "
        "sweeps, the vd entry against dv and K1 without the skip against "
        "K1, in turns")
    loops = [("fp_mode fixpoint, layout dv, table on", {}, True, False),
             ("fp_mode wac1, table on", dict(fp_mode="wac1"), False, False),
             ("fp_mode fixed (2 sweeps), no table", dict(fp_mode="fixed"),
              False, False),
             ("layout vd, table on", dict(fp_layout="vd"), False, False),
             ("layout vd, table on (again)", dict(fp_layout="vd"), False,
              False),
             ("layout dv, table on (again)", {}, False, False),
             ("layout dv, table on, K1 without the skip", {}, False, True),
             ("layout dv, table on, K1 without the skip (again)", {}, False,
              True),
             ("layout dv, table on (third)", {}, False, False)]
    walls = {label: phase_step_loop(torch, dev, label, kw, full, no_skip=n)
             for label, kw, full, n in loops}
    log("  CUDA-graph wall ms per step, dv / vd / vd / dv: " + " / ".join(
        ", ".join(f"{w:.3f}" for w in walls[loops[i][0]])
        for i in (0, 3, 4, 5)))
    log("  CUDA-graph wall ms per step, K1 skip on / off / off / on: "
        + " / ".join(", ".join(f"{w:.3f}" for w in walls[loops[i][0]])
                     for i in (5, 6, 7, 8)))
    if "--kernels-only" in sys.argv[1:]:
        log("--kernels-only: stopping after phase 3c")
        sys.exit(0)

    paths = run_path(torch, dev)
    paths.update(run_multi_paths(torch, dev))
    hosts_paths, allgather = run_hosts_paths(torch, dev)
    paths.update(hosts_paths)
    log("[11] launches by path: " + "; ".join(
        f"{p}: " + ", ".join(f"{k} {n}" for k, n in c.items())
        for p, c in paths.items()))
    if "jax" in sys.modules or "turbo_tpu" in sys.modules:
        fail("jax or the turbo_tpu package was imported")
    # One entry per kernel, and one per entry point of K1 that replaces a
    # JAX function of its own. ``launches`` is read on the main path, or,
    # for a kernel the default search does not run, on its own path.
    # (name, kernel, replaces, path, launch-count key)
    k1 = kernels.fixpoint
    listed = [(k.name, k, k.replaces, WAC1 if k is kernels.wac1 else MAIN,
               k.name) for k in kernels.KERNELS]
    listed += [(f"{k1.name}.{e}", k1, k1.ENTRY_REPLACES[e], path,
                f"{k1.name}.{e}")
               for e, path in (("fixed_sweeps", FIXED), ("transposed", VD))]
    # K7 run per shard stands in for the sharded step of the JAX mesh;
    # its launches are K7's on the -arch multi path.
    tail = kernels.step_tail
    listed.append(("step_tail.sharded", tail, tail.SHARDED_REPLACES, MULTI,
                   tail.name))
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k.source,
         "replaces": replaces, "launches": paths[path][key], "path": path,
         "launches_by_path": {p: c[key] for p, c in paths.items()},
         "max_abs_err": kres[name][0], "ms": kres[name][1],
         "plain_ms": kres[name][2], "bound_ms": kres[name][3],
         "bound_by": kres[name][4], "library_ms": None}
        for name, k, replaces, path, key in listed], "main_path": MAIN,
        # Not a kernel: the -hosts exchange's transport (PERF.md row 18).
        "transports": [allgather]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
