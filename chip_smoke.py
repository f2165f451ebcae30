#!/usr/bin/env python3
"""Smoke test of turbo_tpu_torch on one CUDA card: ``python3 chip_smoke.py``.

Run from the root of the repository (``--kernels-only`` stops after
phase 3c; ``--hosts-only`` runs phases 1, 2 and 13; ``--cards-only``
phases 1, 2, 3e and 12e). Phases (any failure exits non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the kernel build with nvcc (one per source, in parallel) from a cold
   ``turbo_tpu_torch/kernels/_build``;
3. each kernel against its plain torch version on the same CUDA tensors,
   every output exactly equal (tolerance 0: all integer), with the median
   time of both: K1-K3 and K1's step entry (K1, then K2 and K3 in the
   same blocks: its 14 outputs against the plain fixpoint, classify and
   select on the plain fixpoint's result, caps 2 and 10000, shared- and
   global-memory paths) on 4 seeded random models at D=1024 with randomly
   narrowed stores and stores fixed at a solution, and on golomb(8) at
   D=1024 and golomb(12) at D=512; K1's and K8's table level entries
   (K4's parent gather, the fixpoint, K2 and K3 in one launch: their 13
   outputs against the plain ``dive_level``, both memory paths) on the
   widest level of a golomb(12) table build at W=512, at V=2560 and at
   an unrounded V that is not a multiple of 4 (rows loaded by the loop,
   not by TMA); K4's leaf entry against ``table_leaf_plain`` on the leaf
   levels of K1's two golomb(12) builds and of a golomb(8) build at
   D=1024, timed with L2 flushed, back to back and inside table builds
   (the JSON line's row is golomb(8)'s); K4's table refill (V and V - 1)
   and K5 (the open-branch count and the steal plan) on
   random stores, table rows, masks and stacks at golomb(12)'s shapes
   (D=512, V=2560, 2048 table rows, MAXD=10000); on the same stores
   K8 (WAC1: outer caps 2 and 10000, inner caps 1 and 16; iters, unconv
   and bot of every lane, the store of every lane that is not bot), K8's
   step entry (K8, then K2 and K3 in the same blocks: its 14 outputs
   against the plain WAC1 fixpoint, classify and select) and K1's other
   entries (2 and 5 fixed sweeps; the fixpoint on transposed
   (V, D) planes at caps 2 and 10000), each on the shared-memory and the
   global-memory path (K1's fixpoint entry at caps 2 and 10000 on both).
   The ``-Xptxas -v`` lines (registers, shared memory, spills) of K1, of
   its step and level entries and of K8's six kernels (each entry on each
   memory path), the resident blocks per SM of K1's and K8's entries at
   golomb(12), K8's times on both memory paths for each store and the
   step entries' epilogue bound are printed. The golomb(12) times go into
   the JSON line;
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
   parts (with the lanes whose rows each step moves, for the bounds),
   and the fixpoint iterations per node; then, from the same state, K1's
   step entry against K1's fixpoint entry followed by K2 and K3 as
   launches of their own, in turns (step entry, alone, alone, step
   entry), and the K1 step with K1 built with ``-DTT_NO_SKIP`` (no
   skip of unmoved rules) and as built, in turns (on, off, off, on); the
   same for K8's step entry and K8 on the ``fp_mode="wac1"`` state;
3d. the step over S=4 EPS shards, lane groups of one state (K6 over
   every lane, the shard scan in each shard's last K6 post block:
   ``parallel/mesh.py``), against the plain
   sharded step on the same CUDA state, every field equal after 1, 7
   and 40 steps and three chunks of 8 (CUDA graph): golomb(12) at D=512
   a shard with the table on, the 6 random models with the table off,
   queens(8) with enumerate_all and the rings; then each kernel's time
   inside 20 real golomb(12) steps at S=4, K6 + K7 per step against
   3b's S=1;
3e. the card-group step (``parallel/mesh.py``: the shards as card groups,
   a state, a solver and a stream each; K10 ``xcard`` reduces the
   incumbent min and live flag the groups published before each step)
   on a golomb(12) state at full width, S=4 x D=512, table on, cap 16,
   split into 2 x 2 (eager launches) and 4 x 1 groups (a CUDA graph a
   step) on one card: every field of the global state equal to the
   lane-group kernel step's after 1, 7 and 40 steps and three chunks of
   8; K10 alone against its plain version on random slot words of both
   parities (N = 1-64), exact, and its time; again with a group a card
   where the call has two or more cards (else one log line says it did
   not run);
3c. the step loop on golomb(12), D=512, table on, cap 16: chunks of 16
   steps under ``torch.cuda.set_sync_debug_mode("error")`` (any host
   sync inside a chunk fails the phase; so do more than 3.2 launches a
   step: 3 a step and 2 a chunk, under ``wac1`` too, or 5.2 under
   ``fixed`` and ``vd``, where K2 and K3 run on their own), launches per
   step, wall time
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
5c. the same in a fresh process (``fresh_cli``): its ``initTime`` with
   the kernel warm-up's parts, ``table_build_time``, solveTime, and the
   first table level's wall and device ms against the others';
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
   and K5 run; then, on a golomb(12) table-mode state (D=512,
   MAXD=10000) with every other lane made IDLE, the state's old host
   round trip and a steal round on the card (K5's count and plan, one
   host read, K9), held exactly to the host steal and to the plain
   torch versions in every field and plane, its wall time, the
   StepView unchanged and a captured chunk's graph still keyed after a
   second round; K5 and K9 against their plain versions (the JSON
   line's rows);
9. ``-a`` on queens(8) through the card CLI: 92 distinct checker-valid
   solution blocks and the final separator;
10. ``-i -t 30000`` on golomb(9) through the card CLI: every streamed
   block checker-valid, the last one at the final objective (44 when
   the run closes);
10b. ``-fp wac1`` on golomb(12) through the card CLI at full width
   (``-or 0``, ``-t 30000``): every solution checker-valid, K8's step
   entry launched once per step, its level entry once per table level,
   K8 alone, K1, K2 and K3 never;
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
12e. card groups: (a) golomb(8) at 12d's configuration, the card-group
   kernels (2 x 2 and 4 x 1 groups on one card) and the plain card-group
   engine (2 x 2) give the statistics of 12d's lane-group kernel run
   (status, objective, nodes, failures, solutions, iterations, the EPS
   statistics and the rebalance rounds); (b) golomb(12) at full width as
   4 x 1 groups on one card for 20 s, every improving solution
   checker-valid, nodes/s beside 12a's lane groups, K10 launched once a
   step a group (the path ``multi_cards``), then the host's enqueue us
   per step and each group's stream busy share over chunks of 16; with
   two or more cards (a) and (b) again with a group a card, and
   ``-arch multi -i`` through the CLI on golomb(12) for 20 s;
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
   0 just before the path and read just after it (with the table levels
   built, ``table levels``): the kernels of the default search (K1's
   step and level entries, K4's refill, K5, K6 and K7, each entry of K6
   and K7) on the main path (6), K9 excepted on the drain case (8), on
   the main path and the table-off path K1's step entry once a step,
   its level entry once a table level, K2 and K3 never; K1 with its step
   entry, K6 and K7 on the table-off path (7) and on ``-a``, the level
   entry and K4 too on ``-i``; K8's step and level entries in place of
   K1's on 10b, K1's fixed-sweeps and transposed entries with K2 and K3
   on 10c, K1 and K2 on the hybrid paths, K1 with its step entry, K6 and
   K7 in each process of 13b (summed over both processes into the path
   ``hosts2``).

It prints a JSON line of the kernels (with each one's bound: the larger
of the bytes it must move over 3.35 TB/s and its int32 operations over
67 T/s, at the timed shapes and this run's data; ``launches`` is the
count on the main path, or on the kernel's own path (``path``) where the
default search does not run it (K2 and K3 on the ``fixed`` path); each
entry of K6 and K7, and K1's and K8's step and level entries (with the
epilogue's own bound and their blocks per SM), has a row of its own
beside the kernel's; K6 and K7 over S shards, ``step.sharded``,
reads K6 post's launches on the ``-arch multi`` golomb(12) path and its
times from 3d; K5's and K9's times and bounds are phase 8's steal round;
``transports`` holds ``dcn_allgather``, a host transport and
not a kernel, with its times from 13b; K10 ``xcard`` reads its launches
on the path ``multi_cards`` and its times from 3e, and must not launch on
the main path or the lane-group ``-arch multi`` path), the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.
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
# Seconds between the heartbeat lines of the cold build (phase 2).
HEARTBEAT_S = 2.0
# The path whose launch counts the JSON line's ``launches`` reports.
MAIN = "default CLI, golomb(12)"
# The paths of K8 and of K1's other entries, read for their ``launches``.
WAC1 = "-fp wac1, golomb(12)"
FIXED = "fp_mode fixed, golomb(12)"
VD = "fp_layout vd, golomb(12)"
# -arch multi: EPS shards as lane groups on one card, and the path whose
# launch counts K6 and K7 over S shards report.
SHARDS = 4
MULTI = f"-arch multi, golomb(12), S={SHARDS}"
# -hosts 2: the main path's launch counts (both processes), and the
# (lanes, k, lane groups by host) of the golomb(8) kernels-vs-plain run,
# whose hosts steal.
HOSTS2 = "hosts2"
HOSTS_PIN = (16, 7, (1, 2))
# Card groups (-arch multi over cards): the path whose launch counts the
# JSON line's xcard row reads (12e: golomb(12), 4 x 1 groups on one card),
# and what 12e compares with from 12a and 12d (``MULTI_REFS``).
MULTI_CARDS = "multi_cards"
MULTI_REFS = {}


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


def graph_ms(fn, n=20, reps=5):
    """Device ms of one call of ``fn``: ``n`` calls captured in a CUDA
    graph, the graph replayed ``reps`` times, the median replay over
    ``n``. Unlike ``median_ms`` it leaves out the host's time to issue a
    launch, which a single short launch's events include."""
    import torch
    fn()  # warm-up: allocations and attributes outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[len(times) // 2]


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


def split_line(label, err):
    """The run's FIXPOINT/SEARCH split from the CLI's ``-v`` line. Fails
    on the measured chunks' no-kernel warning, and unless the split was
    measured with a fraction in (0, 1). Returns (fraction, the profile's
    wall s, the least-squares fit's fraction)."""
    if "% warning: the measured chunks timed no kernel" in err:
        fail(f"{label}: the measured chunks timed no kernel")
    m = re.search(r"^% timer split: measured, fixpoint fraction ([\d.]+) "
                  r"\(profile ([\d.]+) s; least-squares fit ([\d.]+|n/a)\)$",
                  err, re.M)
    if not m:
        fail(f"{label}: timer_split_measured False: "
             f"{re.findall(r'^% timer split.*$', err, re.M)}")
    frac, wall = float(m.group(1)), float(m.group(2))
    fit = None if m.group(3) == "n/a" else float(m.group(3))
    if not 0 < frac < 1:
        fail(f"{label}: measured fixpoint fraction {frac}")
    log(f"  timer_split_measured True: fixpoint fraction {frac:.4f} (the "
        f"least-squares fit's {m.group(3)}), the profile's wall {wall:.3f} s")
    return frac, wall, fit


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


# K8's instantiations (csrc/wac1.cu ``wac1_kernel<STEP, SMEM>``) by the
# mangled template arguments in their names.
K8_KERNELS = (("K8", "wac1_kernelILb0ELb1E"),
              ("K8's step entry", "wac1_kernelILb1ELb1E"),
              ("K8's level entry", "wac1_level_kernelILb1E"),
              ("K8, global-memory path", "wac1_kernelILb0ELb0E"),
              ("K8's step entry, global-memory path", "wac1_kernelILb1ELb0E"),
              ("K8's level entry, global-memory path",
               "wac1_level_kernelILb0E"),
              ("K8's stamped step entry", "wac1_step_stamped_kernelILb1E"),
              ("K8's stamped step entry, global-memory path",
               "wac1_step_stamped_kernelILb0E"))


def phase_kernels(torch, dev):
    """Each kernel vs its plain version on the same CUDA tensors."""
    import numpy as np
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.kernels import build as kbuild
    log("  K1 (-Xptxas -v): " + " | ".join(
        ptxas_lines(kbuild.build_log, "fixpoint_kernel")))
    log("  K1's step entry (-Xptxas -v): " + " | ".join(
        ptxas_lines(kbuild.build_log, "fixpoint_step_kernel")))
    log("  K1's stamped step entry (-Xptxas -v): " + " | ".join(
        ptxas_lines(kbuild.build_log, "fixpoint_step_stamped_kernel")))
    for what, kernel in (("K6 head", "step_head_kernel"),
                         ("K6 post", "step_post_kernel"),
                         ("K6's timed head", "step_head_timed_kernel"),
                         ("K6's timed post", "step_post_timed_kernel")):
        log(f"  {what} (-Xptxas -v): " + " | ".join(
            ptxas_lines(kbuild.build_log, kernel)))
    log("  K1's level entry (-Xptxas -v): " + " | ".join(
        ptxas_lines(kbuild.build_log, "fixpoint_level_kernel")))
    for what, kernel in K8_KERNELS:
        log(f"  {what} (-Xptxas -v): " + " | ".join(
            ptxas_lines(kbuild.build_log, kernel)))
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.host.solver import oracle
    from turbo_tpu_torch.instances import golomb, random_model
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.engine import BatchedSolver

    errs = dict.fromkeys(("fixpoint", "fixpoint.step", "classify", "select",
                          "wac1", "wac1.step", "fixpoint.fixed_sweeps",
                          "fixpoint.transposed", "fixpoint.step_stamped",
                          "wac1.step_stamped"), 0)
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

        def step_plain(cap, inner=None):
            # K1's or (with ``inner``) K8's step entry: the fixpoint, then
            # K2 and K3 on its result.
            w = (pk.fixpoint_plain(lb, ub, cap) if inner is None
                 else pk.fixpoint_wac1_plain(lb, ub, cap, inner))
            return (w + pk.classify_plain(w[0], w[1])
                    + s._select_plain(w[0], w[1], strat))

        # The stamped step entries' outputs but their stamps (3b checks
        # those), which go to one buffer.
        stamps = torch.zeros((D, 2), dtype=torch.int64, device=dev)
        span = torch.zeros(2, dtype=torch.int64, device=dev)

        def stamped(k, *caps, smem):
            return k.step_stamped(kp, lb, ub, *caps, strat, stamps, span,
                                  smem=smem)

        # A 4th element keys the plain result (it does not depend on the
        # memory path, so it is computed once for both); a 5th is applied
        # to both results before they are compared, outside the timing.
        memo = {}
        for smem in (True, False):
            for cap in (10000, 2):
                cases.append((
                    "fixpoint.step",
                    lambda c=cap, m=smem: kernels.fixpoint.step(
                        kp, lb, ub, c, strat, smem=m),
                    lambda c=cap: step_plain(c), ("s", cap)))
                cases.append((
                    "fixpoint.step_stamped",
                    lambda c=cap, m=smem: stamped(kernels.fixpoint, c,
                                                  smem=m),
                    lambda c=cap: step_plain(c), ("s", cap)))
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
                    cases.append((
                        "wac1.step",
                        lambda c=cap, i=inner, m=smem: kernels.wac1.step(
                            kp, lb, ub, c, i, strat, smem=m),
                        lambda c=cap, i=inner: step_plain(c, i),
                        ("ws", cap, inner)))
                    cases.append((
                        "wac1.step_stamped",
                        lambda c=cap, i=inner, m=smem: stamped(
                            kernels.wac1, c, i, smem=m),
                        lambda c=cap, i=inner: step_plain(c, i),
                        ("ws", cap, inner)))
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
        # K8 and its step entry on the global-memory path, for the
        # medians of both paths on this store.
        for name, fn in (("wac1", lambda: kernels.wac1(kp, lb, ub, 10000, 16,
                                                       smem=False)),
                         ("wac1.step", lambda: kernels.wac1.step(
                             kp, lb, ub, 10000, 16, strat, smem=False))):
            times[label, name + " (global)"] = (median_ms(fn),)
        log(f"  {label}: K8 ms on the shared- / global-memory path: "
            f"{times[label, 'wac1'][0]:.4f} / "
            f"{times[label, 'wac1 (global)'][0]:.4f}; its step entry "
            f"{times[label, 'wac1.step'][0]:.4f} / "
            f"{times[label, 'wac1.step (global)'][0]:.4f}")
        n_bot = int(pk.is_bot(fl, fu).sum())
        n_ent = int(pk.all_entailed(fl, fu).sum())
        log(f"  {label}: D={D} V={s.dp.V} P={s.dp.P} lin_fit32="
            f"{[b.fit32 for b in s.dp.lin]} bot lanes={n_bot} "
            f"entailed lanes={n_ent}: fixpoint (4 entries)/classify/select/"
            f"wac1 (2 entries) exact; sweeps over all lanes: AC-1 "
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
    terms = sum(b.coef.numel() for b in dp.lin)
    cls_ops = D * (10 * dp.P + 4 * terms + dp.V)
    sel_ops = 6 * D * sum(int(t.numel()) for t in dp.strat_ids)
    # K1's step entry: K1's bytes and operations, then K2's and K3's on
    # the store in shared memory: the cursors read, bot, ent, found and
    # seven int32 outputs written (35 bytes a dive), and the tables the
    # epilogue alone reads (its own bound).
    epi_bytes = sum(kp.tensors[n].numel() * kp.tensors[n].element_size()
                    for n in EPILOGUE_TABLES) + 35 * D
    epi_bound = bound(epi_bytes, cls_ops + sel_ops)
    blocks = {f"{k.name}{e}": k.blocks_per_sm(kp, e[1:])
              for k in (kernels.fixpoint, kernels.wac1)
              for e in ("", ".step", ".level", ".step_stamped")}
    for name in ("fixpoint.step", "wac1.step", "fixpoint.level",
                 "wac1.level", "fixpoint.step_stamped", "wac1.step_stamped"):
        ROW_EXTRA[name] = {"epilogue_bound_ms": epi_bound[0],
                           "epilogue_bound_by": epi_bound[1]}
    for name, b in blocks.items():
        ROW_EXTRA.setdefault(name, {})["blocks_per_sm"] = b
    log(f"  golomb(12), D={D}: K1's step entry "
        f"{times[g12, 'fixpoint.step'][0]:.4f} ms against K1 "
        f"{times[g12, 'fixpoint'][0]:.4f}, K2 "
        f"{times[g12, 'classify'][0]:.4f}, K3 {times[g12, 'select'][0]:.4f}"
        f"; the epilogue's own bound {epi_bound[0]:.5f} ms ({epi_bound[1]}"
        f", {epi_bytes} bytes); resident blocks per SM: K1 "
        f"{blocks['fixpoint']}, K1's step entry {blocks['fixpoint.step']}, "
        f"K1's level entry {blocks['fixpoint.level']}, K8 {blocks['wac1']}, "
        f"K8's step entry {blocks['wac1.step']}, K8's level entry "
        f"{blocks['wac1.level']}, the stamped step entries: K1's "
        f"{blocks['fixpoint.step_stamped']}, K8's "
        f"{blocks['wac1.step_stamped']}; "
        f"K8's step entry {times[g12, 'wac1.step'][0]:.4f} ms against K8 "
        f"{times[g12, 'wac1'][0]:.4f}; the stamped step entries against "
        f"the step entries: K1's {times[g12, 'fixpoint.step_stamped'][0]:.4f}"
        f" against {times[g12, 'fixpoint.step'][0]:.4f}, K8's "
        f"{times[g12, 'wac1.step_stamped'][0]:.4f} against "
        f"{times[g12, 'wac1.step'][0]:.4f}")
    bounds = {
        "fixpoint": bound(fp_bytes, sweeps[g12, "fixpoint"] * sweep_ops(dp)),
        "fixpoint.step": bound(
            fp_bytes + 35 * D, sweeps[g12, "fixpoint.step"] * sweep_ops(dp)
            + cls_ops + sel_ops),
        "fixpoint.transposed": bound(
            fp_bytes, sweeps[g12, "fixpoint.transposed"] * sweep_ops(dp)),
        "fixpoint.fixed_sweeps": bound(
            fp_bytes, sweeps[g12, "fixpoint.fixed_sweeps"] * sweep_ops(dp)),
        # One pass over every propagator per outer sweep: the inner
        # iterations beyond a group's first are not counted (the kernel
        # does not return them), so this stays a lower bound.
        "wac1": bound(fp_bytes, sweeps[g12, "wac1"] * sweep_ops(dp)),
        "wac1.step": bound(
            fp_bytes + 35 * D, sweeps[g12, "wac1.step"] * sweep_ops(dp)
            + cls_ops + sel_ops),
        # The step entries' work, and 16 bytes of stamps a dive.
        "fixpoint.step_stamped": bound(
            fp_bytes + 51 * D, sweeps[g12, "fixpoint.step_stamped"]
            * sweep_ops(dp) + cls_ops + sel_ops),
        "wac1.step_stamped": bound(
            fp_bytes + 51 * D, sweeps[g12, "wac1.step_stamped"]
            * sweep_ops(dp) + cls_ops + sel_ops),
        "classify": bound(planes + tabs + 2 * D, cls_ops),
        "select": bound(planes + 9 * 4 * D, sel_ops),
    }
    kres = {k: (errs[k],) + times["golomb(12)", k] + bounds[k] for k in errs}
    kres.update(phase_table_kernels(torch, dev, s, tnf, cls_ops + sel_ops))
    return kres


# The plan tables K2's and K3's bodies read (the step entry's epilogue).
EPILOGUE_TABLES = ("tnf4", "e_idx", "e_res", "e_len", "e_tab", "m_x", "m_b",
                   "m_base", "m_cnt", "l_head", "l_term", "l_rhs", "s_off",
                   "s_ids", "s_vo", "s_valo")
# Keys beyond the contract's that a kernel's row of the JSON line adds.
ROW_EXTRA = {}


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


def level_chunk(dev, text, mode, odd=False, D=512):
    """A solver of D lanes for ``text`` under fp_mode ``mode``, the
    inputs of its table build's widest level (the one with the most
    distinct parent rows; through the kernels) and the six arguments of
    its leaf level (``eps_table.table_leaf``'s), as the main path builds
    them: (solver, the ten inputs, the leaf's arguments). ``odd``: the
    plan keeps V unrounded (the planner rounds it up to a multiple of
    128), a V that is not a multiple of 4, whose rows the level and leaf
    entries load with the loop."""
    from unittest import mock
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.host.solver import plan as plan_mod
    from turbo_tpu_torch.solver import eps_table
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.engine import BatchedSolver
    rounded = plan_mod.quantize
    with mock.patch.object(plan_mod, "quantize", (
            lambda n, min_gran=32: n if min_gran == 128
            else rounded(n, min_gran)) if odd else rounded):
        s = BatchedSolver(compile_model(parse_fzn_text(text)),
                          EngineConfig(num_dives=D, fp_mode=mode),
                          device=dev)
    if (s.plan.V % 4 != 0) != odd or not s.use_table:
        fail(f"level chunk: V={s.plan.V}, table {s.use_table}")
    chunks, leaves = [], []
    level, leaf = eps_table.dive_level, eps_table.table_leaf
    with mock.patch.object(eps_table, "dive_level", lambda solver, *c: (
            chunks.append(c), level(solver, *c))[1]), mock.patch.object(
            eps_table, "table_leaf", lambda *a: (leaves.append(a),
                                                 leaf(*a))[1]):
        eps_table.build_table(s)
    if len(leaves) != 1:
        fail(f"level chunk: {len(leaves)} leaf levels in one build")
    return s, max(chunks, key=lambda c: len(set(c[8].tolist()))), leaves[0]


# Bytes written between two timed launches to evict their inputs and
# outputs from the H100's 50 MB L2.
L2_FLUSH_BYTES = 128 << 20


def profiled_ms(kernel, fn, reps, flush=None):
    """Mean device ms of the launches of ``kernel`` (a name prefix) over
    ``reps`` calls of ``fn`` under ``torch.profiler``; with ``flush`` (a
    card tensor) zeroed before each call, so that the launch starts with
    an L2 that holds none of its bytes. Fails when the profiler sees no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.key.startswith(kernel) and e.count:
            us = getattr(e, "device_time_total", 0) or getattr(
                e, "cuda_time_total", 0)
            if us:
                return us / e.count / 1e3
    fail(f"torch.profiler saw no device time of {kernel}")


def phase_table_leaf(torch, dev, leaves, g8):
    """K4's leaf entry against ``table_leaf_plain`` on the leaf levels of
    real builds (``leaves``: label -> (solver, the leaf's arguments)),
    exactly: 16-byte words where V % 4 == 0, 4-byte ones at an unrounded
    V. Times each: the kernel by ``torch.profiler``, the mean of 20
    launches with L2 flushed before each (the row's ms), back to back
    (warm), and inside 5 table builds of its solver (in the path); the
    wrapper with its upload and the plain version by CUDA events.
    Returns the kres row of ``g8``, the proofs cells' table (golomb(8),
    D = 1024), and puts every shape's figures in ``ROW_EXTRA``."""
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.solver import eps_table
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    shapes, row = {}, None
    for label, (ls, a) in leaves.items():
        chunks, rows, lb0, ub0, n_pad, _ = a
        V, n_live = lb0.shape[0], len(rows)
        err = exact(f"table_leaf ({label})", kernels.table_leaf(*a),
                    eps_table.table_leaf_plain(*a))
        # A live row reads two parent rows; every row writes two, its
        # strat and its path; the root box, the row indices (16 bytes a
        # row) and the chunks' pointers are read once.
        b = bound(8 * V * (n_live + n_pad) + 8 * n_pad + 8 * V
                  + 16 * n_live + 64 * len(chunks), 0)
        ms = profiled_ms("table_leaf_kernel", lambda: kernels.table_leaf(*a),
                         20, flush)
        plain = median_ms(lambda: eps_table.table_leaf_plain(*a), reps=5)
        fig = {"n_pad": n_pad, "n_live": n_live, "V": V,
               "chunks": len(chunks), "vec": V % 4 == 0, "ms": ms,
               "plain_ms": plain, "bound_ms": b[0],
               "warm_ms": profiled_ms("table_leaf_kernel",
                                      lambda: kernels.table_leaf(*a), 20),
               "in_path_ms": profiled_ms(
                   "table_leaf_kernel", lambda: eps_table.build_table(ls),
                   5),
               "wrapper_ms": median_ms(lambda: kernels.table_leaf(*a))}
        shapes[label] = fig
        if label == g8:
            row = (err, ms, plain) + b
        log(f"  table_leaf, {label} ({n_pad} rows, {n_live} live, V={V}, "
            f"{len(chunks)} chunks): exact; ms {ms:.4f} with L2 flushed "
            f"(back to back {fig['warm_ms']:.4f}, in 5 table builds "
            f"{fig['in_path_ms']:.4f}; the wrapper with its upload "
            f"{fig['wrapper_ms']:.4f}; plain {plain:.4f}), bound "
            f"{b[0]:.5f} ({b[1]})")
    ROW_EXTRA.setdefault("table_leaf", {}).update(
        shape=g8, ms_by="torch.profiler, L2 flushed before each launch",
        shapes=shapes)
    return row


def phase_table_kernels(torch, dev, s, tnf, epi_ops):
    """The table build's kernels against their plain versions at
    golomb(12)'s shapes: K1's and K8's level entries (each on both memory
    paths, V = 2560 and an unrounded V that is not a multiple of 4, on
    the widest level of a real build at W = 512) against
    ``dive_level_plain``; K4's leaf entry on the leaf levels of the
    same builds (K1's) and of golomb(8)'s at D = 1024 against
    ``table_leaf_plain`` (``phase_table_leaf``); K4's refill (2048 table
    rows, D = 512) and K5 ((512, 10000) stacks) on random inputs.
    ``epi_ops``: K2's and K3's operations at W = 512."""
    import numpy as np
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.instances import golomb
    from turbo_tpu_torch.solver.engine import (steal_plan_plain,
                                               table_refill_plain)
    from turbo_tpu_torch.host.solver.plan import quantize
    from turbo_tpu_torch.solver.eps_table import _BIG_CAP, dive_level_plain
    rng = np.random.default_rng(42)
    plan, D, MAXD = s.plan, 512, 10000
    n_pad = quantize(1 << 11)  # golomb(12) at D=512 splits 2^11 ways
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                  device=dev)
    out, leaves = {}, {}
    for mode, k in (("fixpoint", kernels.fixpoint), ("wac1", kernels.wac1)):
        name = f"{k.name}.level"
        for odd in (False, True):
            ls, chunk, leaf = level_chunk(dev, golomb(12), mode, odd)
            if mode == "fixpoint":
                leaves[f"golomb(12) D=512, V={ls.plan.V}"] = (ls, leaf)
            kp, V, W = ls.kernels.kernel_plan, ls.plan.V, len(chunk[8])
            caps = (_BIG_CAP, ls.cfg.wac1_inner_cap) if mode == "wac1" \
                else (_BIG_CAP,)
            want = dive_level_plain(ls, *chunk)
            for smem in (True, False):
                err = exact(f"{name} (V={V}, smem={smem})", k.level(
                    kp, chunk, ls.dp.obj, *caps, smem=smem), want)
            if odd:
                continue
            ms = (graph_ms(lambda: k.level(kp, chunk, ls.dp.obj, *caps)),
                  median_ms(lambda: dive_level_plain(ls, *chunk), reps=3))
            one = median_ms(lambda: k.level(kp, chunk, ls.dp.obj, *caps))
            glob = graph_ms(lambda: k.level(kp, chunk, ls.dp.obj, *caps,
                                            smem=False))
            # The distinct parent rows read once, the rows and 11 words a
            # row written, the plan's tables; the sweeps this level
            # needed (outer sweeps under WAC1), then K2 and K3.
            parents = len(set(chunk[8].tolist()))
            sweeps = int(want[11].long().sum()) - W
            out[name] = (err,) + ms + bound(
                8 * V * (parents + W) + 44 * W + plan_bytes(kp),
                sweeps * sweep_ops(ls.dp) + epi_ops)
            log(f"  {name}, golomb(12) widest level (W={W}, {parents} "
                f"parent rows, {sweeps} sweeps): exact on both memory paths "
                f"at V={V} and at an unrounded V; ms {ms[0]:.4f} in a CUDA "
                f"graph ({one:.4f} a single launch; global-memory path "
                f"{glob:.4f}; plain {ms[1]:.4f}), bound {out[name][3]:.5f} "
                f"({out[name][4]})")
    g8 = "golomb(8) D=1024"
    ls, _, leaf = level_chunk(dev, golomb(8), "fixpoint", D=1024)
    leaves[g8] = (ls, leaf)
    out["table_leaf"] = phase_table_leaf(torch, dev, leaves, g8)
    tlb, tub = random_stores(plan, tnf, n_pad, rng, None)
    tab = (t(tlb), t(tub))
    idx = t(rng.integers(-3, n_pad + 3, D))
    refill = torch.as_tensor(rng.random(D) < 0.5, device=dev)
    planes = [t(a) for a in random_stores(plan, tnf, D, rng, None) * 2]
    mine = [p.clone() for p in planes]
    kernels.table_refill(*tab, idx, refill, *mine)
    table_refill_plain(*tab, idx, refill, *planes)
    err = exact("table_refill", mine, planes)
    # V - 1 words a row: rows off 16-byte boundaries, moved 4 bytes at a
    # time.
    odd = [a[:, :-1].contiguous() for a in tab + tuple(planes)]
    odd_mine = [a.clone() for a in odd[2:]]
    kernels.table_refill(*odd[:2], idx, refill, *odd_mine)
    table_refill_plain(*odd[:2], idx, refill, *odd[2:])
    exact("table_refill (V % 4 != 0)", odd_mine, odd[2:])
    # A refilled lane reads two table rows and writes four planes.
    n_refill = int(refill.sum())
    out["table_refill"] = (err,) + (
        graph_ms(lambda: kernels.table_refill(*tab, idx, refill, *mine)),
        median_ms(lambda: table_refill_plain(*tab, idx, refill, *planes))
    ) + bound(n_refill * 6 * plan.V * 4 + 5 * D, 0)
    refill_one = median_ms(lambda: kernels.table_refill(*tab, idx, refill,
                                                        *mine))
    dec_cur = t(rng.integers(0, 2, (D, MAXD)))
    depth = t(rng.integers(0, MAXD + 1, D))
    phase = t(rng.integers(0, 3, D))
    splan = kernels.StealPlan(D, MAXD, dev)
    want = steal_plan_plain(dec_cur, depth, phase)
    err = exact("open_count",
                kernels.open_count(dec_cur, depth, phase, splan), want[0])
    exact("open_count plan", splan.steals(), want[1:])
    # The live prefixes of the SOLVE lanes' stacks, read once, and the
    # plan's three words a steal.
    live = int(depth.clamp(max=MAXD)[phase == 1].long().sum())
    out["open_count"] = (err,) + (
        median_ms(lambda: kernels.open_count(dec_cur, depth, phase, splan)),
        median_ms(lambda: steal_plan_plain(dec_cur, depth, phase))
    ) + bound(4 * live + 8 * D + 8 + 12 * len(want[1]), live)
    log(f"  golomb(12) shapes: D={D} V={plan.V} n_pad={n_pad} MAXD={MAXD}:"
        f" table_refill (V and V - 1)/open_count exact; ms table_refill "
        f"{out['table_refill'][1]:.4f} in a CUDA graph ({refill_one:.4f} a "
        f"single launch; plain {out['table_refill'][2]:.4f}, "
        f"bound {out['table_refill'][3]:.5f} for {n_refill} lanes), "
        f"open_count and its plan on random stacks ({len(want[1])} steals) "
        f"{out['open_count'][1]:.4f} (plain {out['open_count'][2]:.4f}, "
        f"bound {out['open_count'][3]:.5f}; the JSON line's row is phase "
        "8's)")
    return out


def clone_state(st):
    import dataclasses
    return dataclasses.replace(st, **{f.name: getattr(st, f.name).clone()
                                      for f in dataclasses.fields(st)})


def same_state(label, a, b, what="the plain step"):
    """Fails unless every SearchState field of a equals b's (``what``
    names b in the message); returns the max abs error (0)."""
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
            fail(f"{label}: {f.name} differs from {what} (max abs "
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
    step and step_tail and of each of their entries."""
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.instances import golomb, queens, random_model
    from turbo_tpu_torch.solver import step_cuda
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
        res = time_step_parts(torch, label, s, st, cap)[0]
        if out is None:  # the JSON line's K6 and K7: the step with K1
            out = res
        if s.cfg.fp_mode in ("fixpoint", "wac1") and step_cuda.fused(s.cfg):
            # K1's and K8's step entries against the propagation alone
            # with K2 and K3, and without the skip.
            fused_turns(torch, label, s, st0, cap)
            skip_turns(torch, label, s, st0, cap)
            for c in SPLIT_CAPS:
                head, post = split_check(torch, label, s, st0, c)
                if c == cap and s.cfg.fp_mode == "fixpoint":
                    timed = (head, post)
    # K6's timed entries: the work of head and post, their time the mean
    # of their own spans in 3b's profiled chunks (default step, cap 16).
    for e, ms in zip(("head", "post"), timed):
        row = out[f"step.{e}"]
        out[f"step.{e}_timed"] = (row[0], ms) + tuple(row[2:])
    return out


# How far profile_split's fraction (the launches' own spans and the clock
# stamps) may lie from the fraction of torch.profiler's kernel times of the
# same chunks with the same stamps (3b), as a share of what the stamps
# move there (the epilogue's share of the device time: the profiler's
# fraction with each step entry counted whole, less its fraction). Below
# 1, so that counting the step entries whole fails the check, which 3b
# checks too. A launch's own span misses its start-up and drain, which
# the profiler's kernel time holds.
SPLIT_TOL_SHARE = 0.5
# How far it may lie from the CUDA events' share at cap 16 (K1's fixpoint
# entry alone over the step, eager launches, ``time_step_parts``), which
# may not pass 1. At lower caps that share holds the host's gaps between
# short eager launches, and under ``fp_mode="wac1"`` K8's fixpoint entry
# is another kernel than its step entry's body, which it outran or
# trailed by up to a tenth on one state: printed, not held.
EVENT_TOL = 0.05
# 3b's cap, then the caps that the calibrator locks on the main path.
SPLIT_CAPS = (16, 8, 4)


def kernel_kind(name):
    """The kind (``profile_split.FIXPOINT``, ``OTHER``, ``STAMPED``) of a
    kernel in torch.profiler's trace by its name, as ``step_cuda`` tags
    the launch; None for a kernel that is not the step's."""
    from turbo_tpu_torch.solver.profile_split import FIXPOINT, OTHER, STAMPED
    name = re.sub(r"^void ", "", name)
    if "step_stamped_kernel" in name:
        return STAMPED
    if re.match(r"fixpoint_kernel\b|wac1_kernel<false", name):
        return FIXPOINT
    if re.match(r"(step_(head|post|live|copy)(_timed)?|classify|select)"
                r"_kernel\b", name):
        return OTHER
    return None


def split_check(torch, label, s, st, cap, steps=20):
    """On the state ``st`` of a step with K1's or K8's step entry, at fixpoint
    cap ``cap``: a profiled chunk (the stamped step entries and K6's timed
    entries, ``solver/step_cuda.py``) equals an uncaptured chunk of the
    step entries and the plain steps in every field and step count, every
    launch that ran wrote positive stamps (sweep > 0, epilogue > 0) and
    every timed launch a positive span; ``profile_split``'s fraction of
    two profiled chunks (as ``solve`` measures it) is printed; then two
    more run under ``torch.profiler``, and their fraction from the
    launches' own spans lies within ``SPLIT_TOL_SHARE`` of the
    epilogue's share of the device time from the fraction of the
    profiler's kernel times with the same stamps, while counting each
    step entry whole as FIXPOINT lies outside it. At cap 16 the CUDA
    events' share of the propagation alone in a step is printed, and
    with K1 it is at most 1 and the fraction lies within ``EVENT_TOL``
    of it. Returns the mean span (ms) of K6's timed head and post."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from turbo_tpu_torch.solver import profile_split, step_cuda
    D, dev = st.phase.shape[0], st.lb.device
    label = f"{label}, split at cap {cap}"
    a, b, c = clone_state(st), clone_state(st), clone_state(st)
    stamps = torch.zeros((steps, D, 2), dtype=torch.int64, device=dev)
    spans = step_cuda.Spans(steps, dev)
    ran_a = int(step_cuda.run(s, a, steps, cap, stamps=stamps, spans=spans))
    ran_b = int(step_cuda.run(s, b, steps, cap, graph=False))
    live = 0
    for _ in range(steps):
        c, lv = s.step_plain(c, cap)
        live += int(lv)
    if not ran_a == ran_b == live:
        fail(f"{label}: the profiled chunk ran {ran_a} steps, the step "
             f"entries {ran_b}, the plain step {live}")
    same_state(f"{label}, profiled chunk vs step entries", a, b)
    same_state(f"{label}, profiled chunk vs plain step", a, c)
    sweep, epi = stamps[..., 0], stamps[..., 1]
    on = (stamps != 0).any(dim=2).any(dim=1)  # the launches that ran
    durs = [e.dur for e in spans.events()]
    if (int(on.sum()) != ran_a or not bool((sweep[on] > 0).all())
            or not bool((epi[on] > 0).all())
            or min(durs[:3 * ran_a], default=1.0) <= 0):
        fail(f"{label}: stamps of {int(on.sum())} launches for {ran_a} "
             f"steps; sweep cycles min {int(sweep[on].min())}, epilogue "
             f"min {int(epi[on].min())}; spans min "
             f"{min(durs[:3 * ran_a], default=None)} ms")
    stamp_share = float(sweep[on].sum()) / float(stamps[on].sum())

    d = clone_state(st)
    got = []

    def chunk():
        nonlocal d
        d, _, measured = s._profiled_steps(d, steps, cap)
        got.append(measured)
        return measured

    t0 = time.monotonic()
    frac = profile_split.measure_fixpoint_fraction(chunk, cuda=True)
    wall = time.monotonic() - t0
    # Two more under torch.profiler: the port's spans and the profiler's
    # kernel times of the same launches, with the same stamps.
    del got[:]
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            chunk()
    prof_wall = time.monotonic() - t0
    cyc = tuple(sum(int(m[1][i]) for m in got) for i in (0, 1))
    port = [e for m in got for e in m[0]]
    kernels_ = [(e.name, e.time_range.elapsed_us() / 1e3)
                for e in prof.events() if e.device_type == DeviceType.CUDA]
    prof_ev = [profile_split.Event(kernel_kind(n), ms) for n, ms in kernels_
               if kernel_kind(n) is not None]
    prof_frac = profile_split.fraction(prof_ev, cyc)
    port_frac = profile_split.fraction(port, cyc)
    whole = profile_split.fraction(port, (1, 0))
    prof_whole = profile_split.fraction(prof_ev, (1, 0))
    if None in (frac, port_frac, prof_frac, prof_whole):
        fail(f"{label}: a fraction is None (solve's {frac}, spans "
             f"{port_frac}, profiler {prof_frac}, {prof_whole})")
    tol = SPLIT_TOL_SHARE * (prof_whole - prof_frac)
    by = {}
    for n, ms in kernels_:
        key = re.sub(r"\(.*", "", n)[:40]
        k, t = by.get(key, (0, 0.0))
        by[key] = (k + 1, t + ms)
    mean = {}
    for i, part in enumerate(("head", "step entry", "post")):
        xs = [e.dur for e in port[i::3]]
        mean[part] = sum(xs) / max(len(xs), 1)
    log(f"  {label}: a profiled chunk of {steps} equals the step entries "
        f"and the plain step; stamps and spans positive on all {ran_a} "
        f"launches, the sweeps' share of the cycles {stamp_share:.4f}; "
        f"profile_split's fraction {frac:.4f} ({wall:.3f} s for two "
        f"chunks); under torch.profiler ({prof_wall:.3f} s with its start) "
        f"the launches' spans read {port_frac:.4f} against the kernel "
        f"times' {prof_frac:.4f} (counted "
        f"whole {prof_whole:.4f}: tolerance {tol:.4f}), the step entries "
        f"counted whole {whole:.4f}; spans ms a launch: "
        + ", ".join(f"{k} {v:.4f}" for k, v in mean.items())
        + "; the profiler's kernels (launches, ms a launch): " + "; ".join(
            f"{k}: {n}, {t / n:.4f}" for k, (n, t) in
            sorted(by.items(), key=lambda kv: -kv[1][1])))
    if abs(port_frac - prof_frac) > tol:
        fail(f"{label}: the spans' fraction {port_frac:.4f} is not within "
             f"{tol:.4f} of torch.profiler's {prof_frac:.4f}")
    if abs(whole - prof_frac) <= tol:
        fail(f"{label}: the step entries counted whole as FIXPOINT "
             f"({whole:.4f}) also lie within {tol:.4f} of "
             f"torch.profiler's {prof_frac:.4f}: the check cannot see the "
             f"stamps")
    if cap == SPLIT_CAPS[0]:
        alone = time_step_parts(torch, f"{label}, propagation alone", s,
                                clone_state(st), cap, steps, alone=True)[1]
        fused = time_step_parts(torch, f"{label}, step entry", s,
                                clone_state(st), cap, steps)[1]
        ev_share = alone["propagation"] / sum(fused.values())
        log(f"  {label}: the CUDA events' share {ev_share:.4f} (the "
            f"propagation alone {alone['propagation']:.4f} ms over the "
            f"step's {sum(fused.values()):.4f} ms)")
        if s.cfg.fp_mode == "fixpoint" and (
                ev_share > 1 or abs(frac - ev_share) > EVENT_TOL):
            fail(f"{label}: the CUDA events' share {ev_share:.4f} is above "
                 f"1 or not within {EVENT_TOL} of profile_split's "
                 f"{frac:.4f}")
    return mean["head"], mean["post"]


def phase_sharded_step_kernels(torch, dev, single):
    """3d: the step over S EPS shards, lane groups of one state (K6 over
    every lane, the shard scan per shard), against the plain sharded step
    on the same CUDA state; then each kernel's time inside real
    golomb(12) steps at S x D=512, K6 + K7 against S=1 (``single``: 3b's
    entries). Returns the JSON entry of K6 and K7 over S shards."""
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
    res = time_step_parts(torch, *first)[0]
    k, k1 = res["step+step_tail"], single["step+step_tail"]
    log(f"  K6 + K7 per step, golomb(12), D=512 a shard: S={SHARDS} "
        f"{k[1]:.4f} ms (post {res['step.post'][1]:.4f}; plain {k[2]:.4f}, "
        f"bound {k[3]:.5f}), S=1 {k1[1]:.4f} ms (post "
        f"{single['step.post'][1]:.4f}; plain {k1[2]:.4f}, bound "
        f"{k1[3]:.5f})")
    return k


def skip_turns(torch, label, s, st, cap):
    """The step's time from the same state ``st`` with its propagation
    (K1, or K8 under ``wac1``) built without the skip and as built, in
    turns (on, off, off, on); and the propagation alone on the state's
    stores, by cap (K8 at inner cap 16): the first sweep against the
    later ones."""
    from turbo_tpu_torch import kernels
    kp = s.kernels.kernel_plan
    wac1 = s.cfg.fp_mode == "wac1"
    what = "K8" if wac1 else "K1"

    def alone(c):
        if wac1:
            return kernels.wac1(kp, st.lb, st.ub, c, s.cfg.wac1_inner_cap)
        return kernels.fixpoint(kp, st.lb, st.ub, c)

    for no_skip in (False, True, True, False):
        name = "without the skip" if no_skip else "as built"
        with skip_build(no_skip):
            time_step_parts(torch, f"{label}, {what} {name}", s,
                            clone_state(st), cap)
            ms = {c: median_ms(lambda c=c: alone(c)) for c in (1, 2, 4, 16)}
            log(f"    {what} alone ({name}), ms by cap: " + ", ".join(
                f"{c}: {t:.4f}" for c, t in ms.items()))


@contextlib.contextmanager
def skip_build(no_skip):
    """The wrappers launch from the build without K1's and K8's skip
    (their ``-Xptxas -v`` lines logged) when ``no_skip``, else as
    built."""
    from turbo_tpu_torch.kernels import build as kbuild
    if not no_skip:
        yield
        return
    with kbuild.without_skip():
        for what, kernel in (("K1", "fixpoint_kernel"),
                             ("K1's step entry", "fixpoint_step_kernel"),
                             *K8_KERNELS[:2]):
            log(f"  -DTT_NO_SKIP: {what} (-Xptxas -v): " + " | ".join(
                ptxas_lines(kbuild.build_log, kernel)))
        yield


def time_step_parts(torch, label, s, st, cap, steps=20, alone=False):
    """Each kernel entry's time inside one chunk of ``steps`` real steps
    of ``st``, launched as ``solver/step_cuda.py`` launches them (K7
    live, per step K6 head, K1's step entry or the propagation, K2 and
    K3, K6 post, then K7 copy; ``alone``: K1's or K8's fixpoint entry,
    K2 and K3 as launches of their own in place of the step entry):
    CUDA events between the launches, all enqueued before one
    synchronize (so the card does not wait on the host between them);
    and the plain step's parts (``step_pre_plain``, ``step_post_plain``,
    ``shard_scan_plain``, ``lane_copy_plain``) on a copy of the same
    state, whose lane masks give the rows each step moves for the
    bounds. The propagation launch is the configuration's (K1, one of
    its entries with the ``vd`` copies, or K8). Returns the kres entries
    (max abs err, ms, plain ms, bound ms, bound by) of K6 and K7 per
    step and of each entry per launch, and the ms per step of each launch
    of the step by name."""
    import dataclasses
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.solver import step_cuda
    dev = st.lb.device
    ws, kp = s._ws, s.kernels.kernel_plan
    sv = step_cuda.view(s, st, ws)
    plain_st = clone_state(st)
    fused = step_cuda.fused(s.cfg) and not alone
    entry = "wac1.step" if s.cfg.fp_mode == "wac1" else "fixpoint.step"
    names = (("step.head", entry, "step.post") if fused else
             ("step.head", "propagation", "classify", "select", "step.post"))

    def propagate(cur):
        out = (st.lb, st.ub, ws.iters, ws.unconv, ws.fp_scratch)
        if alone and s.cfg.fp_mode == "wac1":  # K8's fixpoint entry
            kernels.wac1(kp, st.lb, st.ub, cap, s.cfg.wac1_inner_cap,
                         live=cur, out=out)
        elif alone and step_cuda.fused(s.cfg):  # K1's fixpoint entry
            kernels.fixpoint(kp, st.lb, st.ub, cap, live=cur, out=out)
        else:
            step_cuda.propagate(s, st, cap, cur)

    def event():
        return torch.cuda.Event(enable_timing=True)

    ev = [[event() for _ in range(len(names) + 1)] for _ in range(steps)]
    ends = [event() for _ in range(4)]
    nodes0, fpit0 = int(st.nodes.long().sum()), int(st.fpit.long().sum())
    ends[0].record()
    kernels.step_tail.live(sv, ws.live[0], dev)
    ends[1].record()
    prev = None
    for i in range(steps):
        cur, nxt = ws.live[i % 2], ws.live[1 - i % 2]
        parts = [lambda: kernels.step.head(sv, prev, cur, dev),
                 lambda: propagate(cur)]
        if not fused:
            parts += [lambda: kernels.classify(kp, st.lb, st.ub, live=cur,
                                               out=(ws.bot, ws.ent)),
                      lambda: kernels.select(kp, st.lb, st.ub, ws.strat0,
                                             live=cur, out=ws.sel)]
        parts.append(lambda: kernels.step.post(sv, cur, nxt, dev,
                                               kp.smem_limit))
        ev[i][0].record()
        for j, part in enumerate(parts):
            part()
            ev[i][j + 1].record()
        prev = cur
    ends[2].record()
    kernels.step_tail.copy(sv, prev, dev)
    ends[3].record()
    torch.cuda.synchronize()
    acc = {n: sum(ev[i][j].elapsed_time(ev[i][j + 1])
                  for i in range(steps)) / steps
           for j, n in enumerate(names)}
    acc["step_tail.live"] = ends[0].elapsed_time(ends[1])
    acc["step_tail.copy"] = ends[2].elapsed_time(ends[3])
    plain = dict.fromkeys(("pre", "post", "scan", "copy"), 0.0)
    # The row work of each step, from the plain step's lane masks.
    keys = ("no_split", "snap", "solve_br", "impr", "restore", "t",
            "refill", "ring")
    work = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in keys}
    G = st.phase.shape[0] // s.cfg.num_dives
    for _ in range(steps):
        pe = [event() for _ in range(6)]
        p = plain_st
        pe[0].record()
        phase, strat0, ub = s.step_pre_plain(p)
        pe[1].record()
        lb, ub, iters, unconv = s.propagate(p.lb, ub, cap)
        bot, ent = s.kernels.classify(lb, ub)
        sel = s._select(lb, ub, strat0)
        pe[2].record()
        w = {}
        new, flags = s.step_post_plain(p, phase, strat0, lb, ub, iters,
                                       unconv, bot, ent, sel, w)
        pe[3].record()
        newidx, refill, ring_row = s.shard_scan_plain(p, new, *flags)
        pe[4].record()
        new = s.lane_copy_plain(p, new, flags[0], newidx, refill, ring_row)
        pe[5].record()
        w["refill"] = refill
        w["ring"] = (ring_row < G * s.cfg.sol_ring_size if ring_row
                     is not None else torch.zeros_like(refill))
        for k in keys:
            work[k] += w[k].long().sum()
        torch.cuda.synchronize()
        plain_st = dataclasses.replace(p, **new)
        for k, (a, b) in (("pre", (0, 1)), ("post", (2, 3)),
                          ("scan", (3, 4)), ("copy", (4, 5))):
            plain[k] += pe[a].elapsed_time(pe[b]) / steps
    plain_live = median_ms(lambda: ((st.phase != 2).any(),
                                    st.best_bound.min()))
    D, V, na = st.phase.shape[0], s.dp.V, s.dp.n_active  # every lane
    w = {k: int(v) / steps for k, v in work.items()}
    # Bytes per step, each input read once and each output written once.
    # The rows after a step (in the next head, or in K7 copy after the
    # chunk's last step): a table refill reads two table rows and writes
    # four planes, a table-off refill writes two (the root box read
    # once), a ring row is read and written; each lane's want and ridx.
    rows = (w["refill"] * (24 * V if s.use_table else 8 * V)
            + (0 if s.use_table or not w["refill"] else 8 * V)
            + w["ring"] * 8 * V + 5 * D)
    # Head: phase, strat, remaining, eps_strat, best_bound, ub[obj] read,
    # strat0 written (phase and ub[obj] where they change), bmin and
    # ext_bound once.
    head_b = rows + 28 * D + 8
    # Post: about 32 scalar words read and 22 written per lane; the
    # parent's stack entry and the child bound; a push writes 7 words;
    # the incumbent and snapshot rows (two planes read, two written); a
    # restore reads the two root rows and t decisions (4 words each) and
    # writes two planes; a no_split lane reads 2 n_active words; the
    # shard scan reads 5 words of each lane and writes 5.
    post_b = (D * (216 + 16) + w["solve_br"] * 28 + w["impr"] * 16 * V
              + w["snap"] * 16 * V + w["restore"] * 16 * V + w["t"] * 16
              + w["no_split"] * 8 * na + 40 * D)
    live_b = 8 * D + 12
    res = {"step.head": (0, acc["step.head"], plain["pre"] + plain["copy"])
           + bound(head_b, 20 * D),
           "step.post": (0, acc["step.post"], plain["post"] + plain["scan"])
           + bound(post_b, 130 * D),
           "step_tail.live": (0, acc["step_tail.live"], plain_live)
           + bound(live_b, 2 * D),
           "step_tail.copy": (0, acc["step_tail.copy"], plain["copy"])
           + bound(rows, 10 * D)}
    res["step"] = (0, acc["step.head"] + acc["step.post"],
                   plain["pre"] + plain["post"] + plain["scan"]
                   + plain["copy"]) + bound(head_b + post_b, 150 * D)
    res["step_tail"] = (0, (acc["step_tail.live"] + acc["step_tail.copy"])
                        / steps, (plain_live + plain["copy"]) / steps) + \
        bound((live_b + rows) / steps, 12 * D / steps)
    # K6 and K7 together per step (the shard scans run in the post).
    res["step+step_tail"] = (0, res["step"][1] + res["step_tail"][1],
                             res["step"][2] + res["step_tail"][2]) + bound(
        head_b + post_b + (live_b + rows) / steps, (150 + 12 / steps) * D)
    nodes = int(st.nodes.long().sum()) - nodes0
    fpit = int(st.fpit.long().sum()) - fpit0
    log(f"  {label}: D={D} V={V}, {steps} steps (per step: "
        + ", ".join(f"{v:.2f} {k}" for k, v in w.items())
        + f" lanes; {nodes / steps:.1f} nodes; {fpit / max(nodes, 1):.2f} "
        f"fixpoint_iterations per node), ms per step: "
        + ", ".join(f"{n} {acc[n]:.4f}" for n in names)
        + f"; per chunk: step_tail.live {acc['step_tail.live']:.4f}, "
        f"step_tail.copy {acc['step_tail.copy']:.4f}; plain parts: pre "
        f"{plain['pre']:.4f}, post {plain['post']:.4f}, scan "
        f"{plain['scan']:.4f}, copy {plain['copy']:.4f}, live "
        f"{plain_live:.4f}; bound ms "
        + ", ".join(f"{k} {v[3]:.5f} ({v[4]})" for k, v in res.items()))
    return res, {n: acc[n] for n in names}


def fused_turns(torch, label, s, st, cap):
    """K1's (K8's under ``wac1``) step entry against its fixpoint entry
    followed by K2 and K3 as launches of their own, each inside 20 real
    steps from the same state ``st``, in turns (step entry, alone, alone,
    step entry): the epilogue's cost in the step entry against the
    separate K2 + K3."""
    what = "K8" if s.cfg.fp_mode == "wac1" else "K1"
    entry = "wac1.step" if what == "K8" else "fixpoint.step"
    runs = []
    for alone in (False, True, True, False):
        name = f"{what}, K2, K3 alone" if alone else f"{what}'s step entry"
        runs.append(time_step_parts(torch, f"{label}, {name}", s,
                                    clone_state(st), cap, alone=alone)[1])
    step = [r[entry] for r in runs if entry in r]
    k1 = [r["propagation"] for r in runs if "propagation" in r]
    k23 = [r["classify"] + r["select"] for r in runs if "classify" in r]
    mean = lambda xs: sum(xs) / len(xs)
    log(f"  in turns (step entry, alone, alone, step entry), ms per step: "
        f"{what}'s step entry {', '.join(f'{x:.4f}' for x in step)}; "
        f"{what} alone {', '.join(f'{x:.4f}' for x in k1)}; K2 + K3 alone "
        f"{', '.join(f'{x:.4f}' for x in k23)}; the epilogue in the step "
        f"entry {mean(step) - mean(k1):.4f} against K2 + K3 "
        f"{mean(k23):.4f}")


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


# 3c: the most launches a step of a 16-step chunk may take, by whether
# K1's or K8's step entry classifies and selects (3.125 with K7 live and
# K7 copy once a chunk) or K2 and K3 run as launches of their own
# (5.125: ``fixed``, ``vd``).
MAX_LAUNCHES_PER_STEP = {True: 3.2, False: 5.2}


def phase_step_loop(torch, dev, label, kw, full=True, chunk=16, cap=16,
                    no_skip=False):
    """3c: the step loop on golomb(12), D=512, under the configuration
    ``kw``: no host sync inside a chunk (sync debug mode "error"),
    launches, wall and device time per step, for the kernels launched one
    by one and the same chunk replayed as a CUDA graph (the route
    ``run_steps`` takes once a chunk repeats); ``full``: the profile of
    both routes and the plain step too; ``no_skip``: the kernels from the
    build without the skip. Returns the graph route's wall ms per step."""
    with skip_build(no_skip):
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
        log(f"    {route}: {n} steps, {per / chunk:.3f} launches of the "
            f"port's kernels per step, wall {wall / n * 1e3:.3f} ms per step "
            f"(enqueue {enq / n * 1e3:.3f}); no host sync")
        # 3 launches a step (5 under "fixed" and "vd") and 2 a chunk
        # (solver/step_cuda.py).
        most = MAX_LAUNCHES_PER_STEP[step_cuda.fused(s.cfg)]
        if per / chunk > most:
            fail(f"{label}, {route}: {per / chunk:.3f} launches per step "
                 f"(at most {most})")
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
    # phases and the incumbents and writes three words.
    ws, D = s._ws, s.cfg.num_dives
    sv = step_cuda.view(s, st, ws)
    live_ms = median_ms(lambda: kernels.step_tail.live(sv, ws.live[0], dev))
    live_bound = bound(8 * D + 12, 2 * D)
    log(f"    K7 live (once per chunk): {live_ms:.4f} ms, bound "
        f"{live_bound[0]:.7f} ms ({live_bound[1]})")
    return out["CUDA graph"]


# Run as ``python -c LEVEL_TIMER [--cold] <CLI arguments>`` from the root
# of a checkout: the CLI of that checkout with each table level timed
# (each ``eps_table.dive_level`` call: its wall seconds up to a
# synchronize, and its device ms by CUDA events around it), and, where
# the checkout has it, the kernel warm-up's parts; both as a last line on
# stderr, with the host's time around the levels and the caching
# allocator's reserved bytes after each. ``--cold``: the warm-up does
# nothing (the first launches fall inside the table build, as before it
# existed).
LEVEL_TIMER = """
import json, sys, time
import torch
from turbo_tpu_torch import cli, kernels
from turbo_tpu_torch.solver import eps_table
levels, starts, reserved, builds, warm = [], [], [], [], {}
level, build = eps_table.dive_level, eps_table.build_table


def timed_level(solver, *chunk):
    t0 = time.monotonic()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    res = level(solver, *chunk)
    ev[1].record()
    torch.cuda.synchronize()
    levels.append((time.monotonic() - t0, ev[0].elapsed_time(ev[1])))
    starts.append(t0)
    reserved.append(torch.cuda.memory_reserved())
    return res


def timed_build(*a, **k):
    t0 = time.monotonic()
    res = build(*a, **k)
    builds.append((t0, time.monotonic()))
    return res


eps_table.dive_level = timed_level
eps_table.build_table = timed_build
cold = sys.argv[1:2] == ["--cold"]
if hasattr(kernels, "warm_up"):
    warm_up = kernels.warm_up

    def timed_warm_up(owner):
        parts = {} if cold else warm_up(owner)
        warm.update(parts)
        return parts
    kernels.warm_up = timed_warm_up
rc = cli.main(sys.argv[2 if cold else 1:])
# The host's time before the first level, between levels and after the
# last, in ms, and the caching allocator's reserved bytes after each level.
b0, b1 = builds[0] if builds else (0.0, 0.0)
ends = [t + w for t, (w, _) in zip(starts, levels)]
gaps = [1e3 * (a - b) for a, b in zip(starts + [b1], [b0] + ends)]
print("%levels " + json.dumps({"levels": levels, "warm_up": warm,
                               "host_gaps_ms": gaps, "reserved": reserved}),
      file=sys.stderr)
sys.exit(rc)
"""


def fresh_cli(tree, args, cold=False, timeout=600):
    """The CLI of checkout ``tree`` as a process of its own
    (``LEVEL_TIMER``) with the arguments ``args``: its statistics, status,
    objective, each table level's (wall s, device ms), the warm-up's
    parts and the process's wall seconds; fails if it fails."""
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", LEVEL_TIMER,
                        *(["--cold"] if cold else []), *args], cwd=tree,
                       capture_output=True, text=True, timeout=timeout)
    wall = time.monotonic() - t0
    if r.returncode != 0:
        fail(f"{tree}: the CLI {args} returned {r.returncode}: "
             f"{r.stderr[-2000:]}")
    stats = dict(re.findall(r"^%%%mzn-stat: (\w+)=(.*)$", r.stdout, re.M))
    timed = json.loads(re.findall(r"^%levels (.*)$", r.stderr, re.M)[-1])
    return {"status": status_of(r.stdout, True),
            "objective": int(stats["objective"]) if "objective" in stats
            else None, "init_time": float(stats["initTime"]),
            "table_build_time": float(stats.get("table_build_time", 0.0)),
            "solve_time": float(stats["solveTime"]),
            "nodes": int(stats["nodes"]), "process_s": wall, **timed}


def plain_engine(s):
    """Solver ``s`` with the plain versions in place of the kernels: the
    step is ``step_plain`` and the fixpoint, classify and select (also in
    the table build) are the plain torch functions. Returns ``s``."""
    import torch
    from turbo_tpu_torch.solver.eps_table import dive_level_plain
    pk = s.kernels
    pk.fixpoint, pk.classify = pk.fixpoint_plain, pk.classify_plain
    s._select = s._select_plain
    s._dive_level = lambda *chunk: dive_level_plain(s, *chunk)

    def run_steps(st, n, cap=0):
        count = torch.zeros((), dtype=torch.int32, device=st.lb.device)
        for _ in range(n):
            st, live = s.step_plain(st, cap)
            count += live.to(torch.int32)
        return st, count
    s.run_steps = run_steps
    # solve's measured chunks (profile_split) run the plain step too, and
    # time no kernel (the run keeps the least-squares fit).
    s._profiled_steps = lambda st, n, cap: run_steps(st, n, cap) + (
        ([], (0, 0)),)
    return s


# The table levels built in this process (``dive_level`` calls, kernels
# or plain), counted by ``count_table_levels``.
TABLE_LEVELS = [0]


def count_table_levels():
    """Counts every call of ``eps_table.dive_level`` (each solver's table
    build calls it once a level) in ``TABLE_LEVELS``."""
    from turbo_tpu_torch.solver import eps_table
    level = eps_table.dive_level

    def counted_level(solver, *chunk):
        TABLE_LEVELS[0] += 1
        return level(solver, *chunk)
    eps_table.dive_level = counted_level


def counted(label, fn, required=()):
    """Drive one path: every launch count (and the count of table levels,
    ``table levels``) is set to 0 just before ``fn`` and read just after;
    fails unless each kernel (or ``<kernel>.<entry>``) in ``required`` was
    launched. Returns the counts."""
    from turbo_tpu_torch import kernels
    kernels.reset_launches()
    TABLE_LEVELS[0] = 0
    fn()
    counts = kernels.launch_counts()
    counts["table levels"] = TABLE_LEVELS[0]
    log(f"  launches on {label}: " + ", ".join(f"{k} {n}"
                                               for k, n in counts.items()))
    missing = [k for k in required if counts[k] <= 0]
    if missing:
        fail(f"{label}: {missing} not launched on this path")
    return counts


def fused_only(label, c, prop="fixpoint"):
    """Fails unless every step of the path ran the step entry of K1 (K8
    with ``prop="wac1"``; its stamped form, beside K6's timed entries, in
    the run's profiled chunks), every table level was one launch of its
    level entry, and K2 and K3 never ran on their own. Returns ``c``."""
    steps = c["step.head"] + c["step.head_timed"]
    if (c[f"{prop}.step"] + c[f"{prop}.step_stamped"] != steps
            or c[f"{prop}.step_stamped"] != c["step.head_timed"]
            or c[f"{prop}.level"] != c["table levels"]
            or c["classify"] or c["select"]):
        fail(f"{label}: {prop}'s step entry {c[f'{prop}.step']} (stamped "
             f"{c[f'{prop}.step_stamped']}) for "
             f"{steps} steps ({c['step.head_timed']} timed), its level entry "
             f"{c[f'{prop}.level']} for {c['table levels']} table levels; "
             f"K2 {c['classify']}, K3 {c['select']}")
    return c


# The step's own kernels (K6, K7), the default step's (K2 and K3 run
# inside K1's step entry), and the default table build's (a level is one
# launch of K1's level entry, the leaf level one of K4's leaf entry; the
# refill seeds the first lanes).
STEP_OWN = ("step", "step_tail", "step.head", "step.post", "step_tail.live",
            "step_tail.copy")
STEP_KERNELS = ("fixpoint", "fixpoint.step") + STEP_OWN
# K6's timed entries, which a CLI run's profiled chunks launch.
PROFILED = ("step.head_timed", "step.post_timed")
TABLE_KERNELS = ("table_refill", "table_leaf", "fixpoint.level")


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
    all_kernels = step_kernels + table_kernels + ("open_count", "steal")
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

    log("[5c] golomb(8) proof, default CLI, in a fresh process")
    rec = fresh_cli(ROOT, [write_model("golomb8", golomb(8)), "-s"])
    if (rec["status"], rec["objective"]) != ("optimal", 34):
        fail(f"golomb(8) in a fresh process: {rec['status']} "
             f"{rec['objective']}")
    first, rest = rec["levels"][0], rec["levels"][1:]
    mid = len(rest) // 2
    log(f"  optimal 34: initTime {rec['init_time']:.3f} s (kernel warm-up "
        f"{sum(rec['warm_up'].values()):.4f} s: " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec["warm_up"].items())
        + f"), table_build_time {rec['table_build_time']:.3f} s, solveTime "
        f"{rec['solve_time']:.3f} s; {len(rec['levels'])} table levels, the "
        f"first {1e3 * first[0]:.3f} ms wall ({first[1]:.4f} ms device), the "
        f"others' median {1e3 * sorted(w for w, _ in rest)[mid]:.3f} ms wall "
        f"({sorted(d for _, d in rest)[mid]:.4f} ms device); the process "
        f"{rec['process_s']:.1f} s")

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
        split_line(MAIN, err)
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
        rounds = {k: [float(ms) for ms in re.findall(
            rf"^% {k} #.*\(([\d.]+) ms\)$", out, re.M)]
            for k in ("stack steal", "tail resplit")}
        idle = [int(i) / int(n) for i, n in re.findall(
            r"^% t=.* idle=(\d+)/(\d+) ", out, re.M)]
        log(f"  table_build_time {stats.get('table_build_time')} s; "
            f"{tbl.group(1) if tbl else 'no table line'}; calibration: "
            f"{cal or 'none'}; steal rounds {len(rounds['stack steal'])} "
            f"({sum(rounds['stack steal']):.3f} ms), resplit rounds "
            f"{len(rounds['tail resplit'])} "
            f"({sum(rounds['tail resplit']):.3f} ms), eps_redistributions "
            f"{stats.get('eps_redistributions')}; idle lanes "
            f"{100 * sum(idle) / max(1, len(idle)):.1f} % of the lanes "
            f"after a chunk, mean over {len(idle)} chunks")

    # The main path: the default CLI at full width, which builds the
    # table, refills from it, drains the range and reaches the steal gate.
    log(f"[6] golomb({big}), default CLI, -or 0, -t 60000")
    paths[MAIN] = fused_only(MAIN, counted(
        f"the default CLI, golomb({big})", golomb_big,
        required=all_kernels + PROFILED + ("fixpoint.step_stamped",)))

    tnf_big = compile_model(model)

    log(f"[7] table-off path: golomb({big}), D=512, solver API, 15 s")
    paths[f"table off, golomb({big})"] = fused_only("table off", counted(
        f"the table-off path, golomb({big})",
        api_run(dev, big, tnf_big, model, 15, use_table=False,
                fp_cap_auto=False),
        required=step_kernels))

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
        "the drain-forcing case, golomb(8)", drain,
        required=step_kernels + table_kernels + ("open_count",))
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
    table_kernels = TABLE_KERNELS
    # The step's kernels besides its propagation launch, where K2 and K3
    # run as launches of their own.
    rest = ("classify", "select") + STEP_OWN
    wac1_kernels = ("wac1", "wac1.step", "wac1.level", "table_refill",
                    "table_leaf")
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

    def cli_big(what, seconds, *opts, split=False):
        # ``split``: -v, and the run's measured split checked.
        def run():
            out, err, stats = run_cli([write_model(f"golomb{big}", text),
                                       "-s", "-or", "0", "-t",
                                       str(seconds * 1000), *opts,
                                       *(("-v",) if split else ())])
            if split:
                split_line(what, err)
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
    c = paths[WAC1] = fused_only(WAC1, counted(
        f"-fp wac1, golomb({big})", cli_big("-fp wac1", 30, "-fp", "wac1",
                                            split=True),
        required=wac1_kernels + STEP_OWN + PROFILED
        + ("wac1.step_stamped",)),
        prop="wac1")
    # K8 alone and K1 never: a level is one launch of K8's level entry.
    if c["fixpoint"] != 0 or c["wac1.wac1"] != 0:
        fail(f"-fp wac1: K8 alone {c['wac1.wac1']}, K1 {c['fixpoint']}")

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
        required=wac1_kernels + ("fixpoint", "classify") + STEP_OWN)

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
        required=STEP_KERNELS + table_kernels)
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
        MULTI_REFS["rate"] = rate(r)
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
            if name == "kernels":
                MULTI_REFS["golomb8"] = group_stats(ms, r)
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


def card_split(S, cards):
    """One card group a card: S shards over the devices ``cards``, in
    order, as even as they go."""
    base, extra = divmod(S, len(cards))
    return [[c] * (base + (i < extra)) for i, c in enumerate(cards)]


def distinct_cards(torch):
    """Every card of the call, or None (and a log line saying so) when
    there is one: the distinct-card runs of 3e and 12e need two."""
    n = torch.cuda.device_count()
    if n >= 2:
        return [torch.device("cuda", i) for i in range(n)]
    log(f"  distinct cards: not run: this call has {n} card "
        "(torch.cuda.device_count()); card groups on distinct cards need "
        "two or more, so peer access and the device switch stay unchecked "
        "here, and the groups above shared one card")
    return None


def group_stats(ms, r):
    """What 12e holds equal between engines: status, objective, nodes,
    failures, solutions, fixpoint iterations, the EPS statistics and
    the rebalance rounds."""
    return (r.status, r.objective, r.nodes, r.fails, r.solutions,
            r.fixpoint_iterations, r.eps_redistributions,
            r.eps_solved_subproblems, r.eps_skipped_subproblems,
            ms.rebalance_rounds)


def cards_equal(label, lane, ms, cap, graph):
    """Fails unless the card groups' kernel steps of ``ms`` equal the
    lane-group kernel steps of ``lane`` (the same shards as one state),
    every field of the global state after 1, 7 and 40 steps and three
    chunks of 8, with the same step counts. ``graph``: each group's step
    a CUDA graph (else eager launches)."""
    import torch
    from turbo_tpu_torch.solver import step_cuda
    dev = lane.device
    st_l, st_c = lane.init_state(), ms.init_state()

    def glob():
        return ms.global_state(st_c, device=dev)

    same_state(f"{label}, init", glob(), st_l, "the lane groups")
    done = 0
    for n in (1, 7, 40, 48, 56, 64):
        st_l, ran_l = lane.run_steps(st_l, n - done, cap)
        ran_c = step_cuda.run_groups(ms.solvers, st_c, ms._xc, n - done,
                                     cap, graph=graph)
        if int(ran_c) != int(ran_l):
            fail(f"{label}: the card groups counted {int(ran_c)} steps, "
                 f"the lane groups {int(ran_l)}")
        done = n
        same_state(f"{label}, after {n} steps", glob(), st_l,
                   "the lane groups")
    if graph and not all(s._ws.step_graphs for s in ms.solvers):
        fail(f"{label}: a group's step was not captured into a CUDA graph")
    st = ms.global_state(st_c)
    log(f"  {label}: every field equal to the lane-group kernel step after "
        f"1, 7, 40 steps and 3 chunks of 8 ({'CUDA graph a step' if graph else 'eager launches'}; "
        f"nodes {int(st.nodes.sum())}, solutions {int(st.sols.sum())}, "
        f"idle lanes {int((st.phase == 2).sum())}/{st.phase.shape[0]})")


def phase_card_groups_step(torch, dev, big=12, lanes=512):
    """3e: the card-group step (K10, then K6 head, K1's step entry and K6
    post on each group's stream, the streams waiting on each other's
    events) on a golomb(12) state at full width, S=4 x D=512, table on,
    cap 16, split into 2 x 2 and 4 x 1 groups on ``dev``, against the
    lane-group kernel step of the same shards; then K10 alone against its
    plain version on random slot words of both parities. Again with a
    group a card where the call has two cards. Returns the JSON entry of
    K10."""
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.instances import golomb
    from turbo_tpu_torch.parallel.mesh import ShardedSolver, xcard_plain
    from turbo_tpu_torch.solver.config import EngineConfig
    tnf = compile_model(parse_fzn_text(golomb(big)))
    cfg = EngineConfig(fp_cap_auto=False, num_dives=lanes)
    lane = ShardedSolver(tnf, cfg, devices=[dev] * SHARDS)
    groupings = [("2 x 2 groups on one card", [[dev] * 2] * 2, False),
                 ("4 x 1 groups on one card", [[dev]] * SHARDS, True)]
    cards = distinct_cards(torch)
    if cards is not None:
        groupings.append((f"a group a card on {len(cards)} cards",
                          card_split(SHARDS, cards), True))
    for label, devs, graph in groupings:
        ms = ShardedSolver(tnf, cfg, devices=devs)
        cards_equal(f"golomb({big}), S={SHARDS} x D={lanes}, {label}", lane,
                    ms, 16, graph)
        del ms
    # K10 alone against xcard_plain on random slot words.
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    err = 0
    for n in (1, 2, 4, 33, 64):
        for trial in range(4):
            slots = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, n, 2),
                                  dtype=torch.int32, device=dev,
                                  generator=gen)
            # Live words: 0 mostly (all 0 in the first trial), else any.
            slots[..., 1] *= (torch.rand((2, n), device=dev, generator=gen)
                              < (0.0 if trial == 0 else 0.3)).to(torch.int32)
            for par in (0, 1):
                live = torch.full((1,), -7, dtype=torch.int32, device=dev)
                bmin = torch.full((1,), -7, dtype=torch.int32, device=dev)
                kernels.xcard(slots, par, live, bmin)
                pl, pm = xcard_plain(slots, par)
                torch.cuda.synchronize()
                e = max(abs(int(live) - int(pl)), abs(int(bmin) - int(pm)))
                err = max(err, e)
                if e:
                    fail(f"K10 (xcard), N={n}, parity {par}: live "
                         f"{int(live)}, bmin {int(bmin)}; plain {int(pl)}, "
                         f"{int(pm)}")
    slots = torch.randint(0, 1 << 20, (2, SHARDS, 2), dtype=torch.int32,
                          device=dev, generator=gen)
    live = torch.zeros(1, dtype=torch.int32, device=dev)
    bmin = torch.zeros(1, dtype=torch.int32, device=dev)
    ms_k = graph_ms(lambda: kernels.xcard(slots, 1, live, bmin))
    ms_p = graph_ms(lambda: xcard_plain(slots, 1))
    # Each slot of one parity read once (two words), two words written.
    b = bound(4 * 2 * SHARDS + 4 * 2, 2 * SHARDS)
    MULTI_REFS["k10_ms"] = ms_k
    log(f"  K10 (xcard) equals xcard_plain on random slots of both "
        f"parities, N = 1, 2, 4, 33, 64 (max abs err {err}); at N={SHARDS}: "
        f"{ms_k:.5f} ms a launch (graph replay), plain {ms_p:.5f} ms, "
        f"bound {b[0]:.2e} ms ({b[1]})")
    return (err, ms_k, ms_p) + b


def run_card_paths(torch, dev, big=12):
    """Phase 12e: -arch multi as card groups (each group a state of its
    own with its own solver; K10's exchange each step). (a) golomb(8) at
    12d's configuration: the card-group kernels (2 x 2 and 4 x 1 groups
    on ``dev``) and the plain card-group engine (2 x 2) equal the
    lane-group kernel run of 12d; (b) golomb(big) at full width for 20 s
    as 4 x 1 groups on ``dev``, every improving solution checked, nodes/s
    beside 12a's lane groups, the host's enqueue us per step and each
    stream's busy share; the same with a group a card where the call has
    two cards, and -arch multi through the CLI. Returns the launch counts
    by label."""
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.host.solver.plan import auto_num_dives
    from turbo_tpu_torch.host.utils.output import print_solution
    from turbo_tpu_torch.instances import golomb
    from turbo_tpu_torch.parallel.mesh import ShardedSolver
    from turbo_tpu_torch.solver import step_cuda
    from turbo_tpu_torch.solver.config import EngineConfig
    paths = {}
    cards = distinct_cards(torch)
    t8 = compile_model(parse_fzn_text(golomb(8)))
    cfg8 = EngineConfig(fp_cap_auto=False, num_dives=8, subproblems_power=8)
    if "golomb8" not in MULTI_REFS:  # --cards-only: 12d's kernel run
        ms = ShardedSolver(t8, cfg8, devices=[dev] * SHARDS)
        MULTI_REFS["golomb8"] = group_stats(ms, ms.solve(fp_cap=16))
    ref = MULTI_REFS["golomb8"]

    def golomb8_cards(groupings):
        def run():
            for label, devs, plain in groupings:
                ms = ShardedSolver(t8, cfg8, devices=devs)
                if plain:
                    for s in ms.solvers:
                        plain_engine(s)
                    ms.run_steps = ms.run_steps_plain
                t0 = time.monotonic()
                got = group_stats(ms, ms.solve(fp_cap=16))
                log(f"  {label}: status/obj/nodes/fails/sols/fp_iters/"
                    f"redistributions/solved/skipped/rebalance rounds "
                    f"{got}, {time.monotonic() - t0:.1f} s")
                if got != ref:
                    fail(f"golomb(8) {label}: {got}, the lane-group kernel "
                         f"run {ref}")
        return run

    log(f"[12e] card groups: golomb(8), S={SHARDS} x D=8 over 2^8 "
        "subproblems, cap 16, the card-group kernels and the plain "
        "card-group engine against 12d's lane-group kernel run "
        f"{ref}; then golomb({big}) for 20 s as 4 x 1 groups on one card")
    required = STEP_KERNELS + TABLE_KERNELS + ("xcard",)
    paths["card groups, golomb(8), cap 16"] = counted(
        "card groups, golomb(8), cap 16", golomb8_cards([
            ("kernels, 2 x 2 groups on one card", [[dev] * 2] * 2, False),
            ("kernels, 4 x 1 groups on one card", [[dev]] * SHARDS, False),
            ("plain, 2 x 2 groups on one card", [[dev] * 2] * 2, True)]),
        required=required)

    text = golomb(big)
    model = parse_fzn_text(text)
    tnf = compile_model(model)
    D = auto_num_dives(tnf)
    held = {}

    def cards_big(devs, label):
        def run():
            ms = ShardedSolver(tnf, EngineConfig(num_dives=D), devices=devs)
            found = []
            r = ms.solve(timeout_s=20, on_improve=found.append)
            if r.best_lb is None:
                fail(f"{label}: no solution")
            for lb in found + [r.best_lb]:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    print_solution(tnf, lb)
                check_solution(model, buf.getvalue())
            rate = r.nodes / max(r.solve_time, 1e-9)
            lanes = MULTI_REFS.get("rate")
            k10 = MULTI_REFS.get("k10_ms")
            log(f"  {label}, S={SHARDS} x D={D}: {len(found)} improving "
                f"solution(s) and the best checked; objective "
                f"{r.objective}, nodes {r.nodes}, nodes/s {rate:.0f} (12a's "
                f"lane groups: "
                f"{'not run' if lanes is None else f'{lanes:.0f}'}; K10 "
                f"{'not timed' if k10 is None else f'{k10:.5f}'} ms a "
                "launch, 3e), "
                f"solveTime {r.solve_time:.3f} s, auto cap "
                f"{ms.solver.last_auto_cap}, rebalance rounds "
                f"{ms.rebalance_rounds}, eps_redistributions "
                f"{r.eps_redistributions}")
            held["ms"] = ms
        return run

    def measure(label):
        """The host's enqueue time per step and each group's stream busy
        share, over chunks of 16 steps of a fresh state at cap 16."""
        ms = held.pop("ms")
        st = ms.init_state()
        ms.run_steps(st, 16, 16)  # the step graphs, captured
        ms.sync()
        enq, shares = [], [[] for _ in ms.groups]
        for _ in range(5):
            busy = [[] for _ in ms.groups]
            t0 = time.perf_counter()
            step_cuda.run_groups(ms.solvers, st, ms._xc, 16, 16, busy=busy)
            t1 = time.perf_counter()
            ms.sync()
            wall = time.perf_counter() - t0
            enq.append((t1 - t0) / 16 * 1e6)
            for g, pairs in enumerate(busy):
                shares[g].append(sum(a.elapsed_time(b) for a, b in pairs)
                                 / 1e3 / wall)
        log(f"  {label}: host enqueue {min(enq):.1f}-{max(enq):.1f} us a "
            f"step (chunks of 16, 5 chunks); each group's stream busy "
            "(its steps' event spans over the chunk's wall): " + ", ".join(
                f"group {g} {min(x):.3f}-{max(x):.3f}"
                for g, x in enumerate(shares)))

    label = f"golomb({big}), 4 x 1 groups on one card"
    paths[MULTI_CARDS] = counted(MULTI_CARDS, cards_big(
        [[dev]] * SHARDS, label), required=required)
    c = paths[MULTI_CARDS]
    if c["xcard"] != c["step.head"]:
        fail(f"{MULTI_CARDS}: K10 launched {c['xcard']} times for "
             f"{c['step.head']} group steps (one a step a group)")
    measure(label)
    if cards is None:
        return paths
    split = card_split(SHARDS, cards)
    paths["card groups on distinct cards, golomb(8), cap 16"] = counted(
        "card groups on distinct cards, golomb(8), cap 16", golomb8_cards([
            (f"kernels, a group a card on {len(cards)} cards", split,
             False)]), required=required)
    label = f"golomb({big}), a group a card on {len(cards)} cards"
    paths[f"{MULTI_CARDS}, distinct cards"] = counted(
        f"{MULTI_CARDS}, distinct cards", cards_big(split, label),
        required=required)
    measure(label)

    def cli_multi():
        out, err, stats = run_cli([write_model(f"golomb{big}", text), "-s",
                                   "-arch", "multi", "-t", "20000", "-i",
                                   "-v"])
        blocks = out.split("----------\n")[:-1]
        if not blocks:
            fail(f"-arch multi CLI on {len(cards)} cards: no solution")
        for blk in blocks:
            check_solution(model, "\n".join(
                ln for ln in blk.splitlines() if not ln.startswith("%")))
        log(f"  CLI -arch multi on {len(cards)} cards: "
            f"{re.findall(r'^% D=.*$', err, re.M)}; objective "
            f"{stats.get('objective')}, nodes {stats.get('nodes')}, "
            f"solveTime {stats.get('solveTime')}; {len(blocks)} "
            "checker-valid solutions")

    paths["-arch multi CLI, distinct cards"] = counted(
        "-arch multi CLI, distinct cards", cli_multi, required=required)
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


# The JSON rows of K5 and K9 (name -> (max_abs_err, ms, plain_ms,
# bound_ms, bound_by)), from phase 8's steal round.
STEAL_ROWS = {}


def steal_round_trip(torch, dev, big, tnf):
    """Phase 8's steal round on a golomb(big) table-mode state (D=512,
    30 steps at cap 4, then every other lane made IDLE): the state's old
    host round trip, timed; the round on the card (K5's count and plan,
    one host read, K9) against the host steal on a host copy and against
    the plain torch versions on a card copy, every field and plane
    exactly, its wall time, the StepView unchanged (the chunk's CUDA graph
    stays valid: after a second round its key is still captured); K5 and
    K9 by CUDA events (median of 15, K9 on a fresh copy each time)
    against their plain versions, with their bounds. Fills
    ``STEAL_ROWS``."""
    import numpy as np
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.solver import step_cuda
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.convert import (search_state_from_numpy,
                                                search_state_to_numpy)
    from turbo_tpu_torch.solver.engine import (IDLE, SOLVE, STEAL_FIELDS,
                                               BatchedSolver,
                                               steal_apply_plain, steal_host,
                                               steal_plan_plain)
    s = BatchedSolver(tnf, EngineConfig(num_dives=512), device=dev)
    st, _ = s.run_steps(s.init_state(), 30, 4)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fields = search_state_to_numpy(st)
    search_state_from_numpy(fields, dev)
    torch.cuda.synchronize()
    rt_s = time.monotonic() - t0
    fields["phase"][::2] = IDLE  # half the lanes as thieves
    phase = fields["phase"]
    base = search_state_from_numpy(fields, dev)
    host = {k: v.copy() for k, v in fields.items()}
    n = steal_host(host, np.nonzero(phase == IDLE)[0])

    def same(label, got):
        exact(label, [getattr(got, k) for k in host],
              [torch.from_numpy(v).to(dev) for v in host.values()])

    # The round on the card, as solve() runs it.
    mine = clone_state(base)
    key = bytes(step_cuda.view(s, mine, s._ws))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = s._steal_open_branches(mine, phase)
    torch.cuda.synchronize()
    round_s = time.monotonic() - t0
    if res is None or res[0] is not mine or res[1] != n:
        fail(f"steal round on the card: {res and res[1]} steals, host {n}")
    if bytes(step_cuda.view(s, mine, s._ws)) != key:
        fail("the steal round changed the state's StepView")
    same("steal round (K5 + K9) vs the host steal", mine)
    plan = s._steal_plan
    want = steal_plan_plain(base.dec_cur, base.depth, base.phase)
    exact("open_count", kernels.open_count(base.dec_cur, base.depth,
                                           base.phase, plan), want[0])
    exact("open_count plan", plan.steals(), want[1:])
    plain = clone_state(base)
    steal_apply_plain(plain, *want[1:])
    same("plain torch steal vs the host steal", plain)

    # Times: K5 on the unchanged state; K9 and the round on a fresh copy.
    work = clone_state(base)

    def restore():
        for k in STEAL_FIELDS:
            getattr(work, k).copy_(getattr(base, k))

    def timed(fn, reps=15):
        times = []
        for _ in range(reps + 1):  # the first is a warm-up
            restore()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        times = sorted(times[1:])
        return times[len(times) // 2]

    walls = []
    for _ in range(15):
        restore()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        s._steal_open_branches(work, phase)
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    walls.sort()
    k5 = (median_ms(lambda: kernels.open_count(base.dec_cur, base.depth,
                                                base.phase, plan)),
          median_ms(lambda: steal_plan_plain(base.dec_cur, base.depth,
                                             base.phase)))
    k9 = (timed(lambda: kernels.steal(work, plan, n)),
          timed(lambda: steal_apply_plain(work, *want[1:])))
    # Bounds from this state: K5 reads the SOLVE lanes' live prefixes,
    # phase and depth, and writes the count and three words a steal; K9
    # per steal reads the victim's root rows, stack prefix and the cur
    # words above d0, and writes the thief's four store rows and stack
    # prefix, the victim's rope words above d0 and 11 scalars.
    MAXD, V = s.cfg.max_depth, s.dp.V
    dep = base.depth.clamp(max=MAXD).long()
    live = int(dep[base.phase == SOLVE].sum())
    d0 = want[2].long()
    above = int((dep[want[3].long()] - d0 - 1).clamp(min=0).sum())
    k9_bytes = 4 * (6 * V * n + 14 * int((d0 + 1).sum()) + 2 * above
                    + 11 * n)
    STEAL_ROWS["open_count"] = (0,) + k5 + bound(
        4 * live + 8 * len(phase) + 8 + 12 * n, live)
    STEAL_ROWS["steal"] = (0,) + k9 + bound(
        k9_bytes, int(2 * (d0 + 1).sum()) + above)
    nbytes = sum(a.nbytes for a in fields.values())
    log(f"  golomb({big}) table-mode state ({nbytes / 1e6:.1f} MB, MAXD "
        f"{MAXD}, {int((phase == SOLVE).sum())} SOLVE lanes after every "
        f"other lane was made IDLE): host round trip {rt_s:.3f} s; a steal "
        f"round on the card ({n} steals from "
        f"{int(plan.work[plan.N_VICT])} victims, {int(want[0])} open "
        f"branches, d0 up to {int(d0.max())}) equals the host steal and "
        f"the plain torch steal in every field; its wall "
        f"{round_s * 1e3:.3f} ms the first time, median of 15 "
        f"{walls[7]:.3f} ms (min {walls[0]:.3f}, max {walls[-1]:.3f}); the "
        "StepView unchanged")
    log(f"  K5 open_count + plan {k5[0]:.4f} ms (plain {k5[1]:.4f}, bound "
        f"{STEAL_ROWS['open_count'][3]:.5f}); K9 steal {k9[0]:.4f} ms "
        f"(plain {k9[1]:.4f}, bound {STEAL_ROWS['steal'][3]:.5f}, "
        f"{k9_bytes} bytes)")

    # A chunk captured on the state, every other lane made IDLE in place,
    # another round: the chunk's key is still among the captured graphs,
    # so the next chunk replays it.
    for _ in range(2):
        s.run_steps(mine, 16, 4)
    mine.phase[::2] = IDLE
    res = s._steal_open_branches(mine, mine.phase.cpu().numpy())
    if res is None:
        fail("no steal in the second round")
    if (16, 4, bytes(step_cuda.view(s, mine, s._ws))) not in s._ws.graphs:
        fail("after a steal round the chunk's CUDA graph would not replay")
    log(f"  a chunk captured as a CUDA graph, then a second round ({res[1]}"
        " steals): the chunk's key unchanged, its graph replays")


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
    count_table_levels()
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {kind}")
    shutil.rmtree(kbuild.BUILD_DIR, ignore_errors=True)
    from turbo_tpu_torch.solver.engine import heartbeat
    beats = io.StringIO()
    t0 = time.monotonic()
    # The solver's build heartbeat, every HEARTBEAT_S here (20 s in a
    # solver), its lines caught.
    with contextlib.redirect_stderr(beats), heartbeat(HEARTBEAT_S):
        kernels.load()
    log(f"[2] kernel build (cold, nvcc sm_90a): {time.monotonic() - t0:.1f} "
        f"s; heartbeat lines (every {HEARTBEAT_S:g} s):")
    for line in beats.getvalue().splitlines():
        log(f"    {line}")
    for line in kbuild.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"    {line.strip()}")

    if "--hosts-only" in sys.argv[1:]:
        run_hosts_paths(torch, dev)
        log("--hosts-only: stopping after phase 13")
        sys.exit(0)
    if "--cards-only" in sys.argv[1:]:
        log("[3e] the card-group step vs the lane-group kernel step, and "
            "K10 vs its plain version (exact)")
        phase_card_groups_step(torch, dev)
        run_card_paths(torch, dev)
        log("--cards-only: stopping after phases 3e and 12e")
        sys.exit(0)
    log("[3] kernels vs plain torch (exact)")
    kres = phase_kernels(torch, dev)
    log("[3b] K6 + K7 vs the plain step on the same CUDA state (exact)")
    kres.update(phase_step_kernels(torch, dev))
    log(f"[3d] the step over S={SHARDS} EPS shards (a scan per shard) vs the "
        "plain sharded step on the same CUDA state (exact)")
    kres["step.sharded"] = phase_sharded_step_kernels(torch, dev, kres)
    log("[3e] the card-group step vs the lane-group kernel step, and K10 "
        "vs its plain version (exact)")
    kres["xcard"] = phase_card_groups_step(torch, dev)
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
    paths.update(run_card_paths(torch, dev))
    for p in (MAIN, MULTI):  # one state on one card: no exchange
        if paths[p]["xcard"]:
            fail(f"{p}: K10 launched {paths[p]['xcard']} times")
    hosts_paths, allgather = run_hosts_paths(torch, dev)
    paths.update(hosts_paths)
    kres.update(STEAL_ROWS)
    log("[11] launches by path: " + "; ".join(
        f"{p}: " + ", ".join(f"{k} {n}" for k, n in c.items())
        for p, c in paths.items()))
    if "jax" in sys.modules or "turbo_tpu" in sys.modules:
        fail("jax or the turbo_tpu package was imported")
    # One entry per kernel, and one per entry point of K1 and K8 that replaces a
    # JAX function of its own. ``launches`` is read on the main path, or,
    # for a kernel the default search does not run, on its own path.
    # (name, kernel, replaces, path, launch-count key)
    # K2 and K3 run on their own only where the step has no step entry
    # (fp_mode fixed, the vd layout) and in the hybrid rounds.
    k1 = kernels.fixpoint
    own_path = {kernels.wac1: WAC1, kernels.classify: FIXED,
                kernels.select: FIXED, kernels.xcard: MULTI_CARDS}
    listed = [(k.name, k, k.replaces, own_path.get(k, MAIN), k.name)
              for k in kernels.KERNELS]
    listed += [(f"{k.name}.{e}", k, k.ENTRY_REPLACES[e], path,
                f"{k.name}.{e}")
               for k, e, path in ((k1, "step", MAIN), (k1, "level", MAIN),
                                  (k1, "fixed_sweeps", FIXED),
                                  (k1, "transposed", VD),
                                  (k1, "step_stamped", MAIN),
                                  (kernels.wac1, "step", WAC1),
                                  (kernels.wac1, "level", WAC1),
                                  (kernels.wac1, "step_stamped", WAC1))]
    # Each entry of K6 and K7 on its own.
    listed += [(f"{k.name}.{e}", k, k.replaces, MAIN, f"{k.name}.{e}")
               for k in (kernels.step, kernels.step_tail) for e in k.ENTRIES]
    # K6 and K7 over S shards stand in for the sharded step of the JAX
    # mesh (the shard scans run in K6 post); the launches are K6 post's
    # on the -arch multi path.
    step = kernels.step
    listed.append(("step.sharded", step, step.SHARDED_REPLACES, MULTI,
                   "step.post"))
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k.source,
         "replaces": replaces, "launches": paths[path][key], "path": path,
         "launches_by_path": {p: c[key] for p, c in paths.items()},
         "max_abs_err": kres[name][0], "ms": kres[name][1],
         "plain_ms": kres[name][2], "bound_ms": kres[name][3],
         "bound_by": kres[name][4], "library_ms": None,
         **ROW_EXTRA.get(name, {})}
        for name, k, replaces, path, key in listed], "main_path": MAIN,
        # Not a kernel: the -hosts exchange's transport (PERF.md row 18).
        "transports": [allgather]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
