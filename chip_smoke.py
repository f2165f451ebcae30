#!/usr/bin/env python3
"""Smoke test of turbo_tpu_torch on one CUDA card: ``python3 chip_smoke.py``.

Run from the root of the repository (``--kernels-only`` stops after
phase 3). Phases (any failure exits non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. the kernel build with nvcc from a cold ``turbo_tpu_torch/kernels/_build``;
3. each kernel against its plain torch version on the same CUDA tensors
   (4 seeded random models at D=1024 with randomly narrowed stores and
   stores fixed at a solution, and golomb(12) at D=512): every output
   exactly equal (tolerance 0: all integer), with the median time of
   both (the golomb(12) times go into the JSON line);
4. the main path (``turbo_tpu_torch.cli.main``) on 6 small seeded models
   against the shared numpy oracle (status and objective equal) and
   against the port's engine on the CPU with the plain versions
   (nodes, failures, solutions and fixpoint iterations equal);
5. golomb(8) proven optimal at 34;
6. golomb(12) at full width (``-or 0``, ``-t 60000``): every printed
   solution checked against the model by ``utils/checker.py``;
7. the launch counts of the three kernels over phases 4-6 (each > 0).

It prints a JSON line of the kernels, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""
import contextlib
import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "chiprun_out" / "chip_smoke"


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
            f"nvidia-smi failed: {r.stderr.strip()}"
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


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
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.host.solver import oracle
    from turbo_tpu_torch.instances import golomb, random_model
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.engine import BatchedSolver

    errs = {k.name: 0 for k in kernels.KERNELS}
    times = {}
    # Exactness on 4 random models at D=1024; exactness and the reported
    # times at the main path's full-width shape, golomb(12) at D=512.
    models = [(f"random_model({100 + i})", random_model(100 + i, n_vars=10,
                                                        n_cons=40), 1024)
              for i in range(4)] + [("golomb(12)", golomb(12), 512)]
    for seed, (label, text, D) in enumerate(models):
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
            ("classify", lambda: kernels.classify(kp, lb, ub),
             lambda: pk.classify_plain(lb, ub)),
        ]
        fl, fu = pk.fixpoint_plain(lb, ub, 10000)[:2]
        for st_lb, st_ub in ((lb, ub), (fl, fu)):
            cases.append(("select",
                          lambda a=st_lb, b=st_ub: kernels.select(kp, a, b, strat),
                          lambda a=st_lb, b=st_ub: s._select_plain(a, b, strat)))
        timed = set()
        for name, kern, plain in cases:
            got, want = kern(), plain()
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
        n_bot = int(pk.is_bot(fl, fu).sum())
        n_ent = int(pk.all_entailed(fl, fu).sum())
        log(f"  {label}: D={D} V={s.dp.V} P={s.dp.P} lin_fit32="
            f"{[b.fit32 for b in s.dp.lin]} bot lanes={n_bot} "
            f"entailed lanes={n_ent}: fixpoint/classify/select exact; ms "
            + ", ".join(f"{k} {times[label, k][0]:.4f} (plain "
                        f"{times[label, k][1]:.4f})" for k in errs))
    return {k: (errs[k],) + times["golomb(12)", k] for k in errs}


def main():
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
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.host.solver import oracle
    from turbo_tpu_torch.host.utils.checker import Checker
    from turbo_tpu_torch.instances import GOLOMB_OPT, golomb, random_model
    from turbo_tpu_torch.kernels import build as kbuild

    dev = torch.device("cuda:0")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {kind}")
    shutil.rmtree(kbuild.BUILD_DIR, ignore_errors=True)
    WORK.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    kernels.load()
    log(f"[2] kernel build (cold, nvcc sm_90a): {time.monotonic() - t0:.1f} s")
    for line in kbuild.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"    {line.strip()}")

    log("[3] kernels vs plain torch (exact)")
    kres = phase_kernels(torch, dev)
    if "--kernels-only" in sys.argv[1:]:
        log("--kernels-only: stopping after phase 3")
        sys.exit(0)

    kernels.reset_launches()
    log("[4] main path vs oracle, and vs the port's CPU engine")
    from turbo_tpu_torch.solver.config import EngineConfig
    from turbo_tpu_torch.solver.engine import BatchedSolver
    for seed in range(6):
        text = random_model(200 + seed, n_vars=8, n_cons=24)
        tnf = compile_model(parse_fzn_text(text))
        ro = oracle.solve(tnf, timeout_s=120)
        out, _, stats = run_cli([write_model(f"rand{seed}", text), "-s",
                                 "-or", "64", "-sub", "6", "-t", "120000"])
        st = status_of(out, tnf.obj_var >= 0)
        obj = int(stats["objective"]) if "objective" in stats else None
        # The same configuration with the plain torch versions on the
        # CPU walks the same tree: the statistics must be equal.
        rc = BatchedSolver(tnf, EngineConfig(num_dives=64, subproblems_power=6),
                           device="cpu").solve()
        cpu = (rc.nodes, rc.fails, rc.solutions, rc.fixpoint_iterations)
        gpu = tuple(int(stats.get(k, -1)) for k in (
            "nodes", "failures", "num_solutions", "fixpoint_iterations"))
        log(f"  model {seed}: port {st} {obj}, oracle {ro.status} "
            f"{ro.objective}; nodes/fails/sols/fp_iters card {gpu} cpu {cpu}")
        if st != ro.status or obj != ro.objective:
            fail(f"model {seed}: port ({st}, {obj}) != oracle "
                 f"({ro.status}, {ro.objective})")
        if gpu != cpu:
            fail(f"model {seed}: card statistics {gpu} != CPU engine {cpu}")

    log("[5] golomb(8) proof")
    out, _, stats = run_cli([write_model("golomb8", golomb(8)), "-s"])
    if "==========" not in out or int(stats.get("objective", -1)) != 34:
        fail(f"golomb(8): expected optimal 34, got {stats.get('objective')}")
    log(f"  optimal 34: nodes {stats['nodes']}, solveTime "
        f"{float(stats['solveTime']):.3f} s, nodes/s "
        f"{int(stats['nodes']) / float(stats['solveTime']):.0f}, "
        f"num_blocks {stats['num_blocks']}")

    log("[6] golomb(12), -or 0, -t 60000")
    text = golomb(12)
    path = write_model("golomb12", text)
    out, err, stats = run_cli([path, "-s", "-or", "0", "-t", "60000", "-v"])
    blocks = [b for b in out.split("----------\n")[:-1]]
    if not blocks:
        fail("golomb(12): no solution printed")
    model = parse_fzn_text(text)
    for b in blocks:
        values = {k: int(v) for k, v in
                  re.findall(r"^(\w+) = (-?\d+);$", b, re.M)}
        ck = Checker(model, values)
        bad = [c.name for c in model.constraints if not ck.holds(c)]
        if bad:
            fail(f"golomb(12): printed solution violates {bad[:5]}")
    dk = re.search(r"% D=(\d+) k=(\d+)", err)
    nodes, solve_t = int(stats["nodes"]), float(stats["solveTime"])
    log(f"  {len(blocks)} solution(s) checked; objective "
        f"{stats.get('objective')} (optimum {GOLOMB_OPT[12]}); nodes {nodes}, "
        f"nodes/s {nodes / solve_t:.0f}, solveTime {solve_t:.3f} s, "
        f"fixpoint_iterations {stats['fixpoint_iterations']}, "
        f"D {dk.group(1) if dk else '?'}, k {dk.group(2) if dk else '?'}")

    log("[7] launches over phases 4-6: " + ", ".join(
        f"{k.name} {k.launches}" for k in kernels.KERNELS))
    for k in kernels.KERNELS:
        if k.launches <= 0:
            fail(f"kernel {k.name} was not launched on the main path")
    if "jax" in sys.modules or "turbo_tpu" in sys.modules:
        fail("jax or the turbo_tpu package was imported")
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": k.launches,
         "max_abs_err": kres[k.name][0], "ms": kres[k.name][1],
         "plain_ms": kres[k.name][2]} for k in kernels.KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
