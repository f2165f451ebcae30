"""turbo-tpu-torch command line entry point.

``python -m turbo_tpu_torch.cli model.fzn [flags]``: the flags of
``turbo_tpu.cli`` (the port's copy of ``parse_args``), the same solution
blocks, separators and ``%%%mzn-stat`` lines. ``-arch tpu|gpu|barebones``
run the batched engine on the CUDA card (``-platform cpu``: the plain
torch versions on the CPU) with the JAX CLI's defaults: the EPS
subproblem table and live fixpoint-cap calibration; ``-arch hybrid``
runs the host-owned search with batched propagation on the device
(``solver/hybrid.py``); ``-arch multi`` runs the EPS shards of
``parallel/mesh.py``, one per visible card as lane groups of one state
(one shard under ``-platform cpu``); ``-arch cpu`` runs the numpy
oracle. ``-fp wac1`` propagates with WAC1 (AC-1 below
``-wac1_threshold`` propagators).
``-hosts N -host_id i -coordinator HOST:PORT`` runs this process as
host i of a multi-host EPS run (``parallel/multihost.py``): one shard on
card i modulo the cards, the hosts joined over gloo, only host 0
printing.
``-a``, ``-i`` and ``-n N`` stream every accepted solution through the
on-device solution ring (``-arch hybrid``: each improving solution as it
is found). ``-checkpoint FILE`` resumes from FILE when it matches and
writes it when the run is cut. ``-v`` prints the setup (kernel build
and warm-up), the table, the cap and whether the FIXPOINT/SEARCH split
was measured (``solver/profile_split.py``), and ends the request with
its spans and counters (``trace.py``) as ``% trace`` lines; ``-v -v``
also the calibrator's choice, the steal and resplit rounds and a line
per chunk.
"""
from __future__ import annotations

import sys
import time

from . import trace
from .host.compile.model import compile_model
from .host.frontend.fzn import parse_fzn
from .host.utils.config import Configuration, parse_args
from .host.utils.output import (MznStats, print_final_separator,
                                print_mzn_statistics, print_solution)


def run(cfg: Configuration) -> int:
    """One request. Under ``-v`` it is traced (``trace.py``; unless the
    caller turned tracing on already) and ends with its ``% trace``
    lines on stderr."""
    turned_on = bool(cfg.verbose) and not trace.enabled()
    if turned_on:
        trace.enable()
    try:
        with trace.request():
            rc = _run(cfg)
        if cfg.verbose:
            trace.report(sys.stderr)
        return rc
    finally:
        if turned_on:
            trace.disable()


def _run(cfg: Configuration) -> int:
    if cfg.hosts > 1 and cfg.host_id != 0:
        # Only host 0 speaks on stdout; at the fd level, since native
        # code (gloo) writes straight to fd 1.
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), 1)
    device = None
    if cfg.arch != "cpu":
        import torch

        from .device import pick_device
        # One process a card: host h takes card h modulo the cards.
        device = pick_device(cfg.platform,
                             cfg.host_id if cfg.hosts > 1 else 0)
        hw = (torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu")
    else:
        hw = "cpu"
    stats = MznStats(cfg.print_statistics)
    with trace.span("parse") as sp_parse:
        stats.stat("command_line", f'"turbo-tpu-torch {cfg.problem_path}"')
        stats.stat("problem_path", f'"{cfg.problem_path}"')
        stats.stat("solver", '"turbo-tpu-torch"')
        from . import __version__
        stats.stat("version", f'"{cfg.version_tag or __version__}"')
        stats.stat("hardware", f'"{cfg.hardware or hw}"')
        stats.stat("arch", f'"{cfg.arch}"')
        stats.stat("fixpoint",
                   f'"{cfg.fixpoint if cfg.arch != "cpu" else "ac1"}"')
        if cfg.fixpoint == "wac1" and cfg.arch != "cpu":
            stats.stat("wac1_threshold", cfg.wac1_threshold)
        stats.stat("subproblems_factor", cfg.subproblems_factor)
        stats.stat("seed", cfg.seed)
        stats.stat("eps_var_order", f'"{cfg.eps_var_order}"')
        stats.stat("eps_value_order", f'"{cfg.eps_value_order}"')
        stats.stat("free_search", '"yes"' if cfg.free_search else '"no"')
        stats.stat("or_nodes", cfg.or_nodes)
        stats.stat("timeout_ms", cfg.timeout_ms)
        stats.stat("cutnodes", cfg.stop_after_n_nodes or 0)
        if cfg.problem_path.endswith(".xml"):
            from .host.frontend.xcsp3 import parse_xcsp3

            model = parse_xcsp3(cfg.problem_path)
        else:
            model = parse_fzn(cfg.problem_path)
        stats.stat("parsed_variables", len(model.vars))
        stats.stat("parsed_constraints", len(model.constraints))
    with trace.span("compile") as sp_compile:
        if cfg.free_search:
            model.solve.searches = []
        tnf = compile_model(model)
        stats.stat("variables", tnf.num_vars)
        stats.stat("propagators", tnf.num_props)
        if cfg.print_statistics and not cfg.disable_network_analysis:
            from .host.compile.analyze import print_analysis

            print_analysis(stats, model, tnf)
    init_time = sp_parse.s + sp_compile.s
    stats.stat("initTime", f"{init_time:.3f}")

    timeout_s = (cfg.timeout_ms / 1000.0 - init_time) if cfg.timeout_ms else 1e18
    timeout_s = max(timeout_s, 0.5)

    if cfg.arch == "cpu":
        return _run_oracle(cfg, stats, tnf, timeout_s, init_time)
    if cfg.hosts > 1:
        return _run_hosts(cfg, stats, tnf, timeout_s, init_time, device)

    from .host.solver.plan import auto_num_dives
    from .solver.config import EngineConfig
    from .solver.engine import BatchedSolver

    enumerate_all = tnf.obj_var < 0 and cfg.stop_after_n_solutions != 1
    num_dives = cfg.or_nodes or auto_num_dives(tnf)
    # Per-solution streaming (-a / -i / -n N) on the batched engine: size
    # the on-device ring; the solve loop drains it every chunk. The
    # hybrid search reports each improving solution itself.
    hybrid = cfg.arch == "hybrid"
    want_stream = (cfg.print_intermediate or enumerate_all) and not hybrid
    ring = min(4 * num_dives, 8192) if want_stream else 0
    econf = EngineConfig(num_dives=num_dives,
                         subproblems_power=cfg.subproblems_power,
                         subproblems_factor=cfg.subproblems_factor,
                         max_depth=cfg.max_depth,
                         eps_var_order=cfg.eps_var_order,
                         eps_value_order=cfg.eps_value_order,
                         seed=cfg.seed,
                         enumerate_all=enumerate_all,
                         fp_mode=("wac1" if cfg.fixpoint == "wac1"
                                  else "fixpoint"),
                         wac1_threshold=cfg.wac1_threshold,
                         disable_simplify=cfg.disable_simplify,
                         shave=cfg.shave,
                         sol_ring_size=ring)
    # Plan, kernel build and warm-up count in initTime, outside the -t
    # window.
    with trace.span("init.solver") as sp_init:
        if hybrid:
            from .solver.hybrid import HybridSolver
            solver = engine = HybridSolver(tnf, econf, device=device)
        elif cfg.arch == "multi":
            from .parallel.mesh import ShardedSolver
            solver = ShardedSolver(tnf, econf, devices=(
                [device] if device.type == "cpu" else None))
            engine = solver.solver
        else:
            solver = engine = BatchedSolver(tnf, econf, device=device)
    setup = sp_init.s
    if cfg.verbose:
        # -arch multi: each card with its shards (a card group each).
        cards = "".join(f" {g.device}x{g.n_shards}"
                        for g in getattr(solver, "groups", ()))
        warm = sum(s.warm_time for s in getattr(solver, "solvers", [engine]))
        print(f"% D={num_dives} k={engine.k} MAXD={engine.cfg.max_depth} "
              f"device={device} shards={getattr(solver, 'n_shards', 1)}"
              f"{' cards:' + cards if cards else ''} "
              f"setup={setup:.2f}s (kernel build {engine.build_time:.2f}s, "
              f"warm-up {warm:.3f}s)", file=sys.stderr)
    printed_last = [None]

    def on_solution(lb_tnf):
        printed_last[0] = list(lb_tnf)
        print_solution(tnf, lb_tnf)
    extra = {}
    if want_stream:
        extra["on_solution"] = on_solution
    elif cfg.print_intermediate or enumerate_all:
        extra["on_improve"] = on_solution
    if cfg.checkpoint_path:
        extra["checkpoint_path"] = cfg.checkpoint_path
    r = solver.solve(timeout_s=timeout_s,
                     stop_after_n_solutions=cfg.stop_after_n_solutions,
                     node_limit=cfg.stop_after_n_nodes,
                     verbose=cfg.verbose >= 2, **extra)
    with trace.span("output"):
        r.init_time = round(init_time + setup, 3)
        if cfg.verbose and not hybrid:
            tb = engine._table
            print("% eps table: "
                  + (f"n_live={tb.n_live} of {engine.num_sub_total}"
                     f" subproblems, n_pad={tb.n_pad}"
                     if tb is not None else "off")
                  + f"; fp_cap={engine.last_auto_cap or 'not calibrated'}",
                  file=sys.stderr)
            # (measured fraction or None, profile s, least-squares
            # fraction)
            split = getattr(solver, "last_split", None)
            if split is None:
                line = "least-squares fit (no measured chunks)"
            else:
                frac, wall, fit = split
                fit = "n/a" if fit is None else f"{fit:.4f}"
                line = (f"least-squares fit {fit} (profile {wall:.3f} s "
                        "measured nothing)" if frac is None else
                        f"measured, fixpoint fraction {frac:.4f} (profile "
                        f"{wall:.3f} s; least-squares fit {fit})")
            print(f"% timer split: {line}", file=sys.stderr)
        # Final block, unless the stream printed this very store last;
        # under enumeration a stream that lost nothing printed every
        # solution.
        stream_complete = (enumerate_all and want_stream
                           and printed_last[0] is not None
                           and r.sol_ring_overflow == 0)
        if (r.best_lb is not None and printed_last[0] != list(r.best_lb)
                and not stream_complete):
            print_solution(tnf, r.best_lb)
        print_final_separator(r.status, tnf.obj_var >= 0,
                              exhaustive=r.exhaustive)
        if r.sol_ring_overflow:
            stats.stat("sol_ring_overflow", r.sol_ring_overflow)
        print_mzn_statistics(stats, r)
    return 0


def _run_hosts(cfg, stats, tnf, timeout_s, init_time, device) -> int:
    """-hosts N: this process is host ``-host_id`` of a multi-host EPS
    run (``parallel/multihost.py``), one shard on its card (or on the CPU
    under ``-platform cpu``), joined over gloo at ``-coordinator``."""
    from .host.solver.plan import auto_num_dives
    from .parallel.multihost import (MultiHostSolver, init_distributed,
                                     shutdown_distributed)
    from .solver.config import EngineConfig

    if not cfg.coordinator:
        raise ValueError("-hosts > 1 requires -coordinator HOST:PORT "
                         "(or TURBO_TPU_COORDINATOR)")
    init_distributed(cfg.coordinator, cfg.hosts, cfg.host_id)
    if tnf.obj_var < 0 and cfg.stop_after_n_solutions != 1:
        raise ValueError("-a is not supported by the multi-host "
                         "architecture; run it on a single host")
    econf = EngineConfig(num_dives=cfg.or_nodes or auto_num_dives(tnf),
                         subproblems_power=cfg.subproblems_power,
                         subproblems_factor=cfg.subproblems_factor,
                         max_depth=cfg.max_depth,
                         eps_var_order=cfg.eps_var_order,
                         eps_value_order=cfg.eps_value_order,
                         seed=cfg.seed,
                         fp_mode=("wac1" if cfg.fixpoint == "wac1"
                                  else "fixpoint"),
                         wac1_threshold=cfg.wac1_threshold,
                         disable_simplify=cfg.disable_simplify,
                         shave=cfg.shave)
    tb = time.monotonic()
    solver = MultiHostSolver(tnf, econf, devices=[device])
    setup = time.monotonic() - tb
    engine = solver.sharded.solver
    if cfg.verbose:
        print(f"% host {cfg.host_id}/{cfg.hosts}: D={econf.num_dives} "
              f"k={engine.k} MAXD={engine.cfg.max_depth} device={device} "
              f"global shards {solver.host_shards.tolist()} setup="
              f"{setup:.2f}s (kernel build {engine.build_time:.2f}s)",
              file=sys.stderr)
    printed = [None]
    on_improve = None
    if cfg.print_intermediate:
        # The global improving solution rides the exchange; every host
        # prints it, and only host 0's stdout is live.
        def on_improve(lb_tnf):
            printed[0] = list(lb_tnf)
            print_solution(tnf, lb_tnf)
    r = solver.solve(timeout_s=timeout_s,
                     stop_after_n_solutions=cfg.stop_after_n_solutions,
                     verbose=cfg.verbose >= 2, on_improve=on_improve,
                     node_limit=cfg.stop_after_n_nodes or 0,
                     checkpoint_path=cfg.checkpoint_path or "")
    r.init_time = round(init_time + setup, 3)
    # Every host holds the same global result.
    if r.best_lb is not None and printed[0] != list(r.best_lb):
        print_solution(tnf, r.best_lb)
    print_final_separator(r.status, tnf.obj_var >= 0,
                          exhaustive=r.exhaustive)
    print_mzn_statistics(stats, r)
    sys.stdout.flush()
    shutdown_distributed()
    return 0


def _run_oracle(cfg, stats, tnf, timeout_s, init_time) -> int:
    """-arch cpu: the shared sequential numpy oracle."""
    import types

    from .host.solver import oracle

    printer = None
    if cfg.print_intermediate or not tnf.obj_var >= 0:
        def printer(blb, bub):
            print_solution(tnf, blb)
    r = oracle.solve(tnf, timeout_s=timeout_s,
                     stop_after_n_solutions=cfg.stop_after_n_solutions,
                     node_limit=cfg.stop_after_n_nodes or (1 << 62),
                     print_intermediate=printer)
    if r.best_lb is not None and printer is None:
        print_solution(tnf, r.best_lb)
    print_final_separator(r.status, tnf.obj_var >= 0,
                          exhaustive=r.stats.exhaustive)
    if cfg.print_statistics:
        s = r.stats
        print_mzn_statistics(stats, types.SimpleNamespace(
            nodes=s.nodes, fails=s.fails, depth_max=s.depth_max,
            init_time=round(init_time, 3), solve_time=s.solve_time,
            solutions=s.solutions, eps_num_subproblems=1,
            eps_solved_subproblems=1, eps_skipped_subproblems=0,
            fixpoint_iterations=s.fixpoint_iterations,
            num_deductions=s.num_deductions, num_blocks=1,
            num_blocks_done=int(s.exhaustive), variables=tnf.num_vars,
            propagators=tnf.num_props, search_time=s.search_time,
            fixpoint_time=s.fixpoint_time, dive_time=0.0,
            transfer_cpu2gpu_time=0.0, transfer_gpu2cpu_time=0.0,
            select_fp_functions_time=s.select_fp_functions_time,
            wait_cpu_time=0.0, first_block_idle_time=s.solve_time,
            cumulative_time_block_sec=s.solve_time,
            deductions_per_block_second=(s.num_deductions / s.solve_time
                                         if s.solve_time > 0 else 0.0),
            best_obj_time=s.best_obj_time, objective=r.objective))
    return 0


def main(argv=None) -> int:
    cfg = parse_args(argv)
    try:
        return run(cfg)
    except Exception as e:
        print(f"% ERROR: {e}", file=sys.stderr)
        raise


if __name__ == "__main__":
    sys.exit(main())
