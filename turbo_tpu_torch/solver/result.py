"""Result extraction for the batched engine: port of
``turbo_tpu/solver/result.py`` (``EngineResult.from_state``) with the
state read back by ``.cpu().numpy()``."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..host.core.ops import INF


@dataclasses.dataclass
class EngineResult:
    status: str                    # optimal | sat | unsat | unknown
    objective: Optional[int]       # original-objective value
    best_lb: Optional[np.ndarray]  # (V,) in TNF variable ids
    best_ub: Optional[np.ndarray]
    nodes: int = 0
    fails: int = 0
    solutions: int = 0
    fixpoint_iterations: int = 0
    num_deductions: float = 0.0
    depth_max: int = 0
    eps_num_subproblems: int = 0
    eps_solved_subproblems: int = 0
    eps_skipped_subproblems: int = 0
    eps_redistributions: int = 0
    exhaustive: bool = True
    solve_time: float = 0.0
    best_obj_time: float = 0.0
    init_time: float = 0.0
    # Per-phase timers (filled by solver.timers.PhaseTimers).
    num_blocks: int = 0
    num_blocks_done: int = 0
    variables: int = 0
    propagators: int = 0
    search_time: float = 0.0
    fixpoint_time: float = 0.0
    dive_time: float = 0.0
    transfer_cpu2gpu_time: float = 0.0
    transfer_gpu2cpu_time: float = 0.0
    select_fp_functions_time: float = 0.0
    wait_cpu_time: float = 0.0
    first_block_idle_time: float = 0.0
    cumulative_time_block_sec: float = 0.0
    deductions_per_block_second: float = 0.0
    # EPS table build wall time (solver/eps_table.py): inside dive_time
    # and the solve window, broken out in the statistics.
    table_build_time: float = 0.0
    # Solutions the ring overwrote before the host drained them (not
    # streamed through on_solution; the CLI warns and prints the count).
    sol_ring_overflow: int = 0

    @classmethod
    def unsat(cls, solver):
        return cls("unsat", None, None, None, exhaustive=True)

    @classmethod
    def from_state(cls, solver, st, stopped: bool, elapsed: float):
        (best_bound, has_best, best_lb, best_ub, nodes, fails, sols, fpit,
         deds, dmax, solved, skipped, nonexh, phase) = (
            x.cpu().numpy() for x in (
                st.best_bound, st.has_best, st.best_lb, st.best_ub,
                st.nodes, st.fails, st.sols, st.fpit, st.deds, st.dmax,
                st.solved_sub, st.skipped_sub, st.nonexh, st.phase))
        tnf = solver.tnf
        plan = solver.plan
        exhaustive = (not stopped) and (phase == 2).all() and not nonexh.any()
        res = cls(
            status="unknown", objective=None, best_lb=None, best_ub=None,
            nodes=int(nodes.sum()), fails=int(fails.sum()),
            solutions=int(sols.sum()), fixpoint_iterations=int(fpit.sum()),
            num_deductions=float(deds.sum()),
            depth_max=int(dmax.max(initial=0)),
            eps_num_subproblems=solver.num_sub_total,
            eps_solved_subproblems=int(solved.sum()),
            eps_skipped_subproblems=int(skipped.sum()),
            exhaustive=bool(exhaustive), solve_time=elapsed,
            num_blocks=len(phase), num_blocks_done=int((phase == 2).sum()),
            variables=tnf.num_vars - (int(plan.dropped.sum())
                                      if plan.dropped is not None else 0),
            propagators=plan.num_real_props)
        if not has_best.any():
            res.status = "unsat" if exhaustive else "unknown"
            return res
        if solver.opt:
            d = int(np.argmin(np.where(has_best, best_bound, INF + 1)))
        else:
            d = int(np.argmax(has_best))
        store_lb, store_ub = plan.store_to_tnf(best_lb[d], best_ub[d])
        res.best_lb, res.best_ub = store_lb, store_ub
        if solver.opt:
            if tnf.is_max:
                res.objective = int(store_ub[tnf.orig_obj_var])
            else:
                res.objective = int(store_lb[tnf.obj_var])
            res.status = "optimal" if exhaustive else "sat"
        else:
            res.status = "sat"
        return res
