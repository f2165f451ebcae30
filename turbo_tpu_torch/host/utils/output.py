"""MiniZinc-protocol solution and statistics output.

Mirrors the reference's SolverOutput printing + mzn-stat emission
(statistics.hpp:232-412, common_solving.hpp:849-896): FlatZinc-level
`name = value;` / `array2d(...)` lines honoring ``output_var`` /
``output_array`` annotations, the `----------` solution separator, the
final status separators, and `%%%mzn-stat:` key=value lines.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from ..compile.tnf import Tnf


def _fmt_val(v: int, is_bool: bool) -> str:
    if is_bool:
        return "true" if v >= 1 else "false"
    return str(int(v))


def print_solution(tnf: Tnf, best_lb: np.ndarray, file=None):
    """Print one solution per the model's output annotations."""
    f = file or sys.stdout
    for item in tnf.outputs:
        if not item.is_array:
            v = best_lb[item.elems[0]]
            f.write(f"{item.name} = {_fmt_val(v, item.is_bool)};\n")
        else:
            vals = ", ".join(_fmt_val(best_lb[e], item.is_bool)
                             for e in item.elems)
            dims = item.dims or [(1, len(item.elems))]
            nd = len(dims)
            dimspec = ", ".join(f"{lo}..{hi}" for lo, hi in dims)
            f.write(f"{item.name} = array{nd}d({dimspec}, [{vals}]);\n")
    f.write("----------\n")
    f.flush()


def print_final_separator(status: str, is_opt: bool, exhaustive: bool = False,
                          file=None):
    """`==========` etc. (statistics.hpp:394-412): `==========` when
    solutions exist and the search was exhaustive."""
    f = file or sys.stdout
    if status == "optimal" or (status == "sat" and exhaustive):
        f.write("==========\n")
    elif status == "unsat":
        f.write("=====UNSATISFIABLE=====\n")
    elif status == "unknown":
        f.write("=====UNKNOWN=====\n")
    f.flush()


class MznStats:
    """%%%mzn-stat: printer (statistics.hpp:203-230)."""

    def __init__(self, enabled: bool, file=None):
        self.enabled = enabled
        self.f = file or sys.stdout

    def stat(self, key, value):
        if self.enabled:
            self.f.write(f"%%%mzn-stat: {key}={value}\n")

    def end(self):
        if self.enabled:
            self.f.write("%%%mzn-stat-end\n")
            self.f.flush()


def print_mzn_statistics(stats: MznStats, r, config=None):
    """Emit the reference's statistics block (statistics.hpp:338-371)."""
    if not stats.enabled:
        return
    def sec(x):
        return f"{x:.6f}"

    stats.stat("num_blocks", getattr(r, "num_blocks", 1))
    stats.stat("nodes", r.nodes)
    stats.stat("failures", r.fails)
    stats.stat("variables", getattr(r, "variables", 0))
    stats.stat("propagators", getattr(r, "propagators", 0))
    stats.stat("peakDepth", r.depth_max)
    stats.stat("initTime", getattr(r, "init_time", 0.0))
    stats.stat("solveTime", r.solve_time)
    stats.stat("num_solutions", r.solutions)
    stats.stat("eps_num_subproblems", r.eps_num_subproblems)
    stats.stat("eps_solved_subproblems", r.eps_solved_subproblems)
    stats.stat("eps_skipped_subproblems", r.eps_skipped_subproblems)
    stats.stat("eps_redistributions", getattr(r, "eps_redistributions", 0))
    stats.stat("num_blocks_done", getattr(r, "num_blocks_done", 0))
    stats.stat("fixpoint_iterations", r.fixpoint_iterations)
    stats.stat("num_deductions", int(r.num_deductions))
    # Timing statistics (statistics.hpp:355-371; block-averaged).
    stats.stat("cumulative_time_block_sec",
               sec(getattr(r, "cumulative_time_block_sec", 0.0)))
    stats.stat("deductions_per_block_second",
               sec(getattr(r, "deductions_per_block_second", 0.0)))
    nb = max(getattr(r, "num_blocks", 1), 1)
    stats.stat("solve_time", sec(r.solve_time / nb))
    stats.stat("search_time", sec(getattr(r, "search_time", 0.0)))
    stats.stat("fixpoint_time", sec(getattr(r, "fixpoint_time", 0.0)))
    stats.stat("transfer_cpu2gpu_time",
               sec(getattr(r, "transfer_cpu2gpu_time", 0.0)))
    stats.stat("transfer_gpu2cpu_time",
               sec(getattr(r, "transfer_gpu2cpu_time", 0.0)))
    stats.stat("select_fp_functions_time",
               sec(getattr(r, "select_fp_functions_time", 0.0)))
    stats.stat("wait_cpu_time", sec(getattr(r, "wait_cpu_time", 0.0)))
    stats.stat("dive_time", sec(getattr(r, "dive_time", 0.0)))
    if getattr(r, "table_build_time", 0.0) > 0.0:
        # Precomputed EPS dive-tree build (solver/eps_table.py):
        # included in dive_time and in the solve budget; broken out so
        # the absorption is observable (extension over the reference's
        # timer set, statistics.hpp:355-371).
        stats.stat("table_build_time", sec(r.table_build_time))
    stats.stat("best_obj_time", round(getattr(r, "best_obj_time", 0.0), 3))
    stats.stat("first_block_idle_time",
               sec(getattr(r, "first_block_idle_time", 0.0)))
    if r.objective is not None:
        stats.stat("objective", r.objective)
    stats.end()
