#!/usr/bin/env python3
"""How many rules K1's skip leaves to run, per sweep, on search states.

``python scripts/k1_skip_stats.py [M] [LANES] [STEPS]`` (defaults 12, 8,
30) runs the port's plain engine on golomb(M) on the CPU for STEPS steps
at cap 16 (table off), then follows each of LANES lanes through the
sweeps of ``csrc/fixpoint.cu`` as ``tests/test_torch_kernels.py``
transliterates them, and prints per sweep: the rules that ran, the TNF
rules among them, and the warp-iterations of a 256-thread strided loop
over the TNF rules that hold at least one of them (what the skip alone
leaves busy; the kernel's worklist packs the TNF rules into dense
warps). Counts only: no time.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from test_torch_kernels import emulate_fixpoint, flat_tables  # noqa: E402
from turbo_tpu_torch.host.compile.model import compile_model  # noqa: E402
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text  # noqa: E402
from turbo_tpu_torch.instances import golomb  # noqa: E402
from turbo_tpu_torch.solver.config import EngineConfig  # noqa: E402
from turbo_tpu_torch.solver.engine import BatchedSolver  # noqa: E402

THREADS, CAP = 256, 16


def sweeps(t, lb, ub):
    """(rules run, TNF rules run, TNF warp-iterations busy) per sweep of
    one dive, to the fixpoint, bot or the cap."""
    trace = []
    emulate_fixpoint(t, lb, ub, CAP, trace=trace)
    out = []
    for *_, ran in trace:
        tnf = [j for j in ran if j < t["P"]]
        warps = {(j // THREADS, j % THREADS // 32) for j in tnf}
        out.append((len(ran), len(tnf), len(warps)))
    return out


def main():
    m, lanes, steps = (int(a) for a in (sys.argv[1:] + ["12", "8", "30"]
                                        [len(sys.argv) - 1:])[:3])
    s = BatchedSolver(compile_model(parse_fzn_text(golomb(m))),
                      EngineConfig(num_dives=lanes, use_table=False,
                                   fp_cap_auto=False), device="cpu")
    st, _ = s.run_steps(s.init_state(), steps, CAP)
    t = flat_tables(s)
    P = t["P"]
    n_warps = len({(j // THREADS, j % THREADS // 32) for j in range(P)})
    print(f"golomb({m}): {t['P']} TNF rules ({n_warps} warp-iterations), "
          f"{t['E'] + t['M'] + t['L']} rows; per lane and sweep: rules "
          f"run, TNF rules run, TNF warp-iterations busy")
    for d in range(lanes):
        print(d, sweeps(t, st.lb[d].tolist(), st.ub[d].tolist()))


if __name__ == "__main__":
    main()
