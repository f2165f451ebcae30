#!/usr/bin/env python3
"""How many rules K8's skip leaves to run, per pass, on search states.

``python scripts/k8_skip_stats.py [M] [LANES] [STEPS]`` (defaults 12, 8,
12) runs the port's plain engine under ``fp_mode="wac1"`` on golomb(M)
on the CPU for STEPS steps at cap 16 and inner cap 16 (table off), then
follows each of LANES lanes through the passes of ``csrc/wac1.cu`` as
``tests/test_torch_kernels.py`` transliterates them, and prints per pass
(each op-group by its op, the element and membership rows, each linear
bucket) summed over the lanes: the times it ran, the times it was
skipped whole (its bit of ``pend`` clear), the rules it ran out of those
it held when it ran, and the share of the rules that running every rule
of every pass would run (the TT_NO_SKIP build). Counts only: no time.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from test_torch_kernels import emulate_wac1, flat_tables  # noqa: E402
from turbo_tpu_torch.host.compile.model import compile_model  # noqa: E402
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text  # noqa: E402
from turbo_tpu_torch.instances import golomb  # noqa: E402
from turbo_tpu_torch.solver.config import EngineConfig  # noqa: E402
from turbo_tpu_torch.solver.engine import BatchedSolver  # noqa: E402

CAP, INNER = 16, 16


def main():
    m, lanes, steps = (int(a) for a in (sys.argv[1:] + ["12", "8", "12"]
                                        [len(sys.argv) - 1:])[:3])
    s = BatchedSolver(compile_model(parse_fzn_text(golomb(m))),
                      EngineConfig(num_dives=lanes, use_table=False,
                                   fp_cap_auto=False, fp_mode="wac1"),
                      device="cpu")
    st, _ = s.run_steps(s.init_state(), steps, CAP)
    t = flat_tables(s)
    names = [f"group {g} (op {op}, {b - a} rules)"
             for g, (op, a, b) in enumerate(s.dp.group_slices)]
    names += [f"element ({t['E']} rows)", f"membership ({t['M']} rows)"]
    names += [f"linear bucket {k} ({t['lb_off'][k + 1] - t['lb_off'][k]} "
              f"rows)" for k in range(t["LB"])]
    total = {}
    for d in range(lanes):
        for skip in (True, False):
            stats = {}
            emulate_wac1(t, st.lb[d].tolist(), st.ub[d].tolist(), CAP, INNER,
                         skip, stats=stats)
            for k, x in stats.items():
                acc = total.setdefault((k, skip), dict.fromkeys(x, 0))
                for key in acc:
                    acc[key] += x[key]
    print(f"golomb({m}), {lanes} lanes after {steps} steps, cap {CAP}, "
          f"inner cap {INNER}: per pass, the passes run and skipped whole; "
          f"the rules run / held by the passes run; the share of the rules "
          f"without the skip")
    for k, name in enumerate(names):
        on, off = total.get((k, True)), total.get((k, False))
        if on is None:
            continue
        print(f"  {name}: run {on['runs']}, skipped whole "
              f"{on['skipped']}; rules {on['ran']} "
              f"/ {on['held']} ({on['ran'] / max(on['held'], 1):.2%}); "
              f"without the skip {off['ran']} "
              f"({on['ran'] / max(off['ran'], 1):.2%})")
    ran = sum(x["ran"] for (k, skip), x in total.items() if skip)
    full = sum(x["ran"] for (k, skip), x in total.items() if not skip)
    print(f"  all passes: {ran} of {full} rules ({ran / max(full, 1):.2%})")


if __name__ == "__main__":
    main()
