#!/usr/bin/env python3
"""The control and the planted faults of the comparison that decides
``correct``: each breaks the program underneath the timed path, in this
process only, so that a run of a cell must come out not correct.

- ``dropped_constraints`` (the control): every eighth ``int_ne`` of the
  parsed model is left out before it is compiled, so the program solves
  a weaker model than the one it was sent. It breaks the guarantee that
  every printed solution satisfies every constraint.
- ``frozen_step``: a chunk of steps returns the state unchanged.
- ``half_batch``: the second half of the lanes is left out, each chunk
  restoring their state to what it was before it.
- ``early_exhaust``: after each chunk of steps every lane is IDLE, so
  the search ends as if it were complete.
- ``altered_answer``: the objective variable of every printed solution
  (the second output variable where there is none) is one more than the
  program found.

``python3 portbench/control.py --plant <name> --workload <w> --seeds
a,b,c --seconds <s> [--trace 1]`` runs the cell on the card once a
seed with the plant in place (``none``: the sound program) and prints
one JSON line a run with the numbers compared (``checks``) and
``correct``; the benchmark's own runs never plant one.
"""
import argparse
import contextlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


@contextlib.contextmanager
def _patched(obj, attr, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def dropped_constraints():
    from turbo_tpu_torch import cli

    def make(parse):
        def parse_weaker(*a, **k):
            model = parse(*a, **k)
            ne = [c for c in model.constraints if c.name == "int_ne"]
            gone = {id(c) for c in ne[::8]}
            model.constraints = [c for c in model.constraints
                                 if id(c) not in gone]
            return model
        return parse_weaker
    return _patched(cli, "parse_fzn", make)


def frozen_step():
    import torch

    from turbo_tpu_torch.solver.engine import BatchedSolver

    def none_ran(st):
        return torch.zeros((), dtype=torch.int32, device=st.lb.device)

    def profiled(self, st, n, cap):
        # What a measured chunk returns: on the card no launch timed.
        return st, none_ran(st), ([], [0, 0]) if st.lb.is_cuda else None

    @contextlib.contextmanager
    def plant():
        with _patched(BatchedSolver, "run_steps",
                      lambda f: lambda self, st, n, cap=0: (st, none_ran(st))), \
             _patched(BatchedSolver, "_profiled_steps", lambda f: profiled):
            yield
    return plant()


def half_batch():
    import dataclasses

    from turbo_tpu_torch.solver.engine import BatchedSolver

    def make(steps):
        def run_half(self, st, *a, **k):
            D = st.phase.shape[0]
            lanes = [f.name for f in dataclasses.fields(st)
                     if getattr(st, f.name).dim() >= 1
                     and getattr(st, f.name).shape[0] == D]
            kept = {k: getattr(st, k)[D // 2:].clone() for k in lanes}
            res = steps(self, st, *a, **k)
            for k in lanes:
                getattr(res[0], k)[D // 2:] = kept[k]
            return res
        return run_half

    @contextlib.contextmanager
    def plant():
        with _patched(BatchedSolver, "run_steps", make), \
             _patched(BatchedSolver, "_profiled_steps", make):
            yield
    return plant()


def early_exhaust():
    from turbo_tpu_torch.solver.engine import IDLE, BatchedSolver

    def make(steps):
        def run_idle(self, st, *a, **k):
            res = steps(self, st, *a, **k)
            res[0].phase.fill_(IDLE)
            return res
        return run_idle

    @contextlib.contextmanager
    def plant():
        with _patched(BatchedSolver, "run_steps", make), \
             _patched(BatchedSolver, "_profiled_steps", make):
            yield
    return plant()


def altered_answer():
    import numpy as np

    from turbo_tpu_torch import cli

    def make(print_solution):
        def print_altered(tnf, best_lb, file=None):
            lb = np.array(best_lb, copy=True)
            lb[tnf.obj_var if tnf.obj_var >= 0
               else tnf.outputs[1].elems[0]] += 1
            return print_solution(tnf, lb, file)
        return print_altered
    return _patched(cli, "print_solution", make)


def none():
    """No plant: the sound runs whose readings the limits are set from."""
    return contextlib.nullcontext()


PLANTS = {"none": none, "dropped_constraints": dropped_constraints,
          "frozen_step": frozen_step, "half_batch": half_batch,
          "early_exhaust": early_exhaust, "altered_answer": altered_answer}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--plant", choices=sorted(PLANTS), required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from portbench import harness, run
    harness.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("portbench: the control runs on the CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    for seed in (int(s) for s in a.seeds.split(",")):
        with PLANTS[a.plant]():
            res = run.run_cell(spec, a.workload, seed, a.seconds,
                               bool(a.trace))
        print(json.dumps({"plant": a.plant, "workload": a.workload,
                          "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "metrics": res["metrics"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
