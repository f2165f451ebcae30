"""The least time a search step could take on one H100, from the model
alone: the larger of the bytes a step must move over the memory rate
and the int32 operations it must do over the CUDA-core rate. The counts
are those of the FlatZinc model (its variables and constraints), not of
the program's plan, so they stay the same whatever kernels implement
the step and however the program pads or decomposes the model.

Copied from the arithmetic of ``chip_smoke.py`` (``bound``,
``sweep_ops``): inputs read once, outputs written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
INT_OPS_PER_S = 67e12      # CUDA-core rate (the float32 figure; int32's
                           # is lower, so the bound stays a lower bound)

WORD = 4                   # int32
OPS_RELATION = 15          # one binary relation propagated both ways
OPS_TERM = 15              # one term of a linear constraint
OPS_SLOT = 2               # one occurrence of a variable in a constraint
OPS_VAR = 8                # one variable's bounds met and compared


def model_counts(model) -> dict:
    """``model``: ``reference.Model``. Returns the variables, the words
    of the constraint tables and the int32 operations of one
    propagation sweep over one search lane."""
    words = ops = 0
    for kind, args in model.constraints:
        if kind.startswith("int_lin_"):
            n = len(args[0])
            words += 2 * n + 2
            ops += OPS_TERM * n + OPS_SLOT * n
        else:
            words += 1 + len(args)
            ops += OPS_RELATION + OPS_SLOT * len(args)
    v = len(model.domains)
    return {"vars": v, "rule_bytes": WORD * words,
            "ops_per_sweep": ops + OPS_VAR * v}


def step_least_s(counts: dict, lanes: int, sweeps_per_step: float):
    """(seconds, "bytes" or "operations"): the least time of one step of
    ``lanes`` lanes that run ``sweeps_per_step`` sweeps in all. Each
    lane's lower and upper bounds are read once and written once, the
    constraint tables read once."""
    nbytes = 2 * lanes * counts["vars"] * 2 * WORD + counts["rule_bytes"]
    ops = sweeps_per_step * counts["ops_per_sweep"]
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")
