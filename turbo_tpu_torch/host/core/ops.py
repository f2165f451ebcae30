"""Ternary constraint network (TNF) bytecode definitions.

The reference compiles every FlatZinc constraint into a ternary normal
form over interval propagators, represented as a bytecode table of
``{op, x, y, z}`` entries interpreted by the PIR abstract domain
(usage at the reference's include/common_solving.hpp:738-771; the
domain itself lives in the non-vendored `lala-pc` dependency).  This
module defines our own op set and the numpy reference semantics of
each deduction rule (bounds consistency) and entailment check.  The
JAX/TPU engine mirrors these rules in `turbo_tpu.solver.propagate`.

Every propagator relates three variables ``x, y, z``:

  ADD  x = y + z
  MUL  x = y * z
  DIV  x = y div z   (truncation toward zero, FlatZinc semantics)
  MIN  x = min(y, z)
  MAX  x = max(y, z)
  LE   x = (y <= z)  (x is a 0/1 variable)
  EQ   x = (y == z)  (x is a 0/1 variable)

Constants are interned as singleton variables, so these seven ops plus
domain meets cover the full FlatZinc builtin surface of the reference
fixture corpus (SURVEY.md §2a).

All domain bounds live in ``[-INF, INF]`` with ``INF = 2**30 - 1``;
arithmetic is computed wide (int64) and clamped back, which keeps every
clamp a sound weakening (the variable universe itself is ``[-INF,INF]``,
mirroring the reference's 32-bit interval universe, TURBO_ITV_BITS=32).
"""
from __future__ import annotations

import numpy as np

OP_ADD = 0
OP_MUL = 1
OP_DIV = 2
OP_MIN = 3
OP_MAX = 4
OP_LE = 5
OP_EQ = 6
NUM_OPS = 7

OP_NAMES = ["add", "mul", "div", "min", "max", "le", "eq"]

INF = (1 << 30) - 1
NINF = -INF


def clamp(a):
    return np.clip(a, NINF, INF)


def interval_fwd(op: int, ly, uy, lz, uz):
    """Forward interval of `y op z` (python ints, used by the compiler
    to initialize auxiliary-variable domains)."""
    if op == OP_ADD:
        return ly + lz, uy + uz
    if op == OP_MUL:
        cs = [ly * lz, ly * uz, uy * lz, uy * uz]
        return min(cs), max(cs)
    if op == OP_DIV:
        cs = []
        for zl, zu in _nonzero_parts(lz, uz):
            for a in (ly, uy):
                for b in (zl, zu):
                    cs.append(int(np.trunc(a / b)) if b != 0 else 0)
        if not cs:
            return NINF, INF
        return min(cs), max(cs)
    if op == OP_MIN:
        return min(ly, lz), min(uy, uz)
    if op == OP_MAX:
        return max(ly, lz), max(uy, uz)
    if op == OP_LE:
        return (1 if uy <= lz else 0), (0 if ly > uz else 1)
    if op == OP_EQ:
        lo = 1 if (ly == uy == lz == uz) else 0
        hi = 1 if (max(ly, lz) <= min(uy, uz)) else 0
        return lo, hi
    raise ValueError(op)


def _nonzero_parts(lz, uz):
    parts = []
    if lz <= -1:
        parts.append((lz, min(uz, -1)))
    if uz >= 1:
        parts.append((max(lz, 1), uz))
    return parts
