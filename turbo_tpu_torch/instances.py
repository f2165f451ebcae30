"""FlatZinc instances generated in the repository (no downloads).

- ``golomb(m)``: the Golomb ruler (CSPLib prob006). Optimal lengths for
  m = 7..12 are 25, 34, 44, 55, 72, 85 (OEIS A003022).
- ``queens(n)``: n queens on an n x n board, a satisfaction model
  whose solution counts are public: 4, 40 and 92 for n = 6, 7, 8 (OEIS
  A000170).
- ``random_model(seed, ...)``: seeded random models that draw from every
  rule family the device plan compiles (TNF add/mul/div/min/max/le/eq,
  native linear with unit, non-unit and int64-only coefficients, element,
  sparse membership) plus root-fixed variables that reach the plan's
  singleton-tail conflict fold.
"""
from __future__ import annotations

import numpy as np


def golomb(m: int) -> str:
    """Golomb ruler with m marks in 0..m*m, minimising the last mark."""
    n = m * m
    lines = [f"var 0..{n}: m{i} :: output_var;" for i in range(m)]
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)]
    # Differences are output too, so a printed solution checks alone.
    lines += [f"var 1..{n}: d{i}_{j} :: output_var;" for i, j in pairs]
    marks = ", ".join(f"m{i}" for i in range(m))
    lines.append(f"array [1..{m}] of var int: mark :: output_array([1..{m}]) "
                 f"= [{marks}];")
    lines.append("constraint int_eq(m0, 0);")
    for i in range(m - 1):
        lines.append(f"constraint int_lt(m{i}, m{i + 1});")
    for i, j in pairs:
        lines.append(f"constraint int_lin_eq([1, -1, 1], "
                     f"[d{i}_{j}, m{j}, m{i}], 0);")
    for a in range(len(pairs)):
        for b in range(a + 1, len(pairs)):
            (i, j), (k, l) = pairs[a], pairs[b]
            lines.append(f"constraint int_ne(d{i}_{j}, d{k}_{l});")
    lines.append(f"constraint int_lt(d0_1, d{m - 2}_{m - 1});")
    lines.append("solve :: int_search(mark, input_order, indomain_min, "
                 f"complete) minimize m{m - 1};")
    return "\n".join(lines) + "\n"


GOLOMB_OPT = {4: 6, 5: 11, 6: 17, 7: 25, 8: 34, 9: 44, 10: 55, 11: 72,
              12: 85}


def queens(n: int) -> str:
    """n queens: q[i] is the row of the queen in column i; no two share a
    row or a diagonal."""
    lines = [f"var 1..{n}: q{i};" for i in range(n)]
    qs = ", ".join(f"q{i}" for i in range(n))
    lines.append(f"array [1..{n}] of var int: q :: output_array([1..{n}]) "
                 f"= [{qs}];")
    for i in range(n):
        for j in range(i + 1, n):
            lines.append(f"constraint int_ne(q{i}, q{j});")
            for off in (j - i, i - j):
                lines.append(f"constraint int_lin_ne([1, -1], [q{i}, q{j}], "
                             f"{off});")
    lines.append("solve :: int_search(q, input_order, indomain_min, "
                 "complete) satisfy;")
    return "\n".join(lines) + "\n"


QUEENS_COUNT = {4: 2, 5: 10, 6: 4, 7: 40, 8: 92}

FAMILIES = ("int_plus", "int_times", "int_div", "int_min", "int_max",
            "int_le_reif", "int_eq_reif", "int_lin_le", "int_lin_eq",
            "int_lin_le_reif", "array_int_element", "set_in_reif")

_VAR_ORDERS = ("input_order", "first_fail", "anti_first_fail", "smallest",
               "largest")
_VAL_ORDERS = ("indomain_min", "indomain_max", "indomain_split",
               "indomain_reverse_split")


def random_model(seed: int, n_vars: int = 6, n_cons: int = 14) -> str:
    """A seeded random model, satisfiable by construction (every
    constraint holds at a hidden witness assignment). Every family of
    FAMILIES appears at least once, and one linear row has a coefficient
    large enough that its bucket cannot run in int32 (``lin_fit32``
    false)."""
    rng = np.random.default_rng(seed)
    lines = []
    wit = {}

    def newvar(w, lo_pad=None, hi_pad=None, out=True):
        name = f"v{len(wit)}"
        lo = w - int(rng.integers(0, 4) if lo_pad is None else lo_pad)
        hi = w + int(rng.integers(0, 4) if hi_pad is None else hi_pad)
        wit[name] = w
        ann = " :: output_var" if out else ""
        lines.append(f"var {lo}..{hi}: {name}{ann};")
        return name

    base = [newvar(int(rng.integers(-3, 5)), int(rng.integers(1, 5)),
                   int(rng.integers(1, 5))) for _ in range(n_vars)]
    # Root-fixed operands: their deductions fold into the conflict column.
    lines.append("var 2..2: k2;")
    lines.append("var -1..-1: km1;")
    wit["k2"], wit["km1"] = 2, -1
    nb = 0

    def pick(k=1, fixed=False):
        pool = base + (["k2", "km1"] if fixed else [])
        return [pool[i] for i in rng.choice(len(pool), size=k, replace=False)]

    def newbool(v):
        nonlocal nb
        lines.append(f"var bool: b{nb} :: output_var;")
        wit[f"b{nb}"] = int(v)
        nb += 1
        return f"b{nb - 1}"

    def coefs(k):
        return [int(c) if c != 0 else 1 for c in rng.integers(-3, 4, size=k)]

    def tdiv(a, b):
        q = abs(a) // abs(b)
        return q if (a < 0) == (b < 0) else -q

    def family(f):
        if f in ("int_plus", "int_times", "int_div", "int_min", "int_max"):
            a = pick(1)[0]
            b = pick(1, fixed=True)[0]
            wa, wb = wit[a], wit[b]
            if f == "int_div" and wb == 0:
                b, wb = "k2", 2
            w = {"int_plus": wa + wb, "int_times": wa * wb,
                 "int_div": tdiv(wa, wb) if wb else 0,
                 "int_min": min(wa, wb), "int_max": max(wa, wb)}[f]
            return f"constraint {f}({a}, {b}, {newvar(w)});"
        if f in ("int_le_reif", "int_eq_reif"):
            a, b = pick(2)
            v = wit[a] <= wit[b] if f == "int_le_reif" else wit[a] == wit[b]
            return f"constraint {f}({a}, {b}, {newbool(v)});"
        k = int(rng.integers(2, 5))
        vs = pick(k)
        if f == "int_lin_le_reif":
            cs = coefs(k)
            rhs = sum(c * wit[x] for c, x in zip(cs, vs)) + int(rng.integers(-2, 3))
            v = sum(c * wit[x] for c, x in zip(cs, vs)) <= rhs
            return (f"constraint int_lin_le_reif({cs}, [{', '.join(vs)}], "
                    f"{rhs}, {newbool(v)});")
        if f in ("int_lin_le", "int_lin_eq"):
            unit = rng.random() < 0.5
            cs = ([int(c) for c in rng.choice([-1, 1], size=k)] if unit
                  else coefs(k))
            rhs = sum(c * wit[x] for c, x in zip(cs, vs))
            if f == "int_lin_le":
                rhs += int(rng.integers(0, 3))
            return f"constraint {f}({cs}, [{', '.join(vs)}], {rhs});"
        if f == "array_int_element":
            T = int(rng.integers(3, 7))
            tab = [int(v) for v in rng.integers(-3, 7, size=T)]
            idx = newvar(int(rng.integers(1, T + 1)), int(rng.integers(0, 3)),
                         int(rng.integers(0, 3)))
            return (f"constraint array_int_element({idx}, {tab}, "
                    f"{newvar(tab[wit[idx] - 1] if 1 <= wit[idx] <= T else tab[0])});")
        if f == "set_in_reif":
            x = vs[0]
            w = wit[x]
            vals = sorted({w - 3, w - 1, w + 2} | {w + int(d) for d in
                                                   rng.integers(-3, 4, size=2)})
            if vals[-1] - vals[0] == len(vals) - 1:  # keep it sparse
                vals = [w - 2, w, w + 3]
            s = "{" + ", ".join(str(v) for v in vals) + "}"
            return f"constraint set_in_reif({x}, {s}, {newbool(w in vals)});"
        raise ValueError(f)

    cons = [family(f) for f in FAMILIES]
    for _ in range(max(0, n_cons - len(FAMILIES))):
        cons.append(family(FAMILIES[int(rng.integers(len(FAMILIES)))]))
    a, b, c = pick(3)
    big = 1 << 28
    cons.append(f"constraint int_lin_le([{big}, {-big}, 1], [{a}, {b}, {c}], "
                f"{big * (wit[a] - wit[b]) + wit[c] + int(rng.integers(0, 4))});")
    lines += cons
    ann = ""
    if rng.random() < 0.7:
        ids = ", ".join(base[i] for i in rng.permutation(n_vars)[:max(2, n_vars - 2)])
        vo = _VAR_ORDERS[int(rng.integers(len(_VAR_ORDERS)))]
        va = _VAL_ORDERS[int(rng.integers(len(_VAL_ORDERS)))]
        ann = f" :: int_search([{ids}], {vo}, {va}, complete)"
    if rng.random() < 0.25:
        lines.append(f"solve{ann} satisfy;")
    else:
        kind = "minimize" if rng.random() < 0.6 else "maximize"
        lines.append(f"solve{ann} {kind} {pick(1)[0]};")
    return "\n".join(lines) + "\n"
