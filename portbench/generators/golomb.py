"""Golomb ruler (CSPLib prob006, https://www.csplib.org/Problems/prob006/),
frozen from the port's ``instances.golomb`` so that a later change there
cannot move the benchmark. m marks in 0..m*m, the last mark minimised;
the differences are output too, so a printed solution checks alone."""
from __future__ import annotations

import random

# Optimal lengths (OEIS A003022).
OPTIMUM = {4: 6, 5: 11, 6: 17, 7: 25, 8: 34, 9: 44, 10: 55, 11: 72,
           12: 85, 13: 106}


def generate(m: int, order_seed: int) -> str:
    n = m * m
    lines = [f"var 0..{n}: m{i} :: output_var;" for i in range(m)]
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)]
    lines += [f"var 1..{n}: d{i}_{j} :: output_var;" for i, j in pairs]
    marks = ", ".join(f"m{i}" for i in range(m))
    lines.append(f"array [1..{m}] of var int: mark :: output_array([1..{m}]) "
                 f"= [{marks}];")
    cons = ["constraint int_eq(m0, 0);"]
    cons += [f"constraint int_lt(m{i}, m{i + 1});" for i in range(m - 1)]
    cons += [f"constraint int_lin_eq([1, -1, 1], [d{i}_{j}, m{j}, m{i}], 0);"
             for i, j in pairs]
    for a in range(len(pairs)):
        for b in range(a + 1, len(pairs)):
            (i, j), (k, l) = pairs[a], pairs[b]
            cons.append(f"constraint int_ne(d{i}_{j}, d{k}_{l});")
    cons.append(f"constraint int_lt(d0_1, d{m - 2}_{m - 1});")
    random.Random(order_seed).shuffle(cons)
    lines += cons
    lines.append("solve :: int_search(mark, input_order, indomain_min, "
                 f"complete) minimize m{m - 1};")
    return "\n".join(lines) + "\n"
