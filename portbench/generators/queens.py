"""n queens (CSPLib prob054, https://www.csplib.org/Problems/prob054/),
frozen from the port's ``instances.queens``: q[i] is the row of the
queen in column i. A satisfaction model; its solution counts are public
(OEIS A000170)."""
from __future__ import annotations

import random

COUNT = {4: 2, 5: 10, 6: 4, 7: 40, 8: 92, 9: 352, 10: 724, 11: 2680,
         12: 14200, 13: 73712, 14: 365596}


def generate(n: int, order_seed: int) -> str:
    lines = [f"var 1..{n}: q{i};" for i in range(n)]
    qs = ", ".join(f"q{i}" for i in range(n))
    lines.append(f"array [1..{n}] of var int: q :: output_array([1..{n}]) "
                 f"= [{qs}];")
    cons = []
    for i in range(n):
        for j in range(i + 1, n):
            cons.append(f"constraint int_ne(q{i}, q{j});")
            for off in (j - i, i - j):
                cons.append(f"constraint int_lin_ne([1, -1], [q{i}, q{j}], "
                            f"{off});")
    random.Random(order_seed).shuffle(cons)
    lines += cons
    lines.append("solve :: int_search(q, input_order, indomain_min, "
                 "complete) satisfy;")
    return "\n".join(lines) + "\n"
