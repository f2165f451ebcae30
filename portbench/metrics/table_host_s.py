"""The mean over the window's proofs of the EPS table build's host time:
the program's ``table`` span less its ``table.read`` children (each host
read of a level's results, which waits for the level's launch), from
``-v``'s ``% trace`` lines."""
import re

SPAN = re.compile(r"^% trace: (table|table\.read) n=\d+ total_ms=([\d.]+) ",
                  re.M)


def read(cell):
    vals = []
    for req in cell.requests:
        t = {m[1]: float(m[2]) for m in SPAN.finditer(req.err)}
        if "table" in t:
            vals.append((t["table"] - t.get("table.read", 0.0)) / 1e3)
    return sum(vals) / len(vals) if vals else None
