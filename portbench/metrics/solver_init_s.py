"""The mean over the window's proofs of the program's ``init.solver``
span (``-v``'s ``% trace`` lines): the solver's construction, with its
plan, its upload and the kernels' warm-up."""
import re

SPAN = re.compile(r"^% trace: init\.solver n=\d+ total_ms=([\d.]+) ", re.M)


def read(cell):
    vals = [float(m[1]) / 1e3 for m in
            (SPAN.search(r.err) for r in cell.requests) if m is not None]
    return sum(vals) / len(vals) if vals else None
