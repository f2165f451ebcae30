"""The mean over the window's proofs of the program's
``table_build_time`` statistic (the EPS table build)."""


def read(cell):
    vals = [r.stat("table_build_time") for r in cell.requests]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
