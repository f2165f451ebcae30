"""The mean over the window's proofs of the CLI's ``initTime`` statistic
(parse, compile, solver construction with the kernels' warm-up)."""


def read(cell):
    vals = [r.stat("initTime") for r in cell.requests]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
