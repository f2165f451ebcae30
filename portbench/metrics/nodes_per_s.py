"""The solve's ``nodes`` statistic over the harness's own wall time of
the whole CLI call (parse, compile, solver construction, solve,
output)."""


def read(cell):
    (req,) = cell.requests
    nodes = req.stat("nodes")
    return None if nodes is None else nodes / req.wall_s
