"""The program's kernel launch counts (``kernels.launch_counts``, graph
replays included) over the requests, over the steps it ran."""


def read(cell):
    launches = sum(r.launches for r in cell.requests)
    steps = sum(r.steps for r in cell.requests)
    return launches / steps if launches > 0 and steps > 0 else None
