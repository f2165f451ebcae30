"""The 90th percentile of the time of every proof of the window, each
from the request to its final ``==========``. A failed proof counts as
missing: past any time."""
from portbench import harness


def read(cell):
    never = 1e300
    times = [r.t_final - r.t_start
             if r.t_final is not None and not r.judged.failed(cell.limits())
             else never for r in cell.requests]
    if not times:
        return None
    p90 = harness.quantile(times, 9, 10)
    return None if p90 > 1e200 else p90
