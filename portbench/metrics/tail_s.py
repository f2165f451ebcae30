"""The mean per proof of the harness's own timer around the solver's
steal and resplit rounds (``_steal_open_branches``, ``_tail_resplit``),
each up to a synchronize."""


def read(cell):
    if cell.tracer is None or not cell.requests:
        return None
    return sum(r.tail_s for r in cell.requests) / len(cell.requests)
