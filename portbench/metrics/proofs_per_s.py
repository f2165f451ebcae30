"""Proofs completed, each judged right, over the wall time from the
window's start to the end of its last proof."""


def read(cell):
    done = [r for r in cell.requests if not r.judged.failed(cell.limits())]
    if not done:
        return None
    return len(done) / (cell.requests[-1].t_end - cell.window_open)
