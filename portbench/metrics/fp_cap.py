"""The fixpoint cap the calibrator locked last, from the ``-v`` line
``% eps table: ...; fp_cap=N``."""
import re


def read(cell):
    (req,) = cell.requests
    m = re.search(r"; fp_cap=(\d+)$", req.err, re.M)
    return None if m is None else float(m.group(1))
