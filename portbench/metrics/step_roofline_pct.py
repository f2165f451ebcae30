"""The least time of a search step (``roofline.py``: the model's bytes
and int32 operations, D lanes, the sweeps a step ran) over the device
time per step in the traced slice: the device operations' time summed
from ``torch.profiler`` over the steps the program ran in that slice."""
import re

from portbench import roofline


def read(cell):
    tr = cell.tracer
    s = tr.summary if tr is not None else None
    if s is None or s.device_s <= 0 or tr.slice_steps <= 0:
        return None
    (req,) = cell.requests
    lanes = re.search(r"^% D=(\d+) ", req.err, re.M)
    sweeps = req.stat("fixpoint_iterations")
    if lanes is None or sweeps is None or req.steps <= 0:
        return None
    counts = roofline.model_counts(cell.models[req.path])
    least, _ = roofline.step_least_s(counts, int(lanes.group(1)),
                                     sweeps / req.steps)
    return 100.0 * least / (s.device_s / tr.slice_steps)
