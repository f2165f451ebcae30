"""The share of the chunks of steps that replayed a CUDA graph the
program had captured before: its counters (``-v``'s ``% trace
counters:`` line), summed over the requests, as 100 ``graph_replays``
over ``chunks``. None where the program counted no chunk as replayed,
captured or eager (the CPU's plain steps)."""
import re

COUNTERS = re.compile(r"^% trace counters:(.*)$", re.M)
KINDS = ("graph_replays", "graph_captures", "eager_chunks")


def read(cell):
    replays = chunks = 0
    seen = False
    for req in cell.requests:
        m = COUNTERS.search(req.err)
        if m is None:
            continue
        c = dict(kv.split("=") for kv in m[1].split())
        if any(k in c for k in KINDS):
            seen = True
            replays += int(c.get("graph_replays", 0))
            chunks += int(c.get("chunks", 0))
    return 100.0 * replays / chunks if seen and chunks else None
