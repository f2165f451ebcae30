"""The host's time a chunk of steps, in which the device waits for it:
the program's spans (``-v``'s ``% trace`` lines), summed over the
requests, as (``chunk`` less ``chunk.wait``) over the ``chunk`` spans."""
import re

SPAN = re.compile(r"^% trace: (\S+) n=(\d+) total_ms=([\d.]+) ", re.M)


def read(cell):
    n = host_ms = 0.0
    for req in cell.requests:
        t = {m[1]: (int(m[2]), float(m[3])) for m in SPAN.finditer(req.err)}
        if "chunk" in t:
            n += t["chunk"][0]
            host_ms += t["chunk"][1] - t.get("chunk.wait", (0, 0.0))[1]
    return host_ms / n if n else None
