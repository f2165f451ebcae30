"""One solve that runs the whole window: ``-t`` is the window, and the
instance does not close within it, so the search runs to the end.

Set-up: the model written, and one short solve of it under
``-cutnodes`` (the kernel library loaded or built, every kernel of the
path and the measured split warmed). Traced: the profiler covers the
chunks from ``trace_slice[0]`` to ``trace_slice[1]`` of the window.
"""
import time

# The traffic file's keys this regime reads, beside those of every mix.
PARAMS = ("warmup_cutnodes", "warmup_timeout_ms", "trace_slice")


def run(cell):
    t = cell.traffic
    (path,) = cell.write_models(1)
    cell.solve(path, timeout_ms=t["warmup_timeout_ms"],
               extra=["-cutnodes", str(t["warmup_cutnodes"])])
    tr = cell.tracer
    cell.open_window()
    if tr is not None:
        a, b = (cell.window_open + f * cell.seconds for f in t["trace_slice"])

        def on_chunk():
            now = time.monotonic()
            if not tr.active and a <= now < b and tr.prof is None:
                tr.start_slice()
            elif tr.active and now >= b:
                tr.stop_slice()
        tr.on_chunk = on_chunk
    cell.requests.append(cell.solve(path, timeout_ms=cell.seconds * 1000))
    cell.close_window()
    if tr is not None:
        tr.stop_slice()
        tr.on_chunk = None
