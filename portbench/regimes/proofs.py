"""A closed loop with one client: each request is one instance solved to
its proven optimum (parse, compile, a new solver, solve, output), the
next sent when the last has printed its result. Requests are sent until
the window ends; one started before its end runs to its end, under a
``-t`` of the whole window.

The instances are ``distinct_orders`` texts of the traffic's model, each
its constraints in an order of its own, written in set-up and sent in
turn. Set-up also solves the first once (the kernel library loaded or
built, every kernel of the path warmed). Traced: the profiler covers the
requests sent from ``trace_slice[0]`` of the window until the first that
ends after ``trace_slice[1]``.
"""
import time

# The traffic file's keys this regime reads, beside those of every mix.
PARAMS = ("distinct_orders", "trace_slice")


def run(cell):
    t = cell.traffic
    paths = cell.write_models(t["distinct_orders"])
    cell.solve(paths[0], timeout_ms=cell.seconds * 1000)
    tr = cell.tracer
    cell.open_window()
    end = cell.window_open + cell.seconds
    a, b = (cell.window_open + f * cell.seconds
            for f in t.get("trace_slice", (0, 0)))
    i = 0
    while time.monotonic() < end:
        if tr is not None and tr.prof is None and time.monotonic() >= a:
            tr.start_slice()
        cell.requests.append(cell.solve(paths[i % len(paths)],
                                        timeout_ms=cell.seconds * 1000))
        if tr is not None and tr.active and time.monotonic() >= b:
            tr.stop_slice()
        i += 1
    cell.close_window()
    if tr is not None:
        tr.stop_slice()
