"""Spans and counters of the port's host code, on the profiler's clock.

``with trace.span("name") as sp:`` times a block with two clock reads,
traced or not, and ``sp.s`` is its seconds once it has closed: the
statistics' timers read it. The clock is ``time.time_ns()``, the one
``torch.profiler`` stamps its events on, so the spans lay over a device
trace as they are.

While tracing is on (``enable()``; the CLI turns it on under ``-v``),
each span that closes also keeps a record, ``Record(request, span,
parent, name, start_ns, end_ns)``, its parent being the span open
around it, and adds its duration and its self time (the duration less
what its children cover) to its name's totals for the request;
``count(name, k)`` adds to a counter of the request. ``request()`` opens
a new request around its root span ``request``; ``report(file)`` prints
the request's totals by span name and its counters as ``% trace``
lines. ``spans()`` returns the records kept since tracing was turned on,
the newest ``MAX_RECORDS`` of them (a dropped one counts in the
counter ``spans_dropped``). Off, a span keeps nothing and ``count`` does
nothing.

Spans nest within one thread: open and close them from the thread that
runs the request.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import time

MAX_RECORDS = 1 << 17

Record = collections.namedtuple(
    "Record", "request span parent name start_ns end_ns")


class _State:
    def __init__(self):
        self.on = False
        self.records = collections.deque(maxlen=MAX_RECORDS)
        self.stack = []        # the spans open now, innermost last
        self.ids = itertools.count(1)
        self.requests = itertools.count(1)
        self.request = 0       # 0: spans outside any request
        self.totals = {}       # name -> [n, total ns, self ns]
        self.counters = {}

    def reset(self):
        self.records.clear()
        self.stack.clear()
        self.request = 0
        self.totals = {}
        self.counters = {}


_S = _State()


class span:
    """A timed block (see the module's docstring); ``s`` its seconds."""
    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "child_ns")

    def __init__(self, name: str):
        self.name = name
        self.start_ns = self.end_ns = 0
        self.id = 0

    def __enter__(self):
        if _S.on:
            self.id = next(_S.ids)
            self.parent = _S.stack[-1] if _S.stack else None
            self.child_ns = 0
            _S.stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if _S.on and _S.stack and _S.stack[-1] is self:
            _S.stack.pop()
            dur = self.end_ns - self.start_ns
            parent = self.parent
            if parent is not None:
                parent.child_ns += dur
            if len(_S.records) == MAX_RECORDS:
                count("spans_dropped")
            _S.records.append((_S.request, self.id,
                               parent.id if parent is not None else 0,
                               self.name, self.start_ns, self.end_ns))
            t = _S.totals.get(self.name)
            if t is None:
                t = _S.totals[self.name] = [0, 0, 0]
            t[0] += 1
            t[1] += dur
            t[2] += dur - self.child_ns
        return False

    @property
    def s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*a, **k):
            with span(name):
                return fn(*a, **k)
        return run
    return deco


def count(name: str, k: int = 1) -> None:
    if _S.on:
        _S.counters[name] = _S.counters.get(name, 0) + k


@contextlib.contextmanager
def request():
    """A new request (its id on every span inside, its own totals and
    counters), inside its root span ``request``."""
    if _S.on:
        _S.request = next(_S.requests)
        _S.totals = {}
        _S.counters = {}
    with span("request") as sp:
        yield sp


def enable() -> None:
    """Turns tracing on, dropping the records kept before."""
    _S.reset()
    _S.on = True


def disable() -> None:
    """Turns tracing off; the records stay until the next ``enable``."""
    _S.on = False
    _S.stack.clear()


def enabled() -> bool:
    return _S.on


def spans() -> list:
    return [Record(*r) for r in _S.records]


def totals() -> dict:
    """Span name -> (n, total s, self s), of the current request."""
    return {k: (n, t * 1e-9, s * 1e-9)
            for k, (n, t, s) in _S.totals.items()}


def counters() -> dict:
    """The current request's counters."""
    return dict(_S.counters)


def idle_by_span(gaps, records) -> tuple:
    """Lays ``records`` (``spans()``) over a device's idle ``gaps``,
    (start ns, end ns) pairs on the same clock. Returns ({innermost span
    name open at a gap's middle, None where no span is: the gaps' ns},
    the gaps' ns that some span covers)."""
    # Spans nest: sweep them in start order with those open on a stack.
    order = sorted(records, key=lambda r: (r.start_ns, -r.end_ns))
    union = []
    for r in order:
        if union and r.start_ns <= union[-1][1]:
            union[-1][1] = max(union[-1][1], r.end_ns)
        else:
            union.append([r.start_ns, r.end_ns])
    by_span, covered, stack, i, u = {}, 0, [], 0, 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) // 2
        while i < len(order) and order[i].start_ns <= mid:
            stack.append(order[i])
            i += 1
        while stack and stack[-1].end_ns < mid:
            stack.pop()
        name = stack[-1].name if stack else None
        by_span[name] = by_span.get(name, 0) + (g1 - g0)
        while u < len(union) and union[u][1] <= g0:
            u += 1
        j = u
        while j < len(union) and union[j][0] < g1:
            covered += min(g1, union[j][1]) - max(g0, union[j][0])
            j += 1
    return by_span, covered


def report(file) -> None:
    """The current request's totals, a ``% trace:`` line a span name,
    and its counters on one ``% trace counters:`` line."""
    for name, (n, t, s) in sorted(_S.totals.items()):
        print(f"% trace: {name} n={n} total_ms={t / 1e6:.3f} "
              f"self_ms={s / 1e6:.3f}", file=file)
    print("% trace counters:" + "".join(
        f" {k}={v}" for k, v in sorted(_S.counters.items())), file=file,
        flush=True)
