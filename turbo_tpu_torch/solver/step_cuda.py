"""The search step on the card: three kernel launches, no host read.

A step of ``BatchedSolver.step_plain`` on a CUDA state, in place:

    K6 step.head -> K1 fixpoint.step or K8 wac1.step (the propagation,
                    then K2 and K3) -> K6 step.post

K6 head does the previous step's refill and ring rows, then this step's
promote and objective tighten; K6 post does the rest of the step lane by
lane, and the last block of each EPS shard to finish runs the shard's
scan (ranks of the finishing lanes and of the solutions, next_sub,
sol_w), the last shard publishing the next step's live flag and the
incumbent min that the next head reads. Between them, under the default
``fp_mode="fixpoint"`` with layout ``dv``, K1's step entry propagates
each lane and classifies and selects on the store its block holds (K2
and K3 as device functions, no launch of their own); under
``fp_mode="wac1"`` K8's step entry does the same. The other modes
launch their propagation, then K2 classify and K3 select (five launches
a step): K1's fixed-sweeps entry (``"fixed"``), or, for layout ``vd``,
K1's transposed entry between two transposing copies into and out of
(V, D) planes kept in the ``Workspace``. Each launch runs in place and
takes the step's ``live`` flag.

``run`` enqueues a chunk of n steps as 3n + 2 launches (5n + 2 under
``"fixed"`` and ``vd``): K7 ``step_tail.live`` (the device flag
``live``: some lane not IDLE; the step counter to 0; the incumbent
min), the n steps, and K7
``step_tail.copy`` with the last step's refill and ring rows, so the
state is complete when the host reads it. Each step reads one of two
flag words and its post writes the other, so every kernel of a step
after the batch went IDLE returns at once, as the JAX ``while_loop`` of
``make_step_budget`` (``turbo_tpu/solver/engine.py:1316-1377``) stops.
The host reads nothing: ``solve`` reads the counter with the chunk's
other scalars.

The scratch of the step (K1-K3's outputs, the flags K6 post hands to the
next head, the tickets of the shard scan) is allocated once per solver
(``Workspace``); the state's tensors are passed to the kernels as
pointers in one ``StepView``.

A chunk whose launches repeat those of the chunk before (the same step
count, cap and StepView, i.e. the same state tensors) is captured once
into a CUDA graph and replayed from then on: one launch per chunk in
place of three per step. The graph bakes in pointers only, so a replay
is right whenever the StepView's bytes match. The capture launches
nothing, so it counts no launch; each replay adds the captured launches
to the wrappers' counts.

A profiled chunk (``run(..., stamps=..., spans=...)``,
``solver/profile_split.py``) launches the stamped step entries in place
of K1's and K8's step entries (the same outputs, and each block's clock
stamps) and K6's timed entries in place of head and post; each of these
launches writes its own span on the global timer into a row of
``Spans``: the first block's start, the last block's end, which leaves
out the time between launches, and the launch's own start-up and drain
that a profiler's kernel time holds. The launches with no timed form
(under ``fixed`` and ``vd``: the propagation, the ``vd`` copies around
it, K2 and K3) are timed by a CUDA event before and after. Each span is
tagged by what the launch does (``profile_split.FIXPOINT``, ``OTHER`` or
``STAMPED``); K7's two launches are not timed. The chunk is captured
into a graph of its own and replayed once, so that its launches run
back to back whatever the host's pace. It writes the same state tensors
in place, so the cached graphs stay valid.

Card groups (``parallel/mesh.py``: EPS shards on distinct cards, or as
separate states on one) step in lockstep through ``run_groups``: each
group's step begins with K10 (``kernels.xcard``), which reduces the
incumbent min and live flag that every group's previous post (or K7
live) published into the group's slots, so that head, step entry and
post read the words they read on one card. The groups' streams wait on
each other's events between steps; one group is the ``run`` above,
unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from .. import trace

I32 = torch.int32
F32 = torch.float32
BOOL = torch.bool


class Workspace:
    """Per-solver scratch of the kernel route, on the solver's card, for
    states of ``D`` lanes (S shards of ``cfg.num_dives`` lanes each)."""

    def __init__(self, solver, D):
        from .. import kernels
        self.lanes = D
        dev = solver.device
        dp = solver.dp

        def e(dtype, *shape):
            return torch.empty(shape or (D,), dtype=dtype, device=dev)

        self.iters, self.unconv = e(I32), e(BOOL)
        # The propagation's scratch, K8's under "wac1", else K1's (None:
        # its stores sit in shared memory).
        prop = (kernels.wac1 if solver.cfg.fp_mode == "wac1"
                else kernels.fixpoint)
        self.fp_scratch = prop.scratch(solver.kernels.kernel_plan, D)
        if solver.cfg.fp_mode == "fixpoint" and solver.cfg.fp_layout == "vd":
            self.lbT, self.ubT = e(I32, dp.V, D), e(I32, dp.V, D)
        self.bot, self.ent = e(BOOL), e(BOOL)
        self.sel = (e(BOOL),) + tuple(e(I32) for _ in range(7))
        self.strat0, self.nxt, self.newidx, self.ridx = (e(I32) for _ in
                                                         range(4))
        self.want, self.impr, self.dleaf, self.havework = (e(BOOL) for _ in
                                                           range(4))
        live = torch.zeros(2, dtype=I32, device=dev)
        self.live = (live[0:1], live[1:2])
        self.steps = torch.zeros(1, dtype=I32, device=dev)
        # K6 post's tickets (csrc/step.cuh): shards scanned, the live
        # word, the min accumulator (INT_MAX between launches), then one
        # lane ticket per shard; and the incumbent min for K6 head.
        S = D // solver.cfg.num_dives
        self.tail_sync = torch.zeros(3 + S, dtype=I32, device=dev)
        self.tail_sync[2] = torch.iinfo(I32).max
        self.bmin = torch.zeros(1, dtype=I32, device=dev)
        self.graphs = {}     # (n, cap, StepView bytes) -> (graph, counts)
        self.last_key = None
        self.capture_stream = None
        # A card group's (Exchange, index) (``run_groups``), else None;
        # and its step graphs: (step kind, cap, StepView bytes) ->
        # (graph, counts).
        self.xc = None
        self.step_graphs = {}


def shards(solver, st) -> int:
    """S: the EPS shards of a state of S * num_dives lanes."""
    D = solver.cfg.num_dives
    S = st.phase.shape[0] // D
    if S < 1 or S * D != st.phase.shape[0]:
        raise ValueError(f"a state of {st.phase.shape[0]} lanes is not a "
                         f"whole number of shards of {D} lanes")
    return S


def _fields(solver, st):
    """(name, tensor, shape, dtype) of every state field the kernels
    read or write: S shards of D lanes, n_pad table rows and R ring rows
    each, concatenated."""
    S = shards(solver, st)
    D, V = S * solver.cfg.num_dives, solver.dp.V
    MAXD = solver.cfg.max_depth
    n_pad = st.tab_lb.shape[0]
    R = S * max(1, solver.cfg.sol_ring_size)
    shapes = {"lb": (D, V), "ub": (D, V), "root_lb": (D, V),
              "root_ub": (D, V), "best_lb": (D, V), "best_ub": (D, V),
              "tab_lb": (n_pad, V), "tab_ub": (n_pad, V),
              "tab_strat": (n_pad,), "tab_path": (n_pad,),
              "sol_ring": (R, V)}
    dtypes = {"has_best": BOOL, "nonexh": BOOL, "deds": F32, "pscale": F32}
    for f in dataclasses.fields(st):
        shape = shapes.get(f.name, (D, MAXD) if f.name.startswith("dec_")
                           else (D,))
        yield f.name, getattr(st, f.name), shape, dtypes.get(f.name, I32)


def view(solver, st, ws):
    """The StepView of state ``st``, checked field by field."""
    from ..kernels import StepView, _check
    cfg, dp = solver.cfg, solver.dp
    ptr = {}
    for name, t, shape, dtype in _fields(solver, st):
        _check(t, name, shape, dtype)
        ptr[name] = t.data_ptr()
    found, var, nstrat, _valo, c0l, c0u, c1l, c1u = ws.sel
    for name, t in (("lb0", dp.lb0), ("ub0", dp.ub0), ("iters", ws.iters),
                    ("unconv", ws.unconv), ("bot", ws.bot),
                    ("ent", ws.ent), ("found", found), ("var", var),
                    ("nstrat", nstrat), ("c0l", c0l), ("c0u", c0u),
                    ("c1l", c1l), ("c1u", c1u), ("strat0", ws.strat0),
                    ("want", ws.want), ("impr", ws.impr),
                    ("dleaf", ws.dleaf), ("nxt", ws.nxt),
                    ("newidx", ws.newidx), ("havework", ws.havework),
                    ("ridx", ws.ridx), ("steps", ws.steps),
                    ("tail_sync", ws.tail_sync), ("bmin", ws.bmin)):
        ptr[name] = t.data_ptr()
    S = shards(solver, st)
    if st.tab_lb.shape[0] % S:
        raise ValueError(f"{st.tab_lb.shape[0]} table rows for {S} shards")
    if ws.xc is not None:  # a card group: its slots, K10's exchange
        xc, g = ws.xc
        ptr.update(xslots=xc.ptrs[g].data_ptr(), xn=xc.n, xcard=g)
    return StepView(
        D=cfg.num_dives, S=S, V=dp.V, n_active=dp.n_active,
        MAXD=cfg.max_depth, obj=dp.obj, is_opt=int(dp.is_opt),
        enumerate_all=int(cfg.enumerate_all),
        use_table=int(solver.use_table), R=cfg.sol_ring_size,
        n_pad=st.tab_lb.shape[0] // S, **ptr)


MAX_GRAPHS = 8


def run(solver, st, n: int, cap: int = 0, graph: bool = True,
        stamps=None, spans=None):
    """n steps of ``st`` in place at fixpoint cap ``cap`` (0:
    ``fp_max_iters``). Returns the number of steps that ran, as a 0-dim
    int32 tensor on the card (no host read). ``graph``: capture a chunk
    that repeats the previous one and replay it. ``stamps``: an (n, D, 2)
    int64 tensor; the chunk is a profiled one (a graph of its own, the
    stamped step entries, step i's stamps in ``stamps[i]``; its launches'
    spans in ``spans``, a ``Spans`` of n steps). Traced (``trace.py``),
    the chunk counts as ``graph_replays``, ``graph_captures`` (captured
    in this call, then replayed) or ``eager_chunks`` (enqueued launch by
    launch; a profiled chunk, or ``graph`` False, too)."""
    lanes = st.phase.shape[0]
    if solver._ws is None or solver._ws.lanes != lanes:
        solver._ws = Workspace(solver, lanes)
    ws = solver._ws
    sv = view(solver, st, ws)
    cap = cap or solver.cfg.fp_max_iters
    if stamps is not None:
        if spans is None:
            raise ValueError("a profiled chunk needs its Spans")
        if tuple(stamps.shape) != (n, lanes, 2):
            raise ValueError(f"stamps: expected shape {(n, lanes, 2)}, got "
                             f"{tuple(stamps.shape)}")
        from .. import kernels
        g, counts = _capture(solver, st, sv, n, cap, stamps, spans)
        g.replay()
        kernels.add_launches(counts)
        trace.count("eager_chunks")
        return ws.steps[0].clone()
    key = (n, cap, bytes(sv))
    g = ws.graphs.get(key) if graph else None
    if g is None and graph and key == ws.last_key:
        g = _capture(solver, st, sv, n, cap)
        if len(ws.graphs) >= MAX_GRAPHS:
            ws.graphs.pop(next(iter(ws.graphs)))
        ws.graphs[key] = g
        trace.count("graph_captures")
    else:
        trace.count("eager_chunks" if g is None else "graph_replays")
    ws.last_key = key
    if g is not None:
        from .. import kernels
        g[0].replay()
        kernels.add_launches(g[1])
    else:
        _enqueue(solver, st, sv, n, cap)
    return ws.steps[0].clone()


def _capture(solver, st, sv, n, cap, stamps=None, spans=None):
    """(graph, launch counts) of one chunk's launches (``stamps``,
    ``spans``: a profiled chunk's), captured on a side stream; the
    capture runs nothing and counts nothing."""
    return _capture_launches(
        solver, st.lb.device,
        lambda: _enqueue(solver, st, sv, n, cap, stamps, spans))


def fused(cfg) -> bool:
    """Whether the step's propagation launch also classifies and selects
    (K1's or K8's step entry): ``fp_mode="fixpoint"`` with layout ``dv``,
    or ``fp_mode="wac1"``."""
    return cfg.fp_mode == "wac1" or (cfg.fp_mode == "fixpoint"
                                      and cfg.fp_layout == "dv")


def propagate(solver, st, cap, live, stamps=None, span=None):
    """The step's propagation launch, in place on ``st.lb`` / ``st.ub``,
    by ``fp_mode`` and ``fp_layout``; iters and unconv go to the
    workspace, and when ``fused(cfg)`` also bot, ent and the selection
    (from ``strat0``). ``stamps`` ((D, 2) int64) and ``span`` ((2,)
    int64): a profiled step's; the step entry is the stamped one."""
    from .. import kernels
    cfg, ws = solver.cfg, solver._ws
    kp = solver.kernels.kernel_plan
    out = (st.lb, st.ub, ws.iters, ws.unconv, ws.fp_scratch)
    step_out = out + (ws.bot, ws.ent) + ws.sel
    if cfg.fp_mode == "wac1":
        if stamps is None:
            kernels.wac1.step(kp, st.lb, st.ub, cap, cfg.wac1_inner_cap,
                              ws.strat0, live=live, out=step_out)
        else:
            kernels.wac1.step_stamped(kp, st.lb, st.ub, cap,
                                      cfg.wac1_inner_cap, ws.strat0, stamps,
                                      span, live=live, out=step_out)
    elif fused(cfg):
        if stamps is None:
            kernels.fixpoint.step(kp, st.lb, st.ub, cap, ws.strat0,
                                  live=live, out=step_out)
        else:
            kernels.fixpoint.step_stamped(kp, st.lb, st.ub, cap, ws.strat0,
                                          stamps, span, live=live,
                                          out=step_out)
    elif cfg.fp_mode == "fixed":
        kernels.fixpoint.fixed_sweeps(kp, st.lb, st.ub, cfg.fp_fixed_iters,
                                      live=live, out=out)
    else:  # fp_mode "fixpoint", layout "vd"
        ws.lbT.copy_(st.lb.t())
        ws.ubT.copy_(st.ub.t())
        kernels.fixpoint.transposed(
            kp, ws.lbT, ws.ubT, cap, live=live,
            out=(ws.lbT, ws.ubT, ws.iters, ws.unconv, ws.fp_scratch))
        st.lb.copy_(ws.lbT.t())
        st.ub.copy_(ws.ubT.t())


class Spans:
    """A profiled chunk's measured spans, each with its kind
    (``profile_split.FIXPOINT``, ``OTHER`` or ``STAMPED``): rows of
    ``ns`` ((3n, 2) int64 on the card, set to (INT64_MAX, 0)), which a
    timed launch writes itself (global-timer ns, csrc/common.cuh), or
    pairs of CUDA events around a launch with no timed form, which also
    hold its launch latency in the graph."""

    def __init__(self, n: int, device):
        self.ns = torch.tensor([[torch.iinfo(torch.int64).max, 0]],
                               dtype=torch.int64, device=device).repeat(
                                   3 * n, 1)
        self.spans = []  # (kind, row of ns or (start event, end event))
        self.rows = 0

    def row(self, kind):
        """The next row of ``ns``, for a timed launch of ``kind``."""
        self.spans.append((kind, self.rows))
        self.rows += 1
        return self.ns[self.rows - 1]

    @contextlib.contextmanager
    def timed(self, kind):
        """A CUDA event before and one after the launches inside
        (external events, so that the chunk's graph records them when it
        runs), a span of ``kind``."""
        a = torch.cuda.Event(enable_timing=True, external=True)
        b = torch.cuda.Event(enable_timing=True, external=True)
        a.record()
        yield
        b.record()
        self.spans.append((kind, (a, b)))

    def events(self):
        """The spans as ``profile_split.Event``s (ms; a row a launch left
        unwritten, 0). Waits for the chunk, one host read."""
        from .profile_split import Event
        torch.cuda.current_stream(self.ns.device).synchronize()
        ns = self.ns.tolist()
        out = []
        for kind, at in self.spans:
            if isinstance(at, int):
                t0, t1 = ns[at]
                out.append(Event(kind, max(t1 - t0, 0) / 1e6))
            else:
                out.append(Event(kind, at[0].elapsed_time(at[1])))
        return out


def _enqueue(solver, st, sv, n, cap, stamps=None, spans=None):
    """Launch the live flag, n steps and the closing copy on the current
    stream: 3n + 2 launches (5n + 2 unless ``fused(cfg)``). ``stamps``,
    ``spans``: a profiled chunk's (see ``run``)."""
    from .. import kernels
    ws = solver._ws
    dev = st.lb.device
    kernels.step_tail.live(sv, ws.live[0], dev)
    prev = None
    for i in range(n):
        cur, nxt = ws.live[i % 2], ws.live[1 - i % 2]
        _step(solver, st, sv, cap, prev, cur, nxt,
              None if stamps is None else stamps[i], spans)
        prev = cur
    if prev is not None:
        kernels.step_tail.copy(sv, prev, dev)


def _step(solver, st, sv, cap, prev, cur, nxt, stamps=None, spans=None,
          xpar=None):
    """One step's launches on the current stream: K6 head (the rows of
    the step whose live word is ``prev``, None for none), the
    propagation (K1's or K8's step entry; or the propagation, K2 and K3)
    and K6 post, under the live word ``cur``, the post writing ``nxt``.
    ``stamps``, ``spans``: a profiled step's; ``xpar``: a card group's
    step, whose post publishes into the slots of parity ``xpar``."""
    from .. import kernels
    from .profile_split import FIXPOINT, OTHER, STAMPED
    ws = solver._ws
    dev = st.lb.device
    kp = solver.kernels.kernel_plan

    def span(kind):  # K6's keyword: the timed entry in a profiled chunk
        return {} if spans is None else {"span": spans.row(kind)}

    def timed(kind):
        return contextlib.nullcontext() if spans is None \
            else spans.timed(kind)

    kernels.step.head(sv, prev, cur, dev, **span(OTHER))
    if not fused(solver.cfg):
        with timed(FIXPOINT):
            propagate(solver, st, cap, cur)
        with timed(OTHER):
            kernels.classify(kp, st.lb, st.ub, live=cur,
                             out=(ws.bot, ws.ent))
        with timed(OTHER):
            kernels.select(kp, st.lb, st.ub, ws.strat0, live=cur,
                           out=ws.sel)
    else:
        propagate(solver, st, cap, cur, stamps,
                  None if spans is None else spans.row(STAMPED))
    kernels.step.post(sv, cur, nxt, dev, kp.smem_limit, **span(OTHER),
                      **({} if xpar is None else {"xpar": xpar}))


# -- card groups: shards on distinct cards of one process ---------------


class Exchange:
    """What the card groups of one ``ShardedSolver`` (``parallel/
    mesh.py``) share on the card: each group's slot array (K10's,
    csrc/xcard.cu: (2, N, 2) int32, [parity][group] = (incumbent min,
    live)) and, on the group's card, the table of every group's slot
    pointer (peer pointers across cards); each group's stream; the CUDA
    events each group's stream records after a step's post (one per
    parity) and at the end of a chunk. ``devices``: each group's card,
    in shard order; groups may share a card. Peer access is enabled for
    every pair of distinct cards (``kernels.enable_peer`` raises for a
    pair without it)."""

    def __init__(self, devices):
        from .. import kernels
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)
        cards = sorted({d.index for d in self.devices})
        for a in cards:
            for b in cards:
                if a != b:
                    kernels.enable_peer(a, b)
        self.slots, self.streams, self.events, self.done = [], [], [], []
        for d in self.devices:
            with torch.cuda.device(d):
                self.slots.append(torch.zeros((2, self.n, 2), dtype=I32,
                                              device=d))
                self.streams.append(torch.cuda.Stream(d))
                self.events.append((torch.cuda.Event(), torch.cuda.Event()))
                self.done.append(torch.cuda.Event())
        addr = [t.data_ptr() for t in self.slots]
        self.ptrs = [torch.tensor(addr, dtype=torch.int64, device=d)
                     for d in self.devices]
        self.started = False  # a chunk was enqueued (``done`` recorded)


def run_groups(solvers, states, xc, n: int, cap: int = 0,
               graph: bool = True, busy=None):
    """n steps of every card group's state, in place, in lockstep (the
    card-group counterpart of ``run``): on each group's stream K7 live
    (publishing the group's incumbent min and live flag for the first
    step), then per step K10 (the exchange: ``kernels.xcard`` over the
    slots of the step's parity), K6 head, the step entry and K6 post
    (publishing for the next step), then K7 copy. The host enqueues the
    whole chunk without a read: before each step a group's stream waits
    on the events the other groups' streams recorded after their
    previous post (K7 live before the first step), and before K7 live on
    the other groups' ends of the previous chunk. With ``graph`` each
    group's step is a CUDA graph of its own, captured at its first use
    (one for the chunk's first step, whose head copies nothing, and one
    for each parity after it) and replayed from then on. ``busy``: a
    list of a list per group, which gets a pair of timing CUDA events
    around each of the group's steps. Returns the steps that ran (group
    0's counter; every group counts the same), a 0-dim int32 tensor on
    group 0's card."""
    from .. import kernels
    cap = cap or solvers[0].cfg.fp_max_iters
    views = []
    for g, (s, st) in enumerate(zip(solvers, states)):
        lanes = st.phase.shape[0]
        if s._ws is None or s._ws.lanes != lanes:
            s._ws = Workspace(s, lanes)
        s._ws.xc = (xc, g)
        views.append(view(s, st, s._ws))
    groups = list(zip(range(xc.n), solvers, states, views, xc.devices,
                      xc.streams))
    for g, s, st, sv, dev, stream in groups:
        with torch.cuda.device(dev):
            # The state's writes on the card's stream, and every group's
            # previous chunk: its K10s read the slots K7 live writes.
            stream.wait_stream(torch.cuda.current_stream(dev))
            if xc.started:
                for h in range(xc.n):
                    if h != g:
                        stream.wait_event(xc.done[h])
            with torch.cuda.stream(stream):
                kernels.step_tail.live(sv, s._ws.live[0], dev)
                xc.events[g][1].record(stream)
    for t in range(n):
        par = t % 2
        for g, s, st, sv, dev, stream in groups:
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                for h in range(xc.n):
                    if h != g:
                        stream.wait_event(xc.events[h][1 - par])
                if busy is not None:
                    a = torch.cuda.Event(enable_timing=True)
                    a.record(stream)
                _group_step(s, st, sv, t, cap, graph)
                if busy is not None:
                    b = torch.cuda.Event(enable_timing=True)
                    b.record(stream)
                    busy[g].append((a, b))
                xc.events[g][par].record(stream)
    for g, s, st, sv, dev, stream in groups:
        with torch.cuda.device(dev):
            with torch.cuda.stream(stream):
                if n:
                    kernels.step_tail.copy(sv, s._ws.live[(n - 1) % 2], dev)
                xc.done[g].record(stream)
            torch.cuda.current_stream(dev).wait_stream(stream)
    xc.started = True
    with torch.cuda.device(xc.devices[0]):
        return solvers[0]._ws.steps[0].clone()


def _group_step(s, st, sv, t, cap, graph):
    """Step ``t`` of a card group on the current stream: K10, then the
    step's launches (``_step``), as the group's graph for the step's
    kind when ``graph``."""
    from .. import kernels
    ws = s._ws
    xc, g = ws.xc
    par = t % 2

    def launches():
        kernels.xcard(xc.slots[g], par, ws.live[par], ws.bmin)
        _step(s, st, sv, cap, None if t == 0 else ws.live[1 - par],
              ws.live[par], ws.live[1 - par], xpar=1 - par)

    if not graph:
        launches()
        return
    key = (0 if t == 0 else 1 + par, cap, bytes(sv))
    entry = ws.step_graphs.get(key)
    if entry is None:
        if len(ws.step_graphs) >= 3 * MAX_GRAPHS:
            ws.step_graphs.pop(next(iter(ws.step_graphs)))
        entry = ws.step_graphs[key] = _capture_launches(s, st.lb.device,
                                                        launches)
    entry[0].replay()
    kernels.add_launches(entry[1])


def _capture_launches(s, dev, launches):
    """(graph, launch counts) of ``launches()`` captured on the solver's
    capture stream after the current stream's work; the capture runs
    nothing and counts nothing."""
    from .. import kernels
    ws = s._ws
    if ws.capture_stream is None:
        ws.capture_stream = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)
    ws.capture_stream.wait_stream(main)
    g = torch.cuda.CUDAGraph()
    before = kernels.launch_counts()
    with torch.cuda.stream(ws.capture_stream):
        g.capture_begin(capture_error_mode="thread_local")
        try:
            launches()
        finally:
            g.capture_end()
            captured = kernels.launch_counts(since=before)
            kernels.add_launches({k: -v for k, v in captured.items()})
    main.wait_stream(ws.capture_stream)
    return g, captured
