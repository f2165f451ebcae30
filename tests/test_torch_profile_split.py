"""The measured FIXPOINT/SEARCH split (``turbo_tpu_torch/solver/
profile_split.py``) against the JAX package's (``turbo_tpu/solver/
profile_split.py``).

The attribution is checked on synthetic span lists, each span tagged
with its kind where it is made: a stamped step entry split by its clock
stamps, the ``vd`` propagation (transposes included) as FIXPOINT, K2,
K3, K6 and K7 as OTHER, nothing attributable as None; and on the spans a
profiled chunk makes in each propagation mode (``step_cuda._enqueue``,
its kernels and events stubbed). Then one solve on each side with the
cap pinned, the table off and steal and resplit stubbed out (wall-clock
timed): golomb(7), D=64, chunks of 32, where JAX's second chunk takes
about 0.4 s of CPU time, above its 0.15 s gate, and the run has chunks
left to profile. Both measure the split; every search statistic is
equal; the port's fraction lies in (0, 1) and ``fixpoint_time +
search_time`` is the device time over D. With
``TURBO_TPU_PROFILE_SPLIT=0`` neither measures. (golomb(8) at D=64 and
chunks of 128 also opens JAX's gate, but the port's plain step takes
minutes there on the CPU.) The stamped step entries themselves run only
on the card (``cuda``-marked, and ``chip_smoke.py`` 3b).
"""
import functools
from types import SimpleNamespace

import pytest
import torch

import chip_smoke

from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.fzn import parse_fzn_text as jax_parse
from turbo_tpu.solver.engine import BatchedSolver as JaxSolver
from turbo_tpu.solver.engine import EngineConfig as JaxConfig
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.instances import GOLOMB_OPT, golomb
from turbo_tpu_torch.solver import profile_split
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.engine import BatchedSolver
from turbo_tpu_torch.solver.profile_split import (FIXPOINT, OTHER, STAMPED,
                                                   Event, fraction)

# Kernel names as CUPTI reports them (demangled, with their arguments):
# ``chip_smoke.kernel_kind`` gives torch.profiler's kernels the kinds that
# ``step_cuda`` tags their launches with, for 3b's cross-check.
K1 = "fixpoint_kernel(PlanView, int const*, int const*, int*, int*, int*)"
K1_STEP = "fixpoint_step_kernel(PlanView, int const*, int const*, StepOut)"
K1_STAMPED = ("fixpoint_step_stamped_kernel(PlanView, int const*, StepOut, "
              "long long*)")
K8 = "void wac1_kernel<false, true>(PlanView, int const*, int const*)"
K8_STEP = "void wac1_kernel<true, true>(PlanView, int const*, int const*)"
K8_STAMPED = "void wac1_step_stamped_kernel<true>(PlanView, long long*)"
HEAD = "step_head_kernel(StepView, int const*, int const*)"
POST = "step_post_kernel(StepView, int const*, int*, int)"
HEAD_TIMED = "step_head_timed_kernel(StepView, int const*, int const*, long*)"
POST_TIMED = "step_post_timed_kernel(StepView, int const*, int*, int, long*)"
LIVE = "step_live_kernel(StepView, int*)"
COPY = "step_copy_kernel(StepView, int const*)"
K2 = "classify_kernel(PlanView, int const*, int const*, unsigned char*)"
K3 = "select_kernel(PlanView, int const*, int const*, int const*)"
TRANSPOSE = ("void at::native::elementwise_kernel<128, 4, at::native::"
             "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda>>"
             "(int, at::native::gpu_kernel_impl_nocast)")
FILL = "void at::native::vectorized_elementwise_kernel<4, FillFunctor<long>>"


def _chunk(steps=2, entry=STAMPED):
    """A chunk's spans: K7 live, per step K6 head, the step entry and K6
    post, K7 copy."""
    ev = [Event(OTHER, 2.0)]
    for _ in range(steps):
        ev += [Event(OTHER, 10.0), Event(entry, 300.0), Event(OTHER, 15.0)]
    return ev + [Event(OTHER, 3.0)]


@pytest.mark.parametrize("entry", [K1_STAMPED, K8_STAMPED])
def test_stamped_step_entry_split_by_its_stamps(entry):
    """The stamped launch's time splits by the sweeps' share of the summed
    cycles (K1's and K8's step entries alike, STAMPED by name too); K6
    and K7 are OTHER; a span of no kind is left out."""
    assert chip_smoke.kernel_kind(entry) == STAMPED
    for name in (K1_STEP, K8_STEP, FILL):  # unstamped: not the chunks'
        assert chip_smoke.kernel_kind(name) is None
    ev = _chunk() + [Event(None, 50.0)]
    got = fraction(ev, stamps=(9000, 1000))
    fix = 0.9 * 600.0
    assert got == pytest.approx(fix / (2 + 3 + 2 * (10 + 300 + 15)))
    assert fraction(ev, stamps=(1, 0)) == pytest.approx(
        600.0 / (2 + 3 + 2 * (10 + 300 + 15)))


@pytest.mark.parametrize("prop", [K1, K8])
def test_vd_transposes_and_propagation_launches_are_fixpoint(prop):
    """Under ``fixed``/``vd`` the propagation is a span of its own
    (under ``vd`` with the four transposing copies inside), all
    FIXPOINT whatever the stamps; K2 and K3 as launches of their own,
    and K6, K7, OTHER. By name, K1's fixpoint kernel and K8's outside
    its step entry are FIXPOINT; a torch copy is none of the step's."""
    assert chip_smoke.kernel_kind(prop) == FIXPOINT
    assert chip_smoke.kernel_kind(TRANSPOSE) is None
    ev = [Event(OTHER, 2.0)]
    for _ in range(3):
        ev += [Event(OTHER, 10.0), Event(FIXPOINT, 4 * 5.0 + 200.0),
               Event(OTHER, 8.0), Event(OTHER, 7.0), Event(OTHER, 15.0)]
    ev.append(Event(OTHER, 3.0))
    fix = 3 * (4 * 5.0 + 200.0)
    other = 2.0 + 3.0 + 3 * (10.0 + 8.0 + 7.0 + 15.0)
    for stamps in ((0, 0), (5, 5)):
        assert fraction(ev, stamps) == pytest.approx(fix / (fix + other))


def test_k2_k3_k6_k7_are_other_and_torch_kernels_by_range():
    """OTHER spans count whole to SEARCH, FIXPOINT spans to FIXPOINT; on
    the CPU the "fixpoint" ranges are FIXPOINT and the "step" ranges'
    time outside them OTHER (``host_events`` on the profiler's raw
    events; other ranges left out). By name, K2, K3, K6 (timed or not)
    and K7 are OTHER."""
    for name in (HEAD, POST, HEAD_TIMED, POST_TIMED, LIVE, COPY, K2, K3):
        assert chip_smoke.kernel_kind(name) == OTHER, name
    assert fraction([Event(OTHER, 5.0)]) == 0.0
    assert fraction([Event(FIXPOINT, 5.0)]) == 1.0

    class Raw:
        def __init__(self, name, ns):
            self._name, self._ns = name, ns

        def name(self):
            return self._name

        def duration_ns(self):
            return self._ns

    raw = [Raw("step", 100), Raw("fixpoint", 70), Raw("aten::add", 9),
           Raw("step", 50), Raw("fixpoint", 20)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: raw)))
    ev = profile_split.host_events(prof)
    assert ev == [Event(FIXPOINT, 90), Event(OTHER, 60)]
    assert fraction(ev) == pytest.approx(0.6)


@pytest.mark.parametrize("case", ["empty", "unstamped", "no_range",
                                  "zero_stamps"])
def test_nothing_attributable_gives_none(case):
    """Stamped step entries without stamps, spans of no kind, and spans
    of no time cannot be attributed; with nothing else the fraction is
    None."""
    ev = {"empty": [],
          "unstamped": [Event(STAMPED, 300.0), Event(STAMPED, 300.0)],
          "no_range": [Event(None, 4.0), Event("transposes", 5.0)],
          "zero_stamps": [Event(STAMPED, 300.0), Event(FIXPOINT, 0.0),
                          Event(OTHER, 0.0)]}[case]
    assert fraction(ev, stamps=(0, 0)) is None


def test_enabled_reads_the_environment(monkeypatch):
    monkeypatch.delenv("TURBO_TPU_PROFILE_SPLIT", raising=False)
    assert profile_split.enabled()
    monkeypatch.setenv("TURBO_TPU_PROFILE_SPLIT", "0")
    assert not profile_split.enabled()
    monkeypatch.setenv("TURBO_TPU_PROFILE_SPLIT", "1")
    assert profile_split.enabled()


KW = dict(num_dives=64, use_table=False, fp_cap_auto=False)
CHUNK = 32
STATS = ("status", "objective", "exhaustive", "nodes", "fails", "solutions",
         "fixpoint_iterations", "depth_max")


@functools.lru_cache(maxsize=None)
def _pair():
    """One JAX and one port solver on golomb(7), shared by the tests (the
    JAX step program compiles once)."""
    text = golomb(7)
    js = JaxSolver(jax_compile(jax_parse(text)),
                   JaxConfig(fp_layout="dv", **KW))
    ts = BatchedSolver(compile_model(parse_fzn_text(text)),
                       EngineConfig(**KW), device="cpu")
    for s in (js, ts):
        s._steal_open_branches = lambda *a, **k: None
        s._tail_resplit = lambda *a, **k: None
    return js, ts


@pytest.fixture(scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("split", ["1", "0"], ids=["profiled", "off"])
def test_measured_split_matches_jax(split, monkeypatch, _one_torch_thread):
    monkeypatch.setenv("TURBO_TPU_PROFILE_SPLIT", split)
    js, ts = _pair()
    rj = js.solve(chunk=CHUNK)
    rt = ts.solve(chunk=CHUNK)
    for k in STATS:
        assert getattr(rt, k) == getattr(rj, k), k
    assert (rt.status, rt.objective) == ("optimal", GOLOMB_OPT[7])
    measured = split == "1"
    assert rj.timer_split_measured is measured
    assert rt.timer_split_measured is measured
    D = KW["num_dives"]
    device_time = rt.cumulative_time_block_sec / D
    assert rt.fixpoint_time + rt.search_time == pytest.approx(
        device_time / D, rel=1e-9)
    if measured:
        frac, wall, fit = ts.last_split
        assert 0 < frac < 1 and wall > 0 and fit is not None
        assert rt.fixpoint_time == pytest.approx(frac * device_time / D,
                                                 rel=1e-9)
    else:
        assert ts.last_split is None


def test_host_profile_of_plain_steps(_one_torch_thread):
    """The CPU route: every plain step is a "step" range holding one
    "fixpoint" range, so a profile of a few steps measures a fraction in
    (0, 1); the profiled steps are ``run_steps``' (no stamps)."""
    _, ts = _pair()
    st = ts.init_state()
    ref, ran = ts.run_steps(ts.init_state(), 3)
    got = []

    def chunk():
        nonlocal st
        st, n, cycles = ts._profiled_steps(st, 3, 0)
        got.append((int(n), cycles))
        return cycles

    frac = profile_split.measure_fixpoint_fraction(chunk, reps=1)
    assert 0 < frac < 1
    assert got == [(int(ran), None)]
    for f in ("lb", "ub", "nodes", "fpit", "phase"):
        assert torch.equal(getattr(st, f), getattr(ref, f)), f


# The propagation span's kind by configuration, in a profiled chunk.
PROPAGATION = {"fixpoint": STAMPED, "wac1": STAMPED, "fixed": FIXPOINT,
               "vd": FIXPOINT}


@pytest.mark.parametrize("mode", sorted(PROPAGATION))
def test_profiled_chunk_launch_sequence(mode, monkeypatch):
    """A profiled chunk (``step_cuda._enqueue`` with stamps and spans)
    launches what an ordinary chunk does, with the same live words, but
    the stamped step entry in place of K1's or K8's step entry (step i
    writing ``stamps[i]``) and K6's timed head and post, each given a row
    of ``Spans.ns`` for the span it writes itself; the launches with no
    timed form (under ``fixed`` and ``vd``: the propagation, the ``vd``
    copies inside its span, K2 and K3) have a CUDA event before and
    after; K7's are not timed. Each span is tagged by what the launch
    does, so that ``Spans.events`` gives each launch's time by kind."""
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.solver import step_cuda
    kw = {"vd": dict(fp_layout="vd"), "fixed": dict(fp_mode="fixed"),
          "wac1": dict(fp_mode="wac1"), "fixpoint": {}}[mode]
    s = BatchedSolver(compile_model(parse_fzn_text(golomb(5))),
                      EngineConfig(num_dives=4, fp_cap_auto=False, **kw),
                      device="cpu")
    st = s.init_state()
    s.kernels._kernel_plan = SimpleNamespace(smem_limit=48 * 1024)
    n = 3
    stamps = torch.zeros((n, 4, 2), dtype=torch.int64)
    calls, order = [], []

    class Ev:
        def record(self):
            self.at = len(order)
            order.append("event")

        def elapsed_time(self, end):
            return float(end.at - self.at)

    def rec(name, *words, span=None):
        calls.append((name,) + words + (span,))
        order.append(name)
        if span is not None:  # what a timed launch writes: 2 ms
            span.copy_(torch.tensor([5_000_000, 7_000_000]))

    class Prop:
        def scratch(self, kp, D):
            return None

        def step_stamped(self, kp, lb, ub, cap, *rest, live, out):
            assert lb is st.lb and ub is st.ub and len(out) == 15
            assert rest[-3] is s._ws.strat0
            rec("step_stamped", live, rest[-2], span=rest[-1])

        def fixed_sweeps(self, kp, lb, ub, k, live, out):
            rec("fixed_sweeps", live)

        def transposed(self, kp, lbT, ubT, cap, live, out):
            assert lbT is s._ws.lbT and ubT is s._ws.ubT
            rec("transposed", live)

    monkeypatch.setattr(kernels, "fixpoint", Prop())
    monkeypatch.setattr(kernels, "wac1", Prop())
    monkeypatch.setattr(torch.cuda, "Event", lambda **k: Ev())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: (
        SimpleNamespace(synchronize=lambda: None)))
    ws = s._ws = step_cuda.Workspace(s, st.phase.shape[0])
    for k, e in (("step_tail", "live"), ("step_tail", "copy")):
        monkeypatch.setattr(getattr(kernels, k), e,
                            lambda sv, live, dev, e=e: rec(e, live))
    monkeypatch.setattr(kernels.step, "head",
                        lambda sv, prev, live, dev, span: rec(
                            "head", prev, live, span=span))
    monkeypatch.setattr(kernels.step, "post",
                        lambda sv, live, nxt, dev, smem, span: rec(
                            "post", live, nxt, span=span))
    monkeypatch.setattr(kernels, "classify",
                        lambda kp, lb, ub, live, out: rec("classify", live))
    monkeypatch.setattr(kernels, "select",
                        lambda kp, lb, ub, strat, live, out: rec("select",
                                                                 live))
    spans = step_cuda.Spans(n, "cpu")
    step_cuda._enqueue(s, st, None, n, 16, stamps, spans)
    w = ws.live
    alone = mode in ("fixed", "vd")
    prop = {"fixed": "fixed_sweeps", "vd": "transposed"}.get(
        mode, "step_stamped")
    per_step = ["head", prop] + (["classify", "select"] if alone else []) \
        + ["post"]
    assert [c[0] for c in calls] == ["live"] + per_step * n + ["copy"]
    for i in range(n):
        at = 1 + len(per_step) * i
        cur, nxt = w[i % 2], w[1 - i % 2]
        head, pr, post = calls[at], calls[at + 1], calls[at + len(
            per_step) - 1]
        assert head[2] is cur and head[1] is (w[1 - i % 2] if i else None)
        assert pr[1] is cur and post[1] is cur and post[2] is nxt
        if prop == "step_stamped":
            assert pr[2].data_ptr() == stamps[i].data_ptr()
    # The timed launches get rows of ns in launch order; K7 none.
    timed = [c for c in calls if c[-1] is not None]
    assert [c[0] for c in timed] == [x for x in per_step
                                     if x in ("head", "post",
                                              "step_stamped")] * n
    assert [c[-1].data_ptr() for c in timed] == [
        spans.ns[i].data_ptr() for i in range(len(timed))]
    # Events around the launches with no timed form only.
    evented = {"fixed_sweeps", "transposed", "classify", "select"}
    assert order == [x for c in calls for x in (
        ("event", c[0], "event") if c[0] in evented else (c[0],))]
    kinds = [kind for kind, _ in spans.spans]
    per_step = ([OTHER, PROPAGATION[mode]] + [OTHER] * (2 if alone else 0)
                + [OTHER])
    assert kinds == per_step * n
    events = spans.events()
    assert [e.kind for e in events] == kinds
    assert all(e.dur == 2.0 for e in events)  # the launch alone, in ms


def test_card_measure_sums_chunks_and_warns_on_nothing(capsys):
    """On the card each chunk returns its launches and stamp cycles; the
    fraction is over all of them. A chunk that timed no kernel leaves
    None and a warning line."""
    chunks = iter([(_chunk(), (900, 100)), (_chunk(), (800, 200))])
    got = profile_split.measure_fixpoint_fraction(lambda: next(chunks),
                                                  cuda=True)
    total = 2 * (2 + 3 + 2 * (10 + 300 + 15))
    assert got == pytest.approx(0.85 * 1200.0 / total)
    assert capsys.readouterr().err == ""
    assert profile_split.measure_fixpoint_fraction(
        lambda: ([], (0, 0)), cuda=True) is None
    assert capsys.readouterr().err.startswith(
        "% warning: the measured chunks timed no kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("fixpoint", "wac1"))
def test_cuda_stamped_chunk_equals_chunk(mode):
    """On the card: a profiled chunk (the stamped step entries, K6's
    timed entries) leaves the state an uncaptured chunk of the step
    entries leaves, and every launch that ran wrote positive stamps and
    a span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses

    from turbo_tpu_torch.solver import step_cuda
    s = BatchedSolver(compile_model(parse_fzn_text(golomb(8))),
                      EngineConfig(num_dives=64, fp_cap_auto=False,
                                   fp_mode=mode), device="cuda:0")
    a = s.init_state()
    b = dataclasses.replace(a, **{f.name: getattr(a, f.name).clone()
                                  for f in dataclasses.fields(a)})
    stamps = torch.zeros((8, 64, 2), dtype=torch.int64, device="cuda:0")
    spans = step_cuda.Spans(8, "cuda:0")
    ran = int(step_cuda.run(s, a, 8, 16, stamps=stamps, spans=spans))
    assert ran == int(step_cuda.run(s, b, 8, 16, graph=False)) > 0
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert bool((stamps[:ran] > 0).all())
    assert all(e.dur > 0 for e in spans.events()[:3 * ran])
