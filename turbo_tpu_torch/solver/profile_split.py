"""Measured FIXPOINT/SEARCH timer attribution (statistics.hpp:83-130).

The port's counterpart of ``turbo_tpu/solver/profile_split.py``. The
reference brackets its solve phases with per-block device clocks
(TIMEPOINT, barebones_dive_and_solve.hpp:615-618); the JAX package tags
its propagation with ``jax.named_scope("fixpoint")`` and splits a
profile's per-op device time by that scope. Here ``BatchedSolver.solve``
measures, once a run, two real chunks, and this module splits what they
took. Each measured span carries its kind (``Event.kind``), set where
the span is made:

- on the card, ``step_cuda`` runs each measured chunk as a CUDA graph of
  its own, so that its launches run back to back, and its launches time
  themselves (``step_cuda.Spans``): the stamped step entries and K6's
  timed head and post write their span on the global timer (the first
  block's start, the last block's end), without the graph's time between
  launches, which CUDA events around each launch would add to it (a
  profiler's kernel time lies between the two: it also holds the
  launch's start-up and drain). The launches with no timed form, under
  ``fixed`` and ``vd`` only (the propagation, K2 and K3 as launches of
  their own), are timed by CUDA events around them; K7's two launches a
  chunk are not timed. FIXPOINT is what JAX's
  scope holds: K1's ``fixed_sweeps`` and ``transposed`` entries (the
  latter's span with the four transposing copies around it, which JAX's
  scope holds too). OTHER is K6 head and post, and K2 and K3 as
  launches of their own. A fused step entry (K1's or K8's: the
  fixpoint, then K2's and K3's bodies) is one launch, so the measured
  chunks launch its stamped form (``kernels.fixpoint.step_stamped``),
  whose blocks read the SM's clock before and after the epilogue:
  STAMPED, its time split by the summed cycles, the sweeps and the row
  write FIXPOINT, the epilogue (K2's and K3's bodies, outside JAX's
  scope) OTHER. ``torch.profiler`` gives the kernels' times too, but its
  first start in a process took 7.9-15.8 s on an H100 (NVIDIA H100 80GB
  HBM3, 700 W), more than a short ``-t`` run has; ``chip_smoke.py`` 3b
  holds the two to each other;
- on the CPU, the chunks run under ``torch.profiler``: every plain step
  runs in a "step" range and its propagation
  (``BatchedSolver.propagate``, the ``vd`` transposes included) in a
  "fixpoint" range; the second is FIXPOINT, the first outside it OTHER.

The result is the fixpoint fraction of the measured time, which
``PhaseTimers.measured_fix_frac`` turns into ``fixpoint_time`` and
``search_time`` in place of its least-squares fit.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

# The profiler ranges of a step and of its propagation (JAX's scope name).
SCOPE = "fixpoint"
STEP = "step"
# The device time, summed over the chunks after the first, that a run has
# to reach before its measured chunks (JAX profiles after one chunk of at
# least 0.15 s; a chunk on the card is a few ms, so the sum counts here).
MIN_DEVICE_S = 0.15

# The kinds of a measured span: FIXPOINT, OTHER, or a stamped step
# entry's, split by its clock stamps.
FIXPOINT, OTHER, STAMPED = "fixpoint", "other", "stamped"


def enabled() -> bool:
    return os.environ.get("TURBO_TPU_PROFILE_SPLIT", "1") != "0"


@dataclasses.dataclass
class Event:
    """A measured span of kind ``FIXPOINT``, ``OTHER`` or ``STAMPED``: a
    launch's device time on the card, a profiler range's own time on the
    CPU."""
    kind: str
    dur: float


def fraction(events, stamps=(0, 0)) -> Optional[float]:
    """The FIXPOINT fraction of the attributable time of ``events``;
    ``stamps``: (sweep cycles, epilogue cycles) summed over the stamped
    launches, which split the STAMPED spans. None when nothing is
    attributable (no time; STAMPED spans without stamps)."""
    total = sum(stamps)
    shares = {FIXPOINT: 1.0, OTHER: 0.0,
              STAMPED: stamps[0] / total if total > 0 else None}
    fix = other = 0.0
    for ev in events:
        share = shares.get(ev.kind)
        if share is None or ev.dur <= 0:
            continue
        fix += share * ev.dur
        other += (1.0 - share) * ev.dur
    if fix + other <= 0:
        return None
    return fix / (fix + other)


def host_events(prof):
    """The CPU profile's ranges, from the profiler's raw events (a plain
    step records thousands of torch ops, too many to build the profiler's
    event tree for): the "fixpoint" ranges' time as FIXPOINT, and the
    "step" ranges' time outside them as OTHER (every "fixpoint" range
    lies in a "step" range)."""
    ns = {SCOPE: 0, STEP: 0}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in ns:
            ns[name] += e.duration_ns()
    return [Event(FIXPOINT, ns[SCOPE]), Event(OTHER, ns[STEP] - ns[SCOPE])]


def measure_fixpoint_fraction(run_chunk, reps: int = 2,
                              cuda: bool = False) -> Optional[float]:
    """Run ``run_chunk()`` ``reps`` times and return the FIXPOINT fraction
    of their time, or None when nothing attributable was measured.
    ``cuda``: the chunks run on the card, and each returns (its launches
    as ``Event``s, the (sweep, epilogue) cycles its stamped launches
    summed); a card chunk that measured nothing prints a warning on
    stderr. Else the chunks run on the CPU under ``torch.profiler``."""
    if cuda:
        events, cycles = [], [0, 0]
        for _ in range(reps):
            evs, (sweep, epi) = run_chunk()
            events += evs
            cycles = [cycles[0] + int(sweep), cycles[1] + int(epi)]
        frac = fraction(events, tuple(cycles))
        if frac is None:
            print("% warning: the measured chunks timed no kernel; "
                  "fixpoint_time and search_time stay the least-squares "
                  "fit", file=sys.stderr, flush=True)
        return frac
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            run_chunk()
    return fraction(host_events(prof))
