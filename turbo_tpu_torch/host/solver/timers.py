"""Per-phase solve timers (statistics.hpp:13-29 Timer enum parity).

The reference instruments its solve loop with per-block device timers
(TIMEPOINT macro, barebones_dive_and_solve.hpp:615-618) and reports
them `meet`-merged across blocks (statistics.hpp:330-371).  Our step
function is one fused XLA program, so phases cannot be bracketed with
clocks inside it; instead every timer is derived from host-side
measurements that are cheap and exact at chunk granularity:

* device_time   - wall time the device spends executing step chunks
                  (dispatch -> block_until_ready), the analog of the
                  per-block OVERALL device timer;
* transfer times - measured around `jax.device_get` / the initial
                  state `device_put`;
* FIXPOINT vs SEARCH split - least-squares fit of the per-chunk device
                  time against the per-chunk fixpoint-iteration count
                  (the engine tracks iterations exactly in traced
                  state): chunk_time ~= a + b * iterations gives
                  fixpoint_time = b * total_iterations.  This is a
                  measurement-based attribution, not a guess: `b` is
                  the marginal cost of one AC-1 sweep on this instance
                  and hardware.
* DIVE share    - lane-steps observed in the DIVE phase vs active
                  lane-steps (phases are fetched every chunk anyway).
* WAIT_CPU      - host time not covered by device execution or
                  transfers (the inverse of the reference's meaning -
                  there the device waits for the host; in our pull
                  model the host drives the device, so this is host
                  overhead between chunks).
* SELECT_FP_FUNCTIONS - the entailment `select` is fused into the
                  propagation program (no separate pass), so this
                  timer is structurally zero here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

DIVE, SOLVE, IDLE = 0, 1, 2


@dataclasses.dataclass
class PhaseTimers:
    num_lanes: int
    device_time: float = 0.0
    transfer_c2g: float = 0.0
    transfer_g2c: float = 0.0
    first_idle: Optional[float] = None
    dive_steps: int = 0
    act_steps: int = 0
    # Profiler-measured fixpoint fraction of device time (solver/
    # profile_split.py); when set, it overrides the LSQ fit below.
    measured_fix_frac: Optional[float] = None
    _samples: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    _last_fpit: int = 0

    def record_chunk(self, device_dur: float, fpit_total: int,
                     phase: np.ndarray, chunk: int, now: float,
                     measured: bool = True):
        """Account one executed chunk of `chunk` steps.

        `phase` is the lane phase vector observed at chunk end,
        `fpit_total` the cumulative fixpoint iterations over all lanes.
        `measured=False` (the compile/load warm-up chunk) tracks phase
        progress but keeps the duration out of the time attribution.
        """
        delta = int(fpit_total) - self._last_fpit
        self._last_fpit = int(fpit_total)
        if measured:
            self.device_time += device_dur
            self._samples.append((delta, device_dur))
        dive = int((phase == DIVE).sum())
        act = int((phase != IDLE).sum())
        self.dive_steps += dive * chunk
        self.act_steps += act * chunk
        if self.first_idle is None and (phase == IDLE).any():
            self.first_idle = now

    # -- attribution ---------------------------------------------------

    def fixpoint_search_split(self) -> Tuple[float, float]:
        """(fixpoint_time, search_time): profiler-measured split when
        available, else the regression fit (see module docstring)."""
        if self.measured_fix_frac is not None:
            fix = self.measured_fix_frac * self.device_time
            return fix, self.device_time - fix
        if not self._samples:
            return 0.0, 0.0
        xs = np.array([s[0] for s in self._samples], dtype=np.float64)
        ys = np.array([s[1] for s in self._samples], dtype=np.float64)
        total_iters = float(xs.sum())
        fixpoint = 0.0
        if len(xs) >= 2 and np.ptp(xs) > 0:
            A = np.stack([np.ones_like(xs), xs], axis=1)
            (a, b), *_ = np.linalg.lstsq(A, ys, rcond=None)
            if b > 0:
                fixpoint = min(b * total_iters, self.device_time)
        elif total_iters > 0:
            # Constant iteration count per chunk (e.g. fixed-sweeps
            # mode): the intercept is unobservable; attribute all
            # device time to the fixpoint, which dominates there.
            fixpoint = self.device_time
        return fixpoint, self.device_time - fixpoint

    def dive_time(self) -> float:
        if self.act_steps == 0:
            return 0.0
        return self.device_time * self.dive_steps / self.act_steps

    def fill_result(self, res, solve_time: float):
        """Populate EngineResult timer fields (reference stat names,
        statistics.hpp:338-371)."""
        fixpoint, search = self.fixpoint_search_split()
        D = max(self.num_lanes, 1)
        res.timer_split_measured = self.measured_fix_frac is not None
        res.num_blocks = self.num_lanes
        res.search_time = search / D
        res.fixpoint_time = fixpoint / D
        res.dive_time = self.dive_time() / D
        res.transfer_cpu2gpu_time = self.transfer_c2g / D
        res.transfer_gpu2cpu_time = self.transfer_g2c / D
        res.select_fp_functions_time = 0.0
        res.wait_cpu_time = max(
            solve_time - self.device_time - self.transfer_g2c, 0.0) / D
        res.first_block_idle_time = (
            self.first_idle if self.first_idle is not None else solve_time)
        # Lockstep lanes are all busy while the device runs: the summed
        # per-block busy time is lanes x device wall time.
        res.cumulative_time_block_sec = self.device_time * self.num_lanes
        if res.cumulative_time_block_sec > 0:
            # Reference formula exactly (statistics.hpp:357):
            # num_deductions / num_blocks / to_sec(cumulative_time_block).
            res.deductions_per_block_second = (
                res.num_deductions / D / res.cumulative_time_block_sec)
        return res
