"""Batched EPS dive-and-solve engine in PyTorch.

Port of ``turbo_tpu/solver/engine.py``: D dives advance in lockstep,
one search node per ``step``, on (D, ·) tensors on one device.

On a CUDA state a step is three kernel launches and no host read:
K6 ``step.head`` (the previous step's refill and ring rows, promote,
objective tighten) -> K1's step entry (the fixpoint, then K2 classify
and K3 select in the same blocks) -> K6 ``step.post`` (the per-lane rest
of the step, then in each shard's last block the cross-lane prefix
counts of the refill and the solution ring), all updating the state in
place. By ``fp_mode`` and ``fp_layout`` the propagation is K1's
fixed-sweeps or transposed entry or K8 WAC1 instead, followed by K2 and
K3 as launches of their own (five a step).
``run_steps`` enqueues a whole chunk of n steps as 3n + 2 launches (K7
``step_tail.live`` before them, K7 ``step_tail.copy`` with the last
step's rows after them): each kernel returns at once when the device
flag ``live`` says every lane was IDLE, as the JAX ``while_loop``
stops, and a device counter counts the steps that ran. On a CPU state ``step_plain`` runs the same step as
plain torch ops; it is the specification the kernels are held to.

With ``use_table`` (the default) the EPS subproblem roots come from a
table built once on the device (``solver/eps_table.py``) and refills
enter SOLVE phase directly; otherwise lanes re-dive their bit-path from
the root. ``enumerate_all`` counts every all-singleton store, and with
``sol_ring_size`` > 0 each accepted solution is appended to an
on-device ring that ``solve`` drains through ``on_solution`` once per
chunk. ``solve`` calibrates the fixpoint cap live
(``AutoCapCalibrator``) and, once the subproblem range is drained,
steals open branches for idle lanes or resplits the stragglers, in
place: on a CUDA state a steal round is K5 (the count and the plan) and
K9 (the steals) with one host read of the count, and a resplit one read
of subp and kpow. The fixpoint cap is a host integer that ``solve``
owns and passes to ``step``. Once a run, ``solve`` measures the
FIXPOINT/SEARCH split of the device time on two real chunks
(``solver/profile_split.py``), and it stops at a hard wall of
``TURBO_TPU_HARD_WALL_MULT`` times ``-t``, which also counts the kernel
build.

``step`` consumes its input state: the decision stacks (D, MAXD) are
updated in place (the JAX step donates its input the same way); on the
CPU every other field of the returned state is a new tensor.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import torch

from .. import trace
from ..host.core.ops import INF, NINF
from ..host.solver import strategy as _strategy
from ..host.solver.plan import build_plan
from .config import (EngineConfig, apply_strategy_config, auto_max_depth,
                     choose_subproblems_power)
from .convert import DevicePlan
from ..device import pick_device
from .propagate import PropagatorKernels

I32 = torch.int32
F32 = torch.float32
DIVE, SOLVE, IDLE = 0, 1, 2
_STACKS = ("dec_var", "dec_l0", "dec_u0", "dec_l1", "dec_u1", "dec_rope1",
           "dec_cur")
# The fields a steal round reads or writes.
STEAL_FIELDS = ("phase", "subp", "kpow", "remaining", "depth", "strat",
                "snap_strat", "lb", "ub", "root_lb", "root_ub") + _STACKS


@dataclasses.dataclass
class SearchState:
    lb: torch.Tensor          # (D, V) current store
    ub: torch.Tensor
    root_lb: torch.Tensor     # (D, V) subproblem root snapshot
    root_ub: torch.Tensor
    best_lb: torch.Tensor     # (D, V) per-dive best solution store
    best_ub: torch.Tensor
    best_bound: torch.Tensor  # (D,) per-dive bound (INF = none); minimization
    has_best: torch.Tensor    # (D,) bool
    dec_var: torch.Tensor     # (D, MAXD) decision stacks
    dec_l0: torch.Tensor      # left child interval
    dec_u0: torch.Tensor
    dec_l1: torch.Tensor      # right child interval
    dec_u1: torch.Tensor
    dec_rope1: torch.Tensor   # rope of the right child
    dec_cur: torch.Tensor     # current child (0/1)
    depth: torch.Tensor       # (D,)
    phase: torch.Tensor       # (D,) DIVE/SOLVE/IDLE
    remaining: torch.Tensor   # (D,) remaining dive depth
    subp: torch.Tensor        # (D,) current subproblem index
    strat: torch.Tensor       # (D,) strategy cursor
    snap_strat: torch.Tensor
    next_sub: torch.Tensor    # (D,) next subproblem counter (replicated)
    nonexh: torch.Tensor      # (D,) bool: search not exhaustive
    nodes: torch.Tensor
    fails: torch.Tensor
    sols: torch.Tensor
    fpit: torch.Tensor
    deds: torch.Tensor        # (D,) float32
    dmax: torch.Tensor
    solved_sub: torch.Tensor
    skipped_sub: torch.Tensor
    kpow: torch.Tensor        # (D,) per-lane subproblem power
    sub_limit: torch.Tensor
    pscale: torch.Tensor      # (D,) float32 live propagators per sweep
    eps_strat: torch.Tensor
    ext_bound: torch.Tensor   # (D,) INF: one device, no remote incumbent
    # EPS subproblem-root table (solver/eps_table.py): refills gather a
    # leaf row and enter SOLVE phase. (1, V) / (1,) placeholders in
    # dive mode.
    tab_lb: torch.Tensor      # (n_pad, V) int32
    tab_ub: torch.Tensor
    tab_strat: torch.Tensor   # (n_pad,) int32 post-dive strategy cursor
    tab_path: torch.Tensor    # (n_pad,) int32 subproblem bit-path
    # Solution ring (R, V), R = max(1, sol_ring_size), and its write
    # counter (D,), replicated: accepted solution stores in device order.
    sol_ring: torch.Tensor
    sol_w: torch.Tensor


def table_refill_plain(tab_lb, tab_ub, idx, refill, lb, ub, root_lb,
                       root_ub):
    """In place: every lane d with refill[d] takes table row
    clip(idx[d], 0, n_pad - 1) into lb, ub, root_lb and root_ub."""
    i = idx.clamp(0, tab_lb.shape[0] - 1).long()
    m = refill[:, None]
    tl, tu = tab_lb[i], tab_ub[i]
    for dst, src in ((lb, tl), (root_lb, tl), (ub, tu), (root_ub, tu)):
        dst.copy_(torch.where(m, src, dst))


# Seconds between two heartbeat lines while the kernels build.
HEARTBEAT_S = 20.0


@contextlib.contextmanager
def heartbeat(interval: float = 0.0):
    """While the block runs, a daemon thread prints a progress line on
    stderr every ``interval`` seconds (0: ``HEARTBEAT_S``): a cold nvcc
    build takes many seconds, and a silent gap looks like a hang (the
    JAX loop's compile heartbeat, ``turbo_tpu/solver/engine.py:
    1500-1516``). The thread stops when the block returns or raises."""
    every = interval or HEARTBEAT_S
    done = threading.Event()
    t0 = time.monotonic()

    def beat():
        while not done.wait(every):
            print(f"% building the CUDA kernels... "
                  f"({time.monotonic() - t0:.0f}s; one-time cost, cached "
                  f"for later runs)", file=sys.stderr, flush=True)

    th = threading.Thread(target=beat, name="turbo-tpu-heartbeat",
                          daemon=True)
    th.start()
    try:
        yield
    finally:
        done.set()
        th.join()


def warm_kernels(solver) -> float:
    """On the card: builds the kernels (at first use, ``build_time``),
    then does for ``solver``'s plan what their first launches would do
    (``kernels.warm_up``), so that both count in the solver's setup (the
    CLI's ``initTime``) and not inside the ``-t`` window or its hard
    wall; a ``heartbeat`` runs meanwhile. Returns the warm-up's seconds
    (0.0 on the CPU)."""
    if solver.device.type != "cuda":
        return 0.0
    from .. import kernels
    with heartbeat():
        t0 = time.monotonic()
        kernels.load()
        solver.build_time = time.monotonic() - t0
        t0 = time.monotonic()
        kernels.warm_up(solver.kernels)
    return time.monotonic() - t0


def table_refill(tab_lb, tab_ub, idx, refill, lb, ub, root_lb, root_ub):
    if lb.is_cuda:
        from ..kernels import table_refill as k_refill
        return k_refill(tab_lb, tab_ub, idx, refill, lb, ub, root_lb,
                        root_ub)
    if lb.device.type != "cpu":
        raise RuntimeError(f"no table refill for device {lb.device}")
    return table_refill_plain(tab_lb, tab_ub, idx, refill, lb, ub,
                              root_lb, root_ub)


def _open_entries(dec_cur, depth, phase):
    """(D, MAXD) bool: the open right branches (dec_cur == 0 below depth)
    of the SOLVE-phase stacks."""
    col = torch.arange(dec_cur.shape[1], dtype=I32, device=dec_cur.device)
    live = (phase == SOLVE)[:, None] & (col[None, :] < depth[:, None])
    return (dec_cur == 0) & live


def open_branch_count_plain(dec_cur, depth, phase):
    """0-dim int64: open right branches (dec_cur == 0 below depth) over
    the SOLVE-phase stacks."""
    return _open_entries(dec_cur, depth, phase).sum()


def steal_plan_plain(dec_cur, depth, phase):
    """K5 as plain torch ops: (the open count, 0-dim int64; thief, d0,
    victim, (n,) int32 each): the plan of a steal round, in which the
    r-th IDLE lane takes the r-th open entry (d0, victim) in (depth,
    lane) order, n = min(count, IDLE lanes)."""
    opens = _open_entries(dec_cur, depth, phase)
    entries = torch.nonzero(opens.t())  # (depth, lane), in that order
    thieves = torch.nonzero(phase == IDLE)[:, 0]
    n = min(entries.shape[0], thieves.shape[0])
    return (opens.sum(), thieves[:n].to(I32), entries[:n, 0].to(I32),
            entries[:n, 1].to(I32))


def steal_apply_plain(st, thief, d0, victim):
    """K9 as plain torch ops: the steals (thief, d0, victim) applied to
    the state ``st`` in place, one after another in plan order (the loop
    of ``steal_host``)."""
    depth = st.depth.tolist()  # a victim's depth does not change
    dev = st.depth.device
    for t, d, v in zip(thief.tolist(), d0.tolist(), victim.tolist()):
        dep = depth[v]
        st.dec_cur[v, d] = 1
        if dep > d + 1:
            # rope1[j] = the last i in (d, j] with cur[i - 1] == 0, else
            # rope1[d].
            j = torch.arange(d + 1, dep, dtype=I32, device=dev)
            last = torch.cummax(torch.where(st.dec_cur[v, d:dep - 1] == 0,
                                            j, -1), 0).values
            st.dec_rope1[v, d + 1:dep] = torch.where(last >= 0, last,
                                                     st.dec_rope1[v, d])
        for f in _STACKS:
            x = getattr(st, f)
            x[t, :d + 1] = x[v, :d + 1]
        st.dec_cur[t, d] = 1
        st.dec_rope1[t, d] = -1
        st.dec_l1[v, d] = st.dec_l0[v, d]
        st.dec_u1[v, d] = st.dec_u0[v, d]
        right = st.dec_cur[t, :d + 1] == 1
        var = st.dec_var[t, :d + 1].long()
        lo = torch.where(right, st.dec_l1[t, :d + 1], st.dec_l0[t, :d + 1])
        hi = torch.where(right, st.dec_u1[t, :d + 1], st.dec_u0[t, :d + 1])
        st.lb[t] = st.root_lb[v].scatter_reduce(0, var, lo, "amax")
        st.ub[t] = st.root_ub[v].scatter_reduce(0, var, hi, "amin")
        st.root_lb[t] = st.root_lb[v]
        st.root_ub[t] = st.root_ub[v]
        st.depth[t] = d + 1
        st.phase[t] = SOLVE
        st.remaining[t] = 0
        st.subp[t] = st.subp[v]
        st.kpow[t] = st.kpow[v]
        st.strat[t] = st.snap_strat[v]
        st.snap_strat[t] = st.snap_strat[v]


def steal_host(f, idle) -> int:
    """A steal round as host numpy surgery (``turbo_tpu/solver/engine.py:
    1203-1314``), in place on ``f``, the state's fields by name
    (``STEAL_FIELDS``) as numpy arrays; ``idle``: the IDLE lanes, in
    order. Returns the number of steals. Thieves are IDLE and victims in
    SOLVE phase, so a victim's rows change only by its own steals."""
    # All open entries across SOLVE-phase lanes, shallowest first.
    opens = []
    for v in np.nonzero(f["phase"] == SOLVE)[0]:
        for d in range(int(f["depth"][v])):
            if f["dec_cur"][v, d] == 0:
                opens.append((d, int(v)))
    opens.sort()
    n_steals = 0
    for t in idle:
        if not opens:
            break
        d0, v = opens.pop(0)
        # Close the branch on the victim; cur[d0]=1 alone would corrupt
        # its future rebuilds (it is inside d0's LEFT subtree), so the
        # right-child interval is rewritten to the left child's below.
        # Stored rope1 values above d0 are push-time snapshots: recompute
        # them with the current cur.
        f["dec_cur"][v, d0] = 1
        for d in range(d0 + 1, int(f["depth"][v])):
            f["dec_rope1"][v, d] = (d if f["dec_cur"][v, d - 1] == 0
                                    else f["dec_rope1"][v, d - 1])
        # Seed the thief BEFORE the victim's l1/u1 rewrite so it copies
        # the true right child at d0.
        for s in _STACKS:
            f[s][t, :d0 + 1] = f[s][v, :d0 + 1]
        f["dec_cur"][t, d0] = 1
        f["dec_rope1"][t, d0] = -1
        f["dec_l1"][v, d0] = f["dec_l0"][v, d0]
        f["dec_u1"][v, d0] = f["dec_u0"][v, d0]
        lb = f["root_lb"][v].copy()
        ub = f["root_ub"][v].copy()
        for d in range(d0 + 1):
            var = f["dec_var"][t, d]
            right = f["dec_cur"][t, d] == 1
            lb[var] = max(lb[var], f["dec_l1" if right else "dec_l0"][t, d])
            ub[var] = min(ub[var], f["dec_u1" if right else "dec_u0"][t, d])
        f["lb"][t] = lb
        f["ub"][t] = ub
        f["root_lb"][t] = f["root_lb"][v]
        f["root_ub"][t] = f["root_ub"][v]
        f["depth"][t] = d0 + 1
        f["phase"][t] = SOLVE
        f["remaining"][t] = 0
        f["subp"][t] = f["subp"][v]
        f["kpow"][t] = f["kpow"][v]
        f["strat"][t] = f["snap_strat"][v]
        f["snap_strat"][t] = f["snap_strat"][v]
        n_steals += 1
    return n_steals


def open_branch_count(dec_cur, depth, phase):
    if dec_cur.is_cuda:
        from ..kernels import open_count as k_open_count
        return k_open_count(dec_cur, depth, phase)
    if dec_cur.device.type != "cpu":
        raise RuntimeError(f"no open-branch count for device "
                           f"{dec_cur.device}")
    return open_branch_count_plain(dec_cur, depth, phase)


class AutoCapCalibrator:
    """Live fixpoint-cap calibration (``turbo_tpu/solver/engine.py:
    204-314``): one short sample per candidate cap of an ascending
    ladder, accumulated to ``TURBO_TPU_CAL_SAMPLE_S`` seconds of device
    time or 4 chunks; stops early once a candidate falls below 0.7x the
    best rate, then locks the nodes/s argmax. Sound at any cap (the
    hold rule keeps the search tree the exact fixpoint tree), so every
    calibration chunk is real solve progress. The cap is a host int:
    ``arm`` and ``observe`` return the cap to run next."""

    def __init__(self, cfg, fp_cap_override: int):
        self.rates = {}
        self.active = None
        self.nodes0 = 0
        self.chosen = None
        self.min_sample_s = float(os.environ.get(
            "TURBO_TPU_CAL_SAMPLE_S", "0.4"))
        self.max_sample_chunks = 4
        self.acc_dur = 0.0
        self.acc_chunks = 0
        if (fp_cap_override == 0 and cfg.fp_cap_auto
                and cfg.fp_mode != "fixed"):
            self.caps = [c for c in (2, 3, 4, 8, 16)
                         if c <= cfg.fp_max_iters]
        else:
            self.caps = []
        if self.caps:
            self.active = self.caps[0]

    @property
    def done(self) -> bool:
        return not self.caps

    def arm(self, cap: int) -> int:
        """The first candidate, run from the first chunk on."""
        return self.active if self.caps else cap

    def observe(self, cap: int, tot_nodes: int, device_dur: float,
                warmup: bool, skip: bool = False, verbose: bool = False):
        """Feed one chunk's observation. Returns (cap', chunk_hint):
        chunk_hint is the suggested trip count for the next chunk (None =
        the caller's own choice)."""
        if not self.caps:
            return cap, None
        if warmup or skip:
            # No rate sample: just rebase the counter.
            self.nodes0 = tot_nodes
            self.acc_dur = 0.0
            self.acc_chunks = 0
            return cap, max(2, 32 // self.active)
        self.acc_dur += device_dur
        self.acc_chunks += 1
        if (self.acc_dur < self.min_sample_s
                and self.acc_chunks < self.max_sample_chunks):
            return cap, max(2, 32 // self.active)
        if self.active is not None:
            self.rates[self.active] = (
                (tot_nodes - self.nodes0) / max(self.acc_dur, 1e-6))
        best_rate = max(self.rates.values(), default=0.0)
        nxt = next((c for c in self.caps if c not in self.rates), None)
        declined = (self.active is not None and len(self.rates) >= 2
                    and self.rates[self.active] < 0.7 * best_rate)
        if nxt is not None and not declined:
            self.active = nxt
            self.nodes0 = tot_nodes
            self.acc_dur = 0.0
            self.acc_chunks = 0
            # Equal-ish wall time per sample: a step costs up to `cap`
            # sweeps.
            return nxt, max(2, 32 // nxt)
        best_cap, best_rate = max(self.rates.items(),
                                  key=lambda kv: (kv[1], kv[0]))
        self.chosen = best_cap
        self.caps = []
        self.active = None
        if verbose:
            print(f"% auto fp_cap={best_cap} ({best_rate:,.0f} nodes/s;"
                  " swept "
                  + " ".join(f"{c}:{self.rates[c]:,.0f}"
                             for c in sorted(self.rates)) + ")",
                  flush=True)
        return best_cap, None


class _TorchXP:
    """The one array function ``solver/strategy.py`` needs, for torch."""

    @staticmethod
    def select(conds, choices, default=0):
        out = torch.full_like(choices[0], default) \
            if not torch.is_tensor(default) else default
        for c, v in zip(reversed(conds), reversed(choices)):
            out = torch.where(torch.as_tensor(c, device=out.device), v, out)
        return out


class BatchedSolver:
    def __init__(self, tnf, config: EngineConfig = EngineConfig(),
                 device=None, num_shards: int = 1):
        """``device`` None: the card (``pick_device``; raises without
        CUDA). The CPU runs the plain versions only when asked.
        ``num_shards``: the EPS shards the subproblem space is split over
        (``parallel/mesh.py``); shard s's state comes from
        ``init_state(s)``, and the step takes the shards' states
        concatenated (see ``shard_scan_plain``)."""
        self.tnf = tnf
        self.cfg = config
        self.num_shards = num_shards
        self.device = pick_device() if device is None else torch.device(device)
        with trace.span("init.plan"):
            self.plan = build_plan(tnf,
                                   disable_simplify=config.disable_simplify,
                                   shave=config.shave)
            self.has_eps = apply_strategy_config(self.plan, config)
            if (config.fp_mode == "wac1"
                    and self.plan.num_real_props < config.wac1_threshold):
                # WAC1 behaves as AC-1 below the threshold.
                self.cfg = config = dataclasses.replace(config,
                                                        fp_mode="fixpoint")
            if config.max_depth <= 0:
                self.cfg = config = dataclasses.replace(
                    config, max_depth=auto_max_depth(self.plan))
            self.k = choose_subproblems_power(tnf, config, num_shards)
        self.num_sub_total = 1 << self.k
        self.opt = self.plan.is_opt
        with trace.span("init.upload"):
            self.dp = DevicePlan.from_plan(self.plan, self.device)
            self.kernels = PropagatorKernels(self.dp)
        # EPS subproblem-root table gate (see EngineConfig.use_table).
        self.use_table = (config.use_table and not config.enumerate_all
                          and config.fp_mode in ("fixpoint", "wac1"))
        if self.use_table:
            # The budget counts one copy of the table's lb and ub planes.
            # A card holds two while a state runs: the table cached in
            # ``_tables`` and the state's own clone (``init_state``).
            from .eps_table import table_n_pad
            budget = int(os.environ.get("TURBO_TPU_TABLE_BUDGET",
                                        str(512 << 20)))
            if 2 * 4 * table_n_pad(self) * self.plan.V > budget:
                self.use_table = False
        self._tables = {}  # shard -> SubTable
        self._table_deadline = None  # absolute monotonic build deadline
        self._table_aborted_s = 0.0  # wall time of an abandoned build
        self.last_auto_cap = None
        self.last_split = None  # solve's split, see solve
        self.build_time = 0.0
        self._ws = None  # kernel-route scratch (solver/step_cuda.py)
        self._steal_plan = None  # K5's workspace and plan (kernels.StealPlan)
        with trace.span("init.warm_up"):
            self.warm_time = warm_kernels(self)
        # Seconds of setup that the next solve's hard wall counts: the
        # kernel build and warm-up, as JAX's wall counts its compile.
        self.wall_setup_s = self.build_time + self.warm_time

    def _dive_level(self, *chunk):
        """One level of the EPS table build (``solver/eps_table.py``
        ``dive_level``): on the card one launch of the level entry."""
        from .eps_table import dive_level
        return dive_level(self, *chunk)

    def get_table(self, shard_idx: int = 0):
        """Build (once per shard) the EPS subproblem-root table. Returns
        None when the build hit its deadline (``_table_deadline``,
        budgeted from ``-t`` by ``solve``); the caller then falls back to
        dive-mode refills for the whole run."""
        if shard_idx not in self._tables:
            from .eps_table import build_table
            tb = build_table(self, shard_idx)
            if tb is None:
                return None
            self._tables[shard_idx] = tb
        return self._tables[shard_idx]

    @property
    def _table(self):
        """Shard 0's table, or None."""
        return self._tables.get(0)

    def disable_table(self):
        """Deadline fallback: drop table mode for this solver (every
        shard: a sharded caller rebuilds all shard states)."""
        self.use_table = False
        self._tables = {}

    # -- strategies ---------------------------------------------------

    def _select_plain(self, lb, ub, strat):
        """Branch selection per dive (barebones split(), :186-349): the
        first strategy >= cursor with a splittable var; ties on the
        smallest position. Then the LightBranch children (:355-384).
        Returns (found, var, chosen, valo, c0l, c0u, c1l, c1u)."""
        dp = self.dp
        D = lb.shape[0]
        big = torch.iinfo(I32).max
        founds, vars_ = [], []
        for si, ids in enumerate(dp.strat_ids):
            a = dp.strat_alias[si]
            if a != si:  # padding duplicate of an earlier strategy
                founds.append(founds[a])
                vars_.append(vars_[a])
                continue
            l = lb[:, ids]
            u = ub[:, ids]
            ok = _strategy.splittable(_TorchXP, l, u, NINF, INF)
            pos_key = torch.arange(ids.shape[0], dtype=I32,
                                   device=lb.device)[None, :].expand_as(l)
            key = _strategy.split_key(_TorchXP, dp.strat_vo[si], pos_key, l, u)
            pos = torch.argmin(torch.where(ok, key, big), dim=1)
            founds.append(ok.any(dim=1))
            vars_.append(ids[pos])
        found_s = torch.stack(founds, dim=1)    # (D, S)
        var_s = torch.stack(vars_, dim=1)
        S = found_s.shape[1]
        allowed = (torch.arange(S, dtype=I32, device=lb.device)[None, :]
                   >= strat[:, None])
        ok = found_s & allowed
        has = ok.any(dim=1)
        chosen = torch.argmax(ok.to(I32), dim=1)
        var = var_s.gather(1, chosen[:, None])[:, 0]
        valo = torch.tensor(dp.strat_valo, dtype=I32,
                            device=lb.device)[chosen]
        lo = lb.gather(1, var[:, None])[:, 0]
        hi = ub.gather(1, var[:, None])[:, 0]
        c0l, c0u, c1l, c1u = _strategy.children(_TorchXP, valo, lo, hi)
        return (has, var.to(I32), chosen.to(I32), valo,
                c0l.to(I32), c0u.to(I32), c1l.to(I32), c1u.to(I32))

    def _select(self, lb, ub, strat):
        if lb.is_cuda:
            from ..kernels import select as k_select
            return k_select(self.kernels.kernel_plan, lb, ub, strat)
        if lb.device.type != "cpu":
            raise RuntimeError(f"no select for device {lb.device}")
        return self._select_plain(lb, ub, strat)

    # -- state --------------------------------------------------------

    def init_state(self, shard_idx: int = 0) -> SearchState:
        """Fresh search state of shard ``shard_idx`` (D lanes). Table
        mode: lanes seed from the first D leaves of the shard's table in
        SOLVE phase, and the build's counters fold into lane 0. Dive
        mode: lane d dives to the d-th subproblem of the shard's range."""
        D = self.cfg.num_dives
        MAXD = self.cfg.max_depth
        dev = self.device
        dp = self.dp
        tb = self.get_table(shard_idx) if self.use_table else None
        if self.use_table and tb is None:
            # Build deadline hit: fall back to dive-mode refills (sound:
            # the dive path re-derives every subproblem root).
            self.disable_table()

        def mat(base):
            return base[None, :].repeat(D, 1)

        def full(v, dtype=I32):
            return torch.full((D,), v, dtype=dtype, device=dev)

        lb, ub = mat(dp.lb0), mat(dp.ub0)
        root_lb, root_ub = mat(dp.lb0), mat(dp.ub0)
        best_lb, best_ub = mat(dp.lb0), mat(dp.ub0)
        best_bound = full(INF)
        has_best = full(False, torch.bool)
        nonexh = full(False, torch.bool)
        cnt = {f: full(0) for f in ("nodes", "fails", "sols", "fpit", "dmax",
                                    "solved_sub", "skipped_sub")}
        deds = full(0.0, F32)
        stacks = {f: torch.zeros((D, MAXD), dtype=I32, device=dev)
                  for f in _STACKS}
        if tb is not None:
            n_live = tb.n_live
            # The state's own copy: a rebalance or a checkpoint restore
            # rewrites its rows in place (``ShardedSolver.write_fields``),
            # and the next state of this shard starts from the table as
            # built.
            tab_lb, tab_ub, tab_strat, tab_path = (
                t.clone() for t in (tb.lb, tb.ub, tb.strat, tb.path))
            rows0 = torch.arange(D, dtype=I32, device=dev)
            seeded = rows0 < min(n_live, D)
            table_refill(tab_lb, tab_ub, rows0, seeded, lb, ub, root_lb,
                         root_ub)
            idx0 = rows0.clamp(0, tab_lb.shape[0] - 1).long()
            strat = torch.where(seeded, tab_strat[idx0], 0)
            snap_strat = strat.clone()
            subp = torch.where(seeded, tab_path[idx0], 0)
            phase = torch.where(seeded, SOLVE, IDLE).to(I32)
            remaining = full(0)
            next_sub = full(min(n_live, D))
            sub_limit = full(n_live)
            for f, v in (("nodes", tb.nodes), ("fails", tb.fails),
                         ("fpit", tb.fpit), ("solved_sub", tb.solved),
                         ("skipped_sub", tb.skipped), ("sols", tb.sols),
                         ("dmax", tb.dmax)):
                cnt[f][0] = np.int64(v).astype(np.int32)
            deds[0] = float(np.float32(np.int64(tb.deds)))
            nonexh[0] = bool(tb.nonexh)
            if tb.has_cand:
                has_best[0] = True
                best_bound[0] = tb.cand_bound
                best_lb[0] = torch.from_numpy(tb.cand_lb).to(dev)
                best_ub[0] = torch.from_numpy(tb.cand_ub).to(dev)
        else:
            from .eps_table import shard_range
            base, limit = shard_range(self, shard_idx)
            subp = base + torch.arange(D, dtype=I32, device=dev)
            phase = torch.where(subp < limit, DIVE, IDLE).to(I32)
            remaining = full(self.k)
            strat, snap_strat = full(0), full(0)
            next_sub = full(min(base + D, limit))
            sub_limit = full(limit)
            tab_lb, tab_ub = dp.lb0[None, :].clone(), dp.ub0[None, :].clone()
            tab_strat = torch.zeros(1, dtype=I32, device=dev)
            tab_path = torch.zeros(1, dtype=I32, device=dev)
        R = max(1, self.cfg.sol_ring_size)
        sol_ring = torch.zeros((R, dp.V), dtype=I32, device=dev)
        sol_w = full(0)
        if tb is not None and self.cfg.sol_ring_size > 0 and tb.has_cand:
            # A solution found during the table build streams too.
            sol_ring[0] = torch.from_numpy(tb.cand_lb).to(dev)
            sol_w = full(1)
        return SearchState(
            lb=lb, ub=ub, root_lb=root_lb, root_ub=root_ub,
            best_lb=best_lb, best_ub=best_ub,
            best_bound=best_bound, has_best=has_best,
            **stacks,
            depth=full(0), phase=phase, remaining=remaining, subp=subp,
            strat=strat, snap_strat=snap_strat,
            next_sub=next_sub, nonexh=nonexh,
            **cnt, deds=deds,
            kpow=full(self.k), sub_limit=sub_limit,
            pscale=full(float(dp.num_real_props), F32),
            eps_strat=full(int(self.has_eps)),
            ext_bound=full(INF),
            tab_lb=tab_lb, tab_ub=tab_ub, tab_strat=tab_strat,
            tab_path=tab_path, sol_ring=sol_ring, sol_w=sol_w)

    # -- the step -------------------------------------------------------

    def step(self, st: SearchState, cap: int = 0) -> SearchState:
        """One search node per lane; ``cap`` (0: ``fp_max_iters``) bounds
        the fixpoint sweeps, and lanes still changing at it are held. A
        CUDA state runs the kernels in place; a CPU state the plain step.
        """
        if st.lb.is_cuda:
            from . import step_cuda
            step_cuda.run(self, st, 1, cap)
            return st
        if st.lb.device.type != "cpu":
            raise RuntimeError(f"no step for device {st.lb.device}")
        return self.step_plain(st, cap)[0]

    def run_steps(self, st: SearchState, n: int, cap: int = 0):
        """n steps at fixpoint cap ``cap`` with no host read (the JAX
        ``make_step_budget`` loop): once every lane is IDLE the remaining
        steps change nothing. Returns (state, steps run as a 0-dim int32
        tensor on the state's device); a CUDA state is updated in place.
        """
        if st.lb.is_cuda:
            from . import step_cuda
            return st, step_cuda.run(self, st, n, cap)
        if st.lb.device.type != "cpu":
            raise RuntimeError(f"no step for device {st.lb.device}")
        count = torch.zeros((), dtype=I32)
        for _ in range(n):
            st, live = self.step_plain(st, cap)
            count += live.to(I32)
        return st, count

    def step_plain(self, st: SearchState, cap: int = 0, xchg=None):
        """The step as plain torch ops (``turbo_tpu/solver/engine.py:
        801-1117``), on any device and with no host read, in the parts
        that K6 and K7 replace around K1-K3. Returns (state, live):
        ``live`` (0-dim bool) is whether some lane was not IDLE; when
        none was, the state is returned unchanged. The step runs in a
        "step" profiler range (``solver/profile_split.py``).

        ``xchg``: the state is one card group of several
        (``parallel/mesh.py``): (the incumbent min, live) across every
        group, 0-dim tensors on the state's device (``exchange_plain``,
        K10 on the card), in place of this state's own; the step of a
        group runs whenever some group has a live lane."""
        with torch.profiler.record_function("step"):
            live = (st.phase != IDLE).any() if xchg is None else xchg[1]
            phase, strat0, ub = self.step_pre_plain(
                st, None if xchg is None else xchg[0])
            lb, ub, iters, unconv = self.propagate(
                st.lb, ub, cap or self.cfg.fp_max_iters)
            bot, ent = self.kernels.classify(lb, ub)
            sel = self._select(lb, ub, strat0)
            new, flags = self.step_post_plain(st, phase, strat0, lb, ub,
                                              iters, unconv, bot, ent, sel)
            new = self.lane_copy_plain(st, new, flags[0],
                                       *self.shard_scan_plain(st, new,
                                                              *flags))
            # With every lane IDLE nothing may change (the JAX loop
            # stops); the stacks were rewritten with their own values then.
            new = {k: torch.where(live, v, getattr(st, k))
                   for k, v in new.items()}
            return dataclasses.replace(st, **new), live

    def propagate(self, lb, ub, cap: int):
        """(II) of the step: propagate to the fixpoint or ``cap`` by
        ``fp_mode`` and ``fp_layout`` (``turbo_tpu/solver/engine.py:
        837-849``), in a "fixpoint" profiler range (JAX's
        ``named_scope``; the ``vd`` transposes inside it, as there).
        Returns (lb, ub, iters, unconv)."""
        with torch.profiler.record_function("fixpoint"):
            return self._propagate(lb, ub, cap)

    def _propagate(self, lb, ub, cap):
        cfg, k = self.cfg, self.kernels
        if cfg.fp_mode == "fixed":
            return k.fixed_sweeps(lb, ub, cfg.fp_fixed_iters)
        if cfg.fp_mode == "wac1":
            return k.fixpoint_wac1(lb, ub, cap, cfg.wac1_inner_cap)
        if cfg.fp_layout == "vd":
            lbT, ubT, iters, unconv = k.fixpoint_t(
                lb.t().contiguous(), ub.t().contiguous(), cap)
            return lbT.t().contiguous(), ubT.t().contiguous(), iters, unconv
        return k.fixpoint(lb, ub, cap)

    def step_pre_plain(self, st: SearchState, g=None):
        """K6 ``step.head`` after the previous step's rows: promote
        finished dives, the strategy cursor, and (I) the objective
        tighten from the incumbent. The batch min
        runs over every shard's lanes, so it is the JAX mesh's pmin
        (``ext_bound`` is the same on every lane); ``g`` (a 0-dim
        tensor): the min across card groups in its place. Returns
        (phase, strat0, ub)."""
        dp, where = self.dp, torch.where
        promote = (st.phase == DIVE) & (st.remaining == 0)
        phase = where(promote, SOLVE, st.phase)
        # After the dive, skip the EPS strategy if one is configured.
        strat0 = where(promote, torch.maximum(st.strat, st.eps_strat),
                       st.strat)
        ub = st.ub
        if dp.is_opt:
            ub = ub.clone()
            if g is None:
                g = torch.minimum(st.best_bound.min(), st.ext_bound[0])
            lim = torch.minimum(g, st.best_bound) - 1
            ub[:, dp.obj] = where(phase == SOLVE,
                                  torch.minimum(ub[:, dp.obj], lim),
                                  ub[:, dp.obj])
        return phase, strat0, ub

    def step_post_plain(self, st, phase, strat0, lb, ub, iters, unconv, bot,
                        ent, sel, work=None):
        """K6 ``step.post`` up to the shard scan: everything after K1-K3
        that reads or writes one lane. The stacks are updated in place.
        Returns (fields, (want, impr, dleaf, nxt)): the new per-lane
        fields and the scan's inputs. ``work``: a dict that gets the
        lane masks of the step's row work (no_split, snap, solve_br,
        impr, restore) and the decisions each restore replays (t)."""
        MAXD = self.cfg.max_depth
        dp = self.dp
        obj = dp.obj
        where = torch.where
        enum = self.cfg.enumerate_all
        act = phase != IDLE
        in_dive = phase == DIVE
        in_solve = phase == SOLVE
        ent = ent & ~bot
        held = unconv & ~bot & ~ent
        found, var, nstrat, valo, c0l, c0u, c1l, c1u = sel
        one = torch.ones_like(st.remaining)
        if enum:
            # All solutions: a solution is an all-singleton store; an
            # entailed box with a splittable var keeps splitting. A
            # singleton reached mid-dive is shared by every subproblem of
            # its prefix: count it in the leftmost one only.
            leftmost = (st.subp & ((one << st.remaining) - 1)) == 0
            sol = ent & ~found & where(in_dive, leftmost, True)
            leaf = bot | (ent & ~found)
        else:
            sol = ent
            leaf = bot | sol

        nodes = st.nodes + (act & ~held).to(I32)
        fails = st.fails + (act & bot).to(I32)
        fpit = st.fpit + where(act, iters, 0)
        deds = st.deds + where(act, iters.to(F32) * st.pscale, 0.0)
        tree_depth = st.depth + (st.kpow - st.remaining)
        dmax = torch.maximum(st.dmax, where(act, tree_depth, 0))

        # III. Solutions (all propagators entailed; objective read at lb).
        if dp.is_opt:
            better = lb[:, obj] < torch.minimum(st.best_bound,
                                                st.ext_bound[0])
        else:
            better = torch.ones_like(act) if enum else ~st.has_best
        impr = act & sol & better
        best_lb = where(impr[:, None], lb, st.best_lb)
        best_ub = where(impr[:, None], ub, st.best_ub)
        best_bound = where(impr, lb[:, obj] if dp.is_opt else 0,
                           st.best_bound)
        has_best = st.has_best | impr
        sols = st.sols + impr.to(I32)
        no_split = act & ~leaf & ~found & ~held
        any_unfixed = (lb[:, :dp.n_active] < ub[:, :dp.n_active]).any(dim=1)
        incomplete = no_split & any_unfixed
        waiting = no_split & ~any_unfixed
        nonexh = st.nonexh | incomplete
        leaf = leaf | incomplete
        branching = act & ~leaf & ~waiting & ~held

        # V. Dive branching: commit the child given by the path bit.
        dive_br = branching & in_dive
        bit = (st.subp >> (st.remaining - 1).clamp(min=0)) & 1
        remaining = where(dive_br, st.remaining - 1, st.remaining)

        # VI. Solve branching: snapshot the root at depth 0, push the
        # decision, take the left child.
        solve_br = branching & in_solve
        ovf = solve_br & (st.depth >= MAXD)
        nonexh = nonexh | ovf
        solve_br = solve_br & ~ovf
        leaf = leaf | ovf
        snap = solve_br & (st.depth == 0)
        root_lb = where(snap[:, None], lb, st.root_lb)
        root_ub = where(snap[:, None], ub, st.root_ub)
        snap_strat = where(snap, strat0, st.snap_strat)

        dd = st.depth.clamp(0, MAXD - 1).long()[:, None]
        parent = (st.depth - 1).clamp(0, MAXD - 1).long()[:, None]
        parent_cur = st.dec_cur.gather(1, parent)[:, 0]
        parent_rope1 = st.dec_rope1.gather(1, parent)[:, 0]
        rope1 = where(st.depth > 0,
                      where(parent_cur == 0, st.depth, parent_rope1), -1)

        def push(dst, vals):  # in place
            upd = where(solve_br, vals, dst.gather(1, dd)[:, 0])
            dst.scatter_(1, dd, upd[:, None])

        for dst, vals in ((st.dec_var, var), (st.dec_l0, c0l),
                          (st.dec_u0, c0u), (st.dec_l1, c1l),
                          (st.dec_u1, c1u), (st.dec_rope1, rope1.to(I32)),
                          (st.dec_cur, torch.zeros_like(var))):
            push(dst, vals)
        depth = where(solve_br, st.depth + 1, st.depth)

        # Apply the chosen child bounds (dive: by path bit; solve: left).
        embed = dive_br | solve_br
        el = where(dive_br, where(bit == 1, c1l, c0l), c0l)
        eu = where(dive_br, where(bit == 1, c1u, c0u), c0u)
        evar = where(embed, var, 0).long()[:, None]
        el = where(embed, el, NINF)[:, None]
        eu = where(embed, eu, INF)[:, None]
        lb = lb.scatter(1, evar, torch.maximum(lb.gather(1, evar), el))
        ub = ub.scatter(1, evar, torch.minimum(ub.gather(1, evar), eu))

        # VII. Backtracking by ropes.
        dec_cur = st.dec_cur
        bt = act & leaf & in_solve
        lastd = (depth - 1).clamp(0, MAXD - 1).long()[:, None]
        last_cur = dec_cur.gather(1, lastd)[:, 0]
        last_rope1 = st.dec_rope1.gather(1, lastd)[:, 0]
        t = where(last_cur == 0, depth, last_rope1)
        done_sub = bt & ((depth == 0) | (t == -1))
        restore = bt & (depth > 0) & (t != -1)
        tm1 = (t - 1).clamp(0, MAXD - 1).long()[:, None]
        dec_cur.scatter_(1, tm1, where(restore, 1, dec_cur.gather(1, tm1)[:, 0])[:, None])

        # Rebuild the store: root snapshot meet all decisions < t at
        # their current child, over the whole stack width (a narrower
        # width would need max(t) on the host).
        tr = where(restore, t, 0)
        live_d = (torch.arange(MAXD, dtype=I32, device=lb.device)[None, :]
                  < tr[:, None])
        cur1 = dec_cur == 1
        cl = where(live_d, where(cur1, st.dec_l1, st.dec_l0), NINF)
        cu = where(live_d, where(cur1, st.dec_u1, st.dec_u0), INF)
        tvar = where(live_d, st.dec_var, 0).long()
        reb_lb = root_lb.scatter_reduce(1, tvar, cl, "amax")
        reb_ub = root_ub.scatter_reduce(1, tvar, cu, "amin")
        lb = where(restore[:, None], reb_lb, lb)
        ub = where(restore[:, None], reb_ub, ub)
        depth = where(restore, t, depth)
        strat = where(branching, nstrat, strat0)
        strat = where(restore, snap_strat, strat)

        # VIII. Dive leaves: skip the unreachable subtree.
        dleaf = act & leaf & in_dive
        nxt = ((st.subp >> remaining) + 1) << remaining
        dleaf_left = dleaf & ((st.subp & ((one << remaining) - 1)) == 0)
        skipped_sub = st.skipped_sub + where(dleaf_left, nxt - st.subp - 1, 0)
        want = dleaf | done_sub
        solved_sub = st.solved_sub + (done_sub | dleaf_left).to(I32)
        if work is not None:
            work.update(no_split=no_split, snap=snap, solve_br=solve_br,
                        impr=impr, restore=restore, t=tr)
        fields = dict(
            lb=lb, ub=ub, root_lb=root_lb, root_ub=root_ub,
            best_lb=best_lb, best_ub=best_ub, best_bound=best_bound,
            has_best=has_best, depth=depth, phase=phase,
            remaining=remaining, strat=strat, snap_strat=snap_strat,
            nonexh=nonexh, nodes=nodes, fails=fails, sols=sols, fpit=fpit,
            deds=deds, dmax=dmax, solved_sub=solved_sub,
            skipped_sub=skipped_sub)
        return fields, (want, impr, dleaf, nxt)

    def shard_scan_plain(self, st, f, want, impr, dleaf, nxt):
        """(IX) The refill counter and the ring slots of finished lanes:
        the shard scan in K6 ``step.post``'s last block of a shard.
        ``f``: the new fields of ``step_post_plain``; next_sub and sol_w
        go into it. Returns (newidx, refill, ring row of each lane: G*R,
        a spare row, for none).

        A state of G*D lanes is G EPS shards (``parallel/mesh.py``),
        laid out as the JAX mesh's global state: shard g owns lanes
        [g*D, (g+1)*D), table rows [g*n_pad, (g+1)*n_pad) and ring rows
        [g*R, (g+1)*R), and reads its counters (next_sub, sub_limit,
        sol_w) from its first lane. Every scan and total here is per
        shard."""
        D = self.cfg.num_dives
        G = want.shape[0] // D
        where = torch.where
        shard = torch.arange(G * D, dtype=I32, device=want.device) // D

        def per_lane(x):  # (G,) -> (G * D,)
            return x[:, None].expand(G, D).reshape(-1)

        next_sub = torch.maximum(
            st.next_sub.view(G, D)[:, 0],
            where(dleaf, nxt, 0).view(G, D).amax(dim=1))
        shard_limit = st.sub_limit.view(G, D)[:, 0]
        want_g = want.view(G, D).to(I32)
        rank = (torch.cumsum(want_g, dim=1, dtype=I32) - 1).view(-1)
        newidx = per_lane(next_sub) + where(want, rank, 0)
        refill = want & (newidx < per_lane(shard_limit))
        next_sub = torch.minimum(next_sub + want_g.sum(dim=1, dtype=I32),
                                 shard_limit)
        f["next_sub"] = per_lane(next_sub).clone()
        R = self.cfg.sol_ring_size
        ring_row = None
        if R > 0:
            # The accepted stores go in lane order to slot (w0 + rank)
            # mod R of the shard's ring. Of more than R writers in one
            # step only the last R land, so every slot has one writer
            # (the last); the others go to a spare row G*R.
            cnt = torch.cumsum(impr.view(G, D).to(I32), dim=1, dtype=I32)
            total = cnt[:, -1]
            cnt = cnt.view(-1)
            keep = impr & (per_lane(total) - cnt < R)
            w0 = per_lane(st.sol_w.view(G, D)[:, 0])
            ridx = torch.remainder(w0 + cnt - 1, R) + shard * R
            ring_row = where(keep, ridx, G * R)
            f["sol_w"] = st.sol_w + per_lane(total)
        return newidx, refill, ring_row

    def lane_copy_plain(self, st, f, want, newidx, refill, ring_row):
        """The rows after the shard scan, which the next K6
        ``step.head`` (K7 ``step_tail.copy`` after a chunk's last step)
        writes: the refill of each finishing lane and the ring row of
        each accepted solution (the incumbent row just written). Updates
        and returns ``f``."""
        D = self.cfg.num_dives
        G = want.shape[0] // D
        where = torch.where
        if self.use_table:
            # Table refill: the leaf row of the lane's shard, straight
            # into SOLVE phase; subp carries the leaf's real bit-path
            # (the tail resplit reads it).
            shard = torch.arange(G * D, dtype=I32, device=want.device) // D
            n_pad = st.tab_lb.shape[0] // G
            idxc = newidx.clamp(0, n_pad - 1) + shard * n_pad
            f["phase"] = where(want, where(refill, SOLVE, IDLE),
                               f["phase"]).to(I32)
            table_refill(st.tab_lb, st.tab_ub, idxc, refill, f["lb"],
                         f["ub"], f["root_lb"], f["root_ub"])  # all new
            idxc = idxc.long()
            tstr = st.tab_strat[idxc]
            f["strat"] = where(refill, tstr, f["strat"])
            f["snap_strat"] = where(refill, tstr, f["snap_strat"])
            f["remaining"] = where(refill, 0, f["remaining"])
            f["subp"] = where(refill, st.tab_path[idxc], st.subp)
        else:
            f["phase"] = where(want, where(refill, DIVE, IDLE),
                               f["phase"]).to(I32)
            f["lb"] = where(refill[:, None], self.dp.lb0[None, :], f["lb"])
            f["ub"] = where(refill[:, None], self.dp.ub0[None, :], f["ub"])
            f["strat"] = where(refill, 0, f["strat"])
            f["remaining"] = where(refill, st.kpow, f["remaining"])
            f["subp"] = where(refill, newidx, st.subp)
        f["depth"] = where(refill, 0, f["depth"])
        if ring_row is not None:
            ring = torch.cat([st.sol_ring, st.sol_ring[:1]])
            ring.index_copy_(0, ring_row.long(), f["best_lb"])
            f["sol_ring"] = ring[:st.sol_ring.shape[0]]
        return f

    # -- EPS tail: resplit and stack steal, in place --------------------

    def _tail_resplit(self, st, phase, max_new_kpow: int = 28):
        """EPS tail refinement (``turbo_tpu/solver/engine.py:1121-1183``):
        once the range is drained and at most D/4 lanes still work,
        re-split each unfinished subproblem 2^j ways (extending its
        bit-path) and reseed the lane batch over the refined space; the
        2^j paths partition the straggler's subproblem exactly. In place:
        one host read (subp and kpow), then torch writes into the state's
        own tensors. Returns (st, number of stragglers) or None."""
        D = self.cfg.num_dives
        active = np.nonzero(phase != IDLE)[0]
        if len(active) == 0 or len(active) > D // 4:
            return None
        j = int(np.floor(np.log2(D / len(active))))
        j = min(j, 8)
        if j < 2:
            return None
        subp, kpow = torch.stack([st.subp, st.kpow]).cpu().numpy()
        pairs = sorted({(int(subp[i]), int(kpow[i])) for i in active})
        j = min(j, max_new_kpow - max(kp for _, kp in pairs))
        if j < 2:
            return None
        new = np.array([((sp << j) | suf, kp + j) for sp, kp in pairs
                        for suf in range(1 << j)], np.int32)
        n_new = len(new)
        if n_new > D:  # cannot happen with j from the formula
            return None
        new = torch.from_numpy(new.T.copy()).to(st.subp.device)
        st.phase.fill_(IDLE)
        st.phase[:n_new] = DIVE
        st.subp[:n_new] = new[0]
        st.kpow[:n_new] = new[1]
        st.remaining[:n_new] = new[1]
        # Every refined subproblem is lane-resident: no counter refills.
        for f in ("depth", "strat", "snap_strat", "next_sub", "sub_limit"):
            getattr(st, f).zero_()
        for f, row in (("lb", self.dp.lb0), ("ub", self.dp.ub0),
                       ("root_lb", self.dp.lb0), ("root_ub", self.dp.ub0)):
            getattr(st, f).copy_(row.expand_as(getattr(st, f)))
        return st, len(pairs)

    def _steal_open_branches(self, st, phase):
        """Post-drain work stealing from decision stacks
        (``turbo_tpu/solver/engine.py:1203-1314``). Every entry d of a
        SOLVE-phase stack with dec_cur[d] == 0 is an unexplored right
        subtree; an idle lane takes the shallowest one and the victim
        closes it, which partitions the victim's remaining work exactly.

        Per steal (victim v, open depth d0, thief lane t):
          - thief stack = victim prefix [0, d0] with cur[d0]=1 and
            rope1[d0]=-1: exhausting the stolen subtree ropes to -1 ->
            done_sub -> the lane idles;
          - thief store = victim root snapshot met with decisions
            [0..d0] at their current child (d0 at the right child);
          - victim cur[d0]=1, its right child rewritten to the left one,
            and the rope chain above d0 recomputed.

        In place. On a CUDA state K5 counts the open branches and plans
        the round in one launch, the host reads the count (one int64),
        and K9 applies the min(count, IDLE lanes) steals; ``phase`` is
        ``st.phase`` as the host last read it. On a CPU state the round
        is ``steal_host`` on the state's own memory. Returns (st,
        n_steals) or None."""
        idle = np.nonzero(phase == IDLE)[0]
        if len(idle) == 0:
            return None
        if st.lb.is_cuda:
            from .. import kernels
            D, MAXD = st.dec_cur.shape
            plan = self._steal_plan
            if plan is None or (plan.D, plan.MAXD) != (D, MAXD):
                plan = self._steal_plan = kernels.StealPlan(D, MAXD,
                                                            st.lb.device)
            n_open = int(kernels.open_count(st.dec_cur, st.depth, st.phase,
                                            plan))
            n = min(n_open, len(idle))
            if n == 0:
                return None
            kernels.steal(st, plan, n)
            return st, n
        if st.lb.device.type != "cpu":
            raise RuntimeError(f"no steal round for device {st.lb.device}")
        n = steal_host({f: getattr(st, f).numpy() for f in STEAL_FIELDS},
                       idle)
        return (st, n) if n else None

    # -- host loop ------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profiled_steps(self, st: SearchState, n: int, cap: int):
        """``run_steps`` for a chunk that ``profile_split`` measures: on
        the card a graph of its own, whose launches time themselves (the
        stamped step entries, K6's timed entries; CUDA events around the
        others: ``step_cuda.run(..., stamps=..., spans=...)``). Returns
        (state, steps run, what was measured: on the card (the launches
        as ``profile_split.Event``s, (sweep, epilogue) cycles summed over
        the stamps), None on the CPU)."""
        if not st.lb.is_cuda:
            return self.run_steps(st, n, cap) + (None,)
        from . import step_cuda
        stamps = torch.zeros((n, st.phase.shape[0], 2), dtype=torch.int64,
                             device=st.lb.device)
        spans = step_cuda.Spans(n, st.lb.device)
        ran = step_cuda.run(self, st, n, cap, stamps=stamps, spans=spans)
        return st, ran, (spans.events(), stamps.sum(dim=(0, 1)).tolist())

    @trace.spanned("solve")
    def solve(self, timeout_s: float = 1e18, chunk: int = 16,
              stop_after_n_solutions: int = 1, max_steps: int = 1 << 60,
              node_limit: int = 0, verbose: bool = False, on_improve=None,
              on_solution=None, checkpoint_path: str = "",
              checkpoint_every_s: float = 60.0, fp_cap: int = 0):
        """Single-device host loop (``turbo_tpu/solver/engine.py:
        1417-1818``): chunks of ``run_steps`` until every lane is IDLE,
        the timeout, ``node_limit``, ``max_steps``, the hard wall or (on
        satisfaction problems) ``stop_after_n_solutions``, with one host
        read per chunk. The first chunk is the warm-up: it stays out of
        the timers' fit, as in JAX. Once the chunks after it have summed
        ``profile_split.MIN_DEVICE_S`` of device time, two more real
        chunks are measured (``solver/profile_split.py``: on the card by
        launches that time themselves and the stamped step entries' clock
        stamps, on the CPU under ``torch.profiler``; off with
        ``TURBO_TPU_PROFILE_SPLIT=0``), and their fixpoint fraction sets
        ``fixpoint_time`` and ``search_time`` (``timer_split_measured``;
        ``last_split`` holds (the fraction or None, the profile's wall
        seconds, the least-squares fit's fraction of the same run)). The
        hard wall stops the run once ``TURBO_TPU_HARD_WALL_MULT``
        (default 2, 0 off) times ``timeout_s`` has passed since this call
        began, counted on a solver's first call from before the kernel
        build and warm-up of ``__init__`` (``wall_setup_s``), as JAX's
        wall counts its compile; ``-t`` and ``solveTime`` start here, and
        ``initTime`` holds the build. The table build runs inside the
        ``-t`` window with a deadline at half of it; ``fp_cap`` > 0 pins
        the fixpoint cap, else the calibrator sweeps it (``fp_cap_auto``). Once the range
        is drained, idle lanes steal open branches or the stragglers are
        resplit (not under ``enumerate_all``). With ``checkpoint_path``
        the run resumes from that file when it matches this solver
        (``solver/checkpoint.py``) and writes it every
        ``checkpoint_every_s`` seconds and when it stops early.

        ``on_improve(best_lb_tnf)``: called when the incumbent improves.
        ``on_solution(lb_tnf)``: with ``sol_ring_size`` > 0, called for
        every accepted solution in device order, once per chunk; under
        ``enumerate_all`` the chunk is capped so that the ring cannot
        overflow between drains. Solutions lost to an overflow are
        warned about and counted in ``sol_ring_overflow``. Kernels were
        built in ``__init__``: the solve clock starts here. The timers
        read the spans of ``trace.py`` (``init_state``, and in each
        ``chunk`` of the loop ``chunk.enqueue``, ``chunk.wait``,
        ``chunk.read``, ``split``, ``ring``, ``calibrate``,
        ``tail.steal``, ``tail.resplit``, ``checkpoint``)."""
        from ..host.solver.timers import PhaseTimers
        from . import profile_split
        from .result import EngineResult
        t0 = time.monotonic()
        hard_mult = float(os.environ.get("TURBO_TPU_HARD_WALL_MULT", "2"))
        t_entry = t0 - self.wall_setup_s  # the build counts once
        self.wall_setup_s = 0.0
        self.last_split = None
        if self.plan.root_unsat:
            return EngineResult.unsat(self)
        D = self.cfg.num_dives
        timers = PhaseTimers(num_lanes=D)
        with trace.span("init_state") as sp:
            if self.use_table and self._table is None and timeout_s < 1e17:
                # Budget the table build inside -t: at most half of it; a
                # tighter deadline set by the caller stays binding.
                dl = time.monotonic() + max(2.0, 0.5 * timeout_s)
                prev = self._table_deadline
                self._table_deadline = dl if prev is None else min(prev, dl)
            st = self.init_state()
            self._table_deadline = None  # consumed; don't leak to re-solves
            cap = fp_cap if fp_cap > 0 else self.cfg.fp_max_iters
            cal = AutoCapCalibrator(self.cfg, fp_cap)
            cap = cal.arm(cap)
            self._sync()
        timers.transfer_c2g = sp.s
        # The table build (or an abandoned one) counts in the solve
        # window and in dive_time / table_build_time.
        dive_dur = self._table.build_time if self._table is not None else 0.0
        dive_dur += self._table_aborted_s
        resplit_rounds = 0
        resplit_base = None
        steal_rounds = 0

        def checkpoint():
            from .checkpoint import save_state
            with trace.span("checkpoint"):
                save_state(self, st, checkpoint_path, extras={
                    "resplit_base": resplit_base,
                    "resplit_rounds": resplit_rounds,
                    "steal_rounds": steal_rounds})

        if checkpoint_path:
            from .checkpoint import load_state
            restored = load_state(self, checkpoint_path)
            if restored is not None:
                st, extras = restored
                resplit_base = extras.get("resplit_base")
                resplit_rounds = extras.get("resplit_rounds", 0)
                steal_rounds = extras.get("steal_rounds", 0)
        last_ckpt = time.monotonic()
        ring = self.cfg.sol_ring_size
        if ring > 0 and self.cfg.enumerate_all:
            # At most D solutions land per step: cap the chunk so that no
            # more than `ring` land between two drains.
            chunk = max(1, min(chunk, ring // max(D, 1)))
        ring_drained = 0
        overflow = 0
        cur_chunk = chunk
        steps = 0
        stopped = False
        first_call = True
        best_seen = None
        best_obj_time = 0.0
        last_best = INF  # no incumbent yet: on_improve waits for one
        last_steal = 0.0
        steal_wait = 1.0
        # One-shot re-calibration once the range drains, armed only
        # after the loop has seen the undrained phase.
        recal_armed = False
        recal_done = False
        prof_pending = profile_split.enabled()
        prof_dev = 0.0  # device seconds of the chunks after the warm-up

        def snapshot(ran=None):
            """One host read: phase, sols, fpit, best_bound, next_sub,
            sub_limit, nodes, sol_w (D each), and the steps ``ran``."""
            if ran is None:
                ran = st.phase.new_zeros(())
            host = torch.cat([torch.stack(
                [st.phase, st.sols, st.fpit, st.best_bound, st.next_sub,
                 st.sub_limit, st.nodes, st.sol_w]).view(-1),
                ran.view(1)]).cpu().numpy()
            return host[:-1].reshape(8, D), int(host[-1])

        def profiled_chunk():
            # A real chunk, measured; accounted as JAX does.
            nonlocal st, steps
            tp = time.monotonic()
            st, ran, measured = self._profiled_steps(st, cur_chunk, cap)
            f, ran = snapshot(ran)
            steps += ran
            trace.count("chunks")
            trace.count("steps", ran)
            timers.record_chunk(time.monotonic() - tp, int(f[2].sum()),
                                f[0], ran, time.monotonic() - t0)
            return measured

        while True:
            with trace.span("chunk"):
                with trace.span("chunk.enqueue") as sp_enqueue:
                    st, ndone = self.run_steps(st, cur_chunk, cap)
                with trace.span("chunk.wait") as sp_wait:
                    self._sync()
                device_dur = sp_enqueue.s + sp_wait.s
                warmup = first_call
                first_call = False
                # One host read per chunk.
                with trace.span("chunk.read") as sp_read:
                    (phase, sols, fpit, bbs, nsub, slim, nodes_v,
                     sol_w), ndone = snapshot(ndone)
                    steps += ndone
                timers.transfer_g2c += sp_read.s
                trace.count("chunks")
                trace.count("steps", ndone)
                timers.record_chunk(device_dur, int(fpit.sum()), phase,
                                    ndone, time.monotonic() - t0,
                                    measured=not warmup)
                # The measured FIXPOINT/SEARCH split, once a run, on two
                # real chunks; the trace is small against the work before
                # it.
                skip_cal = False
                if not warmup:
                    prof_dev += device_dur
                if (prof_pending and not warmup
                        and prof_dev >= profile_split.MIN_DEVICE_S
                        and not (phase == IDLE).all()):
                    prof_pending = False
                    with trace.span("split") as sp:
                        frac = profile_split.measure_fixpoint_fraction(
                            profiled_chunk, cuda=st.lb.is_cuda)
                    if frac is not None:
                        timers.measured_fix_frac = frac
                    self.last_split = (frac, sp.s, None)
                    # The profiled chunks advanced st: refresh the whole
                    # snapshot, and keep their nodes out of the
                    # calibrator's next rate sample.
                    (phase, sols, fpit, bbs, nsub, slim, nodes_v,
                     sol_w), _ = snapshot()
                    skip_cal = True
                if ring > 0 and on_solution is not None:
                    with trace.span("ring"):
                        cur = int(sol_w[0])
                        if not self.opt and stop_after_n_solutions > 0:
                            cur = min(cur, stop_after_n_solutions)
                        if cur - ring_drained > ring:
                            lost = cur - ring_drained - ring
                            overflow += lost
                            print(f"% warning: solution ring overflow; "
                                  f"{lost} solutions not streamed",
                                  flush=True)
                            ring_drained = cur - ring
                        if cur > ring_drained:
                            # Only the new rows cross to the host.
                            slots = torch.arange(ring_drained, cur) % ring
                            rows = st.sol_ring[slots.to(st.sol_ring.device)]
                            for row in rows.cpu().numpy():
                                on_solution(self.plan.store_to_tnf(row))
                            ring_drained = cur
                bbm = int(bbs.min())
                if on_improve is not None and bbm < last_best:
                    last_best = bbm
                    d = int(bbs.argmin())
                    on_improve(self.plan.store_to_tnf(
                        st.best_lb[d].cpu().numpy()))
                if bbm < (best_seen if best_seen is not None else 1 << 40):
                    best_seen = bbm
                    best_obj_time = time.monotonic() - t0
                if (phase == IDLE).all():
                    break
                if not self.opt and sols.sum() >= stop_after_n_solutions > 0:
                    stopped = True
                    break
                if time.monotonic() - t0 > timeout_s or steps >= max_steps:
                    stopped = True
                    break
                if (timeout_s < 1e17 and hard_mult > 0
                        and time.monotonic() - t_entry
                        > hard_mult * timeout_s):
                    print("% hard wall-clock limit reached "
                          f"({hard_mult:g}x timeout incl. compile); stopping",
                          file=sys.stderr, flush=True)
                    stopped = True
                    break
                # Adapt the chunk to the remaining budget.
                if not warmup and ndone > 0 and timeout_s < 1e17:
                    step_cost = device_dur / ndone
                    remaining = timeout_s - (time.monotonic() - t0)
                    cur_chunk = int(max(1, min(
                        chunk, remaining / max(step_cost, 1e-9))))
                if not cal.done:
                    with trace.span("calibrate"):
                        cap, hint = cal.observe(cap, int(nodes_v.sum()),
                                                device_dur, warmup,
                                                skip=skip_cal,
                                                verbose=verbose)
                    if hint is not None:
                        cur_chunk = min(cur_chunk, hint)
                    else:
                        self.last_auto_cap = cal.chosen
                        cur_chunk = chunk
                # EPS tail: once the range is drained, idle lanes can only
                # get work from the stragglers. Stack stealing first (no
                # re-exploration); resplit when there is nothing to steal.
                drained = nsub[0] >= slim[0]
                if not drained:
                    recal_armed = True
                elif (recal_armed and not recal_done and cal.done
                        and fp_cap == 0 and self.cfg.fp_cap_auto
                        and timeout_s - (time.monotonic() - t0) > 10.0):
                    recal_done = True
                    with trace.span("calibrate"):
                        cal = AutoCapCalibrator(self.cfg, fp_cap)
                        if not cal.done:
                            cal.nodes0 = int(nodes_v.sum())
                            cap = cal.arm(cap)
                    if not cal.done and verbose:
                        print("% range drained: re-calibrating fp_cap",
                              flush=True)
                idle_n = int((phase == IDLE).sum())
                # idle_n >= D/8: JAX's policy (turbo_tpu/solver/engine.py:
                # 1702), set when a round fetched the whole state; a round
                # here moves no state through the host, the gate stays
                # JAX's.
                if (drained and idle_n >= max(1, len(phase) // 8)
                        and not (phase == IDLE).all()
                        and not self.cfg.enumerate_all
                        and timeout_s - (time.monotonic() - t0) > 2.0
                        and time.monotonic() - last_steal > steal_wait):
                    last_steal = time.monotonic()

                    def _freeze_accounting():
                        # Coarse (2^k) accounting from here on: counter
                        # deltas of refined / stolen units are credited
                        # as the not-yet-accounted coarse subproblems
                        # when the run exhausts (post-fix below).
                        nonlocal resplit_base
                        if resplit_base is None:
                            s0 = int(st.solved_sub.sum())
                            k0 = int(st.skipped_sub.sum())
                            resplit_base = (
                                s0, k0,
                                max(0, self.num_sub_total - s0 - k0))
                    # The open-branch count gates the steal (on the card
                    # K5, which also plans the round; K9 applies it).
                    with trace.span("tail.steal") as sp:
                        res3 = self._steal_open_branches(st, phase)
                        if res3 is not None:
                            self._sync()
                    if res3 is not None:
                        round_ms = sp.s * 1e3
                        # The round writes neither solved_sub nor
                        # skipped_sub: the snapshot reads the pre-steal
                        # counters.
                        _freeze_accounting()
                        st, n_steals = res3
                        steal_rounds += 1
                        trace.count("steal_rounds")
                        trace.count("steals", n_steals)
                        steal_wait = 1.0
                        if verbose:
                            print(f"% stack steal #{steal_rounds}: "
                                  f"{n_steals} open branches reseeded "
                                  f"({round_ms:.3f} ms)")
                    elif (resplit_rounds < 8
                            and idle_n >= (3 * len(phase)) // 4):
                        with trace.span("tail.resplit") as sp:
                            res2 = self._tail_resplit(st, phase)
                            if res2 is not None:
                                self._sync()
                        if res2 is not None:
                            round_ms = sp.s * 1e3
                            _freeze_accounting()
                            st, n_coarse = res2
                            resplit_rounds += 1
                            trace.count("resplit_rounds")
                            steal_wait = 1.0
                            if verbose:
                                print(f"% tail resplit #{resplit_rounds}: "
                                      f"{n_coarse} stragglers refined "
                                      f"({round_ms:.3f} ms)")
                        else:
                            steal_wait = min(steal_wait * 2, 8.0)
                    else:
                        # Nothing to steal or refine: back off so retries
                        # do not starve the stragglers' chunks.
                        steal_wait = min(steal_wait * 2, 8.0)
                if node_limit and int(nodes_v.sum()) >= node_limit:
                    stopped = True
                    break
                if checkpoint_path and \
                        time.monotonic() - last_ckpt > checkpoint_every_s:
                    checkpoint()
                    last_ckpt = time.monotonic()
                if verbose:
                    bb = int(bbs.min())
                    print(f"% t={time.monotonic()-t0:6.1f}s steps={steps} "
                          f"chunk_s={device_dur:.2f} "
                          f"nodes={int(nodes_v.sum())} "
                          f"best={bb if bb < INF else None} "
                          f"dive={(phase == DIVE).sum()} "
                          f"solve={(phase == SOLVE).sum()} "
                          f"idle={(phase == IDLE).sum()}/{len(phase)} "
                          f"next_sub={int(nsub[0])}/{int(slim[0])}",
                          flush=True)
        if checkpoint_path and stopped:
            checkpoint()
        res = EngineResult.from_state(self, st, stopped,
                                      time.monotonic() - t0)
        if resplit_base is not None:
            # Subproblem accounting in coarse (2^k) units: refined-unit
            # deltas after the first resplit or steal collapse back into
            # the stragglers they partition.
            solved0, skipped0, n_coarse = resplit_base
            res.eps_solved_subproblems = solved0 + (
                n_coarse if res.exhaustive else 0)
            res.eps_skipped_subproblems = skipped0
            res.eps_redistributions += resplit_rounds + steal_rounds
        res.best_obj_time = best_obj_time
        res.sol_ring_overflow = overflow
        if self.last_split is not None and timers.device_time > 0:
            # The least-squares fit's fraction of the same run, beside
            # the measured one.
            fit = dataclasses.replace(timers, measured_fix_frac=None)
            self.last_split = self.last_split[:2] + (
                float(fit.fixpoint_search_split()[0] / timers.device_time),)
        timers.fill_result(res, res.solve_time)
        res.dive_time += dive_dur
        res.table_build_time = dive_dur
        return res
