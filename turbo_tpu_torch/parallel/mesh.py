"""EPS shards as lane groups of one search state, and card groups on
distinct cards: port of ``turbo_tpu/parallel/mesh.py``.

The JAX package spreads S EPS shards over a 1-D mesh of S devices, D
lanes each, with static per-shard subproblem ranges; the only value a
step reads across shards is the incumbent, through ``lax.pmin``. Here
the S shards are lane groups of one ``SearchState`` on one device,
laid out as the mesh's global state: shard s owns lanes [s*D, (s+1)*D),
table rows [s*n_pad, (s+1)*n_pad) and ring rows [s*R, (s+1)*R). The
step is the batched engine's over all S*D lanes: its incumbent min over
every lane is the pmin (``ext_bound`` is the same on every lane), and
its cross-lane end (on the card the shard scan in K6 post's last block
of each shard, ``shard_scan_plain`` on the CPU) runs per shard, each
from its own counter, table and ring.

Shards on distinct cards of one process are card groups: each card holds
a run of consecutive shards as the lane groups of a state of its own,
with a ``BatchedSolver`` of its own, whose table rows are indexed by
local shard; the groups' states concatenated in shard order are the
mesh's global state (``global_state``). The groups step in lockstep and
exchange two words a step, the incumbent min and the live flag: on the
card each group publishes them into every group's slots (K6 post, K7
live) and K10 (``kernels.xcard``) reduces them at the head of the next
step (``solver/step_cuda.py`` ``run_groups``); on the CPU
``exchange_plain`` feeds every group's ``step_plain``. Card groups may
also share a device, each with its own state and stream, which runs the
multi-card code on one card.

``solve`` is the mesh host loop: the calibrator, the per-shard ring
drain under a global ``-n`` budget, ``on_improve``, the host-side
``rebalance_ranges`` that revives a dry shard from the richest one,
``node_limit``, and the checkpoint with the shard count. It has no
stack steal and no tail resplit, as the JAX mesh loop has neither.

In a multi-host run (``parallel/multihost.py``) each process builds a
``ShardedSolver`` over its local shards with ``shard_offset`` and
``total_shards`` set, so that the processes' shards partition one global
subproblem space.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..device import pick_device
from ..host.core.ops import INF
from ..solver.config import EngineConfig
from ..solver.convert import search_state_to_numpy
from ..solver.engine import (DIVE, IDLE, SOLVE, AutoCapCalibrator,
                             BatchedSolver, SearchState)


def rebalance_ranges(st: dict, D: int, n_shards: int, lb0: np.ndarray,
                     ub0: np.ndarray, use_table: bool = False):
    """Host-side EPS work redistribution across shards (numpy; a copy of
    ``turbo_tpu/parallel/mesh.py:34-139``).

    Static per-shard ranges can leave a shard with every lane IDLE and
    its range exhausted while others still hold work. Such a dry shard
    takes the upper half of the remaining range of the shard with the
    most left: with the table on it copies the donor's table and seeds
    its lanes from rows [mid, limit) in SOLVE phase; with it off its
    lanes dive to subproblems [mid, limit) from the root box. Only
    values change, never shapes.

    ``st``: the state's fields as numpy arrays (``search_state_to_numpy``
    of the global state). Returns (fields, moves); the fields are ``st``
    itself when nothing moved."""
    phase = st["phase"].copy()
    subp = st["subp"].copy()
    next_sub = st["next_sub"].copy()
    sub_limit = st["sub_limit"].copy()
    depth = st["depth"].copy()
    strat = st["strat"].copy()
    snap_strat = st["snap_strat"].copy()
    remaining = st["remaining"].copy()
    lb = st["lb"].copy()
    ub = st["ub"].copy()
    root_lb = st["root_lb"].copy()
    root_ub = st["root_ub"].copy()
    tab_lb = st["tab_lb"].copy()
    tab_ub = st["tab_ub"].copy()
    tab_strat = st["tab_strat"].copy()
    tab_path = st["tab_path"].copy()
    n_pad = tab_lb.shape[0] // n_shards

    def shard_next(s):
        return int(next_sub[s * D])

    def shard_limit(s):
        return int(sub_limit[s * D])

    moves = 0
    for s in range(n_shards):
        sl = slice(s * D, (s + 1) * D)
        if not (phase[sl] == IDLE).all():
            continue
        if shard_limit(s) - shard_next(s) > 0:
            continue  # not dry (can't normally happen)
        # Donor: the shard with the largest remaining unexplored range.
        rems = [(shard_limit(d) - shard_next(d), d) for d in range(n_shards)
                if d != s]
        rem, donor = max(rems, default=(0, -1))
        give = rem // 2
        if give < 1:
            continue
        dsl = slice(donor * D, (donor + 1) * D)
        limit_d = shard_limit(donor)
        mid = limit_d - give
        sub_limit[dsl] = mid          # donor keeps [next_d, mid)
        if use_table:
            # Table mode: counters index live table rows, so the
            # receiver also copies the donor's table and seeds its
            # lanes straight into SOLVE from rows [mid, limit_d).
            tsl = slice(s * n_pad, (s + 1) * n_pad)
            dtl = slice(donor * n_pad, (donor + 1) * n_pad)
            tab_lb[tsl] = tab_lb[dtl]
            tab_ub[tsl] = tab_ub[dtl]
            tab_strat[tsl] = tab_strat[dtl]
            tab_path[tsl] = tab_path[dtl]
            rows = mid + np.arange(D, dtype=np.int64)
            live = rows < limit_d
            ridx = np.clip(rows, 0, n_pad - 1)
            subp[sl] = tab_path[dtl][ridx]
            phase[sl] = np.where(live, SOLVE, IDLE)
            lb[sl] = tab_lb[dtl][ridx]
            ub[sl] = tab_ub[dtl][ridx]
            root_lb[sl] = tab_lb[dtl][ridx]
            root_ub[sl] = tab_ub[dtl][ridx]
            strat[sl] = tab_strat[dtl][ridx]
            snap_strat[sl] = tab_strat[dtl][ridx]
            remaining[sl] = 0
        else:
            # Receiver lanes take [mid, limit_d) exactly like init_state.
            lane_sub = mid + np.arange(D, dtype=np.int32)
            subp[sl] = lane_sub
            phase[sl] = np.where(lane_sub < limit_d, DIVE, IDLE)
            lb[sl] = lb0[None, :]
            ub[sl] = ub0[None, :]
            root_lb[sl] = lb0[None, :]
            root_ub[sl] = ub0[None, :]
            strat[sl] = 0
            snap_strat[sl] = 0
            remaining[sl] = st["kpow"][sl]
        next_sub[sl] = min(mid + D, limit_d)
        sub_limit[sl] = limit_d
        depth[sl] = 0
        moves += 1
    if not moves:
        return st, 0
    return dict(
        st, phase=phase, subp=subp, next_sub=next_sub, sub_limit=sub_limit,
        depth=depth, strat=strat, snap_strat=snap_strat,
        remaining=remaining, lb=lb, ub=ub, root_lb=root_lb,
        root_ub=root_ub, tab_lb=tab_lb, tab_ub=tab_ub,
        tab_strat=tab_strat, tab_path=tab_path), moves


def xcard_plain(slots, parity: int):
    """K10's plain version (csrc/xcard.cu): (live, bmin) of a card
    group's slot array ``slots`` ((2, N, 2) int32, [parity][group] =
    (incumbent min, live)): whether some slot of parity ``parity`` is
    live, and the min of their incumbent words, as 0-dim tensors (bool,
    int32)."""
    words = slots[parity]
    return (words[:, 1] != 0).any(), words[:, 0].min()


def exchange_plain(states, device):
    """The card groups' per-step exchange as plain torch ops: the CPU
    route of ``ShardedSolver.run_steps`` and, on the card, the reference
    of K10 and the publish in K6 post and K7 live. Each group's state
    contributes min(best_bound.min(), ext_bound[0]) and whether a lane
    is not IDLE, as one slot each; ``xcard_plain`` reduces them. Returns
    (G, live), 0-dim tensors on ``device``: the incumbent min across
    every group (JAX's ``pmin``) and the OR of the live flags."""
    words = torch.stack([torch.stack([
        torch.minimum(st.best_bound.min(), st.ext_bound[0]),
        (st.phase != IDLE).any().to(torch.int32)]).to(device)
        for st in states])
    live, g = xcard_plain(words[None], 0)
    return g, live


def _device(d):
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def card_groups(devices):
    """The card groups of a ``devices`` argument, as [(device, shards)]
    in shard order. A list of lists is one group a list, each list one
    device repeated once per shard (groups may share a device); a flat
    list groups its shards by device, in order, so the shards of a
    device must be consecutive (``ValueError`` otherwise): a flat list of
    one repeated device is one group."""
    if not devices:
        raise ValueError("ShardedSolver needs at least one device")
    nested = [isinstance(d, (list, tuple)) for d in devices]
    if any(nested) and not all(nested):
        raise ValueError("devices: either one device a shard or one list "
                         "of devices a card group, not both")
    groups = []
    if all(nested):
        for grp in devices:
            devs = {_device(d) for d in grp}
            if len(devs) != 1:
                raise ValueError(f"a card group must hold the shards of "
                                 f"one device, not {sorted(map(str, devs))}")
            groups.append((devs.pop(), len(grp)))
    else:
        for d in map(_device, devices):
            if groups and groups[-1][0] == d:
                groups[-1] = (d, groups[-1][1] + 1)
            elif any(g == d for g, _ in groups):
                raise ValueError(
                    f"the shards on {d} are not consecutive in {devices}: "
                    "a card group's shards are a run of global shards")
            else:
                groups.append((d, 1))
    if len({d.type for d, _ in groups}) > 1:
        raise ValueError("card groups on devices of more than one type")
    return groups


@dataclasses.dataclass
class CardGroup:
    """A run of ``n_shards`` consecutive EPS shards as lane groups of one
    state on ``device``: its local shard i is the process's shard
    ``offset + i``."""
    device: torch.device
    offset: int
    n_shards: int
    solver: BatchedSolver


class ShardedSolver:
    """``BatchedSolver`` over S EPS shards: lane groups of one state on
    one device, or card groups, one state each, on distinct devices (or
    beside each other on one)."""

    def __init__(self, tnf, config: EngineConfig = EngineConfig(),
                 devices=None, shard_offset: int = 0,
                 total_shards: int | None = None):
        """``devices``: one torch device per shard, or one list of them
        per card group (``card_groups``). None: one shard per visible
        card (the JAX default is every device; ``pick_device`` raises
        without CUDA). A list that repeats one device gives that many
        lane groups on it; distinct devices give a card group each, with
        a ``BatchedSolver`` of its own on its device. Every group's step
        reads the incumbent min and the live flag across the groups (K10
        on the card, ``exchange_plain`` on the CPU), so the groups walk
        what one state of every shard walks, and ``global_state`` is the
        JAX mesh's state.

        ``shard_offset`` / ``total_shards``: local shard i is global shard
        ``shard_offset + i`` of ``total_shards`` (a multi-host run; the
        defaults are one process owning every shard). A process that does
        not own shard 0 runs with the table off, as the multi-host path
        does."""
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if torch.cuda.is_available() else [pick_device()])
        spec = card_groups(devices)
        self.n_shards = sum(n for _, n in spec)
        self.shard_offset = shard_offset
        self.total_shards = (self.n_shards if total_shards is None
                             else total_shards)
        self.groups = []
        cfg = config
        for dev, n in spec:
            s = BatchedSolver(tnf, cfg, device=dev,
                              num_shards=self.total_shards)
            # Every later group takes the first one's configuration with
            # its k pinned (the root-tree probe is bounded by the wall
            # clock), so the groups agree on k, the table and the depth.
            cfg = dataclasses.replace(s.cfg, subproblems_power=s.k)
            self.groups.append(CardGroup(dev, sum(
                g.n_shards for g in self.groups), n, s))
        self.solvers = [g.solver for g in self.groups]
        self.solver = self.solvers[0]
        self.device = self.solver.device
        if shard_offset > 0 and self.solver.use_table:
            raise ValueError(
                f"shard_offset {shard_offset} with the EPS table on: the "
                "table rows of a process are indexed by local shard; run "
                "the shards of a multi-host process with use_table=False")
        self._xc = None  # the card groups' exchange on the card
        if len(self.groups) > 1 and self.device.type == "cuda":
            from ..solver.step_cuda import Exchange
            self._xc = Exchange([g.device for g in self.groups])
        self.plan = self.solver.plan
        self.opt = self.solver.opt
        self.num_sub_total = self.solver.num_sub_total
        self.rebalance_rounds = 0   # of the last solve, and their
        self.rebalance_s = 0.0      # host wall time

    @property
    def tnf(self):
        return self.solver.tnf

    # -- global state --------------------------------------------------

    def init_state(self):
        """The process's state: local shard i's lanes hold the subproblem
        range of global shard ``shard_offset + i``. One group: a
        ``SearchState``; card groups: a list of one per group, in shard
        order (``global_state`` concatenates them)."""
        while True:
            modes = [s.use_table for s in self.solvers]
            states = []
            for g in self.groups:
                shards = [g.solver.init_state(self.shard_offset + g.offset
                                              + i)
                          for i in range(g.n_shards)]
                states.append(SearchState(**{
                    f.name: torch.cat([getattr(x, f.name) for x in shards])
                    for f in dataclasses.fields(SearchState)}))
            if [s.use_table for s in self.solvers] == modes:
                break
            # A shard's table build hit its deadline and its solver fell
            # back to dive mode: the states built before hold table rows,
            # so every group's shards are rebuilt in dive mode.
            for s in self.solvers:
                s.disable_table()
        return states[0] if len(states) == 1 else states

    def states(self, st) -> list:
        """The card groups' states of ``st``, in shard order."""
        return [st] if isinstance(st, SearchState) else list(st)

    def global_state(self, st, fields=None, device=None):
        """The state the JAX mesh holds: the card groups' states
        concatenated in shard order, on ``device`` (the CPU by default);
        ``st`` itself for one group. ``fields``: only these fields (a
        namespace of them)."""
        states = self.states(st)
        if len(states) == 1:
            return st
        dev = torch.device("cpu") if device is None else device
        names = fields or [f.name for f in dataclasses.fields(SearchState)]
        cat = {n: torch.cat([getattr(x, n).to(dev) for x in states])
               for n in names}
        return (SimpleNamespace(**cat) if fields is not None
                else SearchState(**cat))

    def write_fields(self, st, fields: dict):
        """Writes ``fields`` (numpy arrays of the global state, any of its
        fields) into the card groups' tensors, in place (``copy_``), so
        that each card's captured graphs stay valid."""
        for g, x in zip(self.groups, self.states(st)):
            for name, a in fields.items():
                t = getattr(x, name)
                per = t.shape[0] // g.n_shards  # rows of one shard
                lo = g.offset * per
                t.copy_(torch.from_numpy(np.ascontiguousarray(
                    a[lo:lo + t.shape[0]])))

    def shard_rows(self, st, name: str, shard: int):
        """The rows of field ``name`` that local shard ``shard`` owns: a
        view into its group's tensor."""
        for g, x in zip(self.groups, self.states(st)):
            if g.offset <= shard < g.offset + g.n_shards:
                t = getattr(x, name)
                per = t.shape[0] // g.n_shards
                i = shard - g.offset
                return t[i * per:(i + 1) * per]
        raise IndexError(f"shard {shard} of {self.n_shards}")

    def run_steps(self, st, n: int, cap: int = 0):
        """n sharded steps. One group: ``BatchedSolver.run_steps`` over
        its state. Card groups, in lockstep with one exchange a step:
        on the card ``step_cuda.run_groups`` (in place), else
        ``run_steps_plain``. Returns (state, steps run)."""
        if len(self.groups) == 1:
            return self.solver.run_steps(st, n, cap)
        states = self.states(st)
        if states[0].lb.is_cuda:
            from ..solver import step_cuda
            ran = step_cuda.run_groups(self.solvers, states, self._xc, n,
                                       cap)
            return states, ran
        return self.run_steps_plain(states, n, cap)

    def run_steps_plain(self, states, n: int, cap: int = 0):
        """n steps of the card groups' ``states`` as plain torch ops: per
        step the exchange (``exchange_plain``), then each group's
        ``step_plain`` with it. The CPU route, and the reference of the
        card-group kernels on the card. Returns (states, steps run, a
        0-dim int32 tensor on the first group's device)."""
        dev0 = states[0].lb.device
        count = torch.zeros((), dtype=torch.int32, device=dev0)
        for _ in range(n):
            g, live = exchange_plain(states, dev0)
            states = [grp.solver.step_plain(x, cap, xchg=(
                g.to(x.lb.device), live.to(x.lb.device)))[0]
                for grp, x in zip(self.groups, states)]
            count += live.to(torch.int32)
        return states, count

    def sync(self):
        """Waits for the work on every group's card."""
        for d in {g.device for g in self.groups}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- host loop ------------------------------------------------------

    def solve(self, timeout_s: float = 1e18, chunk: int = 16,
              stop_after_n_solutions: int = 1, max_steps: int = 1 << 60,
              node_limit: int = 0, verbose: bool = False, on_improve=None,
              on_solution=None, checkpoint_path: str = "",
              checkpoint_every_s: float = 60.0, fp_cap: int = 0):
        """The mesh host loop (``turbo_tpu/parallel/mesh.py:221-416``):
        chunks of ``chunk`` steps until every lane is IDLE, the timeout,
        the hard wall of ``BatchedSolver.solve`` (with every group's
        build and warm-up on the first call), ``node_limit``,
        ``max_steps`` or (on satisfaction problems)
        ``stop_after_n_solutions``, one host read per card per chunk;
        the first chunk is the warm-up, kept out of the timers' fit, and
        no profiled split runs (as in JAX's mesh loop). The calibrator's
        one cap holds for every group. After a chunk that leaves a shard
        dry while another has more than one subproblem left, the state
        moves through the host for ``rebalance_ranges`` and back into
        the groups' tensors. ``on_solution`` drains the per-shard
        solution rings every chunk, shard by shard, under one global
        ``-n`` budget; ``fp_cap``, ``on_improve`` and the checkpoint
        (of the global state, so a lane-group file resumes in card
        groups and the other way round) are those of
        ``BatchedSolver.solve``."""
        from ..host.solver.timers import PhaseTimers
        from ..solver.checkpoint import load_state, save_state
        from ..solver.result import EngineResult
        s = self.solver
        t0 = time.monotonic()
        hard_mult = float(os.environ.get("TURBO_TPU_HARD_WALL_MULT", "2"))
        # Every group's kernel build and warm-up count once.
        t_entry = t0 - sum(x.wall_setup_s for x in self.solvers)
        for x in self.solvers:
            x.wall_setup_s = 0.0
        if self.plan.root_unsat:
            return EngineResult.unsat(self)
        D, S = s.cfg.num_dives, self.n_shards
        timers = PhaseTimers(num_lanes=D * S)
        tt = time.monotonic()
        if (s.use_table and not any(x._tables for x in self.solvers)
                and timeout_s < 1e17):
            # One deadline for every shard's table build, at half of -t;
            # a tighter one set by the caller stays binding.
            dl = time.monotonic() + max(2.0, 0.5 * timeout_s)
            for x in self.solvers:
                prev = x._table_deadline
                x._table_deadline = dl if prev is None else min(prev, dl)
        st = self.init_state()
        for x in self.solvers:
            x._table_deadline = None
        cap = fp_cap if fp_cap > 0 else s.cfg.fp_max_iters
        cal = AutoCapCalibrator(s.cfg, fp_cap)
        cap = cal.arm(cap)
        self.sync()
        timers.transfer_c2g = time.monotonic() - tt
        dive_dur = sum(tb.build_time for x in self.solvers
                       for tb in x._tables.values())
        dive_dur += sum(x._table_aborted_s for x in self.solvers)
        if checkpoint_path:
            restored = load_state(s, checkpoint_path, num_shards=S)
            if restored is not None:
                self.write_fields(st, search_state_to_numpy(restored[0]))
        last_ckpt = time.monotonic()
        ring = s.cfg.sol_ring_size
        if ring > 0 and s.cfg.enumerate_all:
            # At most D solutions land per shard per step: cap the chunk
            # so that no more than `ring` land between two drains.
            chunk = max(1, min(chunk, ring // max(D, 1)))
        ring_drained = [0] * S
        printed = 0
        overflow = 0
        steps = 0
        stopped = False
        best_seen = None
        best_obj_time = 0.0
        last_best = INF  # no incumbent yet: on_improve waits for one
        redistributions = 0
        self.rebalance_rounds, self.rebalance_s = 0, 0.0
        first_call = True
        while True:
            td = time.monotonic()
            st, ndone = self.run_steps(st, chunk, cap)
            self.sync()
            device_dur = time.monotonic() - td
            warmup, first_call = first_call, False
            tg = time.monotonic()
            # One host read per card: the scalars of its lanes (and the
            # step count, with the first group's).
            reads = []
            for i, x in enumerate(self.states(st)):
                words = torch.stack(
                    [x.phase, x.sols, x.fpit, x.best_bound, x.next_sub,
                     x.sub_limit, x.nodes, x.sol_w]).view(-1)
                if i == 0:
                    words = torch.cat([words, ndone.view(1)])
                reads.append(words.cpu().numpy())
            ndone = int(reads[0][-1])
            host = np.concatenate([r[:8 * (len(r) // 8)].reshape(8, -1)
                                   for r in reads], axis=1)
            (phase, sols, fpit, bbs, nsub, slim, nodes_v, sol_w) = host
            steps += chunk
            timers.transfer_g2c += time.monotonic() - tg
            timers.record_chunk(device_dur, int(fpit.sum()), phase, ndone,
                                time.monotonic() - t0, measured=not warmup)
            if not cal.done:
                cap, _ = cal.observe(cap, int(nodes_v.sum()), device_dur,
                                     warmup, verbose=verbose)
                if cal.done:
                    s.last_auto_cap = cal.chosen
            if ring > 0 and on_solution is not None:
                for g in range(S):
                    cur = int(sol_w[g * D])
                    if not self.opt and stop_after_n_solutions > 0:
                        # One -n budget across the shards.
                        left = max(stop_after_n_solutions - printed, 0)
                        cur = min(cur, ring_drained[g] + left)
                    if cur - ring_drained[g] > ring:
                        lost = cur - ring_drained[g] - ring
                        overflow += lost
                        print(f"% warning: shard {g} solution ring "
                              f"overflow; {lost} solutions not streamed",
                              flush=True)
                        ring_drained[g] = cur - ring
                    if cur > ring_drained[g]:
                        seg = self.shard_rows(st, "sol_ring", g)
                        slots = torch.arange(ring_drained[g], cur) % ring
                        for row in seg[slots.to(seg.device)].cpu().numpy():
                            on_solution(self.plan.store_to_tnf(row))
                            printed += 1
                        ring_drained[g] = cur
            bbm = int(bbs.min())
            if on_improve is not None and bbm < last_best:
                last_best = bbm
                d = int(bbs.argmin())
                lb = self.shard_rows(st, "best_lb", d // D)[d % D]
                on_improve(self.plan.store_to_tnf(lb.cpu().numpy()))
            if bbm < (best_seen if best_seen is not None else 1 << 40):
                best_seen = bbm
                best_obj_time = time.monotonic() - t0
            if S > 1:
                dry = (phase.reshape(S, D) == IDLE).all(axis=1)
                left = slim.reshape(S, D)[:, 0] - nsub.reshape(S, D)[:, 0]
                if dry.any() and not dry.all() and (left > 1).any():
                    tr = time.monotonic()
                    before = search_state_to_numpy(self.global_state(st))
                    fields, moves = rebalance_ranges(
                        before, D, S, self.plan.lb0, self.plan.ub0,
                        use_table=s.use_table)
                    if moves:
                        redistributions += moves
                        self.write_fields(st, {
                            k: v for k, v in fields.items()
                            if v is not before[k]})
                        phase = fields["phase"]
                    self.sync()
                    self.rebalance_rounds += 1
                    self.rebalance_s += time.monotonic() - tr
                    if verbose and moves:
                        print(f"% rebalance #{self.rebalance_rounds}: "
                              f"{moves} dry shard(s) revived", flush=True)
            if (phase == IDLE).all():
                break
            if not self.opt and sols.sum() >= stop_after_n_solutions > 0:
                stopped = True
                break
            if time.monotonic() - t0 > timeout_s or steps >= max_steps:
                stopped = True
                break
            if (timeout_s < 1e17 and hard_mult > 0
                    and time.monotonic() - t_entry > hard_mult * timeout_s):
                print("% hard wall-clock limit reached "
                      f"({hard_mult:g}x timeout incl. compile); stopping",
                      file=sys.stderr, flush=True)
                stopped = True
                break
            if node_limit and int(nodes_v.sum()) >= node_limit:
                stopped = True
                break
            if checkpoint_path and \
                    time.monotonic() - last_ckpt > checkpoint_every_s:
                save_state(s, self.global_state(st), checkpoint_path,
                           num_shards=S)
                last_ckpt = time.monotonic()
            if verbose:
                print(f"% t={time.monotonic() - t0:6.1f}s steps={steps} "
                      f"chunk_s={device_dur:.2f} nodes={int(nodes_v.sum())} "
                      f"best={bbm if bbm < INF else None} "
                      f"idle={int((phase == IDLE).sum())}/{S * D} dry "
                      f"shards={int(dry.sum()) if S > 1 else 0}/{S}",
                      flush=True)
        glob = self.global_state(st)
        if checkpoint_path and stopped:
            save_state(s, glob, checkpoint_path, num_shards=S)
        res = EngineResult.from_state(self, glob, stopped,
                                      time.monotonic() - t0)
        res.best_obj_time = best_obj_time
        res.eps_redistributions = redistributions
        res.sol_ring_overflow = overflow
        timers.fill_result(res, res.solve_time)
        res.dive_time += dive_dur
        res.table_build_time = dive_dur
        return res
