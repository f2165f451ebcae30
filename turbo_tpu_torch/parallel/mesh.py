"""EPS shards as lane groups of one search state: port of
``turbo_tpu/parallel/mesh.py``.

The JAX package spreads S EPS shards over a 1-D mesh of S devices, D
lanes each, with static per-shard subproblem ranges; the only value a
step reads across shards is the incumbent, through ``lax.pmin``. Here
the S shards are S lane groups of one ``SearchState`` on one device,
laid out as the mesh's global state: shard s owns lanes [s*D, (s+1)*D),
table rows [s*n_pad, (s+1)*n_pad) and ring rows [s*R, (s+1)*R). The
step is the batched engine's over all S*D lanes: its incumbent min over
every lane is the pmin (``ext_bound`` is the same on every lane), and
its cross-lane end (K7 on the card, ``step_tail_plain`` on the CPU) runs
per shard, each from its own counter, table and ring.

``solve`` is the mesh host loop: the calibrator, the per-shard ring
drain under a global ``-n`` budget, ``on_improve``, the host-side
``rebalance_ranges`` that revives a dry shard from the richest one,
``node_limit``, and the checkpoint with the shard count. It has no
stack steal and no tail resplit, as the JAX mesh loop has neither.

In a multi-host run (``parallel/multihost.py``) each process builds a
``ShardedSolver`` over its local shards with ``shard_offset`` and
``total_shards`` set, so that the processes' shards partition one global
subproblem space. Shards on more than one device of one process (a
collective each step) are not ported yet (ROADMAP A12(b)).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import pick_device
from ..host.core.ops import INF
from ..solver.config import EngineConfig
from ..solver.convert import search_state_from_numpy, search_state_to_numpy
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


def _one_device(devices):
    """The one torch device of ``devices`` (``cuda`` names the current
    card); raises for an empty list and for shards on distinct
    devices."""
    if not devices:
        raise ValueError("ShardedSolver needs at least one device")
    devs = set()
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.add(d)
    if len(devs) > 1:
        raise NotImplementedError(
            f"EPS shards on {len(devs)} distinct devices: the cross-card "
            "transport is not ported yet (ROADMAP A12(b)); repeat one "
            "device to run the shards as lane groups on it")
    return devs.pop()


class ShardedSolver:
    """``BatchedSolver`` over S EPS shards, each a lane group of one
    state on one device."""

    def __init__(self, tnf, config: EngineConfig = EngineConfig(),
                 devices=None, shard_offset: int = 0,
                 total_shards: int | None = None):
        """``devices``: one torch device per shard. None: one shard per
        visible card (the JAX default is every device; ``pick_device``
        raises without CUDA). A list that repeats one device gives that
        many lane groups on it; distinct devices raise.

        ``shard_offset`` / ``total_shards``: local shard i is global shard
        ``shard_offset + i`` of ``total_shards`` (a multi-host run; the
        defaults are one process owning every shard). A process that does
        not own shard 0 runs with the table off, as the multi-host path
        does: its table rows and K7's copy offsets count local shards."""
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if torch.cuda.is_available() else [pick_device()])
        self.device = _one_device(devices)
        self.n_shards = len(devices)
        self.shard_offset = shard_offset
        self.total_shards = (self.n_shards if total_shards is None
                             else total_shards)
        self.solver = BatchedSolver(tnf, config, device=self.device,
                                    num_shards=self.total_shards)
        if shard_offset > 0 and self.solver.use_table:
            raise ValueError(
                f"shard_offset {shard_offset} with the EPS table on: the "
                "table rows of a process are indexed by local shard; run "
                "the shards of a multi-host process with use_table=False")
        self.plan = self.solver.plan
        self.opt = self.solver.opt
        self.num_sub_total = self.solver.num_sub_total
        self.rebalance_rounds = 0   # of the last solve, and their
        self.rebalance_s = 0.0      # host wall time

    @property
    def tnf(self):
        return self.solver.tnf

    # -- global state --------------------------------------------------

    def init_state(self) -> SearchState:
        """The process's state: local shard i's lanes hold the subproblem
        range of global shard ``shard_offset + i``."""
        s = self.solver
        while True:
            use_table0 = s.use_table
            shards = [s.init_state(self.shard_offset + i)
                      for i in range(self.n_shards)]
            if s.use_table == use_table0:
                break
            # A shard's table build hit its deadline and the solver fell
            # back to dive mode: the states built before hold table rows,
            # so every shard is rebuilt in dive mode.
        return SearchState(**{
            f.name: torch.cat([getattr(x, f.name) for x in shards])
            for f in dataclasses.fields(SearchState)})

    def run_steps(self, st: SearchState, n: int, cap: int = 0):
        """n sharded steps (``BatchedSolver.run_steps`` over the global
        state). Returns (state, steps run)."""
        return self.solver.run_steps(st, n, cap)

    # -- host loop ------------------------------------------------------

    def solve(self, timeout_s: float = 1e18, chunk: int = 16,
              stop_after_n_solutions: int = 1, max_steps: int = 1 << 60,
              node_limit: int = 0, verbose: bool = False, on_improve=None,
              on_solution=None, checkpoint_path: str = "",
              checkpoint_every_s: float = 60.0, fp_cap: int = 0):
        """The mesh host loop (``turbo_tpu/parallel/mesh.py:221-416``
        without the hard wall): chunks of ``chunk`` steps until every
        lane is IDLE, the timeout, ``node_limit``, ``max_steps`` or (on
        satisfaction problems) ``stop_after_n_solutions``, one host read
        per chunk. After a chunk that leaves a shard dry while another
        has more than one subproblem left, the state moves through the
        host for ``rebalance_ranges``. ``on_solution`` drains the
        per-shard solution rings every chunk, shard by shard, under one
        global ``-n`` budget; ``fp_cap``, ``on_improve`` and the
        checkpoint are those of ``BatchedSolver.solve``."""
        from ..host.solver.timers import PhaseTimers
        from ..solver.checkpoint import load_state, save_state
        from ..solver.result import EngineResult
        s = self.solver
        t0 = time.monotonic()
        if self.plan.root_unsat:
            return EngineResult.unsat(self)
        D, S = s.cfg.num_dives, self.n_shards
        timers = PhaseTimers(num_lanes=D * S)
        tt = time.monotonic()
        if s.use_table and not s._tables and timeout_s < 1e17:
            # One deadline for every shard's table build, at half of -t;
            # a tighter one set by the caller stays binding.
            dl = time.monotonic() + max(2.0, 0.5 * timeout_s)
            prev = s._table_deadline
            s._table_deadline = dl if prev is None else min(prev, dl)
        st = self.init_state()
        s._table_deadline = None
        cap = fp_cap if fp_cap > 0 else s.cfg.fp_max_iters
        cal = AutoCapCalibrator(s.cfg, fp_cap)
        cap = cal.arm(cap)
        s._sync()
        timers.transfer_c2g = time.monotonic() - tt
        dive_dur = sum(tb.build_time for tb in s._tables.values())
        dive_dur += s._table_aborted_s
        if checkpoint_path:
            restored = load_state(s, checkpoint_path, num_shards=S)
            if restored is not None:
                st = restored[0]
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
            st, ndone = s.run_steps(st, chunk, cap)
            s._sync()
            device_dur = time.monotonic() - td
            warmup, first_call = first_call, False
            tg = time.monotonic()
            host = torch.cat([torch.stack(
                [st.phase, st.sols, st.fpit, st.best_bound, st.next_sub,
                 st.sub_limit, st.nodes, st.sol_w]).view(-1),
                ndone.view(1)]).cpu().numpy()
            ndone = int(host[-1])
            (phase, sols, fpit, bbs, nsub, slim, nodes_v,
             sol_w) = host[:-1].reshape(8, S * D)
            steps += chunk
            timers.transfer_g2c += time.monotonic() - tg
            timers.record_chunk(device_dur, int(fpit.sum()), phase, ndone,
                                time.monotonic() - t0)
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
                        slots = g * ring + torch.arange(ring_drained[g],
                                                        cur) % ring
                        rows = st.sol_ring[slots.to(st.sol_ring.device)]
                        for row in rows.cpu().numpy():
                            on_solution(self.plan.store_to_tnf(row))
                            printed += 1
                        ring_drained[g] = cur
            bbm = int(bbs.min())
            if on_improve is not None and bbm < last_best:
                last_best = bbm
                d = int(bbs.argmin())
                on_improve(self.plan.store_to_tnf(st.best_lb[d].cpu().numpy()))
            if bbm < (best_seen if best_seen is not None else 1 << 40):
                best_seen = bbm
                best_obj_time = time.monotonic() - t0
            if S > 1:
                dry = (phase.reshape(S, D) == IDLE).all(axis=1)
                left = slim.reshape(S, D)[:, 0] - nsub.reshape(S, D)[:, 0]
                if dry.any() and not dry.all() and (left > 1).any():
                    tr = time.monotonic()
                    fields, moves = rebalance_ranges(
                        search_state_to_numpy(st), D, S, self.plan.lb0,
                        self.plan.ub0, use_table=s.use_table)
                    if moves:
                        redistributions += moves
                        st = search_state_from_numpy(fields, s.device)
                        phase = fields["phase"]
                    s._sync()
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
            if node_limit and int(nodes_v.sum()) >= node_limit:
                stopped = True
                break
            if checkpoint_path and \
                    time.monotonic() - last_ckpt > checkpoint_every_s:
                save_state(s, st, checkpoint_path, num_shards=S)
                last_ckpt = time.monotonic()
            if verbose:
                print(f"% t={time.monotonic() - t0:6.1f}s steps={steps} "
                      f"chunk_s={device_dur:.2f} nodes={int(nodes_v.sum())} "
                      f"best={bbm if bbm < INF else None} "
                      f"idle={int((phase == IDLE).sum())}/{S * D} dry "
                      f"shards={int(dry.sum()) if S > 1 else 0}/{S}",
                      flush=True)
        if checkpoint_path and stopped:
            save_state(s, st, checkpoint_path, num_shards=S)
        res = EngineResult.from_state(self, st, stopped,
                                      time.monotonic() - t0)
        res.best_obj_time = best_obj_time
        res.eps_redistributions = redistributions
        res.sol_ring_overflow = overflow
        timers.fill_result(res, res.solve_time)
        res.dive_time += dive_dur
        res.table_build_time = dive_dur
        return res
