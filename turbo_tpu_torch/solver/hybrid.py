"""Hybrid architecture: host-owned search, device-batched propagation.

Port of ``turbo_tpu/solver/hybrid.py``. The host owns C cube searches in
numpy: an explicit DFS stack of (store, depth, strategy) snapshots per
cube, EPS bit-path diving with subtree skipping, and branch and bound
through a host incumbent. Every round it batches the current node of
every active cube into one (C_active, V) propagation on the device: one
launch of K1 (or K8 under ``fp_mode="wac1"``), one of K2, and one host
read of the stores, sweep counts and classification. The batch shrinks
and grows from round to round; the kernels run one block per row, so no
padding is needed. On a CPU device the plain versions run.

The whole search state is host-side, so a checkpoint is a pickle of the
cubes and counters, guarded by the plan's identity.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import sys
import time
from typing import List

import numpy as np
import torch

from ..device import pick_device
from ..host.core.ops import INF, NINF
from ..host.solver import strategy as _strategy
from ..host.solver.oracle import branch_children as _children
from ..host.solver.plan import build_plan
from .config import (EngineConfig, apply_strategy_config, auto_max_depth,
                     probe_tree_power)
from .convert import DevicePlan
from .engine import warm_kernels
from .propagate import PropagatorKernels
from .result import EngineResult

I32 = torch.int32
_CKPT_FIELDS = ("next_sub", "best_bound", "best_lb", "best_ub",
                "best_obj_time", "nodes", "fails", "sols", "fpit_total",
                "deds", "depth_max", "solved_sub", "skipped_sub",
                "exhaustive")


class _Cube:
    __slots__ = ("lb", "ub", "depth", "strat", "stack", "remaining",
                 "subp", "active")

    def __init__(self):
        self.active = False
        self.stack: List = []
        self.remaining = 0
        self.subp = -1
        self.lb = self.ub = None
        self.depth = 0
        self.strat = 0


class HybridSolver:
    def __init__(self, tnf, config: EngineConfig = EngineConfig(),
                 device=None):
        """``device`` None: the card (``pick_device``; raises without
        CUDA). The CPU runs the plain versions only when asked."""
        self.tnf = tnf
        self.device = pick_device() if device is None else torch.device(device)
        self.plan = build_plan(tnf, disable_simplify=config.disable_simplify,
                               shave=config.shave)
        if config.max_depth <= 0:
            config = dataclasses.replace(
                config, max_depth=auto_max_depth(self.plan))
        self.cfg = config
        self.has_eps = apply_strategy_config(self.plan, config)
        self.dp = DevicePlan.from_plan(self.plan, self.device)
        self.kernels = PropagatorKernels(self.dp)
        self.opt = self.plan.is_opt
        C = config.num_dives
        k = config.subproblems_power
        if k <= 0:
            total = max(1, config.subproblems_factor * C)
            k = max(1, int(np.ceil(np.log2(total))))
            if not config.enumerate_all:
                kp = probe_tree_power(tnf)
                if kp is not None:
                    k = min(k, kp)
        self.k = min(k, 30)
        self.num_sub_total = 1 << self.k
        self.wac1 = (config.fp_mode == "wac1"
                     and self.plan.num_real_props >= config.wac1_threshold)
        self.build_time = 0.0
        self.warm_time = warm_kernels(self)

    # -- device round ---------------------------------------------------

    def _fp(self, lb, ub):
        """The batch's propagation to the fixpoint: (lb, ub, iters, _)."""
        if self.wac1:
            return self.kernels.fixpoint_wac1(lb, ub, self.cfg.fp_max_iters,
                                              self.cfg.wac1_inner_cap)
        return self.kernels.fixpoint(lb, ub, self.cfg.fp_max_iters)

    def _post(self, lb, ub):
        """(bot, ent) of the batch."""
        return self.kernels.classify(lb, ub)

    def propagate_round(self, L: np.ndarray, U: np.ndarray):
        """One round on the device: upload the (C, V) batch, ``_fp``,
        ``_post``, and one host read. Returns numpy (lb, ub, iters, bot,
        ent)."""
        C, V = L.shape
        both = torch.from_numpy(np.stack([L, U])).to(self.device)
        lb, ub, it, _ = self._fp(both[0], both[1])
        bot, ent = self._post(lb, ub)
        flat = torch.cat([lb.reshape(-1), ub.reshape(-1), it, bot.to(I32),
                          ent.to(I32)]).cpu().numpy()
        n = C * V
        return (flat[:n].reshape(C, V), flat[n:2 * n].reshape(C, V),
                flat[2 * n:2 * n + C], flat[2 * n + C:2 * n + 2 * C] != 0,
                flat[2 * n + 2 * C:] != 0)

    # -- host-side branching ------------------------------------------

    def _select(self, lb: np.ndarray, ub: np.ndarray, strat: int):
        """First strategy >= cursor with a splittable var; smallest
        position tie-break (the engine's selection in numpy)."""
        for si in range(strat, len(self.plan.strategies)):
            s = self.plan.strategies[si]
            ids = s.ids
            l, u = lb[ids], ub[ids]
            ok = (l < u) & (l > NINF) & (u < INF)
            if not ok.any():
                continue
            vo = _strategy.VO_CODE.get(s.var_order, 0)
            # int64 keys: an int32 key would wrap the big sentinel to -1
            # and select padding slots.
            key = _strategy.split_key(np, vo,
                                      np.arange(len(ids), dtype=np.int64),
                                      l.astype(np.int64), u.astype(np.int64))
            pos = int(np.argmin(np.where(ok, key, np.iinfo(np.int64).max)))
            return si, int(ids[pos]), s.val_order
        return None

    # -- solve ---------------------------------------------------------

    def _checkpoint_sig(self):
        """Identity guard: a snapshot must only resume the same
        instance and configuration."""
        return (self.plan.shape_signature, self.plan.data_digest,
                self.k, self.cfg.num_dives, self.cfg.max_depth)

    def solve(self, timeout_s: float = 1e18,
              stop_after_n_solutions: int = 1, node_limit: int = 0,
              verbose: bool = False, on_improve=None,
              checkpoint_path: str = "", checkpoint_every_s: float = 60.0,
              **_ignored) -> EngineResult:
        from ..host.solver.timers import PhaseTimers
        t0 = time.monotonic()
        if self.plan.root_unsat:
            return EngineResult.unsat(self)
        plan = self.plan
        C = self.cfg.num_dives
        obj = plan.obj
        timers = PhaseTimers(num_lanes=C)

        cubes = [_Cube() for _ in range(C)]
        next_sub = 0
        best_bound = INF
        best_lb = best_ub = None
        best_obj_time = 0.0
        nodes = fails = sols = fpit_total = 0
        deds = 0.0
        depth_max = 0
        solved_sub = skipped_sub = 0
        exhaustive = True
        stopped = False
        maxd = self.cfg.max_depth

        root_lb = plan.lb0.astype(np.int32)
        root_ub = plan.ub0.astype(np.int32)

        def grab(cube) -> bool:
            nonlocal next_sub
            if next_sub >= self.num_sub_total:
                return False
            cube.subp = next_sub
            next_sub += 1
            cube.remaining = self.k
            cube.lb = root_lb.copy()
            cube.ub = root_ub.copy()
            cube.depth = 0
            cube.strat = 0
            cube.stack = []
            cube.active = True
            return True

        def next_work(cube) -> bool:
            nonlocal solved_sub
            if cube.stack:
                cube.lb, cube.ub, cube.depth, cube.strat = cube.stack.pop()
                return True
            if cube.active and cube.subp >= 0:
                solved_sub += 1
                cube.subp = -1
            if grab(cube):
                return True
            cube.active = False
            return False

        def save_ckpt():
            # Reads the loop's current counters at each call.
            snap = {"sig": self._checkpoint_sig(),
                    "cubes": [(c.active, c.subp, c.remaining, c.depth,
                               c.strat, c.lb, c.ub, c.stack)
                              for c in cubes],
                    "next_sub": next_sub, "best_bound": best_bound,
                    "best_lb": best_lb, "best_ub": best_ub,
                    "best_obj_time": best_obj_time, "nodes": nodes,
                    "fails": fails, "sols": sols,
                    "fpit_total": fpit_total, "deds": deds,
                    "depth_max": depth_max, "solved_sub": solved_sub,
                    "skipped_sub": skipped_sub, "exhaustive": exhaustive}
            tmp = checkpoint_path + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as fh:
                pickle.dump(snap, fh)
            os.replace(tmp, checkpoint_path)

        resumed = False
        if checkpoint_path and os.path.exists(checkpoint_path):
            try:
                with open(checkpoint_path, "rb") as fh:
                    snap = pickle.load(fh)
                if snap.get("sig") != self._checkpoint_sig():
                    raise ValueError("checkpoint from a different "
                                     "instance/configuration")
                for c, (a, sp, rem, dep, strt, l, u, stk) in zip(
                        cubes, snap["cubes"]):
                    c.active, c.subp, c.remaining = a, sp, rem
                    c.depth, c.strat = dep, strt
                    c.lb, c.ub, c.stack = l, u, stk
                (next_sub, best_bound, best_lb, best_ub, best_obj_time,
                 nodes, fails, sols, fpit_total, deds, depth_max,
                 solved_sub, skipped_sub, exhaustive) = (
                    snap[f] for f in _CKPT_FIELDS)
                resumed = True
                print(f"% resumed hybrid checkpoint: {nodes} nodes, "
                      f"next_sub={next_sub}/{self.num_sub_total}",
                      file=sys.stderr)
            except Exception as e:
                print(f"% WARNING: could not resume checkpoint "
                      f"{checkpoint_path} ({e}); starting fresh",
                      file=sys.stderr)
        if not resumed:
            for cube in cubes:
                grab(cube)
        last_ckpt = time.monotonic()
        first_round = True

        while True:
            act = [c for c in cubes if c.active]
            if not act:
                break
            if time.monotonic() - t0 > timeout_s or \
                    (node_limit and nodes >= node_limit):
                stopped = True
                # Snapshot before clearing exhaustive: the interruption
                # makes this run non-exhaustive, but the saved search
                # state is complete, and a resumed run can still prove.
                if checkpoint_path:
                    save_ckpt()
                exhaustive = False
                break
            if checkpoint_path and \
                    time.monotonic() - last_ckpt > checkpoint_every_s:
                save_ckpt()
                last_ckpt = time.monotonic()
            # Branch and bound: tighten the objective from the shared
            # incumbent.
            if self.opt and best_bound < INF:
                for c in act:
                    if c.remaining == 0:
                        c.ub[obj] = min(c.ub[obj], best_bound - 1)
            # One batched device propagation for every cube's current
            # node.
            tt = time.monotonic()
            L = np.stack([c.lb for c in act])
            U = np.stack([c.ub for c in act])
            timers.transfer_c2g += time.monotonic() - tt
            td = time.monotonic()
            Lh, Uh, ith, both, enth = self.propagate_round(L, U)
            now = time.monotonic()
            # The read blocks until the kernels are done, so (now - td)
            # is device time and transfer together.
            phases = np.array([0 if c.remaining > 0 else 1 for c in act])
            # The first round carries one-time start-up cost (context,
            # table upload): keep it out of the time attribution and
            # restart the solve clock after it, as the batched engine
            # does with its first chunk.
            warmup = first_round
            if first_round:
                first_round = False
                t0 = now
            timers.record_chunk(now - td, fpit_total + int(ith.sum()),
                                phases, 1, now - t0, measured=not warmup)
            for i, c in enumerate(act):
                c.lb, c.ub = Lh[i].copy(), Uh[i].copy()
                nodes += 1
                fpit_total += int(ith[i])
                deds += float(ith[i]) * plan.num_real_props
                depth_max = max(depth_max, c.depth)
                diving = c.remaining > 0
                if both[i]:
                    fails += 1
                    if diving:
                        # Every dive leaf advances the shared counter.
                        # The accounting partitions the space exactly:
                        # the leftmost lane of the dead prefix subtree
                        # counts itself solved (via next_work) and the
                        # rest of the range skipped; other lanes in the
                        # range count nothing.
                        nxt = ((c.subp >> c.remaining) + 1) << c.remaining
                        if (c.subp & ((1 << c.remaining) - 1)) == 0:
                            skipped_sub += nxt - c.subp - 1
                        else:
                            c.subp = -1  # suppress the solved count
                        next_sub = max(next_sub, nxt)
                    next_work(c)
                    continue
                if enth[i] and self.cfg.enumerate_all and not self.opt \
                        and self._select(c.lb, c.ub, c.strat) is not None:
                    # All-solutions mode: an entailed box with unfixed
                    # vars keeps splitting (solutions are singleton
                    # stores).
                    enth_i = False
                else:
                    enth_i = bool(enth[i])
                if enth_i:
                    # A solution reached mid-dive skips its whole prefix
                    # subtree and is counted only from the leftmost
                    # subproblem, to avoid duplicates.
                    leftmost = (c.subp & ((1 << c.remaining) - 1)) == 0
                    if diving:
                        nxt = ((c.subp >> c.remaining) + 1) << c.remaining
                        next_sub = max(next_sub, nxt)
                        if leftmost:
                            skipped_sub += nxt - c.subp - 1
                        else:
                            c.subp = -1  # inside the leftmost's range
                    if self.cfg.enumerate_all and diving and not leftmost:
                        next_work(c)
                        continue
                    if (not self.opt) or int(c.lb[obj]) < best_bound:
                        best_lb, best_ub = c.lb.copy(), c.ub.copy()
                        sols += 1
                        if self.opt:
                            best_bound = int(c.lb[obj])
                            best_obj_time = time.monotonic() - t0
                        if on_improve is not None:
                            on_improve(plan.store_to_tnf(best_lb))
                        if not self.opt and stop_after_n_solutions and \
                                sols >= stop_after_n_solutions:
                            stopped = True
                            exhaustive = False
                            act = []
                            break
                    next_work(c)
                    continue
                sel = self._select(c.lb, c.ub, c.strat)
                if sel is None:
                    exhaustive = False  # unbounded domains remain
                    next_work(c)
                    continue
                si, var, val_order = sel
                if diving:
                    bit = (c.subp >> (c.remaining - 1)) & 1
                    (l0, u0), (l1, u1) = _children(
                        val_order, int(c.lb[var]), int(c.ub[var]))
                    lo, hi = (l1, u1) if bit else (l0, u0)
                    c.lb[var] = max(c.lb[var], lo)
                    c.ub[var] = min(c.ub[var], hi)
                    c.remaining -= 1
                    if c.remaining == 0:
                        # Skip the EPS dive strategy once the dive ends.
                        c.strat = max(si, int(self.has_eps))
                    continue
                if c.depth >= maxd:
                    exhaustive = False
                    next_work(c)
                    continue
                (l0, u0), (l1, u1) = _children(
                    val_order, int(c.lb[var]), int(c.ub[var]))
                rlb, rub = c.lb.copy(), c.ub.copy()
                rlb[var] = max(rlb[var], l1)
                rub[var] = min(rub[var], u1)
                c.stack.append((rlb, rub, c.depth + 1, si))
                c.lb[var] = max(c.lb[var], l0)
                c.ub[var] = min(c.ub[var], u0)
                c.depth += 1
                c.strat = si
            if stopped:
                if checkpoint_path:
                    save_ckpt()
                break

        solve_time = time.monotonic() - t0
        exhaustive = exhaustive and not stopped
        res = EngineResult(
            status="unknown", objective=None, best_lb=None, best_ub=None,
            nodes=nodes, fails=fails, solutions=sols,
            fixpoint_iterations=fpit_total, num_deductions=deds,
            depth_max=depth_max, eps_num_subproblems=self.num_sub_total,
            eps_solved_subproblems=solved_sub,
            eps_skipped_subproblems=skipped_sub,
            exhaustive=exhaustive, solve_time=solve_time,
            num_blocks=C, num_blocks_done=sum(not c.active for c in cubes),
            variables=self.tnf.num_vars, propagators=plan.num_real_props)
        res.best_obj_time = best_obj_time
        timers.fill_result(res, solve_time)
        # The device does only propagation here, so the split is
        # measured, not fitted: device busy time is the fixpoint, the
        # remaining host time the search (the device idles meanwhile).
        res.fixpoint_time = timers.device_time / max(C, 1)
        res.search_time = max(
            solve_time - timers.device_time - timers.transfer_c2g
            - timers.transfer_g2c, 0.0) / max(C, 1)
        res.wait_cpu_time = res.search_time
        if best_lb is None:
            res.status = "unsat" if exhaustive else "unknown"
            return res
        res.best_lb, res.best_ub = plan.store_to_tnf(best_lb, best_ub)
        if self.opt:
            if self.tnf.is_max:
                res.objective = int(res.best_ub[self.tnf.orig_obj_var])
            else:
                res.objective = int(res.best_lb[self.tnf.obj_var])
            res.status = "optimal" if exhaustive else "sat"
        else:
            res.status = "sat"
        return res
