"""Batched EPS dive-and-solve engine in PyTorch (table off).

Port of ``turbo_tpu/solver/engine.py`` for the configuration
``use_table=False, fp_cap_auto=False, fp_mode="fixpoint"``: D dives
advance in lockstep, one search node per ``step``, on (D, ·) tensors on
one device. Per step the three kernels run the heavy part: the
propagation fixpoint and the bot/entailment classification
(``PropagatorKernels``) and branch selection (``_select``); the rest of
the step is plain batched torch ops.

``step`` consumes its input state: the decision stacks (D, MAXD) are
updated in place (the JAX step donates its input the same way); every
other field of the returned state is a new tensor.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..host.core.ops import INF, NINF
from ..host.solver import strategy as _strategy
from ..host.solver.plan import build_plan
from .config import (EngineConfig, apply_strategy_config, auto_max_depth,
                     choose_subproblems_power)
from .convert import DevicePlan
from .propagate import PropagatorKernels

I32 = torch.int32
F32 = torch.float32
DIVE, SOLVE, IDLE = 0, 1, 2


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
    kpow: torch.Tensor        # (D,) replicated instance scalars
    sub_limit: torch.Tensor
    pscale: torch.Tensor      # (D,) float32 live propagators per sweep
    eps_strat: torch.Tensor
    ext_bound: torch.Tensor   # (D,) INF: one device, no remote incumbent


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
                 device="cpu"):
        if config.use_table or config.fp_cap_auto or config.enumerate_all:
            raise NotImplementedError(
                "this engine runs use_table=False, fp_cap_auto=False, "
                "enumerate_all=False only")
        self.tnf = tnf
        self.cfg = config
        self.device = torch.device(device)
        self.plan = build_plan(tnf, disable_simplify=config.disable_simplify,
                               shave=config.shave)
        self.has_eps = apply_strategy_config(self.plan, config)
        if config.max_depth <= 0:
            self.cfg = config = dataclasses.replace(
                config, max_depth=auto_max_depth(self.plan))
        self.k = choose_subproblems_power(tnf, config, 1)
        self.num_sub_total = 1 << self.k
        self.opt = self.plan.is_opt
        self.dp = DevicePlan.from_plan(self.plan, self.device)
        self.kernels = PropagatorKernels(self.dp)
        self.build_time = 0.0
        if self.device.type == "cuda":
            from .. import kernels
            t0 = time.monotonic()
            kernels.load()
            self.build_time = time.monotonic() - t0

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

    def init_state(self) -> SearchState:
        """Fresh search state (dive mode): lane d takes subproblem d."""
        D = self.cfg.num_dives
        MAXD = self.cfg.max_depth
        dev = self.device
        dp = self.dp

        def mat(base):
            return base[None, :].repeat(D, 1)

        def full(v, dtype=I32):
            return torch.full((D,), v, dtype=dtype, device=dev)

        limit = self.num_sub_total
        subp = torch.arange(D, dtype=I32, device=dev)
        stacks = {f: torch.zeros((D, MAXD), dtype=I32, device=dev)
                  for f in ("dec_var", "dec_l0", "dec_u0", "dec_l1",
                            "dec_u1", "dec_rope1", "dec_cur")}
        return SearchState(
            lb=mat(dp.lb0), ub=mat(dp.ub0),
            root_lb=mat(dp.lb0), root_ub=mat(dp.ub0),
            best_lb=mat(dp.lb0), best_ub=mat(dp.ub0),
            best_bound=full(INF), has_best=full(False, torch.bool),
            **stacks,
            depth=full(0), phase=torch.where(subp < limit, DIVE, IDLE).to(I32),
            remaining=full(self.k), subp=subp,
            strat=full(0), snap_strat=full(0),
            next_sub=full(min(D, limit)), nonexh=full(False, torch.bool),
            nodes=full(0), fails=full(0), sols=full(0), fpit=full(0),
            deds=full(0.0, F32), dmax=full(0),
            solved_sub=full(0), skipped_sub=full(0),
            kpow=full(self.k), sub_limit=full(limit),
            pscale=full(float(dp.num_real_props), F32),
            eps_strat=full(int(self.has_eps)),
            ext_bound=full(INF))

    # -- the step -------------------------------------------------------

    def step(self, st: SearchState) -> SearchState:
        D = self.cfg.num_dives
        MAXD = self.cfg.max_depth
        dp = self.dp
        obj = dp.obj
        dev = self.device
        where = torch.where

        promote = (st.phase == DIVE) & (st.remaining == 0)
        phase = where(promote, SOLVE, st.phase)
        # After the dive, skip the EPS strategy if one is configured.
        strat0 = where(promote, torch.maximum(st.strat, st.eps_strat),
                       st.strat)
        act = phase != IDLE
        in_dive = phase == DIVE
        in_solve = phase == SOLVE
        lb, ub = st.lb, st.ub
        best_bound = st.best_bound

        # I. Tighten the objective from the incumbent (one device: the
        # batch min replaces the mesh pmin).
        if dp.is_opt:
            g = torch.minimum(best_bound.min(), st.ext_bound[0])
            lim = torch.minimum(g, best_bound) - 1
        else:
            lim = torch.full_like(best_bound, INF)
        ub = ub.clone()
        ub[:, obj] = where(in_solve, torch.minimum(ub[:, obj], lim),
                           ub[:, obj])

        # II. Propagate to the fixpoint (capped), classify, hold.
        lb, ub, iters, unconv = self.kernels.fixpoint(lb, ub,
                                                     self.cfg.fp_max_iters)
        bot, ent = self.kernels.classify(lb, ub)
        ent = ent & ~bot
        held = unconv & ~bot & ~ent

        # IV(a). Branch selection and the children of the chosen var.
        found, var, nstrat, valo, c0l, c0u, c1l, c1u = self._select(
            lb, ub, strat0)
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
            better = lb[:, obj] < torch.minimum(best_bound, st.ext_bound[0])
        else:
            better = ~st.has_best
        impr = act & sol & better
        best_lb = where(impr[:, None], lb, st.best_lb)
        best_ub = where(impr[:, None], ub, st.best_ub)
        best_bound = where(impr, lb[:, obj] if dp.is_opt else 0, best_bound)
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
            return dst

        dec_var = push(st.dec_var, var)
        dec_l0 = push(st.dec_l0, c0l)
        dec_u0 = push(st.dec_u0, c0u)
        dec_l1 = push(st.dec_l1, c1l)
        dec_u1 = push(st.dec_u1, c1u)
        dec_rope1 = push(st.dec_rope1, rope1.to(I32))
        dec_cur = push(st.dec_cur, torch.zeros_like(var))
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
        bt = act & leaf & in_solve
        lastd = (depth - 1).clamp(0, MAXD - 1).long()[:, None]
        last_cur = dec_cur.gather(1, lastd)[:, 0]
        last_rope1 = dec_rope1.gather(1, lastd)[:, 0]
        t = where(last_cur == 0, depth, last_rope1)
        done_sub = bt & ((depth == 0) | (t == -1))
        restore = bt & (depth > 0) & (t != -1)
        tm1 = (t - 1).clamp(0, MAXD - 1).long()[:, None]
        dec_cur.scatter_(1, tm1, where(restore, 1, dec_cur.gather(1, tm1)[:, 0])[:, None])

        # Rebuild the store: root snapshot meet all decisions < t at
        # their current child. Only the first max(t) entries can be live.
        tr = where(restore, t, 0)
        w = int(tr.max())
        if w > 0:
            live = torch.arange(w, dtype=I32, device=dev)[None, :] < tr[:, None]
            cur1 = dec_cur[:, :w] == 1
            cl = where(live, where(cur1, dec_l1[:, :w], dec_l0[:, :w]), NINF)
            cu = where(live, where(cur1, dec_u1[:, :w], dec_u0[:, :w]), INF)
            tvar = where(live, dec_var[:, :w], 0).long()
            reb_lb = root_lb.scatter_reduce(1, tvar, cl, "amax")
            reb_ub = root_ub.scatter_reduce(1, tvar, cu, "amin")
            lb = where(restore[:, None], reb_lb, lb)
            ub = where(restore[:, None], reb_ub, ub)
        depth = where(restore, t, depth)
        strat = where(branching, nstrat, strat0)
        strat = where(restore, snap_strat, strat)

        # VIII. Dive leaves: skip the unreachable subtree.
        dleaf = act & leaf & in_dive
        one = torch.ones_like(remaining)
        nxt = ((st.subp >> remaining) + 1) << remaining
        dleaf_left = dleaf & ((st.subp & ((one << remaining) - 1)) == 0)
        skip_gain = where(dleaf_left, nxt - st.subp - 1, 0)
        skipped_sub = st.skipped_sub + skip_gain
        next_sub = torch.maximum(st.next_sub[0], where(dleaf, nxt, 0).max())

        # IX. Refill finished lanes from the subproblem counter.
        shard_limit = st.sub_limit[0]
        want = dleaf | done_sub
        solved_sub = st.solved_sub + (done_sub | dleaf_left).to(I32)
        rank = torch.cumsum(want.to(I32), dim=0, dtype=I32) - 1
        newidx = next_sub + where(want, rank, 0)
        havework = want & (newidx < shard_limit)
        next_sub = torch.minimum(next_sub + want.sum().to(I32), shard_limit)
        refill = havework
        next_sub = next_sub.expand(D).clone()
        phase = where(want, where(havework, DIVE, IDLE), phase).to(I32)
        lb = where(refill[:, None], dp.lb0[None, :], lb)
        ub = where(refill[:, None], dp.ub0[None, :], ub)
        depth = where(refill, 0, depth)
        strat = where(refill, 0, strat)
        remaining = where(refill, st.kpow, remaining)
        subp = where(refill, newidx, st.subp)

        return dataclasses.replace(
            st, lb=lb, ub=ub, root_lb=root_lb, root_ub=root_ub,
            best_lb=best_lb, best_ub=best_ub, best_bound=best_bound,
            has_best=has_best, dec_var=dec_var, dec_l0=dec_l0,
            dec_u0=dec_u0, dec_l1=dec_l1, dec_u1=dec_u1,
            dec_rope1=dec_rope1, dec_cur=dec_cur, depth=depth, phase=phase,
            remaining=remaining, subp=subp, strat=strat,
            snap_strat=snap_strat, next_sub=next_sub, nonexh=nonexh,
            nodes=nodes, fails=fails, sols=sols, fpit=fpit, deds=deds,
            dmax=dmax, solved_sub=solved_sub, skipped_sub=skipped_sub)

    def run_steps(self, st: SearchState, n: int):
        """Up to n steps, stopping early once every lane is IDLE (the
        JAX ``make_step_budget`` loop). Returns (state, steps run)."""
        i = 0
        while i < n and bool((st.phase != IDLE).any()):
            st = self.step(st)
            i += 1
        return st, i

    # -- host loop ------------------------------------------------------

    def solve(self, timeout_s: float = 1e18, chunk: int = 16,
              stop_after_n_solutions: int = 1, max_steps: int = 1 << 60,
              node_limit: int = 0, on_improve=None):
        """Single-device host loop: chunks of ``step`` until every lane
        is IDLE, the timeout, ``node_limit``, ``max_steps`` or (on
        satisfaction problems) ``stop_after_n_solutions``. Kernels were
        built in ``__init__``: the solve clock starts here."""
        from ..host.solver.timers import PhaseTimers
        from .result import EngineResult
        t0 = time.monotonic()
        if self.plan.root_unsat:
            return EngineResult.unsat(self)
        timers = PhaseTimers(num_lanes=self.cfg.num_dives)
        tt = time.monotonic()
        st = self.init_state()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timers.transfer_c2g = time.monotonic() - tt
        steps = 0
        stopped = False
        best_obj_time = 0.0
        best_seen = None
        last_best = INF + 1
        while True:
            td = time.monotonic()
            st, ndone = self.run_steps(st, chunk)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            device_dur = time.monotonic() - td
            tg = time.monotonic()
            phase, sols, fpit, bbs, nodes_v = (
                x.cpu().numpy() for x in (st.phase, st.sols, st.fpit,
                                          st.best_bound, st.nodes))
            steps += ndone
            timers.transfer_g2c += time.monotonic() - tg
            timers.record_chunk(device_dur, int(fpit.sum()), phase, ndone,
                                time.monotonic() - t0)
            bbm = int(bbs.min())
            if on_improve is not None and bbm < last_best:
                last_best = bbm
                d = int(bbs.argmin())
                on_improve(self.plan.store_to_tnf(st.best_lb[d].cpu().numpy()))
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
            if node_limit and int(nodes_v.sum()) >= node_limit:
                stopped = True
                break
        res = EngineResult.from_state(self, st, stopped,
                                      time.monotonic() - t0)
        res.best_obj_time = best_obj_time
        timers.fill_result(res, res.solve_time)
        return res
