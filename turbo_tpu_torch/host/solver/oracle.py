"""Sequential propagate-and-search oracle (the "cpu" architecture).

Mirrors the reference's CPU solver (cpu_solving.hpp:8-50): Gauss-
Seidel-style AC-1 fixpoint, entailment-based solution detection
(a node is a solution when every propagator is entailed, with the
objective value read as lb(obj) — barebones_dive_and_solve.hpp:992-1009),
branch-and-bound by tightening ub(obj) to best-1 at each node, and
DFS with left-child-first exploration matching the reference's
LightBranch child ordering (barebones_dive_and_solve.hpp:355-404).

Used both as a usable solver backend and as the semantics oracle that
the batched TPU engine is differentially tested against (SURVEY.md §4:
the reference's cpu-vs-gpu oracle pattern).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from ..core.ops import INF, NINF, NUM_OPS
from ..compile.tnf import Strategy, Tnf
from . import deduce_np


class PropTable:
    """Propagators grouped by op for vectorized deduction, plus native
    element / membership constraint tables."""

    def __init__(self, tnf: Tnf):
        self.num_vars = tnf.num_vars
        order = np.argsort(tnf.ops, kind="stable")
        self.ops = tnf.ops[order]
        self.xs = tnf.xs[order].astype(np.int64)
        self.ys = tnf.ys[order].astype(np.int64)
        self.zs = tnf.zs[order].astype(np.int64)
        self.num_props = len(self.ops)
        self.groups: List[Tuple[int, slice]] = []
        for op in range(NUM_OPS):
            idx = np.nonzero(self.ops == op)[0]
            if len(idx):
                self.groups.append((op, slice(idx[0], idx[-1] + 1)))
        self._build_element_tables(tnf.elements)
        self._build_member_tables(tnf.members)
        self._build_linear_tables(tnf.linears)

    SUM_CLAMP = np.int64(1) << 40

    def _build_linear_tables(self, linears):
        self.L = len(linears)
        if not self.L:
            return
        K = max(len(l.coefs) for l in linears)
        C = self.L
        self.l_b = np.array([l.b for l in linears], dtype=np.int64)
        self.l_op = np.array([l.op for l in linears], dtype=np.int64)
        self.l_rhs = np.array([l.rhs for l in linears], dtype=np.int64)
        self.l_coef = np.zeros((C, K), dtype=np.int64)
        self.l_var = np.zeros((C, K), dtype=np.int64)
        for i, l in enumerate(linears):
            self.l_coef[i, :len(l.coefs)] = l.coefs
            self.l_var[i, :len(l.vars)] = l.vars

    def _linear_sums(self, lb, ub):
        xl = lb[self.l_var]
        xu = ub[self.l_var]
        a = self.l_coef * xl
        b = self.l_coef * xu
        tmin = np.clip(np.minimum(a, b), -self.SUM_CLAMP, self.SUM_CLAMP)
        tmax = np.clip(np.maximum(a, b), -self.SUM_CLAMP, self.SUM_CLAMP)
        return tmin, tmax, tmin.sum(axis=1), tmax.sum(axis=1)

    def _linear_cands(self, lb, ub):
        """Returns (term_lo (C,K), term_hi (C,K), b_lo (C,), b_hi (C,))."""
        tmin, tmax, Smin, Smax = self._linear_sums(lb, ub)
        rhs = self.l_rhs
        is_eq = self.l_op == 1
        b_lo = np.where(is_eq, (Smin == rhs) & (Smax == rhs),
                        Smax <= rhs).astype(np.int64)
        b_hi = np.where(is_eq, (Smin <= rhs) & (rhs <= Smax),
                        Smin <= rhs).astype(np.int64)
        tt = (lb[self.l_b] >= 1)[:, None]
        ff = (ub[self.l_b] <= 0)[:, None]
        c = self.l_coef
        live = c != 0
        csafe = np.where(live, c, 1)
        # "<=" direction (active when tt, or tt&EQ):
        R = rhs[:, None] - (Smin[:, None] - tmin)
        ub_le = np.floor_divide(R, csafe)      # bound on x for c>0
        lb_le = -np.floor_divide(-R, csafe)    # ceil, bound for c<0
        # ">=" direction: sum >= rhs2 where rhs2 = rhs (EQ&tt) or rhs+1 (LE&ff)
        rhs2 = np.where(is_eq, rhs, rhs + 1)[:, None]
        R2 = rhs2 - (Smax[:, None] - tmax)
        lb_ge = -np.floor_divide(-R2, csafe)   # ceil, bound for c>0
        ub_ge = np.floor_divide(R2, csafe)     # bound for c<0
        cpos = c > 0
        ge_act = (is_eq[:, None] & tt) | (~is_eq[:, None] & ff)
        le_act = tt
        ninf = np.full_like(tmin, NINF)
        pinf = np.full_like(tmin, INF)
        term_hi = np.where(live & le_act & cpos, ub_le, pinf)
        term_hi = np.minimum(term_hi,
                             np.where(live & ge_act & ~cpos, ub_ge, pinf))
        term_lo = np.where(live & le_act & ~cpos, lb_le, ninf)
        term_lo = np.maximum(term_lo,
                             np.where(live & ge_act & cpos, lb_ge, ninf))
        return (np.clip(term_lo, NINF, INF), np.clip(term_hi, NINF, INF),
                b_lo, b_hi)

    def _linear_ask(self, lb, ub):
        _, _, Smin, Smax = self._linear_sums(lb, ub)
        rhs = self.l_rhs
        is_eq = self.l_op == 1
        tt = lb[self.l_b] >= 1
        ff = ub[self.l_b] <= 0
        ent_t = np.where(is_eq, (Smin == rhs) & (Smax == rhs), Smax <= rhs)
        ent_f = np.where(is_eq, (rhs < Smin) | (rhs > Smax), Smin > rhs)
        return (tt & ent_t) | (ff & ent_f)

    def _build_element_tables(self, elements):
        self.E = len(elements)
        if not self.E:
            return
        T = max(len(e.values) for e in elements)
        self.e_idx = np.array([e.idx for e in elements], dtype=np.int64)
        self.e_res = np.array([e.res for e in elements], dtype=np.int64)
        self.e_len = np.array([len(e.values) for e in elements], dtype=np.int64)
        self.e_tab = np.zeros((self.E, T), dtype=np.int64)
        for i, e in enumerate(elements):
            self.e_tab[i, :len(e.values)] = e.values

    def _build_member_tables(self, members):
        self.M = len(members)
        if not self.M:
            return
        self.m_x = np.array([m.x for m in members], dtype=np.int64)
        self.m_b = np.array([m.b for m in members], dtype=np.int64)
        self.m_base = np.array([min(m.values) for m in members], dtype=np.int64)
        self.m_top = np.array([max(m.values) for m in members], dtype=np.int64)
        W = int((self.m_top - self.m_base).max()) + 1
        self.m_W = W
        M = self.M
        in_s = np.zeros((M, W), dtype=bool)
        for i, m in enumerate(members):
            for v in m.values:
                in_s[i, v - self.m_base[i]] = True
        self.m_in = in_s
        # Prefix counts over the hull window.
        self.m_cnt = np.zeros((M, W + 1), dtype=np.int64)
        self.m_cnt[:, 1:] = np.cumsum(in_s, axis=1)
        big = np.int64(1) << 40
        # next member >= base+w (value), sentinel top+1.
        self.m_next_ge = np.full((M, W), 0, dtype=np.int64)
        self.m_prev_le = np.full((M, W), 0, dtype=np.int64)
        self.m_next_out = np.full((M, W), 0, dtype=np.int64)
        self.m_prev_out = np.full((M, W), 0, dtype=np.int64)
        for i in range(M):
            nxt = self.m_top[i] + 1
            nxo = self.m_top[i] + 1
            for w in range(W - 1, -1, -1):
                v = self.m_base[i] + w
                if in_s[i, w]:
                    nxt = v
                else:
                    nxo = v
                self.m_next_ge[i, w] = nxt
                self.m_next_out[i, w] = nxo
            prv = self.m_base[i] - 1
            pvo = self.m_base[i] - 1
            for w in range(W):
                v = self.m_base[i] + w
                if in_s[i, w]:
                    prv = v
                else:
                    pvo = v
                self.m_prev_le[i, w] = prv
                self.m_prev_out[i, w] = pvo

    # -- element deduction (numpy): see compile.tnf.ElementCon ---------

    def _element_cands(self, lb, ub):
        """Returns (idx_lo, idx_hi, res_lo, res_hi) candidate arrays."""
        li = lb[self.e_idx]
        ui = ub[self.e_idx]
        lr = lb[self.e_res][:, None]
        ur = ub[self.e_res][:, None]
        T = self.e_tab.shape[1]
        j = np.arange(T, dtype=np.int64)[None, :]
        in_win = (j >= li[:, None] - 1) & (j <= ui[:, None] - 1) & \
                 (j < self.e_len[:, None])
        ok = in_win & (self.e_tab >= lr) & (self.e_tab <= ur)
        any_ok = ok.any(axis=1)
        first = np.argmax(ok, axis=1)
        last = T - 1 - np.argmax(ok[:, ::-1], axis=1)
        idx_lo = np.where(any_ok, first + 1, INF)
        idx_hi = np.where(any_ok, last + 1, NINF)
        tb = np.where(ok, self.e_tab, np.int64(INF))
        res_lo = np.where(any_ok, tb.min(axis=1), INF)
        tb = np.where(ok, self.e_tab, np.int64(NINF))
        res_hi = np.where(any_ok, tb.max(axis=1), NINF)
        return idx_lo, idx_hi, res_lo, res_hi

    def _element_ask(self, lb, ub):
        li = np.clip(lb[self.e_idx], 1, self.e_len)
        ui = np.clip(ub[self.e_idx], 1, self.e_len)
        lr, ur = lb[self.e_res], ub[self.e_res]
        T = self.e_tab.shape[1]
        j = np.arange(T, dtype=np.int64)[None, :]
        in_win = (j >= li[:, None] - 1) & (j <= ui[:, None] - 1) & \
                 (j < self.e_len[:, None])
        tb_min = np.where(in_win, self.e_tab, np.int64(INF)).min(axis=1)
        tb_max = np.where(in_win, self.e_tab, np.int64(NINF)).max(axis=1)
        return (lr == ur) & (tb_min == lr) & (tb_max == lr)

    # -- membership deduction -----------------------------------------

    def _member_cands(self, lb, ub):
        """Returns (x_lo, x_hi, b_lo, b_hi) candidate arrays."""
        lx = lb[self.m_x]
        ux = ub[self.m_x]
        lbb = lb[self.m_b]
        ubb = ub[self.m_b]
        W = self.m_W
        wl = np.clip(lx - self.m_base, 0, W)
        wh = np.clip(ux - self.m_base + 1, 0, W)
        rows = np.arange(self.M)
        c = self.m_cnt[rows, wh] - self.m_cnt[rows, wl]
        width = ux - lx + 1
        b_lo = ((c == width) & (width > 0)).astype(np.int64)
        b_hi = (c > 0).astype(np.int64)
        # x pruning under b decided.
        tt = lbb >= 1
        ff = ubb <= 0
        wl_i = np.clip(lx - self.m_base, 0, W - 1)
        wh_i = np.clip(ux - self.m_base, 0, W - 1)
        nge = np.where(lx > self.m_top, np.int64(INF),
                       self.m_next_ge[rows, wl_i])
        ple = np.where(ux < self.m_base, np.int64(NINF),
                       self.m_prev_le[rows, wh_i])
        # For b=0: shave bounds off S (values outside the hull are
        # trivially not in S, so no shave there).
        inhull_l = (lx >= self.m_base) & (lx <= self.m_top)
        inhull_h = (ux >= self.m_base) & (ux <= self.m_top)
        nout = np.where(inhull_l, self.m_next_out[rows, wl_i], lx)
        pout = np.where(inhull_h, self.m_prev_out[rows, wh_i], ux)
        x_lo = np.where(tt, nge, np.where(ff, nout, NINF))
        x_hi = np.where(tt, ple, np.where(ff, pout, INF))
        return (np.clip(x_lo, NINF, INF), np.clip(x_hi, NINF, INF),
                b_lo, b_hi)

    def _member_ask(self, lb, ub):
        lx = lb[self.m_x]
        ux = ub[self.m_x]
        lbb = lb[self.m_b]
        ubb = ub[self.m_b]
        W = self.m_W
        wl = np.clip(lx - self.m_base, 0, W)
        wh = np.clip(ux - self.m_base + 1, 0, W)
        rows = np.arange(self.M)
        c = self.m_cnt[rows, wh] - self.m_cnt[rows, wl]
        width = ux - lx + 1
        return ((lbb >= 1) & (c == width) & (width > 0)) | \
               ((ubb <= 0) & (c == 0))

    def propagate(self, lb: np.ndarray, ub: np.ndarray, max_iters: int = 100000):
        """AC-1 fixpoint in place. Returns (iterations, num_deductions, is_bot)."""
        iters = 0
        deds = 0
        while iters < max_iters:
            iters += 1
            changed = False
            for op, sl in self.groups:
                xs, ys, zs = self.xs[sl], self.ys[sl], self.zs[sl]
                cxl, cxu, cyl, cyu, czl, czu = deduce_np.deduce(
                    op, lb[xs], ub[xs], lb[ys], ub[ys], lb[zs], ub[zs])
                deds += len(xs)
                for ids, cl, cu in ((xs, cxl, cxu), (ys, cyl, cyu), (zs, czl, czu)):
                    old_l = lb[ids]
                    old_u = ub[ids]
                    np.maximum.at(lb, ids, cl)
                    np.minimum.at(ub, ids, cu)
                    if not changed:
                        if np.any(lb[ids] > old_l) or np.any(ub[ids] < old_u):
                            changed = True
            if getattr(self, "E", 0):
                il, ih, rl, rh = self._element_cands(lb, ub)
                deds += self.E
                for ids, cl, cu in ((self.e_idx, il, ih), (self.e_res, rl, rh)):
                    old_l, old_u = lb[ids], ub[ids]
                    np.maximum.at(lb, ids, cl)
                    np.minimum.at(ub, ids, cu)
                    if not changed and (np.any(lb[ids] > old_l)
                                        or np.any(ub[ids] < old_u)):
                        changed = True
            if getattr(self, "M", 0):
                xl, xh, bl, bh = self._member_cands(lb, ub)
                deds += self.M
                for ids, cl, cu in ((self.m_x, xl, xh), (self.m_b, bl, bh)):
                    old_l, old_u = lb[ids], ub[ids]
                    np.maximum.at(lb, ids, cl)
                    np.minimum.at(ub, ids, cu)
                    if not changed and (np.any(lb[ids] > old_l)
                                        or np.any(ub[ids] < old_u)):
                        changed = True
            if getattr(self, "L", 0):
                tl, th, bl, bh = self._linear_cands(lb, ub)
                deds += self.L
                flat = self.l_var.ravel()
                for ids, cl, cu in ((flat, tl.ravel(), th.ravel()),
                                    (self.l_b, bl, bh)):
                    old_l, old_u = lb[ids], ub[ids]
                    np.maximum.at(lb, ids, cl)
                    np.minimum.at(ub, ids, cu)
                    if not changed and (np.any(lb[ids] > old_l)
                                        or np.any(ub[ids] < old_u)):
                        changed = True
            if np.any(lb > ub):
                return iters, deds, True
            if not changed:
                return iters, deds, False
        return iters, deds, bool(np.any(lb > ub))

    def all_entailed(self, lb: np.ndarray, ub: np.ndarray) -> bool:
        for op, sl in self.groups:
            xs, ys, zs = self.xs[sl], self.ys[sl], self.zs[sl]
            ok = deduce_np.ask(op, lb[xs], ub[xs], lb[ys], ub[ys], lb[zs], ub[zs])
            if not ok.all():
                return False
        if getattr(self, "E", 0) and not self._element_ask(lb, ub).all():
            return False
        if getattr(self, "M", 0) and not self._member_ask(lb, ub).all():
            return False
        if getattr(self, "L", 0) and not self._linear_ask(lb, ub).all():
            return False
        return True


@dataclasses.dataclass
class SolveStats:
    nodes: int = 0
    fails: int = 0
    solutions: int = 0
    depth_max: int = 0
    fixpoint_iterations: int = 0
    num_deductions: int = 0
    exhaustive: bool = True
    solve_time: float = 0.0
    # Per-phase timers (cpu arch: directly bracketed host clocks,
    # cpu_solving.hpp / statistics.hpp Timer parity).
    fixpoint_time: float = 0.0
    search_time: float = 0.0
    select_fp_functions_time: float = 0.0
    best_obj_time: float = 0.0


@dataclasses.dataclass
class SolveResult:
    status: str  # "sat" | "unsat" | "unknown" | "optimal"
    objective: Optional[int]
    best_lb: Optional[np.ndarray]
    best_ub: Optional[np.ndarray]
    stats: SolveStats


def _splittable(lb, ub, ids=None):
    if ids is None:
        return (lb < ub) & (lb > NINF) & (ub < INF)
    return (lb[ids] < ub[ids]) & (lb[ids] > NINF) & (ub[ids] < INF)


def select_var(strategies: List[Strategy], lb, ub, start_strategy: int = 0):
    """Returns (strategy_index, var_id, val_order) or None if no
    splittable variable remains in any strategy. Key semantics shared
    with the batched engine via solver.strategy (one spec, two array
    libraries)."""
    from . import strategy as _st

    for si in range(start_strategy, len(strategies)):
        s = strategies[si]
        ids = s.var_ids
        if ids is None:
            mask = _splittable(lb, ub)
            doms_l, doms_u = lb, ub
        else:
            mask = _splittable(lb, ub, ids)
            doms_l, doms_u = lb[ids], ub[ids]
        if not mask.any():
            continue
        vo = _st.VO_CODE.get(s.var_order, 0)
        pos_key = np.arange(len(doms_l), dtype=np.int64)
        key = _st.split_key(np, vo, pos_key, doms_l.astype(np.int64),
                            doms_u.astype(np.int64))
        pos = int(np.argmin(np.where(mask, key, np.iinfo(np.int64).max)))
        var = pos if ids is None else int(ids[pos])
        return si, var, s.val_order
    return None


def branch_children(val_order: str, lo: int, hi: int):
    """Two child intervals, left explored first (LightBranch semantics,
    barebones_dive_and_solve.hpp:355-384); table in solver.strategy."""
    from .strategy import branch_children as _bc

    return _bc(val_order, lo, hi)


def solve(tnf: Tnf, timeout_s: float = 1e18, stop_after_n_solutions: int = 1,
          node_limit: int = 1 << 62, print_intermediate=None) -> SolveResult:
    """DFS branch-and-bound solve of a compiled TNF.

    All-solutions semantics (stop_after_n_solutions == 0 or > 1): a
    solution is an all-singleton store (the reference's
    AtomicExtraction / is_extractable), so entailed boxes with unfixed
    variables keep splitting; with the default stop-after-1 an entailed
    box counts once and its lb witness is returned."""
    stats = SolveStats()
    t0 = time.monotonic()
    opt = tnf.obj_var >= 0

    if tnf.root_unsat:
        return SolveResult("unsat", None, None, None, stats)

    table = PropTable(tnf)
    lb = tnf.lb0.copy()
    ub = tnf.ub0.copy()

    best_bound = INF + 1
    best_lb = best_ub = None

    # Explicit DFS stack of unexplored nodes (domains snapshots).
    stack: List[Tuple[np.ndarray, np.ndarray, int]] = [(lb, ub, 0)]

    while stack:
        if time.monotonic() - t0 > timeout_s or stats.nodes >= node_limit:
            stats.exhaustive = False
            break
        lb, ub, depth = stack.pop()
        if opt and best_bound <= INF:
            # BAB: only accept strictly better solutions.
            ub[tnf.obj_var] = min(ub[tnf.obj_var], best_bound - 1)
        tfp = time.monotonic()
        it, deds, bot = table.propagate(lb, ub)
        stats.fixpoint_time += time.monotonic() - tfp
        stats.nodes += 1
        stats.fixpoint_iterations += it
        stats.num_deductions += deds
        stats.depth_max = max(stats.depth_max, depth)
        if bot:
            stats.fails += 1
            continue
        enumerate_all = (not opt) and stop_after_n_solutions != 1
        if table.all_entailed(lb, ub) and not (
                enumerate_all and select_var(tnf.strategies, lb, ub) is not None):
            stats.solutions += 1
            best_lb, best_ub = lb.copy(), ub.copy()
            if opt:
                best_bound = int(lb[tnf.obj_var])
                stats.best_obj_time = time.monotonic() - t0
                if print_intermediate:
                    print_intermediate(best_lb, best_ub)
            else:
                if print_intermediate:
                    print_intermediate(best_lb, best_ub)
                if stop_after_n_solutions and stats.solutions >= stop_after_n_solutions:
                    stats.exhaustive = False
                    break
            continue
        tsel = time.monotonic()
        sel = select_var(tnf.strategies, lb, ub)
        stats.select_fp_functions_time += time.monotonic() - tsel
        if sel is None:
            # Unsplittable (infinite domains remain): not exhaustive.
            stats.exhaustive = False
            continue
        _, var, val_order = sel
        (l0, u0), (l1, u1) = branch_children(val_order, int(lb[var]), int(ub[var]))
        rlb, rub = lb.copy(), ub.copy()
        rlb[var] = max(rlb[var], l1)
        rub[var] = min(rub[var], u1)
        stack.append((rlb, rub, depth + 1))
        lb[var] = max(lb[var], l0)
        ub[var] = min(ub[var], u0)
        stack.append((lb, ub, depth + 1))

    stats.solve_time = time.monotonic() - t0
    stats.search_time = max(
        stats.solve_time - stats.fixpoint_time, 0.0)
    if stats.solutions == 0:
        status = "unsat" if stats.exhaustive else "unknown"
        return SolveResult(status, None, None, None, stats)
    if opt:
        status = "optimal" if stats.exhaustive else "sat"
        obj = int(best_lb[tnf.orig_obj_var]) if tnf.is_max else int(best_lb[tnf.obj_var])
        if tnf.is_max:
            # Original objective value: for maximization print ub of the
            # original variable (statistics.hpp:381-391 prints ub).
            obj = int(best_ub[tnf.orig_obj_var])
        return SolveResult(status, obj, best_lb, best_ub, stats)
    return SolveResult("sat", None, best_lb, best_ub, stats)
