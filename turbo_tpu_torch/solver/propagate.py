"""Batched AC-1 interval propagation in PyTorch.

Port of ``turbo_tpu/solver/propagate_jax.py`` (``PropagatorKernels``,
gather mode ``take``). Every rule has a plain torch version here that
computes bit for bit what the JAX function computes: int32 store planes,
MUL/DIV and non-``lin_fit32`` linear rows in int64, each candidate
clamped to [NINF, INF].

``fixpoint``, ``fixed_sweeps``, ``fixpoint_t`` (dive-minor (V, D)
planes), ``fixpoint_wac1`` and ``classify`` dispatch by device: a CPU
tensor runs the plain version, a CUDA tensor launches the hand-written
kernel (``kernels/csrc/fixpoint.cu``, ``wac1.cu``, ``classify.cu``) or
raises.

The plain fixpoint freezes a lane once its mask drops (converged, bot or
capped), as the kernel does; the JAX loop keeps sweeping every lane
until the last lane converges. Sweeps are idempotent at a fixpoint, so
the two agree on every lane whose store is not bot (store, ``iters``
and ``unconv``), and on ``bot`` everywhere. The plain WAC1 fixpoint
freezes a lane the same way, and inside a sweep as soon as the lane is
bot, as its kernel does: ``iters``, ``unconv`` and ``bot`` agree with
the JAX function on every lane, the store on every lane that is not bot.
"""
from __future__ import annotations

import functools

import torch

from ..host.core.ops import (INF, NINF, OP_ADD, OP_DIV, OP_EQ, OP_LE, OP_MAX,
                             OP_MIN, OP_MUL)
from .convert import DevicePlan

I32 = torch.int32
I64 = torch.int64
SUM_CLAMP = 1 << 40


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _tdiv(a, b):
    q = _fdiv(a, b)
    r = a - q * b
    return q + ((r != 0) & ((a < 0) != (b < 0))).to(q.dtype)


def _clamp32(lo, hi):
    return (lo.clamp(NINF, INF).to(I32), hi.clamp(NINF, INF).to(I32))


_where = torch.where


def _deduce_group(op, lx, ux, ly, uy, lz, uz):
    """Mirror of ``propagate_jax._deduce_group`` for one op-group.
    Inputs int32 (D, n); returns 6 int32 arrays."""
    ninf = torch.full_like(lx, NINF)
    pinf = torch.full_like(lx, INF)
    if op == OP_ADD:
        cxl, cxu = ly + lz, uy + uz
        cyl, cyu = lx - uz, ux - lz
        czl, czu = lx - uy, ux - ly
    elif op == OP_MUL:
        ly64, uy64, lz64, uz64 = (v.to(I64) for v in (ly, uy, lz, uz))
        lx64, ux64 = lx.to(I64), ux.to(I64)
        p1, p2, p3, p4 = ly64 * lz64, ly64 * uz64, uy64 * lz64, uy64 * uz64
        cxl = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
        cxu = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
        cyl, cyu = _inv_mul(lx64, ux64, lz64, uz64)
        czl, czu = _inv_mul(lx64, ux64, ly64, uy64)
    elif op == OP_DIV:
        ly64, uy64, lz64, uz64 = (v.to(I64) for v in (ly, uy, lz, uz))
        lx64, ux64 = lx.to(I64), ux.to(I64)
        cxl, cxu = _fwd_div(ly64, uy64, lz64, uz64)
        mz = torch.maximum(lz64.abs(), uz64.abs())
        p1, p2, p3, p4 = lx64 * lz64, lx64 * uz64, ux64 * lz64, ux64 * uz64
        pad = (mz - 1).clamp(min=0)
        cyl = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)) - pad
        cyu = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)) + pad
        czl, czu = ninf.to(I64), pinf.to(I64)
        zzero = (lz == 0) & (uz == 0)
        cxl = _where(zzero, INF, cxl)
        cxu = _where(zzero, NINF, cxu)
    elif op == OP_MIN:
        cxl = torch.minimum(ly, lz)
        cxu = torch.minimum(uy, uz)
        cyl = lx
        cyu = _where(lz > ux, ux, pinf)
        czl = lx
        czu = _where(ly > ux, ux, pinf)
    elif op == OP_MAX:
        cxl = torch.maximum(ly, lz)
        cxu = torch.maximum(uy, uz)
        cyu = ux
        cyl = _where(uz < lx, lx, ninf)
        czu = ux
        czl = _where(uy < lx, lx, ninf)
    elif op == OP_LE:
        cxl = (uy <= lz).to(I32)
        cxu = 1 - (ly > uz).to(I32)
        tt = lx >= 1
        ff = ux <= 0
        cyl = _where(ff, lz + 1, ninf)
        cyu = _where(tt, uz, pinf)
        czl = _where(tt, ly, ninf)
        czu = _where(ff, uy - 1, pinf)
    elif op == OP_EQ:
        cxl = ((ly == uy) & (uy == lz) & (lz == uz)).to(I32)
        cxu = (torch.maximum(ly, lz) <= torch.minimum(uy, uz)).to(I32)
        tt = lx >= 1
        ff = ux <= 0
        zsing = lz == uz
        ysing = ly == uy
        cyl = _where(tt, lz, _where(ff & zsing & (lz == ly), ly + 1, ninf))
        cyu = _where(tt, uz, _where(ff & zsing & (lz == uy), uy - 1, pinf))
        czl = _where(tt, ly, _where(ff & ysing & (ly == lz), lz + 1, ninf))
        czu = _where(tt, uy, _where(ff & ysing & (ly == uz), uz - 1, pinf))
    else:
        raise ValueError(op)
    cxl, cxu = _clamp32(cxl, cxu)
    cyl, cyu = _clamp32(cyl, cyu)
    czl, czu = _clamp32(czl, czu)
    return cxl, cxu, cyl, cyu, czl, czu


def _inv_mul(la, ua, lb, ub):
    has0 = (lb <= 0) & (ub >= 0)
    sb = _where(lb == 0, 1, lb)
    tb = _where(ub == 0, -1, ub)
    los, his = [], []
    for a in (la, ua):
        for b in (sb, tb):
            los.append(-_fdiv(-a, b))  # ceil
            his.append(_fdiv(a, b))    # floor
    lo = functools.reduce(torch.minimum, los)
    hi = functools.reduce(torch.maximum, his)
    return _where(has0, NINF, lo), _where(has0, INF, hi)


def _fwd_div(ly, uy, lz, uz):
    lo = torch.full_like(ly, INF)
    hi = torch.full_like(ly, NINF)
    for plo, phi, valid in ((lz, uz.clamp(max=-1), lz <= -1),
                            (lz.clamp(min=1), uz, uz >= 1)):
        plo_s = _where(valid, plo, 1)
        phi_s = _where(valid, phi, 1)
        for a in (ly, uy):
            for zc in (plo_s, phi_s):
                q = _tdiv(a, zc)
                lo = _where(valid, torch.minimum(lo, q), lo)
                hi = _where(valid, torch.maximum(hi, q), hi)
    return lo, hi


def _ask_group(op, lx, ux, ly, uy, lz, uz):
    sing = (lx == ux) & (ly == uy) & (lz == uz)
    if op == OP_ADD:
        return sing & (lx == ly + lz)
    if op == OP_MUL:
        return sing & (lx.to(I64) == ly.to(I64) * lz.to(I64))
    if op == OP_DIV:
        return sing & (lz != 0) & (lx == _tdiv(ly, _where(lz == 0, 1, lz)))
    if op == OP_MIN:
        return sing & (lx == torch.minimum(ly, lz))
    if op == OP_MAX:
        return sing & (lx == torch.maximum(ly, lz))
    if op == OP_LE:
        return ((lx >= 1) & (uy <= lz)) | ((ux <= 0) & (ly > uz))
    if op == OP_EQ:
        return (((lx >= 1) & (ly == uy) & (lz == uz) & (ly == lz))
                | ((ux <= 0) & ((uy < lz) | (ly > uz))))
    raise ValueError(op)


class PropagatorKernels:
    """The plan's propagators on one device: plain torch rules, and the
    dispatch to the CUDA kernels for CUDA tensors."""

    def __init__(self, dplan: DevicePlan):
        self.dp = dplan
        self.P = dplan.P
        self._kernel_plan = None

    @property
    def kernel_plan(self):
        """The plan's tables for the CUDA kernels, uploaded at first use."""
        if self._kernel_plan is None:
            from ..kernels import KernelPlan
            self._kernel_plan = KernelPlan(self.dp)
        return self._kernel_plan

    # -- linear rows ---------------------------------------------------

    @staticmethod
    def _linear_sums(lb, ub, bk: "LinBucket"):
        DT = I32 if bk.fit32 else I64
        D = lb.shape[0]
        C, K = bk.coef.shape
        xl = lb[:, bk.var.reshape(-1)].reshape(D, C, K).to(DT)
        xu = ub[:, bk.var.reshape(-1)].reshape(D, C, K).to(DT)
        c = bk.coef.to(DT)[None, :, :]
        a = c * xl
        b2 = c * xu
        tmin = torch.minimum(a, b2)
        tmax = torch.maximum(a, b2)
        if not bk.fit32:
            tmin = tmin.clamp(-SUM_CLAMP, SUM_CLAMP)
            tmax = tmax.clamp(-SUM_CLAMP, SUM_CLAMP)
        # Terms are products in the working type; their sums are int64
        # in both paths (jnp.sum widens int32 under x64, as torch does).
        Smin = tmin.sum(dim=2, dtype=I64)
        Smax = tmax.sum(dim=2, dtype=I64)
        return c, tmin, tmax, Smin, Smax, bk.rhs.to(DT)[None, :]

    def _linear_bucket_cands(self, lb, ub, bk):
        D = lb.shape[0]
        C, K = bk.coef.shape
        c, tmin, tmax, Smin, Smax, rhs = self._linear_sums(lb, ub, bk)
        is_eq = (bk.op == 1)[None, :]
        b_lo = _where(is_eq, (Smin == rhs) & (Smax == rhs), Smax <= rhs).to(I32)
        b_hi = _where(is_eq, (Smin <= rhs) & (rhs <= Smax), Smin <= rhs).to(I32)
        tt = (lb[:, bk.b] >= 1)[:, :, None]
        ff = (ub[:, bk.b] <= 0)[:, :, None]
        live = (bk.coef != 0)[None, :, :]
        csafe = _where(live, c, torch.ones_like(c))
        R = rhs[:, :, None] - (Smin[:, :, None] - tmin)
        rhs2 = _where(is_eq, rhs, rhs + 1)[:, :, None]
        R2 = rhs2 - (Smax[:, :, None] - tmax)
        if bk.unit:
            q_le = ceil_le = R * csafe
            q_ge = ceil_ge = R2 * csafe
        else:
            q_le = _fdiv(R, csafe)
            ceil_le = q_le + ((R - q_le * csafe) != 0).to(R.dtype)
            q_ge = _fdiv(R2, csafe)
            ceil_ge = q_ge + ((R2 - q_ge * csafe) != 0).to(R.dtype)
        cpos = (bk.coef > 0)[None, :, :]
        is_eq3 = is_eq[:, :, None]
        ge_act = (is_eq3 & tt) | (~is_eq3 & ff)
        le_act = tt
        term_hi = _where(live & le_act & cpos, q_le, INF)
        term_hi = torch.minimum(term_hi,
                                _where(live & ge_act & ~cpos, q_ge, INF))
        term_lo = _where(live & le_act & ~cpos, ceil_le, NINF)
        term_lo = torch.maximum(term_lo,
                                _where(live & ge_act & cpos, ceil_ge, NINF))
        term_lo = term_lo.clamp(NINF, INF).to(I32).reshape(D, C * K)
        term_hi = term_hi.clamp(NINF, INF).to(I32).reshape(D, C * K)
        return term_lo, term_hi, b_lo, b_hi

    def _linear_ask_all(self, lb, ub):
        out = torch.ones(lb.shape[0], dtype=torch.bool, device=lb.device)
        for bk in self.dp.lin:
            _, _, _, Smin, Smax, rhs = self._linear_sums(lb, ub, bk)
            is_eq = (bk.op == 1)[None, :]
            tt = lb[:, bk.b] >= 1
            ff = ub[:, bk.b] <= 0
            ent_t = _where(is_eq, (Smin == rhs) & (Smax == rhs), Smax <= rhs)
            ent_f = _where(is_eq, (rhs < Smin) | (rhs > Smax), Smin > rhs)
            out = out & ((tt & ent_t) | (ff & ent_f)).all(dim=1)
        return out

    # -- element / membership -----------------------------------------

    def _element_window(self, li, ui):
        dp = self.dp
        T = dp.e_tab.shape[1]
        j = torch.arange(T, dtype=I32, device=li.device)[None, None, :]
        in_win = ((j >= li[:, :, None] - 1) & (j <= ui[:, :, None] - 1)
                  & (j < dp.e_len[None, :, None]))
        return j, dp.e_tab[None, :, :], in_win

    def _element_cands(self, lb, ub):
        dp = self.dp
        lr = lb[:, dp.e_res][:, :, None]
        ur = ub[:, dp.e_res][:, :, None]
        j, tab, in_win = self._element_window(lb[:, dp.e_idx], ub[:, dp.e_idx])
        ok = in_win & (tab >= lr) & (tab <= ur)
        idx_lo = _where(ok, j, INF - 1).amin(dim=2) + 1
        idx_hi = _where(ok, j, NINF - 1).amax(dim=2) + 1
        res_lo = _where(ok, tab, INF).amin(dim=2)
        res_hi = _where(ok, tab, NINF).amax(dim=2)
        return idx_lo, idx_hi, res_lo, res_hi

    def _element_ask(self, lb, ub):
        dp = self.dp
        li = torch.minimum(lb[:, dp.e_idx].clamp(min=1), dp.e_len[None, :])
        ui = torch.minimum(ub[:, dp.e_idx].clamp(min=1), dp.e_len[None, :])
        lr = lb[:, dp.e_res]
        ur = ub[:, dp.e_res]
        _, tab, in_win = self._element_window(li, ui)
        tmin = _where(in_win, tab, INF).amin(dim=2)
        tmax = _where(in_win, tab, NINF).amax(dim=2)
        return (lr == ur) & (tmin == lr) & (tmax == lr)

    def _member_window(self, lb, ub):
        dp = self.dp
        lx = lb[:, dp.m_x]
        ux = ub[:, dp.m_x]
        W = dp.m_W
        wl = (lx - dp.m_base[None, :]).clamp(0, W)
        wh = (ux - dp.m_base[None, :] + 1).clamp(0, W)
        chi = dp.m_cnt_flat[(wh + dp.m_cnt_offs[None, :]).long()]
        clo = dp.m_cnt_flat[(wl + dp.m_cnt_offs[None, :]).long()]
        c = chi - clo
        width = ux.to(I64) - lx.to(I64) + 1
        return lx, ux, c, width, W

    def _member_cands(self, lb, ub):
        dp = self.dp
        lx, ux, c, width, W = self._member_window(lb, ub)
        lbb = lb[:, dp.m_b]
        ubb = ub[:, dp.m_b]
        b_lo = ((c.to(I64) == width) & (width > 0)).to(I32)
        b_hi = (c > 0).to(I32)
        wl_i = (lx - dp.m_base[None, :]).clamp(0, W - 1)
        wh_i = (ux - dp.m_base[None, :]).clamp(0, W - 1)

        def row_take(flat, idx2):
            return flat[(idx2 + dp.m_offs[None, :]).long()]

        base, top = dp.m_base[None, :], dp.m_top[None, :]
        nge = _where(lx > top, INF, row_take(dp.m_next_ge, wl_i))
        ple = _where(ux < base, NINF, row_take(dp.m_prev_le, wh_i))
        inhull_l = (lx >= base) & (lx <= top)
        inhull_h = (ux >= base) & (ux <= top)
        nout = _where(inhull_l, row_take(dp.m_next_out, wl_i), lx)
        pout = _where(inhull_h, row_take(dp.m_prev_out, wh_i), ux)
        tt = lbb >= 1
        ff = ubb <= 0
        x_lo = _where(tt, nge, _where(ff, nout, NINF))
        x_hi = _where(tt, ple, _where(ff, pout, INF))
        return (x_lo.clamp(NINF, INF).to(I32), x_hi.clamp(NINF, INF).to(I32),
                b_lo, b_hi)

    def _member_ask(self, lb, ub):
        dp = self.dp
        lx, ux, c, width, W = self._member_window(lb, ub)
        lbb = lb[:, dp.m_b]
        ubb = ub[:, dp.m_b]
        return (((lbb >= 1) & (c.to(I64) == width) & (width > 0))
                | ((ubb <= 0) & (c == 0)))

    # -- one AC-1 sweep ------------------------------------------------

    def _clamp_store(self, lb, ub):
        return (torch.minimum(lb, self.dp.ub_cap[None, :]),
                torch.maximum(ub, self.dp.lb_floor[None, :]))

    def iteration(self, lb, ub):
        """One sweep over all propagators. lb/ub: (D, V) int32."""
        dp = self.dp
        if self.P == 0:
            return lb, ub
        D = lb.shape[0]
        LX, UX = lb[:, dp.all_x], ub[:, dp.all_x]
        LY, UY = lb[:, dp.all_y], ub[:, dp.all_y]
        LZ, UZ = lb[:, dp.all_z], ub[:, dp.all_z]
        xls, yls, zls, xus, yus, zus = [], [], [], [], [], []
        for op, a, b in dp.group_slices:
            cxl, cxu, cyl, cyu, czl, czu = _deduce_group(
                op, LX[:, a:b], UX[:, a:b], LY[:, a:b], UY[:, a:b],
                LZ[:, a:b], UZ[:, a:b])
            xls.append(cxl); yls.append(cyl); zls.append(czl)
            xus.append(cxu); yus.append(cyu); zus.append(czu)
        # Candidate slots: [3P | E idx | E res | M x | M b | linear terms
        # | linear b | neutral], the layout of plan.py.
        extra_l, extra_u = [], []
        if dp.E:
            il, ih, rl, rh = self._element_cands(lb, ub)
            extra_l += [il, rl]
            extra_u += [ih, rh]
        if dp.M:
            xl, xh, bl, bh = self._member_cands(lb, ub)
            extra_l += [xl, bl]
            extra_u += [xh, bh]
        lin_b_l, lin_b_u = [], []
        for bk in dp.lin:
            tl, th, bl2, bh2 = self._linear_bucket_cands(lb, ub, bk)
            extra_l.append(tl)
            extra_u.append(th)
            lin_b_l.append(bl2)
            lin_b_u.append(bh2)
        extra_l += lin_b_l
        extra_u += lin_b_u
        neutral_l = torch.full((D, 1), NINF, dtype=I32, device=lb.device)
        neutral_u = torch.full((D, 1), INF, dtype=I32, device=lb.device)
        cand_l = torch.cat(xls + yls + zls + extra_l + [neutral_l], dim=1)
        cand_u = torch.cat(xus + yus + zus + extra_u + [neutral_u], dim=1)

        new_l, new_u = [], []
        for start, count, idx in dp.buckets:
            gl = cand_l[:, idx]  # (D, count, K)
            gu = cand_u[:, idx]
            new_l.append(torch.maximum(lb[:, start:start + count],
                                       gl.amax(dim=-1)))
            new_u.append(torch.minimum(ub[:, start:start + count],
                                       gu.amin(dim=-1)))
        tail_l = lb[:, dp.n_active:]
        tail_u = ub[:, dp.n_active:]
        if dp.conf_idx is not None:
            # Singleton-tail conflict fold (plan.conf_idx): a deduction
            # contradicting a root-fixed var raises the dummy column's lb.
            off = dp.conf_off[None, :]
            conf = ((cand_l[:, dp.conf_idx] > off)
                    | (cand_u[:, dp.conf_idx] < off)).any(dim=1)
            dl = torch.maximum(tail_l[:, -1], conf.to(I32))
            tail_l = torch.cat([tail_l[:, :-1], dl[:, None]], dim=1)
        lb2 = torch.cat(new_l + [tail_l], dim=1)
        ub2 = torch.cat(new_u + [tail_u], dim=1)
        return self._clamp_store(lb2, ub2)

    # -- fixpoint ------------------------------------------------------

    def fixpoint_plain(self, lb, ub, max_iters: int = 100000):
        """AC-1 fixpoint, one lane frozen once its mask drops. Returns
        (lb, ub, iters (D,) int32, unconv (D,) bool)."""
        D = lb.shape[0]
        z = torch.zeros(D, dtype=I32, device=lb.device)
        if self.P == 0:
            return lb, ub, z, z != 0
        m = z == 0
        iters = z
        it = 0
        while it < max_iters and bool(m.any()):
            lb3, ub3 = self.iteration(lb, ub)
            iters = iters + m.to(I32)
            dch = ((lb3 != lb) | (ub3 != ub)).any(dim=1)
            bot = (lb3 > ub3).any(dim=1)
            lb = _where(m[:, None], lb3, lb)
            ub = _where(m[:, None], ub3, ub)
            m = m & dch & ~bot
            it += 1
        return lb, ub, iters + 1, m

    def fixpoint(self, lb, ub, max_iters: int = 100000):
        if lb.is_cuda:
            from ..kernels import fixpoint as k_fixpoint
            return k_fixpoint(self.kernel_plan, lb, ub, int(max_iters))
        if lb.device.type != "cpu":
            raise RuntimeError(f"no fixpoint for device {lb.device}")
        return self.fixpoint_plain(lb, ub, max_iters)

    def fixed_sweeps_plain(self, lb, ub, n: int):
        """Exactly n AC-1 sweeps of every lane, no convergence check:
        iters = n, unconv all false."""
        z = torch.zeros(lb.shape[0], dtype=I32, device=lb.device)
        if self.P == 0:
            return lb, ub, z, z != 0
        for _ in range(n):
            lb, ub = self.iteration(lb, ub)
        return lb, ub, z + n, z != 0

    def fixed_sweeps(self, lb, ub, n: int):
        if lb.is_cuda:
            from ..kernels import fixpoint as k_fixpoint
            return k_fixpoint.fixed_sweeps(self.kernel_plan, lb, ub, int(n))
        if lb.device.type != "cpu":
            raise RuntimeError(f"no fixed sweeps for device {lb.device}")
        return self.fixed_sweeps_plain(lb, ub, n)

    def fixpoint_t_plain(self, lbT, ubT, max_iters: int = 100000):
        """The AC-1 fixpoint on dive-minor (V, D) planes: the sweep is
        the one of ``iteration`` whatever the layout. Returns (lbT, ubT,
        iters, unconv)."""
        lb, ub, iters, m = self.fixpoint_plain(
            lbT.t().contiguous(), ubT.t().contiguous(), max_iters)
        return lb.t().contiguous(), ub.t().contiguous(), iters, m

    def fixpoint_t(self, lbT, ubT, max_iters: int = 100000):
        if lbT.is_cuda:
            from ..kernels import fixpoint as k_fixpoint
            return k_fixpoint.transposed(self.kernel_plan, lbT, ubT,
                                         int(max_iters))
        if lbT.device.type != "cpu":
            raise RuntimeError(f"no fixpoint for device {lbT.device}")
        return self.fixpoint_t_plain(lbT, ubT, max_iters)

    # -- WAC1: per-group local fixpoints ---------------------------------

    def _meet(self, lb, ub, idx, cl, cu, run):
        """Scatter-meet candidates (D, n) into variables ``idx`` (n,) on
        the lanes of ``run``, each candidate clamped to the root box
        first (on a store inside the box this is the JAX function's clamp
        after the meet). Returns (lb, ub, changed (D,))."""
        dp = self.dp
        ix = idx[None, :].expand(lb.shape[0], -1)
        cl = torch.minimum(cl, dp.ub_cap[idx][None, :])
        cu = torch.maximum(cu, dp.lb_floor[idx][None, :])
        lb2 = lb.scatter_reduce(1, ix, cl, "amax")
        ub2 = ub.scatter_reduce(1, ix, cu, "amin")
        ch = run & ((lb2 != lb) | (ub2 != ub)).any(dim=1)
        return (_where(run[:, None], lb2, lb), _where(run[:, None], ub2, ub),
                ch)

    def sweep_wac1_plain(self, lb, ub, inner_cap: int = 16):
        """One WAC1 sweep: every op-group to its local fixpoint (Jacobi
        inside the group, at most ``inner_cap`` iterations) in group
        order, then one scatter-meet pass of the element rows, the
        membership rows and each linear bucket in turn. A lane leaves the
        sweep once it is bot. Returns (lb, ub, changed (D,), bot (D,))."""
        dp = self.dp
        bot = self.is_bot(lb, ub)
        alive = torch.ones_like(bot)
        changed = torch.zeros_like(bot)
        for op, a, b in dp.group_slices:
            xs, ys, zs = dp.all_x[a:b], dp.all_y[a:b], dp.all_z[a:b]
            idx = torch.cat([xs, ys, zs])
            run = alive
            for _ in range(inner_cap):
                if not bool(run.any()):
                    break
                cxl, cxu, cyl, cyu, czl, czu = _deduce_group(
                    op, lb[:, xs], ub[:, xs], lb[:, ys], ub[:, ys],
                    lb[:, zs], ub[:, zs])
                lb, ub, ch = self._meet(
                    lb, ub, idx, torch.cat([cxl, cyl, czl], dim=1),
                    torch.cat([cxu, cyu, czu], dim=1), run)
                changed = changed | ch
                bot = bot | (ch & self.is_bot(lb, ub))
                run = ch & ~bot
            alive = alive & ~bot
        run = alive
        ch = torch.zeros_like(bot)
        if dp.E:
            il, ih, rl, rh = self._element_cands(lb, ub)
            lb, ub, c = self._meet(lb, ub, torch.cat([dp.e_idx, dp.e_res]),
                                   torch.cat([il, rl], dim=1),
                                   torch.cat([ih, rh], dim=1), run)
            ch = ch | c
        if dp.M:
            xl, xh, bl, bh = self._member_cands(lb, ub)
            lb, ub, c = self._meet(lb, ub, torch.cat([dp.m_x, dp.m_b]),
                                   torch.cat([xl, bl], dim=1),
                                   torch.cat([xh, bh], dim=1), run)
            ch = ch | c
        for bk in dp.lin:
            tl, th, b_lo, b_hi = self._linear_bucket_cands(lb, ub, bk)
            lb, ub, c = self._meet(lb, ub,
                                   torch.cat([bk.var.reshape(-1), bk.b]),
                                   torch.cat([tl, b_lo], dim=1),
                                   torch.cat([th, b_hi], dim=1), run)
            ch = ch | c
        return lb, ub, changed | ch, _where(run, self.is_bot(lb, ub), bot)

    def fixpoint_wac1_plain(self, lb, ub, max_iters: int = 100000,
                            inner_cap: int = 16):
        """WAC1 fixpoint: ``sweep_wac1_plain`` until a lane's sweep
        changes nothing, the lane is bot, or ``max_iters``. Returns (lb,
        ub, sweeps + 1 (D,) int32, unconv (D,) bool)."""
        D = lb.shape[0]
        z = torch.zeros(D, dtype=I32, device=lb.device)
        if self.P == 0:
            return lb, ub, z, z != 0
        m = z == 0
        sweeps = z
        it = 0
        while it < max_iters and bool(m.any()):
            lb2, ub2, ch, bot = self.sweep_wac1_plain(lb, ub, inner_cap)
            sweeps = sweeps + m.to(I32)
            lb = _where(m[:, None], lb2, lb)
            ub = _where(m[:, None], ub2, ub)
            m = m & ch & ~bot
            it += 1
        return lb, ub, sweeps + 1, m

    def fixpoint_wac1(self, lb, ub, max_iters: int = 100000,
                      inner_cap: int = 16):
        if lb.is_cuda:
            from ..kernels import wac1 as k_wac1
            return k_wac1(self.kernel_plan, lb, ub, int(max_iters),
                          int(inner_cap))
        if lb.device.type != "cpu":
            raise RuntimeError(f"no WAC1 fixpoint for device {lb.device}")
        return self.fixpoint_wac1_plain(lb, ub, max_iters, inner_cap)

    # -- classification ------------------------------------------------

    def all_entailed(self, lb, ub):
        """(D,) bool: every propagator entailed."""
        dp = self.dp
        out = torch.ones(lb.shape[0], dtype=torch.bool, device=lb.device)
        if self.P == 0:
            return out
        LX, UX = lb[:, dp.all_x], ub[:, dp.all_x]
        LY, UY = lb[:, dp.all_y], ub[:, dp.all_y]
        LZ, UZ = lb[:, dp.all_z], ub[:, dp.all_z]
        for op, a, b in dp.group_slices:
            ok = _ask_group(op, LX[:, a:b], UX[:, a:b], LY[:, a:b],
                            UY[:, a:b], LZ[:, a:b], UZ[:, a:b])
            out = out & ok.all(dim=1)
        if dp.E:
            out = out & self._element_ask(lb, ub).all(dim=1)
        if dp.M:
            out = out & self._member_ask(lb, ub).all(dim=1)
        if dp.lin:
            out = out & self._linear_ask_all(lb, ub)
        return out

    @staticmethod
    def is_bot(lb, ub):
        return (lb > ub).any(dim=1)

    def classify_plain(self, lb, ub):
        """(bot, ent) as (D,) bool: some domain empty / every propagator
        entailed (``ent`` is not masked by ``bot``)."""
        return self.is_bot(lb, ub), self.all_entailed(lb, ub)

    def classify(self, lb, ub):
        if lb.is_cuda:
            from ..kernels import classify as k_classify
            return k_classify(self.kernel_plan, lb, ub)
        if lb.device.type != "cpu":
            raise RuntimeError(f"no classify for device {lb.device}")
        return self.classify_plain(lb, ub)
