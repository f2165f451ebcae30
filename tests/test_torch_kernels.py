"""The CUDA kernels' tables and algorithm, checked on the CPU.

The kernels (turbo_tpu_torch/kernels/csrc/*.cu) cannot run here, so
this file transliterates them line for line into scalar Python over the
very tables the wrappers upload (``kernel_tables``): one dive at a time,
K1's scatter-meet into the second store routed by ``slot_tgt``, the
clamp pass and the skip of rules whose variables did not move; the block
argmin; K8 (WAC1) pass by pass, scatter-met into a second store routed by
the variables, with its claims, moved list and dirty rules; K6/K7 (the
step around K1-K3) one lane at a time over the state; and K5's steal
plan and K9's steals, block by block with their scans. The emulation
must equal the plain versions, which ``test_torch_propagate.py``,
``test_torch_engine.py`` and ``test_torch_table_engine.py`` hold to the
JAX package. The real kernels
are compared with the plain versions on the card (marked ``cuda``, and
by ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.core.ops import (INF, NINF, OP_ADD, OP_DIV, OP_EQ,
                                           OP_LE, OP_MAX, OP_MIN, OP_MUL)
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.host.solver import oracle
from turbo_tpu_torch.instances import golomb, queens, random_model
from turbo_tpu_torch.kernels import kernel_tables
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.engine import BatchedSolver

SUM_CLAMP = 1 << 40
WARP, BLOCK = 32, 256   # csrc/common.cuh TT_THREADS


def w32(x):
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def clip(v):
    return max(NINF, min(INF, v))


def fdiv(a, b):
    return a // b  # python // floors


def tdiv(a, b):
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def deduce(op, lx, ux, ly, uy, lz, uz):
    if op == OP_ADD:
        c = [w32(ly + lz), w32(uy + uz), w32(lx - uz), w32(ux - lz),
             w32(lx - uy), w32(ux - ly)]
    elif op == OP_MUL:
        ps = [ly * lz, ly * uz, uy * lz, uy * uz]
        c = [min(ps), max(ps)]
        for lb_, ub_ in ((lz, uz), (ly, uy)):
            sb = 1 if lb_ == 0 else lb_
            tb = -1 if ub_ == 0 else ub_
            lo = min(-fdiv(-a, b) for a in (lx, ux) for b in (sb, tb))
            hi = max(fdiv(a, b) for a in (lx, ux) for b in (sb, tb))
            if lb_ <= 0 <= ub_:
                lo, hi = NINF, INF
            c += [lo, hi]
    elif op == OP_DIV:
        lo, hi = INF, NINF
        for valid, plo, phi in ((lz <= -1, lz, min(uz, -1)),
                                (uz >= 1, max(lz, 1), uz)):
            if valid:
                qs = [tdiv(a, z) for a in (ly, uy) for z in (plo, phi)]
                lo, hi = min([lo] + qs), max([hi] + qs)
        if lz == 0 and uz == 0:
            lo, hi = INF, NINF
        pad = max(max(abs(lz), abs(uz)) - 1, 0)
        ps = [lx * lz, lx * uz, ux * lz, ux * uz]
        c = [lo, hi, min(ps) - pad, max(ps) + pad, NINF, INF]
    elif op == OP_MIN:
        c = [min(ly, lz), min(uy, uz), lx, ux if lz > ux else INF,
             lx, ux if ly > ux else INF]
    elif op == OP_MAX:
        c = [max(ly, lz), max(uy, uz), lx if uz < lx else NINF, ux,
             lx if uy < lx else NINF, ux]
    elif op == OP_LE:
        tt, ff = lx >= 1, ux <= 0
        c = [int(uy <= lz), 1 - int(ly > uz),
             w32(lz + 1) if ff else NINF, uz if tt else INF,
             ly if tt else NINF, w32(uy - 1) if ff else INF]
    else:
        tt, ff = lx >= 1, ux <= 0
        c = [int(ly == uy == lz == uz), int(max(ly, lz) <= min(uy, uz)),
             lz if tt else (w32(ly + 1) if ff and lz == uz and lz == ly else NINF),
             uz if tt else (w32(uy - 1) if ff and lz == uz and lz == uy else INF),
             ly if tt else (w32(lz + 1) if ff and ly == uy and ly == lz else NINF),
             uy if tt else (w32(uz - 1) if ff and ly == uy and ly == uz else INF)]
    return [clip(v) for v in c]


def ask(op, lx, ux, ly, uy, lz, uz):
    sing = lx == ux and ly == uy and lz == uz
    if op == OP_ADD:
        return sing and lx == w32(ly + lz)
    if op == OP_MUL:
        return sing and lx == ly * lz
    if op == OP_DIV:
        return sing and lz != 0 and lx == tdiv(ly, lz)
    if op == OP_MIN:
        return sing and lx == min(ly, lz)
    if op == OP_MAX:
        return sing and lx == max(ly, lz)
    if op == OP_LE:
        return (lx >= 1 and uy <= lz) or (ux <= 0 and ly > uz)
    return ((lx >= 1 and ly == uy and lz == uz and ly == lz)
            or (ux <= 0 and (uy < lz or ly > uz)))


def lin_terms(t, r, lb, ub):
    fit32 = bool(t["l_flags"][r] & 2)
    o = t["l_toff"][r]
    out = []
    for k in range(t["l_K"][r]):
        c, v = int(t["l_coef"][o + k]), int(t["l_var"][o + k])
        a, b = c * lb[v], c * ub[v]
        if fit32:
            a, b = w32(a), w32(b)
            out.append((c, min(a, b), max(a, b)))
        else:
            out.append((c, max(-SUM_CLAMP, min(min(a, b), SUM_CLAMP)),
                        max(-SUM_CLAMP, min(max(a, b), SUM_CLAMP))))
    return out


def member_count(t, i, lx, ux):
    W, base = t["W"], int(t["m_base"][i])
    wl = min(max(w32(lx - base), 0), W)
    wh = min(max(w32(w32(ux - base) + 1), 0), W)
    return int(t["m_cnt"][i * (W + 1) + wh]) - int(t["m_cnt"][i * (W + 1) + wl])


def tnf_cands(t, p, lb, ub):
    """(slot, lo, hi) of TNF propagator p's three roles."""
    P = t["P"]
    x, y, z = int(t["px"][p]), int(t["py"][p]), int(t["pz"][p])
    c = deduce(int(t["prop_op"][p]), lb[x], ub[x], lb[y], ub[y], lb[z], ub[z])
    return [(r * P + p, c[2 * r], c[2 * r + 1]) for r in range(3)]


def elem_cands(t, i, lb, ub):
    P, E, T = t["P"], t["E"], t["T"]
    n = int(t["e_len"][i])
    li, ui = lb[t["e_idx"][i]], ub[t["e_idx"][i]]
    lr, ur = lb[t["e_res"][i]], ub[t["e_res"][i]]
    ok = [j for j in range(T) if w32(li - 1) <= j <= w32(ui - 1) and j < n
          and lr <= t["e_tab"][i * T + j] <= ur]
    vals = [int(t["e_tab"][i * T + j]) for j in ok]
    return [(3 * P + i, (min(ok) if ok else INF - 1) + 1,
             (max(ok) if ok else NINF - 1) + 1),
            (3 * P + E + i, min(vals, default=INF), max(vals, default=NINF))]


def member_cands(t, i, lb, ub):
    P, E, M, W = t["P"], t["E"], t["M"], t["W"]
    base, top = int(t["m_base"][i]), int(t["m_top"][i])
    lx, ux = lb[t["m_x"][i]], ub[t["m_x"][i]]
    c = member_count(t, i, lx, ux)
    width = ux - lx + 1
    wl = min(max(w32(lx - base), 0), W - 1)
    wh = min(max(w32(ux - base), 0), W - 1)
    nge = INF if lx > top else int(t["m_next_ge"][i * W + wl])
    ple = NINF if ux < base else int(t["m_prev_le"][i * W + wh])
    nout = int(t["m_next_out"][i * W + wl]) if base <= lx <= top else lx
    pout = int(t["m_prev_out"][i * W + wh]) if base <= ux <= top else ux
    tt, ff = lb[t["m_b"][i]] >= 1, ub[t["m_b"][i]] <= 0
    s = 3 * P + 2 * E + i
    return [(s, clip(nge if tt else (nout if ff else NINF)),
             clip(ple if tt else (pout if ff else INF))),
            (s + M, int(c == width and width > 0), int(c > 0))]


def linear_cands(t, r, lb, ub):
    """The reified linear row r: its b slot, then one slot per term with
    a nonzero coefficient."""
    terms = lin_terms(t, r, lb, ub)
    smin = sum(a for _, a, _ in terms)
    smax = sum(b for _, _, b in terms)
    rhs, is_eq = int(t["l_rhs"][r]), t["l_op"][r] == 1
    out = [(t["base_linb"] + r,
            int(smin == rhs == smax) if is_eq else int(smax <= rhs),
            int(smin <= rhs <= smax) if is_eq else int(smin <= rhs))]
    tt, ff = lb[t["l_b"][r]] >= 1, ub[t["l_b"][r]] <= 0
    ge_act, le_act = (is_eq and tt) or (not is_eq and ff), tt
    rhs2 = rhs if is_eq else rhs + 1
    for k, (c, tmin, tmax) in enumerate(terms):
        if c == 0:
            continue
        R, R2 = rhs - (smin - tmin), rhs2 - (smax - tmax)
        if t["l_flags"][r] & 1:
            q_le = ceil_le = R * c
            q_ge = ceil_ge = R2 * c
        else:
            q_le, q_ge = fdiv(R, c), fdiv(R2, c)
            ceil_le = q_le + int(R - q_le * c != 0)
            ceil_ge = q_ge + int(R2 - q_ge * c != 0)
        hi = min(q_le if le_act and c > 0 else INF,
                 q_ge if ge_act and c < 0 else INF)
        lo = max(ceil_le if le_act and c < 0 else NINF,
                 ceil_ge if ge_act and c > 0 else NINF)
        out.append((t["base_lin"] + int(t["l_toff"][r]) + k, clip(lo),
                    clip(hi)))
    return out


def rules(t):
    """Every rule in the kernel's order, as (its variables, its
    candidates from a store)."""
    for p in range(t["P"]):
        yield ((t["px"][p], t["py"][p], t["pz"][p]),
               lambda lb, ub, p=p: tnf_cands(t, p, lb, ub))
    for i in range(t["E"]):
        yield ((t["e_idx"][i], t["e_res"][i]),
               lambda lb, ub, i=i: elem_cands(t, i, lb, ub))
    for i in range(t["M"]):
        yield ((t["m_x"][i], t["m_b"][i]),
               lambda lb, ub, i=i: member_cands(t, i, lb, ub))
    for r in range(t["L"]):
        o = t["l_toff"][r]
        yield ((t["l_b"][r], *t["l_var"][o:o + t["l_K"][r]]),
               lambda lb, ub, r=r: linear_cands(t, r, lb, ub))


def emulate_fixpoint(t, lb_row, ub_row, cap, fixed=False, skip=True,
                     trace=None, seen=None):
    """fixpoint.cu's ``sweep_loop`` and what its kernel writes; ``fixed``:
    the ``tt_fixed_sweeps`` entry (exactly ``cap`` sweeps); ``skip``:
    from the second sweep on, run only the rules with a variable that
    moved in the sweep before (``skip=False``: the TT_NO_SKIP build).
    The kernel gathers the TNF rules to run into a worklist first and
    meets in any order; max and min make the order immaterial, so the
    rules run here in plan order.
    ``trace`` collects (A lb, A ub, changed, bot, the indices in
    ``rules`` order of the rules run) per sweep, ``seen`` the slots phase
    A handed to the meet."""
    al, au = [int(v) for v in lb_row], [int(v) for v in ub_row]
    bl, bu = al[:], au[:]
    V, tgt, dummy = t["V"], t["slot_tgt"], t["V"] - 1
    mk = [False] * V
    it, iters, m = 0, 0, True
    while (m or fixed) and it < cap:
        ran = []
        for j, (vs, cands) in enumerate(rules(t)):
            if skip and it > 0 and not any(mk[v] for v in vs):
                continue
            ran.append(j)
            for s, lo, hi in cands(al, au):
                if seen is not None:
                    seen.add(s)
                g, c = tgt[2 * s], tgt[2 * s + 1]
                if g >= 0:  # atomicMax / atomicMin when past A's bound
                    if lo > al[g]:
                        bl[g] = max(bl[g], lo)
                    if hi < au[g]:
                        bu[g] = min(bu[g], hi)
                elif g != -1:  # TT_CONF(k): fold against c = conf_off[k]
                    if (lo > c or hi < c) and al[dummy] < 1:
                        bl[dummy] = max(bl[dummy], 1)
        changed = bot = False
        for v in range(V):
            l, u = bl[v], bu[v]
            mk[v] = False
            if it == 0 or l != al[v] or u != au[v]:
                l = min(l, int(t["ub_cap"][v]))
                u = max(u, int(t["lb_floor"][v]))
                mk[v] = l != al[v] or u != au[v]
                al[v] = bl[v] = l
                au[v] = bu[v] = u
            changed |= mk[v]
            bot |= l > u
        iters += 1
        it += 1
        m = changed and not bot
        if trace is not None:
            trace.append((al[:], au[:], changed, bot, ran))
    if fixed:
        return al, au, iters, False
    return al, au, iters + 1, m


def wac1_passes(t):
    """K8's passes in order, as (pass, its first rule id, its rules): each
    op-group over ``tnf4`` (the kernel's TNF table), then the element
    rows, the membership rows and each linear bucket; rules are numbered
    TNF, element, membership, linear rows, and a rule is (its variables,
    its candidates (slot, var, lo, hi) from a store)."""
    P = t["P"]

    def tnf(i):
        op, x, y, z = t["tnf4"][4 * i:4 * i + 4]  # one int4 load

        def cands(lb, ub):
            c = deduce(op, lb[x], ub[x], lb[y], ub[y], lb[z], ub[z])
            return [(r * P + i, v, c[2 * r], c[2 * r + 1])
                    for r, v in enumerate((x, y, z))]
        return (x, y, z), cands

    def routed(cands):  # the target variable of each slot
        return lambda lb, ub: [(sl, slot_var(t, sl), lo, hi)
                               for sl, lo, hi in cands(lb, ub)]

    passes = [(g, t["g_off"][g],
               [tnf(i) for i in range(t["g_off"][g], t["g_off"][g + 1])])
              for g in range(t["G"])]
    E0, M0 = P + t["E"], P + t["E"] + t["M"]
    if t["E"]:
        passes.append((t["G"], P, [((t["e_idx"][i], t["e_res"][i]), routed(
            lambda lb, ub, i=i: elem_cands(t, i, lb, ub)))
            for i in range(t["E"])]))
    if t["M"]:
        passes.append((t["G"] + 1, E0, [((t["m_x"][i], t["m_b"][i]), routed(
            lambda lb, ub, i=i: member_cands(t, i, lb, ub)))
            for i in range(t["M"])]))
    for k in range(t["LB"]):
        rows = []
        for r in range(t["lb_off"][k], t["lb_off"][k + 1]):
            o = t["l_toff"][r]
            rows.append(((t["l_b"][r], *t["l_var"][o:o + t["l_K"][r]]),
                         routed(lambda lb, ub, r=r: linear_cands(t, r, lb,
                                                                 ub))))
        passes.append((t["G"] + 2 + k, M0 + t["lb_off"][k], rows))
    return passes


def emulate_wac1(t, lb_row, ub_row, cap, inner_cap, skip=True, trace=None,
                 stats=None):
    """wac1.cu's ``sweep_loop`` for one dive and what its kernel writes.
    A pass whose bit of ``pend`` is clear runs nothing and has no
    barrier; otherwise its dirty rules (all of them on the first sweep,
    or with ``skip`` False: the TT_NO_SKIP build) compute candidates from
    A, clear their bits and meet the candidates, clamped to the root box,
    into B; a variable moved past A is claimed and listed once; after the
    barrier the listed variables are copied into A, unclaimed and tested
    for an empty domain, their ``v_pass`` bits set ``pend`` and the rules
    the CSR ``v_roff`` / ``v_rule`` lists for them turn dirty. The kernel
    meets in any order; max and min make the order immaterial, so the
    rules run here in plan order. ``trace`` collects (pass, A lb, A ub)
    after each pass that moved a variable; ``stats`` counts per pass the
    rules run (``"ran"``), the rules of the passes that ran
    (``"held"``), the passes run (``"runs"``) and skipped whole
    (``"skipped"``)."""
    al, au = [int(v) for v in lb_row], [int(v) for v in ub_row]
    bl, bu = al[:], au[:]
    V, G = t["V"], t["G"]
    dirty = [True] * (t["P"] + t["E"] + t["M"] + t["L"])
    vp = [x & 0xFFFFFFFF for x in t["v_pass"]]
    pend = [0xFFFFFFFF]
    bot = any(al[v] > au[v] for v in range(V))
    passes = wac1_passes(t)

    def bit(s):
        return 1 << min(s, 31)

    def run_pass(s, r0, rules):
        nonlocal bot
        st = stats.setdefault(s, dict(ran=0, held=0, runs=0, skipped=0)) \
            if stats is not None else None
        if skip and not pend[0] & bit(s):
            if st is not None:
                st["skipped"] += 1
            return False
        moved, claimed = [], set()
        for j, (_, cands) in enumerate(rules):
            if skip and not dirty[r0 + j]:
                continue
            dirty[r0 + j] = False
            if st is not None:
                st["ran"] += 1
            for _, v, lo, hi in cands(al, au):
                m = False
                if lo > al[v]:  # the root box is read only past A
                    lo = min(lo, t["ub_cap"][v])
                    if lo > al[v]:
                        bl[v], m = max(bl[v], lo), True
                if hi < au[v]:
                    hi = max(hi, t["lb_floor"][v])
                    if hi < au[v]:
                        bu[v], m = min(bu[v], hi), True
                if m and v not in claimed:  # the claim bit: listed once
                    claimed.add(v)
                    moved.append(v)
        if st is not None:
            st["held"] += len(rules)
            st["runs"] += 1
        if s < 31:
            pend[0] &= ~(1 << s)
        if not moved:
            return False
        for v in moved:
            al[v], au[v] = bl[v], bu[v]
            bot |= al[v] > au[v]
            pend[0] |= vp[v]
            if skip:
                for e in range(t["v_roff"][v], t["v_roff"][v + 1]):
                    dirty[t["v_rule"][e]] = True
        if trace is not None:
            trace.append((s, al[:], au[:]))
        return True

    sweeps, it, m = 0, 0, True
    while m and it < cap:
        changed = False
        for s, r0, rules in passes:
            if s < G:  # an op-group, to its local fixpoint
                if s > 0 and bot:
                    break
                for _ in range(inner_cap):
                    ch = run_pass(s, r0, rules)
                    changed |= ch
                    if not ch or bot:
                        break
            elif not bot:  # every row pass, once the groups left no bot
                changed |= run_pass(s, r0, rules)
        sweeps += 1
        it += 1
        m = changed and not bot
    return al, au, sweeps + 1, m


def tnf_ask(t, i, lb, ub):
    op, x, y, z = t["tnf4"][4 * i:4 * i + 4]  # one int4 load
    return ask(op, lb[x], ub[x], lb[y], ub[y], lb[z], ub[z])


def elem_ask(t, i, lb, ub):
    T, n = t["T"], int(t["e_len"][i])
    li = min(max(lb[t["e_idx"][i]], 1), n)
    ui = min(max(ub[t["e_idx"][i]], 1), n)
    win = [int(t["e_tab"][i * T + j]) for j in range(T)
           if li - 1 <= j <= ui - 1 and j < n]
    lr, ur = lb[t["e_res"][i]], ub[t["e_res"][i]]
    return (lr == ur and min(win, default=INF) == lr
            and max(win, default=NINF) == lr)


def member_ask(t, i, lb, ub):
    lx, ux = lb[t["m_x"][i]], ub[t["m_x"][i]]
    c, width = member_count(t, i, lx, ux), ux - lx + 1
    return ((lb[t["m_b"][i]] >= 1 and c == width and width > 0)
            or (ub[t["m_b"][i]] <= 0 and c == 0))


def lin_ask(t, r, lb, ub):
    terms = lin_terms(t, r, lb, ub)
    smin, smax = sum(a for _, a, _ in terms), sum(b for _, _, b in terms)
    rhs, is_eq = int(t["l_rhs"][r]), t["l_op"][r] == 1
    tt, ff = lb[t["l_b"][r]] >= 1, ub[t["l_b"][r]] <= 0
    ent_t = smin == rhs == smax if is_eq else smax <= rhs
    ent_f = (rhs < smin or rhs > smax) if is_eq else smin > rhs
    return (tt and ent_t) or (ff and ent_f)


def emulate_classify(t, lb, ub, stats=None):
    """classify.cuh's ``classify_block``: the bot pass, then each
    thread's rules in the block's strided order (the TNF rules from
    ``tnf4``, then the element, membership and linear rows), the threads
    advancing in lockstep; a thread stops at its own first failure, and
    every thread at the round after the first failure of any (the
    shared "failed" word). ``stats`` collects the rules asked
    (``asked``) out of all (``rules``)."""
    lb, ub = [int(v) for v in lb], [int(v) for v in ub]
    bot = any(l > u for l, u in zip(lb, ub))
    if t["P"] == 0:
        return bot, True
    fams = ((t["P"], tnf_ask), (t["E"], elem_ask), (t["M"], member_ask),
            (t["L"], lin_ask))
    todo = [[(fn, i) for n, fn in fams for i in range(tid, n, BLOCK)]
            for tid in range(BLOCK)]
    ok, failed, asked = [True] * BLOCK, False, 0
    for k in range(max(len(x) for x in todo)):
        stop = failed  # the word as this round began
        for tid in range(BLOCK):
            if ok[tid] and not stop and k < len(todo[tid]):
                fn, i = todo[tid][k]
                ok[tid] = fn(t, i, lb, ub)
                failed |= not ok[tid]
                asked += 1
    if stats is not None:
        stats["asked"] = stats.get("asked", 0) + asked
        stats["rules"] = stats.get("rules", 0) + sum(n for n, _ in fams)
    return bot, all(ok)


def emulate_select(t, lb, ub, strat):
    """select.cuh's ``select_block``: per strategy each thread's least
    packed (key, position) over its strided positions, the least of each
    warp, and an OR of "splittable" ends the strategy; warp 0 folds the
    per-warp minima of the strategy that ends the walk."""
    lb, ub = [int(v) for v in lb], [int(v) for v in ub]

    def pack(key, pos):
        return (((key & 0xFFFFFFFF) ^ 0x80000000) << 32) | pos

    def scan(s):
        b, e = t["s_off"][s], t["s_off"][s + 1]
        vo = t["s_vo"][s]
        best, found = [2 ** 64 - 1] * BLOCK, False
        for i in range(e - b):
            v = int(t["s_ids"][b + i])
            l, u = lb[v], ub[v]
            ok = l < u and l > NINF and u < INF
            size = w32(u - l)
            key = [i, size, w32(-size), l][vo] if vo < 4 else w32(-u)
            tid = i % BLOCK
            best[tid] = min(best[tid], pack(key if ok else 2 ** 31 - 1, i))
            found |= ok
        return [min(best[w:w + WARP]) for w in range(0, BLOCK, WARP)], found

    found, chosen = False, 0
    for s in range(max(int(strat), 0), t["S"]):
        wmin, found = scan(s)
        if found:
            chosen = s
            break
    if not found:
        wmin, _ = scan(0)
    pos = min(wmin) & 0xFFFFFFFF  # warp 0's fold
    var = int(t["s_ids"][t["s_off"][chosen] + pos])
    valo = int(t["s_valo"][chosen])
    lo, hi = lb[var], ub[var]
    mid = w32(lo + (w32(hi - lo) >> 1))
    ch = {0: (lo, lo, w32(lo + 1), hi), 1: (hi, hi, lo, w32(hi - 1)),
          2: (lo, mid, w32(mid + 1), hi), 3: (w32(mid + 1), hi, lo, mid)}
    return (found, var, chosen, valo) + ch.get(valo, (0, 0, 0, 0))


def emulate_fixpoint_step(t, lb_row, ub_row, cap, strat, stats=None):
    """fixpoint.cu's ``tt_fixpoint_step`` for one dive: the fixpoint of
    ``tt_fixpoint``, then ``classify_block`` and ``select_block`` on the
    block's final store. Returns the 14 outputs of
    ``kernels.fixpoint.step``, lanes as lists."""
    el, eu, ei, em = emulate_fixpoint(t, lb_row, ub_row, cap)
    return ((el, eu, ei, em) + emulate_classify(t, el, eu, stats)
            + tuple(emulate_select(t, el, eu, strat)))


def emulate_wac1_step(t, lb_row, ub_row, cap, inner_cap, strat):
    """wac1.cu's ``tt_wac1_step`` for one dive: the fixpoint of
    ``tt_wac1``, then ``classify_block`` and ``select_block`` on the
    block's final store (A). Returns the 14 outputs of
    ``kernels.wac1.step``, lanes as lists."""
    el, eu, ei, em = emulate_wac1(t, lb_row, ub_row, cap, inner_cap)
    return ((el, eu, ei, em) + emulate_classify(t, el, eu)
            + tuple(emulate_select(t, el, eu, strat)))


def gather_parent(chunk, r):
    """level.cuh's prologue for row r: the parent row pidx[r] met at its
    branch variable with the child interval pbit[r] selects (row r of
    ``embed_plain``). ``chunk``: dive_level's ten inputs as lists.
    Returns (lb, ub, the parent's cursor)."""
    lb, ub, strat, var, c0l, c0u, c1l, c1u, pidx, pbit = chunk
    p = pidx[r]
    right = pbit[r] == 1
    l, u, v = list(lb[p]), list(ub[p]), var[p]
    l[v] = max(l[v], (c1l if right else c0l)[p])
    u[v] = min(u[v], (c1u if right else c0u)[p])
    return l, u, strat[p]


def emulate_level(t, chunk, r, step, obj):
    """A level entry (``tt_fixpoint_level`` / ``tt_wac1_level``) for row
    r: the gathered parent row, then ``step(lb, ub, cursor)`` (the step
    entry's 14 outputs: the fixpoint, then K2 and K3 on its store), then
    level_epilogue's outputs. With no propagator the store is the
    gathered one and iters 0. Returns dive_level's 13 outputs of row r."""
    lb, ub, stp = gather_parent(chunk, r)
    if t["P"] == 0:
        out = ((lb, ub, 0, False) + emulate_classify(t, lb, ub)
               + tuple(emulate_select(t, lb, ub, stp)))
    else:
        out = step(lb, ub, stp)
    el, eu, iters, _, bot, ent, found, var, chosen, _, *children = out
    return (el, eu, chosen if found else stp, var, *children, bot,
            ent and not bot, found, iters, el[obj])


def emulate_fixpoint_level(t, chunk, r, cap, obj):
    """fixpoint.cu's ``tt_fixpoint_level`` for row r (``emulate_level``
    around ``emulate_fixpoint_step``)."""
    return emulate_level(t, chunk, r, lambda lb, ub, stp:
                         emulate_fixpoint_step(t, lb, ub, cap, stp), obj)


def emulate_wac1_level(t, chunk, r, cap, inner_cap, obj):
    """wac1.cu's ``tt_wac1_level`` for row r (``emulate_level`` around
    ``emulate_wac1_step``)."""
    return emulate_level(t, chunk, r, lambda lb, ub, stp:
                         emulate_wac1_step(t, lb, ub, cap, inner_cap, stp),
                         obj)


def level_solver(case, mode, device="cpu"):
    """A table-mode solver for the level tests, on ``device``: golomb(6)
    (``"golomb6"``) or ``random_model(1)`` (``"rand1"``) under fp_mode
    ``mode``. With the suffix ``"_odd"`` its plan keeps V as the planner
    counts it, not rounded up to a multiple of 128: a V that is not a
    multiple of 4, whose rows the level entries load with the loop and
    not by TMA."""
    from unittest import mock

    from turbo_tpu_torch.host.solver import plan as plan_mod
    name, odd = case.removesuffix("_odd"), case.endswith("_odd")
    text = golomb(6) if name == "golomb6" else random_model(1, n_vars=7,
                                                            n_cons=18)
    rounded = plan_mod.quantize
    with mock.patch.object(plan_mod, "quantize", (
            lambda n, min_gran=32: n if min_gran == 128
            else rounded(n, min_gran)) if odd else rounded):
        s = BatchedSolver(compile_model(parse_fzn_text(text)),
                          EngineConfig(num_dives=8, subproblems_power=4,
                                       max_depth=64, fp_mode=mode,
                                       fp_cap_auto=False), device=device)
    assert s.use_table and (s.plan.V % 4 != 0) == odd
    return s


def level_chunk(s, seed):
    """dive_level's ten inputs as numpy arrays, W = num_dives rows, in
    the manner of test_torch_eps_table's ``_dive_inputs``: parents with
    root boxes narrowed at random and one bot row, branch variables,
    their children (a quarter neutral), cursors (some past every
    strategy), parent rows and bits."""
    rng = np.random.default_rng(seed)
    plan, W = s.plan, s.cfg.num_dives
    lb = np.tile(plan.lb0, (W, 1)).astype(np.int32)
    ub = np.tile(plan.ub0, (W, 1)).astype(np.int32)
    for d in range(W):
        for v in rng.choice(plan.n_active, size=3, replace=False):
            if lb[d, v] < ub[d, v]:
                lo = rng.integers(lb[d, v], ub[d, v] + 1)
                lb[d, v], ub[d, v] = lo, rng.integers(lo, ub[d, v] + 1)
    lb[1, 0] = ub[1, 0] + 1
    var = rng.integers(0, plan.n_active, W).astype(np.int32)
    lo, hi = lb[np.arange(W), var], ub[np.arange(W), var]
    mid = lo + (hi - lo) // 2
    neutral = rng.random(W) < 0.25
    c0l, c1l = (np.where(neutral, NINF, c).astype(np.int32)
                for c in (lo, mid + 1))
    c0u, c1u = (np.where(neutral, INF, c).astype(np.int32)
                for c in (mid, hi))
    strat = rng.integers(0, len(s.dp.strat_ids) + 1, W).astype(np.int32)
    pidx = rng.integers(0, W, W).astype(np.int32)
    pidx[0] = 1  # the bot parent
    pbit = rng.integers(0, 2, W).astype(np.int32)
    return lb, ub, strat, var, c0l, c0u, c1l, c1u, pidx, pbit


def _case(seed):
    text = golomb(4) if seed < 0 else random_model(seed, n_vars=7, n_cons=18)
    tnf = compile_model(parse_fzn_text(text))
    s = BatchedSolver(tnf, EngineConfig(num_dives=12, subproblems_power=3,
                                        max_depth=64, use_table=False,
                                        fp_cap_auto=False), device="cpu")
    rng = np.random.default_rng(seed + 10)
    plan, D = s.plan, 12
    lb = np.tile(plan.lb0, (D, 1)).astype(np.int32)
    ub = np.tile(plan.ub0, (D, 1)).astype(np.int32)
    sol = oracle.solve(tnf, timeout_s=30).best_lb
    for d in range(D):
        if d % 4 == 0 and sol is not None:
            keep = ~plan.dropped
            lb[d, plan.perm[keep]] = ub[d, plan.perm[keep]] = sol[keep]
            continue
        for v in rng.choice(plan.n_active, size=3, replace=False):
            if lb[d, v] < ub[d, v]:
                lo = rng.integers(lb[d, v], ub[d, v] + 1)
                lb[d, v], ub[d, v] = lo, rng.integers(lo, ub[d, v] + 1)
    strat = rng.integers(0, len(s.dp.strat_ids) + 1, D).astype(np.int32)
    return s, torch.as_tensor(lb), torch.as_tensor(ub), torch.as_tensor(strat)


@pytest.mark.parametrize("seed", [-1, 0, 1, 2, 3])
def test_kernel_emulation_matches_plain(seed):
    s, lb, ub, strat = _case(seed)
    t = kernel_tables(s.dp)
    for k, v in t.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == (np.int64 if k == "l_rhs" else np.int32), k
            t[k] = [int(x) for x in v.reshape(-1)]  # flat, as uploaded
    for cap in (10000, 2):
        pl, pu, pi, pm = s.kernels.fixpoint_plain(lb, ub, cap)
        for d in range(lb.shape[0]):
            el, eu, ei, em = emulate_fixpoint(t, lb[d].tolist(), ub[d].tolist(), cap)
            assert el == pl[d].tolist() and eu == pu[d].tolist(), (cap, d)
            assert (ei, em) == (int(pi[d]), bool(pm[d])), (cap, d)
    for a, b in ((lb, ub), (pl, pu)):
        bot, ent = s.kernels.classify_plain(a, b)
        sel = s._select_plain(a, b, strat)
        for d in range(lb.shape[0]):
            assert emulate_classify(t, a[d], b[d]) == (bool(bot[d]), bool(ent[d]))
            want = tuple(int(x[d]) for x in sel)
            assert tuple(int(x) for x in emulate_select(t, a[d], b[d], strat[d])) == want


def _fused_case(case):
    """A _case (seed), golomb(8) or golomb(12) at D=8, with lane 0's
    cursor past every strategy (the strategy-0 default) and lane 1 bot;
    golomb(8)'s lane 2 is fixed at a solution."""
    if case in ("golomb8", "golomb12"):
        tnf = compile_model(parse_fzn_text(golomb(int(case[6:]))))
        s = BatchedSolver(tnf, EngineConfig(num_dives=8, max_depth=64,
                                            use_table=False,
                                            fp_cap_auto=False), device="cpu")
        rng = np.random.default_rng(8)
        plan = s.plan
        lb = np.tile(plan.lb0, (8, 1)).astype(np.int32)
        ub = np.tile(plan.ub0, (8, 1)).astype(np.int32)
        if case == "golomb8":
            sol = oracle.solve(tnf, timeout_s=60).best_lb
            keep = ~plan.dropped
            lb[2, plan.perm[keep]] = ub[2, plan.perm[keep]] = sol[keep]
        for d in range(3, 8):  # the first marks fixed at random
            for v in range(d):
                lb[d, v] = ub[d, v] = rng.integers(lb[d, v], ub[d, v] + 1)
        strat = rng.integers(0, len(s.dp.strat_ids) + 1, 8).astype(np.int32)
        lb, ub, strat = map(torch.as_tensor, (lb, ub, strat))
    else:
        s, lb, ub, strat = _case(case)
    strat[0] = len(s.dp.strat_ids)
    v = int(np.argmax((ub[1] > lb[1]).numpy()))
    lb[1, v] = ub[1, v] + 1
    return s, lb, ub, strat


@pytest.mark.parametrize("case", [-1, 0, 1, 2, 3, "golomb8"])
def test_fixpoint_step_emulation_matches_plain(case):
    """K1's step entry (the fixpoint, then K2 and K3 on the block's final
    store) as transliterated above equals ``fixpoint_plain``, then
    ``classify_plain`` and ``_select_plain`` on its result, on every
    lane and output at caps 10000 and 2: bot lanes, entailed lanes and a
    cursor past every strategy included. The block-wide early exit asks
    fewer rules than there are on a lane that is not entailed."""
    s, lb, ub, strat = _fused_case(case)
    t = flat_tables(s)
    seen = {"bot": 0, "ent": 0, "default": 0}
    for cap in (10000, 2):
        pl, pu, pi, pm = s.kernels.fixpoint_plain(lb, ub, cap)
        bot, ent = s.kernels.classify_plain(pl, pu)
        sel = s._select_plain(pl, pu, strat)
        for d in range(lb.shape[0]):
            stats = {}
            got = emulate_fixpoint_step(t, lb[d].tolist(), ub[d].tolist(),
                                        cap, int(strat[d]), stats)
            want = (pl[d].tolist(), pu[d].tolist(), int(pi[d]),
                    bool(pm[d]), bool(bot[d]), bool(ent[d]),
                    *(int(x[d]) for x in sel))
            assert got[:4] == want[:4], (cap, d)
            assert tuple(int(x) for x in got[4:]) == tuple(
                int(x) for x in want[4:]), (cap, d)
            if not ent[d] and t["P"]:
                assert stats["asked"] < stats["rules"], (cap, d)
            seen["bot"] += bool(bot[d])
            seen["ent"] += bool(ent[d] & ~bot[d])
            seen["default"] += not bool(sel[0][d])
    assert all(seen.values()), seen


def flat_tables(s):
    """The kernel tables of solver ``s`` as ints and lists of ints."""
    t = kernel_tables(s.dp)
    return {k: ([int(x) for x in v.reshape(-1)]
                if isinstance(v, np.ndarray) else v) for k, v in t.items()}


def _wac1_case(case):
    """A _case (seed), or a _fused_case of golomb(8) or golomb(12)."""
    if isinstance(case, str):
        return _fused_case(case)
    return _case(case)


@pytest.mark.parametrize("case", [-1, 0, 1, 2, 3, "golomb8", "golomb12"])
def test_wac1_kernel_emulation_matches_plain(case):
    """K8 as transliterated above against ``fixpoint_wac1_plain``, every
    lane and output, at outer caps 10000 and 2 and inner caps 16 and 1;
    the group and bucket offsets the kernel walks are the plan's."""
    s, lb, ub, _ = _wac1_case(case)
    t = flat_tables(s)
    assert t["g_off"] == [0] + [b for _, _, b in s.dp.group_slices]
    assert t["G"] == len(s.dp.group_slices) and t["g_off"][-1] == t["P"]
    assert t["LB"] == len(s.dp.lin) and t["lb_off"][-1] == t["L"]
    assert [t["lb_off"][k + 1] - t["lb_off"][k] for k in range(t["LB"])] == [
        bk.coef.shape[0] for bk in s.dp.lin]
    for cap in (10000, 2):
        for inner in (16, 1):
            pl, pu, pi, pm = s.kernels.fixpoint_wac1_plain(lb, ub, cap, inner)
            for d in range(lb.shape[0]):
                el, eu, ei, em = emulate_wac1(t, lb[d].tolist(),
                                              ub[d].tolist(), cap, inner)
                assert el == pl[d].tolist() and eu == pu[d].tolist(), (cap, d)
                assert (ei, em) == (int(pi[d]), bool(pm[d])), (cap, inner, d)


@pytest.mark.parametrize("case", [-1, 0, 1, 2, 3, "golomb8"])
def test_wac1_step_emulation_matches_plain(case):
    """K8's step entry (the fixpoint, then K2 and K3 on the block's final
    store) as transliterated above equals ``fixpoint_wac1_plain``, then
    ``classify_plain`` and ``_select_plain`` on its result, on every lane
    and output at outer caps 10000 and 2 and inner caps 16 and 1: bot
    lanes, entailed lanes and a cursor past every strategy included."""
    s, lb, ub, strat = _fused_case(case)
    t = flat_tables(s)
    seen = {"bot": 0, "ent": 0, "default": 0}
    for cap in (10000, 2):
        for inner in (16, 1):
            want = s.kernels.fixpoint_wac1_plain(lb, ub, cap, inner)
            want += s.kernels.classify_plain(*want[:2])
            want += s._select_plain(*want[:2], strat)
            for d in range(lb.shape[0]):
                got = emulate_wac1_step(t, lb[d].tolist(), ub[d].tolist(),
                                        cap, inner, int(strat[d]))
                assert got[:2] == (want[0][d].tolist(), want[1][d].tolist())
                assert tuple(int(x) for x in got[2:]) == tuple(
                    int(w[d]) for w in want[2:]), (cap, inner, d)
                seen["bot"] += bool(want[4][d])
                seen["ent"] += bool(want[5][d] & ~want[4][d])
                seen["default"] += not bool(want[6][d])
    assert all(seen.values()), seen


@pytest.mark.parametrize("mode", ("fixpoint", "wac1"))
@pytest.mark.parametrize("case", ("golomb6", "golomb6_odd", "rand1",
                                  "rand1_odd"))
def test_level_emulation_matches_plain_dive_level(case, mode):
    """K1's and K8's table level entries as transliterated above (the
    parent gathered into the store, the fixpoint to the table build's
    cap, K2 and K3, the rest of dive_level's outputs) equal the plain
    ``dive_level`` on every row and output, on chunks with a bot parent
    and neutral children, V a multiple of 4 and not; tolerance 0."""
    from turbo_tpu_torch.solver import eps_table
    s = level_solver(case, mode)
    t = flat_tables(s)
    obj = s.dp.obj
    seen = {"bot": 0, "ent": 0, "found": 0}
    for seed in (0, 1):
        chunk = level_chunk(s, seed)
        want = eps_table.dive_level_plain(s, *map(torch.as_tensor, chunk))
        lists = [a.tolist() for a in chunk]
        for r in range(len(chunk[8])):
            got = (emulate_wac1_level(t, lists, r, eps_table._BIG_CAP,
                                      s.cfg.wac1_inner_cap, obj)
                   if mode == "wac1" else
                   emulate_fixpoint_level(t, lists, r, eps_table._BIG_CAP,
                                          obj))
            assert got[:2] == (want[0][r].tolist(), want[1][r].tolist()), r
            assert tuple(int(x) for x in got[2:]) == tuple(
                int(w[r]) for w in want[2:]), (seed, r)
            seen["bot"] += bool(want[8][r])
            seen["ent"] += bool(want[9][r])
            seen["found"] += bool(want[10][r])
    assert seen["bot"] and seen["found"], seen


@pytest.mark.parametrize("seed", [-1, 0, 1, 2, 3])
def test_fixed_and_transposed_entries_match_plain(seed):
    """K1's two other entries: exactly n sweeps (no exit on convergence
    or bot, iters = n), and the fixpoint on the columns of (V, D) planes,
    where dive d's element v lies at [v * D + d]."""
    s, lb, ub, _ = _case(seed)
    t = flat_tables(s)
    D, V = lb.shape
    for n in (1, 3):
        pl, pu, pi, pm = s.kernels.fixed_sweeps_plain(lb, ub, n)
        for d in range(D):
            el, eu, ei, em = emulate_fixpoint(t, lb[d].tolist(),
                                              ub[d].tolist(), n, fixed=True)
            assert el == pl[d].tolist() and eu == pu[d].tolist(), (n, d)
            assert (ei, em) == (int(pi[d]), bool(pm[d])) == (n, False)
    lbT, ubT = lb.t().contiguous(), ub.t().contiguous()
    fl, fu = lbT.reshape(-1).tolist(), ubT.reshape(-1).tolist()
    for cap in (10000, 2):
        pl, pu, pi, pm = s.kernels.fixpoint_t_plain(lbT, ubT, cap)
        assert pl.shape == (V, D)
        for d in range(D):
            el, eu, ei, em = emulate_fixpoint(t, fl[d::D], fu[d::D], cap)
            assert el == pl[:, d].tolist() and eu == pu[:, d].tolist()
            assert (ei, em) == (int(pi[d]), bool(pm[d])), (cap, d)


def slot_var(t, s):
    """The variable whose candidate slot s holds, from the slot layout of
    solver/plan.py (None: the neutral slot)."""
    P, E, M = t["P"], t["E"], t["M"]
    if s < 3 * P:
        return t[("px", "py", "pz")[s // P]][s % P]
    s -= 3 * P
    if s < 2 * E:
        return t[("e_idx", "e_res")[s // E]][s % E]
    s -= 2 * E
    if s < 2 * M:
        return t[("m_x", "m_b")[s // M]][s % M]
    s -= 2 * M
    n_terms = t["base_linb"] - t["base_lin"]
    if s < n_terms:
        return t["l_var"][s]
    s -= n_terms
    return t["l_b"][s] if s < t["L"] else None


@pytest.mark.parametrize("case", ["golomb6", 0, 5, 7, 10])
def test_slot_targets_invert_routing(case):
    """K1's ``slot_tgt`` is the exact inverse of the incidence CSR and the
    conflict fold: every slot of inc[v] maps to v, every conflict slot to
    its entry (whose value is its root-fixed variable's), every other
    slot is unread; and a sweep hands the meet every slot that is read."""
    if case == "golomb6":
        s = BatchedSolver(compile_model(parse_fzn_text(golomb(6))),
                          EngineConfig(num_dives=4, use_table=False,
                                       fp_cap_auto=False), device="cpu")
    else:
        s = _case(case)[0]
    t = flat_tables(s)
    V, n_active = t["V"], t["n_active"]
    tgt, val = t["slot_tgt"][0::2], t["slot_tgt"][1::2]
    assert len(tgt) == t["n_cand"]
    read = set()
    for v in range(n_active):
        for k in range(t["inc_off"][v], t["inc_off"][v + 1]):
            assert tgt[t["inc_slot"][k]] == v
            read.add(t["inc_slot"][k])
    for k, sl in enumerate(t["conf_slot"]):
        assert tgt[sl] == -2 - k and val[sl] == t["conf_off"][k]
        v = slot_var(t, sl)
        assert n_active <= v < V - 3
        assert t["conf_off"][k] == t["lb_floor"][v] + 1 == t["ub_cap"][v] - 1
        read.add(sl)
    for sl in range(t["n_cand"]):
        if sl not in read:
            assert tgt[sl] == -1 and val[sl] == 0, sl
            v = slot_var(t, sl)
            assert v is None or v >= V - 3  # neutral, spill or dummies
        elif tgt[sl] >= 0:
            assert slot_var(t, sl) == tgt[sl] and val[sl] == 0
    lb0, ub0 = s.dp.lb0.tolist(), s.dp.ub0.tolist()
    seen = set()
    emulate_fixpoint(t, lb0, ub0, 1, seen=seen)
    assert read <= seen
    # K1's packed tables repeat the flat ones.
    assert t["tnf4"] == [v for p in range(t["P"]) for v in (
        t["prop_op"][p], t["px"][p], t["py"][p], t["pz"][p])]
    assert t["l_head"] == [v for r in range(t["L"]) for v in (
        t["l_flags"][r] | t["l_op"][r] << 2, t["l_toff"][r], t["l_K"][r],
        t["l_b"][r])]
    assert t["l_term"] == [v for c, x in zip(t["l_coef"], t["l_var"])
                           for v in (c, x)]


@pytest.mark.parametrize("seed", [-1, 0, 5, 7, 10, 12])
def test_skip_is_exact(seed):
    """Skipping the rules whose variables did not move gives, sweep by
    sweep, the same store, changed and bot as running every rule, and the
    same iters and unconv, at caps 2 and 10000 and under fixed sweeps
    (tolerance 0); both equal the plain version. The seeds cover TNF,
    element, membership and linear rows. The skip rests on each rule's
    candidates depending on its listed variables only: changing every
    other variable of a random store changes none of them."""
    s, lb, ub, _ = _case(seed)
    t = flat_tables(s)
    rng = np.random.default_rng(seed + 100)
    lb0, ub0 = s.dp.lb0.tolist(), s.dp.ub0.tolist()

    def narrowed():
        lo = [int(rng.integers(a, b + 1)) for a, b in zip(lb0, ub0)]
        return lo, [int(rng.integers(a, b + 1)) for a, b in zip(lo, ub0)]

    for vs, cands in rules(t):
        for _ in range(4):
            (al, au), (ol, ou) = narrowed(), narrowed()
            for v in vs:
                ol[v], ou[v] = al[v], au[v]
            assert cands(al, au) == cands(ol, ou), vs
    ran = {True: 0, False: 0}
    for cap, fixed in ((10000, False), (2, False), (5, True)):
        want = (s.kernels.fixed_sweeps_plain(lb, ub, cap) if fixed
                else s.kernels.fixpoint_plain(lb, ub, cap))
        for d in range(lb.shape[0]):
            res, traces = {}, {}
            for skip in (True, False):
                traces[skip] = []
                res[skip] = emulate_fixpoint(t, lb[d].tolist(),
                                             ub[d].tolist(), cap, fixed,
                                             skip, traces[skip])
                ran[skip] += sum(len(x[4]) for x in traces[skip])
            assert len(traces[True]) == len(traces[False])
            for a, b in zip(traces[True], traces[False]):
                assert a[:4] == b[:4], (cap, fixed, d)
            assert res[True] == res[False], (cap, fixed, d)
            assert res[True][:2] == (want[0][d].tolist(), want[1][d].tolist())
            assert res[True][2:] == (int(want[2][d]), bool(want[3][d]))
    assert ran[True] < ran[False]


@pytest.mark.parametrize("case", [-1, 0, 5, 7, 10, 12, "golomb8"])
def test_wac1_skip_is_exact(case):
    """K8's skip (passes whose bit of ``pend`` is clear, and rules that
    are not dirty: no variable moved since their pass last ran) gives,
    pass by pass, the
    same stores as running every rule of every pass (the TT_NO_SKIP
    build; a pass that moves nothing leaves no trace), and the same
    sweeps, unconv and bot, at outer caps 10000 and 2 and inner caps 16
    and 1 (tolerance 0); both equal the plain version, and the skip runs
    fewer rules. ``v_pass`` has each pass's bit on every variable its
    rules read, and the CSR ``v_roff`` / ``v_rule`` lists every rule that
    reads each variable."""
    s, lb, ub, _ = _wac1_case(case)
    t = flat_tables(s)
    vp = [x & 0xFFFFFFFF for x in t["v_pass"]]
    readers = [set() for _ in range(t["V"])]
    for k, r0, rules in wac1_passes(t):
        for j, (vs, _) in enumerate(rules):
            assert all(vp[v] >> min(k, 31) & 1 for v in vs), (k, vs)
            for v in vs:
                readers[v].add(r0 + j)
    for v in range(t["V"]):  # the CSR lists the rules that read v
        assert set(t["v_rule"][t["v_roff"][v]:t["v_roff"][v + 1]]) == \
            readers[v], v
    ran = {True: 0, False: 0}
    for cap in (10000, 2):
        for inner in (16, 1):
            want = s.kernels.fixpoint_wac1_plain(lb, ub, cap, inner)
            for d in range(lb.shape[0]):
                res, traces = {}, {}
                for skip in (True, False):
                    traces[skip], stats = [], {}
                    res[skip] = emulate_wac1(t, lb[d].tolist(),
                                             ub[d].tolist(), cap, inner,
                                             skip, traces[skip], stats)
                    ran[skip] += sum(x["ran"] for x in stats.values())
                assert traces[True] == traces[False], (cap, inner, d)
                assert res[True] == res[False], (cap, inner, d)
                assert res[True][:2] == (want[0][d].tolist(),
                                         want[1][d].tolist())
                assert res[True][2:] == (int(want[2][d]), bool(want[3][d]))
    assert ran[True] < ran[False]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [-1, 0, 1])
def test_cuda_wac1_fixed_transposed_match_plain(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from turbo_tpu_torch import kernels
    s, lb, ub, _ = _case(seed)
    dev = torch.device("cuda:0")
    sc = BatchedSolver(s.tnf, s.cfg, device=dev)
    kp, pk = sc.kernels.kernel_plan, sc.kernels
    glb, gub = lb.to(dev), ub.to(dev)
    for smem in (True, False):
        for cap in (10000, 2):
            for inner in (16, 1):
                for g, w in zip(kernels.wac1(kp, glb, gub, cap, inner,
                                             smem=smem),
                                pk.fixpoint_wac1_plain(glb, gub, cap, inner)):
                    assert torch.equal(g, w)
            gT, uT = glb.t().contiguous(), gub.t().contiguous()
            for g, w in zip(kernels.fixpoint.transposed(kp, gT, uT, cap,
                                                        smem=smem),
                            pk.fixpoint_t_plain(gT, uT, cap)):
                assert torch.equal(g, w)
        for g, w in zip(kernels.fixpoint.fixed_sweeps(kp, glb, gub, 3,
                                                      smem=smem),
                        pk.fixed_sweeps_plain(glb, gub, 3)):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [-1, 0, 1, "golomb8", "golomb12"])
def test_cuda_wac1_step_matches_plain(case):
    """K8 and its step entry against ``fixpoint_wac1_plain``, then
    ``classify_plain`` and ``_select_plain`` on its result, every output
    exactly, on the shared- and the global-memory path at outer caps
    10000 and 2 and inner caps 16 and 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from turbo_tpu_torch import kernels
    s, lb, ub, strat = _fused_case(case) if isinstance(case, str) else \
        _case(case)
    dev = torch.device("cuda:0")
    sc = BatchedSolver(s.tnf, s.cfg, device=dev)
    kp, pk = sc.kernels.kernel_plan, sc.kernels
    glb, gub, gst = lb.to(dev), ub.to(dev), strat.to(dev)
    for smem in (True, False):
        for cap in (10000, 2):
            for inner in (16, 1):
                want = pk.fixpoint_wac1_plain(glb, gub, cap, inner)
                for g, w in zip(kernels.wac1(kp, glb, gub, cap, inner,
                                             smem=smem), want):
                    assert torch.equal(g, w), (smem, cap, inner)
                want += pk.classify_plain(*want[:2])
                want += sc._select_plain(*want[:2], gst)
                got = kernels.wac1.step(kp, glb, gub, cap, inner, gst,
                                        smem=smem)
                assert len(got) == len(want) == 14
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (smem, cap, inner)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [-1, 0, 1])
def test_cuda_kernels_match_plain(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from turbo_tpu_torch import kernels
    s, lb, ub, strat = _case(seed)
    dev = torch.device("cuda:0")
    sc = BatchedSolver(s.tnf, s.cfg, device=dev)
    glb, gub, gst = lb.to(dev), ub.to(dev), strat.to(dev)
    for cap in (10000, 2):
        got = kernels.fixpoint(sc.kernels.kernel_plan, glb, gub, cap)
        want = sc.kernels.fixpoint_plain(glb, gub, cap)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for g, w in zip(kernels.classify(sc.kernels.kernel_plan, glb, gub),
                    sc.kernels.classify_plain(glb, gub)):
        assert torch.equal(g, w)
    for g, w in zip(kernels.select(sc.kernels.kernel_plan, glb, gub, gst),
                    sc._select_plain(glb, gub, gst)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [-1, 0, 1, "golomb8"])
def test_cuda_fixpoint_step_matches_plain(case):
    """K1's step entry against ``fixpoint_plain``, then ``classify_plain``
    and ``_select_plain`` on its result, every output exactly, on the
    shared- and the global-memory path at caps 10000 and 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from turbo_tpu_torch import kernels
    s, lb, ub, strat = _fused_case(case)
    dev = torch.device("cuda:0")
    sc = BatchedSolver(s.tnf, s.cfg, device=dev)
    kp, pk = sc.kernels.kernel_plan, sc.kernels
    glb, gub, gst = lb.to(dev), ub.to(dev), strat.to(dev)
    for smem in (True, False):
        for cap in (10000, 2):
            want = pk.fixpoint_plain(glb, gub, cap)
            want += pk.classify_plain(*want[:2])
            want += sc._select_plain(*want[:2], gst)
            got = kernels.fixpoint.step(kp, glb, gub, cap, gst, smem=smem)
            assert len(got) == len(want) == 14
            for g, w in zip(got, want):
                assert torch.equal(g, w), (smem, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [-1, 0, 1])
def test_cuda_engine_matches_cpu_engine(seed):
    """The engine on the card (kernels) walks the same tree as on the CPU
    (plain versions): equal state after 30 steps, equal statistics.
    Steal and resplit are gated by the wall clock, so both are off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from turbo_tpu_torch.solver.convert import search_state_to_numpy
    s, _, _, _ = _case(seed)
    s = BatchedSolver(s.tnf, s.cfg, device="cpu")
    sc = BatchedSolver(s.tnf, s.cfg, device="cuda:0")
    for solver in (s, sc):
        solver._steal_open_branches = lambda *a, **k: None
        solver._tail_resplit = lambda *a, **k: None
    a, _ = s.run_steps(s.init_state(), 30)
    b, _ = sc.run_steps(sc.init_state(), 30)
    want, got = search_state_to_numpy(a), search_state_to_numpy(b)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ra, rb = s.solve(), sc.solve()
    for k in ("status", "objective", "nodes", "fails", "solutions",
              "fixpoint_iterations", "depth_max"):
        assert getattr(rb, k) == getattr(ra, k), k


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_embed_refill_open_count_match_plain(seed):
    """The table level entries of K1 and K8 (K4's parent gather in their
    prologue; both memory paths, V a multiple of 4 and not), K4's table
    refill and K5 against their plain versions on the same CUDA tensors,
    exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.solver.engine import (open_branch_count_plain,
                                               table_refill_plain)
    from turbo_tpu_torch.solver.eps_table import _BIG_CAP, dive_level_plain
    dev = torch.device("cuda:0")
    for case in ("golomb6", "golomb6_odd"):
        for mode in ("fixpoint", "wac1"):
            s = level_solver(case, mode, device=dev)
            kp = s.kernels.kernel_plan
            chunk = tuple(torch.as_tensor(a, device=dev)
                          for a in level_chunk(s, seed))
            want = dive_level_plain(s, *chunk)
            k = kernels.wac1 if mode == "wac1" else kernels.fixpoint
            caps = (_BIG_CAP, s.cfg.wac1_inner_cap) if mode == "wac1" \
                else (_BIG_CAP,)
            for smem in (True, False):
                got = k.level(kp, chunk, s.dp.obj, *caps, smem=smem)
                assert len(got) == len(want) == 13
                for i, (a, b) in enumerate(zip(got, want)):
                    assert torch.equal(a, b), (case, mode, smem, i)
    g = torch.Generator().manual_seed(seed)
    W, V, n_pad, MAXD = 96, 300, 64, 500

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).to(dev)

    for v in (V, V + 1):  # 16-byte rows and not
        tab = (ri(-9, 9, n_pad, v), ri(-9, 9, n_pad, v))
        idx, refill = ri(-5, n_pad + 5, W), ri(0, 2, W) == 1
        planes = [ri(-9, 9, W, v) for _ in range(4)]
        mine = [p.clone() for p in planes]
        kernels.table_refill(*tab, idx, refill, *mine)
        table_refill_plain(*tab, idx, refill, *planes)
        for a, b in zip(mine, planes):
            assert torch.equal(a, b)
    dec_cur, depth, phase = ri(0, 2, W, MAXD), ri(0, MAXD + 1, W), ri(0, 3, W)
    assert int(kernels.open_count(dec_cur, depth, phase)) == int(
        open_branch_count_plain(dec_cur, depth, phase))


# -- K4's leaf entry (table_leaf.cu) -------------------------------------

def leaf_case(seed, V, n_chunks, kind):
    """Random last-level chunk stores, as numpy: ``n_chunks`` chunks of W
    rows, each (lb, ub, strat, var, c0l, c0u, c1l, c1u) with some
    neutral children, the live rows and unique bit-paths of each, and a
    shard range [base, limit) that cuts some children off. ``kind``:
    "padded" (n_pad above the live rows), "full" (n_pad equal to them)
    or "empty" (no live row). Returns (chunks, parents, base, limit, lb0,
    ub0, n_pad)."""
    rng = np.random.default_rng(seed)
    W = 40
    lb0 = rng.integers(-50, 0, V).astype(np.int32)
    ub0 = (lb0 + rng.integers(0, 100, V)).astype(np.int32)
    chunks, parents = [], []
    paths = rng.permutation(4 * W * n_chunks)
    for c in range(n_chunks):
        lb = (lb0 + rng.integers(0, 20, (W, V))).astype(np.int32)
        ub = (ub0 - rng.integers(0, 20, (W, V))).astype(np.int32)
        var = rng.integers(0, V, W).astype(np.int32)
        lo, hi = lb[np.arange(W), var], ub[np.arange(W), var]
        mid = lo + (hi - lo) // 2
        neutral = rng.random(W) < 0.2
        c0l, c1l = (np.where(neutral, NINF, x).astype(np.int32)
                    for x in (lo, mid + 1))
        c0u, c1u = (np.where(neutral, INF, x).astype(np.int32)
                    for x in (mid, hi))
        strat = rng.integers(0, 3, W).astype(np.int32)
        chunks.append((lb, ub, strat, var, c0l, c0u, c1l, c1u))
        n = 0 if kind == "empty" else int(rng.integers(W // 2, W + 1))
        rows = np.sort(rng.choice(W, n, replace=False)).astype(np.int64)
        parents.append((rows, paths[c * W:c * W + n].astype(np.int64)))
    top = 2 * len(paths)
    base = int(rng.integers(0, top // 4))
    limit = int(rng.integers(3 * top // 4, top + 1))
    live = sum(int(((2 * p + b >= base) & (2 * p + b < limit)).sum())
               for _, p in parents for b in (0, 1))
    n_pad = live if kind == "full" else live + int(rng.integers(1, 50))
    return chunks, parents, base, limit, lb0, ub0, n_pad


def numpy_leaf(chunks, parents, base, limit, lb0, ub0, n_pad, eps_skip):
    """The leaf level as the numpy of ``turbo_tpu/solver/eps_table.py``
    (328-384) builds it on the host: each chunk's children embedded,
    concatenated, sorted by a stable argsort of the path, padded with
    root rows."""
    leaf_lb, leaf_ub, leaf_st, leaf_paths = [], [], [], []
    for ch, (rows, paths) in zip(chunks, parents):
        if not len(rows):
            continue
        lbh, ubh, sth, vrh, c0lh, c0uh, c1lh, c1uh = ch
        for bit in (0, 1):
            cps = paths * 2 + bit
            inr = (cps >= base) & (cps < limit)
            rs = rows[inr]
            if not len(rs):
                continue
            lbn = lbh[rs].copy()
            ubn = ubh[rs].copy()
            v = vrh[rs]
            cl = (c1lh if bit else c0lh)[rs]
            cu = (c1uh if bit else c0uh)[rs]
            ar = np.arange(len(rs))
            lbn[ar, v] = np.maximum(lbn[ar, v], cl)
            ubn[ar, v] = np.minimum(ubn[ar, v], cu)
            leaf_lb.append(lbn)
            leaf_ub.append(ubn)
            leaf_st.append(sth[rs])
            leaf_paths.append(cps[inr])
    V = len(lb0)
    if leaf_lb:
        tlb = np.concatenate(leaf_lb, axis=0).astype(np.int32)
        tub = np.concatenate(leaf_ub, axis=0).astype(np.int32)
        tst = np.maximum(np.concatenate(leaf_st), eps_skip).astype(np.int32)
        tpa = np.concatenate(leaf_paths).astype(np.int32)
        order = np.argsort(tpa, kind="stable")
        tlb, tub, tst, tpa = tlb[order], tub[order], tst[order], tpa[order]
    else:
        tlb = tub = np.zeros((0, V), dtype=np.int32)
        tst = tpa = np.zeros((0,), dtype=np.int32)
    pad = n_pad - len(tlb)
    return (np.concatenate([tlb, np.tile(lb0[None, :], (pad, 1))]),
            np.concatenate([tub, np.tile(ub0[None, :], (pad, 1))]),
            np.concatenate([tst, np.zeros(pad, dtype=np.int32)]),
            np.concatenate([tpa, np.zeros(pad, dtype=np.int32)]))


LEAF_CASES = [(seed, V, n_chunks, kind, eps_skip)
              for seed, (V, n_chunks, kind, eps_skip) in enumerate([
                  (64, 3, "padded", 0), (37, 2, "padded", 1),
                  (64, 1, "full", 1), (38, 3, "full", 0),
                  (64, 2, "empty", 0), (37, 1, "empty", 1)])]


@pytest.mark.parametrize("seed,V,n_chunks,kind,eps_skip", LEAF_CASES)
def test_table_leaf_plain_matches_the_numpy_leaf(seed, V, n_chunks, kind,
                                                 eps_skip):
    """``table_leaf_plain`` on the rows ``leaf_rows`` orders against the
    JAX package's numpy leaf level on the same chunks, exactly."""
    from turbo_tpu_torch.solver.eps_table import leaf_rows, table_leaf_plain
    chunks, parents, base, limit, lb0, ub0, n_pad = leaf_case(
        seed, V, n_chunks, kind)
    rows = leaf_rows(parents, base, limit)
    assert rows.dtype == np.int32 and rows.shape[1] == 4
    assert (len(rows) == 0) == (kind == "empty")
    assert (len(rows) == n_pad) == (kind == "full")
    got = table_leaf_plain([tuple(map(torch.as_tensor, ch)) for ch in chunks],
                           rows, torch.as_tensor(lb0), torch.as_tensor(ub0),
                           n_pad, eps_skip)
    want = numpy_leaf(chunks, parents, base, limit, lb0, ub0, n_pad,
                      eps_skip)
    for name, g, w in zip(("lb", "ub", "strat", "path"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,V,n_chunks,kind,eps_skip", LEAF_CASES)
def test_cuda_table_leaf_matches_plain(seed, V, n_chunks, kind, eps_skip):
    """K4's leaf entry against ``table_leaf_plain`` on the same CUDA
    chunks, byte for byte: 16-byte words (V % 4 == 0) and 4-byte ones,
    padding, no padding and no live row, one chunk and several."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.solver.eps_table import leaf_rows, table_leaf_plain
    dev = torch.device("cuda:0")
    chunks, parents, base, limit, lb0, ub0, n_pad = leaf_case(
        seed, V, n_chunks, kind)
    rows = leaf_rows(parents, base, limit)
    chunks = [tuple(torch.as_tensor(a, device=dev) for a in ch)
              for ch in chunks]
    lb0, ub0 = torch.as_tensor(lb0, device=dev), torch.as_tensor(ub0,
                                                               device=dev)
    n0 = kernels.table_leaf.launches
    got = kernels.table_leaf(chunks, rows, lb0, ub0, n_pad, eps_skip)
    want = table_leaf_plain(chunks, rows, lb0, ub0, n_pad, eps_skip)
    torch.cuda.synchronize()
    assert kernels.table_leaf.launches == n0 + 1
    for name, g, w in zip(("lb", "ub", "strat", "path"), got, want):
        assert g.is_cuda and g.dtype == w.dtype == torch.int32, name
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("fp_mode", ["fixpoint", "wac1"])
def test_cuda_table_matches_cpu_table(fp_mode):
    """The EPS table built on the card (the level entries, then K4's leaf
    entry) against the CPU's build (the plain versions), every field
    exactly, on each shard of golomb(6) split three ways: ranges that
    start past 0, a last level in several chunks, padding rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from turbo_tpu_torch.solver.eps_table import SubTable
    tnf = compile_model(parse_fzn_text(golomb(6)))
    cfg = EngineConfig(num_dives=8, subproblems_power=6, max_depth=96,
                       fp_max_iters=10000, use_table=True, fp_cap_auto=False,
                       fp_mode=fp_mode)
    cpu = BatchedSolver(tnf, cfg, device="cpu", num_shards=3)
    card = BatchedSolver(tnf, cfg, device="cuda:0", num_shards=3)
    for shard in range(3):
        want, got = cpu.get_table(shard), card.get_table(shard)
        assert 0 < got.n_live < got.n_pad
        for f in SubTable.__dataclass_fields__:
            if f == "build_time":
                continue
            w, g = getattr(want, f), getattr(got, f)
            if isinstance(w, torch.Tensor):
                assert g.is_cuda and g.dtype == w.dtype, f
                assert torch.equal(g.cpu(), w), (shard, f)
            elif isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w, err_msg=f)
            else:
                assert g == w, (shard, f, g, w)


# -- K6 step.cu and K7 step_tail.cu, transliterated --------------------

DIVE, SOLVE, IDLE = 0, 1, 2


def shard_ranks(want, impr):
    """The shard scan's ranks as K6 post's last block computes them
    (csrc/step.cu ``shard_scan``): rounds of 256 lanes, per warp of 32 a
    ballot of each flag and popc(mask & lanemask_lt), per round a prefix
    over the 8 warps' popc totals, a carry from round to round. Returns
    the inclusive counts of want and impr in lane order."""
    n = len(want)
    inc_w, inc_i = np.zeros(n, np.int64), np.zeros(n, np.int64)
    carry_w = carry_i = 0
    for base in range(0, n, BLOCK):
        masks = []
        for w in range(BLOCK // WARP):
            mw = mi = 0
            for lane in range(WARP):
                i = base + w * WARP + lane
                if i < n:
                    mw |= int(bool(want[i])) << lane
                    mi |= int(bool(impr[i])) << lane
            masks.append((mw, mi))
        tot = [(bin(mw).count("1"), bin(mi).count("1")) for mw, mi in masks]
        for w, (mw, mi) in enumerate(masks):
            pre_w = carry_w + sum(t[0] for t in tot[:w])
            pre_i = carry_i + sum(t[1] for t in tot[:w])
            for lane in range(WARP):
                i = base + w * WARP + lane
                if i >= n:
                    continue
                lt = (1 << lane) - 1
                inc_w[i] = pre_w + bin(mw & lt).count("1") + ((mw >> lane) & 1)
                inc_i[i] = pre_i + bin(mi & lt).count("1") + ((mi >> lane) & 1)
        carry_w += sum(t[0] for t in tot)
        carry_i += sum(t[1] for t in tot)
    return inc_w, inc_i


@pytest.mark.parametrize("S", (1, 3))
@pytest.mark.parametrize("D", (45, 300, 777))
def test_shard_ranks_equal_cumsum(S, D):
    """The ballot/popc ranks and the warp-total prefix of the shard scan
    equal np.cumsum over each shard's lanes, for shard sizes that are
    not a multiple of 32 (one, two and four rounds of 256 lanes)."""
    rng = np.random.default_rng(1000 * S + D)
    for density in (0.05, 0.5, 0.95):
        want = rng.random(S * D) < density
        impr = rng.random(S * D) < density / 2
        for sh in range(S):
            sl = slice(sh * D, (sh + 1) * D)
            inc_w, inc_i = shard_ranks(want[sl], impr[sl])
            np.testing.assert_array_equal(inc_w, np.cumsum(want[sl]))
            np.testing.assert_array_equal(inc_i, np.cumsum(impr[sl]))


def emulate_lane_copy(s, f, scr, d):
    """``lane_copy`` of csrc/step.cuh for lane d: the refill row and the
    ring row after the step whose shard scan wrote ``scr``."""
    Ds, R = s.cfg.num_dives, s.cfg.sol_ring_size
    sh = d // Ds
    n_pad = f["tab_lb"].shape[0] // (len(f["phase"]) // Ds)
    lb, ub = f["lb"], f["ub"]
    want, hw, r = scr["want"][d], scr["havework"][d], scr["ridx"][d]
    if want:
        if hw and s.use_table:
            i = sh * n_pad + min(max(scr["newidx"][d], 0), n_pad - 1)
            lb[d] = f["root_lb"][d] = f["tab_lb"][i]
            ub[d] = f["root_ub"][d] = f["tab_ub"][i]
            f["depth"][d], f["remaining"][d] = 0, 0
            f["strat"][d] = f["snap_strat"][d] = f["tab_strat"][i]
            f["subp"][d] = f["tab_path"][i]
        elif hw:
            lb[d], ub[d] = s.dp.lb0.numpy(), s.dp.ub0.numpy()
            f["depth"][d], f["strat"][d] = 0, 0
            f["remaining"][d] = f["kpow"][d]
            f["subp"][d] = scr["newidx"][d]
        f["phase"][d] = (SOLVE if s.use_table else DIVE) if hw else IDLE
    if r >= 0:
        f["sol_ring"][sh * R + r] = f["best_lb"][d]


def emulate_run(s, f, n, cap):
    """``solver/step_cuda.run`` over the numpy state ``f`` (updated in
    place): K7 live (the flag, the incumbent min ``bmin``), then per step
    K6 head (under the previous step's live word the previous step's
    refill and ring rows, then under this step's promote and the tighten
    from ``bmin``) -> K1-K3 (their plain versions) -> K6 post, each lane
    as one block of csrc/step.cu computes it, the shard scan once every
    lane of the shard has posted, and the last shard's live word and
    ``bmin``; then K7 copy of the last step's rows. A state of S * D
    lanes is S EPS shards: K6 runs over all S * D lanes, the scan per
    shard over the shard's lanes, table rows and ring rows. Returns the
    steps that ran."""
    dp, cfg = s.dp, s.cfg
    MAXD, R = cfg.max_depth, cfg.sol_ring_size
    enum, obj, is_opt = cfg.enumerate_all, dp.obj, dp.is_opt
    lb, ub = f["lb"], f["ub"]
    D = len(f["phase"])          # every lane of every shard
    Ds = cfg.num_dives           # the lanes of one shard
    S = D // Ds
    # K7 live.
    live = [int((f["phase"] != IDLE).any()), 0]
    bmin = int(f["best_bound"].min())
    steps, prev = 0, None
    scr = {}                     # the post's flags and the scan's output
    for i in range(n):
        cur = i % 2
        # K6 head: the previous step's rows, then promote and tighten.
        if prev is not None and live[prev]:
            for d in range(D):
                emulate_lane_copy(s, f, scr, d)
        prev = cur
        if not live[cur]:  # every kernel returns; post clears the next
            live[1 - cur] = 0
            continue
        g = min(bmin, int(f["ext_bound"][0]))
        strat0 = np.zeros(D, np.int32)
        for d in range(D):
            ph, st = int(f["phase"][d]), int(f["strat"][d])
            promote = ph == DIVE and f["remaining"][d] == 0
            if promote:
                ph = f["phase"][d] = SOLVE
            strat0[d] = max(st, int(f["eps_strat"][d])) if promote else st
            if is_opt and ph == SOLVE:
                lim = w32(min(g, int(f["best_bound"][d])) - 1)
                ub[d, obj] = min(int(ub[d, obj]), lim)
        # K1-K3, in place.
        tl, tu = torch.from_numpy(lb.copy()), torch.from_numpy(ub.copy())
        l2, u2, iters, unconv = s.kernels.fixpoint_plain(tl, tu, cap)
        lb[:], ub[:] = l2.numpy(), u2.numpy()
        bot, ent = (x.numpy() for x in s.kernels.classify_plain(l2, u2))
        found, var, nstrat, _, c0l, c0u, c1l, c1u = (
            x.numpy() for x in s._select_plain(l2, u2,
                                               torch.from_numpy(strat0)))
        iters, unconv = iters.numpy(), unconv.numpy()
        # K6 post, one lane (block) at a time.
        want, impr_v, dleaf_v, nxt_v = (np.zeros(D, np.int64)
                                        for _ in range(4))
        for d in range(D):
            ph = int(f["phase"][d])
            act, in_dive, in_solve = ph != IDLE, ph == DIVE, ph == SOLVE
            b = bool(bot[d])
            e = bool(ent[d]) and not b
            held = bool(unconv[d]) and not b and not e
            fnd = bool(found[d])
            rem, sp, dep = (int(f[k][d]) for k in ("remaining", "subp",
                                                   "depth"))
            if enum:
                leftmost = (sp & w32(w32(1 << rem) - 1)) == 0
                sol = e and not fnd and (leftmost if in_dive else True)
                leaf = b or (e and not fnd)
            else:
                sol, leaf = e, b or e
            objv = int(lb[d, obj]) if is_opt else 0
            if is_opt:
                better = objv < min(int(f["best_bound"][d]),
                                    int(f["ext_bound"][0]))
            else:
                better = enum or not f["has_best"][d]
            impr = act and sol and better
            no_split = act and not leaf and not fnd and not held
            any_unfixed = no_split and bool(
                (lb[d, :dp.n_active] < ub[d, :dp.n_active]).any())
            incomplete = no_split and any_unfixed
            waiting = no_split and not any_unfixed
            leaf = leaf or incomplete
            branching = act and not leaf and not waiting and not held
            dive_br = branching and in_dive
            solve_br = branching and in_solve
            ovf = solve_br and dep >= MAXD
            solve_br = solve_br and not ovf
            leaf = leaf or ovf
            snap = solve_br and dep == 0
            if impr:
                f["best_lb"][d], f["best_ub"][d] = lb[d], ub[d]
            if snap:
                f["root_lb"][d], f["root_ub"][d] = lb[d], ub[d]
            it = int(iters[d])
            f["nodes"][d] = w32(int(f["nodes"][d]) + (act and not held))
            f["fails"][d] = w32(int(f["fails"][d]) + (act and b))
            f["fpit"][d] = w32(int(f["fpit"][d]) + (it if act else 0))
            f["deds"][d] = f["deds"][d] + (np.float32(it) * f["pscale"][d]
                                           if act else np.float32(0))
            tree_depth = w32(dep + w32(int(f["kpow"][d]) - rem))
            f["dmax"][d] = max(int(f["dmax"][d]), tree_depth if act else 0)
            if impr:
                f["best_bound"][d] = objv
                f["has_best"][d] = True
            f["sols"][d] = w32(int(f["sols"][d]) + impr)
            f["nonexh"][d] = bool(f["nonexh"][d]) or incomplete or ovf
            bit = (sp >> max(rem - 1, 0)) & 1
            rem2 = rem - 1 if dive_br else rem
            f["remaining"][d] = rem2
            st0 = int(strat0[d])
            snap_strat = st0 if snap else int(f["snap_strat"][d])
            # The second round of loads: the parent's stack entry.
            par = min(max(dep - 1, 0), MAXD - 1)
            pcur, prope = int(f["dec_cur"][d, par]), int(f["dec_rope1"][d, par])
            dd = dep  # dep < MAXD when solve_br
            rope1 = (dep if pcur == 0 else prope) if dep > 0 else -1
            if solve_br:
                for k, v in (("dec_var", var[d]), ("dec_l0", c0l[d]),
                             ("dec_u0", c0u[d]), ("dec_l1", c1l[d]),
                             ("dec_u1", c1u[d]), ("dec_rope1", rope1),
                             ("dec_cur", 0)):
                    f[k][d, dd] = v
            dep1 = dep + 1 if solve_br else dep
            if dive_br or solve_br:
                v = int(var[d])
                right = dive_br and bit == 1
                lb[d, v] = max(int(lb[d, v]), int(c1l[d] if right else c0l[d]))
                ub[d, v] = min(int(ub[d, v]), int(c1u[d] if right else c0u[d]))
            # After a push the last entry is the new one (t = dep1),
            # else the parent's.
            bt = act and leaf and in_solve
            t = dep1 if solve_br or pcur == 0 else prope
            done_sub = bt and (dep1 == 0 or t == -1)
            restore = bt and dep1 > 0 and t != -1
            if restore:
                f["dec_cur"][d, min(max(t - 1, 0), MAXD - 1)] = 1
            strat = int(nstrat[d]) if branching else st0
            f["strat"][d] = snap_strat if restore else strat
            f["snap_strat"][d] = snap_strat
            f["depth"][d] = t if restore else dep1
            dleaf = act and leaf and in_dive
            nxt = w32(w32((sp >> rem2) + 1) << rem2)
            dleaf_left = dleaf and (sp & w32(w32(1 << rem2) - 1)) == 0
            f["skipped_sub"][d] = w32(int(f["skipped_sub"][d])
                                      + (w32(nxt - sp - 1) if dleaf_left
                                         else 0))
            f["solved_sub"][d] = w32(int(f["solved_sub"][d])
                                     + (done_sub or dleaf_left))
            want[d], impr_v[d], dleaf_v[d], nxt_v[d] = (
                dleaf or done_sub, impr, dleaf, nxt)
            if restore:  # atomicMax/atomicMin scatter over j < t
                lb[d], ub[d] = f["root_lb"][d], f["root_ub"][d]
                for j in range(t):
                    v = int(f["dec_var"][d, j])
                    c1 = j == t - 1 or f["dec_cur"][d, j] == 1
                    lb[d, v] = max(int(lb[d, v]),
                                   int(f["dec_l1" if c1 else "dec_l0"][d, j]))
                    ub[d, v] = min(int(ub[d, v]),
                                   int(f["dec_u1" if c1 else "dec_u0"][d, j]))
        # The shard scan, in the shard's last block to post; the last
        # shard publishes the live word and bmin.
        newidx, havework, ridx = [0] * D, [False] * D, [-1] * D
        any_live, shard_min = False, []
        for sh in range(S):
            ls = range(sh * Ds, (sh + 1) * Ds)
            l0 = sh * Ds
            m = max(int(nxt_v[d]) if dleaf_v[d] else 0 for d in ls)
            shard_min.append(int(f["best_bound"][l0:l0 + Ds].min()))
            ns = max(int(f["next_sub"][l0]), m)
            limit, w0 = int(f["sub_limit"][l0]), int(f["sol_w"][l0])
            inc_w, inc_i = shard_ranks(want[l0:l0 + Ds], impr_v[l0:l0 + Ds])
            total_w, total_i = int(inc_w[-1]), int(inc_i[-1])
            for d in ls:
                i = d - l0
                newidx[d] = w32(ns + (int(inc_w[i]) - 1 if want[d] else 0))
                havework[d] = bool(want[d]) and newidx[d] < limit
                if impr_v[d] and R > 0 and total_i - inc_i[i] < R:
                    ridx[d] = w32(w0 + int(inc_i[i]) - 1) % R
                # Live after the step: a lane that does not finish and
                # is not IDLE, or a refilled one.
                any_live |= bool(havework[d]) or (
                    not want[d] and int(f["phase"][d]) != IDLE)
            f["next_sub"][l0:l0 + Ds] = min(w32(ns + total_w), limit)
            if R > 0:
                f["sol_w"][l0:l0 + Ds] = [w32(int(f["sol_w"][d]) + total_i)
                                          for d in ls]
        live[1 - cur] = int(any_live)
        bmin = min(shard_min)
        steps += 1
        scr = dict(want=want, havework=havework, newidx=newidx, ridx=ridx)
    # K7 copy: the last step's rows.
    if prev is not None and live[prev]:
        for d in range(D):
            emulate_lane_copy(s, f, scr, d)
    return steps


STEP_CASES = {
    # name: (model, EngineConfig keywords); D = 6 lanes, 2^k subproblems
    "golomb6_table_ring": (lambda: golomb(6),
                           dict(use_table=True, sol_ring_size=8,
                                subproblems_power=3)),
    "golomb6_table_off_ring": (lambda: golomb(6),
                               dict(use_table=False, sol_ring_size=4,
                                    subproblems_power=3)),
    "queens6_enumerate": (lambda: queens(6),
                          dict(enumerate_all=True, sol_ring_size=3,
                               subproblems_power=3)),
    "rand12_eps_table": (lambda: random_model(12, n_vars=9, n_cons=26),
                         dict(use_table=True, seed=4,
                              eps_var_order="first_fail",
                              subproblems_power=2)),
    "rand10_table_off": (lambda: random_model(10, n_vars=8, n_cons=22),
                         dict(use_table=False, subproblems_power=2)),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_step_kernel_emulation_matches_plain_step(name):
    """K6 and K7 as transliterated above equal ``step_plain`` field for
    field over 60 steps at cap 3 (so lanes are held too), including the
    steps after the batch went IDLE (the golomb(6) table case idles at
    step 56, the random models earlier)."""
    from turbo_tpu_torch.solver.convert import search_state_to_numpy
    text, kw = STEP_CASES[name]
    tnf = compile_model(parse_fzn_text(text()))
    s = BatchedSolver(tnf, EngineConfig(num_dives=6, max_depth=48,
                                        fp_cap_auto=False, **kw),
                      device="cpu")
    st = s.init_state()
    f = {k: v.copy() for k, v in search_state_to_numpy(st).items()}
    done = 0
    for n in (1, 7, 20, 32):
        st, ran = s.run_steps(st, n, 3)
        assert emulate_run(s, f, n, 3) == int(ran), (name, n)
        done += n
        want = search_state_to_numpy(st)
        for k in want:
            np.testing.assert_array_equal(f[k], want[k],
                                          err_msg=f"{name} {done}: {k}")
    assert int(f["nodes"].sum()) > 0 and done == 60


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_sharded_step_kernel_emulation_matches_plain_step(name):
    """The same over 3 EPS shards of 4 lanes (``parallel/mesh.py``'s
    global state): the scan per shard equals the segmented
    ``shard_scan_plain`` field for field over 60 steps at cap 3."""
    from turbo_tpu_torch.parallel.mesh import ShardedSolver
    from turbo_tpu_torch.solver.convert import search_state_to_numpy
    text, kw = STEP_CASES[name]
    tnf = compile_model(parse_fzn_text(text()))
    ms = ShardedSolver(tnf, EngineConfig(num_dives=4, max_depth=48,
                                         fp_cap_auto=False, **kw),
                       devices=["cpu"] * 3)
    s = ms.solver
    st = ms.init_state()
    assert st.phase.shape == (12,)
    f = {k: v.copy() for k, v in search_state_to_numpy(st).items()}
    done = 0
    for n in (1, 7, 20, 32):
        st, ran = s.run_steps(st, n, 3)
        assert emulate_run(s, f, n, 3) == int(ran), (name, n)
        done += n
        want = search_state_to_numpy(st)
        for k in want:
            np.testing.assert_array_equal(f[k], want[k],
                                          err_msg=f"{name} {done}: {k}")
    assert int(f["nodes"].sum()) > 0 and done == 60


@pytest.mark.parametrize("mode", ("fixpoint", "wac1"))
@pytest.mark.parametrize("n", (1, 2, 16))
def test_chunk_launch_sequence(n, mode, monkeypatch):
    """``step_cuda._enqueue`` of a chunk of n steps makes 3n + 2 launches
    under the default ``fp_mode="fixpoint"``: K7 live, then per step K6
    head, K1's step entry (K2 and K3 in its blocks, writing the
    workspace's bot, ent and selection from strat0) and K6 post, then K7
    copy; under ``fp_mode="wac1"`` also 3n + 2, with K8's step entry in
    place of K1's. Each reads the right live word (step i reads word
    i % 2, its post writes the other, its head copies under the previous
    step's word, the first head copies nothing) on a CPU workspace with
    the wrappers replaced by recorders. The tickets of the shard scan
    are sized by the shards (3 + S words, the min accumulator at
    INT_MAX)."""
    from types import SimpleNamespace

    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.parallel.mesh import ShardedSolver
    from turbo_tpu_torch.solver import step_cuda
    tnf = compile_model(parse_fzn_text(golomb(5)))
    ms = ShardedSolver(tnf, EngineConfig(num_dives=4, fp_cap_auto=False,
                                         fp_mode=mode),
                       devices=["cpu"] * 3)
    s = ms.solver
    st = ms.init_state()
    s.kernels._kernel_plan = SimpleNamespace(smem_limit=48 * 1024)
    calls = []

    def rec(name, *words):
        calls.append((name,) + words)

    def step_out(lb, ub, strat, out):
        ws = s._ws
        assert lb is st.lb and ub is st.ub and strat is ws.strat0
        assert all(a is b for a, b in zip(
            out, (st.lb, st.ub, ws.iters, ws.unconv, ws.fp_scratch,
                  ws.bot, ws.ent) + ws.sel)) and len(out) == 15

    class K1:
        def scratch(self, kp, D):
            return None

        def step(self, kp, lb, ub, cap, strat, live, out):
            step_out(lb, ub, strat, out)
            rec("fixpoint.step", live)

    class K8(K1):
        def step(self, kp, lb, ub, cap, inner, strat, live, out):
            assert inner == s.cfg.wac1_inner_cap
            step_out(lb, ub, strat, out)
            rec("wac1.step", live)

    monkeypatch.setattr(kernels, "fixpoint", K1())
    monkeypatch.setattr(kernels, "wac1", K8())
    ws = s._ws = step_cuda.Workspace(s, st.phase.shape[0])
    assert ws.tail_sync.tolist() == [0, 0, 2 ** 31 - 1, 0, 0, 0]
    monkeypatch.setattr(kernels.step_tail, "live",
                        lambda sv, live, dev: rec("live", live))
    monkeypatch.setattr(kernels.step_tail, "copy",
                        lambda sv, live, dev: rec("copy", live))
    monkeypatch.setattr(kernels.step, "head",
                        lambda sv, prev, live, dev: rec("head", prev, live))
    monkeypatch.setattr(kernels.step, "post",
                        lambda sv, live, nxt, dev, smem: rec("post", live,
                                                             nxt))
    monkeypatch.setattr(kernels, "classify",
                        lambda kp, lb, ub, live, out: rec("classify", live))
    monkeypatch.setattr(kernels, "select",
                        lambda kp, lb, ub, strat, live, out: rec("select",
                                                                 live))
    step_cuda._enqueue(s, st, None, n, 16)
    w = ws.live
    middle = ("fixpoint.step",) if mode == "fixpoint" else ("wac1.step",)
    want = [("live", w[0])]
    for i in range(n):
        cur, nxt = w[i % 2], w[1 - i % 2]
        want += ([("head", w[1 - i % 2] if i else None, cur)]
                 + [(m, cur) for m in middle] + [("post", cur, nxt)])
    want.append(("copy", w[(n - 1) % 2]))
    assert len(calls) == 3 * n + 2
    assert [c[0] for c in calls] == [c[0] for c in want]
    for got, exp in zip(calls, want):
        assert all(a is b for a, b in zip(got[1:], exp[1:])), (got, exp)


# -- K5 open_count.cu and K9 steal.cu, transliterated ------------------

INT_MIN = -(1 << 31)
STACKS = ("dec_var", "dec_l0", "dec_u0", "dec_l1", "dec_u1", "dec_rope1",
          "dec_cur")


def block_scan(xs, op):
    """csrc/steal.cuh ``block_scan`` over one round of BLOCK values (op:
    ``operator.add`` or ``max``): a shuffle scan per warp (offsets 1 to
    16, every lane reading the others' values before the round), then
    the earlier warps' totals. Returns (inclusive scan, total)."""
    import operator
    assert len(xs) == BLOCK
    ident = 0 if op is operator.add else INT_MIN
    v = list(xs)
    for o in (1, 2, 4, 8, 16):
        v = [op(v[i], v[i - o]) if i % WARP >= o else v[i]
             for i in range(BLOCK)]
    tots = [v[w * WARP + WARP - 1] for w in range(BLOCK // WARP)]
    out = []
    for i in range(BLOCK):
        pre = ident
        for k in range(i // WARP):
            pre = op(pre, tots[k])
        out.append(op(pre, v[i]))
    total = ident
    for t in tots:
        total = op(total, t)
    return out, total


def emulate_open_count(dec_cur, depth, phase):
    """K5 (csrc/open_count.cu) over numpy stacks: the SOLVE blocks (each
    reads its live prefix 1024 words a round and adds each open entry to
    the histogram while fewer than n_idle of its lane came before), then
    the last block's ranking. Returns (count, plan): plan has n, thief,
    d0, victim, next (by rank), head (by lane) and vict (the victims in
    the order the last block lists them). Checks that the histogram and
    the ``last`` links are left reset."""
    import operator
    add = operator.add
    D, MAXD = dec_cur.shape
    hist = np.zeros(MAXD, np.int64)
    count = top_all = 0
    n_idle = int((phase == IDLE).sum())
    for d in range(D):
        if phase[d] != SOLVE:
            continue
        dep = min(int(depth[d]), MAXD)
        seen = top = 0
        for b in range(0, dep, 4 * BLOCK):
            take = seen < n_idle
            ns = []
            for th in range(BLOCK):
                j = b + 4 * th
                n = 0
                for k in range(4):
                    if j + k < dep and dec_cur[d, j + k] == 0:
                        n += 1
                        if take:
                            hist[j + k] += 1
                ns.append(n)
            tot = block_scan(ns, add)[1]
            if take and tot:
                top = min(b + 4 * BLOCK, dep)
            seen += tot
        count += seen
        top_all = max(top_all, top)
    n = min(count, n_idle)
    thief, d0, victim, nxt = (np.full(D, -7) for _ in range(4))
    head, last = np.full(D, -7), np.full(D, -1)
    vict = []
    c = 0
    for b in range(0, D, BLOCK):
        if c >= n:
            break
        f = [int(i < D and phase[i] == IDLE) for i in range(b, b + BLOCK)]
        inc, tot = block_scan(f, add)
        for th in range(BLOCK):
            r = c + inc[th] - f[th]
            if f[th] and r < n:
                thief[r] = b + th
        c += tot
    base = 0
    for jb in range(0, top_all, BLOCK):
        if base >= n:
            break
        h = [int(hist[j]) if j < top_all else 0
             for j in range(jb, jb + BLOCK)]
        inc, tot = block_scan(h, add)
        bs = [base + inc[k] - h[k] for k in range(BLOCK)]
        base += tot
        for k in range(BLOCK):
            if jb + k >= top_all or bs[k] >= n:
                break
            if h[k] == 0:
                continue
            jj, c = jb + k, bs[k]
            for vb in range(0, D, BLOCK):
                if c >= n:
                    break
                f = [int(v < D and phase[v] == SOLVE and jj < depth[v]
                         and dec_cur[v, jj] == 0)
                     for v in range(vb, vb + BLOCK)]
                inc2, tot2 = block_scan(f, add)
                for th in range(BLOCK):
                    r = c + inc2[th] - f[th]
                    if f[th] and r < n:
                        v = vb + th
                        d0[r], victim[r], nxt[r] = jj, v, -1
                        if last[v] < 0:
                            head[v] = r
                            vict.append(v)
                        else:
                            nxt[last[v]] = r
                        last[v] = r
                c += tot2
    hist[:top_all] = 0
    for v in vict:
        last[v] = -1
    assert not hist.any() and (last == -1).all()
    return count, dict(n=n, thief=thief[:n], d0=d0[:n], victim=victim[:n],
                       next=nxt[:n], head=head, vict=vict)


def emulate_steal(f, plan):
    """K9 (csrc/steal.cu) over the numpy state ``f``, in place: a block
    per victim, its steals in link order (increasing d0), the rope chain
    by block max-scans 256 depths a round, the thief's store as the root
    row met with atomicMax/atomicMin."""
    for v in plan["vict"]:
        dep = int(f["depth"][v])
        r = plan["head"][v]
        while r >= 0:
            t, d0 = plan["thief"][r], plan["d0"][r]
            f["dec_cur"][v, d0] = 1
            carry = int(f["dec_rope1"][v, d0])
            for b in range(d0 + 1, dep, BLOCK):
                js = range(b, b + BLOCK)
                x = [j if j < dep and f["dec_cur"][v, j - 1] == 0 else -1
                     for j in js]
                m, tot = block_scan(x, max)
                for th, j in enumerate(js):
                    if j < dep:
                        f["dec_rope1"][v, j] = m[th] if m[th] >= 0 else carry
                if tot >= 0:
                    carry = tot
            for s in STACKS:
                f[s][t, :d0 + 1] = f[s][v, :d0 + 1]
            f["dec_cur"][t, d0] = 1
            f["dec_rope1"][t, d0] = -1
            f["dec_l1"][v, d0] = f["dec_l0"][v, d0]
            f["dec_u1"][v, d0] = f["dec_u0"][v, d0]
            f["depth"][t] = d0 + 1
            f["phase"][t] = SOLVE
            f["remaining"][t] = 0
            for k in ("subp", "kpow"):
                f[k][t] = f[k][v]
            f["strat"][t] = f["snap_strat"][t] = f["snap_strat"][v]
            for k in ("lb", "root_lb"):
                f[k][t] = f["root_lb"][v]
            for k in ("ub", "root_ub"):
                f[k][t] = f["root_ub"][v]
            for j in range(d0 + 1):
                x = f["dec_var"][t, j]
                right = j == d0 or f["dec_cur"][t, j] == 1
                f["lb"][t, x] = max(f["lb"][t, x],
                                    f["dec_l1" if right else "dec_l0"][t, j])
                f["ub"][t, x] = min(f["ub"][t, x],
                                    f["dec_u1" if right else "dec_u0"][t, j])
            r = plan["next"][r]


def steal_rounds_agree(f, label):
    """The steal round on the numpy state ``f`` (the fields of
    ``engine.STEAL_FIELDS``) four ways, every field exactly equal:
    ``steal_host`` (the specification, held to JAX), K5 and K9 as
    transliterated, and the plain torch versions (``steal_plan_plain``,
    ``steal_apply_plain``); the three plans equal the host's order.
    Returns the number of steals."""
    from types import SimpleNamespace

    from turbo_tpu_torch.solver.engine import (steal_apply_plain, steal_host,
                                               steal_plan_plain)
    idle = np.nonzero(f["phase"] == IDLE)[0]
    host = {k: v.copy() for k, v in f.items()}
    n = steal_host(host, idle)
    count, plan = emulate_open_count(f["dec_cur"], f["depth"], f["phase"])
    assert plan["n"] == n == min(count, len(idle)), label
    assert count == int(((f["dec_cur"] == 0) & (f["phase"] == SOLVE)[:, None]
                         & (np.arange(f["dec_cur"].shape[1])[None, :]
                            < f["depth"][:, None])).sum()), label
    emu = {k: v.copy() for k, v in f.items()}
    emulate_steal(emu, plan)
    t = {k: torch.from_numpy(v.copy()) for k, v in f.items()}
    cnt, thief, d0, victim = steal_plan_plain(t["dec_cur"], t["depth"],
                                              t["phase"])
    assert int(cnt) == count, label
    for a, b in ((thief, plan["thief"]), (d0, plan["d0"]),
                 (victim, plan["victim"])):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=label)
    steal_apply_plain(SimpleNamespace(**t), thief, d0, victim)
    for k in f:
        np.testing.assert_array_equal(emu[k], host[k], err_msg=f"{label}: {k}")
        np.testing.assert_array_equal(t[k].numpy(), host[k],
                                      err_msg=f"{label}: plain {k}")
    return n


def synthetic_steal_state(rng, D, MAXD, V, lanes):
    """Random numpy stacks, stores and scalars of D lanes; ``lanes``:
    (lane, phase, depth, share of open entries) for each lane that is
    not IDLE (the others are IDLE with random depth)."""
    i32 = lambda a: np.asarray(a, np.int32)
    f = dict(
        phase=i32(np.full(D, IDLE)), depth=i32(rng.integers(0, MAXD + 1, D)),
        subp=i32(rng.integers(0, 99, D)), kpow=i32(rng.integers(1, 9, D)),
        remaining=i32(rng.integers(0, 5, D)),
        strat=i32(rng.integers(0, 3, D)), snap_strat=i32(rng.integers(0, 3, D)),
        dec_var=i32(rng.integers(0, V, (D, MAXD))),
        dec_cur=i32(rng.integers(0, 2, (D, MAXD))),
        dec_rope1=i32(rng.integers(-1, MAXD, (D, MAXD))))
    for k in ("dec_l0", "dec_l1"):
        f[k] = i32(rng.integers(-20, 10, (D, MAXD)))
    for k in ("dec_u0", "dec_u1"):
        f[k] = i32(rng.integers(-10, 20, (D, MAXD)))
    for k in ("lb", "root_lb"):
        f[k] = i32(rng.integers(-30, 0, (D, V)))
    for k in ("ub", "root_ub"):
        f[k] = i32(rng.integers(0, 30, (D, V)))
    for v, ph, dep, share in lanes:
        f["phase"][v], f["depth"][v] = ph, dep
        f["dec_cur"][v] = rng.random(MAXD) >= share
    return f


def _steal_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "one_victim":  # five steals from one stack, in depth order
        return synthetic_steal_state(rng, 12, 40, 9,
                                     [(3, SOLVE, 30, 0.4), (7, DIVE, 20, 1)])
    if name == "more_idle":  # 37 idle lanes, a handful of open entries
        lanes = [(v, SOLVE, 6, 0.3) for v in range(0, 40, 9)]
        return synthetic_steal_state(rng, 42, 8, 7, lanes)
    if name == "fewer_idle":  # 3 idle lanes, many open entries
        lanes = [(v, SOLVE, 25, 0.5) for v in range(20) if v % 7]
        lanes += [(v, DIVE, 25, 0.5) for v in range(20) if v % 7 == 0 and v]
        return synthetic_steal_state(rng, 20, 30, 11, lanes)
    if name == "same_depth":  # victims open at the same depths
        f = synthetic_steal_state(rng, 10, 16, 5,
                                  [(2, SOLVE, 12, 0.0), (5, SOLVE, 14, 0.0),
                                   (8, SOLVE, 9, 0.0)])
        f["dec_cur"][[2, 5, 8], :] = 1
        f["dec_cur"][[2, 5, 8], 3] = 0
        f["dec_cur"][[2, 5], 7] = 0
        return f
    if name == "depth_maxd":  # a victim as deep as the stacks
        return synthetic_steal_state(rng, 9, 24, 6,
                                     [(1, SOLVE, 24, 0.3), (6, SOLVE, 24, 0.1)])
    if name == "wide":  # 300 lanes (two rounds of 256), 2000-deep stacks:
        # lanes with more open entries than idle lanes stop adding to the
        # histogram after their first 1024 words.
        lanes = [(v, SOLVE, int(rng.integers(1, 2001)), 0.5)
                 for v in range(300) if v % 10]
        return synthetic_steal_state(rng, 300, 2000, 4, lanes)
    raise KeyError(name)


@pytest.mark.parametrize("name", ("one_victim", "more_idle", "fewer_idle",
                                  "same_depth", "depth_maxd", "wide"))
def test_steal_emulation_matches_host_steal(name):
    """K5's plan and K9's steals as transliterated, and the plain torch
    versions, equal the host steal on synthetic stacks: several steals
    from one victim (each later thief copies a prefix an earlier steal
    rewrote), more and fewer idle lanes than open entries, victims open
    at the same depths, a victim of depth MAXD, and 300 lanes with
    2000-deep stacks."""
    f = _steal_case(name)
    n = steal_rounds_agree(f, name)
    idle = int((f["phase"] == IDLE).sum())
    count = int(((f["dec_cur"] == 0) & (f["phase"] == SOLVE)[:, None]
                 & (np.arange(f["dec_cur"].shape[1])[None, :]
                    < f["depth"][:, None])).sum())
    assert n == min(idle, count) > 0
    if name == "one_victim":
        assert n >= 4
    if name == "more_idle":
        assert idle > count
    if name in ("fewer_idle", "wide"):
        assert idle < count


def test_block_scan_equals_cumsum_and_cummax():
    """The warp-shuffle block scan of csrc/steal.cuh equals np.cumsum and
    np.maximum.accumulate over one round of 256 values."""
    import operator
    rng = np.random.default_rng(5)
    for op, ref in ((operator.add, np.cumsum), (max, np.maximum.accumulate)):
        for _ in range(4):
            xs = [int(x) for x in rng.integers(-1, 40, BLOCK)]
            out, total = block_scan(xs, op)
            np.testing.assert_array_equal(out, ref(np.array(xs)))
            assert total == out[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("one_victim", "fewer_idle", "same_depth",
                                  "depth_maxd", "wide"))
def test_cuda_steal_round_matches_plain(name):
    """K5's count and plan and K9's steals on the card against the plain
    torch versions and the host steal, exactly (the synthetic stacks of
    ``test_steal_emulation_matches_host_steal``), twice on one plan
    workspace (K5 leaves its counters reset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from types import SimpleNamespace

    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.solver.engine import steal_host, steal_plan_plain
    f = _steal_case(name)
    host = {k: v.copy() for k, v in f.items()}
    n = steal_host(host, np.nonzero(f["phase"] == IDLE)[0])
    D, MAXD = f["dec_cur"].shape
    plan = kernels.StealPlan(D, MAXD, "cuda:0")
    for _ in range(2):
        st = SimpleNamespace(**{k: torch.from_numpy(v.copy()).cuda()
                                for k, v in f.items()})
        count = kernels.open_count(st.dec_cur, st.depth, st.phase, plan)
        want = steal_plan_plain(st.dec_cur, st.depth, st.phase)
        assert int(count) == int(want[0])
        for a, b in zip(plan.steals(), want[1:]):
            assert torch.equal(a, b)
        kernels.steal(st, plan, n)
        torch.cuda.synchronize()
        for k in f:
            np.testing.assert_array_equal(getattr(st, k).cpu().numpy(),
                                          host[k], err_msg=k)
