"""The CUDA kernels' tables and algorithm, checked on the CPU.

The kernels (turbo_tpu_torch/kernels/csrc/*.cu) cannot run here, so
this file transliterates them line for line into scalar Python over the
very tables the wrappers upload (``kernel_tables``): one dive at a time,
phase A then phase B per sweep, CSR combine, conflict fold, block
argmin. The emulation must equal the plain torch versions, which
``test_torch_propagate.py`` holds to the JAX package. The real kernels
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
from turbo_tpu_torch.instances import golomb, random_model
from turbo_tpu_torch.kernels import kernel_tables
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.engine import BatchedSolver

SUM_CLAMP = 1 << 40


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


def phase_a(t, lb, ub):
    P, E, M = t["P"], t["E"], t["M"]
    cl = [None] * t["n_cand"]
    cu = [None] * t["n_cand"]
    for p in range(P):
        x, y, z = int(t["px"][p]), int(t["py"][p]), int(t["pz"][p])
        c = deduce(int(t["prop_op"][p]), lb[x], ub[x], lb[y], ub[y], lb[z], ub[z])
        for r in range(3):
            cl[r * P + p], cu[r * P + p] = c[2 * r], c[2 * r + 1]
    T = t["T"]
    for i in range(E):
        n = int(t["e_len"][i])
        li, ui = lb[t["e_idx"][i]], ub[t["e_idx"][i]]
        lr, ur = lb[t["e_res"][i]], ub[t["e_res"][i]]
        ok = [j for j in range(T) if w32(li - 1) <= j <= w32(ui - 1) and j < n
              and lr <= t["e_tab"][i * T + j] <= ur]
        vals = [int(t["e_tab"][i * T + j]) for j in ok]
        cl[3 * P + i] = (min(ok) if ok else INF - 1) + 1
        cu[3 * P + i] = (max(ok) if ok else NINF - 1) + 1
        cl[3 * P + E + i] = min(vals, default=INF)
        cu[3 * P + E + i] = max(vals, default=NINF)
    W = t["W"]
    for i in range(M):
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
        cl[s] = clip(nge if tt else (nout if ff else NINF))
        cu[s] = clip(ple if tt else (pout if ff else INF))
        cl[s + M], cu[s + M] = int(c == width and width > 0), int(c > 0)
    for r in range(t["L"]):
        terms = lin_terms(t, r, lb, ub)
        smin = sum(a for _, a, _ in terms)
        smax = sum(b for _, _, b in terms)
        rhs, is_eq = int(t["l_rhs"][r]), t["l_op"][r] == 1
        s = t["base_linb"] + r
        cl[s] = int(smin == rhs == smax) if is_eq else int(smax <= rhs)
        cu[s] = int(smin <= rhs <= smax) if is_eq else int(smin <= rhs)
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
            s = t["base_lin"] + int(t["l_toff"][r]) + k
            cl[s], cu[s] = clip(lo), clip(hi)
    return cl, cu


def emulate_fixpoint(t, lb_row, ub_row, cap):
    lb, ub = [int(v) for v in lb_row], [int(v) for v in ub_row]
    V, it, iters, m = t["V"], 0, 0, True
    while m and it < cap:
        cl, cu = phase_a(t, lb, ub)
        conf = int(any(cl[s] > o or cu[s] < o
                       for s, o in zip(t["conf_slot"], t["conf_off"])))
        changed = bot = False
        for v in range(V):
            l, u = lb[v], ub[v]
            if v < t["n_active"]:
                for k in range(t["inc_off"][v], t["inc_off"][v + 1]):
                    s = t["inc_slot"][k]
                    l, u = max(l, cl[s]), min(u, cu[s])
            elif v == V - 1 and t["n_conf"] > 0:
                l = max(l, conf)
            l, u = min(l, int(t["ub_cap"][v])), max(u, int(t["lb_floor"][v]))
            changed |= l != lb[v] or u != ub[v]
            bot |= l > u
            lb[v], ub[v] = l, u
        iters += 1
        it += 1
        m = changed and not bot
    return lb, ub, iters + 1, m


def emulate_classify(t, lb, ub):
    lb, ub = [int(v) for v in lb], [int(v) for v in ub]
    bot = any(l > u for l, u in zip(lb, ub))
    ok = all(ask(int(t["prop_op"][p]), lb[t["px"][p]], ub[t["px"][p]],
                 lb[t["py"][p]], ub[t["py"][p]], lb[t["pz"][p]], ub[t["pz"][p]])
             for p in range(t["P"]))
    T = t["T"]
    for i in range(t["E"]):
        n = int(t["e_len"][i])
        li = min(max(lb[t["e_idx"][i]], 1), n)
        ui = min(max(ub[t["e_idx"][i]], 1), n)
        win = [int(t["e_tab"][i * T + j]) for j in range(T)
               if li - 1 <= j <= ui - 1 and j < n]
        lr, ur = lb[t["e_res"][i]], ub[t["e_res"][i]]
        ok &= lr == ur and min(win, default=INF) == lr and max(win, default=NINF) == lr
    for i in range(t["M"]):
        lx, ux = lb[t["m_x"][i]], ub[t["m_x"][i]]
        c, width = member_count(t, i, lx, ux), ux - lx + 1
        ok &= ((lb[t["m_b"][i]] >= 1 and c == width and width > 0)
               or (ub[t["m_b"][i]] <= 0 and c == 0))
    for r in range(t["L"]):
        terms = lin_terms(t, r, lb, ub)
        smin, smax = sum(a for _, a, _ in terms), sum(b for _, _, b in terms)
        rhs, is_eq = int(t["l_rhs"][r]), t["l_op"][r] == 1
        tt, ff = lb[t["l_b"][r]] >= 1, ub[t["l_b"][r]] <= 0
        ent_t = smin == rhs == smax if is_eq else smax <= rhs
        ent_f = (rhs < smin or rhs > smax) if is_eq else smin > rhs
        ok &= (tt and ent_t) or (ff and ent_f)
    return bot, bool(ok)


def emulate_select(t, lb, ub, strat):
    lb, ub = [int(v) for v in lb], [int(v) for v in ub]

    def argmin(s):
        b, e = t["s_off"][s], t["s_off"][s + 1]
        vo = t["s_vo"][s]
        best, found = None, False
        for i in range(e - b):
            v = int(t["s_ids"][b + i])
            l, u = lb[v], ub[v]
            ok = l < u and l > NINF and u < INF
            size = w32(u - l)
            key = [i, size, w32(-size), l][vo] if vo < 4 else w32(-u)
            k = (key if ok else 2 ** 31 - 1, i)
            best = k if best is None or k < best else best
            found |= ok
        return best, found

    found, chosen = False, 0
    for s in range(max(int(strat), 0), t["S"]):
        best, found = argmin(s)
        if found:
            chosen = s
            break
    if not found:
        best, _ = argmin(0)
    var = int(t["s_ids"][t["s_off"][chosen] + best[1]])
    valo = int(t["s_valo"][chosen])
    lo, hi = lb[var], ub[var]
    mid = w32(lo + (w32(hi - lo) >> 1))
    ch = {0: (lo, lo, w32(lo + 1), hi), 1: (hi, hi, lo, w32(hi - 1)),
          2: (lo, mid, w32(mid + 1), hi), 3: (w32(mid + 1), hi, lo, mid)}
    return (found, var, chosen, valo) + ch.get(valo, (0, 0, 0, 0))


def _case(seed):
    text = golomb(4) if seed < 0 else random_model(seed, n_vars=7, n_cons=18)
    tnf = compile_model(parse_fzn_text(text))
    s = BatchedSolver(tnf, EngineConfig(num_dives=12, subproblems_power=3,
                                        max_depth=64, use_table=False,
                                        fp_cap_auto=False))
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
@pytest.mark.parametrize("seed", [-1, 0, 1])
def test_cuda_engine_matches_cpu_engine(seed):
    """The engine on the card (kernels) walks the same tree as on the CPU
    (plain versions): equal state after 30 steps, equal statistics.
    Steal and resplit are gated by the wall clock, so both are off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from turbo_tpu_torch.solver.convert import search_state_to_numpy
    s, _, _, _ = _case(seed)
    s = BatchedSolver(s.tnf, s.cfg)
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
    """K4 (both entry points) and K5 against their plain versions on the
    same CUDA tensors, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from turbo_tpu_torch import kernels
    from turbo_tpu_torch.solver.engine import (open_branch_count_plain,
                                               table_refill_plain)
    from turbo_tpu_torch.solver.eps_table import embed_plain
    dev = torch.device("cuda:0")
    g = torch.Generator().manual_seed(seed)
    W, V, n_pad, MAXD = 96, 300, 64, 500

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).to(dev)

    args = (ri(-50, 50, W, V), ri(-50, 50, W, V), ri(0, 4, W), ri(0, V, W),
            ri(-60, 60, W), ri(-60, 60, W), ri(-60, 60, W), ri(-60, 60, W),
            ri(0, W, W), ri(0, 2, W))
    for a, b in zip(kernels.embed(*args), embed_plain(*args)):
        assert torch.equal(a, b)
    tab = (ri(-9, 9, n_pad, V), ri(-9, 9, n_pad, V))
    idx, refill = ri(-5, n_pad + 5, W), ri(0, 2, W) == 1
    planes = [ri(-9, 9, W, V) for _ in range(4)]
    mine = [p.clone() for p in planes]
    kernels.embed.refill(*tab, idx, refill, *mine)
    table_refill_plain(*tab, idx, refill, *planes)
    for a, b in zip(mine, planes):
        assert torch.equal(a, b)
    dec_cur, depth, phase = ri(0, 2, W, MAXD), ri(0, MAXD + 1, W), ri(0, 3, W)
    assert int(kernels.open_count(dec_cur, depth, phase)) == int(
        open_branch_count_plain(dec_cur, depth, phase))
