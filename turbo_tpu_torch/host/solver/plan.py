"""Host-side device plan: TNF -> static arrays for the batched TPU engine.

This plays the role of the reference's root preprocessing + memory
configuration (common_solving.hpp:520-585 root fixpoint / entailed-
constraint elimination, memory_gpu.hpp MemoryConfig):

* runs the root propagation fixpoint once on the host (numpy),
* drops propagators that are already entailed at the root,
* permutes variables so that (a) root-singleton variables (constants,
  fixed vars) sit at the tail and are excluded from the incidence
  structure, and (b) active variables are grouped into power-of-two
  degree buckets, giving the propagation kernel contiguous
  gather+reduce segments instead of scatters — the TPU-first
  replacement for the GPU's atomic scatter updates.

Shape canonicalization: every dimension that reaches the device
(variable count, per-op propagator counts, bucket rows/widths,
strategy list lengths) is padded to quantized sizes, and all seven op
groups always exist.  Combined with the engine keeping instance
scalars (objective id, subproblem power, ...) as traced data, the
compiled XLA program depends only on the quantized shape signature —
so one (slow) TPU compile is reused across instances and runs.

The propagation engine works entirely in permuted ids; results are
mapped back through ``inv_perm`` for output.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from ..core.ops import INF, NINF, NUM_OPS, OP_ADD
from ..compile.tnf import Strategy, Tnf
from . import deduce_np
from .oracle import PropTable


def quantize(n: int, min_gran: int = 32) -> int:
    """Smallest padded size >= n on a coarse grid (4 steps per octave,
    granularity >= min_gran). Keeps padding waste <= ~12.5% while
    collapsing nearby sizes onto shared compiled shapes."""
    if n <= min_gran:
        return min_gran
    gran = min_gran
    while gran * 8 < n:
        gran *= 2
    return ((n + gran - 1) // gran) * gran


@dataclasses.dataclass
class PlanStrategy:
    var_order: str
    val_order: str
    ids: np.ndarray  # (padded,) permuted var ids; padding -> dummy var


@dataclasses.dataclass
class Bucket:
    start: int            # first permuted var id in this bucket
    count: int            # padded row count
    cand_idx: np.ndarray  # (count, K) int32 indices into flat candidates


@dataclasses.dataclass
class Plan:
    V: int                # padded total vars
    n_active: int         # padded active region (bucket rows)
    P: int                # padded propagators (sum of padded groups)
    lb0: np.ndarray       # (V,) int32 root bounds after root fixpoint (permuted)
    ub0: np.ndarray
    groups: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]  # (op, xs, ys, zs)
    buckets: List[Bucket]
    obj: int              # permuted objective var id; dummy var if satisfaction
    is_opt: bool
    strategies: List[PlanStrategy]
    inv_perm: np.ndarray  # permuted id -> original tnf id (len = real V)
    perm: np.ndarray      # original tnf id -> permuted id
    root_unsat: bool
    root_entailed: bool
    num_real_props: int = 0
    # Useless-variable compaction (Simplifier parity,
    # common_solving.hpp:520-585 eliminate_useless_variables):
    # root-singleton vars referenced by no live propagator are dropped
    # from the device store entirely; `perm` maps them to the inert
    # spill slot and their values are restored host-side from the root.
    dropped: Optional[np.ndarray] = None   # (Vr,) bool
    fixed_lb: Optional[np.ndarray] = None  # (Vr,) root store (TNF ids)
    fixed_ub: Optional[np.ndarray] = None
    # Native element constraints (padded): values[idx-1] == res.
    e_idx: Optional[np.ndarray] = None   # (E,)
    e_res: Optional[np.ndarray] = None   # (E,)
    e_len: Optional[np.ndarray] = None   # (E,)
    e_tab: Optional[np.ndarray] = None   # (E, T)
    # Native membership constraints (padded): b = (x in S).
    m_x: Optional[np.ndarray] = None     # (M,)
    m_b: Optional[np.ndarray] = None
    m_base: Optional[np.ndarray] = None
    m_top: Optional[np.ndarray] = None
    m_cnt: Optional[np.ndarray] = None   # (M, W+1)
    m_next_ge: Optional[np.ndarray] = None  # (M, W)
    m_prev_le: Optional[np.ndarray] = None
    m_next_out: Optional[np.ndarray] = None
    m_prev_out: Optional[np.ndarray] = None
    # Native linear constraints, bucketed by term count: list of
    # (b (C,), op (C,), rhs (C,), coef (C,K), var (C,K)).
    lin_buckets: List[tuple] = dataclasses.field(default_factory=list)
    # Conflict fold for singleton-tail deduction targets: candidate
    # slots whose target var sits in the singleton tail (root-fixed,
    # outside the bucketed combine). A deduction (lo, hi) into a var
    # fixed at c is inconsistent iff lo > c or hi < c — equivalently
    # meet([0,0], [lo-c, hi-c]) is empty, so the sweep folds
    # max_i(lo_i - c_i) / min_i(hi_i - c_i) into the dummy column
    # (fixed [0,0]) and is_bot sees the conflict. Without this, a node
    # contradicting a root-fixed var never fails (livelock on
    # all-singleton non-entailed leaves, found by fuzzing round 3).
    conf_idx: Optional[np.ndarray] = None  # (T,) candidate slots
    conf_off: Optional[np.ndarray] = None  # (T,) fixed values c

    def store_to_tnf(self, row_lb: np.ndarray,
                     row_ub: Optional[np.ndarray] = None):
        """Map a permuted device-store row back to TNF variable ids,
        restoring dropped (store-compacted) variables from the root."""
        out_lb = np.asarray(row_lb)[self.perm].astype(np.int64)
        if self.dropped is not None and self.dropped.any():
            out_lb[self.dropped] = self.fixed_lb[self.dropped]
        if row_ub is None:
            return out_lb
        out_ub = np.asarray(row_ub)[self.perm].astype(np.int64)
        if self.dropped is not None and self.dropped.any():
            out_ub[self.dropped] = self.fixed_ub[self.dropped]
        return out_lb, out_ub

    @property
    def E(self):
        return 0 if self.e_idx is None else len(self.e_idx)

    @property
    def M(self):
        return 0 if self.m_x is None else len(self.m_x)

    @property
    def L(self):
        return sum(len(b[0]) for b in self.lin_buckets)

    @property
    def L_terms(self):
        return sum(b[3].shape[0] * b[3].shape[1] for b in self.lin_buckets)

    @property
    def data_digest(self) -> str:
        """Content hash of everything the jitted step bakes in as
        compile-time constants (linear coef/rhs tables, element/member
        tables, lb0/ub0 clamp bounds, seed-shuffled strategy id lists,
        bucket gather indices, objective id). Two plans with identical
        shape signatures but different data MUST compile to different
        executables — the disk-cache alias key includes this digest so
        a shape collision can never load the wrong program."""
        if getattr(self, "_data_digest", None) is None:
            import hashlib
            h = hashlib.sha256()
            def upd(a):
                a = np.ascontiguousarray(a)
                h.update(str(a.dtype).encode())
                h.update(str(a.shape).encode())
                h.update(a.tobytes())
            upd(self.lb0)
            upd(self.ub0)
            for op, xs, ys, zs in self.groups:
                h.update(bytes([op]))
                upd(xs); upd(ys); upd(zs)
            for b in self.buckets:
                h.update(repr((b.start, b.count)).encode())
                upd(b.cand_idx)
            for s in self.strategies:
                h.update(f"{s.var_order}/{s.val_order}".encode())
                upd(s.ids)
            h.update(repr((self.obj, self.is_opt)).encode())
            for a in (self.e_idx, self.e_res, self.e_len, self.e_tab,
                      self.m_x, self.m_b, self.m_base, self.m_top,
                      self.m_cnt, self.m_next_ge, self.m_prev_le,
                      self.m_next_out, self.m_prev_out):
                if a is not None:
                    upd(a)
            for bucket in self.lin_buckets:
                for a in bucket:
                    upd(a)
            if self.conf_idx is not None:
                upd(self.conf_idx)
                upd(self.conf_off)
            self._data_digest = h.hexdigest()[:24]
        return self._data_digest

    @property
    def shape_signature(self):
        """Everything that determines the compiled program's shapes."""
        return (
            self.V, self.n_active, self.P,
            tuple((op, len(xs)) for op, xs, _, _ in self.groups),
            tuple((b.start, b.count, b.cand_idx.shape[1]) for b in self.buckets),
            tuple(len(s.ids) for s in self.strategies),
            (self.E, 0 if self.e_tab is None else self.e_tab.shape[1]),
            (self.M, 0 if self.m_cnt is None else self.m_cnt.shape[1]),
            tuple(b[3].shape for b in self.lin_buckets),
            0 if self.conf_idx is None else len(self.conf_idx),
        )


def auto_num_dives(tnf: Tnf, budget_bytes: Optional[int] = None,
                   lo: int = 64, hi: int = 1024) -> int:
    """TPU analog of the reference's occupancy-based default block count.

    With ``-or 0`` (the reference's config.hpp:74 default) Turbo sizes
    its grid as max_blocks_per_sm * num_SMs from the CUDA occupancy API
    (configure_gpu_barebones, barebones_dive_and_solve.hpp:527-547) and
    clamps by a global-memory budget (barebones:557-585).  The TPU
    equivalent of "occupancy" is the propagation sweep's per-iteration
    working set vs the chip's fast-memory scale: lanes are free until
    the sweep's tensors outgrow the bandwidth/compile budget, after
    which more dives only add latency.  Pick the largest power-of-two D
    whose estimated per-sweep footprint fits the budget (HBM-streaming
    scale, not VMEM residency: the element-table window masks (D,E,T)
    dominate real instances and are streamed).

    The per-dive estimate counts the store planes (2V), the six
    consolidated role gathers (18P), candidate planes (~8P), and the
    native element/member/linear working tensors (propagate_jax.py
    iteration())."""
    if budget_bytes is None:
        budget_bytes = int(os.environ.get(
            "TURBO_TPU_WS_BUDGET", 128 << 20))
    V = tnf.num_vars
    P = max(tnf.num_props, 1)
    elem_cells = sum(len(e.values) for e in tnf.elements)
    memb_cells = 8 * len(tnf.members)
    lin_cells = 3 * sum(len(l.vars) for l in tnf.linears)
    per_dive = 4 * (2 * V + 26 * P
                    + 2 * (elem_cells + memb_cells + lin_cells))
    d = max(budget_bytes // max(per_dive, 1), 1)
    p = lo
    while p * 2 <= d and p * 2 <= hi:
        p *= 2
    return p


# Root-shaving limits. All DETERMINISTIC functions of the instance —
# no wall-clock budget: warm_goldens must build byte-identical plans
# to the regression run (shaved bounds feed Plan.data_digest, which
# keys the executable cache), so the probe schedule may depend only on
# the model, never on machine speed.
SHAVE_ROUNDS = 2
SHAVE_PROBE_ITERS = 12
SHAVE_MAX_PROBES_PER_ROUND = 4096   # 2 * unfixed vars
SHAVE_MAX_PROPS = 8192


def shave_root(table: PropTable, lb: np.ndarray, ub: np.ndarray,
               rounds: int = SHAVE_ROUNDS,
               probe_iters: int = SHAVE_PROBE_ITERS) -> int:
    """Root bound shaving (singleton bound consistency on the bounds).

    For every unfixed variable, probe each bound assignment (x=lb,
    x=ub) with a short capped AC-1 fixpoint; a probe that reaches bot
    REFUTES that bound, which is then shaved off and the root
    re-propagated. Sound in one direction only: deductions are sound,
    so bot under a capped sweep is a valid refutation, while a non-bot
    capped probe proves nothing and shaves nothing. Removes only
    values that belong to no solution, so the full solution set (and
    every optimum) is preserved — unlike the simplification passes it
    can only *strengthen* the entailed-drop/folding that follows.

    Beyond the reference: the GPU driver has no probing presolve.
    Mutates lb/ub in place; returns the number of shaved bounds, or -1
    if shaving proved the root unsat (every value of some variable
    refuted)."""
    cuts = 0
    for _ in range(rounds):
        changed = False
        for v in np.flatnonzero(ub > lb):
            for side in (0, 1):
                # A bound sitting at the clamped-universe sentinel is
                # not a real model value: probing x=±(2^30-1) wastes a
                # full-table sweep and a successful "cut" shrinks a
                # ~2^31 domain by one — skip effectively-unbounded
                # sides entirely.
                if (lb[v] <= NINF if side == 0 else ub[v] >= INF):
                    continue
                l2, u2 = lb.copy(), ub.copy()
                if side == 0:
                    u2[v] = l2[v]
                else:
                    l2[v] = u2[v]
                _, _, bot = table.propagate(l2, u2, max_iters=probe_iters)
                if bot:
                    if side == 0:
                        lb[v] += 1
                    else:
                        ub[v] -= 1
                    _, _, rbot = table.propagate(lb, ub)
                    cuts += 1
                    changed = True
                    if rbot or lb[v] > ub[v]:
                        return -1
        if not changed:
            break
    return cuts


def build_plan(tnf: Tnf, max_bucket_k: int = 64,
               disable_simplify: bool = False, shave: bool = False) -> Plan:
    """disable_simplify mirrors the reference's -disable_simplify
    (config.cpp:41, preprocess_tcn common_solving.hpp:530-536): the
    root fixpoint still runs, but the simplification passes — entailed-
    propagator elimination, root-singleton rhs folding, useless-variable
    store compaction — are skipped, so the device plan carries the full
    unsimplified constraint network. Shaving counts as a simplification
    pass, so the flag disables it too."""
    Vr = tnf.num_vars  # real var count
    lb = tnf.lb0.copy()
    ub = tnf.ub0.copy()
    root_unsat = bool(tnf.root_unsat or np.any(lb > ub))

    # Root fixpoint on the host (preprocess, common_solving.hpp:541-563).
    table = PropTable(tnf)
    if not root_unsat and tnf.num_props:
        _, _, bot = table.propagate(lb, ub)
        root_unsat = root_unsat or bot

    # Root shaving (see shave_root). Gated by deterministic size limits
    # so the probe sweep stays a few seconds of host presolve (it scales
    # as unfixed-vars x propagators); big instances skip it.
    if (shave and not disable_simplify and not root_unsat
            and tnf.num_props <= SHAVE_MAX_PROPS
            and 2 * int(np.count_nonzero(ub > lb))
                <= SHAVE_MAX_PROBES_PER_ROUND):
        if shave_root(table, lb, ub) < 0:
            root_unsat = True

    if root_unsat:
        lb, ub = tnf.lb0.copy(), tnf.ub0.copy()

    # Drop root-entailed propagators (ask is monotone: once entailed,
    # always entailed), including fully-singleton satisfied ones.
    per_op = {op: [] for op in range(NUM_OPS)}
    num_real_props = 0
    for op, sl in table.groups:
        xs, ys, zs = table.xs[sl], table.ys[sl], table.zs[sl]
        if root_unsat or disable_simplify:
            keep = np.ones(len(xs), dtype=bool)
        else:
            keep = ~deduce_np.ask(op, lb[xs], ub[xs], lb[ys], ub[ys], lb[zs], ub[zs])
        if keep.any():
            per_op[op].append((xs[keep], ys[keep], zs[keep]))
            num_real_props += int(keep.sum())
    keep_elems = list(tnf.elements)
    keep_members = list(tnf.members)
    if not root_unsat and not disable_simplify:
        if keep_elems:
            ask_e = table._element_ask(lb, ub)
            keep_elems = [e for e, a in zip(keep_elems, ask_e) if not a]
        if keep_members:
            ask_m = table._member_ask(lb, ub)
            keep_members = [m for m, a in zip(keep_members, ask_m) if not a]
    keep_lins = list(tnf.linears)
    if not root_unsat and keep_lins and not disable_simplify:
        ask_l = table._linear_ask(lb, ub)
        keep_lins = [l for l, a in zip(keep_lins, ask_l) if not a]
        # Fold root-singleton terms into the rhs (shrinks term counts).
        from ..compile.tnf import LinCon
        folded = []
        for l in keep_lins:
            rhs = l.rhs
            cs, vs = [], []
            for c, x in zip(l.coefs, l.vars):
                if lb[x] == ub[x]:
                    rhs -= c * int(lb[x])
                else:
                    cs.append(c)
                    vs.append(x)
            folded.append(LinCon(l.b, l.op, rhs, tuple(cs), tuple(vs)))
        keep_lins = folded
    elif root_unsat:
        keep_lins = []
    root_entailed = (num_real_props == 0 and not keep_elems
                     and not keep_members and not keep_lins)

    # Degree of each variable over live props; root singletons excluded.
    singleton = lb == ub
    deg = np.zeros(Vr, dtype=np.int64)
    for op in range(NUM_OPS):
        for xs, ys, zs in per_op[op]:
            for ids in (xs, ys, zs):
                np.add.at(deg, ids, 1)
    for e in keep_elems:
        deg[e.idx] += 1
        deg[e.res] += 1
    for m in keep_members:
        deg[m.x] += 1
        deg[m.b] += 1
    for l in keep_lins:
        for x in l.vars:
            deg[x] += 1
        deg[l.b] += 1
    active = ~singleton

    # Power-of-two K ladder from 2: balances combine padding against
    # the number of bucket gather ops (each distinct gather costs real
    # compile time on this TPU toolchain).
    Ks = [2]
    k = 4
    while k < max_bucket_k:
        Ks.append(k)
        k *= 2
    Ks.append(max_bucket_k)

    def bucket_k(d):
        for K in Ks:
            if d <= K:
                return K
        return Ks[-1]

    # Order active vars by (bucket K, original id).
    act_ids = np.nonzero(active)[0]
    act_deg = deg[act_ids]
    act_K = np.array([bucket_k(int(d)) for d in act_deg])
    order = np.lexsort((act_ids, act_K))
    act_sorted = act_ids[order]
    act_K_sorted = act_K[order]
    # Useless-variable compaction: singletons referenced by no live
    # propagator never influence propagation or failure detection, so
    # they are dropped from the device store (values restored from the
    # root at output time). The objective is always kept (the engine
    # reads lb[:, obj] even when it is root-fixed).
    dropped = (~active) & (deg == 0)
    if disable_simplify:
        dropped[:] = False  # no useless-variable store compaction
    if tnf.obj_var >= 0:
        dropped[tnf.obj_var] = False
    sing_ids = np.nonzero(~active & ~dropped)[0]

    # Padded layout: per-K bucket row ranges (padded counts), then
    # singleton tail, then padding slots; the last slot is the dummy var.
    bucket_ranges = []  # (K, real_ids_in_bucket, start, padded_count)
    pos = 0
    i = 0
    while i < len(act_sorted):
        K = act_K_sorted[i]
        j = i
        while j < len(act_sorted) and act_K_sorted[j] == K:
            j += 1
        real = act_sorted[i:j]
        padded = quantize(len(real))
        bucket_ranges.append((int(K), real, pos, padded))
        pos += padded
        i = j
    n_active = pos
    V = quantize(n_active + len(sing_ids) + 3, min_gran=128)
    dummy = V - 1    # fixed [0,0]
    dummy1 = V - 2   # fixed [1,1] (reified-true / nonzero-divisor slot)
    spill = V - 3    # inert slot shared by all dropped vars

    # perm: real tnf id -> permuted id; inv_perm: permuted -> tnf id
    perm = np.full(Vr, -1, dtype=np.int64)
    lb_p = np.zeros(V, dtype=np.int32)
    ub_p = np.zeros(V, dtype=np.int32)
    for K, real, start, padded in bucket_ranges:
        perm[real] = start + np.arange(len(real))
        lb_p[start:start + len(real)] = lb[real]
        ub_p[start:start + len(real)] = ub[real]
    sing_start = n_active
    perm[sing_ids] = sing_start + np.arange(len(sing_ids))
    lb_p[sing_start:sing_start + len(sing_ids)] = lb[sing_ids]
    ub_p[sing_start:sing_start + len(sing_ids)] = ub[sing_ids]
    perm[np.nonzero(dropped)[0]] = spill
    lb_p[dummy1] = ub_p[dummy1] = 1
    inv_perm = np.full(V, -1, dtype=np.int64)
    inv_perm[perm[~dropped]] = np.nonzero(~dropped)[0]

    # Groups: all seven ops, each padded to a quantized size with dummy
    # props (x=y=z=dummy var, trivially entailed ADD-style rows).
    groups = []
    slot_of: List[Tuple[np.ndarray, np.ndarray]] = []
    sizes = []
    for op in range(NUM_OPS):
        parts = per_op[op]
        if parts:
            xs = np.concatenate([p[0] for p in parts])
            ys = np.concatenate([p[1] for p in parts])
            zs = np.concatenate([p[2] for p in parts])
            pxs, pys, pzs = perm[xs], perm[ys], perm[zs]
        else:
            pxs = pys = pzs = np.zeros(0, dtype=np.int64)
        n = len(pxs)
        padded = quantize(n)
        # Dummy rows must be entailed, satisfied constraints so they are
        # invisible to all_entailed(): pick operand values per op.
        from ..core.ops import OP_DIV, OP_EQ, OP_LE
        dx = dummy1 if op in (OP_LE, OP_EQ) else dummy   # x=(0<=0)=1 etc.
        dz = dummy1 if op == OP_DIV else dummy           # nonzero divisor
        padx = np.full(padded - n, dx, dtype=np.int64)
        pady = np.full(padded - n, dummy, dtype=np.int64)
        padz = np.full(padded - n, dz, dtype=np.int64)
        groups.append((op,
                       np.concatenate([pxs, padx]).astype(np.int32),
                       np.concatenate([pys, pady]).astype(np.int32),
                       np.concatenate([pzs, padz]).astype(np.int32)))
        sizes.append((n, padded))
    P = sum(p for _, p in sizes)

    # Candidate layout: role-major over padded groups:
    # [x-cands | y-cands | z-cands | neutral]. Slot of real prop j of
    # group g, role r: r*P + group_base_g + j.
    base = 0
    for (op, gxs, gys, gzs), (n, padded) in zip(groups, sizes):
        idx = np.arange(n, dtype=np.int64)
        slot_of.append((gxs[:n], 0 * P + base + idx))
        slot_of.append((gys[:n], 1 * P + base + idx))
        slot_of.append((gzs[:n], 2 * P + base + idx))
        base += padded
    E = quantize(max(len(keep_elems), 1), min_gran=8)
    M = quantize(max(len(keep_members), 1), min_gran=8)
    # Bucket linears by padded term count.
    lin_by_k = {}
    for l in keep_lins:
        K = 2
        while K < len(l.coefs):
            K *= 2
        lin_by_k.setdefault(K, []).append(l)
    lin_bucket_list = []
    for K in sorted(lin_by_k):
        ls = lin_by_k[K]
        Cb = quantize(len(ls), min_gran=8)
        lin_bucket_list.append((K, Cb, ls))
    if not lin_bucket_list:
        lin_bucket_list.append((2, 8, []))
    L_terms_total = sum(Cb * K for K, Cb, _ in lin_bucket_list)
    L_total = sum(Cb for _, Cb, _ in lin_bucket_list)
    base_lin = 3 * P + 2 * E + 2 * M
    base_linb = base_lin + L_terms_total
    neutral = base_linb + L_total

    # Incidence lists per active permuted var (padding rows stay empty).
    # Slots whose target is a singleton-tail var go to the conflict
    # fold instead (see Plan.conf_idx): the deduction can only confirm
    # the fixed value or prove bot, and dropping it would lose the bot.
    inc: List[List[int]] = [[] for _ in range(n_active)]
    conf_pairs: List[Tuple[int, int]] = []  # (slot, fixed value)

    def _route(v, s):
        if v < n_active:
            inc[v].append(int(s))
        elif v < V - 3:  # singleton tail (spill/dummies are synthetic)
            conf_pairs.append((int(s), int(lb_p[v])))

    for vids, slots in slot_of:
        for v, s in zip(vids.tolist(), slots.tolist()):
            _route(v, s)
    for i, e in enumerate(keep_elems):
        _route(perm[e.idx], 3 * P + i)
        _route(perm[e.res], 3 * P + E + i)
    for i, m in enumerate(keep_members):
        _route(perm[m.x], 3 * P + 2 * E + i)
        _route(perm[m.b], 3 * P + 2 * E + M + i)
    off_t = 0
    off_c = 0
    for K, Cb, ls in lin_bucket_list:
        for j, l in enumerate(ls):
            for t, x in enumerate(l.vars):
                _route(perm[x], base_lin + off_t + j * K + t)
            _route(perm[l.b], base_linb + off_c + j)
        off_t += Cb * K
        off_c += Cb
    conf_idx = conf_off = None
    if conf_pairs:
        T = quantize(len(conf_pairs), min_gran=8)
        conf_idx = np.full(T, neutral, dtype=np.int64)
        conf_off = np.zeros(T, dtype=np.int32)  # neutral cand: no conflict
        conf_idx[:len(conf_pairs)] = [s for s, _ in conf_pairs]
        conf_off[:len(conf_pairs)] = [c for _, c in conf_pairs]
        conf_idx = conf_idx.astype(np.int32)

    buckets: List[Bucket] = []
    for K, real, start, padded in bucket_ranges:
        true_max = max((len(inc[start + i]) for i in range(len(real))), default=0)
        Kp = K
        while Kp < true_max:
            Kp *= 2
        idx = np.full((padded, Kp), neutral, dtype=np.int64)
        for i in range(len(real)):
            row = inc[start + i]
            idx[i, :len(row)] = row
        buckets.append(Bucket(start, padded, idx.astype(np.int32)))

    # Objective + strategies in permuted ids.
    is_opt = tnf.obj_var >= 0
    obj = int(perm[tnf.obj_var]) if is_opt else dummy
    strategies = []
    for s in tnf.strategies:
        if s.var_ids is None:
            # Default whole-store strategy: active vars in ORIGINAL store
            # order (reference tie-break order, barebones input_order_split).
            ids = perm[np.sort(act_sorted)]
        else:
            if len(s.var_ids) == 0:
                continue
            ids = perm[s.var_ids]
        padded = quantize(len(ids))
        ids = np.concatenate([ids, np.full(padded - len(ids), dummy, dtype=np.int64)])
        strategies.append(PlanStrategy(s.var_order, s.val_order,
                                       ids.astype(np.int32)))
    # Pad the strategy list to a power of two with copies of the last
    # (default, whole-store) strategy — semantically inert duplicates.
    while len(strategies) & (len(strategies) - 1):
        strategies.append(strategies[-1])

    # Element tables (padded with trivially-entailed dummy rows:
    # idx=dummy1 [1,1], res=dummy [0,0], table [0,...]).
    T = quantize(max([len(e.values) for e in keep_elems] + [1], default=1),
                 min_gran=8) if keep_elems else 8
    e_idx = np.full(E, dummy1, dtype=np.int32)
    e_res = np.full(E, dummy, dtype=np.int32)
    e_len = np.ones(E, dtype=np.int32)
    e_tab = np.zeros((E, T), dtype=np.int32)
    for i, e in enumerate(keep_elems):
        e_idx[i] = perm[e.idx]
        e_res[i] = perm[e.res]
        e_len[i] = len(e.values)
        e_tab[i, :len(e.values)] = e.values

    # Member tables (dummy rows: x=dummy [0,0], b=dummy1 [1,1], S={0}).
    W = 8
    for m in keep_members:
        W = max(W, max(m.values) - min(m.values) + 1)
    W = quantize(W, min_gran=8)
    m_x = np.full(M, dummy, dtype=np.int32)
    m_b = np.full(M, dummy1, dtype=np.int32)
    m_base = np.zeros(M, dtype=np.int32)
    m_top = np.zeros(M, dtype=np.int32)
    m_cnt = np.zeros((M, W + 1), dtype=np.int32)
    m_cnt[:, 1:] = 1  # dummy S={0}: one member at offset 0
    m_next_ge = np.zeros((M, W), dtype=np.int32)
    m_prev_le = np.zeros((M, W), dtype=np.int32)
    m_next_out = np.ones((M, W), dtype=np.int32)
    m_prev_out = np.full((M, W), -1, dtype=np.int32)
    for i, m in enumerate(keep_members):
        base, top = min(m.values), max(m.values)
        m_x[i] = perm[m.x]
        m_b[i] = perm[m.b]
        m_base[i] = base
        m_top[i] = top
        w = top - base + 1
        ins = np.zeros(W, dtype=bool)
        for v in m.values:
            ins[v - base] = True
        m_cnt[i, 0] = 0
        m_cnt[i, 1:] = np.cumsum(ins)
        nxt = top + 1
        nxo = top + 1
        for k2 in range(W - 1, -1, -1):
            v = base + k2
            if k2 < w and ins[k2]:
                nxt = v
            elif k2 < w:
                nxo = v
            m_next_ge[i, k2] = nxt
            m_next_out[i, k2] = nxo
        prv = base - 1
        pvo = base - 1
        for k2 in range(W):
            v = base + k2
            if k2 < w and ins[k2]:
                prv = v
            elif k2 < w:
                pvo = v
            m_prev_le[i, k2] = prv
            m_prev_out[i, k2] = pvo

    lin_buckets = []
    BIG_RHS = 1 << 40
    for K, Cb, ls in lin_bucket_list:
        lb_arr = np.full(Cb, dummy1, dtype=np.int32)
        lop = np.zeros(Cb, dtype=np.int32)
        lrhs = np.full(Cb, BIG_RHS, dtype=np.int64)
        lcoef = np.zeros((Cb, K), dtype=np.int32)
        lvar = np.full((Cb, K), dummy, dtype=np.int32)
        for j, l in enumerate(ls):
            lb_arr[j] = perm[l.b]
            lop[j] = l.op
            lrhs[j] = l.rhs
            lcoef[j, :len(l.coefs)] = l.coefs
            lvar[j, :len(l.vars)] = perm[np.asarray(l.vars, dtype=np.int64)]
        lin_buckets.append((lb_arr, lop, lrhs, lcoef, lvar))

    return Plan(V=V, n_active=n_active, P=P, lb0=lb_p, ub0=ub_p,
                groups=groups, buckets=buckets, obj=obj, is_opt=is_opt,
                strategies=strategies, inv_perm=inv_perm, perm=perm,
                root_unsat=root_unsat, root_entailed=root_entailed,
                num_real_props=(num_real_props + len(keep_elems)
                                + len(keep_members) + len(keep_lins)),
                dropped=dropped, fixed_lb=lb.astype(np.int64),
                fixed_ub=ub.astype(np.int64),
                e_idx=e_idx, e_res=e_res, e_len=e_len, e_tab=e_tab,
                m_x=m_x, m_b=m_b, m_base=m_base, m_top=m_top, m_cnt=m_cnt,
                m_next_ge=m_next_ge, m_prev_le=m_prev_le,
                m_next_out=m_next_out, m_prev_out=m_prev_out,
                lin_buckets=lin_buckets,
                conf_idx=conf_idx, conf_off=conf_off)
