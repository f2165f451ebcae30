"""EPS subproblem-root table for the batched engine in PyTorch.

Port of ``turbo_tpu/solver/eps_table.py``: the 2^k-leaf dive tree is
expanded once, level by level, by ``dive_level`` (embed the children of
the previous frontier -> propagate to the true fixpoint -> classify ->
select), sharing every prefix. The surviving parents' children at level
k (stores, strategy cursors, bit-paths) become the table, built on the
solver's device by ``table_leaf`` and copied by each
``BatchedSolver.init_state``; a refill is then one row gather that drops
the lane straight into SOLVE phase.

Dead prefixes (bot / entailed / no splittable var) are accounted like
the engine's dive-leaf subtree skip: a dead node at level l covers
2^(k-l) subproblems -> 1 solved + (2^(k-l) - 1) skipped. Entailed
prefixes seed the incumbent. The host bookkeeping is the JAX module's,
with its semantics unchanged (that module imports jax at its top, so
none of it can be imported here).

``dive_level`` dispatches by device: on CUDA tensors a level is one
launch of K1's level entry (``kernels.fixpoint.level``; K8's under
``fp_mode="wac1"``), which gathers each row's parent into its block,
propagates it and classifies and selects on the result; on CPU tensors
it is ``dive_level_plain``, the same four stages in plain torch.
``table_leaf`` dispatches alike: one launch of K4's leaf entry
(``kernels.table_leaf``) or ``table_leaf_plain``.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import trace
from ..host.core.ops import INF, NINF

I32 = torch.int32
_BIG_CAP = 1 << 30  # the build propagates to the true fixpoint


class TableBuildTimeout(Exception):
    """Raised internally when the build passes its wall-clock deadline
    (``solver._table_deadline``, set by ``solve()`` from ``-t``); the
    caller falls back to dive-mode refills."""


@dataclasses.dataclass
class SubTable:
    """Build result: the table's planes on the solver's device, which
    ``init_state`` copies into each state (a state's rows may be
    rewritten in place), and the build's statistics on the host."""
    lb: torch.Tensor     # (n_pad, V) int32 leaf stores (plan space)
    ub: torch.Tensor
    strat: torch.Tensor  # (n_pad,) int32 post-dive strategy cursor
    path: torch.Tensor   # (n_pad,) int32 bit-path (for resplit / stats)
    n_live: int
    n_pad: int
    # Build statistics, seeded into the engine's counters so the
    # reported nodes/fails/fixpoint work include the dive tree.
    nodes: int = 0
    fails: int = 0
    fpit: int = 0
    deds: float = 0.0
    solved: int = 0      # subproblems completed by dead prefixes
    skipped: int = 0     # subproblems skipped by dead prefixes
    sols: int = 0
    dmax: int = 0        # deepest level classified (peakDepth seed)
    nonexh: bool = False
    has_cand: bool = False
    cand_bound: int = INF
    cand_lb: Optional[np.ndarray] = None  # (V,)
    cand_ub: Optional[np.ndarray] = None
    build_time: float = 0.0


def shard_range(solver, shard_idx: int):
    """[base, limit) of shard ``shard_idx``'s subproblems: equal static
    ranges, the last shard takes the remainder, so the ranges partition
    [0, 2^k) for any shard count."""
    total, n = solver.num_sub_total, solver.num_shards
    per = max(1, total // n)
    base = shard_idx * per
    return base, (total if shard_idx == n - 1 else min(base + per, total))


def table_n_pad(solver) -> int:
    """Static table row count: the largest shard range (the last
    shard's), padded."""
    from ..host.solver.plan import quantize
    base, limit = shard_range(solver, solver.num_shards - 1)
    return quantize(max(limit - base, 1))


def embed_plain(lb_par, ub_par, strat_par, var_par, c0l, c0u, c1l, c1u,
                pidx, pbit):
    """Row r: parent row pidx[r], met at the parent's branch variable
    with the child interval pbit[r] selects. Returns (lbp, ubp, stp)."""
    p = pidx.long()
    lbp, ubp, stp = lb_par[p], ub_par[p], strat_par[p]
    vp = var_par[p].long()[:, None]
    right = pbit == 1
    cl = torch.where(right, c1l[p], c0l[p])[:, None]
    cu = torch.where(right, c1u[p], c0u[p])[:, None]
    lbp.scatter_(1, vp, torch.maximum(lbp.gather(1, vp), cl))
    ubp.scatter_(1, vp, torch.minimum(ubp.gather(1, vp), cu))
    return lbp, ubp, stp


def leaf_rows(parents, base: int, limit: int) -> np.ndarray:
    """The leaf level's rows, as (n_live, 4) int32 (chunk, parent row,
    bit, path): the children path * 2 + bit of each (rows, paths) of
    ``parents`` (a chunk's live rows and their bit-paths) that fall in
    the shard's [base, limit), in bit-path order. The paths are unique,
    so this is the order of the JAX package's stable sort."""
    kids = [np.zeros((0, 4), dtype=np.int64)]
    for c, (rows, paths) in enumerate(parents):
        for bit in (0, 1):
            cps = paths * 2 + bit
            inr = (cps >= base) & (cps < limit)
            n = int(inr.sum())
            kids.append(np.stack([np.full(n, c), rows[inr],
                                  np.full(n, bit), cps[inr]], axis=1))
    out = np.concatenate(kids)
    return out[np.argsort(out[:, 3], kind="stable")].astype(np.int32)


def table_leaf_plain(chunks, rows, lb0, ub0, n_pad: int, eps_skip: int):
    """The table's leaf level: row r < len(rows) embeds child
    ``rows[r]`` = (chunk, parent row, bit, path) of ``chunks[chunk]``
    (the eight (lb, ub, strat, var, c0l, c0u, c1l, c1u) of a last-level
    chunk) as ``embed_plain`` does, with strat max(strat, eps_skip) and
    its path; the rows after it copy the root box (lb0, ub0) with strat
    and path 0 (a refill never gathers them, as it takes rows below
    ``sub_limit`` == n_live; root copies keep them harmless). Returns
    the (n_pad, V) ``lb``, ``ub`` and (n_pad,) ``strat``, ``path``,
    int32, on lb0's device."""
    dev = lb0.device
    tab_lb = lb0[None, :].repeat(n_pad, 1)
    tab_ub = ub0[None, :].repeat(n_pad, 1)
    tab_strat = torch.zeros(n_pad, dtype=I32, device=dev)
    tab_path = torch.zeros(n_pad, dtype=I32, device=dev)
    for c, ch in enumerate(chunks):
        sel = np.flatnonzero(rows[:, 0] == c)
        if not len(sel):
            continue
        pidx, pbit, path = (torch.as_tensor(rows[sel, j], device=dev)
                            for j in (1, 2, 3))
        lbp, ubp, stp = embed_plain(*ch, pidx, pbit)
        at = torch.as_tensor(sel, device=dev)
        tab_lb[at], tab_ub[at] = lbp, ubp
        tab_strat[at] = stp.clamp(min=eps_skip)
        tab_path[at] = path
    return tab_lb, tab_ub, tab_strat, tab_path


def table_leaf(chunks, rows, lb0, ub0, n_pad: int, eps_skip: int):
    """``table_leaf_plain``'s four planes: on the card one launch of K4's
    leaf entry, which writes them without a host copy."""
    if lb0.is_cuda:
        from .. import kernels
        return kernels.table_leaf(chunks, rows, lb0, ub0, n_pad, eps_skip)
    if lb0.device.type != "cpu":
        raise RuntimeError(f"no table leaf for device {lb0.device}")
    return table_leaf_plain(chunks, rows, lb0, ub0, n_pad, eps_skip)


def dive_level_plain(solver, lb_par, ub_par, strat_par, var_par, c0l, c0u,
                     c1l, c1u, pidx, pbit):
    """One frontier chunk of W rows: embed -> fixpoint (true fixpoint;
    WAC1 under ``fp_mode="wac1"``) -> classify -> select, each stage's
    plain torch version. Returns the 13 outputs of the JAX program (lb,
    ub, strat, var, c0l, c0u, c1l, c1u, bot, ent, found, iters,
    objlb)."""
    pk = solver.kernels
    lbp, ubp, stp = embed_plain(lb_par, ub_par, strat_par, var_par, c0l,
                                c0u, c1l, c1u, pidx, pbit)
    if solver.cfg.fp_mode == "wac1":
        lb2, ub2, iters, _ = pk.fixpoint_wac1_plain(
            lbp, ubp, _BIG_CAP, solver.cfg.wac1_inner_cap)
    else:
        lb2, ub2, iters, _ = pk.fixpoint_plain(lbp, ubp, _BIG_CAP)
    bot, ent = pk.classify_plain(lb2, ub2)
    ent = ent & ~bot
    found, var2, nstrat, _, d0l, d0u, d1l, d1u = solver._select_plain(
        lb2, ub2, stp)
    strat2 = torch.where(found, nstrat, stp)
    return (lb2, ub2, strat2, var2, d0l, d0u, d1l, d1u, bot, ent, found,
            iters, lb2[:, solver.dp.obj])


def dive_level(solver, *chunk):
    """``dive_level_plain``'s 13 outputs for the ten inputs ``chunk``: on
    the card one launch of the level entry of K1 (K8 under
    ``fp_mode="wac1"``)."""
    if chunk[0].is_cuda:
        from .. import kernels
        kp = solver.kernels.kernel_plan
        if solver.cfg.fp_mode == "wac1":
            return kernels.wac1.level(kp, chunk, solver.dp.obj, _BIG_CAP,
                                      solver.cfg.wac1_inner_cap)
        return kernels.fixpoint.level(kp, chunk, solver.dp.obj, _BIG_CAP)
    if chunk[0].device.type != "cpu":
        raise RuntimeError(f"no table level for device {chunk[0].device}")
    return dive_level_plain(solver, *chunk)


class _Chunk:
    """One frontier chunk: device outputs of a dive_level call plus the
    host bookkeeping needed to expand it."""
    __slots__ = ("dev", "rows", "paths")

    def __init__(self, dev, rows, paths):
        self.dev = dev        # (lb, ub, strat, var, c0l, c0u, c1l, c1u)
        self.rows = rows      # np int64: live row indices in this chunk
        self.paths = paths    # np int64: bit-path per live row


def build_table(solver, shard_idx: int = 0) -> Optional[SubTable]:
    """Expand the dive tree over shard ``shard_idx``'s range and return
    its leaf table, built inside the span ``table`` (``trace.py``), whose
    seconds are its ``build_time``: ``table.level`` a level's launch,
    ``table.read`` a host read of a level's results, ``table.leaf`` the
    leaf level: its row indices on the host and its launch. Counts
    ``table_leaf_device`` (1: the leaf ran on the card) and
    ``table_leaf_rows`` (its live rows).

    Returns None when the build overruns ``solver._table_deadline`` (an
    absolute ``time.monotonic()`` deadline budgeted from ``-t`` by
    ``solve()``); the wasted wall time is recorded in
    ``solver._table_aborted_s`` so the solve budget still charges it.
    Progress goes to stderr as ``%`` lines once the build runs longer
    than ~2 s."""
    with trace.span("table") as sp:
        try:
            acc = _build(solver, shard_idx)
        except TableBuildTimeout:
            acc = None
    if acc is None:
        solver._table_aborted_s = sp.s
        print(f"% table build deadline exceeded at level<= {solver.k}: "
              f"abandoning after {solver._table_aborted_s:.1f}s; "
              f"falling back to dive-mode refills",
              file=sys.stderr, flush=True)
        return None
    acc.build_time = sp.s
    return acc


def _build(solver, shard_idx):
    """``build_table``'s work; raises ``TableBuildTimeout`` past the
    deadline."""
    cfg, plan = solver.cfg, solver.plan
    W = cfg.num_dives
    k = solver.k
    dev = solver.device
    base, limit = shard_range(solver, shard_idx)
    t_start = time.monotonic()
    deadline = solver._table_deadline
    last_progress = [t_start]

    def checkpoint(level, n_chunks):
        """Deadline check + throttled progress, called between device
        calls (the build's only preemption points)."""
        now = time.monotonic()
        if now - last_progress[0] > 5.0 and now - t_start > 2.0:
            last_progress[0] = now
            print(f"% table build: level {level}/{k} "
                  f"({n_chunks} frontier chunks, "
                  f"{now - t_start:.0f}s elapsed)",
                  file=sys.stderr, flush=True)
        if deadline is not None and now > deadline:
            raise TableBuildTimeout()
    eps_skip = 1 if solver.has_eps else 0
    pscale = float(plan.num_real_props)
    is_opt = bool(plan.is_opt)

    acc = SubTable(lb=None, ub=None, strat=None, path=None,
                   n_live=0, n_pad=table_n_pad(solver))

    def classify(raw, rows, paths, level):
        """Account a freshly-propagated chunk (one host read); return the
        expandable subset (rows, paths) with the chunk's device arrays."""
        dvc = raw[:8]
        with trace.span("table.read"):
            bot, ent, found, iters, objlb = torch.stack(
                [raw[8].to(I32), raw[9].to(I32), raw[10].to(I32), raw[11],
                 raw[12]]).cpu().numpy()
        bot, ent, found = bot != 0, ent != 0, found != 0
        n = len(rows)
        acc.nodes += n
        acc.fpit += int(iters[rows].sum())
        acc.deds += float(iters[rows].sum()) * pscale
        if n:
            acc.dmax = max(acc.dmax, level)
        keep_rows, keep_paths = [], []
        shift = k - level
        for r, p in zip(rows, paths):
            lo_cov = int(p) << shift
            hi_cov = (int(p) + 1) << shift
            cov = min(hi_cov, limit) - max(lo_cov, base)
            if bot[r]:
                acc.fails += 1
                if cov >= 1:
                    acc.solved += 1
                    acc.skipped += cov - 1
            elif ent[r]:
                objv = int(objlb[r])
                better = (objv < acc.cand_bound) if is_opt \
                    else (not acc.has_cand)
                if better:
                    acc.sols += 1
                    acc.has_cand = True
                    acc.cand_bound = objv if is_opt else 0
                    with trace.span("table.read"):
                        acc.cand_lb = dvc[0][int(r)].cpu().numpy()
                        acc.cand_ub = dvc[1][int(r)].cpu().numpy()
                if cov >= 1:
                    acc.solved += 1
                    acc.skipped += cov - 1
            elif not found[r]:
                # No splittable var but not entailed: unbounded vars
                # remain (engine: incomplete -> exhaustive=false).
                acc.nonexh = True
                if cov >= 1:
                    acc.solved += 1
                    acc.skipped += cov - 1
            else:
                keep_rows.append(int(r))
                keep_paths.append(int(p))
        return _Chunk(dvc, np.asarray(keep_rows, dtype=np.int64),
                      np.asarray(keep_paths, dtype=np.int64))

    # Level 0: the root, W copies of the root box with neutral children.
    lb_r = solver.dp.lb0[None, :].repeat(W, 1)
    ub_r = solver.dp.ub0[None, :].repeat(W, 1)
    z = torch.zeros(W, dtype=I32, device=dev)
    neu0l = torch.full((W,), NINF, dtype=I32, device=dev)
    neu0u = torch.full((W,), INF, dtype=I32, device=dev)
    with trace.span("table.level"):
        raw = solver._dive_level(lb_r, ub_r, z, z, neu0l, neu0u, neu0l,
                                 neu0u, z, z)
    parents = [classify(raw, np.asarray([0]), np.asarray([0]), 0)]

    def expand(level):
        """Propagate the level-`level` children of `parents`."""
        out = []
        shift = k - level
        for ch in parents:
            kids = []  # (parent_row, bit, path)
            for r, p in zip(ch.rows, ch.paths):
                for bit in (0, 1):
                    cp = int(p) * 2 + bit
                    lo_cov = cp << shift
                    hi_cov = (cp + 1) << shift
                    if min(hi_cov, limit) - max(lo_cov, base) >= 1:
                        kids.append((int(r), bit, cp))
            for g0 in range(0, len(kids), W):
                checkpoint(level, len(parents))
                grp = kids[g0:g0 + W]
                pidx = np.zeros(W, dtype=np.int32)
                pbit = np.zeros(W, dtype=np.int32)
                pidx[:len(grp)] = [g[0] for g in grp]
                pbit[:len(grp)] = [g[1] for g in grp]
                with trace.span("table.level"):
                    res = solver._dive_level(
                        *ch.dev, torch.from_numpy(pidx).to(dev),
                        torch.from_numpy(pbit).to(dev))
                out.append((res, np.arange(len(grp)),
                            np.asarray([g[2] for g in grp])))
        return out

    for level in range(1, k):
        parents = [classify(raw, rows, paths, level)
                   for raw, rows, paths in expand(level)]
        parents = [c for c in parents if len(c.rows)]
        if not parents:
            break
    # Leaf level k: embed-only (the lane's first step propagates the
    # leaf anyway), on the solver's device.
    with trace.span("table.leaf"):
        rows = leaf_rows([(ch.rows, ch.paths) for ch in parents], base,
                         limit)
        acc.lb, acc.ub, acc.strat, acc.path = table_leaf(
            [ch.dev for ch in parents], rows, solver.dp.lb0, solver.dp.ub0,
            acc.n_pad, eps_skip)
        acc.n_live = len(rows)
    trace.count("table_leaf_device", int(acc.lb.is_cuda))
    trace.count("table_leaf_rows", acc.n_live)
    return acc
