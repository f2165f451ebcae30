"""Multi-host EPS: port of ``turbo_tpu/parallel/multihost.py``.

Each process (host) runs a ``ShardedSolver`` over its local shards and
owns a contiguous range of the global 2^k EPS subproblem space. The
processes cooperate through one host-side exchange every
``exchange_every_chunks`` chunks: an int64 snapshot of each process,
allgathered, from which every process computes the same decisions:

  1. the incumbent bound: the gathered global best is met into the
     state's ``ext_bound`` (written in place, so the chunk's CUDA graph
     stays valid);
  2. work stealing: ``plan_host_steal`` on the gathered (next_sub,
     sub_limit) cursors; a donor shrinks its shard's range on the card,
     a thief reseeds its shards with ``reseed_ranges``. Timing races only
     duplicate subproblems, never skip them;
  3. the ``-i`` stream (the winning store rides the snapshot), the global
     ``-cutnodes`` budget, the timeout, the checkpoint tick and ``-n``.

The transport is ``torch.distributed.all_gather`` over gloo on CPU
tensors (``dcn_allgather``): the JAX version is an identity jitted with a
replicated output sharding, so XLA gathers a host vector across
processes. There is no device arithmetic to write a kernel for, the data
starts and ends on the host, and NCCL cannot join two ranks on one card.

Run one process per host with ``init_distributed(...)`` first; every
process must call ``solve`` collectively.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import pick_device
from ..host.core.ops import INF
from ..solver.config import EngineConfig, choose_subproblems_power
from ..solver.convert import search_state_to_numpy
from ..solver.engine import DIVE, IDLE
from ..solver.result import EngineResult
from .mesh import ShardedSolver, card_groups

I64 = torch.int64

# The fields reseed_ranges writes (and kpow, which it reads).
RESEED_FIELDS = ("phase", "subp", "next_sub", "sub_limit", "depth", "strat",
                 "snap_strat", "remaining", "lb", "ub", "root_lb", "root_ub")


def _world() -> Tuple[int, int]:
    """(process id, process count) of the distributed run, or (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def dcn_allgather(vec: np.ndarray) -> np.ndarray:
    """Gather the int64 vector ``vec`` from every process; returns
    ``(H, *vec.shape)`` as numpy (``vec[None]`` in a single process)."""
    vec = np.asarray(vec)
    _, n = _world()
    if n == 1:
        return vec[None, ...]
    import torch.distributed as dist
    t = torch.from_numpy(np.ascontiguousarray(vec, dtype=np.int64))
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: float = 300.0) -> bool:
    """Join the gloo process group of a multi-host run at
    ``tcp://coordinator_address`` (``host:port``; process 0 serves it).
    Returns True when a multi-process group was set up (False: one
    process, nothing to do). Every collective after it fails, and never
    hangs, once ``timeout_s`` passes without a peer."""
    if num_processes in (None, 1):
        return False
    import torch.distributed as dist
    host = coordinator_address.rsplit(":", 1)[0]
    if host in ("localhost", "127.0.0.1", "::1", "[::1]"):
        # Every process on this machine: keep gloo on the loopback
        # device, without resolving the machine's own name.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown_distributed() -> None:
    """Leave the process group of ``init_distributed``, all at once:
    process 0 serves the group's store, so no process may tear it down
    while another still uses it. Nothing to do in a single process."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def plan_host_steal(next_mat: np.ndarray, limit_mat: np.ndarray,
                    idle: np.ndarray) -> List[Tuple[int, int, int, int, int]]:
    """Deterministic cross-host steal plan (a copy of
    ``turbo_tpu/parallel/multihost.py:86-115``).

    next_mat/limit_mat: (H, S) int64 per-host per-local-shard subproblem
    cursors and range ends (padded shards have next==limit); idle: (H,)
    bool, host has no running lanes. Every host computes this from the
    same snapshot, so donors and thieves agree without a second round.

    Returns moves [(thief_host, donor_host, donor_shard, mid, hi)]:
    donor shard's range shrinks to [.., mid), thief reseeds [mid, hi).
    """
    next_mat = next_mat.copy()
    limit_mat = limit_mat.copy()
    rem = limit_mat - next_mat
    dry = idle & (rem.sum(axis=1) <= 0)
    moves = []
    for thief in np.nonzero(dry)[0]:
        rem = limit_mat - next_mat
        rem[dry, :] = 0          # dry hosts (incl. served thieves) can't donate
        d_host, d_shard = np.unravel_index(int(np.argmax(rem)), rem.shape)
        give = int(rem[d_host, d_shard]) // 2
        if give < 1:
            continue
        hi = int(limit_mat[d_host, d_shard])
        mid = hi - give
        limit_mat[d_host, d_shard] = mid
        dry[thief] = False
        moves.append((int(thief), int(d_host), int(d_shard), mid, hi))
    return moves


def reseed_ranges(st: dict, D: int, n_shards: int, lb0: np.ndarray,
                  ub0: np.ndarray, lo: int, hi: int) -> dict:
    """Reseed ALL local shards of a dry host with the stolen range
    [lo, hi): contiguous per-shard sub-ranges, the lane layout of
    ``init_state`` (a copy of ``turbo_tpu/parallel/multihost.py:118-145``
    over numpy fields). ``st``: the fields of ``RESEED_FIELDS`` and
    ``kpow``; returns new arrays for the ``RESEED_FIELDS``."""
    per = max(1, (hi - lo) // n_shards)
    out = {f: st[f].copy() for f in RESEED_FIELDS}
    for s in range(n_shards):
        sl = slice(s * D, (s + 1) * D)
        base = min(lo + s * per, hi)
        limit = hi if s == n_shards - 1 else min(base + per, hi)
        lane_sub = base + np.arange(D, dtype=np.int32)
        out["subp"][sl] = lane_sub
        out["phase"][sl] = np.where(lane_sub < limit, DIVE, IDLE)
        out["next_sub"][sl] = min(base + D, limit)
        out["sub_limit"][sl] = limit
        out["depth"][sl] = 0
        out["strat"][sl] = 0
        out["snap_strat"][sl] = 0
        out["remaining"][sl] = st["kpow"][sl]
        out["lb"][sl] = lb0[None, :]
        out["ub"][sl] = ub0[None, :]
        out["root_lb"][sl] = lb0[None, :]
        out["root_ub"][sl] = ub0[None, :]
    return out


class MultiHostSolver:
    """Per-host ``ShardedSolver`` + host-side bound sharing and work
    stealing.

    Construct after ``init_distributed``; every process must call
    ``solve`` collectively (the allgathers are collective operations)."""

    def __init__(self, tnf, config: EngineConfig = EngineConfig(),
                 devices=None, exchange_every_chunks: int = 2):
        """``devices``: the local shards' devices, as ``ShardedSolver``
        takes them (several cards: a card group each, stepped with K10's
        exchange between them). None: one shard on this process's card
        (``pick_device``, card ``pid`` modulo the visible cards; raises
        without CUDA)."""
        if config.enumerate_all:
            # Steal races may duplicate subproblems (sound for bounds,
            # pruned by the incumbent), but enumeration would count the
            # duplicated solutions twice: route -a to one host.
            raise ValueError(
                "enumerate_all (-a) is not supported by the multi-host "
                "architecture; run it on a single host")
        # A thief cannot gather another host's table rows: stolen ranges
        # re-dive from the root, so the multi-host path runs table off.
        config = dataclasses.replace(config, use_table=False)
        self.pid, self.n_hosts = _world()
        if devices is None:
            devices = [pick_device(index=self.pid)]
        # Host h owns global shards [off_h, off_h + S_h); the snapshot
        # pads to the largest S_h (padded shards have next == limit).
        S = sum(n for _, n in card_groups(devices))
        counts = dcn_allgather(np.array([S], dtype=np.int64)).reshape(-1)
        self.host_shards = counts.astype(np.int64)
        total_shards = int(counts.sum())
        shard_offset = int(counts[:self.pid].sum())
        self.S_max = int(counts.max())
        if config.subproblems_power <= 0:
            # The root-tree probe is wall-clock bounded: host 0 chooses k
            # and every host takes its choice.
            k = choose_subproblems_power(tnf, config, total_shards,
                                         allow_probe=(self.pid == 0))
            k = int(dcn_allgather(np.array([k], dtype=np.int64))[0, 0])
            config = dataclasses.replace(config, subproblems_power=k)
        self.sharded = ShardedSolver(tnf, config, devices=devices,
                                     shard_offset=shard_offset,
                                     total_shards=total_shards)
        self.plan = self.sharded.plan
        self.opt = self.sharded.opt
        # The final reduction runs in the original objective's space.
        self.is_max = bool(self.sharded.tnf.is_max)
        self.exchange_every = max(1, exchange_every_chunks)
        self.S = S
        # Of the last solve: seconds of each snapshot allgather (waiting
        # for the peers included), the exchanges' whole host time after
        # the chunks' device work, and this host's steal moves.
        self.allgather_s: List[float] = []
        self.exchange_s = 0.0
        self.steal_moves = 0
        self.steal_s = 0.0

    def _read_snapshot(self, st, D: int):
        """One host read of what the snapshot needs: (local idle, best
        bound, sols, nodes, has_best, ext_bound, per-shard next and limit,
        the store of the best lane). The store is read with the scalars,
        as one transfer, and used only when has_best holds."""
        st = self.sharded.global_state(st, fields=(
            "phase", "best_bound", "sols", "nodes", "has_best", "ext_bound",
            "next_sub", "sub_limit", "best_lb"))
        first = torch.arange(self.S, device=st.phase.device) * D
        d = torch.where(st.has_best, st.best_bound, INF + 1).argmin()
        head = torch.stack([
            (st.phase == IDLE).all().to(I64), st.best_bound.min().to(I64),
            st.sols.sum(dtype=I64), st.nodes.sum(dtype=I64),
            st.has_best.any().to(I64), st.ext_bound[0].to(I64)])
        host = torch.cat([head, st.next_sub[first].to(I64),
                          st.sub_limit[first].to(I64),
                          st.best_lb[d].to(I64)]).cpu().numpy()
        S = self.S
        return (bool(host[0]), int(host[1]), int(host[2]), int(host[3]),
                bool(host[4]), int(host[5]), host[6:6 + S],
                host[6 + S:6 + 2 * S], host[6 + 2 * S:])

    def _reseed(self, st, D: int, lo: int, hi: int):
        """``reseed_ranges`` on this host's state, in place: only its
        fields go through the host."""
        names = RESEED_FIELDS + ("kpow",)
        glob = self.sharded.global_state(st, fields=names)
        fields = {f: getattr(glob, f).cpu().numpy() for f in names}
        out = reseed_ranges(fields, D, self.S, self.plan.lb0, self.plan.ub0,
                            lo, hi)
        self.sharded.write_fields(st, out)

    def solve(self, timeout_s: float = 1e18, chunk: int = 16,
              stop_after_n_solutions: int = 1, verbose: bool = False,
              on_improve=None, node_limit: int = 0,
              checkpoint_path: str = "",
              checkpoint_every_s: float = 60.0) -> EngineResult:
        """Collective multi-host solve (``turbo_tpu/parallel/multihost.py:
        200-433``).

        on_improve(best_lb_tnf): called on every host whenever the GLOBAL
        incumbent improves, at exchange latency (the winning host's store
        rides the snapshot). node_limit: global node budget, evaluated on
        the gathered total so every host stops at the same tick.
        checkpoint_path: per-host files ``path.h<pid>``, each with its
        local shard count; host 0's clock arms the save flag so every
        host saves at the same tick, and a restore is taken only when
        every host restored."""
        from ..solver.checkpoint import host_path, load_state, save_state
        sh = self.sharded
        s = sh.solver
        D = s.cfg.num_dives
        self.allgather_s, self.exchange_s = [], 0.0
        self.steal_moves, self.steal_s = 0, 0.0
        if self.plan.root_unsat:
            return EngineResult.unsat(sh)
        st = sh.init_state()
        my_ckpt = host_path(checkpoint_path, self.pid) if checkpoint_path \
            else ""
        if my_ckpt:
            restored = load_state(s, my_ckpt, num_shards=self.S)
            ok = dcn_allgather(np.array(
                [int(restored is not None)], dtype=np.int64)).reshape(-1)
            if ok.all() and restored is not None:
                sh.write_fields(st, search_state_to_numpy(restored[0]))
            elif ok.any() and self.pid == 0:
                print("% warning: partial multi-host checkpoint set; "
                      "all hosts starting fresh", flush=True)
        sh.sync()
        last_ckpt = time.monotonic()
        t0 = time.monotonic()
        first = True
        stopped = False
        redistributions = 0
        chunks = 0
        V = int(self.plan.V)
        SM = self.S_max
        last_improve_printed = INF
        # Every break below is decided from the gathered snapshot, the
        # same on every host, at ticks counted in chunks: the allgather is
        # a collective, so no host may leave the loop on its own.
        while True:
            st, _ = sh.run_steps(st, chunk)
            if first:
                sh.sync()
                first = False
                t0 = time.monotonic()
            chunks += 1
            if chunks % self.exchange_every:
                continue
            sh.sync()  # the chunks' device time stays out of exchange_s
            tx = time.monotonic()
            (local_idle, bbm, sols, nodes, has_b, ext, ns, slim,
             store) = self._read_snapshot(st, D)
            # [best, idle, want_stop, n_sols, nodes, want_ckpt,
            #  next_s..., limit_s..., best_store(V)]
            snap = np.zeros(6 + 2 * SM + V, dtype=np.int64)
            snap[0] = bbm
            snap[1] = int(local_idle)
            snap[2] = int(time.monotonic() - t0 > timeout_s)
            snap[3] = sols
            snap[4] = nodes
            snap[5] = int(bool(my_ckpt) and self.pid == 0 and
                          time.monotonic() - last_ckpt > checkpoint_every_s)
            snap[6:6 + self.S] = ns
            snap[6 + SM:6 + SM + self.S] = slim
            if has_b:
                snap[6 + 2 * SM:] = store
            tg = time.monotonic()
            allsnap = dcn_allgather(snap)
            self.allgather_s.append(time.monotonic() - tg)
            gbest = int(allsnap[:, 0].min())
            idle = allsnap[:, 1].astype(bool)
            total_sols = int(allsnap[:, 3].sum())
            total_nodes = int(allsnap[:, 4].sum())
            next_mat = allsnap[:, 6:6 + SM]
            limit_mat = allsnap[:, 6 + SM:6 + 2 * SM]
            if self.opt and gbest < ext:
                for x in sh.states(st):
                    x.ext_bound.fill_(gbest)
            if (on_improve is not None and self.opt and gbest < INF
                    and gbest < last_improve_printed):
                last_improve_printed = gbest
                win = int(np.argmin(allsnap[:, 0]))
                store = allsnap[win, 6 + 2 * SM:].astype(np.int32)
                on_improve(self.plan.store_to_tnf(store))
            moves = plan_host_steal(next_mat, limit_mat, idle)
            ts = time.monotonic()
            mine = 0
            for thief, d_host, d_shard, mid, hi in moves:
                if d_host == self.pid:
                    sh.shard_rows(st, "sub_limit", d_shard).clamp_(max=mid)
                    mine += 1
                if thief == self.pid:
                    self._reseed(st, D, mid, hi)
                    redistributions += 1
                    mine += 1
            if mine:
                sh.sync()
                self.steal_moves += mine
                self.steal_s += time.monotonic() - ts
            if my_ckpt and allsnap[:, 5].any():
                # Host 0 armed the save: every host saves at this tick.
                save_state(s, sh.global_state(st), my_ckpt,
                           num_shards=self.S)
                last_ckpt = time.monotonic()
            self.exchange_s += time.monotonic() - tx
            if allsnap[:, 2].any():          # some host hit the timeout
                stopped = True
                break
            if node_limit and total_nodes >= node_limit:
                stopped = True
                break
            if (not self.opt and stop_after_n_solutions > 0
                    and total_sols >= stop_after_n_solutions):
                # Enough solutions across hosts (-n): stop everywhere,
                # exhaustive only if every range drained.
                stopped = not bool(idle.all())
                break
            if idle.all() and not moves:
                break
            if verbose and self.pid == 0:
                print(f"% host0: chunks={chunks} best={bbm}", flush=True)
        glob = sh.global_state(st)
        if my_ckpt and stopped:
            save_state(s, glob, my_ckpt, num_shards=self.S)
        res = EngineResult.from_state(sh, glob, stopped,
                                      time.monotonic() - t0)
        return self._reduce(res, redistributions)

    def _reduce(self, res: EngineResult, redistributions: int):
        """The global reduction (``turbo_tpu/parallel/multihost.py:378-
        433``): every host returns the same result: the global objective
        (max for maximisation), global exhaustiveness, the summed
        statistics and the winning store (best objective, lowest pid on
        ties; for satisfaction the first host with a solution)."""
        res.eps_redistributions = redistributions
        has_sol = res.status in ("sat", "optimal")
        V = len(res.best_lb) if res.best_lb is not None else \
            len(self.plan.store_to_tnf(np.asarray(self.plan.lb0),
                                       np.asarray(self.plan.ub0))[0])
        zeros = np.zeros(V, dtype=np.int64)
        blb = (res.best_lb.astype(np.int64) if res.best_lb is not None
               else zeros)
        bub = (res.best_ub.astype(np.int64) if res.best_ub is not None
               else zeros)
        # A host without an incumbent sends the losing sentinel.
        sent = -INF if self.is_max else INF
        fin = dcn_allgather(np.concatenate([np.array(
            [res.objective if res.objective is not None else sent,
             int(res.exhaustive), int(has_sol),
             res.nodes, res.fails, res.solutions,
             res.fixpoint_iterations, int(res.num_deductions),
             res.depth_max, res.eps_solved_subproblems,
             res.eps_skipped_subproblems, redistributions],
            dtype=np.int64), blb, bub]))
        gobj = int(fin[:, 0].max() if self.is_max else fin[:, 0].min())
        res.exhaustive = bool(fin[:, 1].all())
        any_sol = bool(fin[:, 2].any())
        res.nodes = int(fin[:, 3].sum())
        res.fails = int(fin[:, 4].sum())
        res.solutions = int(fin[:, 5].sum())
        res.fixpoint_iterations = int(fin[:, 6].sum())
        res.num_deductions = float(fin[:, 7].sum())
        res.depth_max = int(fin[:, 8].max())
        res.eps_solved_subproblems = int(fin[:, 9].sum())
        res.eps_skipped_subproblems = int(fin[:, 10].sum())
        res.eps_redistributions = int(fin[:, 11].sum())
        if any_sol:
            key = -fin[:, 0] if self.is_max else fin[:, 0]
            win = int(np.lexsort((np.arange(fin.shape[0]),
                                  key))[0]) if self.opt else \
                int(np.nonzero(fin[:, 2])[0][0])
            res.best_lb = fin[win, 12:12 + V].astype(np.int32)
            res.best_ub = fin[win, 12 + V:12 + 2 * V].astype(np.int32)
        if self.opt and gobj != sent:
            res.objective = gobj
            res.status = "optimal" if res.exhaustive else "sat"
        elif not self.opt:
            if any_sol:
                res.status = "sat" if res.status != "optimal" else res.status
            else:
                res.status = "unsat" if res.exhaustive else "unknown"
        return res
