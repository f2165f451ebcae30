"""Engine configuration and the host-side helpers of the batched engine.

``EngineConfig`` keeps the field names of ``turbo_tpu.solver.engine.
EngineConfig`` for the fields this port runs; the functions below are
copies of host functions that live inside that jax module (so they
cannot be imported from it), with their semantics unchanged:
``probe_tree_power`` (engine.py:317), ``auto_max_depth`` (337),
``choose_subproblems_power`` (384) and ``apply_strategy_config`` (438).
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

from .. import trace


@dataclasses.dataclass
class EngineConfig:
    num_dives: int = 64          # D: lanes (GPU: thread blocks)
    subproblems_power: int = 0   # k: 2^k subproblems; 0 -> auto from factor
    subproblems_factor: int = 300
    # Decision stack depth (MAXD); 0 = auto-size from the instance.
    max_depth: int = 0
    # Per-step fixpoint sweep cap; lanes still changing at the cap are
    # held (no branch, no node) and resume next step.
    fp_max_iters: int = 10000
    # "fixpoint": AC-1 until no change. "fixed": exactly fp_fixed_iters
    # sweeps per step, no convergence loop; sound because entailment and
    # failure detection stay exact, and an undecided node propagates
    # further on the next step before it branches. "wac1": per-op-group
    # local fixpoints, Gauss-Seidel over groups; falls back to AC-1 when
    # the instance has fewer than wac1_threshold propagators.
    fp_mode: str = "fixpoint"
    # Plane layout inside the fixpoint: "dv" = (D, V) as the search
    # state carries it; "vd" = transposed to dive-minor (V, D) around the
    # sweep. Both give equal stores.
    fp_layout: str = "dv"
    fp_fixed_iters: int = 2
    wac1_threshold: int = 0
    wac1_inner_cap: int = 16
    eps_var_order: str = "default"
    eps_value_order: str = "default"
    seed: int = 1
    # All-solutions mode (-a / -n>1 on satisfaction problems): count
    # only all-singleton stores, splitting entailed boxes further.
    enumerate_all: bool = False
    disable_simplify: bool = False
    shave: bool = False
    # Solution ring size R (0 = off): device buffer for per-solution
    # streaming (-a / -i). The host drains new rows each chunk; in
    # enumerate mode the chunk is capped at R // num_dives steps so the
    # ring cannot overflow between drains.
    sol_ring_size: int = 0
    # Live fixpoint-cap calibration when solve() gets no fp_cap.
    fp_cap_auto: bool = True
    # EPS subproblem-root table (solver/eps_table.py): refills enter
    # SOLVE phase from a table built once, instead of re-diving. Off
    # under enumerate_all, fp_mode "fixed" (the build needs true
    # fixpoints) and for oversized tables.
    use_table: bool = True

    def __post_init__(self):
        if self.fp_mode not in ("fixpoint", "fixed", "wac1"):
            raise ValueError(f"fp_mode {self.fp_mode!r}")
        if self.fp_layout not in ("dv", "vd"):
            raise ValueError(f"fp_layout {self.fp_layout!r}")


def probe_tree_power(tnf, probe_nodes: int = 2000,
                     probe_timeout_s: float = 0.5):
    """Root-tree size probe for EPS auto-splitting: run the sequential
    oracle briefly; if it exhausts the whole tree in N nodes, return
    ceil(log2(N))+1, else None (use the factor split).

    The oracle's search runs in native code (``tree_probe.py``), node for
    node; the numpy oracle runs only where that library cannot be built
    or loaded, said once on stderr while tracing is on (the CLI's
    ``-v``). Inside span ``init.probe``, with counters ``probe_nodes``,
    ``probe_exhaustive`` and ``probe_native`` (1: the native probe
    answered)."""
    from ..host.solver import oracle
    from . import tree_probe
    with trace.span("init.probe"):
        try:
            r = tree_probe.solve(tnf, timeout_s=probe_timeout_s,
                                 node_limit=probe_nodes)
            native = r is not None
            if not native:
                _say_fallback(tree_probe.load_error)
                st = oracle.solve(tnf, timeout_s=probe_timeout_s,
                                  node_limit=probe_nodes).stats
                r = tree_probe.Probe(st.nodes, st.exhaustive, st.fails,
                                     st.solutions, None)
        except Exception:
            return None
    trace.count("probe_native", int(native))
    trace.count("probe_nodes", r.nodes)
    trace.count("probe_exhaustive", int(r.exhaustive))
    if not r.exhaustive:
        return None
    return max(1, int(np.ceil(np.log2(max(2, r.nodes)))) + 1)


_said_fallback = False


def _say_fallback(why) -> None:
    global _said_fallback
    if trace.enabled() and not _said_fallback:
        _said_fallback = True
        print(f"% tree probe: native library unavailable ({why}); "
              f"running the numpy oracle", file=sys.stderr, flush=True)


def auto_max_depth(plan) -> int:
    """Decision-stack depth that provably covers the instance: per var,
    ceil(log2(w)) decisions under a halving value order, w-1 under
    indomain_min/max, charged by the first strategy that contains it;
    capped at the reference's MAX_SEARCH_DEPTH=10000."""
    from ..host.solver.plan import quantize
    lb0 = plan.lb0[:plan.n_active].astype(np.int64)
    ub0 = plan.ub0[:plan.n_active].astype(np.int64)
    w = ub0 - lb0 + 1
    cost = np.zeros(plan.n_active, dtype=np.int64)
    seen = np.zeros(plan.n_active, dtype=bool)
    for s in plan.strategies:
        if getattr(s, "is_eps", False):
            continue  # k <= 30 dive decisions, charged in the margin
        ids = np.asarray(s.ids, dtype=np.int64)
        ids = ids[ids < plan.n_active]
        ids = ids[~seen[ids]]
        if len(ids) == 0:
            continue
        ws = w[ids]
        if s.val_order in ("indomain_split", "indomain_reverse_split"):
            c = np.ceil(np.log2(np.clip(ws, 2, None))).astype(np.int64)
        else:
            c = np.minimum(ws - 1, 10000)
        cost[ids] = np.where(ws > 1, c, 0)
        seen[ids] = True
    bits = int(cost.sum())
    return int(min(10000, max(128, quantize(bits + 38))))


def choose_subproblems_power(tnf, config, num_shards: int,
                             allow_probe: bool = True) -> int:
    """EPS split size 2^k: pinned -sub, or the occupancy-factor default
    capped by a dive-work budget (TURBO_TPU_DIVE_BUDGET lockstep steps
    per lane), by ~2^TURBO_TPU_REFILL_BITS refills per lane, and by the
    root-tree probe."""
    D = config.num_dives
    k = config.subproblems_power
    if k <= 0:
        total = max(1, config.subproblems_factor * D * num_shards)
        k = max(1, int(np.ceil(np.log2(total))))
        budget = int(os.environ.get("TURBO_TPU_DIVE_BUDGET", "1500"))
        kb = 1
        while kb < 30 and ((1 << (kb + 1)) * (kb + 1)) // max(D * num_shards, 1) <= budget:
            kb += 1
        k = min(k, kb)
        refill_bits = int(os.environ.get("TURBO_TPU_REFILL_BITS", "2"))
        kr = int(np.ceil(np.log2(max(1, D * num_shards)))) + refill_bits
        k = min(k, max(kr, 1))
        if not config.enumerate_all and allow_probe:
            kp = probe_tree_power(tnf)
            if kp is not None:
                k = min(k, kp)
    # Every shard must own a non-empty subproblem range.
    k = max(k, int(np.ceil(np.log2(max(1, num_shards)))))
    return min(k, 30)


def apply_strategy_config(plan, cfg) -> bool:
    """Seed-shuffle 'random' strategies and prepend the EPS dive
    strategy (common_solving.hpp:631-667). Returns whether an EPS
    strategy was prepended."""
    from ..host.solver.plan import PlanStrategy
    rng = np.random.default_rng(cfg.seed)
    for st in plan.strategies:
        if st.var_order == "random":
            ids = st.ids.copy()
            rng.shuffle(ids)
            st.ids = ids
            st.var_order = "input_order"
    has_eps = cfg.eps_var_order != "default"
    if has_eps:
        base = plan.strategies[-1]  # default whole-store strategy
        eps = PlanStrategy(cfg.eps_var_order,
                           cfg.eps_value_order
                           if cfg.eps_value_order != "default"
                           else "indomain_min",
                           base.ids.copy())
        eps.is_eps = True
        plan.strategies.insert(0, eps)
        # Re-pad the strategy list to a power of two.
        while len(plan.strategies) & (len(plan.strategies) - 1):
            plan.strategies.append(plan.strategies[-1])
    return has_eps
