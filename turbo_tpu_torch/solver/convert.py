"""Carry the JAX package's data across: plan tables and search states.

``DevicePlan`` is the plan of ``solver/plan.py`` as a frozen bundle of
tensors on one ``torch.device``: the tables ``PropagatorKernels.__init__``
of ``turbo_tpu/solver/propagate_jax.py`` builds (gather mode ``take``
only), plus the strategy tables of ``BatchedSolver``. With it both
packages compute on the same data, the way a model port carries weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..host.solver.strategy import VALO_CODE, VO_CODE

I32 = torch.int32
I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class LinBucket:
    b: torch.Tensor      # (C,) int64 reified var
    op: torch.Tensor     # (C,) int32 (1 = eq, 0 = le)
    rhs: torch.Tensor    # (C,) int32 when fit32 (clipped to +-2^30), else int64
    coef: torch.Tensor   # (C, K) int32
    var: torch.Tensor    # (C, K) int64
    unit: bool           # every coefficient in {-1, 0, 1}
    fit32: bool          # the root box proves int32 arithmetic exact


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    device: torch.device
    V: int
    n_active: int
    P: int
    n_cand: int                       # candidate slots incl. the neutral one
    num_real_props: int
    obj: int
    is_opt: bool
    lb0: torch.Tensor                 # (V,) int32
    ub0: torch.Tensor
    lb_floor: torch.Tensor            # lb0 - 1: ub clamp floor
    ub_cap: torch.Tensor              # ub0 + 1: lb clamp ceiling
    all_x: torch.Tensor               # (P,) int64, group order
    all_y: torch.Tensor
    all_z: torch.Tensor
    prop_op: torch.Tensor             # (P,) int32 op code per propagator
    group_slices: Tuple[Tuple[int, int, int], ...]   # (op, start, end)
    buckets: Tuple[Tuple[int, int, torch.Tensor], ...]  # (start, count, idx (count, K))
    conf_idx: Optional[torch.Tensor]  # (T,) int64 candidate slots
    conf_off: Optional[torch.Tensor]  # (T,) int32 fixed values
    lin: Tuple[LinBucket, ...]
    E: int
    e_idx: torch.Tensor               # (E,) int64
    e_res: torch.Tensor
    e_len: torch.Tensor               # (E,) int32
    e_tab: torch.Tensor               # (E, T) int32
    M: int
    m_W: int
    m_x: torch.Tensor                 # (M,) int64
    m_b: torch.Tensor
    m_base: torch.Tensor              # (M,) int32
    m_top: torch.Tensor
    m_cnt_flat: torch.Tensor          # (M * (W + 1),) int32
    m_cnt_offs: torch.Tensor          # (M,) int32
    m_offs: torch.Tensor              # (M,) int32
    m_next_ge: torch.Tensor           # (M * W,) int32
    m_prev_le: torch.Tensor
    m_next_out: torch.Tensor
    m_prev_out: torch.Tensor
    strat_ids: Tuple[torch.Tensor, ...]  # per strategy (n_s,) int64
    strat_vo: Tuple[int, ...]
    strat_valo: Tuple[int, ...]
    strat_alias: Tuple[int, ...]      # first strategy that is the same object

    @classmethod
    def from_plan(cls, plan, device) -> "DevicePlan":
        device = torch.device(device)

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        groups = plan.groups
        if groups:
            all_x = np.concatenate([g[1] for g in groups])
            all_y = np.concatenate([g[2] for g in groups])
            all_z = np.concatenate([g[3] for g in groups])
            prop_op = np.concatenate([np.full(len(g[1]), g[0]) for g in groups])
        else:
            all_x = all_y = all_z = prop_op = np.zeros(0, dtype=np.int32)
        slices, base = [], 0
        for op, xs, _, _ in groups:
            slices.append((int(op), base, base + len(xs)))
            base += len(xs)
        lb0 = plan.lb0.astype(np.int64)
        ub0 = plan.ub0.astype(np.int64)
        vmax = np.maximum(np.abs(lb0), np.abs(ub0)) + 1
        lin = []
        for l_b, l_op, l_rhs, l_coef, l_var in plan.lin_buckets:
            # Same int32 fit analysis as PropagatorKernels.__init__.
            tb = np.abs(l_coef.astype(np.int64)) * vmax[l_var]
            r_bound = (np.abs(l_rhs.astype(np.int64)) + 1 + tb.sum(axis=1)
                       + tb.max(axis=1, initial=0))
            live_row = (l_coef != 0).any(axis=1)
            fit = bool((r_bound[live_row] < (1 << 30)).all())
            rhs = (t(np.clip(l_rhs, -(1 << 30), 1 << 30), I32) if fit
                   else t(l_rhs, I64))
            lin.append(LinBucket(t(l_b, I64), t(l_op, I32), rhs,
                                 t(l_coef, I32), t(l_var, I64),
                                 bool(np.all(np.abs(l_coef) <= 1)), fit))
        L_terms = sum(b[3].shape[0] * b[3].shape[1] for b in plan.lin_buckets)
        L_rows = sum(len(b[0]) for b in plan.lin_buckets)
        M, W = plan.m_cnt.shape[0], plan.m_cnt.shape[1] - 1
        first = {}
        alias = tuple(first.setdefault(id(s), i)
                      for i, s in enumerate(plan.strategies))
        return cls(
            device=device, V=plan.V, n_active=plan.n_active, P=plan.P,
            n_cand=3 * plan.P + 2 * plan.E + 2 * plan.M + L_terms + L_rows + 1,
            num_real_props=plan.num_real_props, obj=int(plan.obj),
            is_opt=bool(plan.is_opt),
            lb0=t(plan.lb0, I32), ub0=t(plan.ub0, I32),
            lb_floor=t(plan.lb0, I32) - 1, ub_cap=t(plan.ub0, I32) + 1,
            all_x=t(all_x, I64), all_y=t(all_y, I64), all_z=t(all_z, I64),
            prop_op=t(prop_op, I32), group_slices=tuple(slices),
            buckets=tuple((b.start, b.count, t(b.cand_idx, I64))
                          for b in plan.buckets),
            conf_idx=(t(plan.conf_idx, I64) if plan.conf_idx is not None
                      else None),
            conf_off=(t(plan.conf_off, I32) if plan.conf_idx is not None
                      else None),
            lin=tuple(lin),
            E=plan.E, e_idx=t(plan.e_idx, I64), e_res=t(plan.e_res, I64),
            e_len=t(plan.e_len, I32), e_tab=t(plan.e_tab, I32),
            M=M, m_W=W, m_x=t(plan.m_x, I64), m_b=t(plan.m_b, I64),
            m_base=t(plan.m_base, I32), m_top=t(plan.m_top, I32),
            m_cnt_flat=t(plan.m_cnt.reshape(-1), I32),
            m_cnt_offs=t(np.arange(M) * (W + 1), I32),
            m_offs=t(np.arange(M) * W, I32),
            m_next_ge=t(plan.m_next_ge.reshape(-1), I32),
            m_prev_le=t(plan.m_prev_le.reshape(-1), I32),
            m_next_out=t(plan.m_next_out.reshape(-1), I32),
            m_prev_out=t(plan.m_prev_out.reshape(-1), I32),
            strat_ids=tuple(t(s.ids, I64) for s in plan.strategies),
            strat_vo=tuple(VO_CODE.get(s.var_order, 0) for s in plan.strategies),
            strat_valo=tuple(VALO_CODE.get(s.val_order, 0)
                             for s in plan.strategies),
            strat_alias=alias)


def search_state_from_numpy(fields: dict, device):
    """Build the port's ``SearchState`` from numpy arrays keyed by field
    name (for example a JAX ``SearchState`` read with ``jax.device_get``
    and ``._asdict()``). Fields the port does not carry are ignored."""
    from .engine import SearchState
    return SearchState(**{
        f.name: torch.from_numpy(np.array(fields[f.name])).to(device)
        for f in dataclasses.fields(SearchState)})


def search_state_to_numpy(st) -> dict:
    """The port's state as a dict of numpy arrays keyed by field name."""
    return {f.name: getattr(st, f.name).cpu().numpy()
            for f in dataclasses.fields(st)}
