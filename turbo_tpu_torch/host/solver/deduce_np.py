"""Vectorized numpy interval deduction/entailment rules for TNF bytecodes.

This is the semantics oracle for the JAX/TPU engine: the same bounds-
consistency rules the reference's PIR domain implements in CUDA
(`deduce(i)` / `ask(i)` usage at common_solving.hpp:738-771), written
as numpy array ops over whole op-groups.  The TPU engine in
`turbo_tpu.solver.propagate` mirrors these rules; tests cross-check the
two on random stores.
"""
from __future__ import annotations

import numpy as np

from ..core.ops import INF, NINF, OP_ADD, OP_DIV, OP_EQ, OP_LE, OP_MAX, OP_MIN, OP_MUL


def tdiv(a, b):
    """Truncated (toward zero) integer division, numpy int64."""
    q = np.floor_divide(a, b)
    r = a - q * b
    fix = (r != 0) & ((a < 0) != (b < 0))
    return q + fix


def _clamp(lo, hi):
    return np.clip(lo, NINF, INF), np.clip(hi, NINF, INF)


def deduce(op: int, lx, ux, ly, uy, lz, uz):
    """Candidate bounds for each role of `x = y op z`.

    Returns (cxl, cxu, cyl, cyu, czl, czu) — each a sound candidate
    interval to be intersected (meet) with the current domain.  Inputs
    and outputs are int64 arrays.
    """
    ninf = np.full_like(lx, NINF)
    pinf = np.full_like(lx, INF)
    if op == OP_ADD:
        cxl, cxu = ly + lz, uy + uz
        cyl, cyu = lx - uz, ux - lz
        czl, czu = lx - uy, ux - ly
    elif op == OP_MUL:
        p1, p2, p3, p4 = ly * lz, ly * uz, uy * lz, uy * uz
        cxl = np.minimum(np.minimum(p1, p2), np.minimum(p3, p4))
        cxu = np.maximum(np.maximum(p1, p2), np.maximum(p3, p4))
        cyl, cyu = _inv_mul(lx, ux, lz, uz, ninf, pinf)
        czl, czu = _inv_mul(lx, ux, ly, uy, ninf, pinf)
    elif op == OP_DIV:
        cxl, cxu = _fwd_div(ly, uy, lz, uz, ninf, pinf)
        # y in x*z expanded by the max remainder magnitude.
        mz = np.maximum(np.abs(lz), np.abs(uz))
        p1, p2, p3, p4 = lx * lz, lx * uz, ux * lz, ux * uz
        cyl = np.minimum(np.minimum(p1, p2), np.minimum(p3, p4)) - np.maximum(mz - 1, 0)
        cyu = np.maximum(np.maximum(p1, p2), np.maximum(p3, p4)) + np.maximum(mz - 1, 0)
        czl, czu = ninf, pinf
        # z = [0,0] -> division by zero -> fail via empty x candidate.
        zzero = (lz == 0) & (uz == 0)
        cxl = np.where(zzero, pinf, cxl)
        cxu = np.where(zzero, ninf, cxu)
    elif op == OP_MIN:
        cxl = np.minimum(ly, lz)
        cxu = np.minimum(uy, uz)
        cyl = lx + 0
        cyu = np.where(lz > ux, ux, pinf)
        czl = lx + 0
        czu = np.where(ly > ux, ux, pinf)
    elif op == OP_MAX:
        cxl = np.maximum(ly, lz)
        cxu = np.maximum(uy, uz)
        cyu = ux + 0
        cyl = np.where(uz < lx, lx, ninf)
        czu = ux + 0
        czl = np.where(uy < lx, lx, ninf)
    elif op == OP_LE:
        cxl = (uy <= lz).astype(lx.dtype)
        cxu = 1 - (ly > uz).astype(lx.dtype)
        tt = lx >= 1
        ff = ux <= 0
        cyl = np.where(ff, lz + 1, ninf)
        cyu = np.where(tt, uz, pinf)
        czl = np.where(tt, ly, ninf)
        czu = np.where(ff, uy - 1, pinf)
    elif op == OP_EQ:
        cxl = ((ly == uy) & (uy == lz) & (lz == uz)).astype(lx.dtype)
        cxu = (np.maximum(ly, lz) <= np.minimum(uy, uz)).astype(lx.dtype)
        tt = lx >= 1
        ff = ux <= 0
        zsing = lz == uz
        ysing = ly == uy
        cyl = np.where(tt, lz, np.where(ff & zsing & (lz == ly), ly + 1, ninf))
        cyu = np.where(tt, uz, np.where(ff & zsing & (lz == uy), uy - 1, pinf))
        czl = np.where(tt, ly, np.where(ff & ysing & (ly == lz), lz + 1, ninf))
        czu = np.where(tt, uy, np.where(ff & ysing & (ly == uz), uz - 1, pinf))
    else:
        raise ValueError(op)
    cxl, cxu = _clamp(cxl, cxu)
    cyl, cyu = _clamp(cyl, cyu)
    czl, czu = _clamp(czl, czu)
    return cxl, cxu, cyl, cyu, czl, czu


def _inv_mul(la, ua, lb, ub, ninf, pinf):
    """Hull of a/b (rational, rounded inward) for x=y*z inversion.
    No pruning when 0 in [lb,ub]."""
    has0 = (lb <= 0) & (ub >= 0)
    sb = np.where(lb == 0, 1, lb)  # avoid div-by-zero; masked out anyway
    tb = np.where(ub == 0, -1, ub)
    corners = []
    for a in (la, ua):
        for b in (sb, tb):
            corners.append((np.floor_divide(a, b), -np.floor_divide(-a, b)))
    lo = np.minimum.reduce([c[1] for c in corners])  # ceil corners -> min
    hi = np.maximum.reduce([c[0] for c in corners])  # floor corners -> max
    return np.where(has0, ninf, lo), np.where(has0, pinf, hi)


def _fwd_div(ly, uy, lz, uz, ninf, pinf):
    """Hull of trunc(y/z) over z != 0 in [lz, uz]."""
    lo = pinf.copy()
    hi = ninf.copy()
    # Negative part [lz, min(uz,-1)], positive part [max(lz,1), uz].
    for plo, phi, valid in (
        (lz, np.minimum(uz, -1), lz <= -1),
        (np.maximum(lz, 1), uz, uz >= 1),
    ):
        plo_s = np.where(valid, plo, 1)
        phi_s = np.where(valid, phi, 1)
        for a in (ly, uy):
            for zc in (plo_s, phi_s):
                q = tdiv(a, zc)
                lo = np.where(valid, np.minimum(lo, q), lo)
                hi = np.where(valid, np.maximum(hi, q), hi)
    return lo, hi


def ask(op: int, lx, ux, ly, uy, lz, uz):
    """Entailment: constraint holds for every assignment in the domains."""
    sing = (lx == ux) & (ly == uy) & (lz == uz)
    if op == OP_ADD:
        return sing & (lx == ly + lz)
    if op == OP_MUL:
        return sing & (lx == ly * lz)
    if op == OP_DIV:
        return sing & (lz != 0) & (lx == tdiv(ly, np.where(lz == 0, 1, lz)))
    if op == OP_MIN:
        return sing & (lx == np.minimum(ly, lz))
    if op == OP_MAX:
        return sing & (lx == np.maximum(ly, lz))
    if op == OP_LE:
        return ((lx >= 1) & (uy <= lz)) | ((ux <= 0) & (ly > uz))
    if op == OP_EQ:
        return ((lx >= 1) & (ly == uy) & (lz == uz) & (ly == lz)) | \
               ((ux <= 0) & ((uy < lz) | (ly > uz)))
    raise ValueError(op)
