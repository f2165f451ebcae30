"""Single source of truth for branching-strategy semantics.

The reference implements variable/value ordering twice (CPU search and
GPU `split()`/`LightBranch`, barebones_dive_and_solve.hpp:186-384);
round 1 of this framework grew three hand-kept copies (numpy oracle,
batched jnp engine, hybrid host search) of the same tie-breaking rules.
This module is the one table both array libraries share: every function
takes the array namespace `xp` (numpy or jax.numpy) and pure
elementwise/broadcastable inputs, so the numpy and jnp variants are
generated from the same spec and cannot drift.

Semantics (mirroring the reference):
- variable order: the chosen var minimizes `split_key` over splittable
  vars; ties break on the smallest position in the strategy's variable
  list (np/jnp argmin both return the first minimum).
- value order: `children` yields the two child intervals, left child
  explored first (LightBranch, barebones:355-384).
"""
from __future__ import annotations

VO_CODE = {"input_order": 0, "first_fail": 1, "anti_first_fail": 2,
           "smallest": 3, "largest": 4}
VALO_CODE = {"indomain_min": 0, "indomain_max": 1, "indomain_split": 2,
             "indomain_reverse_split": 3}


def splittable(xp, l, u, ninf, inf):
    """A var can be branched on iff its interval is non-singleton and
    bounded (barebones:195-200)."""
    return (l < u) & (l > ninf) & (u < inf)


def split_key(xp, vo_code, pos_key, l, u):
    """Selection key minimized over splittable vars.

    vo_code may be a python int, a numpy scalar, or a traced jnp
    scalar; pos_key/l/u broadcastable arrays of one integer dtype
    (the caller picks a dtype whose max can serve as the masked-out
    sentinel)."""
    size = u - l
    return xp.select(
        [vo_code == 0, vo_code == 1, vo_code == 2, vo_code == 3],
        [pos_key, size, -size, l], -u)


def children(xp, valo_code, lo, hi):
    """LightBranch child intervals (c0l, c0u, c1l, c1u); the left child
    (c0) is explored first."""
    mid = lo + (hi - lo) // 2
    c0l = xp.select([valo_code == 0, valo_code == 1, valo_code == 2,
                     valo_code == 3], [lo, hi, lo, mid + 1])
    c0u = xp.select([valo_code == 0, valo_code == 1, valo_code == 2,
                     valo_code == 3], [lo, hi, mid, hi])
    c1l = xp.select([valo_code == 0, valo_code == 1, valo_code == 2,
                     valo_code == 3], [lo + 1, lo, mid + 1, lo])
    c1u = xp.select([valo_code == 0, valo_code == 1, valo_code == 2,
                     valo_code == 3], [hi, hi - 1, hi, mid])
    return c0l, c0u, c1l, c1u


def branch_children(val_order: str, lo: int, hi: int):
    """Scalar convenience wrapper for host-side search: two (lo, hi)
    child tuples, left explored first."""
    import numpy as np

    code = VALO_CODE.get(val_order, 0)
    c0l, c0u, c1l, c1u = children(np, code, np.int64(lo), np.int64(hi))
    return (int(c0l), int(c0u)), (int(c1l), int(c1u))
