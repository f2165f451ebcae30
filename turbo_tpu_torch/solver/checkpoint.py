"""Cross-run checkpoint/resume of the batched search state.

Port of ``turbo_tpu/solver/checkpoint.py`` with its file format: a pickle
of the state as numpy arrays keyed by field name, guarded by the format
version, the plan's shape signature and data digest, ``num_dives``,
``max_depth``, the shard count, the EPS split and the table mode. A file
the JAX package wrote loads here into an equal state, and the other way
round: the fields only the JAX state carries (``obj``, ``is_opt``,
``fp_cap``) are written as it would write them and ignored on load; the
resuming run's fixpoint cap wins (the cap is a host integer that
``solve`` owns).

A multi-host run (``parallel/multihost.py``) keeps one file per process,
``host_path(path, pid)``, each holding that process's local shards and
their count.
"""
from __future__ import annotations

import os
import pickle
import sys
from typing import Optional

import numpy as np

from .convert import search_state_from_numpy, search_state_to_numpy

# v2: the state gained ext_bound; v3: fp_cap; v4: the payload gained
# data_digest (shapes alone cannot tell two plans apart when only plan
# data differs, and resuming lane state against different root bounds
# would remap subproblem bit-paths to other subtrees); v5: the state
# gained the EPS subproblem-root table (tab_*), the payload num_sub_total
# (k pins the table shape and the bit-path space) and `extras` (the
# resplit/steal accounting freeze: a resumed run keeps reporting coarse
# 2^k subproblem units).
FORMAT_VERSION = 5


def host_path(path: str, pid: int) -> str:
    """Process ``pid``'s checkpoint file of a multi-host run."""
    return f"{path}.h{pid}"


def save_state(solver, st, path: str, num_shards: int = 1,
               extras: Optional[dict] = None):
    host = search_state_to_numpy(st)
    D = len(host["phase"])  # every lane of every shard
    host["obj"] = np.full(D, solver.dp.obj, dtype=np.int32)
    host["is_opt"] = np.full(D, solver.dp.is_opt, dtype=bool)
    host["fp_cap"] = np.full(D, solver.cfg.fp_max_iters, dtype=np.int32)
    payload = {
        "format": FORMAT_VERSION,
        "shape_signature": solver.plan.shape_signature,
        "data_digest": solver.plan.data_digest,
        "num_dives": solver.cfg.num_dives,
        "max_depth": solver.cfg.max_depth,
        "num_shards": num_shards,
        "num_sub_total": solver.num_sub_total,
        "use_table": solver.use_table,
        "state": host,
        "extras": dict(extras or {}),
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_state(solver, path: str, num_shards: int = 1):
    """Returns (restored state on the solver's device, extras dict), or
    None on any mismatch."""

    def _reject(why):
        # A rejected checkpoint that silently restarted a long proof from
        # scratch (and then overwrote the file) would be hours lost with
        # no trace: always say why.
        print(f"% warning: checkpoint {path} ignored ({why}); "
              f"starting fresh", file=sys.stderr, flush=True)
        return None

    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            payload = pickle.load(f)
        if payload.get("format") != FORMAT_VERSION:
            return _reject(f"format {payload.get('format')} != "
                           f"{FORMAT_VERSION}")
        if payload["shape_signature"] != solver.plan.shape_signature:
            return _reject("different instance/plan shapes")
        if payload["data_digest"] != solver.plan.data_digest:
            return _reject("same shapes but different plan data "
                           "(instance content or presolve flags differ)")
        if payload["num_dives"] != solver.cfg.num_dives or \
                payload["max_depth"] != solver.cfg.max_depth:
            return _reject("different num_dives/max_depth config")
        if payload.get("num_shards", 1) != num_shards:
            return _reject("different shard count")
        if payload.get("num_sub_total") != solver.num_sub_total:
            return _reject("different EPS split (2^k)")
        if payload.get("use_table") != solver.use_table:
            return _reject("different table mode")
        fields = {k: np.asarray(v) for k, v in payload["state"].items()}
        st = search_state_from_numpy(fields, solver.device)
        return st, dict(payload.get("extras", {}))
    except Exception as e:
        return _reject(f"{type(e).__name__}: {e}")
