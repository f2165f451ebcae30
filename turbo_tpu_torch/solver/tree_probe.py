"""The root-tree size probe of EPS auto-splitting in native code.

``solve(tnf, timeout_s, node_limit)`` runs the numpy oracle's depth-first
branch-and-bound (``host/solver/oracle.py`` ``solve``) node for node in
``csrc/tree_probe.cpp``, on the tables of the oracle's own ``PropTable``,
and returns the ``Probe`` counts the oracle's statistics would hold:
nodes, exhaustive, fails, solutions and the last solution's objective.
The library is built with g++ into
``kernels/_build/libtree_probe_<hash>.so``, keyed by a hash of the source
and the flags (a file of this process renamed into place), and loaded
through ``ctypes``: by ``kernels.build.load()`` before any request on
the card, at first use on the CPU. Where it cannot be built or loaded,
``solve`` returns None and ``config.probe_tree_power`` runs the oracle.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import subprocess
import time
from typing import Optional

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "tree_probe.cpp"
BUILD_DIR = SRC.parents[2] / "kernels" / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
load_error: Optional[str] = None  # why the library is unavailable


@dataclasses.dataclass
class Probe:
    nodes: int
    exhaustive: bool
    fails: int
    solutions: int
    best: Optional[int]  # lb of the objective in the last solution


_P = ctypes.POINTER(ctypes.c_int64)
_I = ctypes.c_int64
# Mirror of struct ProbeIn (csrc/tree_probe.cpp), field for field.
_IN_FIELDS = (
    ("V", _I), ("lb0", _P), ("ub0", _P),
    ("P", _I), ("xs", _P), ("ys", _P), ("zs", _P),
    ("G", _I), ("g_op", _P), ("g_lo", _P), ("g_hi", _P),
    ("E", _I), ("T", _I), ("e_idx", _P), ("e_res", _P), ("e_len", _P),
    ("e_tab", _P),
    ("M", _I), ("W", _I), ("m_x", _P), ("m_b", _P), ("m_base", _P),
    ("m_top", _P), ("m_cnt", _P), ("m_next_ge", _P), ("m_prev_le", _P),
    ("m_next_out", _P), ("m_prev_out", _P),
    ("L", _I), ("K", _I), ("l_b", _P), ("l_op", _P), ("l_rhs", _P),
    ("l_coef", _P), ("l_var", _P),
    ("S", _I), ("s_vo", _P), ("s_valo", _P), ("s_off", _P), ("s_len", _P),
    ("s_ids", _P),
    ("obj_var", _I), ("timeout_s", ctypes.c_double), ("node_limit", _I),
)


class _ProbeIn(ctypes.Structure):
    _fields_ = _IN_FIELDS


class _ProbeOut(ctypes.Structure):
    _fields_ = [(n, _I) for n in
                ("nodes", "exhaustive", "fails", "solutions", "best")]


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libtree_probe_{h.hexdigest()[:16]}.so"


def load():
    """Builds (once per source hash) and loads the library; None, with
    the reason in ``load_error``, when it cannot."""
    global _lib, load_error
    if _lib is not None or load_error is not None:
        return _lib
    out = library_path()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # A file of this process renamed into place: two processes
            # starting cold at once never load a half-written library.
            subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.CalledProcessError) as e:
        load_error = (f"{e}: {e.stderr.strip()}"
                      if isinstance(e, subprocess.CalledProcessError)
                      else str(e))
        return None
    finally:
        tmp.unlink(missing_ok=True)
    lib.tp_probe.argtypes = [ctypes.POINTER(_ProbeIn),
                             ctypes.POINTER(_ProbeOut)]
    lib.tp_probe.restype = ctypes.c_int
    _lib = lib
    return lib


def _arr(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def solve(tnf, timeout_s: float, node_limit: int) -> Optional[Probe]:
    """``oracle.solve(tnf, timeout_s=timeout_s, node_limit=node_limit)``'s
    counts, in native code; None when the library is unavailable."""
    from ..host.solver import strategy
    from ..host.solver.oracle import PropTable

    lib = load()
    if lib is None:
        return None
    t0 = time.monotonic()
    if tnf.root_unsat:
        return Probe(0, True, 0, 0, None)
    t = PropTable(tnf)
    keep = []  # every array the native call reads, alive until it returns

    def ptr(a):
        a = _arr(a)
        keep.append(a)
        return a.ctypes.data_as(_P)

    f = {"V": tnf.num_vars, "lb0": ptr(tnf.lb0), "ub0": ptr(tnf.ub0),
         "P": t.num_props, "xs": ptr(t.xs), "ys": ptr(t.ys),
         "zs": ptr(t.zs), "G": len(t.groups),
         "g_op": ptr([op for op, _ in t.groups]),
         "g_lo": ptr([sl.start for _, sl in t.groups]),
         "g_hi": ptr([sl.stop for _, sl in t.groups]),
         "E": t.E, "M": t.M, "L": t.L}
    if t.E:
        f.update(T=t.e_tab.shape[1], e_idx=ptr(t.e_idx),
                 e_res=ptr(t.e_res), e_len=ptr(t.e_len),
                 e_tab=ptr(t.e_tab))
    if t.M:
        f.update(W=t.m_W, **{k: ptr(getattr(t, k)) for k in (
            "m_x", "m_b", "m_base", "m_top", "m_cnt", "m_next_ge",
            "m_prev_le", "m_next_out", "m_prev_out")})
    if t.L:
        f.update(K=t.l_coef.shape[1], l_b=ptr(t.l_b), l_op=ptr(t.l_op),
                 l_rhs=ptr(t.l_rhs), l_coef=ptr(t.l_coef),
                 l_var=ptr(t.l_var))
    offs, lens, ids = [], [], []
    for s in tnf.strategies:
        offs.append(sum(map(len, ids)))
        lens.append(-1 if s.var_ids is None else len(s.var_ids))
        if s.var_ids is not None:
            ids.append(np.asarray(s.var_ids, dtype=np.int64))
    f.update(S=len(tnf.strategies),
             s_vo=ptr([strategy.VO_CODE.get(s.var_order, 0)
                       for s in tnf.strategies]),
             s_valo=ptr([strategy.VALO_CODE.get(s.val_order, 0)
                         for s in tnf.strategies]),
             s_off=ptr(offs), s_len=ptr(lens),
             s_ids=ptr(np.concatenate(ids + [np.zeros(1, np.int64)])),
             obj_var=tnf.obj_var, node_limit=node_limit,
             # The oracle's wall counts from its call, its table included.
             timeout_s=timeout_s - (time.monotonic() - t0))
    out = _ProbeOut()
    if lib.tp_probe(ctypes.byref(_ProbeIn(**f)), ctypes.byref(out)) != 0:
        raise MemoryError("tree probe: out of memory")
    return Probe(int(out.nodes), bool(out.exhaustive), int(out.fails),
                 int(out.solutions), int(out.best) if out.solutions
                 and tnf.obj_var >= 0 else None)
