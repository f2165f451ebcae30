"""ctypes bridge to the native C++ FlatZinc frontend (host/native/fzn_parser.cpp).

Compiles the shared library on first use (g++ available in the image;
pybind11 is not, so the ABI is plain C driven through ctypes). Items
the native fast path does not cover (solve items, par declarations,
nested call expressions) are returned as byte spans and re-parsed by
the Python parser — both paths produce the same Model AST.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import List, Optional

import numpy as np

from .ast import ArrayDecl, Constraint, Model, Range, SetLit, VarDecl

_HOST = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_HOST, "native", "fzn_parser.cpp")
_SO = os.path.join(_HOST, "native", "build", "libfznparser.so")

_lib = None
_FIELDS = [
    "name_offs", "var_name", "var_flags", "var_lb", "var_ub",
    "var_sparse_off", "var_sparse_len", "sparse_pool", "var_alias_kind",
    "var_alias_val", "arr_name", "arr_flags", "arr_lo", "arr_hi",
    "arr_type_lb", "arr_type_ub", "arr_type_has", "arr_dims_off",
    "arr_dims_len", "dims_pool", "arr_elem_off", "arr_elem_len",
    "elem_pool", "con_name", "con_arg_off", "con_arg_len", "con_defines",
    "arg_nodes", "set_pool", "complex_spans",
]


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or \
            os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        # Build to a file of this process and rename it into place: two
        # processes starting cold at once must never load a half-written
        # library.
        tmp = f"{_SO}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                 "-o", tmp, _SRC],
                check=True, capture_output=True)
            os.replace(tmp, _SO)
        except Exception as e:
            print(f"% native fzn parser unavailable ({e}); using Python "
                  f"parser", file=sys.stderr)
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(_SO)
    lib.fzn_parse.restype = ctypes.c_void_p
    lib.fzn_parse.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.fzn_free.argtypes = [ctypes.c_void_p]
    lib.fzn_names.restype = ctypes.POINTER(ctypes.c_char)
    lib.fzn_names.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_longlong)]
    for f in _FIELDS:
        fn = getattr(lib, f"fzn_{f}")
        fn.restype = ctypes.POINTER(ctypes.c_int64)
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
    _lib = lib
    return lib


def _vec(lib, h, name) -> np.ndarray:
    n = ctypes.c_longlong()
    ptr = getattr(lib, f"fzn_{name}")(h, ctypes.byref(n))
    if n.value == 0:
        return np.zeros(0, dtype=np.int64)
    return np.ctypeslib.as_array(ptr, shape=(n.value,)).copy()


AK_INT, AK_IDENT, AK_RANGE, AK_SET, AK_LIST, AK_ACCESS = range(6)


def parse_fzn_native(text: str, path: str = "") -> Optional[Model]:
    """Parse with the native frontend; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    data = text.encode()
    h = lib.fzn_parse(data, len(data))
    try:
        return _build_model(lib, h, text, path)
    finally:
        lib.fzn_free(h)


def _build_model(lib, h, text: str, path: str) -> Model:
    v = {f: _vec(lib, h, f) for f in _FIELDS}
    nlen = ctypes.c_longlong()
    nptr = lib.fzn_names(h, ctypes.byref(nlen))
    name_bytes = ctypes.string_at(nptr, nlen.value)
    offs = v["name_offs"]
    names = [name_bytes[offs[i]:offs[i + 1]].decode()
             for i in range(len(offs) - 1)]

    variables: List[VarDecl] = []
    flags = v["var_flags"]
    for i in range(len(v["var_name"])):
        f = int(flags[i])
        has_bounds = bool(f & 16)
        sp = None
        if v["var_sparse_off"][i] >= 0 and v["var_sparse_len"][i] > 0:
            o, l = int(v["var_sparse_off"][i]), int(v["var_sparse_len"][i])
            sp = tuple(int(x) for x in v["sparse_pool"][o:o + l])
        alias = None
        if v["var_alias_kind"][i] == 1:
            alias = int(v["var_alias_val"][i])
        elif v["var_alias_kind"][i] == 2:
            alias = names[int(v["var_alias_val"][i])]
        variables.append(VarDecl(
            names[int(v["var_name"][i])], bool(f & 1),
            int(v["var_lb"][i]) if has_bounds else None,
            int(v["var_ub"][i]) if has_bounds else None,
            sp, output_var=bool(f & 2), introduced=bool(f & 4),
            defined=bool(f & 8), alias=alias))

    def decode_elems(off, count):
        ep = v["elem_pool"]
        out = []
        for j in range(count):
            k, val = int(ep[off + 2 * j]), int(ep[off + 2 * j + 1])
            out.append(val if k == 0 else names[val])
        return out

    arrays: List[ArrayDecl] = []
    for i in range(len(v["arr_name"])):
        f = int(v["arr_flags"][i])
        lo, hi = int(v["arr_lo"][i]), int(v["arr_hi"][i])
        name = names[int(v["arr_name"][i])]
        dims = None
        if f & 4:
            o, dl = int(v["arr_dims_off"][i]), int(v["arr_dims_len"][i])
            dp = v["dims_pool"]
            dims = [(int(dp[o + 2 * j]), int(dp[o + 2 * j + 1]))
                    for j in range(dl)]
        eo = int(v["arr_elem_off"][i])
        if eo == -2:
            # Unassigned var array: synthesize fresh variables.
            elems = []
            is_bool = bool(f & 1)
            has_t = bool(v["arr_type_has"][i])
            for j in range(lo, hi + 1):
                vn = f"{name}[{j}]"
                variables.append(VarDecl(
                    vn, is_bool,
                    int(v["arr_type_lb"][i]) if (has_t or is_bool) else None,
                    int(v["arr_type_ub"][i]) if (has_t or is_bool) else None,
                    None))
                elems.append(vn)
        else:
            elems = decode_elems(eo, int(v["arr_elem_len"][i]))
        arrays.append(ArrayDecl(name, elems, bool(f & 2), bool(f & 1), dims))

    an = v["arg_nodes"]

    def decode_arg(node):
        k = int(an[3 * node])
        a = int(an[3 * node + 1])
        b = int(an[3 * node + 2])
        if k == AK_INT:
            return a
        if k == AK_IDENT:
            return names[a]
        if k == AK_RANGE:
            return Range(a, b)
        if k == AK_SET:
            return SetLit(tuple(int(x) for x in v["set_pool"][a:a + b]))
        if k == AK_LIST:
            return decode_elems(a, b)
        if k == AK_ACCESS:
            return ("access", names[a], b)
        raise ValueError(k)

    constraints: List[Constraint] = []
    ep = v["elem_pool"]
    for i in range(len(v["con_name"])):
        off = int(v["con_arg_off"][i])
        cnt = int(v["con_arg_len"][i])
        args = [decode_arg(int(ep[off + 2 * j + 1])) for j in range(cnt)]
        d = int(v["con_defines"][i])
        constraints.append(Constraint(names[int(v["con_name"][i])], args,
                                      names[d] if d >= 0 else None))

    # Python fallback for items the fast path skipped (solve, par decls,
    # nested calls, set types...).
    from . import fzn as pyfzn

    solve = None
    spans = v["complex_spans"]
    for i in range(0, len(spans), 2):
        frag = text[int(spans[i]):int(spans[i + 1])].strip()
        if not frag:
            continue
        sub = pyfzn.parse_fzn_text(frag + ";\nsolve satisfy;", path) \
            if not frag.startswith("solve") else None
        if frag.startswith("solve"):
            m2 = pyfzn.parse_fzn_text(frag + ";", path)
            solve = m2.solve
        else:
            variables.extend(sub.vars)
            arrays.extend(sub.arrays)
            constraints.extend(sub.constraints)
    if solve is None:
        raise pyfzn.FznParseError("missing solve item")
    return Model(variables, arrays, constraints, solve, path)
