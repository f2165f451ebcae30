"""FlatZinc parser.

Covers the FlatZinc surface exercised by the reference fixture corpus
(see the reference's benchmarks; builtin histogram in SURVEY.md §2a):
variable/array declarations (interval, sparse-set and bool domains),
parameter arrays, constraint items with ``defines_var`` annotations,
``output_var``/``output_array`` annotations, and solve items with
``int_search``/``bool_search``/``seq_search`` annotations.

The reference obtains the same information through lala-parsing's
``parse_flatzinc`` (common_solving.hpp:404-417); this is a from-scratch
Python implementation, item-oriented for speed on multi-MB files.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple, Union

from .ast import (
    ArrayDecl,
    Constraint,
    Model,
    Range,
    SearchAnnotation,
    SetLit,
    SolveItem,
    VarDecl,
)


class FznParseError(Exception):
    pass


_TOKEN_RE = re.compile(
    r"""
      (?P<num>-?\d+)
    | (?P<dots>\.\.)
    | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<sym>[\[\]{}(),:=])
    | (?P<ws>\s+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> List[Union[int, str]]:
    toks: List[Union[int, str]] = []
    pos = 0
    n = len(text)
    append = toks.append
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise FznParseError(f"bad token at: {text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        if kind == "num":
            append(int(m.group()))
        else:
            append(m.group())
    return toks


class _Toks:
    __slots__ = ("t", "i")

    def __init__(self, toks):
        self.t = toks
        self.i = 0

    def peek(self):
        return self.t[self.i] if self.i < len(self.t) else None

    def peek2(self):
        return self.t[self.i + 1] if self.i + 1 < len(self.t) else None

    def next(self):
        v = self.t[self.i]
        self.i += 1
        return v

    def expect(self, tok):
        v = self.next()
        if v != tok:
            raise FznParseError(f"expected {tok!r}, got {v!r} (context {self.t[max(0,self.i-4):self.i+4]})")
        return v

    def at_end(self):
        return self.i >= len(self.t)


def _parse_expr(ts: _Toks):
    """Parse one argument expression: literal, range, set, ident, or array."""
    tok = ts.peek()
    if isinstance(tok, int):
        ts.next()
        if ts.peek() == "..":
            ts.next()
            hi = ts.next()
            return Range(tok, hi)
        return tok
    if tok == "[":
        ts.next()
        elems = []
        if ts.peek() == "]":
            ts.next()
            return elems
        while True:
            elems.append(_parse_expr(ts))
            if ts.peek() == ",":
                ts.next()
                continue
            ts.expect("]")
            return elems
    if tok == "{":
        ts.next()
        vals = []
        while ts.peek() != "}":
            vals.append(ts.next())
            if ts.peek() == ",":
                ts.next()
        ts.next()
        return SetLit(tuple(vals))
    if tok == "true":
        ts.next()
        return 1
    if tok == "false":
        ts.next()
        return 0
    if isinstance(tok, str):
        ts.next()
        # Array access: name[i]
        if ts.peek() == "[":
            ts.next()
            idx = ts.next()
            ts.expect("]")
            return ("access", tok, idx)
        # Possible call syntax inside annotations: name(args...)
        if ts.peek() == "(":
            ts.next()
            args = []
            if ts.peek() != ")":
                while True:
                    args.append(_parse_expr(ts))
                    if ts.peek() == ",":
                        ts.next()
                        continue
                    break
            ts.expect(")")
            return ("call", tok, args)
        return tok
    raise FznParseError(f"unexpected token {tok!r}")


def _parse_annotations(ts: _Toks):
    anns = []
    while ts.peek() == ":" and ts.peek2() == ":":
        ts.next()
        ts.next()
        anns.append(_parse_expr(ts))
    return anns


def _parse_type(ts: _Toks):
    """Parse a var/par type after 'var' (or a par type). Returns
    (is_bool, lb, ub, sparse)."""
    tok = ts.peek()
    if tok == "bool":
        ts.next()
        return True, 0, 1, None
    if tok == "int":
        ts.next()
        return False, None, None, None
    if isinstance(tok, int):
        ts.next()
        ts.expect("..")
        hi = ts.next()
        return False, tok, hi, None
    if tok == "{":
        ts.next()
        vals = []
        while ts.peek() != "}":
            vals.append(ts.next())
            if ts.peek() == ",":
                ts.next()
        ts.next()
        vals = sorted(set(vals))
        return False, vals[0], vals[-1], tuple(vals)
    if tok == "set":
        # Set variables are compiled away by the reference's MiniZinc
        # library (`nosets.mzn`, benchmarks/minizinc/mzn-lib); native set
        # vars are unsupported there and here.
        raise FznParseError("set variables are not supported")
    raise FznParseError(f"unexpected type token {tok!r}")


_COMMENT_RE = re.compile(r"%[^\n]*")


def _split_items(text: str) -> List[str]:
    text = _COMMENT_RE.sub("", text)
    return [it.strip() for it in text.split(";") if it.strip()]


def _search_from_ann(ann, searches: List[SearchAnnotation]):
    """Extract SearchAnnotations from a solve annotation expression."""
    if not (isinstance(ann, tuple) and ann[0] == "call"):
        return
    name = ann[1]
    args = ann[2]
    if name in ("int_search", "bool_search"):
        vars_arg = args[0]
        if isinstance(vars_arg, str):
            vars_list = [vars_arg]  # array name, resolved later
        elif isinstance(vars_arg, list):
            vars_list = vars_arg
        else:
            vars_list = []
        var_order = args[1] if len(args) > 1 else "input_order"
        val_order = args[2] if len(args) > 2 else "indomain_min"
        searches.append(SearchAnnotation(vars_list, str(var_order), str(val_order)))
    elif name == "seq_search":
        inner = args[0]
        if isinstance(inner, list):
            for sub in inner:
                _search_from_ann(sub, searches)
        else:
            _search_from_ann(inner, searches)
    elif name in ("warm_start", "restart_none"):
        pass


def parse_fzn_text(text: str, path: str = "") -> Model:
    variables: List[VarDecl] = []
    arrays: List[ArrayDecl] = []
    constraints: List[Constraint] = []
    solve: Optional[SolveItem] = None

    for item in _split_items(text):
        if item.startswith("predicate"):
            continue
        ts = _Toks(_tokenize(item))
        head = ts.peek()
        if head == "constraint":
            ts.next()
            call = _parse_expr(ts)
            if not (isinstance(call, tuple) and call[0] == "call"):
                raise FznParseError(f"bad constraint item: {item[:80]}")
            anns = _parse_annotations(ts)
            defines = None
            for a in anns:
                if isinstance(a, tuple) and a[0] == "call" and a[1] == "defines_var":
                    tgt = a[2][0]
                    if isinstance(tgt, str):
                        defines = tgt
            constraints.append(Constraint(call[1], call[2], defines))
        elif head == "solve":
            ts.next()
            anns = _parse_annotations(ts)
            searches: List[SearchAnnotation] = []
            for a in anns:
                _search_from_ann(a, searches)
            kind = ts.next()
            if kind == "satisfy":
                solve = SolveItem("satisfy", None, searches)
            elif kind in ("minimize", "maximize"):
                obj = _parse_expr(ts)
                solve = SolveItem(kind, obj, searches)
            else:
                raise FznParseError(f"bad solve item: {item[:80]}")
        elif head == "var":
            ts.next()
            is_bool, lb, ub, sparse = _parse_type(ts)
            ts.expect(":")
            name = ts.next()
            anns = _parse_annotations(ts)
            alias = None
            if not ts.at_end():
                ts.expect("=")
                rhs = _parse_expr(ts)
                if isinstance(rhs, (int, str)):
                    alias = rhs
                else:
                    raise FznParseError(f"unsupported var RHS: {item[:80]}")
            vd = VarDecl(name, is_bool, lb, ub, sparse, alias=alias)
            _apply_var_anns(vd, anns)
            variables.append(vd)
        elif head == "array":
            ts.next()
            ts.expect("[")
            lo = ts.next()
            ts.expect("..")
            hi = ts.next()
            ts.expect("]")
            ts.expect("of")
            is_var = False
            if ts.peek() == "var":
                ts.next()
                is_var = True
            is_bool, tlb, tub, tsparse = _parse_type(ts)
            ts.expect(":")
            name = ts.next()
            anns = _parse_annotations(ts)
            output_dims = None
            for a in anns:
                if isinstance(a, tuple) and a[0] == "call" and a[1] == "output_array":
                    dims_arg = a[2][0]
                    output_dims = []
                    for d in dims_arg:
                        if isinstance(d, Range):
                            output_dims.append((d.lo, d.hi))
            elems: List[Union[int, str]] = []
            if not ts.at_end():
                # "= [ ... ]" assignment
                eq = ts.next()
                if eq != "=":
                    raise FznParseError(f"expected '=' in array decl: {item[:80]}")
                val = _parse_expr(ts)
                if not isinstance(val, list):
                    raise FznParseError(f"expected array literal: {item[:80]}")
                elems = [e if isinstance(e, (int, str)) else e for e in val]
            else:
                if is_var:
                    # Unassigned var array: introduce fresh variables name[i].
                    for i in range(lo, hi + 1):
                        vn = f"{name}[{i}]"
                        vd = VarDecl(vn, is_bool, tlb, tub, tsparse)
                        variables.append(vd)
                        elems.append(vn)
            arrays.append(ArrayDecl(name, elems, is_var, is_bool, output_dims))
        elif head in ("int", "bool") or isinstance(head, int) or head == "{":
            # Par declaration: "int: n = 5;"
            is_bool, lb, ub, sparse = _parse_type(ts)
            ts.expect(":")
            name = ts.next()
            _parse_annotations(ts)
            if not ts.at_end():
                eq = ts.next()
                if eq != "=":
                    raise FznParseError(f"expected '=' in par decl: {item[:80]}")
                val = _parse_expr(ts)
                if isinstance(val, int):
                    # Model par ints as fixed singleton variables.
                    variables.append(VarDecl(name, False, val, val, None))
                    continue
            raise FznParseError(f"unsupported par decl: {item[:80]}")
        else:
            raise FznParseError(f"unknown item: {item[:80]}")

    if solve is None:
        raise FznParseError("missing solve item")
    return Model(variables, arrays, constraints, solve, path)


def _apply_var_anns(vd: VarDecl, anns):
    for a in anns:
        if a == "output_var":
            vd.output_var = True
        elif a == "var_is_introduced":
            vd.introduced = True
        elif a == "is_defined_var":
            vd.defined = True


def parse_fzn(path: str, use_native: bool = True) -> Model:
    with open(path, "r") as f:
        text = f.read()
    if use_native:
        try:
            from .native import parse_fzn_native

            m = parse_fzn_native(text, path)
            if m is not None:
                return m
        except Exception:
            pass  # fall back to the pure-Python parser
    return parse_fzn_text(text, path)
