"""XCSP3 frontend.

The reference supports XCSP3 through the optional XCSP3-CPP-Parser
(`WITH_XCSP3PARSER`, common_solving.hpp:409-413); its only shipped
fixture is benchmarks/test_data/cumulative.xml. This parser covers the
XCSP3-core subset: integer vars/arrays (sparse domains included),
intension (full functional syntax), extension (supports/conflicts,
stars, compression), element, sum, count, cardinality, nValues,
allDifferent, allEqual, ordered, channel, regular, minimum/maximum,
instantiation, cumulative, and group templates — lowered to the same
Model AST the FlatZinc frontend produces. Globals are decomposed into
FlatZinc builtins (time-indexed decomposition for cumulative, unrolled
row-selector automaton for regular), mirroring how MiniZinc
pre-decomposes globals for the reference (SURVEY.md §2a: mzn-lib has
no global redefinitions).
"""
from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple, Union

from .ast import Constraint, Model, SearchAnnotation, SolveItem, VarDecl


class Xcsp3Error(Exception):
    pass


def _parse_values(text: str) -> List[int]:
    """Parse a whitespace-separated value list with 'VxK' compression."""
    out = []
    for tok in text.split():
        m = re.fullmatch(r"(-?\d+)x(\d+)", tok)
        if m:
            out.extend([int(m.group(1))] * int(m.group(2)))
        else:
            out.append(int(tok))
    return out


def _parse_domain(text: str) -> Tuple[int, int, Union[Tuple[int, ...], None]]:
    """Parse a domain spec into (lb, ub, sparse).

    `sparse` is a sorted value tuple when the domain is a value list with
    holes (e.g. "1 3 5"); contiguous lists and ranges return sparse=None.
    A mix of ranges and values ("1..3 7 9") is also supported.
    """
    text = text.strip()
    m = re.fullmatch(r"(-?\d+)\.\.(-?\d+)", text)
    if m:
        return int(m.group(1)), int(m.group(2)), None
    vals: List[int] = []
    for tok in text.split():
        m = re.fullmatch(r"(-?\d+)\.\.(-?\d+)", tok)
        if m:
            vals.extend(range(int(m.group(1)), int(m.group(2)) + 1))
        else:
            vals.extend(_parse_values(tok))
    if not vals:
        raise Xcsp3Error(f"empty domain {text!r}")
    vals = sorted(set(vals))
    lo, hi = vals[0], vals[-1]
    if len(vals) == hi - lo + 1:
        return lo, hi, None
    return lo, hi, tuple(vals)


class _Builder:
    def __init__(self):
        self.vars: List[VarDecl] = []
        self.constraints: List[Constraint] = []
        self.var_names: Dict[str, List[str]] = {}  # array id -> element names
        self.aux = 0

    def new_aux(self, lb, ub, bool_=False) -> str:
        self.aux += 1
        name = f"__aux_{self.aux}"
        self.vars.append(VarDecl(name, bool_, lb, ub, None, introduced=True))
        return name

    def resolve_list(self, text: str) -> List[str]:
        """Resolve 'x[]' / 'x[1] y[2]' style variable references."""
        out = []
        for tok in text.split():
            m = re.fullmatch(r"(\w+)\[\]", tok)
            if m:
                out.extend(self.var_names[m.group(1)])
                continue
            m = re.fullmatch(r"(\w+)\[(\d+)\]", tok)
            if m:
                out.append(self.var_names[m.group(1)][int(m.group(2))])
                continue
            out.append(tok)
        return out


def parse_xcsp3(path: str) -> Model:
    tree = ET.parse(path)
    root = tree.getroot()
    b = _Builder()

    variables = root.find("variables")
    for v in (variables if variables is not None else []):
        if v.tag == "array":
            size = v.get("size", "[1]")
            m = re.fullmatch(r"\[(\d+)\]", size)
            if not m:
                raise Xcsp3Error(f"unsupported array size {size!r}")
            n = int(m.group(1))
            lo, hi, sparse = _parse_domain(v.text or "")
            names = []
            aid = v.get("id")
            for i in range(n):
                nm = f"{aid}[{i}]"
                b.vars.append(VarDecl(nm, False, lo, hi, sparse,
                                      output_var=True))
                names.append(nm)
            b.var_names[aid] = names
        elif v.tag == "var":
            lo, hi, sparse = _parse_domain(v.text or "")
            b.vars.append(VarDecl(v.get("id"), False, lo, hi, sparse,
                                  output_var=True))
            b.var_names[v.get("id")] = [v.get("id")]

    cons = root.find("constraints")
    if cons is not None:
        for c in cons:
            _lower_constraint(b, c)

    solve = SolveItem("satisfy", None, [])
    objs = root.find("objectives")
    if objs is not None:
        for o in objs:
            kind = "minimize" if o.tag == "minimize" else "maximize"
            typ = o.get("type", "expression")
            lst = o.find("list")
            coeffs_el = o.find("coeffs")
            if lst is not None:
                terms = b.resolve_list((lst.text or "").strip())
            else:
                terms = b.resolve_list((o.text or "").strip())
            coeffs = (_parse_values(coeffs_el.text)
                      if coeffs_el is not None else [1] * len(terms))
            if typ in ("sum", "expression"):
                if len(terms) == 1 and coeffs == [1]:
                    obj = terms[0]
                else:
                    obj = b.new_aux(None, None)
                    b.constraints.append(Constraint(
                        "int_lin_eq",
                        [coeffs + [-1], terms + [obj], 0]))
                solve = SolveItem(kind, obj, [])
            elif typ in ("minimum", "maximum"):
                term_vals = [int(t) if re.fullmatch(r"-?\d+", t) else t
                             for t in terms]
                doms = [_dom_of(b, t) for t in term_vals]
                lo = min(d[0] for d in doms)
                hi = max(d[1] for d in doms)
                terms = term_vals
                fold = "int_min" if typ == "minimum" else "int_max"
                acc = terms[0]
                for x in terms[1:]:
                    nxt = b.new_aux(lo, hi)
                    b.constraints.append(Constraint(fold, [acc, x, nxt]))
                    acc = nxt
                solve = SolveItem(kind, acc, [])
            else:
                raise Xcsp3Error(f"unsupported objective type {typ!r}")
            break

    return Model(b.vars, [], b.constraints, solve, path)


def _lower_constraint(b: _Builder, c):
    if c.tag == "cumulative":
        _lower_cumulative(b, c)
    elif c.tag == "group":
        _lower_group(b, c)
    elif c.tag == "intension":
        _lower_intension(b, (c.text or "").strip())
    elif c.tag == "extension":
        _lower_extension(b, c)
    elif c.tag == "element":
        _lower_element(b, c)
    elif c.tag in ("minimum", "maximum"):
        _lower_minmax(b, c)
    elif c.tag == "instantiation":
        vs = b.resolve_list((c.find("list").text or "").strip())
        vals = _parse_values(c.find("values").text or "")
        if len(vs) != len(vals):
            raise Xcsp3Error("instantiation arity mismatch")
        for v, k in zip(vs, vals):
            b.constraints.append(Constraint("int_eq", [v, k]))
    elif c.tag == "allDifferent":
        vs = b.resolve_list((c.text or "").strip())
        for i in range(len(vs)):
            for j in range(i + 1, len(vs)):
                b.constraints.append(Constraint("int_ne", [vs[i], vs[j]]))
    elif c.tag == "allEqual":
        vs = b.resolve_list((c.text or "").strip())
        for i in range(len(vs) - 1):
            b.constraints.append(Constraint("int_eq", [vs[i], vs[i + 1]]))
    elif c.tag == "sum":
        vs = b.resolve_list((c.find("list").text or "").strip())
        coeffs_el = c.find("coeffs")
        coeffs = _parse_values(coeffs_el.text) if coeffs_el is not None \
            else [1] * len(vs)
        op, k = _parse_condition(b, c.find("condition").text)
        _lin_cond(b, coeffs, vs, op, k)
    elif c.tag == "ordered":
        _lower_ordered(b, c)
    elif c.tag == "channel":
        _lower_channel(b, c)
    elif c.tag == "count":
        _lower_count(b, c)
    elif c.tag == "cardinality":
        _lower_cardinality(b, c)
    elif c.tag == "nValues":
        _lower_nvalues(b, c)
    elif c.tag == "regular":
        _lower_regular(b, c)
    else:
        raise Xcsp3Error(f"unsupported constraint <{c.tag}>")


def _lin_cond(b: _Builder, coeffs: List[int], vs: List[str], op: str, k):
    """Emit `sum(coeffs*vs) OP k` where k is an int or a variable and
    OP in le/lt/ge/gt/eq/ne (XCSP3-core <condition> operators)."""
    coeffs, vs, k = list(coeffs), list(vs), k
    if not isinstance(k, int):
        # Move the variable RHS into the sum: sum - k OP 0.
        coeffs = coeffs + [-1]
        vs = vs + [k]
        k = 0
    if op == "lt":
        op, k = "le", k - 1
    elif op == "gt":
        op, k = "ge", k + 1
    if op == "ge":
        coeffs = [-a for a in coeffs]
        op, k = "le", -k
    name = {"le": "int_lin_le", "eq": "int_lin_eq",
            "ne": "int_lin_ne"}.get(op)
    if name is None:
        raise Xcsp3Error(f"unsupported linear condition {op!r}")
    b.constraints.append(Constraint(name, [coeffs, vs, k]))


# -- intension expressions (XCSP3-core functional syntax) -------------

_REL = {"eq": "int_eq", "ne": "int_ne", "le": "int_le", "lt": "int_lt"}
_REL_REIF = {"eq": "int_eq_reif", "ne": "int_ne_reif",
             "le": "int_le_reif", "lt": "int_lt_reif"}


def _parse_prefix(text: str):
    """'op(a,op2(b,c),d)' -> ('op', [...]) tree; leaves are str/int."""
    text = text.strip()
    m = re.fullmatch(r"(\w+)\((.*)\)", text, re.S)
    if not m:
        return int(text) if re.fullmatch(r"-?\d+", text) else text
    op, body = m.group(1), m.group(2)
    args, depth, cur = [], 0, []
    for ch in body:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            args.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur or not args:
        args.append("".join(cur))
    return op, [_parse_prefix(a) for a in args]


def _dom_of(b: _Builder, t) -> Tuple[int, int]:
    if isinstance(t, int):
        return t, t
    for v in b.vars:
        if v.name == t:
            return v.lb, v.ub
    raise Xcsp3Error(f"unknown variable {t!r}")


def _expr_int(b: _Builder, e) -> Union[str, int]:
    """Lower an arithmetic expression tree to a var name or int."""
    if not isinstance(e, tuple):
        return e
    op, args = e
    xs = [_expr_int(b, a) for a in args]
    if op in ("add", "sub"):
        coefs = [1] * len(xs) if op == "add" else [1, -1]
        const = sum(c * x for c, x in zip(coefs, xs) if isinstance(x, int))
        terms = [(c, x) for c, x in zip(coefs, xs) if not isinstance(x, int)]
        lo = const + sum(min(c * l, c * u)
                         for c, x in terms for l, u in [_dom_of(b, x)])
        hi = const + sum(max(c * l, c * u)
                         for c, x in terms for l, u in [_dom_of(b, x)])
        r = b.new_aux(lo, hi)
        b.constraints.append(Constraint(
            "int_lin_eq", [[c for c, _ in terms] + [-1],
                           [x for _, x in terms] + [r], -const]))
        return r
    if op in ("mul", "div", "mod", "min", "max"):
        if len(xs) != 2:
            # n-ary mul/min/max: fold left.
            acc = xs[0]
            for x in xs[1:]:
                acc = _expr_int(b, (op, [acc, x]))
            return acc
        (l1, u1), (l2, u2) = _dom_of(b, xs[0]), _dom_of(b, xs[1])
        if op == "mul":
            cands = [l1 * l2, l1 * u2, u1 * l2, u1 * u2]
            lo, hi = min(cands), max(cands)
        elif op == "div":
            cands = [l1, u1, -abs(l1), -abs(u1), abs(l1), abs(u1)]
            lo, hi = min(cands + [0]), max(cands + [0])
        elif op == "mod":
            m = max(abs(l2), abs(u2))
            lo, hi = -m, m
        elif op == "min":
            lo, hi = min(l1, l2), min(u1, u2)
        else:
            lo, hi = max(l1, l2), max(u1, u2)
        r = b.new_aux(lo, hi)
        name = {"mul": "int_times", "div": "int_div", "mod": "int_mod",
                "min": "int_min", "max": "int_max"}[op]
        b.constraints.append(Constraint(name, [xs[0], xs[1], r]))
        return r
    if op in ("abs", "neg", "sqr"):
        (l1, u1) = _dom_of(b, xs[0])
        if op == "abs":
            r = b.new_aux(0, max(abs(l1), abs(u1)))
            b.constraints.append(Constraint("int_abs", [xs[0], r]))
            return r
        if op == "neg":
            return _expr_int(b, ("sub", [0, args[0]]))
        return _expr_int(b, ("mul", [args[0], args[0]]))
    if op == "dist":
        return _expr_int(b, ("abs", [("sub", args)]))
    if op in _REL or op in ("ge", "gt") or op in ("and", "or", "not",
                                                  "iff", "imp", "xor"):
        return _expr_bool(b, e)
    raise Xcsp3Error(f"unsupported intension op {op!r}")


def _expr_bool(b: _Builder, e) -> str:
    """Lower a boolean expression tree to a 0/1 var."""
    if not isinstance(e, tuple):
        if isinstance(e, int):
            return e
        return e  # already a 0/1 variable reference
    op, args = e
    if op in ("ge", "gt"):
        op = {"ge": "le", "gt": "lt"}[op]
        args = [args[1], args[0]]
    if op in _REL_REIF:
        x, y = _expr_int(b, args[0]), _expr_int(b, args[1])
        r = b.new_aux(0, 1, bool_=True)
        b.constraints.append(Constraint(_REL_REIF[op], [x, y, r]))
        return r
    xs = [_expr_bool(b, a) for a in args]
    r = b.new_aux(0, 1, bool_=True)
    if op == "not":
        b.constraints.append(Constraint("bool_not", [xs[0], r]))
    elif op == "and":
        if len(xs) == 2:
            b.constraints.append(Constraint("bool_and", [xs[0], xs[1], r]))
        else:
            b.constraints.append(Constraint("array_bool_and", [xs, r]))
    elif op == "or":
        if len(xs) == 2:
            b.constraints.append(Constraint("bool_or", [xs[0], xs[1], r]))
        else:
            b.constraints.append(Constraint("array_bool_or", [xs, r]))
    elif op == "xor":
        b.constraints.append(Constraint("bool_xor", [xs[0], xs[1], r]))
    elif op == "iff":
        b.constraints.append(Constraint("bool_eq_reif", [xs[0], xs[1], r]))
    elif op == "imp":
        b.constraints.append(Constraint("bool_le_reif", [xs[0], xs[1], r]))
    else:
        raise Xcsp3Error(f"unsupported boolean op {op!r}")
    return r


def _lower_intension(b: _Builder, text: str):
    e = _parse_prefix(text)
    if not isinstance(e, tuple):
        raise Xcsp3Error(f"bad intension {text!r}")
    op, args = e
    if op in ("ge", "gt"):
        op = {"ge": "le", "gt": "lt"}[op]
        args = [args[1], args[0]]
    if op in _REL and not any(
            isinstance(a, tuple) and a[0] in ("and", "or", "not", "iff",
                                              "imp", "xor") for a in args):
        x, y = _expr_int(b, args[0]), _expr_int(b, args[1])
        b.constraints.append(Constraint(_REL[op], [x, y]))
        return
    r = _expr_bool(b, e)
    b.constraints.append(Constraint("int_eq", [r, 1]))


def _lower_extension(b: _Builder, c):
    """Table constraints. Supports: row-selector encoding through the
    native element kernel — aux index i in 1..T with
    array_int_element(i, column_j, x_j) per column (star '*' entries
    skip their column). Conflicts: per forbidden tuple, at least one
    column differs (bool_clause over ne_reif)."""
    vs = b.resolve_list((c.find("list").text or "").strip())
    sup = c.find("supports")
    con = c.find("conflicts")
    if sup is not None and (sup.text or "").strip():
        tuples = _parse_tuples(sup.text)
        if not tuples:
            raise Xcsp3Error("extension: empty/unparsable supports")
        if len(vs) == 1 and len(tuples[0]) == 1:
            from .ast import SetLit
            vals = [t[0] for t in tuples if t[0] != "*"]
            b.constraints.append(Constraint(
                "set_in", [vs[0], SetLit(tuple(sorted(set(vals))))]))
            return
        idx = b.new_aux(1, len(tuples))
        for j, x in enumerate(vs):
            col = [t[j] for t in tuples]
            if any(v == "*" for v in col):
                for ti, v in enumerate(col):
                    if v == "*":
                        continue
                    bi = b.new_aux(0, 1, bool_=True)
                    b.constraints.append(
                        Constraint("int_eq_reif", [idx, ti + 1, bi]))
                    bj = b.new_aux(0, 1, bool_=True)
                    b.constraints.append(
                        Constraint("int_eq_reif", [x, int(v), bj]))
                    b.constraints.append(Constraint("bool_le", [bi, bj]))
            else:
                b.constraints.append(Constraint(
                    "array_int_element", [idx, [int(v) for v in col], x]))
    elif con is not None and (con.text or "").strip():
        for t in _parse_tuples(con.text):
            lits = []
            for x, v in zip(vs, t):
                if v == "*":
                    continue
                r = b.new_aux(0, 1, bool_=True)
                b.constraints.append(
                    Constraint("int_ne_reif", [x, int(v), r]))
                lits.append(r)
            b.constraints.append(Constraint("bool_clause", [lits, []]))


def _parse_tuples(text: str) -> List[list]:
    """Tuple lists: '(1,2)(3,4)' n-ary form, plain values for unary
    ('1 2 3'), and interval compression '(1..3,0)' (expanded)."""
    import itertools

    def cell(tok):
        tok = tok.strip()
        if tok == "*":
            return ["*"]
        m = re.fullmatch(r"(-?\d+)\.\.(-?\d+)", tok)
        if m:
            return list(range(int(m.group(1)), int(m.group(2)) + 1))
        if re.fullmatch(r"-?\d+", tok):
            return [int(tok)]
        raise Xcsp3Error(f"unsupported extension tuple entry {tok!r}")

    out = []
    if "(" in text:
        for m in re.finditer(r"\(([^)]*)\)", text):
            cells = [cell(tok) for tok in m.group(1).split(",")]
            for combo in itertools.product(*cells):
                out.append(list(combo))
    else:
        # Unary tables: whitespace-separated values (XCSP3-core form).
        for tok in text.split():
            out.extend([v] for v in cell(tok))
    return out


def _lower_element(b: _Builder, c):
    vs = b.resolve_list((c.find("list").text or "").strip())
    idx_el = c.find("index")
    val_el = c.find("value")
    val = (val_el.text or "").strip()
    value = int(val) if re.fullmatch(r"-?\d+", val) else \
        b.resolve_list(val)[0]
    start = int(c.find("list").get("startIndex", "0"))
    if idx_el is None:
        raise Xcsp3Error("element without index unsupported")
    i0 = b.resolve_list((idx_el.text or "").strip())[0]
    # FlatZinc element is 1-based: shift the index by (1 - start).
    shift = 1 - start
    if shift:
        lo, hi = _dom_of(b, i0)
        i1 = b.new_aux(lo + shift, hi + shift)
        b.constraints.append(Constraint(
            "int_lin_eq", [[1, -1], [i0, i1], -shift]))
    else:
        i1 = i0
    if all(re.fullmatch(r"-?\d+", v) for v in vs):
        b.constraints.append(Constraint(
            "array_int_element", [i1, [int(v) for v in vs], value]))
    else:
        b.constraints.append(Constraint(
            "array_var_int_element", [i1, vs, value]))


def _lower_minmax(b: _Builder, c):
    vs = b.resolve_list((c.find("list").text or "").strip())
    op, k = _parse_condition(b, c.find("condition").text)
    fold = "int_min" if c.tag == "minimum" else "int_max"
    acc = vs[0]
    doms = [_dom_of(b, v) for v in vs]
    lo = min(d[0] for d in doms)
    hi = max(d[1] for d in doms)
    for x in vs[1:]:
        nxt = b.new_aux(lo, hi)
        b.constraints.append(Constraint(fold, [acc, x, nxt]))
        acc = nxt
    name = {"le": "int_le", "eq": "int_eq", "ne": "int_ne",
            "lt": "int_lt"}.get(op)
    if name:
        b.constraints.append(Constraint(name, [acc, k]))
    elif op in ("ge", "gt"):
        b.constraints.append(Constraint(
            {"ge": "int_le", "gt": "int_lt"}[op], [k, acc]))
    else:
        raise Xcsp3Error(f"unsupported {c.tag} condition {op!r}")


def _lower_group(b: _Builder, c):
    """<group>: one constraint template with %0 %1 ... applied to each
    <args> row."""
    template = None
    rows = []
    for ch in c:
        if ch.tag == "args":
            rows.append((ch.text or "").strip())
        else:
            template = ch
    if template is None:
        raise Xcsp3Error("group without template")
    for row in rows:
        args = row.split()
        inst = ET.fromstring(
            _substitute_args(ET.tostring(template, encoding="unicode"), args))
        _lower_constraint(b, inst)


def _substitute_args(text: str, args: List[str]) -> str:
    text = text.replace("%...", " ".join(args))
    for i in range(len(args) - 1, -1, -1):
        text = text.replace(f"%{i}", args[i])
    return text


def _parse_condition(b: _Builder, text: str):
    """(op, operand): operand is an int, or a variable reference
    (XCSP3-core allows `(le, y)` / `(eq, x[3])`)."""
    m = re.fullmatch(r"\s*\((\w+),\s*(-?\d+)\)\s*", text)
    if m:
        return m.group(1), int(m.group(2))
    m = re.fullmatch(r"\s*\((\w+),\s*([\w\[\]]+)\)\s*", text)
    if m:
        return m.group(1), b.resolve_list(m.group(2))[0]
    raise Xcsp3Error(f"unsupported condition {text!r}")


def _lower_cumulative(b: _Builder, c):
    """Time-indexed decomposition: for each time t,
    sum_i h_i * [x_i <= t < x_i + l_i] <= cap."""
    origins = b.resolve_list((c.find("origins").text or "").strip())
    lengths = _parse_values(c.find("lengths").text)
    heights = _parse_values(c.find("heights").text)
    op, cap = _parse_condition(b, c.find("condition").text)
    if op != "le":
        raise Xcsp3Error(f"unsupported cumulative condition {op!r}")
    doms = {v.name: (v.lb, v.ub) for v in b.vars}
    lo_t = min(doms[o][0] for o in origins)
    hi_t = max(doms[o][1] + l - 1 for o, l in zip(origins, lengths))
    for t in range(lo_t, hi_t + 1):
        terms, hs = [], []
        for o, l, h in zip(origins, lengths, heights):
            # b1 = (x_o <= t), b2 = (t - l + 1 <= x_o), run = b1 & b2
            b1 = b.new_aux(0, 1, bool_=True)
            b.constraints.append(Constraint("int_le_reif", [o, t, b1]))
            b2 = b.new_aux(0, 1, bool_=True)
            b.constraints.append(Constraint("int_le_reif", [t - l + 1, o, b2]))
            run = b.new_aux(0, 1, bool_=True)
            b.constraints.append(Constraint("bool_and", [b1, b2, run]))
            terms.append(run)
            hs.append(h)
        b.constraints.append(Constraint("int_lin_le", [hs, terms, cap]))


# -- XCSP3-core widening (round 5): ordered / channel / count /
#    cardinality / nValues / regular ----------------------------------

def _lower_ordered(b: _Builder, c):
    """<ordered>: x_i (+ l_i) OP x_{i+1} chain (lex on a single list).
    Reference analog: XCSP3-core `ordered` with operator lt/le/gt/ge
    and optional <lengths>."""
    lst = c.find("list")
    vs = b.resolve_list(((lst.text if lst is not None else c.text)
                         or "").strip())
    op_el = c.find("operator")
    op = (op_el.text or "le").strip() if op_el is not None else "le"
    lens_el = c.find("lengths")
    lens = (_parse_values(lens_el.text) if lens_el is not None
            else [0] * (len(vs) - 1))
    if op in ("gt", "ge"):
        # x_i + l_i (gt|ge) x_{i+1}  ==  x_{i+1} - l_i (lt|le) x_i: the
        # reversed chain with lt/le and the lengths reversed and negated.
        op = {"gt": "lt", "ge": "le"}[op]
        vs = vs[::-1]
        lens = [-l for l in lens[::-1]]
    for i in range(len(vs) - 1):
        # x_i + l_i (lt|le) x_{i+1}  ->  x_i - x_{i+1} <= -l_i (-1)
        rhs = -lens[i] - (1 if op == "lt" else 0)
        b.constraints.append(Constraint(
            "int_lin_le", [[1, -1], [vs[i], vs[i + 1]], rhs]))


def _fixed(b: _Builder, k: int) -> str:
    """A singleton auxiliary variable pinned to k (for element-value
    slots that require a variable operand)."""
    return b.new_aux(k, k)


def _lower_channel(b: _Builder, c):
    """<channel>: one-list form x[x[i]] = i (self-inverse permutation);
    two-list form x[i] = j <=> y[j] = i, lowered through var elements
    in both directions (bijection when |x| == |y|)."""
    lists = c.findall("list")
    if not lists:
        lists = [c]
    def resolve(el):
        start = int(el.get("startIndex", "0")) if el.get("startIndex") \
            else 0
        return b.resolve_list((el.text or "").strip()), start

    def elem(idx_var, idx_start, arr, value_var):
        # FlatZinc element is 1-based: shift index by (1 - start).
        shift = 1 - idx_start
        if shift:
            lo, hi = _dom_of(b, idx_var)
            i1 = b.new_aux(lo + shift, hi + shift)
            b.constraints.append(Constraint(
                "int_lin_eq", [[1, -1], [idx_var, i1], -shift]))
        else:
            i1 = idx_var
        b.constraints.append(Constraint(
            "array_var_int_element", [i1, arr, value_var]))

    if len(lists) == 1:
        xs, sx = resolve(lists[0])
        for i, x in enumerate(xs):
            # x[x[i]] = i (+ start offset on both sides).
            elem(x, sx, xs, _fixed(b, i + sx))
    else:
        xs, sx = resolve(lists[0])
        ys, sy = resolve(lists[1])
        for i, x in enumerate(xs):
            elem(x, sy, ys, _fixed(b, i + sx))
        if len(xs) == len(ys):
            for j, y in enumerate(ys):
                elem(y, sx, xs, _fixed(b, j + sy))


def _count_sum(b: _Builder, vs: List[str], vals: List[int]) -> List[str]:
    """0/1 vars b_iv = [x_i = v] for every (i, v) pair."""
    bits = []
    for x in vs:
        for v in vals:
            r = b.new_aux(0, 1, bool_=True)
            b.constraints.append(Constraint("int_eq_reif", [x, v, r]))
            bits.append(r)
    return bits


def _lower_count(b: _Builder, c):
    """<count>: |{i : x_i in values}| OP k (k int or var)."""
    vs = b.resolve_list((c.find("list").text or "").strip())
    vals = _parse_values(c.find("values").text or "")
    op, k = _parse_condition(b, c.find("condition").text)
    bits = _count_sum(b, vs, vals)
    _lin_cond(b, [1] * len(bits), bits, op, k)


def _lower_cardinality(b: _Builder, c):
    """<cardinality>: per value v, count(x, v) matches <occurs> (int,
    a..b range, or a variable). closed="true" additionally restricts
    every x_i to the value list."""
    vs = b.resolve_list((c.find("list").text or "").strip())
    vals = _parse_values(c.find("values").text or "")
    occ_toks = (c.find("occurs").text or "").split()
    if len(occ_toks) != len(vals):
        raise Xcsp3Error("cardinality values/occurs arity mismatch")
    for v, tok in zip(vals, occ_toks):
        bits = _count_sum(b, vs, [v])
        ones = [1] * len(bits)
        m = re.fullmatch(r"(-?\d+)\.\.(-?\d+)", tok)
        if m:
            _lin_cond(b, ones, bits, "ge", int(m.group(1)))
            _lin_cond(b, ones, bits, "le", int(m.group(2)))
        elif re.fullmatch(r"-?\d+", tok):
            _lin_cond(b, ones, bits, "eq", int(tok))
        else:
            _lin_cond(b, ones, bits, "eq", b.resolve_list(tok)[0])
    if (c.get("closed") or "").lower() == "true":
        from .ast import SetLit
        allowed = SetLit(tuple(sorted(set(vals))))
        for x in vs:
            b.constraints.append(Constraint("set_in", [x, allowed]))


def _lower_nvalues(b: _Builder, c):
    """<nValues>: |{x_i}| OP k via used_v = OR_i [x_i = v] over the
    union of domains (guarded against huge unions)."""
    vs = b.resolve_list((c.find("list").text or "").strip())
    op, k = _parse_condition(b, c.find("condition").text)
    union = set()
    for x in vs:
        lo, hi = _dom_of(b, x)
        union.update(range(lo, hi + 1))
        if len(union) > 512:
            raise Xcsp3Error("nValues domain union too large (>512)")
    used = []
    for v in sorted(union):
        bits = _count_sum(b, vs, [v])
        u = b.new_aux(0, 1, bool_=True)
        b.constraints.append(Constraint("array_bool_or", [bits, u]))
        used.append(u)
    _lin_cond(b, [1] * len(used), used, op, k)


def _lower_regular(b: _Builder, c):
    """<regular>: unrolled automaton. Step i picks a transition row
    r_i: src[r_i] = q_i, sym[r_i] = x_i, dst[r_i] = q_{i+1} (the same
    row-selector element encoding the extension kernel uses); q_0 is
    pinned to <start> and q_n restricted to <final>."""
    from .ast import SetLit

    vs = b.resolve_list((c.find("list").text or "").strip())
    trans_text = (c.find("transitions").text or "").strip()
    trans = []
    for m in re.finditer(r"\(([^)]*)\)", trans_text):
        src, sym, dst = [t.strip() for t in m.group(1).split(",")]
        trans.append((src, int(sym), dst))
    if not trans:
        raise Xcsp3Error("regular without transitions")
    states = sorted({t[0] for t in trans} | {t[2] for t in trans})
    sid = {s: i for i, s in enumerate(states)}
    start = (c.find("start").text or "").strip()
    finals = [(f) for f in (c.find("final").text or "").split()]
    if start not in sid or any(f not in sid for f in finals):
        # A start/final state with no transition can never be reached /
        # left; map unknown states to a fresh id so the encoding stays
        # total (the row tables simply never produce them).
        for s in [start] + finals:
            if s not in sid:
                sid[s] = len(sid)
    src_col = [sid[t[0]] for t in trans]
    sym_col = [t[1] for t in trans]
    dst_col = [sid[t[2]] for t in trans]
    n_states = len(sid)
    q = [_fixed(b, sid[start])]
    for i in range(len(vs)):
        q.append(b.new_aux(0, n_states - 1))
    for i, x in enumerate(vs):
        r = b.new_aux(1, len(trans))
        b.constraints.append(Constraint(
            "array_int_element", [r, src_col, q[i]]))
        b.constraints.append(Constraint(
            "array_int_element", [r, sym_col, x]))
        b.constraints.append(Constraint(
            "array_int_element", [r, dst_col, q[i + 1]]))
    b.constraints.append(Constraint(
        "set_in", [q[-1], SetLit(tuple(sorted(sid[f] for f in finals)))]))
