"""Compile a parsed FlatZinc Model into a finalized Tnf.

Covers the builtin surface exercised by the reference's fixture corpus
(histogram in SURVEY.md §2a) plus the common close relatives.  The
reference reaches the same form through lala's ``ternarize`` +
``Simplifier`` (common_solving.hpp:520-585); here decomposition, CSE
and equivalence classes happen in a single build pass.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..core.ops import INF, NINF, OP_ADD, OP_DIV, OP_EQ, OP_LE, OP_MAX, OP_MIN, OP_MUL
from ..frontend.ast import ArrayDecl, Constraint, Model, Range, SetLit
from .tnf import Builder, CompileError, OutputItem, Strategy, Tnf


class _Ctx:
    def __init__(self, model: Model):
        self.model = model
        self.b = Builder()
        self.var_ids: Dict[str, int] = {}
        self.arrays: Dict[str, ArrayDecl] = {a.name: a for a in model.arrays}
        self.sparse_doms: List = []  # (var_id, tuple_of_values)

    # -- argument resolution ------------------------------------------

    def term(self, arg) -> int:
        """Resolve an argument into a variable id (constants interned)."""
        if isinstance(arg, (int, np.integer)):
            return self.b.const(int(arg))
        if isinstance(arg, str):
            v = self.var_ids.get(arg)
            if v is not None:
                return v
            arr = self.arrays.get(arg)
            if arr is not None and len(arr.elems) == 1:
                return self.term(arr.elems[0])
            raise CompileError(f"unknown identifier {arg!r}")
        if isinstance(arg, tuple) and arg[0] == "access":
            arr = self.arrays.get(arg[1])
            if arr is None:
                raise CompileError(f"unknown array {arg[1]!r}")
            return self.term(arr.elems[arg[2] - 1])
        if isinstance(arg, tuple) and arg[0] == "call":
            # Nested functional expression (e.g. `int_eq(b, int_le(0, y))`
            # in bug1.fzn) — return its reified/functional result variable.
            fname, fargs = arg[1], [self.term(a) for a in arg[2]]
            b = self.b
            if fname in ("int_le", "bool_le"):
                return b.le(fargs[0], fargs[1])
            if fname in ("int_lt", "bool_lt"):
                return b.le(b.fn(OP_ADD, fargs[0], b.const(1)), fargs[1])
            if fname in ("int_eq", "bool_eq"):
                return b.eq(fargs[0], fargs[1])
            if fname in ("int_ne", "bool_ne"):
                return b.negb(b.eq(fargs[0], fargs[1]))
            if fname == "int_plus":
                return b.fn(OP_ADD, fargs[0], fargs[1])
            if fname == "int_times":
                return b.fn(OP_MUL, fargs[0], fargs[1])
            if fname == "int_min":
                return b.fn(OP_MIN, fargs[0], fargs[1])
            if fname == "int_max":
                return b.fn(OP_MAX, fargs[0], fargs[1])
            if fname == "int_abs":
                n = b.fn(OP_MUL, b.const(-1), fargs[0])
                return b.fn(OP_MAX, fargs[0], n)
            raise CompileError(f"unsupported nested call {fname!r}")
        raise CompileError(f"cannot resolve term {arg!r}")

    def term_list(self, arg) -> List[int]:
        if isinstance(arg, str):
            arr = self.arrays.get(arg)
            if arr is None:
                # A scalar identifier used where an array is expected.
                return [self.term(arg)]
            return [self.term(e) for e in arr.elems]
        if isinstance(arg, list):
            return [self.term(e) for e in arg]
        raise CompileError(f"cannot resolve list {arg!r}")

    def const_list(self, arg) -> List[int]:
        if isinstance(arg, str):
            arr = self.arrays.get(arg)
            if arr is None:
                raise CompileError(f"unknown par array {arg!r}")
            out = []
            for e in arr.elems:
                if isinstance(e, (int, np.integer)):
                    out.append(int(e))
                else:
                    v = self.b.find(self.term(e))
                    if self.b.lb[v] != self.b.ub[v]:
                        raise CompileError(f"non-constant element in {arg!r}")
                    out.append(self.b.lb[v])
            return out
        if isinstance(arg, list):
            out = []
            for e in arg:
                if isinstance(e, (int, np.integer)):
                    out.append(int(e))
                else:
                    v = self.b.find(self.term(e))
                    if self.b.lb[v] != self.b.ub[v]:
                        raise CompileError("non-constant element in literal list")
                    out.append(self.b.lb[v])
            return out
        raise CompileError(f"cannot resolve constant list {arg!r}")


def _set_values(arg) -> Optional[List[int]]:
    if isinstance(arg, Range):
        return list(range(arg.lo, arg.hi + 1))
    if isinstance(arg, SetLit):
        return sorted(arg.values)
    return None


def compile_model(model: Model) -> Tnf:
    ctx = _Ctx(model)
    b = ctx.b

    # 1. Declare variables.
    for vd in model.vars:
        lb = NINF if vd.lb is None else vd.lb
        ub = INF if vd.ub is None else vd.ub
        v = b.new_var(lb, ub, vd.name)
        ctx.var_ids[vd.name] = v
        if vd.sparse is not None:
            vals = sorted(set(vd.sparse))
            if vals[-1] - vals[0] != len(vals) - 1:
                ctx.sparse_doms.append((v, tuple(vals)))
    # Alias RHS ("var 1..5: x = y;" / "= 3;")
    for vd in model.vars:
        if vd.alias is not None:
            b.union(ctx.var_ids[vd.name], ctx.term(vd.alias))

    # 2. Objective (maximize -> minimize negated objective, mirroring the
    # reference's __MINIMIZE_OBJ rewrite, common_solving.hpp:489-510).
    obj_var = -1
    orig_obj_var = -1
    is_max = model.solve.kind == "maximize"
    if model.solve.kind in ("minimize", "maximize"):
        orig_obj_var = ctx.term(model.solve.objective)
        if is_max:
            obj_var = b.fn(OP_MUL, b.const(-1), orig_obj_var, name="__MINIMIZE_OBJ")
        else:
            obj_var = orig_obj_var

    # 3. Constraints.
    for c in model.constraints:
        _compile_constraint(ctx, c)

    # 4. Sparse domain membership (after unions so hull bounds are final).
    seen = set()
    for v, vals in ctx.sparse_doms:
        r = b.find(v)
        key = (r, vals)
        if key in seen:
            continue
        seen.add(key)
        b.fix(b.in_set(v, vals), 1)

    # 5. Search strategies from annotations + default first_fail/indomain_min
    # over the whole store (common_solving.hpp:640-650).
    strategies: List[Strategy] = []
    arrays_by_name = {a.name: a for a in model.arrays}
    for s in model.solve.searches:
        ids = []
        entries = []
        for e in s.vars:
            # Annotation args may name a var ARRAY (e.g.
            # int_search(X_INTRODUCED_555_, ...)): expand to elements.
            if isinstance(e, str) and e in arrays_by_name:
                entries.extend(arrays_by_name[e].elems)
            else:
                entries.append(e)
        for e in entries:
            try:
                ids.append(ctx.term(e))
            except CompileError:
                continue
        strategies.append(Strategy(_VAR_ORDERS.get(s.var_order, "input_order"),
                                   _VAL_ORDERS.get(s.value_order, "indomain_min"),
                                   np.asarray(ids, dtype=np.int64)))
    strategies.append(Strategy("first_fail", "indomain_min", None))

    # 6. Outputs.
    outputs: List[OutputItem] = []
    for vd in model.vars:
        if vd.output_var:
            outputs.append(OutputItem(vd.name, False, vd.is_bool,
                                      [ctx.var_ids[vd.name]], None))
    for ad in model.arrays:
        if ad.output_dims is not None:
            elems = [ctx.term(e) for e in ad.elems]
            outputs.append(OutputItem(ad.name, True, ad.is_bool, elems, ad.output_dims))

    tnf = _finalize(ctx, obj_var, orig_obj_var, is_max, strategies, outputs,
                     n_parsed_vars=len(model.vars),
                     n_parsed_cons=len(model.constraints))
    return tnf


def _finalize(ctx: _Ctx, obj_var, orig_obj_var, is_max, strategies, outputs,
              n_parsed_vars, n_parsed_cons) -> Tnf:
    b = ctx.b
    n = len(b.lb)
    # Compact representatives.
    rep = np.asarray([b.find(v) for v in range(n)], dtype=np.int64)
    is_rep = np.zeros(n, dtype=bool)
    is_rep[rep] = True
    new_id = np.cumsum(is_rep) - 1
    remap = new_id[rep]
    V = int(is_rep.sum())

    lb0 = np.asarray(b.lb, dtype=np.int64)[is_rep]
    ub0 = np.asarray(b.ub, dtype=np.int64)[is_rep]
    names = [b.names[i] for i in range(n) if is_rep[i]]

    if b.props:
        parr = np.asarray(b.props, dtype=np.int64)
        ops = parr[:, 0].astype(np.int32)
        xs = remap[parr[:, 1]].astype(np.int32)
        ys = remap[parr[:, 2]].astype(np.int32)
        zs = remap[parr[:, 3]].astype(np.int32)
        # Drop duplicate propagators (can arise via unions).
        key = ((ops.astype(np.int64) * n + xs) * n + ys) * n + zs
        _, keep = np.unique(key, return_index=True)
        keep.sort()
        ops, xs, ys, zs = ops[keep], xs[keep], ys[keep], zs[keep]
    else:
        ops = np.zeros(0, dtype=np.int32)
        xs = np.zeros(0, dtype=np.int32)
        ys = np.zeros(0, dtype=np.int32)
        zs = np.zeros(0, dtype=np.int32)

    fs = []
    for s in strategies:
        ids = None
        if s.var_ids is not None:
            ids = remap[[b.find(int(v)) for v in s.var_ids]]
        fs.append(Strategy(s.var_order, s.val_order, ids))
    fouts = []
    for o in outputs:
        fouts.append(OutputItem(o.name, o.is_array, o.is_bool,
                                [int(remap[b.find(e)]) for e in o.elems], o.dims))

    from .tnf import ElementCon, MemberCon
    elements = []
    eseen = set()
    for idx, res, values in b.elements:
        e = ElementCon(int(remap[b.find(idx)]), int(remap[b.find(res)]), values)
        k = (e.idx, e.res, values)
        if k not in eseen:
            eseen.add(k)
            elements.append(e)
    members = []
    mseen = set()
    for x, bb, values in b.members:
        mcon = MemberCon(int(remap[b.find(x)]), int(remap[b.find(bb)]), values)
        k = (mcon.x, mcon.b, values)
        if k not in mseen:
            mseen.add(k)
            members.append(mcon)
    from .tnf import LinCon
    linears = []
    lseen = set()
    for bb, op, rhs, coefs, vs in b.linears:
        lc = LinCon(int(remap[b.find(bb)]), op, rhs, coefs,
                    tuple(int(remap[b.find(x)]) for x in vs))
        k = (lc.b, lc.op, lc.rhs, lc.coefs, lc.vars)
        if k not in lseen:
            lseen.add(k)
            linears.append(lc)

    return Tnf(
        lb0=lb0, ub0=ub0, ops=ops, xs=xs, ys=ys, zs=zs,
        obj_var=int(remap[b.find(obj_var)]) if obj_var >= 0 else -1,
        orig_obj_var=int(remap[b.find(orig_obj_var)]) if orig_obj_var >= 0 else -1,
        is_max=is_max,
        strategies=fs,
        outputs=fouts,
        names=names,
        root_unsat=b.root_unsat,
        n_parsed_vars=n_parsed_vars,
        n_parsed_cons=n_parsed_cons,
        elements=elements,
        members=members,
        linears=linears,
        var_map={name: int(remap[b.find(vid)])
                 for name, vid in ctx.var_ids.items()},
    )


_VAR_ORDERS = {k: k for k in
               ("input_order", "first_fail", "anti_first_fail", "smallest", "largest",
                "occurrence", "most_constrained", "max_regret", "dom_w_deg", "random")}
_VAR_ORDERS.update({"occurrence": "input_order", "most_constrained": "first_fail",
                    "max_regret": "input_order", "dom_w_deg": "input_order",
                    "random": "input_order"})
_VAL_ORDERS = {k: k for k in
               ("indomain_min", "indomain_max", "indomain_split", "indomain_reverse_split")}
_VAL_ORDERS.update({"indomain_median": "indomain_split", "indomain": "indomain_min",
                    "indomain_middle": "indomain_split", "indomain_random": "indomain_min",
                    "outdomain_min": "indomain_max", "outdomain_max": "indomain_min"})


def _compile_constraint(ctx: _Ctx, c: Constraint):
    b = ctx.b
    name, args = c.name, c.args
    h = _DISPATCH.get(name)
    if h is None:
        raise CompileError(f"unsupported constraint {name!r}")
    h(ctx, args)


# ---- individual builtins -------------------------------------------------

def _lin_sum(ctx: _Ctx, cs_arg, xs_arg) -> int:
    cs = ctx.const_list(cs_arg)
    xs = ctx.term_list(xs_arg)
    return ctx.b.linear(cs, xs)


def _c_int_lin_eq(ctx, args):
    cs = ctx.const_list(args[0])
    xs = ctx.term_list(args[1])
    k = ctx.term(args[2])
    rk = ctx.b.find(k)
    if ctx.b.lb[rk] == ctx.b.ub[rk]:
        b = ctx.b.lin(cs, xs, 1, ctx.b.lb[rk])
        if b is not None:
            ctx.b.fix(b, 1)
            return
    else:
        # sum == k with variable k: sum + (-1)k == 0
        b = ctx.b.lin(list(cs) + [-1], xs + [k], 1, 0)
        if b is not None:
            ctx.b.fix(b, 1)
            return
    s = ctx.b.linear(cs, xs)
    ctx.b.union(s, k)


def _c_int_lin_le(ctx, args):
    cs = ctx.const_list(args[0])
    xs = ctx.term_list(args[1])
    k = ctx.term(args[2])
    kv = ctx.b.find(k)
    if ctx.b.lb[kv] == ctx.b.ub[kv]:
        b = ctx.b.lin(cs, xs, 0, ctx.b.lb[kv])
        if b is not None:
            ctx.b.fix(b, 1)
            return
        s = ctx.b.linear(cs, xs)
        ctx.b.meet_dom(s, NINF, ctx.b.lb[kv])
    else:
        b = ctx.b.lin(list(cs) + [-1], xs + [k], 0, 0)
        if b is not None:
            ctx.b.fix(b, 1)
            return
        s = ctx.b.linear(cs, xs)
        ctx.b.fix(ctx.b.le(s, k), 1)


def _c_int_lin_ne(ctx, args):
    s = _lin_sum(ctx, args[0], args[1])
    ctx.b.fix(ctx.b.eq(s, ctx.term(args[2])), 0)


def _c_int_lin_eq_reif(ctx, args):
    cs = ctx.const_list(args[0])
    xs = ctx.term_list(args[1])
    k = ctx.term(args[2])
    r = ctx.term(args[3])
    rk = ctx.b.find(k)
    if ctx.b.lb[rk] == ctx.b.ub[rk]:
        if ctx.b.lin(cs, xs, 1, ctx.b.lb[rk], hint=r) is not None:
            return
    else:
        if ctx.b.lin(list(cs) + [-1], xs + [k], 1, 0, hint=r) is not None:
            return
    s = ctx.b.linear(cs, xs)
    ctx.b.eq(s, k, hint=r)


def _c_int_lin_le_reif(ctx, args):
    cs = ctx.const_list(args[0])
    xs = ctx.term_list(args[1])
    k = ctx.term(args[2])
    r = ctx.term(args[3])
    rk = ctx.b.find(k)
    if ctx.b.lb[rk] == ctx.b.ub[rk]:
        if ctx.b.lin(cs, xs, 0, ctx.b.lb[rk], hint=r) is not None:
            return
    else:
        if ctx.b.lin(list(cs) + [-1], xs + [k], 0, 0, hint=r) is not None:
            return
    s = ctx.b.linear(cs, xs)
    ctx.b.le(s, k, hint=r)


def _c_int_lin_ne_reif(ctx, args):
    s = _lin_sum(ctx, args[0], args[1])
    e = ctx.b.eq(s, ctx.term(args[2]))
    ctx.b.negb(e, hint=ctx.term(args[3]))


def _c_int_eq(ctx, args):
    ctx.b.union(ctx.term(args[0]), ctx.term(args[1]))


def _c_int_ne(ctx, args):
    ctx.b.fix(ctx.b.eq(ctx.term(args[0]), ctx.term(args[1])), 0)


def _c_int_le(ctx, args):
    a, z = ctx.term(args[0]), ctx.term(args[1])
    ra, rz = ctx.b.find(a), ctx.b.find(z)
    if ctx.b.lb[rz] == ctx.b.ub[rz]:
        ctx.b.meet_dom(a, NINF, ctx.b.lb[rz])
    elif ctx.b.lb[ra] == ctx.b.ub[ra]:
        ctx.b.meet_dom(z, ctx.b.lb[ra], INF)
    else:
        ctx.b.fix(ctx.b.le(a, z), 1)


def _c_int_lt(ctx, args):
    a, z = ctx.term(args[0]), ctx.term(args[1])
    s = ctx.b.fn(OP_ADD, a, ctx.b.const(1))
    rz = ctx.b.find(z)
    if ctx.b.lb[rz] == ctx.b.ub[rz]:
        ctx.b.meet_dom(s, NINF, ctx.b.lb[rz])
    else:
        ctx.b.fix(ctx.b.le(s, z), 1)


def _c_int_eq_reif(ctx, args):
    ctx.b.eq(ctx.term(args[0]), ctx.term(args[1]), hint=ctx.term(args[2]))


def _c_int_ne_reif(ctx, args):
    e = ctx.b.eq(ctx.term(args[0]), ctx.term(args[1]))
    ctx.b.negb(e, hint=ctx.term(args[2]))


def _c_int_le_reif(ctx, args):
    ctx.b.le(ctx.term(args[0]), ctx.term(args[1]), hint=ctx.term(args[2]))


def _c_int_lt_reif(ctx, args):
    s = ctx.b.fn(OP_ADD, ctx.term(args[0]), ctx.b.const(1))
    ctx.b.le(s, ctx.term(args[1]), hint=ctx.term(args[2]))


def _c_int_abs(ctx, args):
    a, r = ctx.term(args[0]), ctx.term(args[1])
    n = ctx.b.fn(OP_MUL, ctx.b.const(-1), a)
    ctx.b.fn(OP_MAX, a, n, hint=r)


def _c_int_times(ctx, args):
    ctx.b.fn(OP_MUL, ctx.term(args[0]), ctx.term(args[1]), hint=ctx.term(args[2]))


def _c_int_div(ctx, args):
    ctx.b.fn(OP_DIV, ctx.term(args[0]), ctx.term(args[1]), hint=ctx.term(args[2]))


def _c_int_min(ctx, args):
    ctx.b.fn(OP_MIN, ctx.term(args[0]), ctx.term(args[1]), hint=ctx.term(args[2]))


def _c_int_max(ctx, args):
    ctx.b.fn(OP_MAX, ctx.term(args[0]), ctx.term(args[1]), hint=ctx.term(args[2]))


def _c_int_plus(ctx, args):
    ctx.b.fn(OP_ADD, ctx.term(args[0]), ctx.term(args[1]), hint=ctx.term(args[2]))


def _c_int_minus(ctx, args):
    # a - b = c  <=>  a = b + c
    ctx.b.fn(OP_ADD, ctx.term(args[1]), ctx.term(args[2]), hint=ctx.term(args[0]))


def _c_int_mod(ctx, args):
    # a mod b = c  <=>  c = a - b*(a div b)
    a, m, r = ctx.term(args[0]), ctx.term(args[1]), ctx.term(args[2])
    q = ctx.b.fn(OP_DIV, a, m)
    t = ctx.b.fn(OP_MUL, m, q)
    ctx.b.fn(OP_ADD, t, r, hint=a)


def _c_bool2int(ctx, args):
    ctx.b.union(ctx.term(args[0]), ctx.term(args[1]))


def _c_bool_not(ctx, args):
    ctx.b.negb(ctx.term(args[0]), hint=ctx.term(args[1]))


def _c_bool_xor(ctx, args):
    if len(args) == 2:
        ctx.b.fix(ctx.b.eq(ctx.term(args[0]), ctx.term(args[1])), 0)
    else:
        e = ctx.b.eq(ctx.term(args[0]), ctx.term(args[1]))
        ctx.b.negb(e, hint=ctx.term(args[2]))


def _c_bool_and(ctx, args):
    ctx.b.fn(OP_MIN, ctx.term(args[0]), ctx.term(args[1]), hint=ctx.term(args[2]))


def _c_bool_or(ctx, args):
    ctx.b.fn(OP_MAX, ctx.term(args[0]), ctx.term(args[1]), hint=ctx.term(args[2]))


def _c_array_bool_and(ctx, args):
    elems = ctx.term_list(args[0])
    ctx.b.min_tree(elems, hint=ctx.term(args[1]))


def _c_array_bool_or(ctx, args):
    elems = ctx.term_list(args[0])
    ctx.b.max_tree(elems, hint=ctx.term(args[1]))


def _c_array_bool_xor(ctx, args):
    elems = ctx.term_list(args[0])
    n = len(elems)
    if n == 0:
        ctx.b.root_unsat = True
        return
    q = ctx.b.new_var(0, (n - 1) // 2)
    b = ctx.b.lin([1] * n + [-2], elems + [q], 1, 1)
    if b is not None:
        ctx.b.fix(b, 1)
        return
    s = ctx.b.linear([1] * n, elems)
    t = ctx.b.fn(OP_MUL, ctx.b.const(2), q)
    t1 = ctx.b.fn(OP_ADD, t, ctx.b.const(1))
    ctx.b.union(s, t1)


def _c_bool_clause(ctx, args):
    pos = ctx.term_list(args[0])
    neg = ctx.term_list(args[1])
    # sum(pos) - sum(neg) >= 1 - |neg|  <=>  -sum(pos) + sum(neg) <= |neg| - 1
    b = ctx.b.lin([-1] * len(pos) + [1] * len(neg), pos + neg, 0,
                  len(neg) - 1)
    if b is not None:
        ctx.b.fix(b, 1)
        return
    s = ctx.b.linear([-1] * len(pos) + [1] * len(neg), pos + neg)
    ctx.b.meet_dom(s, NINF, len(neg) - 1)


def _c_bool_clause_reif(ctx, args):
    pos = ctx.term_list(args[0])
    neg = ctx.term_list(args[1])
    terms = list(pos) + [ctx.b.negb(v) for v in neg]
    ctx.b.max_tree(terms, hint=ctx.term(args[2]))


def _element(ctx: _Ctx, idx, arr_vals_vars: List[int], res: int, const_vals=None):
    b = ctx.b
    if const_vals is not None and b.element(idx, res, const_vals):
        return  # native vectorized element propagator
    n = len(arr_vals_vars) if const_vals is None else len(const_vals)
    b.meet_dom(idx, 1, n)
    if const_vals is not None:
        b.meet_dom(res, min(const_vals), max(const_vals))
    li, ui = b.dom(idx)
    for j in range(max(1, li), min(n, ui) + 1):
        bj = b.eq(idx, b.const(j))
        tgt = b.const(const_vals[j - 1]) if const_vals is not None else arr_vals_vars[j - 1]
        ej = b.eq(res, tgt)
        b.fix(b.le(bj, ej), 1)


def _c_array_int_element(ctx, args):
    idx = ctx.term(args[0])
    vals = ctx.const_list(args[1])
    res = ctx.term(args[2])
    _element(ctx, idx, [], res, const_vals=vals)


def _c_array_var_int_element(ctx, args):
    idx = ctx.term(args[0])
    arr = ctx.term_list(args[1])
    res = ctx.term(args[2])
    _element(ctx, idx, arr, res)


def _c_set_in(ctx, args):
    x = ctx.term(args[0])
    vals = _set_values(args[1])
    if vals is None:
        raise CompileError("set_in: unsupported set argument")
    if isinstance(args[1], Range):
        ctx.b.meet_dom(x, args[1].lo, args[1].hi)
    else:
        ctx.b.meet_dom(x, min(vals), max(vals))
        if vals[-1] - vals[0] != len(vals) - 1:
            ctx.b.fix(ctx.b.in_set(x, vals), 1)


def _c_set_in_reif(ctx, args):
    x = ctx.term(args[0])
    vals = _set_values(args[1])
    if vals is None:
        raise CompileError("set_in_reif: unsupported set argument")
    ctx.b.in_set(x, vals, hint=ctx.term(args[2]))


def _c_bool_lin_eq(ctx, args):
    _c_int_lin_eq(ctx, args)


def _c_bool_lin_le(ctx, args):
    _c_int_lin_le(ctx, args)


_DISPATCH = {
    "int_lin_eq": _c_int_lin_eq,
    "int_lin_le": _c_int_lin_le,
    "int_lin_ne": _c_int_lin_ne,
    "int_lin_eq_reif": _c_int_lin_eq_reif,
    "int_lin_le_reif": _c_int_lin_le_reif,
    "int_lin_ne_reif": _c_int_lin_ne_reif,
    "int_eq": _c_int_eq,
    "int_ne": _c_int_ne,
    "int_le": _c_int_le,
    "int_lt": _c_int_lt,
    "int_eq_reif": _c_int_eq_reif,
    "int_ne_reif": _c_int_ne_reif,
    "int_le_reif": _c_int_le_reif,
    "int_lt_reif": _c_int_lt_reif,
    "int_abs": _c_int_abs,
    "int_times": _c_int_times,
    "int_div": _c_int_div,
    "int_mod": _c_int_mod,
    "int_min": _c_int_min,
    "int_max": _c_int_max,
    "int_plus": _c_int_plus,
    "int_minus": _c_int_minus,
    "bool2int": _c_bool2int,
    "bool_eq": _c_int_eq,
    "bool_ne": _c_int_ne,
    "bool_le": _c_int_le,
    "bool_lt": _c_int_lt,
    "bool_eq_reif": _c_int_eq_reif,
    "bool_ne_reif": _c_int_ne_reif,
    "bool_le_reif": _c_int_le_reif,
    "bool_lt_reif": _c_int_lt_reif,
    "bool_not": _c_bool_not,
    "bool_xor": _c_bool_xor,
    "bool_and": _c_bool_and,
    "bool_or": _c_bool_or,
    "array_bool_and": _c_array_bool_and,
    "array_bool_or": _c_array_bool_or,
    "array_bool_xor": _c_array_bool_xor,
    "bool_clause": _c_bool_clause,
    "bool_clause_reif": _c_bool_clause_reif,
    "array_int_element": _c_array_int_element,
    "array_var_int_element": _c_array_var_int_element,
    "array_bool_element": _c_array_int_element,
    "array_var_bool_element": _c_array_var_int_element,
    "set_in": _c_set_in,
    "set_in_reif": _c_set_in_reif,
    "bool_lin_eq": _c_bool_lin_eq,
    "bool_lin_le": _c_bool_lin_le,
    "int_lin_lt": None,  # replaced below
}


def _c_int_lin_lt(ctx, args):
    cs = ctx.const_list(args[0])
    xs = ctx.term_list(args[1])
    k = ctx.term(args[2])
    kv = ctx.b.find(k)
    if ctx.b.lb[kv] == ctx.b.ub[kv]:
        b = ctx.b.lin(cs, xs, 0, ctx.b.lb[kv] - 1)
        if b is not None:
            ctx.b.fix(b, 1)
            return
        s = ctx.b.linear(cs, xs)
        ctx.b.meet_dom(s, NINF, ctx.b.lb[kv] - 1)
    else:
        b = ctx.b.lin(list(cs) + [-1], xs + [k], 0, -1)
        if b is not None:
            ctx.b.fix(b, 1)
            return
        s = ctx.b.linear(cs, xs)
        s1 = ctx.b.fn(OP_ADD, s, ctx.b.const(1))
        ctx.b.fix(ctx.b.le(s1, k), 1)


_DISPATCH["int_lin_lt"] = _c_int_lin_lt


def _fold_tree(ctx, op, xs, hint):
    """Balanced fold of a binary TNF op over a list (depth log n, so
    the AC-1 fixpoint converges in O(log n) sweeps instead of O(n))."""
    if not xs:
        raise CompileError("empty array in array_int_minimum/maximum")
    if len(xs) == 1:
        ctx.b.union(xs[0], hint)
        return
    while len(xs) > 2:
        nxt = [ctx.b.fn(op, xs[i], xs[i + 1])
               for i in range(0, len(xs) - 1, 2)]
        if len(xs) % 2:
            nxt.append(xs[-1])
        xs = nxt
    ctx.b.fn(op, xs[0], xs[1], hint=hint)


def _c_array_int_minimum(ctx, args):
    # m = min(xs) (FlatZinc builtin array_int_minimum(m, xs); MiniZinc
    # emits it for min() over var arrays).
    _fold_tree(ctx, OP_MIN, ctx.term_list(args[1]), ctx.term(args[0]))


def _c_array_int_maximum(ctx, args):
    _fold_tree(ctx, OP_MAX, ctx.term_list(args[1]), ctx.term(args[0]))


def _c_int_pow(ctx, args):
    # z = x^n for a FIXED exponent n >= 0, as a square-and-multiply
    # OP_MUL chain (log n deep). A variable exponent has no TNF form;
    # fail loudly rather than drop the constraint.
    x, n, z = (ctx.term(a) for a in args)
    nv = ctx.b.find(n)
    if ctx.b.lb[nv] != ctx.b.ub[nv] or ctx.b.lb[nv] < 0:
        raise CompileError("int_pow requires a fixed exponent >= 0")
    e = int(ctx.b.lb[nv])
    if e == 0:
        ctx.b.union(z, ctx.b.const(1))
        return
    acc = None        # product of selected square terms
    sq = x            # x^(2^i)
    while e:
        if e & 1:
            acc = sq if acc is None else ctx.b.fn(OP_MUL, acc, sq)
        e >>= 1
        if e:
            sq = ctx.b.fn(OP_MUL, sq, sq)
    ctx.b.union(acc, z)


_DISPATCH["array_int_minimum"] = _c_array_int_minimum
_DISPATCH["array_int_maximum"] = _c_array_int_maximum
_DISPATCH["int_pow"] = _c_int_pow
