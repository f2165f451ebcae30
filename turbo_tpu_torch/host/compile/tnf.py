"""FlatZinc model -> ternary constraint network (TNF) compiler.

Plays the role of the reference's ``ternarize``/``normalize`` passes
plus parts of its ``Simplifier`` (equivalence classes over ``=``
constraints and incremental CSE), see
the reference's include/common_solving.hpp:520-585.  Everything here is
host-side Python; the output is a set of flat int arrays ready to be
uploaded to the device.

Design choices (TPU-first, not a translation of lala's ternarize):

* Constants are interned as singleton variables.
* Functional results are CSE'd at build time via a ``(op, y, z)`` memo
  (the reference runs i-CSE as a fixpoint pass afterwards; doing it
  during construction is cheaper and catches the dominant duplicates,
  e.g. repeated linear terms across wordpress constraints).
* Variable equalities (``bool2int``, ``int_eq``, reified results, ...)
  use a union-find; propagator operands are remapped through it at
  finalization, so unions may happen at any time during the build.
* Unary constraints (``x <= k`` etc.) become domain meets, not
  propagators.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.ops import (
    INF,
    NINF,
    OP_ADD,
    OP_DIV,
    OP_EQ,
    OP_LE,
    OP_MAX,
    OP_MIN,
    OP_MUL,
    interval_fwd,
)
from ..frontend.ast import Model, Range, SetLit


class CompileError(Exception):
    pass


@dataclasses.dataclass
class Strategy:
    var_order: str   # input_order | first_fail | anti_first_fail | smallest | largest | random
    val_order: str   # indomain_min | indomain_max | indomain_split | indomain_reverse_split
    # Variable ids (pre-finalize ids; finalized to rep ids). None = whole store.
    var_ids: Optional[np.ndarray]


@dataclasses.dataclass
class OutputItem:
    name: str
    is_array: bool
    is_bool: bool
    # For scalars: a single element; for arrays: all elements.
    # Each element is a (finalized) variable id.
    elems: List[int]
    dims: Optional[List[Tuple[int, int]]]


@dataclasses.dataclass
class ElementCon:
    """Native element constraint: values[idx - 1] == res (1-based idx).

    The reference receives array_int_element pre-decomposed only at the
    FlatZinc level and ternarizes it into eq/le chains; a dedicated
    vectorized propagator is both stronger (bounds-consistent on idx
    and res directly) and far cheaper on TPU (dense windowed reductions
    instead of thousands of reified propagators)."""
    idx: int
    res: int
    values: tuple


@dataclasses.dataclass
class MemberCon:
    """Native reified sparse membership: b = (x in values)."""
    x: int
    b: int
    values: tuple


LIN_LE = 0  # b = (sum coef*var <= rhs)
LIN_EQ = 1  # b = (sum coef*var == rhs)


@dataclasses.dataclass
class LinCon:
    """Native (reified) linear constraint: b = (sum c_i x_i <op> rhs).

    Hard constraints use b = the interned constant 1. Replaces the
    reference's ternarized sum trees with single-sweep bounds filtering
    (the classic linear propagator), which converges in one iteration
    instead of tree-depth iterations.
    """
    b: int
    op: int       # LIN_LE | LIN_EQ
    rhs: int
    coefs: tuple  # nonzero ints
    vars: tuple   # variable ids, same length


@dataclasses.dataclass
class Tnf:
    """Finalized ternary constraint network."""
    lb0: np.ndarray          # (V,) int64 root lower bounds
    ub0: np.ndarray          # (V,) int64 root upper bounds
    ops: np.ndarray          # (P,) int32
    xs: np.ndarray           # (P,) int32
    ys: np.ndarray           # (P,) int32
    zs: np.ndarray           # (P,) int32
    obj_var: int             # minimized variable id, or -1 (satisfaction)
    orig_obj_var: int        # original objective variable id (for printing), or -1
    is_max: bool
    strategies: List[Strategy]
    outputs: List[OutputItem]
    names: List[str]
    root_unsat: bool
    n_parsed_vars: int = 0
    n_parsed_cons: int = 0
    elements: List[ElementCon] = dataclasses.field(default_factory=list)
    members: List[MemberCon] = dataclasses.field(default_factory=list)
    linears: List[LinCon] = dataclasses.field(default_factory=list)
    # Declared-name -> finalized variable id (through the union-find).
    var_map: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def num_vars(self) -> int:
        return len(self.lb0)

    @property
    def num_props(self) -> int:
        return len(self.ops)


_COMMUTATIVE = {OP_ADD, OP_MUL, OP_MIN, OP_MAX, OP_EQ}


class Builder:
    def __init__(self):
        self.lb: List[int] = []
        self.ub: List[int] = []
        self.names: List[str] = []
        self.parent: List[int] = []
        self.props: List[Tuple[int, int, int, int]] = []
        self.const_ids: Dict[int, int] = {}
        self.memo: Dict[Tuple[int, int, int], int] = {}
        self.elements: List[Tuple[int, int, tuple]] = []
        self.members: List[Tuple[int, int, tuple]] = []
        self.linears: List[Tuple[int, int, int, tuple, tuple]] = []
        self.root_unsat = False

    # ---- variables -------------------------------------------------

    def new_var(self, lb: int, ub: int, name: str = "") -> int:
        v = len(self.lb)
        self.lb.append(max(NINF, min(INF, int(lb))))
        self.ub.append(max(NINF, min(INF, int(ub))))
        self.names.append(name)
        self.parent.append(v)
        return v

    def const(self, c: int) -> int:
        c = int(c)
        v = self.const_ids.get(c)
        if v is None:
            v = self.new_var(c, c, str(c))
            self.const_ids[c] = v
        return v

    def find(self, v: int) -> int:
        p = self.parent
        r = v
        while p[r] != r:
            r = p[r]
        while p[v] != r:
            p[v], v = r, p[v]
        return r

    def union(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        self.parent[rb] = ra
        self.meet_dom(ra, self.lb[rb], self.ub[rb])
        return ra

    def meet_dom(self, v: int, lo: int, hi: int):
        v = self.find(v)
        lo = max(NINF, min(INF, int(lo)))
        hi = max(NINF, min(INF, int(hi)))
        if lo > self.lb[v]:
            self.lb[v] = lo
        if hi < self.ub[v]:
            self.ub[v] = hi
        if self.lb[v] > self.ub[v]:
            self.root_unsat = True

    def dom(self, v: int) -> Tuple[int, int]:
        v = self.find(v)
        return self.lb[v], self.ub[v]

    def is_singleton(self, v: int) -> bool:
        v = self.find(v)
        return self.lb[v] == self.ub[v]

    # ---- propagators ----------------------------------------------

    def add_prop(self, op: int, x: int, y: int, z: int):
        self.props.append((op, x, y, z))

    def fn(self, op: int, y: int, z: int, hint: Optional[int] = None,
           name: str = "") -> int:
        """CSE'd functional result variable for `y op z`."""
        y, z = self.find(y), self.find(z)
        if op in _COMMUTATIVE and y > z:
            y, z = z, y
        # Constant folding.
        if self.lb[y] == self.ub[y] and self.lb[z] == self.ub[z]:
            lo, hi = interval_fwd(op, self.lb[y], self.ub[y], self.lb[z], self.ub[z])
            if lo == hi:
                c = self.const(lo)
                if hint is not None:
                    self.union(hint, c)
                return c
        # Algebraic identities (the cheap core of the reference
        # Simplifier's algebraic_simplify pass): fold to an alias
        # instead of emitting a propagator.
        zc = self.lb[z] == self.ub[z]
        yc = self.lb[y] == self.ub[y]
        if op == OP_ADD and zc and self.lb[z] == 0:
            return self._alias_result(y, hint)
        if op == OP_ADD and yc and self.lb[y] == 0:
            return self._alias_result(z, hint)
        if op == OP_MUL and zc and self.lb[z] == 1:
            return self._alias_result(y, hint)
        if op == OP_MUL and yc and self.lb[y] == 1:
            return self._alias_result(z, hint)
        if op in (OP_MIN, OP_MAX) and y == z:
            return self._alias_result(y, hint)
        if op == OP_EQ and y == z:
            c = self.const(1)
            if hint is not None:
                self.union(hint, c)
            return c
        if op == OP_LE and y == z:
            c = self.const(1)
            if hint is not None:
                self.union(hint, c)
            return c
        key = (op, y, z)
        x = self.memo.get(key)
        if x is not None:
            x = self.find(x)
            if hint is not None:
                x = self.union(hint, x)
                self.memo[key] = x
            return x
        if hint is not None:
            x = self.find(hint)
        else:
            lo, hi = interval_fwd(op, self.lb[y], self.ub[y], self.lb[z], self.ub[z])
            x = self.new_var(lo, hi, name)
        if op in (OP_LE, OP_EQ):
            self.meet_dom(x, max(0, self.lb[self.find(x)]), min(1, self.ub[self.find(x)]))
        self.memo[key] = x
        self.add_prop(op, x, y, z)
        return x

    def _alias_result(self, v: int, hint: Optional[int]) -> int:
        v = self.find(v)
        if hint is not None:
            return self.union(hint, v)
        return v

    def le(self, y: int, z: int, hint: Optional[int] = None) -> int:
        return self.fn(OP_LE, y, z, hint)

    def eq(self, y: int, z: int, hint: Optional[int] = None) -> int:
        return self.fn(OP_EQ, y, z, hint)

    def fix(self, b: int, val: int):
        self.meet_dom(b, val, val)

    def negb(self, a: int, hint: Optional[int] = None) -> int:
        """Boolean negation: r = 1 - a, encoded as 1 = r + a."""
        a = self.find(a)
        if self.lb[a] == self.ub[a]:
            c = self.const(1 - self.lb[a])
            if hint is not None:
                self.union(hint, c)
            return c
        key = (-1, a, a)  # pseudo-op for CSE of negation
        r = self.memo.get(key)
        if r is not None:
            r = self.find(r)
            if hint is not None:
                r = self.union(hint, r)
                self.memo[key] = r
            return r
        if hint is not None:
            r = self.find(hint)
        else:
            r = self.new_var(0, 1)
        self.meet_dom(r, 0, 1)
        self.memo[key] = r
        self.add_prop(OP_ADD, self.const(1), r, a)
        return r

    # ---- composite builders ----------------------------------------

    def scaled(self, c: int, x: int) -> int:
        if c == 1:
            return self.find(x)
        return self.fn(OP_MUL, self.const(c), x)

    def sum_tree(self, terms: List[int]) -> int:
        """Balanced ADD tree with CSE. Returns the sum variable."""
        if not terms:
            return self.const(0)
        layer = [self.find(t) for t in terms]
        while len(layer) > 1:
            nxt = []
            for i in range(0, len(layer) - 1, 2):
                nxt.append(self.fn(OP_ADD, layer[i], layer[i + 1]))
            if len(layer) % 2 == 1:
                nxt.append(layer[-1])
            layer = nxt
        return layer[0]

    def linear(self, coeffs: Sequence[int], xs: Sequence[int]) -> int:
        if len(coeffs) != len(xs):
            raise CompileError("linear: length mismatch")
        return self.sum_tree([self.scaled(c, x) for c, x in zip(coeffs, xs)])

    def min_tree(self, terms: List[int], hint=None) -> int:
        return self._fold_tree(OP_MIN, terms, hint, empty=1)

    def max_tree(self, terms: List[int], hint=None) -> int:
        return self._fold_tree(OP_MAX, terms, hint, empty=0)

    def _fold_tree(self, op: int, terms: List[int], hint, empty: int) -> int:
        if not terms:
            c = self.const(empty)
            if hint is not None:
                self.union(hint, c)
            return c
        layer = [self.find(t) for t in terms]
        while len(layer) > 1:
            nxt = []
            for i in range(0, len(layer) - 1, 2):
                is_top = len(layer) == 2
                nxt.append(self.fn(op, layer[i], layer[i + 1],
                                   hint if is_top else None))
            if len(layer) % 2 == 1:
                nxt.append(layer[-1])
            layer = nxt
        if hint is not None:
            return self.union(hint, layer[0])
        return layer[0]

    MAX_MEMBER_WIDTH = 4096

    def in_set(self, x: int, values: Sequence[int], hint=None) -> int:
        """Reified sparse membership: r = (x in values).

        Sparse sets with a modest hull width become native MemberCon
        propagators (vectorized value-table kernels); contiguous ranges
        stay two LE comparisons; pathological widths fall back to the
        reference-style eq/max decomposition."""
        x = self.find(x)
        values = sorted(set(int(v) for v in values))
        lo, hi = self.dom(x)
        values = [v for v in values if lo <= v <= hi]
        if not values:
            c = self.const(0)
            if hint is not None:
                self.union(hint, c)
            return c
        if values[-1] - values[0] == len(values) - 1:
            # Contiguous: r = (lo' <= x) & (x <= hi')
            b1 = self.le(self.const(values[0]), x)
            b2 = self.le(x, self.const(values[-1]))
            return self.fn(OP_MIN, b1, b2, hint)
        if values[-1] - values[0] + 1 <= self.MAX_MEMBER_WIDTH:
            key = ("member", x, tuple(values))
            b = self.memo.get(key)
            if b is not None:
                b = self.find(b)
                if hint is not None:
                    b = self.union(hint, b)
                    self.memo[key] = b
                return b
            b = self.find(hint) if hint is not None else self.new_var(0, 1)
            self.meet_dom(b, 0, 1)
            self.memo[key] = b
            self.members.append((x, b, tuple(values)))
            return b
        return self.max_tree([self.eq(x, self.const(v)) for v in values], hint)

    MAX_LIN_TERMS = 512

    def lin(self, coefs: Sequence[int], xs: Sequence[int], op: int,
            rhs: int, hint: Optional[int] = None) -> Optional[int]:
        """Native linear constraint b = (sum coef*x <op> rhs).
        Returns the reified b (or None if the term list exceeds the
        native limit; caller falls back to the sum-tree path).
        Constant terms fold into rhs; repeated vars merge."""
        acc = {}
        rhs = int(rhs)
        for c, x in zip(coefs, xs):
            c = int(c)
            if c == 0:
                continue
            x = self.find(x)
            if self.lb[x] == self.ub[x]:
                rhs -= c * self.lb[x]
                continue
            acc[x] = acc.get(x, 0) + c
        terms = [(c, x) for x, c in acc.items() if c != 0]
        if len(terms) > self.MAX_LIN_TERMS:
            return None
        if not terms:
            holds = (0 <= rhs) if op == LIN_LE else (0 == rhs)
            c = self.const(1 if holds else 0)
            if hint is not None:
                self.union(hint, c)
            return c
        coefs_t = tuple(c for c, _ in terms)
        vars_t = tuple(x for _, x in terms)
        key = ("lin", op, rhs, coefs_t, vars_t)
        b = self.memo.get(key)
        if b is not None:
            b = self.find(b)
            if hint is not None:
                b = self.union(hint, b)
                self.memo[key] = b
            return b
        b = self.find(hint) if hint is not None else self.new_var(0, 1)
        self.meet_dom(b, 0, 1)
        self.memo[key] = b
        self.linears.append((b, op, rhs, coefs_t, vars_t))
        return b

    MAX_ELEMENT_LEN = 2048

    def element(self, idx: int, res: int, values: Sequence[int]) -> bool:
        """Native element values[idx-1] == res; returns False if the
        table is too large for the native kernel (caller decomposes)."""
        values = [int(v) for v in values]
        if len(values) > self.MAX_ELEMENT_LEN:
            return False
        self.meet_dom(idx, 1, len(values))
        self.meet_dom(res, min(values), max(values))
        self.elements.append((self.find(idx), self.find(res), tuple(values)))
        return True
