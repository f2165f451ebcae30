"""FlatZinc model AST.

Mirrors the information surfaced by the reference frontend
(`lala-parsing`'s ``parse_flatzinc``, used at
the reference's include/common_solving.hpp:404-417): variable
declarations with interval or sparse domains, parameter arrays,
constraint items, search annotations and the solve item, plus the
output annotations (``output_var`` / ``output_array``) consumed by
solution printing.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

# An argument of a constraint call after parsing:
#   int          -> integer literal (booleans are 0/1)
#   str          -> identifier (variable or array name)
#   Range        -> l..u set literal
#   SetLit       -> {a,b,c} set literal
#   list         -> array literal of the above
Arg = Union[int, str, "Range", "SetLit", list]


@dataclasses.dataclass(frozen=True)
class Range:
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class SetLit:
    values: Tuple[int, ...]


@dataclasses.dataclass
class VarDecl:
    name: str
    is_bool: bool
    lb: Optional[int]  # None = unbounded below ("var int")
    ub: Optional[int]
    sparse: Optional[Tuple[int, ...]]  # sparse domain {a,b,c}, else None
    output_var: bool = False
    introduced: bool = False
    defined: bool = False
    # RHS of "var ...: x = rhs;" (an identifier or literal), else None.
    alias: Optional[Union[int, str]] = None


@dataclasses.dataclass
class ArrayDecl:
    name: str
    # Elements are identifiers (str) or integer literals (bools as 0/1).
    elems: List[Union[int, str]]
    is_var: bool
    is_bool: bool
    # output_array([1..3,1..4]) annotation dims, as a list of (lo, hi).
    output_dims: Optional[List[Tuple[int, int]]] = None


@dataclasses.dataclass
class Constraint:
    name: str
    args: List[Arg]
    # defines_var(x) annotation target, if any.
    defines: Optional[str] = None


@dataclasses.dataclass
class SearchAnnotation:
    """int_search/bool_search(vars, var_order, value_order, complete)."""
    vars: List[Union[int, str]]  # identifiers (constants allowed, ignored)
    var_order: str               # input_order | first_fail | ...
    value_order: str             # indomain_min | indomain_max | ...


@dataclasses.dataclass
class SolveItem:
    kind: str  # "satisfy" | "minimize" | "maximize"
    objective: Optional[Union[int, str]]
    searches: List[SearchAnnotation]


@dataclasses.dataclass
class Model:
    vars: List[VarDecl]
    arrays: List[ArrayDecl]
    constraints: List[Constraint]
    solve: SolveItem
    path: str = ""

    def var_names(self):
        return [v.name for v in self.vars]
