"""Independent FlatZinc solution checker.

Evaluates the parsed Model's constraints directly on a complete
assignment (no TNF, no propagators) — an end-to-end guard for the
whole compile/solve pipeline, in the spirit of the reference's
golden-objective regression harness (test_turbo.sh) but per-solution.
"""
from __future__ import annotations

from typing import Dict, List

from ..frontend.ast import Constraint, Model, Range, SetLit


class CheckError(Exception):
    pass


def _tdiv(a, b):
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


class Checker:
    def __init__(self, model: Model, values: Dict[str, int]):
        self.model = model
        self.values = values
        self.arrays = {a.name: a for a in model.arrays}

    def val(self, arg):
        if isinstance(arg, (int,)):
            return int(arg)
        if isinstance(arg, str):
            if arg in self.values:
                return self.values[arg]
            arr = self.arrays.get(arg)
            if arr is not None and len(arr.elems) == 1:
                return self.val(arr.elems[0])
            raise CheckError(f"no value for {arg!r}")
        if isinstance(arg, tuple) and arg[0] == "access":
            return self.val(self.arrays[arg[1]].elems[arg[2] - 1])
        if isinstance(arg, tuple) and arg[0] == "call":
            return self._call(arg[1], [self.val(a) for a in arg[2]])
        raise CheckError(f"cannot evaluate {arg!r}")

    def vals(self, arg) -> List[int]:
        if isinstance(arg, str):
            arr = self.arrays.get(arg)
            if arr is None:
                return [self.val(arg)]
            return [self.val(e) for e in arr.elems]
        if isinstance(arg, list):
            return [self.val(e) for e in arg]
        raise CheckError(f"cannot evaluate list {arg!r}")

    def _call(self, name, a):
        if name in ("int_le", "bool_le"):
            return int(a[0] <= a[1])
        if name in ("int_lt", "bool_lt"):
            return int(a[0] < a[1])
        if name in ("int_eq", "bool_eq"):
            return int(a[0] == a[1])
        if name in ("int_ne", "bool_ne"):
            return int(a[0] != a[1])
        if name == "int_plus":
            return a[0] + a[1]
        if name == "int_times":
            return a[0] * a[1]
        if name == "int_min":
            return min(a)
        if name == "int_max":
            return max(a)
        if name == "int_abs":
            return abs(a[0])
        raise CheckError(f"unsupported call {name!r}")

    def holds(self, c: Constraint) -> bool:
        n, a = c.name, c.args
        v, vs = self.val, self.vals

        def setvals(arg):
            if isinstance(arg, Range):
                return range(arg.lo, arg.hi + 1)
            if isinstance(arg, SetLit):
                return arg.values
            raise CheckError(f"bad set arg {arg!r}")

        if n in ("int_lin_eq", "bool_lin_eq"):
            cs, xs, k = a[0], a[1], a[2]
            return sum(ci * xi for ci, xi in zip(vs(cs), vs(xs))) == v(k)
        if n in ("int_lin_le", "bool_lin_le"):
            return sum(ci * xi for ci, xi in zip(vs(a[0]), vs(a[1]))) <= v(a[2])
        if n == "int_lin_ne":
            return sum(ci * xi for ci, xi in zip(vs(a[0]), vs(a[1]))) != v(a[2])
        if n == "int_lin_lt":
            return sum(ci * xi for ci, xi in zip(vs(a[0]), vs(a[1]))) < v(a[2])
        if n == "int_lin_eq_reif":
            s = sum(ci * xi for ci, xi in zip(vs(a[0]), vs(a[1])))
            return (s == v(a[2])) == bool(v(a[3]))
        if n == "int_lin_le_reif":
            s = sum(ci * xi for ci, xi in zip(vs(a[0]), vs(a[1])))
            return (s <= v(a[2])) == bool(v(a[3]))
        if n == "int_lin_ne_reif":
            s = sum(ci * xi for ci, xi in zip(vs(a[0]), vs(a[1])))
            return (s != v(a[2])) == bool(v(a[3]))
        if n in ("int_eq", "bool_eq"):
            return v(a[0]) == v(a[1])
        if n in ("int_ne", "bool_ne"):
            return v(a[0]) != v(a[1])
        if n in ("int_le", "bool_le"):
            return v(a[0]) <= v(a[1])
        if n in ("int_lt", "bool_lt"):
            return v(a[0]) < v(a[1])
        if n in ("int_eq_reif", "bool_eq_reif"):
            return (v(a[0]) == v(a[1])) == bool(v(a[2]))
        if n in ("int_ne_reif", "bool_ne_reif"):
            return (v(a[0]) != v(a[1])) == bool(v(a[2]))
        if n in ("int_le_reif", "bool_le_reif"):
            return (v(a[0]) <= v(a[1])) == bool(v(a[2]))
        if n in ("int_lt_reif", "bool_lt_reif"):
            return (v(a[0]) < v(a[1])) == bool(v(a[2]))
        if n == "int_abs":
            return abs(v(a[0])) == v(a[1])
        if n == "int_times":
            return v(a[0]) * v(a[1]) == v(a[2])
        if n == "int_div":
            return _tdiv(v(a[0]), v(a[1])) == v(a[2])
        if n == "int_mod":
            x, m = v(a[0]), v(a[1])
            return x - m * _tdiv(x, m) == v(a[2])
        if n == "int_min":
            return min(v(a[0]), v(a[1])) == v(a[2])
        if n == "int_max":
            return max(v(a[0]), v(a[1])) == v(a[2])
        if n == "int_plus":
            return v(a[0]) + v(a[1]) == v(a[2])
        if n == "int_minus":
            return v(a[0]) - v(a[1]) == v(a[2])
        if n == "bool2int":
            return v(a[0]) == v(a[1])
        if n == "bool_not":
            return v(a[0]) != v(a[1])
        if n == "bool_xor":
            if len(a) == 2:
                return v(a[0]) != v(a[1])
            return (v(a[0]) != v(a[1])) == bool(v(a[2]))
        if n == "bool_and":
            return (bool(v(a[0])) and bool(v(a[1]))) == bool(v(a[2]))
        if n == "bool_or":
            return (bool(v(a[0])) or bool(v(a[1]))) == bool(v(a[2]))
        if n == "array_bool_and":
            return all(bool(x) for x in vs(a[0])) == bool(v(a[1]))
        if n == "array_bool_or":
            return any(bool(x) for x in vs(a[0])) == bool(v(a[1]))
        if n == "array_bool_xor":
            return sum(vs(a[0])) % 2 == 1
        if n == "bool_clause":
            return any(bool(x) for x in vs(a[0])) or \
                   any(not bool(x) for x in vs(a[1]))
        if n in ("array_int_element", "array_bool_element"):
            arr = vs(a[1])
            return arr[v(a[0]) - 1] == v(a[2])
        if n in ("array_var_int_element", "array_var_bool_element"):
            arr = vs(a[1])
            return arr[v(a[0]) - 1] == v(a[2])
        if n == "set_in":
            return v(a[0]) in setvals(a[1])
        if n == "set_in_reif":
            return (v(a[0]) in setvals(a[1])) == bool(v(a[2]))
        raise CheckError(f"unsupported constraint {n!r}")


def check_solution(model: Model, tnf, best_lb) -> List[str]:
    """Verify a solution store against the original model. Returns a
    list of violated-constraint descriptions (empty = valid). Also
    checks sparse variable domains."""
    values: Dict[str, int] = {vd.name: int(best_lb[tnf.var_map[vd.name]])
                              for vd in model.vars
                              if vd.name in tnf.var_map}
    ck = Checker(model, values)
    bad = []
    for vd in model.vars:
        val = values.get(vd.name)
        if val is None:
            continue
        if vd.sparse is not None and val not in vd.sparse:
            bad.append(f"{vd.name}={val} outside sparse domain")
        if vd.lb is not None and not (vd.lb <= val <= vd.ub):
            bad.append(f"{vd.name}={val} outside [{vd.lb},{vd.ub}]")
    for c in model.constraints:
        try:
            if not ck.holds(c):
                bad.append(f"violated {c.name}{c.args!r}"[:200])
        except CheckError as e:
            bad.append(f"cannot check {c.name}: {e}")
    return bad
