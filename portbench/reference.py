"""The plain reference: a FlatZinc reader and checker for the constraint
kinds that ``generators/`` write, and the reading of a MiniZinc
solver's printed output. It imports nothing of the program.

A printed solution is judged by what it says: every variable of the
model assigned, inside its declared domain, every constraint true, and
the objective statistic equal to the objective variable's value. A
proof (``==========`` after an optimisation) is judged against the
known optimum of the generator, and so is the objective a search that
does not close reaches in its window (the gap to the optimum).
"""
from __future__ import annotations

import dataclasses
import re

_VAR = re.compile(r"^var\s+(?:(-?\d+)\s*\.\.\s*(-?\d+)|bool|int)\s*:\s*(\w+)")
_ARRAY = re.compile(r"^array\s*\[1\.\.(\d+)\]\s+of\s+var\s+(?:int|bool)\s*:"
                    r"\s*(\w+).*=\s*\[(.*)\]\s*;$")
_CONS = re.compile(r"^constraint\s+(\w+)\((.*)\)\s*;$")
_SOLVE = re.compile(r"^solve\b.*?\b(minimize|maximize|satisfy)\s*(\w*)\s*;$")
_ASSIGN = re.compile(r"^(\w+) = (-?\d+|true|false);$")
_ARRAY_OUT = re.compile(r"^(\w+) = array\d+d\([^\[]*\[([^\]]*)\]\);$")
_STAT = re.compile(r"^%%%mzn-stat: (\w+)=(.*)$", re.M)

BIG = 1 << 40


def _split_args(s: str):
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return [_arg(a) for a in out]


def _arg(a: str):
    if a.startswith("["):
        return [_arg(x.strip()) for x in a[1:-1].split(",") if x.strip()]
    if re.fullmatch(r"-?\d+", a):
        return int(a)
    return a


@dataclasses.dataclass
class Model:
    domains: dict            # var -> (lo, hi)
    arrays: dict             # array name -> [var or int]
    constraints: list        # (kind, args)
    objective: str | None    # the minimised or maximised variable
    sense: str               # "minimize", "maximize" or "satisfy"


def parse(text: str) -> Model:
    domains, arrays, cons = {}, {}, []
    objective, sense = None, "satisfy"
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        m = _VAR.match(line)
        if m:
            lo, hi, name = m.groups()
            domains[name] = ((int(lo), int(hi)) if lo is not None
                             else (0, 1) if "bool" in line.split(":")[0]
                             else (-BIG, BIG))
            continue
        m = _ARRAY.match(line)
        if m:
            arrays[m.group(2)] = [_arg(x.strip())
                                  for x in m.group(3).split(",")]
            continue
        m = _CONS.match(line)
        if m:
            cons.append((m.group(1), _split_args(m.group(2))))
            continue
        m = _SOLVE.match(line)
        if m:
            sense = m.group(1)
            objective = m.group(2) or None
            continue
        raise ValueError(f"reference: unread FlatZinc line {line!r}")
    return Model(domains, arrays, cons, objective, sense)


def _val(x, sol):
    return x if isinstance(x, int) else sol[x]


def holds(kind: str, args, sol) -> bool:
    """Whether constraint ``kind(args)`` holds under the assignment."""
    if kind in ("int_eq", "int_ne", "int_lt", "int_le"):
        a, b = (_val(x, sol) for x in args)
        return {"int_eq": a == b, "int_ne": a != b, "int_lt": a < b,
                "int_le": a <= b}[kind]
    if kind in ("int_lin_eq", "int_lin_ne", "int_lin_le"):
        cs, xs, rhs = args
        s = sum(c * _val(x, sol) for c, x in zip(cs, xs))
        return {"int_lin_eq": s == rhs, "int_lin_ne": s != rhs,
                "int_lin_le": s <= rhs}[kind]
    raise ValueError(f"reference: no semantics for {kind}")


def violations(model: Model, sol: dict) -> int:
    """Variables unassigned or outside their domain, plus constraints
    that do not hold."""
    bad = 0
    for name, (lo, hi) in model.domains.items():
        if name not in sol:
            bad += 1
        elif not lo <= sol[name] <= hi:
            bad += 1
    if bad:
        return bad + len(model.constraints)
    return sum(not holds(k, a, sol) for k, a in model.constraints)


@dataclasses.dataclass
class Output:
    solutions: list          # dicts var -> value, in print order
    final: str | None        # "==========", "=====UNSATISFIABLE=====", ...
    stats: dict              # %%%mzn-stat key -> raw string


def read_output(model: Model, text: str) -> Output:
    """The solution blocks, the final separator and the statistics of a
    MiniZinc solver's standard output."""
    sols, cur, final = [], {}, None
    for line in text.splitlines():
        line = line.strip()
        if line == "----------":
            sols.append(cur)
            cur = {}
        elif line.startswith("=====") or line == "==========":
            final = line
        elif line.startswith("%") or not line:
            continue
        else:
            m = _ASSIGN.match(line)
            if m:
                v = m.group(2)
                cur[m.group(1)] = (1 if v == "true" else 0 if v == "false"
                                   else int(v))
                continue
            m = _ARRAY_OUT.match(line)
            if m and m.group(1) in model.arrays:
                vals = [int(x) for x in m.group(2).split(",")]
                for e, v in zip(model.arrays[m.group(1)], vals):
                    if isinstance(e, str):
                        cur.setdefault(e, v)
                continue
            cur.setdefault("__unread__", 0)
            cur["__unread__"] += 1
    return Output(sols, final, stats(text))


def stats(text: str) -> dict:
    """The ``%%%mzn-stat`` lines of an output: key -> raw string."""
    return dict(_STAT.findall(text))


@dataclasses.dataclass
class Judged:
    violations: int = 0        # constraints and domains broken, summed
    objective_mismatch: int = 0  # 1 when the statistic is not the value
    wrong_optimum: int = 0     # 1 for a proof of a value not the optimum
    unanswered: int = 0        # 1 when no solution was printed
    unproved: int = 0          # 1 when a proof was due and not printed
    objective_gap: int = 0     # the last solution's objective past the
    #                            known optimum

    def failed(self, limits=None) -> bool:
        """Whether a number compared is past its limit (``limits``: the
        numbers compared and their limits; by default ``LIMITS``)."""
        return any(getattr(self, k) > v
                   for k, v in (LIMITS if limits is None else limits).items())


def judge(model: Model, out: Output, expect: str,
          optimum: int | None) -> Judged:
    """One request's output against the model. ``expect`` is "proof"
    (the optimum proven) or "solution" (at least one solution)."""
    j = Judged()
    for sol in out.solutions:
        j.violations += violations(model, sol) + sol.get("__unread__", 0)
    if not out.solutions:
        j.unanswered = 1
    if model.objective is not None and out.solutions:
        last = out.solutions[-1].get(model.objective)
        if str(last) != out.stats.get("objective", "").strip():
            j.objective_mismatch = 1
        if optimum is not None and isinstance(last, int):
            j.objective_gap = abs(last - optimum)
    proved = out.final == "==========" and model.sense != "satisfy"
    if out.final == "=====UNSATISFIABLE=====":
        # Every generated model has solutions.
        j.wrong_optimum = 1
    if proved and (not out.solutions or optimum is None
                   or out.solutions[-1].get(model.objective) != optimum):
        j.wrong_optimum = 1
    if expect == "proof" and not proved:
        j.unproved = 1
    return j


# The counts of wrong answers, each with the limit 0. The objective gap
# has no limit here: how far a search gets in a window depends on the
# instance and the window, so a traffic mix that compares it states its
# limit (``limits`` in its file).
LIMITS = {f.name: 0 for f in dataclasses.fields(Judged)
          if f.name != "objective_gap"}
# The numbers compared for each kind of request: a request with no
# solution is also unproved where a proof is due, and only a proof can
# be unproved.
COMPARED = {"solution": ("violations", "objective_mismatch", "wrong_optimum",
                         "unanswered", "objective_gap"),
            "proof": ("violations", "objective_mismatch", "wrong_optimum",
                      "unproved")}
