"""Constraint-network analysis (observability parity).

Mirrors the reference's `analyze_cn` / `analyze_tcn`
(common_solving.hpp:670-826): model-shape statistics emitted as
mzn-stat lines before and after ternarization — symbol histograms,
variable-degree histograms, and domain-size distributions.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

import numpy as np

from ..core.ops import OP_NAMES
from ..frontend.ast import Model
from .tnf import Tnf


def analyze_formula(model: Model) -> Dict:
    """Pre-ternarization stats over the parsed constraint network."""
    ops = Counter(c.name for c in model.constraints)
    occ = Counter()
    for c in model.constraints:
        stack = list(c.args)
        while stack:
            a = stack.pop()
            if isinstance(a, str):
                occ[a] += 1
            elif isinstance(a, list):
                stack.extend(a)
    deg_hist = Counter(occ.values())
    return {
        "fcn_variables": len(model.vars),
        "fcn_constraints": len(model.constraints),
        "fcn_var_occurrences": sum(occ.values()),
        "fcn_histogram_symbols": dict(ops),
        "fcn_histogram_vars_degree": dict(sorted(deg_hist.items())),
    }


def analyze_tcn(tnf: Tnf, prefix: str = "tcn") -> Dict:
    """Post-ternarization stats over the TNF bytecode network."""
    ops = Counter(OP_NAMES[o] for o in tnf.ops)
    if tnf.elements:
        ops["element"] = len(tnf.elements)
    if tnf.members:
        ops["member"] = len(tnf.members)
    deg = np.zeros(tnf.num_vars, dtype=np.int64)
    for ids in (tnf.xs, tnf.ys, tnf.zs):
        if len(ids):
            np.add.at(deg, ids, 1)
    for e in tnf.elements:
        deg[e.idx] += 1
        deg[e.res] += 1
    for m in tnf.members:
        deg[m.x] += 1
        deg[m.b] += 1
    deg_hist = Counter(int(d) for d in deg if d > 0)
    sizes = np.minimum(tnf.ub0 - tnf.lb0 + 1, 1 << 20)
    size_hist = Counter()
    for s in sizes:
        if s <= 1:
            size_hist["1"] += 1
        elif s <= 2:
            size_hist["2"] += 1
        elif s <= 8:
            size_hist["3-8"] += 1
        elif s <= 64:
            size_hist["9-64"] += 1
        else:
            size_hist[">64"] += 1
    return {
        f"{prefix}_variables": tnf.num_vars,
        f"{prefix}_constraints": tnf.num_props + len(tnf.elements) + len(tnf.members),
        f"{prefix}_histogram_symbols": dict(ops),
        f"{prefix}_histogram_vars_degree": dict(sorted(deg_hist.items())),
        f"{prefix}_histogram_domain_sizes": dict(size_hist),
    }


def print_analysis(stats, model: Model, tnf: Tnf):
    """Emit all analysis stats through an MznStats printer."""
    for k, v in analyze_formula(model).items():
        stats.stat(k, v)
    for k, v in analyze_tcn(tnf).items():
        stats.stat(k, v)
