"""The solver's CUDA kernels for Hopper and their wrappers.

Eleven kernels on PyTorch's current stream (``csrc/*.cu``), most of them
one thread block per dive (or table row):

- ``fixpoint`` (K1): AC-1 propagation to the fixpoint or the cap, on
  (D, V) planes; ``fixpoint.fixed_sweeps``: exactly n sweeps;
  ``fixpoint.transposed``: the fixpoint on dive-minor (V, D) planes;
  ``fixpoint.step``: the fixpoint, then K2's and K3's bodies on each
  dive's result in the same block (the search step's launch);
  ``fixpoint.step_stamped``: the same, with each block's clock stamps
  (the cycles before the epilogue and the epilogue's) and the launch's
  span on the global timer (profiled chunks only,
  ``solver/profile_split.py``);
  ``fixpoint.level``: one level of the EPS table build in one launch
  (each row's parent gathered into the block's store, the fixpoint,
  then K2's and K3's bodies: the 13 outputs of ``dive_level``);
- ``classify`` (K2): per dive, some domain empty / every propagator
  entailed;
- ``select`` (K3): branch variable and the two children;
- ``table_refill`` (K4): the table-row refill that seeds the first
  lanes, in place (K4's parent gather runs in the level entries);
- ``table_leaf`` (K4's leaf entry): the EPS table's leaf level, each
  surviving parent's children embedded into the table's planes, and
  the padding rows;
- ``open_count`` (K5): open right branches on the SOLVE-phase stacks,
  and in the same launch the plan of a steal round (``StealPlan``);
- ``step`` (K6): a search step around K1's step entry, in place: before it
  (``step.head``: the previous step's refill and ring rows, then
  promote and tighten) and after it (``step.post``: the per-lane rest
  of the step, then, in each shard's last block, the shard scan and the
  next step's live flag); ``step.head_timed`` and ``step.post_timed``:
  the same, with the launch's span on the global timer (profiled
  chunks only);
- ``step_tail`` (K7): the chunk's live flag (``step_tail.live``) and
  the last step's refill and ring rows (``step_tail.copy``);
- ``wac1`` (K8): WAC1 propagation (per op-group local fixpoints, then
  the element, membership and linear passes) to the fixpoint or the cap;
  ``wac1.step``: the same, then K2's and K3's bodies on each dive's
  result in the same block (the search step's launch under
  ``fp_mode="wac1"``); ``wac1.step_stamped``: the same, with the clock
  stamps and the span of ``fixpoint.step_stamped``; ``wac1.level``: K1's
  level entry with K8's fixpoint;
- ``steal`` (K9): a steal round applied in place on K5's plan;
- ``xcard`` (K10): the incumbent min and the live flag across card
  groups (``parallel/mesh.py``), reduced from the groups' slots at the
  head of each step; ``enable_peer`` turns on peer access between two
  cards for the slots' peer stores.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty`` unless the caller passes them
(``out=``), raises when the launch fails, and counts its launches in
``launches`` (and per entry point in ``entry_launches``). K1-K3 and K8
take an optional ``live`` flag (a 1-element int32 CUDA tensor): when it holds 0
the kernel returns at once. The plain versions live in
``solver/propagate.py``, ``solver/engine.py`` and
``solver/eps_table.py``; nothing here falls back to them.

``warm_up`` does, when a solver is built, what the first launch of each
kernel would do inside the ``-t`` window: the library's CUDA runtime,
every kernel's module load and the shared-memory attributes of the
plan's launches, after the plan's upload.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from .build import SOURCES, load

I32 = torch.int32


class PlanView(ctypes.Structure):
    """Mirror of ``struct PlanView`` in csrc/common.cuh."""
    _fields_ = [(n, ctypes.c_int if t == "i" else ctypes.c_void_p)
                for n, t in (
                    ("V", "i"), ("P", "i"), ("G", "i"), ("g_off", "p"),
                    ("E", "i"), ("T", "i"), ("e_idx", "p"), ("e_res", "p"),
                    ("e_len", "p"), ("e_tab", "p"), ("M", "i"), ("W", "i"),
                    ("m_x", "p"), ("m_b", "p"), ("m_base", "p"),
                    ("m_top", "p"), ("m_cnt", "p"), ("m_next_ge", "p"),
                    ("m_prev_le", "p"), ("m_next_out", "p"),
                    ("m_prev_out", "p"), ("L", "i"), ("base_lin", "i"),
                    ("base_linb", "i"), ("l_rhs", "p"), ("l_head", "p"),
                    ("l_term", "p"), ("LB", "i"), ("lb_off", "p"),
                    ("slot_tgt", "p"), ("tnf4", "p"), ("lb_floor", "p"),
                    ("ub_cap", "p"), ("v_pass", "p"), ("v_roff", "p"),
                    ("v_rule", "p"), ("S", "i"),
                    ("s_off", "p"), ("s_ids", "p"), ("s_vo", "p"),
                    ("s_valo", "p"))]


def kernel_tables(dp) -> dict:
    """The plan in the kernels' flat layout, as numpy arrays and ints:
    the op-groups as offsets into the propagators, concatenated linear
    rows (term offsets into the candidate slots) with the buckets as
    offsets into the rows,
    the bucketed incidence tables as CSR without neutral slots, the
    conflict fold without neutral entries, K1's routing of every slot
    (``slot_tgt``, their inverse: (code, value) per slot), the TNF and
    linear tables packed for one load per rule or term (``tnf4``,
    ``l_head``, ``l_term``), concatenated strategies. The kernels take
    the fields of ``PlanView``; the rest (the CSR, the fold, the flat
    row flags) is what the packed tables are built and tested from."""
    n = lambda t: t.cpu().numpy()
    neutral = dp.n_cand - 1
    inc_off, inc_slot = [0], []
    for start, count, idx in dp.buckets:
        for row in n(idx):
            inc_slot.extend(int(s) for s in row if s != neutral)
            inc_off.append(len(inc_slot))
    assert len(inc_off) == dp.n_active + 1
    l_b, l_op, l_rhs, l_K, l_toff, l_flags, l_coef, l_var = ([] for _ in range(8))
    off = 0
    g_off = [0] + [b for _, _, b in dp.group_slices]
    lb_off = np.cumsum([0] + [bk.coef.shape[0] for bk in dp.lin])
    for bk in dp.lin:
        C, K = bk.coef.shape
        l_b.append(n(bk.b)); l_op.append(n(bk.op))
        l_rhs.append(n(bk.rhs).astype(np.int64))
        l_K.append(np.full(C, K)); l_toff.append(off + K * np.arange(C))
        l_flags.append(np.full(C, int(bk.unit) | (int(bk.fit32) << 1)))
        l_coef.append(n(bk.coef).reshape(-1)); l_var.append(n(bk.var).reshape(-1))
        off += C * K
    cat = lambda xs, dt: (np.concatenate(xs) if xs else np.zeros(0)).astype(dt)
    conf_slot = conf_off = np.zeros(0, dtype=np.int32)
    if dp.conf_idx is not None:
        keep = n(dp.conf_idx) != neutral
        conf_slot, conf_off = n(dp.conf_idx)[keep], n(dp.conf_off)[keep]
    # K1 routes each candidate slot by the same decision, as (code,
    # value): (its target var, 0) (the inverse of the CSR), (TT_CONF(k)
    # = -2 - k, conf_off[k]) for a fold against conf_off[k], or
    # (TT_UNREAD = -1, 0) for a slot nothing reads.
    inc_slot = np.asarray(inc_slot, np.int64)
    conf = conf_slot.astype(np.int64)
    routed = np.concatenate([inc_slot, conf])
    # (bincount, not np.unique: the first np.unique of a process costs
    # about 0.07 s under numpy 2.3, inside the solve window.)
    assert np.bincount(routed, minlength=1).max() <= 1, \
        "a slot with two targets"
    slot_tgt = np.zeros((dp.n_cand, 2), np.int64)
    slot_tgt[:, 0] = -1
    slot_tgt[inc_slot, 0] = np.repeat(np.arange(dp.n_active),
                                      np.diff(inc_off))
    slot_tgt[conf, 0] = -2 - np.arange(len(conf))
    slot_tgt[conf, 1] = conf_off
    s_ids = [n(t) for t in dp.strat_ids]
    base_lin = 3 * dp.P + 2 * dp.E + 2 * dp.M
    # K8's passes in order: the op-groups, the element rows, the
    # membership rows, the linear buckets; bit min(pass, 31) of v_pass[v]
    # is set when a rule of the pass reads v.
    G = len(dp.group_slices)
    readers = [np.concatenate([n(dp.all_x[a:b]), n(dp.all_y[a:b]),
                               n(dp.all_z[a:b])])
               for _, a, b in dp.group_slices]
    readers += [np.concatenate([n(dp.e_idx), n(dp.e_res)]),
                np.concatenate([n(dp.m_x), n(dp.m_b)])]
    readers += [np.concatenate([n(bk.var).reshape(-1), n(bk.b)])
                for bk in dp.lin]
    v_pass = np.zeros(dp.V, np.int64)
    for k, vs in enumerate(readers):
        v_pass[vs.astype(np.int64)] |= 1 << min(k, 31)
    assert len(readers) == G + 2 + len(dp.lin)
    # K8's rules in one numbering (TNF, element, membership, linear rows)
    # and, as a CSR by variable, the rules that read each variable.
    rule_vars = [np.stack([n(dp.all_x), n(dp.all_y), n(dp.all_z)], axis=1),
                 np.stack([n(dp.e_idx), n(dp.e_res)], axis=1),
                 np.stack([n(dp.m_x), n(dp.m_b)], axis=1)]
    rule_vars += [np.concatenate([n(bk.b)[:, None], n(bk.var)], axis=1)
                  for bk in dp.lin]
    rv = np.concatenate([np.repeat(np.arange(len(x)) + sum(
        len(y) for y in rule_vars[:k]), x.shape[1]) for k, x in
        enumerate(rule_vars)] or [np.zeros(0, np.int64)])
    vv = np.concatenate([x.reshape(-1) for x in rule_vars] or
                        [np.zeros(0, np.int64)]).astype(np.int64)
    order = np.argsort(vv, kind="stable")
    v_roff = np.concatenate([[0], np.cumsum(np.bincount(vv, minlength=dp.V))])
    i32 = np.int32
    tabs = dict(
        V=dp.V, n_active=dp.n_active, P=dp.P, n_cand=dp.n_cand,
        prop_op=n(dp.prop_op), px=n(dp.all_x), py=n(dp.all_y), pz=n(dp.all_z),
        G=G, g_off=np.asarray(g_off, i32),
        E=dp.E, T=int(dp.e_tab.shape[1]), e_idx=n(dp.e_idx),
        e_res=n(dp.e_res), e_len=n(dp.e_len), e_tab=n(dp.e_tab),
        M=dp.M, W=dp.m_W, m_x=n(dp.m_x), m_b=n(dp.m_b),
        m_base=n(dp.m_base), m_top=n(dp.m_top), m_cnt=n(dp.m_cnt_flat),
        m_next_ge=n(dp.m_next_ge), m_prev_le=n(dp.m_prev_le),
        m_next_out=n(dp.m_next_out), m_prev_out=n(dp.m_prev_out),
        L=sum(len(x) for x in l_b), base_lin=base_lin,
        base_linb=base_lin + off,
        l_b=cat(l_b, i32), l_op=cat(l_op, i32), l_rhs=cat(l_rhs, np.int64),
        l_K=cat(l_K, i32), l_toff=cat(l_toff, i32),
        l_flags=cat(l_flags, i32), l_coef=cat(l_coef, i32),
        l_var=cat(l_var, i32), LB=len(dp.lin), lb_off=lb_off.astype(i32),
        # The same rows packed for one load each: (flags | op << 2, toff,
        # K, b) per row, (coef, var) per term.
        l_head=np.stack([cat(l_flags, i32) | cat(l_op, i32) << 2,
                         cat(l_toff, i32), cat(l_K, i32), cat(l_b, i32)],
                        axis=1).reshape(-1),
        l_term=np.stack([cat(l_coef, i32), cat(l_var, i32)],
                        axis=1).reshape(-1),
        inc_off=np.asarray(inc_off, i32), inc_slot=inc_slot,
        n_conf=len(conf_slot), conf_slot=conf_slot, conf_off=conf_off,
        slot_tgt=slot_tgt.reshape(-1),
        tnf4=np.stack([n(dp.prop_op), n(dp.all_x), n(dp.all_y),
                       n(dp.all_z)], axis=1).reshape(-1),
        lb_floor=n(dp.lb_floor), ub_cap=n(dp.ub_cap),
        # uint32 in the kernel: bit 31 wraps to the int32 sign.
        v_pass=(v_pass - ((v_pass >> 31) << 32)),
        v_roff=v_roff, v_rule=rv[order],
        S=len(s_ids),
        s_off=np.cumsum([0] + [len(s) for s in s_ids]).astype(i32),
        s_ids=cat(s_ids, i32), s_vo=np.asarray(dp.strat_vo, i32),
        s_valo=np.asarray(dp.strat_valo, i32))
    # Every table is int32 in the kernels except the int64 l_rhs.
    return {k: (np.ascontiguousarray(v, np.int64 if k == "l_rhs" else i32)
                if isinstance(v, np.ndarray) else v) for k, v in tabs.items()}


class KernelPlan:
    """The kernel tables of one plan on its CUDA device, and the PlanView
    that points at them (the tensors are kept alive here). Built once
    per plan by its owner (``PropagatorKernels.kernel_plan``)."""

    def __init__(self, dp):
        self.dp = dp
        tabs = kernel_tables(dp)
        self.tensors = {}
        view = {}
        for name, _ in PlanView._fields_:
            v = tabs[name]
            if isinstance(v, np.ndarray):
                t = torch.as_tensor(v).to(dp.device)
                self.tensors[name] = t
                view[name] = t.data_ptr()
            else:
                view[name] = int(v)
        self.view = PlanView(**view)
        self.smem_limit = torch.cuda.get_device_properties(
            dp.device).shared_memory_per_block_optin


class StepView(ctypes.Structure):
    """Mirror of ``struct StepView`` in csrc/step.cuh: the search state,
    K1-K3's outputs and the step scratch, as pointers (built by
    ``solver/step_cuda.py``)."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "D", "S", "V", "n_active", "MAXD", "obj", "is_opt",
        "enumerate_all", "use_table", "R", "n_pad")]
        + [(n, ctypes.c_void_p) for n in (
            "lb", "ub", "root_lb", "root_ub", "best_lb", "best_ub",
            "best_bound", "has_best", "dec_var", "dec_l0", "dec_u0",
            "dec_l1", "dec_u1", "dec_rope1", "dec_cur", "depth", "phase",
            "remaining", "subp", "strat", "snap_strat", "next_sub",
            "nonexh", "nodes", "fails", "sols", "fpit", "deds", "dmax",
            "solved_sub", "skipped_sub", "kpow", "sub_limit", "pscale",
            "eps_strat", "ext_bound", "tab_lb", "tab_ub", "tab_strat",
            "tab_path", "lb0", "ub0", "sol_ring", "sol_w", "iters",
            "unconv", "bot", "ent", "found", "var", "nstrat", "c0l", "c0u",
            "c1l", "c1u", "strat0", "want", "impr", "dleaf", "nxt",
            "newidx", "havework", "ridx", "steps", "tail_sync", "bmin",
            "xslots")]
        + [(n, ctypes.c_int) for n in ("xn", "xcard")])


class LevelView(ctypes.Structure):
    """Mirror of ``struct LevelView`` in csrc/level.cuh: one table level's
    inputs, its 13 outputs (in ``dive_level``'s order) and ``obj``."""
    INPUTS = ("lb_par", "ub_par", "strat_par", "var_par", "c0l", "c0u",
              "c1l", "c1u", "pidx", "pbit")
    OUTPUTS = ("lb", "ub", "strat", "var", "c0l_out", "c0u_out", "c1l_out",
               "c1u_out", "bot", "ent", "found", "iters", "objlb")
    _fields_ = ([(n, ctypes.c_void_p) for n in INPUTS + OUTPUTS]
                + [("obj", ctypes.c_int)])


def _check(t, name, shape, dtype=I32):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


class _Kernel:
    """A launch wrapper: ``launches`` counts the launches it made, and
    ``entry_launches`` those of each entry point in ``ENTRIES``."""
    name = source = replaces = ""
    ENTRIES = ()

    def __init__(self):
        self.reset()

    def reset(self):
        self.launches = 0
        self.entry_launches = dict.fromkeys(self.ENTRIES, 0)

    def _launch(self, fn, *args, entry=None):
        lib = load()
        rc = fn(lib)(*args)
        if rc != 0:
            msg = lib.tt_error_string(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} "
                               f"({rc})")
        self.launches += 1
        if entry is not None:
            self.entry_launches[entry] += 1


def _live_ptr(live):
    if live is None:
        return None
    _check(live, "live", (1,))
    return live.data_ptr()


def _stream_of(device):
    return torch.cuda.current_stream(device).cuda_stream


def _stream(t):
    return _stream_of(t.device)


# Static shared memory that K1's and K8's launches leave beside the
# dynamic one (csrc/epilogue.cuh ``TT_STATIC_SMEM``: the step and level
# entries' K2 and K3 words, the level entries' mbarrier).
STATIC_SMEM = 128


def fixpoint_smem_bytes(view) -> int:
    """Dynamic shared memory of K1's shared-memory path (csrc/fixpoint.cu
    ``smem_bytes``) for a PlanView: the flag words, the stores A and B
    (4 V int32), the worklist (P int32) and a byte per variable."""
    return 16 + 16 * view.V + 4 * view.P + -(-view.V // 16) * 16


def fixpoint_scratch_shape(D: int, view) -> tuple:
    """K1's global scratch on the global-memory path (``scratch_words``):
    per dive the store B (2 V int32), the worklist (P int32) and a byte
    per variable."""
    return (D, 2 * view.V + view.P + (view.V + 3) // 4)


def wac1_work_seg(view) -> int:
    """Entries of one warp's worklist in K8 (csrc/wac1.cu ``work_seg``)."""
    rules = view.P + view.E + view.M + view.L
    return 32 * ((rules // 32 + 1) // 8 + 1)


def wac1_smem_bytes(view) -> int:
    """Dynamic shared memory of K8's shared-memory path (csrc/wac1.cu
    ``smem_bytes``): 8 flag words, a dirty bit per rule and a claim bit
    per variable (each in words rounded up to 4), the stores A and B (4 V
    int32), the list of moved variables (V uint16) and eight worklists
    (uint16), each rounded up to 16 bytes."""
    rules = view.P + view.E + view.M + view.L
    head = 8 + -(-rules // 128) * 4 + -(-view.V // 128) * 4
    return (4 * head + 16 * view.V + -(-view.V // 8) * 16
            + -(-8 * wac1_work_seg(view) // 8) * 16)


def wac1_scratch_shape(D: int, view) -> tuple:
    """K8's global scratch on the global-memory path (``scratch_words``):
    per dive A and B (4 V int32), the list (V int32) and eight worklists
    (int32)."""
    return (D, 5 * view.V + 8 * wac1_work_seg(view))


def _fixpoint_out(lb, D, scratch):
    """Fresh outputs of K1 / K8: (lb_out, ub_out, iters, unconv,
    scratch)."""
    return (torch.empty_like(lb), torch.empty_like(lb),
            torch.empty(D, dtype=I32, device=lb.device),
            torch.empty(D, dtype=torch.bool, device=lb.device), scratch)


def _check_fixpoint(lb, ub, out, D, shape, scratch_shape):
    """Checks the planes and ``out``; the scratch only when
    ``scratch_shape`` is not None (the kernel reads it)."""
    _check(lb, "lb", shape)
    _check(ub, "ub", shape)
    lb_out, ub_out, iters, unconv, scratch = out
    for n, t, sh, dt in (
            ("lb_out", lb_out, shape, I32), ("ub_out", ub_out, shape, I32),
            ("iters", iters, (D,), I32),
            ("unconv", unconv, (D,), torch.bool)):
        _check(t, n, sh, dt)
    if scratch_shape is None:
        return None
    if scratch is None:
        raise ValueError(f"scratch: expected a tensor of {scratch_shape}")
    _check(scratch, "scratch", scratch_shape)
    return scratch.data_ptr()


def _no_propagators(lb, ub, out):
    """P == 0: the JAX functions return the store with zero counts."""
    lb_out, ub_out, iters, unconv, _ = out
    if lb_out is not lb:
        lb_out.copy_(lb)
        ub_out.copy_(ub)
    iters.zero_()
    unconv.zero_()
    return lb_out, ub_out, iters, unconv


class _Propagator(_Kernel):
    """What K1 and K8 share: the stores in shared memory when they fit,
    else a global scratch row per dive; a step entry that classifies and
    selects in the same block; the occupancy query."""
    PREFIX = ""  # the C entry points' prefix: tt_<prefix>_step, ...

    @staticmethod
    def smem_bytes(view) -> int:
        raise NotImplementedError

    @staticmethod
    def scratch_shape(D: int, view) -> tuple:
        raise NotImplementedError

    def uses_smem(self, kp, smem: bool = True) -> bool:
        """Whether a launch keeps the stores in shared memory; otherwise
        it needs ``scratch``."""
        return smem and (self.smem_bytes(kp.view) + STATIC_SMEM
                         <= kp.smem_limit)

    def scratch(self, kp, D: int, smem: bool = True):
        """The global scratch of D dives (``scratch_shape``) when the
        launch does not keep its stores in shared memory, else None."""
        if self.uses_smem(kp, smem):
            return None
        return torch.empty(self.scratch_shape(D, kp.view), dtype=I32,
                           device=kp.dp.device)

    def _scratch_ptr(self, kp, lb, ub, out, D, shape, smem):
        return _check_fixpoint(lb, ub, out, D, shape,
                               None if self.uses_smem(kp, smem)
                               else self.scratch_shape(D, kp.view))

    def _step(self, kp, lb, ub, strat, smem, live, out, args, stamps=None,
              span=None):
        """The step entry ``tt_<PREFIX>_step`` with the integer arguments
        ``args`` after the scratch: (lb, ub, iters, unconv, bot, ent,
        found, var, chosen, valo, c0l, c0u, c1l, c1u). With ``stamps``
        ((D, 2) int64) and ``span`` ((2,) int64) the stamped entry
        ``tt_<PREFIX>_step_stamped``, which also writes each block's
        clock stamps and the launch's span on the global timer there.
        With no propagator (P == 0) the fixpoint is the copy of
        ``__call__``, K2 and K3 run as launches of their own, and the
        stamps are 0 and the span is left as it was."""
        dp = kp.dp
        D = lb.shape[0]
        _check(strat, "strat", (D,))
        if stamps is not None:
            _check(stamps, "stamps", (D, 2), torch.int64)
            _check(span, "span", (2,), torch.int64)
        if out is None:
            out = _fixpoint_out(lb, D, self.scratch(kp, D, smem)) + (
                *(torch.empty(D, dtype=torch.bool, device=lb.device)
                  for _ in range(3)),
                *(torch.empty(D, dtype=I32, device=lb.device)
                  for _ in range(7)))
        fp_out, sel_out = out[:5], out[7:]
        scratch = self._scratch_ptr(kp, lb, ub, fp_out, D, (D, dp.V), smem)
        for n, t in (("bot", out[5]), ("ent", out[6]),
                     ("found", sel_out[0])):
            _check(t, n, (D,), torch.bool)
        for i, o in enumerate(sel_out[1:]):
            _check(o, f"out[{i + 8}]", (D,))
        if dp.P == 0:
            if stamps is not None:
                stamps.zero_()
            res = _no_propagators(lb, ub, fp_out)
            return res + classify(kp, res[0], res[1], live, out[5:7]) + \
                select(kp, res[0], res[1], strat, live, sel_out)
        lb_out, ub_out, iters, unconv, _ = fp_out
        entry = "step" if stamps is None else "step_stamped"
        with torch.cuda.device(lb.device):
            self._launch(lambda lib: getattr(lib, f"tt_{self.PREFIX}_{entry}"),
                         ctypes.byref(kp.view), lb.data_ptr(), ub.data_ptr(),
                         lb_out.data_ptr(), ub_out.data_ptr(),
                         iters.data_ptr(), unconv.data_ptr(), scratch, D,
                         *args, kp.smem_limit if smem else 0,
                         _live_ptr(live), _stream(lb), strat.data_ptr(),
                         *(t.data_ptr() for t in out[5:]),
                         *(() if stamps is None else (stamps.data_ptr(),
                                                      span.data_ptr())),
                         entry=entry)
        return (lb_out, ub_out, iters, unconv) + tuple(out[5:])

    def level(self, kp, chunk, obj: int, *args, smem: bool = True):
        """One level of the EPS table build in one launch (csrc/level.cuh):
        ``chunk`` holds ``dive_level``'s ten inputs (the previous chunk's
        lb, ub (Wp, V), strat, var, c0l, c0u, c1l, c1u (Wp,), then pidx
        and pbit (W,)); ``args`` the launch's caps (``level``'s
        signature in each kernel). Returns ``dive_level``'s 13 outputs:
        (lb, ub, strat, var, c0l, c0u, c1l, c1u, bot, ent, found, iters,
        objlb), ``objlb`` being lb[:, obj]."""
        dp = kp.dp
        lb_par = chunk[0]
        Wp, W = lb_par.shape[0], chunk[8].shape[0]
        for name, t in zip(LevelView.INPUTS, chunk):
            _check(t, name, (Wp, dp.V) if name in ("lb_par", "ub_par") else
                   (W,) if name in ("pidx", "pbit") else (Wp,))
        dev = lb_par.device
        out = (torch.empty((W, dp.V), dtype=I32, device=dev),
               torch.empty((W, dp.V), dtype=I32, device=dev),
               *(torch.empty(W, dtype=I32, device=dev) for _ in range(6)),
               *(torch.empty(W, dtype=torch.bool, device=dev)
                 for _ in range(3)),
               torch.empty(W, dtype=I32, device=dev),
               torch.empty(W, dtype=I32, device=dev))
        scratch = self.scratch(kp, W, smem)
        names = LevelView.INPUTS + LevelView.OUTPUTS
        view = LevelView(obj=int(obj) % dp.V, **{
            n: t.data_ptr() for n, t in zip(names, tuple(chunk) + out)})
        with torch.cuda.device(dev):
            self._launch(lambda lib: getattr(lib, f"tt_{self.PREFIX}_level"),
                         ctypes.byref(kp.view), ctypes.byref(view),
                         None if scratch is None else scratch.data_ptr(), W,
                         *(int(a) for a in args),
                         kp.smem_limit if smem else 0, _stream(lb_par),
                         entry="level")
        return out

    def blocks_per_sm(self, kp, entry: str = "step") -> int:
        """Resident blocks per SM of a shared-memory launch of ``entry``
        (``"step"``, ``"level"``, ``"step_stamped"``, or the fixpoint's
        other entries) at this plan's shared memory
        (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
        blocks = ctypes.c_int(0)
        lib = load()
        fn = getattr(lib, f"tt_{self.PREFIX}_blocks_per_sm")
        with torch.cuda.device(kp.dp.device):
            rc = fn(ctypes.byref(kp.view),
                    {"step": 1, "level": 2, "step_stamped": 3}.get(entry, 0),
                    kp.smem_limit,
                    ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"{self.name} occupancy query failed: "
                               f"{lib.tt_error_string(rc).decode()} ({rc})")
        return blocks.value


class _Fixpoint(_Propagator):
    name = "fixpoint"
    source = "turbo_tpu_torch/kernels/csrc/fixpoint.cu"
    replaces = "turbo_tpu/solver/propagate_jax.py:912"
    PREFIX = "fixpoint"
    ENTRIES = ("fixpoint", "fixed_sweeps", "transposed", "step", "level",
               "step_stamped")
    # The step entry replaces the fixpoint (912), all_entailed / is_bot
    # (983) and _select / _children (engine.py:550) of one JAX step; the
    # level entry the table build's dive program, _embed included.
    ENTRY_REPLACES = {"fixed_sweeps": "turbo_tpu/solver/propagate_jax.py:967",
                      "transposed": "turbo_tpu/solver/propagate_jax.py:782",
                      "step": "turbo_tpu/solver/propagate_jax.py:912",
                      "level": "turbo_tpu/solver/eps_table.py:122",
                      "step_stamped": "turbo_tpu/solver/propagate_jax.py:912"}
    smem_bytes = staticmethod(fixpoint_smem_bytes)
    scratch_shape = staticmethod(fixpoint_scratch_shape)

    def _run(self, entry, kp, lb, ub, cap, smem, live, out):
        dp = kp.dp
        transposed = entry == "transposed"
        D = lb.shape[1] if transposed else lb.shape[0]
        shape = (dp.V, D) if transposed else (D, dp.V)
        if out is None:
            out = _fixpoint_out(lb, D, self.scratch(kp, D, smem))
        scratch = self._scratch_ptr(kp, lb, ub, out, D, shape, smem)
        if dp.P == 0:
            return _no_propagators(lb, ub, out)
        lb_out, ub_out, iters, unconv, _ = out
        fn = {"fixpoint": "tt_fixpoint", "fixed_sweeps": "tt_fixed_sweeps",
              "transposed": "tt_fixpoint_t"}[entry]
        with torch.cuda.device(lb.device):
            self._launch(lambda lib: getattr(lib, fn), ctypes.byref(kp.view),
                         lb.data_ptr(), ub.data_ptr(), lb_out.data_ptr(),
                         ub_out.data_ptr(), iters.data_ptr(),
                         unconv.data_ptr(), scratch, D, int(cap),
                         kp.smem_limit if smem else 0, _live_ptr(live),
                         _stream(lb), entry=entry)
        return lb_out, ub_out, iters, unconv

    def __call__(self, kp, lb, ub, cap: int, smem: bool = True, live=None,
                 out=None):
        """(lb, ub, iters (D,) int32, unconv (D,) bool) after AC-1 sweeps
        to the fixpoint or ``cap``; see csrc/fixpoint.cu. The stores sit
        in shared memory when they fit; ``smem=False`` forces the
        global-memory path that larger stores take. ``out`` = (lb_out,
        ub_out, iters, unconv, scratch): lb_out and ub_out may be lb and
        ub (in place); scratch is ``self.scratch(kp, D, smem)`` (None on
        the shared-memory path)."""
        return self._run("fixpoint", kp, lb, ub, cap, smem, live, out)

    def fixed_sweeps(self, kp, lb, ub, n: int, smem: bool = True, live=None,
                     out=None):
        """Exactly ``n`` AC-1 sweeps of every dive, whether or not it
        converged or turned bot: iters = n, unconv all false."""
        return self._run("fixed_sweeps", kp, lb, ub, n, smem, live, out)

    def transposed(self, kp, lbT, ubT, cap: int, smem: bool = True,
                   live=None, out=None):
        """The fixpoint of ``__call__`` on dive-minor planes: lbT, ubT
        and the first two outputs are (V, D)."""
        return self._run("transposed", kp, lbT, ubT, cap, smem, live, out)

    def step(self, kp, lb, ub, cap: int, strat, smem: bool = True,
             live=None, out=None):
        """The fixpoint of ``__call__``, then K2 and K3 on each dive's
        result in the same block: (lb, ub, iters, unconv, bot, ent, found,
        var, chosen, valo, c0l, c0u, c1l, c1u), the outputs of
        ``__call__``, ``classify`` and ``select`` (from the cursors
        ``strat``) in one launch. ``out``: the five tensors of
        ``__call__``'s ``out``, then the ten of ``classify`` and
        ``select``."""
        return self._step(kp, lb, ub, strat, smem, live, out, (int(cap),))

    def step_stamped(self, kp, lb, ub, cap: int, strat, stamps, span,
                     smem: bool = True, live=None, out=None):
        """``step``, each block's clock stamps into ``stamps`` ((D, 2)
        int64, csrc/epilogue.cuh): the cycles of the load, the sweeps and
        the row write, then the epilogue's; and the launch's span on the
        global timer into ``span`` ((2,) int64, set to (INT64_MAX, 0)
        before: the first block's start and the last block's end in ns,
        csrc/common.cuh). Its other outputs are ``step``'s, bit for bit;
        profiled chunks launch it (``solver/profile_split.py``)."""
        return self._step(kp, lb, ub, strat, smem, live, out, (int(cap),),
                          stamps, span)

    def level(self, kp, chunk, obj: int, cap: int, smem: bool = True):
        """One table level: each row's parent gathered and met with its
        child interval, the AC-1 fixpoint (``cap`` sweeps at most), then
        K2 and K3 on the result; see ``_Propagator.level``."""
        return super().level(kp, chunk, obj, cap, smem=smem)


class _Wac1(_Propagator):
    name = "wac1"
    source = "turbo_tpu_torch/kernels/csrc/wac1.cu"
    replaces = "turbo_tpu/solver/propagate_jax.py:884"
    PREFIX = "wac1"
    ENTRIES = ("wac1", "step", "level", "step_stamped")
    # The step entry replaces fixpoint_wac1 (884), all_entailed / is_bot
    # (983) and _select / _children (engine.py:550) of one JAX step; the
    # level entry the table build's dive program under fp_mode="wac1".
    ENTRY_REPLACES = {"step": "turbo_tpu/solver/propagate_jax.py:884",
                      "level": "turbo_tpu/solver/eps_table.py:122",
                      "step_stamped": "turbo_tpu/solver/propagate_jax.py:884"}
    smem_bytes = staticmethod(wac1_smem_bytes)
    scratch_shape = staticmethod(wac1_scratch_shape)

    def uses_smem(self, kp, smem: bool = True) -> bool:
        # The shared-memory path keeps uint16 worklist entries.
        return super().uses_smem(kp, smem) and wac1_work_seg(kp.view) <= 65536

    def __call__(self, kp, lb, ub, cap: int, inner_cap: int = 16,
                 smem: bool = True, live=None, out=None):
        """(lb, ub, sweeps + 1 (D,) int32, unconv (D,) bool) after WAC1
        sweeps to the fixpoint or ``cap``; see csrc/wac1.cu. ``smem`` and
        ``out`` (lb_out, ub_out, iters, unconv, scratch) as for K1. The
        stores must lie inside the root box's clamp (lb <= ub0 + 1, ub >=
        lb0 - 1), as every engine state does."""
        dp = kp.dp
        D = lb.shape[0]
        if out is None:
            out = _fixpoint_out(lb, D, self.scratch(kp, D, smem))
        scratch = self._scratch_ptr(kp, lb, ub, out, D, (D, dp.V), smem)
        if dp.P == 0:
            return _no_propagators(lb, ub, out)
        lb_out, ub_out, iters, unconv, _ = out
        with torch.cuda.device(lb.device):
            self._launch(lambda lib: lib.tt_wac1, ctypes.byref(kp.view),
                         lb.data_ptr(), ub.data_ptr(), lb_out.data_ptr(),
                         ub_out.data_ptr(), iters.data_ptr(),
                         unconv.data_ptr(), scratch, D, int(cap),
                         int(inner_cap), kp.smem_limit if smem else 0,
                         _live_ptr(live), _stream(lb), entry="wac1")
        return lb_out, ub_out, iters, unconv

    def step(self, kp, lb, ub, cap: int, inner_cap: int, strat,
             smem: bool = True, live=None, out=None):
        """The fixpoint of ``__call__``, then K2 and K3 on each dive's
        result in the same block: the 14 outputs of K1's ``step`` in one
        launch, ``out`` as there."""
        return self._step(kp, lb, ub, strat, smem, live, out,
                          (int(cap), int(inner_cap)))

    def step_stamped(self, kp, lb, ub, cap: int, inner_cap: int, strat,
                     stamps, span, smem: bool = True, live=None, out=None):
        """``step`` with K1's ``step_stamped`` clock stamps and span."""
        return self._step(kp, lb, ub, strat, smem, live, out,
                          (int(cap), int(inner_cap)), stamps, span)

    def level(self, kp, chunk, obj: int, cap: int, inner_cap: int,
              smem: bool = True):
        """K1's ``level`` with K8's fixpoint (outer cap ``cap``, inner cap
        ``inner_cap``)."""
        return super().level(kp, chunk, obj, cap, inner_cap, smem=smem)


class _Classify(_Kernel):
    name = "classify"
    source = "turbo_tpu_torch/kernels/csrc/classify.cu"
    replaces = "turbo_tpu/solver/propagate_jax.py:983"

    def __call__(self, kp, lb, ub, live=None, out=None):
        """(bot, ent) as (D,) bool; see csrc/classify.cu. ``out``: the
        two output tensors."""
        D = lb.shape[0]
        _check(lb, "lb", (D, kp.dp.V))
        _check(ub, "ub", (D, kp.dp.V))
        if out is None:
            out = tuple(torch.empty(D, dtype=torch.bool, device=lb.device)
                        for _ in range(2))
        bot, ent = out
        _check(bot, "bot", (D,), torch.bool)
        _check(ent, "ent", (D,), torch.bool)
        with torch.cuda.device(lb.device):
            self._launch(lambda lib: lib.tt_classify, ctypes.byref(kp.view),
                         lb.data_ptr(), ub.data_ptr(), bot.data_ptr(),
                         ent.data_ptr(), D, _live_ptr(live), _stream(lb))
        return bot, ent


class _Select(_Kernel):
    name = "select"
    source = "turbo_tpu_torch/kernels/csrc/select.cu"
    replaces = "turbo_tpu/solver/engine.py:550"

    def __call__(self, kp, lb, ub, strat, live=None, out=None):
        """(found, var, chosen, valo, c0l, c0u, c1l, c1u), each (D,);
        see csrc/select.cu. ``out``: the eight output tensors."""
        D = lb.shape[0]
        _check(lb, "lb", (D, kp.dp.V))
        _check(ub, "ub", (D, kp.dp.V))
        _check(strat, "strat", (D,))
        if out is None:
            out = (torch.empty(D, dtype=torch.bool, device=lb.device),
                   *(torch.empty(D, dtype=I32, device=lb.device)
                     for _ in range(7)))
        found, *outs = out
        _check(found, "found", (D,), torch.bool)
        for i, o in enumerate(outs):
            _check(o, f"out[{i + 1}]", (D,))
        with torch.cuda.device(lb.device):
            self._launch(lambda lib: lib.tt_select, ctypes.byref(kp.view),
                         lb.data_ptr(), ub.data_ptr(), strat.data_ptr(),
                         found.data_ptr(), *(o.data_ptr() for o in outs), D,
                         _live_ptr(live), _stream(lb))
        return (found, *outs)


class _TableRefill(_Kernel):
    name = "table_refill"
    source = "turbo_tpu_torch/kernels/csrc/table_refill.cu"
    replaces = "turbo_tpu/solver/engine.py:696"

    def __call__(self, tab_lb, tab_ub, idx, refill, lb, ub, root_lb,
                 root_ub):
        """In place: every lane d with refill[d] takes table row
        clip(idx[d], 0, n_pad - 1) into lb, ub, root_lb and root_ub; see
        csrc/table_refill.cu."""
        n_pad, V = tab_lb.shape
        D = lb.shape[0]
        _check(tab_lb, "tab_lb", (n_pad, V))
        _check(tab_ub, "tab_ub", (n_pad, V))
        _check(idx, "idx", (D,))
        _check(refill, "refill", (D,), torch.bool)
        for n, t in (("lb", lb), ("ub", ub), ("root_lb", root_lb),
                     ("root_ub", root_ub)):
            _check(t, n, (D, V))
        with torch.cuda.device(lb.device):
            self._launch(lambda lib: lib.tt_table_refill, tab_lb.data_ptr(),
                         tab_ub.data_ptr(), idx.data_ptr(),
                         refill.data_ptr(), lb.data_ptr(), ub.data_ptr(),
                         root_lb.data_ptr(), root_ub.data_ptr(), D, n_pad, V,
                         _stream(lb))


class _TableLeaf(_Kernel):
    name = "table_leaf"
    source = "turbo_tpu_torch/kernels/csrc/table_leaf.cu"
    replaces = "turbo_tpu/solver/eps_table.py:325"

    def __call__(self, chunks, rows, lb0, ub0, n_pad: int, eps_skip: int):
        """The (n_pad, V) ``lb``, ``ub`` and (n_pad,) ``strat``, ``path``
        of ``eps_table.table_leaf_plain`` for the same arguments (``rows``
        a host array), new tensors on lb0's card; see
        csrc/table_leaf.cu. The row indices and the chunks' pointers go
        up in one copy; the launch does not synchronise."""
        V = lb0.shape[0]
        _check(lb0, "lb0", (V,))
        _check(ub0, "ub0", (V,))
        rows = np.ascontiguousarray(rows, np.int32)
        n_live = rows.shape[0]
        if rows.shape != (n_live, 4) or not 0 <= n_live <= n_pad:
            raise ValueError(f"rows: expected (n, 4) with n <= {n_pad}, "
                             f"got {rows.shape}")
        widths, ptrs = [], []
        for c, ch in enumerate(chunks):
            W = ch[0].shape[0]
            for name, t in zip(("lb", "ub", "strat", "var", "c0l", "c0u",
                                "c1l", "c1u"), ch):
                _check(t, f"chunks[{c}].{name}", (W, V) if name in (
                    "lb", "ub") else (W,))
            widths.append(W)
            ptrs.extend(t.data_ptr() for t in ch)
        c, i, bit = rows[:, 0], rows[:, 1], rows[:, 2]
        inside = (0 <= c) & (c < len(chunks)) & ((bit == 0) | (bit == 1))
        if not (inside.all() and (0 <= i).all()
                and (i < np.asarray(widths)[c]).all()):
            raise ValueError("rows: a chunk or a parent row out of range, "
                             "or a bit other than 0 and 1")
        buf = np.empty(2 * len(ptrs) + 4 * n_live, np.int32)
        buf[:2 * len(ptrs)].view(np.int64)[:] = ptrs
        buf[2 * len(ptrs):] = rows.reshape(-1)
        idx = torch.from_numpy(buf).to(lb0.device)
        out = (torch.empty((n_pad, V), dtype=I32, device=lb0.device),
               torch.empty((n_pad, V), dtype=I32, device=lb0.device),
               torch.empty(n_pad, dtype=I32, device=lb0.device),
               torch.empty(n_pad, dtype=I32, device=lb0.device))
        planes = [lb0, ub0, *out[:2]] + [t for ch in chunks for t in ch[:2]]
        vec = V % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in planes)
        with torch.cuda.device(lb0.device):
            self._launch(lambda lib: lib.tt_table_leaf, idx.data_ptr(),
                         idx.data_ptr() + 8 * len(ptrs), lb0.data_ptr(),
                         ub0.data_ptr(), *(t.data_ptr() for t in out),
                         n_live, n_pad, V, int(eps_skip), int(vec),
                         _stream(lb0))
        return out


class StealPlan:
    """K5's workspace and the steal plan it leaves for K9, for D lanes of
    MAXD-deep stacks on one card (csrc/steal.cuh): one int32 buffer, the
    head words (K5's ticket, counters and the plan's sizes), the per-depth
    histogram and seven (D,) arrays. K5 leaves its counters at 0 and the
    ``last`` links at -1, so a plan is reused from round to round without
    a memset. Owned by its solver (or made per call of ``open_count``)."""
    HEAD = 8          # csrc/steal.cuh W_HEAD
    N_VICT, N_STEAL = 4, 5

    def __init__(self, D: int, MAXD: int, device):
        self.D, self.MAXD = D, MAXD
        self.work = torch.zeros(self.HEAD + MAXD + 7 * D, dtype=I32,
                                device=device)
        self._array("last").fill_(-1)

    def _array(self, name):
        k = ("thief", "d0", "victim", "next", "head", "last",
             "vict").index(name)
        at = self.HEAD + self.MAXD + k * self.D
        return self.work[at:at + self.D]

    def steals(self):
        """(thief, d0, victim) of the last plan, by rank: (n,) int32
        tensors on the card (one host read of n)."""
        n = int(self.work[self.N_STEAL])
        return tuple(self._array(f)[:n] for f in ("thief", "d0", "victim"))


class _OpenCount(_Kernel):
    name = "open_count"
    source = "turbo_tpu_torch/kernels/csrc/open_count.cu"
    replaces = "turbo_tpu/solver/engine.py:1185"

    def __call__(self, dec_cur, depth, phase, plan=None):
        """0-dim int64 tensor on the card: the open right branches of
        the SOLVE-phase stacks; see csrc/open_count.cu. The same launch
        writes the steal plan of these stacks into ``plan`` (a
        ``StealPlan`` of this D and MAXD; None: a fresh one)."""
        D, MAXD = dec_cur.shape
        _check(dec_cur, "dec_cur", (D, MAXD))
        _check(depth, "depth", (D,))
        _check(phase, "phase", (D,))
        if plan is None:
            plan = StealPlan(D, MAXD, dec_cur.device)
        if (plan.D, plan.MAXD) != (D, MAXD):
            raise ValueError(f"a StealPlan of ({plan.D}, {plan.MAXD}) for "
                             f"stacks of ({D}, {MAXD})")
        _check(plan.work, "plan.work", plan.work.shape)
        out = torch.empty((), dtype=torch.int64, device=dec_cur.device)
        with torch.cuda.device(dec_cur.device):
            self._launch(lambda lib: lib.tt_open_count, dec_cur.data_ptr(),
                         depth.data_ptr(), phase.data_ptr(),
                         plan.work.data_ptr(), out.data_ptr(), D, MAXD,
                         _stream(dec_cur))
        return out


class StealView(ctypes.Structure):
    """Mirror of ``struct StealView`` in csrc/steal.cuh."""
    _fields_ = ([(n, ctypes.c_int) for n in ("D", "V", "MAXD")]
                + [(n, ctypes.c_void_p) for n in (
                    "lb", "ub", "root_lb", "root_ub", "dec_var", "dec_l0",
                    "dec_u0", "dec_l1", "dec_u1", "dec_rope1", "dec_cur",
                    "depth", "phase", "remaining", "subp", "kpow", "strat",
                    "snap_strat", "work")])


class _Steal(_Kernel):
    name = "steal"
    source = "turbo_tpu_torch/kernels/csrc/steal.cu"
    replaces = "turbo_tpu/solver/engine.py:1203"

    def __call__(self, st, plan, n: int):
        """Apply the steals of ``plan`` (K5's, on ``st``'s stacks) to the
        search state ``st`` in place; ``n``: the number of steals (one
        block each; the blocks beyond the victims return at once). See
        csrc/steal.cu."""
        D, MAXD = st.dec_cur.shape
        V = st.lb.shape[1]
        if (plan.D, plan.MAXD) != (D, MAXD):
            raise ValueError(f"a StealPlan of ({plan.D}, {plan.MAXD}) for "
                             f"stacks of ({D}, {MAXD})")
        if not 0 < n <= D:
            raise ValueError(f"{n} steals for {D} lanes")
        ptr = {}
        for f, _ in StealView._fields_[3:-1]:  # the state's fields
            t = getattr(st, f)
            _check(t, f, (D, V) if f in ("lb", "ub", "root_lb", "root_ub")
                   else (D, MAXD) if f.startswith("dec_") else (D,))
            ptr[f] = t.data_ptr()
        _check(plan.work, "plan.work", plan.work.shape)
        view = StealView(D=D, V=V, MAXD=MAXD, work=plan.work.data_ptr(),
                         **ptr)
        with torch.cuda.device(st.lb.device):
            self._launch(lambda lib: lib.tt_steal, ctypes.byref(view), int(n),
                         _stream(st.lb))


class _Step(_Kernel):
    name = "step"
    source = "turbo_tpu_torch/kernels/csrc/step.cu"
    replaces = "turbo_tpu/solver/engine.py:801"
    # The shard scan in each shard's last post block is the per-shard
    # part of the JAX mesh's sharded step.
    SHARDED_REPLACES = "turbo_tpu/parallel/mesh.py:184"
    ENTRIES = ("head", "post", "head_timed", "post_timed")

    def head(self, view, prev_live, live, device, span=None):
        """The previous step's refill and ring rows under ``prev_live``
        (None: the chunk's first step, no copy), then promote, strat0 and
        the objective tighten under ``live``, in place; see
        csrc/step.cu. ``view``: a StepView of the state. ``span`` ((2,)
        int64): the timed entry, which also writes the launch's span on
        the global timer there (``fixpoint.step_stamped``)."""
        if span is not None:
            _check(span, "span", (2,), torch.int64)
        with torch.cuda.device(device):
            self._launch(
                lambda lib: lib.tt_step_head if span is None
                else lib.tt_step_head_timed, ctypes.byref(view),
                _live_ptr(prev_live), _live_ptr(live), _stream_of(device),
                *(() if span is None else (span.data_ptr(),)),
                entry="head" if span is None else "head_timed")

    def post(self, view, live, live_next, device, smem_limit, span=None,
             xpar=0):
        """The per-lane rest of the step after K1-K3, then the shard
        scan, the next step's live flag ``live_next`` and the incumbent
        min, in place; see csrc/step.cu. ``span``: as for ``head``.
        ``xpar``: over card groups (``view.xslots`` set), the parity of
        the next step, whose slots the post publishes into."""
        if span is not None:
            _check(span, "span", (2,), torch.int64)
        with torch.cuda.device(device):
            self._launch(
                lambda lib: lib.tt_step_post if span is None
                else lib.tt_step_post_timed, ctypes.byref(view),
                _live_ptr(live), _live_ptr(live_next), int(smem_limit),
                int(xpar), _stream_of(device),
                *(() if span is None else (span.data_ptr(),)),
                entry="post" if span is None else "post_timed")


class _StepTail(_Kernel):
    name = "step_tail"
    source = "turbo_tpu_torch/kernels/csrc/step_tail.cu"
    replaces = "turbo_tpu/solver/engine.py:1059"
    ENTRIES = ("live", "copy")

    def live(self, view, live, device):
        """live[0] = some lane is not IDLE, the step counter 0 and the
        incumbent min of every lane, at a chunk's start; see
        csrc/step_tail.cu."""
        with torch.cuda.device(device):
            self._launch(lambda lib: lib.tt_step_live, ctypes.byref(view),
                         _live_ptr(live), _stream_of(device), entry="live")

    def copy(self, view, live, device):
        """The refill and ring rows of the step whose live word is
        ``live``, in place, at a chunk's end; see csrc/step_tail.cu."""
        with torch.cuda.device(device):
            self._launch(lambda lib: lib.tt_step_copy, ctypes.byref(view),
                         _live_ptr(live), _stream_of(device), entry="copy")


class _XCard(_Kernel):
    name = "xcard"
    source = "turbo_tpu_torch/kernels/csrc/xcard.cu"
    replaces = "turbo_tpu/parallel/mesh.py:184"

    def __call__(self, slots, parity: int, live, bmin):
        """live[0] = some slot of parity ``parity`` is live, bmin[0] = the
        min of their incumbent words, from a card group's slot array
        ``slots`` ((2, N, 2) int32: [parity][group] = (min, live)); see
        csrc/xcard.cu. The plain version is ``parallel/mesh.py``
        ``xcard_plain``."""
        if slots.dim() != 3:
            raise ValueError(f"slots: expected (2, N, 2), got "
                             f"{tuple(slots.shape)}")
        n = slots.shape[1]
        _check(slots, "slots", (2, n, 2))
        _check(bmin, "bmin", (1,))
        if parity not in (0, 1):
            raise ValueError(f"parity {parity}: expected 0 or 1")
        with torch.cuda.device(slots.device):
            self._launch(lambda lib: lib.tt_xcard, slots.data_ptr(), n,
                         int(parity), _live_ptr(live), bmin.data_ptr(),
                         _stream(slots))


def enable_peer(device, peer):
    """Peer access from card ``device`` to card ``peer`` (one direction;
    already enabled counts as success). Raises, naming the pair, when the
    pair has no peer access: the card groups' slots are never routed
    through the host in its place."""
    a, b = torch.device(device).index, torch.device(peer).index
    lib = load()
    rc = lib.tt_enable_peer(a, b)
    if rc != 0:
        raise RuntimeError(f"peer access from cuda:{a} to cuda:{b} failed: "
                           f"{lib.tt_error_string(rc).decode()} ({rc}); "
                           "card groups need peer access between every "
                           "pair of their cards")


fixpoint = _Fixpoint()
classify = _Classify()
select = _Select()
table_refill = _TableRefill()
table_leaf = _TableLeaf()
open_count = _OpenCount()
step = _Step()
step_tail = _StepTail()
wac1 = _Wac1()
steal = _Steal()
xcard = _XCard()
KERNELS = (fixpoint, classify, select, table_refill, table_leaf, open_count,
           step, step_tail, wac1, steal, xcard)


def warm_up(owner) -> dict:
    """Does now what the first launch of each kernel would do: uploads
    ``owner.kernel_plan`` (a ``PropagatorKernels``), initialises the
    library's CUDA runtime, loads every kernel's module (each source's
    ``tt_<source>_load``: cudaFuncGetAttributes of each of its kernels)
    and sets the shared-memory attributes of this plan's launches. A
    solver calls it when it is built, so that the table build and the
    first steps inside ``-t`` launch loaded kernels. Launches nothing;
    raises when a kernel does not load. Returns the seconds of each part
    by name, each measured up to a synchronize."""
    times = {}

    def timed(name, fn):
        t0 = time.monotonic()
        res = fn()
        torch.cuda.synchronize(owner.dp.device)
        times[name] = time.monotonic() - t0
        return res

    kp = timed("plan upload", lambda: owner.kernel_plan)
    lib = load()
    with torch.cuda.device(kp.dp.device):
        parts = [("runtime", lib.tt_runtime_init)] + [
            (src[:-3], lambda src=src: getattr(lib, f"tt_{src[:-3]}_load")(
                ctypes.byref(kp.view), kp.smem_limit)) for src in SOURCES]
        for name, fn in parts:
            rc = timed(name, fn)
            if rc != 0:
                raise RuntimeError(f"kernel warm-up ({name}) failed: "
                                   f"{lib.tt_error_string(rc).decode()} "
                                   f"({rc})")
    return times


def reset_launches():
    for k in KERNELS:
        k.reset()


def launch_counts(since=None) -> dict:
    """Launches by kernel name and by ``name.entry``; ``since``: a
    previous result to subtract."""
    counts = {k.name: k.launches for k in KERNELS}
    for k in KERNELS:
        counts.update({f"{k.name}.{e}": c
                       for e, c in k.entry_launches.items()})
    if since is not None:
        counts = {key: c - since[key] for key, c in counts.items()}
    return counts


def add_launches(counts: dict):
    """Add launches made outside the wrappers: a CUDA graph replay of
    kernels the wrappers put into the graph (``launch_counts`` keys)."""
    by_name = {k.name: k for k in KERNELS}
    for key, c in counts.items():
        name, _, entry = key.partition(".")
        if entry:
            by_name[name].entry_launches[entry] += c
        else:
            by_name[name].launches += c
