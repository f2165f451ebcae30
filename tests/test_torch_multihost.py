"""The port's multi-host EPS (``turbo_tpu_torch/parallel/multihost.py``)
against the JAX package's (``turbo_tpu/parallel/multihost.py``).

``plan_host_steal`` and ``reseed_ranges`` are numpy on both sides and are
compared in this process. The solver runs as two real processes on each
side: the port's ``MultiHostSolver`` over gloo with ``devices=["cpu"] *
S`` in each process, JAX's over ``jax.distributed`` with ``S`` virtual
CPU devices in each. Both pairs run at once, every case of a pair in one
process each, and every case must give equal results (tolerance 0): the
exchange is deterministic (every decision comes from the gathered
snapshot at ticks counted in chunks). The CLI runs as two processes
per side too. Only instances of ``turbo_tpu_torch/instances.py`` are
used.
"""
import json
import os
import pathlib
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.fzn import parse_fzn_text as jax_parse
from turbo_tpu.parallel import multihost as jax_mh
from turbo_tpu.solver.engine import BatchedSolver as JaxSolver
from turbo_tpu.solver.engine import EngineConfig as JaxConfig
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.instances import golomb, random_model
from turbo_tpu_torch.parallel import multihost as mh
from turbo_tpu_torch.solver.config import EngineConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
WAIT_S = 240  # every child process is killed after this

# (name, model, local shards of host 0 and host 1, EngineConfig, chunk).
CASES = [
    ("golomb6", golomb(6), (2, 2),
     dict(num_dives=4, subproblems_power=6, max_depth=64), 8),
    ("rand3", random_model(3), (2, 2),
     dict(num_dives=2, subproblems_power=5, max_depth=64), 4),
    ("rand4", random_model(4, n_vars=9, n_cons=24), (2, 2),
     dict(num_dives=3, subproblems_power=6, max_depth=64), 4),
    # Unequal hosts (2 and 4 local shards, as JAX's
    # test_two_process_asymmetric_device_counts): host 1 drains its
    # ranges first and steals from host 0 (eps_redistributions > 0).
    ("golomb6_2x4", golomb(6), (2, 4),
     dict(num_dives=2, subproblems_power=7, max_depth=64), 4),
]
STEALS = "golomb6_2x4"
# JAX's WORKER_R5 (tests/test_multihost.py) on golomb(6): see WORKER.
R5 = dict(name="r5", text=golomb(6), shards=(2, 2), chunk=8, cut=40,
          cfg=dict(num_dives=4, subproblems_power=6, max_depth=64))
RESULT_KEYS = ("status", "objective", "exhaustive", "nodes", "fails",
               "solutions", "fixpoint_iterations", "depth_max",
               "eps_solved_subproblems", "eps_skipped_subproblems",
               "eps_redistributions", "best_lb", "best_ub")

# A worker process: argv = side (jax | port), pid, port, spec file. The
# spec lists the cases; each prints one RESULT line of JSON. The "r5"
# case is JAX's WORKER_R5 (tests/test_multihost.py): a run cut by the
# global node budget that writes the per-host checkpoints, then a second
# solve that resumes from them, both streaming through on_improve.
WORKER = r"""
import json, os, sys
side, pid, port, spec = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
cases = json.load(open(spec))
if side == "jax":
    n_local = cases[0]["shards"][pid]
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_local}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from turbo_tpu.parallel.multihost import MultiHostSolver, init_distributed
    from turbo_tpu.frontend.fzn import parse_fzn_text
    from turbo_tpu.compile.model import compile_model
    from turbo_tpu.solver.engine import EngineConfig
else:
    import torch
    torch.set_num_threads(1)
    from turbo_tpu_torch.parallel.multihost import (
        MultiHostSolver, init_distributed, shutdown_distributed)
    from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
    from turbo_tpu_torch.host.compile.model import compile_model
    from turbo_tpu_torch.solver.config import EngineConfig
init_distributed(f"localhost:{port}", 2, pid)


def result(r):
    out = {}
    for k in ("status", "objective", "exhaustive", "nodes", "fails",
              "solutions", "fixpoint_iterations", "depth_max",
              "eps_solved_subproblems", "eps_skipped_subproblems",
              "eps_redistributions", "best_lb", "best_ub"):
        v = getattr(r, k)
        out[k] = (None if v is None else [int(x) for x in v]
                  if k.startswith("best_") else
                  v if isinstance(v, str) else int(v))
    return out


for case in cases:
    tnf = compile_model(parse_fzn_text(case["text"]))
    cfg = dict(case["cfg"])
    if side == "jax":
        cfg["fp_layout"] = "dv"
        s = MultiHostSolver(tnf, EngineConfig(**cfg))
    else:
        s = MultiHostSolver(tnf, EngineConfig(**cfg),
                            devices=["cpu"] * case["shards"][pid])
    if case["name"] == "r5":
        imps = []
        ck = case["ckpt"]
        r1 = s.solve(timeout_s=300, chunk=2, node_limit=case["cut"],
                     checkpoint_path=ck,
                     on_improve=lambda lb: imps.append([int(x) for x in lb]))
        cut = result(r1)
        r2 = s.solve(timeout_s=300, chunk=case["chunk"], checkpoint_path=ck,
                     on_improve=lambda lb: imps.append([int(x) for x in lb]))
        out = {"cut": cut, "resumed": result(r2), "improvements": imps}
    else:
        out = result(s.solve(timeout_s=300, chunk=case["chunk"]))
    print("RESULT " + json.dumps({"name": case["name"], **out}), flush=True)
if side == "port":
    shutdown_distributed()
"""


def _free_port():
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _child_env():
    # One thread per child: the suite's other workers hold the cores.
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    return env


def _start_pair(argv_of, env):
    """Start the two processes of one side (argv by pid)."""
    return [subprocess.Popen(argv_of(i), cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for i in range(2)]


def _finish(procs):
    """(stdout, stderr, returncode) of each process; a process still
    running after WAIT_S is killed, and so is its peer."""
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=WAIT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
        outs.append((out, err, p.returncode))
    return outs


def _run_workers(specs):
    """Run one pair of worker processes per (side, spec file) of
    ``specs``, every pair at once. Returns {side: {case name: [result of
    pid 0, result of pid 1]}}."""
    pairs = []
    for side, spec in specs:
        port = _free_port()
        pairs.append((side, _start_pair(lambda i: [
            sys.executable, "-c", WORKER, side, str(i), str(port), spec],
            _child_env())))
    res = {}
    for side, procs in pairs:
        for pid, (out, err, rc) in enumerate(_finish(procs)):
            assert rc == 0, (side, out[-2000:], err[-4000:])
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    r = json.loads(line[7:])
                    res.setdefault(side, {}).setdefault(
                        r["name"], [None, None])[pid] = r
    return res


def _solve_results(tmp):
    """Every case of CASES and the -i/-cutnodes/-checkpoint case on both
    sides, two cases to a pair of processes (a process's JAX device count
    is fixed at its start, so the unequal hosts get a pair of their own),
    every pair at once."""
    tmp = pathlib.Path(tmp)
    cases = [dict(name=name, text=text, shards=shards, cfg=cfg, chunk=chunk)
             for name, text, shards, cfg, chunk in CASES] + [R5]
    groups = {}
    for c in cases:
        group = groups.setdefault(tuple(c["shards"]), [[]])
        if len(group[-1]) == 2:
            group.append([])
        group[-1].append(c)
    specs = []
    for g, group in enumerate(x for gs in groups.values() for x in gs):
        for side in ("jax", "port"):
            cs = [dict(c, ckpt=str(tmp / f"{side}.ckpt")) for c in group]
            spec = tmp / f"{side}_{g}.json"
            spec.write_text(json.dumps(cs))
            specs.append((side, str(spec)))
    out = _run_workers(specs)
    out["ckpt_files"] = {side: [os.path.exists(tmp / f"{side}.ckpt.h{i}")
                                for i in range(2)]
                         for side in ("jax", "port")}
    return out


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    return _solve_results(str(tmp_path_factory.mktemp("multihost")))


def _stats(r):
    return {k: r[k] for k in RESULT_KEYS}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_two_processes_match_jax(solved, name):
    """Two port processes over gloo against two JAX processes over
    jax.distributed: every host returns the same global result, equal on
    both sides in status, objective, exhaustiveness, every statistic,
    the redistributions and the best store."""
    jax_r, port_r = solved["jax"][name], solved["port"][name]
    assert jax_r[0] == jax_r[1] and port_r[0] == port_r[1]
    assert _stats(port_r[0]) == _stats(jax_r[0])
    assert port_r[0]["exhaustive"] == 1
    assert port_r[0]["status"] in ("optimal", "sat", "unsat")
    if name == STEALS:
        assert port_r[0]["eps_redistributions"] > 0


def test_two_processes_cutnodes_checkpoint_improve_match_jax(solved):
    """-i, -cutnodes and -checkpoint over two processes (JAX's
    WORKER_R5 on golomb(6)): run 1 is cut by the global node budget and
    writes path.h0 and path.h1; run 2 resumes from them and proves the
    optimum; the on_improve stream and both results equal JAX's."""
    jax_r, port_r = solved["jax"]["r5"], solved["port"]["r5"]
    plan = mh.MultiHostSolver(compile_model(parse_fzn_text(golomb(6))),
                              EngineConfig(**R5["cfg"]),
                              devices=["cpu"]).plan
    zero = [int(x) for x in plan.store_to_tnf(np.zeros(plan.V, np.int32))]
    assert solved["ckpt_files"]["port"] == [True, True]
    assert solved["ckpt_files"]["jax"] == [True, True]
    for pid in range(2):
        for run in ("cut", "resumed"):
            assert port_r[pid][run] == jax_r[pid][run]
        # JAX's loop compares the gathered best with 1 << 30, one above
        # the engine's INF, so its first exchange without an incumbent
        # calls on_improve with an all-zero store; the port waits for a
        # real incumbent. Every real improvement is the same.
        real = [lb for lb in jax_r[pid]["improvements"] if lb != zero]
        assert len(real) < len(jax_r[pid]["improvements"])
        assert port_r[pid]["improvements"] == real
    cut, res = port_r[0]["cut"], port_r[0]["resumed"]
    assert not cut["exhaustive"] and cut["status"] in ("sat", "unknown")
    assert (res["status"], res["objective"], res["exhaustive"]) == (
        "optimal", 17, 1)
    assert len(port_r[0]["improvements"]) >= 1


# -- the numpy functions ---------------------------------------------------

def _steal_snapshots():
    """Seeded (H, S) snapshots: dry hosts, padded shards (next == limit),
    two thieves, and no donor."""
    rng = np.random.default_rng(7)
    cases = []
    for _ in range(40):
        H, S = int(rng.integers(2, 5)), int(rng.integers(1, 4))
        nxt = rng.integers(0, 200, (H, S))
        lim = nxt + rng.integers(0, 60, (H, S)) * (rng.random((H, S)) < .6)
        idle = rng.random(H) < 0.5
        cases.append((nxt, lim, idle))
    cases.append((np.array([[10, 50], [99, 99]]), np.array([[40, 60],
                                                           [99, 99]]),
                  np.array([False, True])))
    cases.append((np.array([[0], [99], [99]]), np.array([[100], [99], [99]]),
                  np.array([False, True, True])))
    cases.append((np.array([[40], [99]]), np.array([[41], [99]]),
                  np.array([False, True])))
    return [(a.astype(np.int64), b.astype(np.int64), c) for a, b, c in cases]


def test_plan_host_steal_matches_jax():
    n_moves = 0
    for nxt, lim, idle in _steal_snapshots():
        got = mh.plan_host_steal(nxt, lim, idle)
        assert got == jax_mh.plan_host_steal(nxt, lim, idle)
        n_moves += len(got)
    assert n_moves > 10   # the snapshots make thieves and donors


@pytest.mark.parametrize("lo,hi", [(40, 64), (7, 9), (0, 1), (60, 64)])
def test_reseed_ranges_matches_jax(lo, hi):
    """JAX's reseed_ranges on a JAX SearchState and the port's on the
    same fields as numpy: equal fields, and the stolen range covered."""
    text = random_model(4, n_vars=9, n_cons=24)
    s = JaxSolver(jax_compile(jax_parse(text)),
                  JaxConfig(num_dives=4, subproblems_power=6, max_depth=64,
                            use_table=False), num_shards=2)
    import jax
    sts = [s.init_state(shard_idx=i) for i in range(2)]
    st = jax.tree.map(lambda *x: np.concatenate([np.asarray(v) for v in x]),
                      *sts)
    # A state in mid-search: scramble what the reseed overwrites.
    rng = np.random.default_rng(lo)
    fields = {f: np.asarray(getattr(st, f)).copy() for f in st._fields}
    for f in mh.RESEED_FIELDS:
        fields[f] = (fields[f] + rng.integers(0, 3, fields[f].shape)
                     ).astype(fields[f].dtype)
    st = st._replace(**fields)
    want = jax_mh.reseed_ranges(st, 4, 2, s.plan.lb0, s.plan.ub0, lo, hi)
    got = mh.reseed_ranges(dict(fields), 4, 2, s.plan.lb0, s.plan.ub0, lo,
                           hi)
    assert set(got) == set(mh.RESEED_FIELDS)
    for f in st._fields:
        a = np.asarray(getattr(want, f))
        b = got.get(f, fields[f])
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    covered = set()
    for sh in range(2):
        covered.update(range(int(got["subp"][sh * 4]),
                             int(got["sub_limit"][sh * 4])))
    assert covered == set(range(lo, hi))


# -- single process ----------------------------------------------------------

def test_one_process_without_a_card_raises():
    """No devices and no CUDA: pick_device raises; nothing falls back to
    the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    tnf = compile_model(parse_fzn_text(golomb(4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mh.MultiHostSolver(tnf, EngineConfig(num_dives=2))


def test_one_process_refuses_enumeration_and_runs_table_off():
    tnf = compile_model(parse_fzn_text(golomb(4)))
    with pytest.raises(ValueError, match="enumerate_all"):
        mh.MultiHostSolver(tnf, EngineConfig(num_dives=2,
                                             enumerate_all=True),
                           devices=["cpu"])
    s = mh.MultiHostSolver(tnf, EngineConfig(num_dives=2, max_depth=32),
                           devices=["cpu"] * 2)
    assert not s.sharded.solver.use_table and s.n_hosts == 1
    assert mh.init_distributed("localhost:1", 1, 0) is False
    np.testing.assert_array_equal(mh.dcn_allgather(np.arange(3)),
                                  np.arange(3)[None])
    r = s.solve(chunk=8)
    assert (r.status, r.objective, r.exhaustive) == ("optimal", 6, True)


def test_shard_offset_with_the_table_raises():
    from turbo_tpu_torch.parallel.mesh import ShardedSolver
    tnf = compile_model(parse_fzn_text(golomb(4)))
    with pytest.raises(ValueError, match="shard_offset"):
        ShardedSolver(tnf, EngineConfig(num_dives=2, max_depth=32),
                      devices=["cpu"], shard_offset=1, total_shards=2)


# Host 1 dies right after joining the group; host 0 goes on to solve.
DEAD_PEER = r"""
import os, sys
from turbo_tpu_torch.parallel.multihost import MultiHostSolver, init_distributed
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.instances import golomb
from turbo_tpu_torch.solver.config import EngineConfig
pid, port = int(sys.argv[1]), sys.argv[2]
init_distributed(f"localhost:{port}", 2, pid, timeout_s=60)
if pid == 1:
    os._exit(3)
tnf = compile_model(parse_fzn_text(golomb(9)))
MultiHostSolver(tnf, EngineConfig(num_dives=4, subproblems_power=6),
                devices=["cpu"]).solve()
print("FINISHED")
"""


def test_dead_peer_fails_the_survivor():
    """A host that dies makes the others fail at their next collective;
    none of them waits for it."""
    port = _free_port()
    procs = _start_pair(lambda i: [sys.executable, "-c", DEAD_PEER, str(i),
                                   str(port)], _child_env())
    (out0, err0, rc0), (_, _, rc1) = _finish(procs)
    assert rc1 == 3
    assert rc0 not in (0, None) and "FINISHED" not in out0
    assert "RuntimeError" in err0, err0[-2000:]


# -- the CLI -----------------------------------------------------------------

# The port's CLI as host `pid`, with an audit hook: it fails if jax or the
# JAX package is loaded or a file of turbo_tpu/ or native/ is opened.
PORT_CLI = r"""
import os, sys
seen = []
def hook(event, args):
    if event == 'open' and isinstance(args[0], str):
        seen.append(os.path.abspath(args[0]))
sys.addaudithook(hook)
import turbo_tpu_torch.cli as cli
rc = cli.main(sys.argv[1:])
assert rc == 0
assert 'jax' not in sys.modules, 'jax was imported'
assert 'turbo_tpu' not in sys.modules
root = os.getcwd()
for bad in (os.path.join(root, 'turbo_tpu') + os.sep,
            os.path.join(root, 'native') + os.sep):
    hit = [f for f in seen if f.startswith(bad)]
    assert not hit, hit[:5]
print('NOJAX', file=sys.stderr)
"""


def test_cli_two_hosts_match_jax_cli(tmp_path):
    """``-hosts 2`` through both CLIs, one local shard a host: host 0
    prints the same solution block, separator, stat keys and counted
    statistics on both sides; host 1 prints nothing; the port's
    processes never load jax."""
    path = tmp_path / "g6.fzn"
    path.write_text(golomb(6))
    flags = [str(path), "-s", "-or", "4", "-sub", "6", "-platform", "cpu",
             "-hosts", "2"]
    env = _child_env()
    jax_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=1")
    jp, tp = _free_port(), _free_port()
    jax_procs = _start_pair(lambda i: [
        sys.executable, "-m", "turbo_tpu.cli", *flags, "-host_id", str(i),
        "-coordinator", f"localhost:{jp}"], jax_env)
    port_procs = _start_pair(lambda i: [
        sys.executable, "-c", PORT_CLI, *flags, "-host_id", str(i),
        "-coordinator", f"localhost:{tp}"], env)
    outs = {"jax": _finish(jax_procs), "port": _finish(port_procs)}
    for side, res in outs.items():
        for out, err, rc in res:
            assert rc == 0, (side, out[-2000:], err[-3000:])
        assert res[1][0].strip() == "", (side, res[1][0])
    assert all("NOJAX" in err for _, err, _ in outs["port"])

    def parsed(out):
        # jax.distributed's CPU collectives print a gloo banner on fd 1.
        body = [l for l in out.splitlines()
                if not l.startswith(("%", "[Gloo]"))]
        stats = dict(re.findall(r"^%%%mzn-stat: (\w+)=(.*)$", out, re.M))
        return body, stats

    body_j, stats_j = parsed(outs["jax"][0][0])
    body_t, stats_t = parsed(outs["port"][0][0])
    assert body_t == body_j
    assert body_t[-2:] == ["----------", "=========="]
    assert "m5 = 17;" in body_t
    assert stats_t.keys() == stats_j.keys()
    for k in ("nodes", "failures", "num_solutions", "objective",
              "peakDepth", "eps_num_subproblems", "eps_solved_subproblems",
              "eps_skipped_subproblems", "eps_redistributions",
              "fixpoint_iterations", "num_deductions", "num_blocks",
              "num_blocks_done", "variables", "propagators"):
        assert stats_t[k] == stats_j[k], k
    solved = int(stats_t["eps_solved_subproblems"])
    assert solved + int(stats_t["eps_skipped_subproblems"]) == 64


# -- cold start ----------------------------------------------------------------

COLD_LOAD = r"""
import os, sys, time
from turbo_tpu_torch.host.frontend import native
native._SO, go, text, mode = sys.argv[1:5]
while not os.path.exists(go):
    pass
if mode == "watch":
    # Load the moment the library's name appears in the directory.
    while not os.path.exists(native._SO):
        pass
assert native._load() is not None
m = native.parse_fzn_native(text)
assert m is not None and len(m.vars) > 0
print("LOADED")
"""


def test_native_parser_cold_start_of_two_processes(tmp_path):
    """Two processes load the native parser at once from an empty build
    directory, as the hosts of a -hosts run start: one builds it, the
    other loads it the moment its name appears (a build written in place
    would hand it a half-written library). Each loader builds to a file
    of its own and renames it into place, so both load a whole library
    and no temporary file is left."""
    so = tmp_path / "build" / "libfznparser.so"
    go = tmp_path / "go"
    procs = [subprocess.Popen(
        [sys.executable, "-c", COLD_LOAD, str(so), str(go), golomb(5), mode],
        cwd=ROOT, env=_child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for mode in ("build", "watch")]
    go.touch()
    for out, err, rc in _finish(procs):
        assert rc == 0 and "LOADED" in out, err[-3000:]
        assert "unavailable" not in err
    assert sorted(p.name for p in so.parent.iterdir()) == [so.name]
