"""The rest of the port's solve loop against the JAX package's: the hard
wall, the build heartbeat and the warm-up chunk.

- Hard wall (``TURBO_TPU_HARD_WALL_MULT``): at 1e-9 times a 3600 s
  timeout, ``BatchedSolver`` and ``ShardedSolver`` (four lane groups on
  the CPU) stop after their first chunk of one step, not exhaustive, with
  the nodes of the JAX ``BatchedSolver`` and of its ``ShardedSolver`` on
  four virtual CPU devices, and print the JAX line; at 0 both reach the
  same optimum with the same statistics. golomb(6) with the table off,
  the cap pinned and (on the batched solvers) steal and resplit stubbed
  out, so that no wall-clock gate changes the walk. At the default 2 the
  wall counts a solver's kernel build and warm-up on its first solve, as
  JAX's counts its compile: a build of 2.5 times ``-t`` stops the first
  solve after one chunk, and the second runs to the optimum.
- Heartbeat: ``engine.heartbeat`` prints its line while the block runs
  (its interval made small) and stops when the block returns or raises;
  ``warm_kernels`` runs the build and the warm-up inside it.
- Warm-up chunk: the first chunk of both loops stays out of
  ``PhaseTimers``' samples and device time, as in JAX.
"""
import functools
import threading
import time
import types

import jax
import pytest
import torch

from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.fzn import parse_fzn_text as jax_parse
from turbo_tpu.parallel import mesh as jax_mesh
from turbo_tpu.solver.engine import BatchedSolver as JaxSolver
from turbo_tpu.solver.engine import EngineConfig as JaxConfig
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.host.solver import timers as port_timers
from turbo_tpu_torch.instances import GOLOMB_OPT, golomb
from turbo_tpu_torch.parallel.mesh import ShardedSolver
from turbo_tpu_torch.solver import engine
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.engine import BatchedSolver

KW = dict(num_dives=4, subproblems_power=5, max_depth=64,
          fp_max_iters=10000, use_table=False, fp_cap_auto=False)
STATS = ("status", "objective", "exhaustive", "nodes", "fails", "solutions",
         "fixpoint_iterations", "depth_max")
WALL_LINE = "% hard wall-clock limit reached (1e-09x timeout incl. compile)"


@functools.lru_cache(maxsize=None)
def _pair(kind):
    """(JAX solver, port solver) on golomb(6): ``batched``, or
    ``sharded`` over four shards."""
    text = golomb(6)
    if kind == "batched":
        js = JaxSolver(jax_compile(jax_parse(text)),
                       JaxConfig(fp_layout="dv", **KW))
        ts = BatchedSolver(compile_model(parse_fzn_text(text)),
                           EngineConfig(**KW), device="cpu")
        for s in (js, ts):
            s._steal_open_branches = lambda *a, **k: None
            s._tail_resplit = lambda *a, **k: None
    else:
        js = jax_mesh.ShardedSolver(jax_compile(jax_parse(text)),
                                    JaxConfig(fp_layout="dv", **KW),
                                    devices=jax.devices()[:4])
        ts = ShardedSolver(compile_model(parse_fzn_text(text)),
                           EngineConfig(**KW), devices=["cpu"] * 4)
    return js, ts


@pytest.mark.parametrize("kind", ["batched", "sharded"])
def test_hard_wall_stops_after_one_chunk_like_jax(kind, monkeypatch,
                                                  capsys):
    monkeypatch.setenv("TURBO_TPU_HARD_WALL_MULT", "1e-9")
    js, ts = _pair(kind)
    rj = js.solve(timeout_s=3600, chunk=1)
    assert WALL_LINE in capsys.readouterr().err
    rt = ts.solve(timeout_s=3600, chunk=1)
    assert WALL_LINE in capsys.readouterr().err
    assert not rt.exhaustive and not rj.exhaustive
    assert rt.status == rj.status
    assert rt.nodes == rj.nodes > 0
    assert rt.fixpoint_iterations == rj.fixpoint_iterations
    # One step: at most a node a lane.
    assert rt.nodes <= KW["num_dives"] * (4 if kind == "sharded" else 1)


@pytest.mark.parametrize("kind", ["batched", "sharded"])
def test_no_hard_wall_reaches_the_optimum_like_jax(kind, monkeypatch,
                                                   capsys):
    monkeypatch.setenv("TURBO_TPU_HARD_WALL_MULT", "0")
    js, ts = _pair(kind)
    rj = js.solve(timeout_s=3600, chunk=4)
    rt = ts.solve(timeout_s=3600, chunk=4)
    assert "hard wall" not in capsys.readouterr().err
    for k in STATS:
        assert getattr(rt, k) == getattr(rj, k), k
    assert (rt.status, rt.objective) == ("optimal", GOLOMB_OPT[6])


@pytest.mark.parametrize("kind", ["batched", "sharded"])
def test_hard_wall_counts_the_kernel_build(kind, monkeypatch, capsys):
    monkeypatch.delenv("TURBO_TPU_HARD_WALL_MULT", raising=False)
    _, ts = _pair(kind)
    owner = ts if kind == "batched" else ts.solver
    owner.wall_setup_s = 2.5 * 3600  # the build, as __init__ timed it
    r = ts.solve(timeout_s=3600, chunk=1)
    assert ("% hard wall-clock limit reached (2x timeout incl. compile)"
            in capsys.readouterr().err)
    assert not r.exhaustive and 0 < r.nodes <= 4 * KW["num_dives"]
    assert owner.wall_setup_s == 0.0  # counted once
    r = ts.solve(timeout_s=3600, chunk=4)
    assert "hard wall" not in capsys.readouterr().err
    assert (r.status, r.objective) == ("optimal", GOLOMB_OPT[6])


def _heartbeat_threads():
    return [t for t in threading.enumerate()
            if t.name == "turbo-tpu-heartbeat"]


def test_heartbeat_prints_until_the_block_returns(monkeypatch, capsys):
    monkeypatch.setattr(engine, "HEARTBEAT_S", 0.02)
    with engine.heartbeat():
        time.sleep(0.2)
    lines = capsys.readouterr().err.splitlines()
    assert len(lines) >= 3
    assert all(ln.startswith("% building the CUDA kernels... (")
               and ln.endswith("s; one-time cost, cached for later runs)")
               for ln in lines)
    assert not _heartbeat_threads()
    time.sleep(0.1)
    assert capsys.readouterr().err == ""


def test_heartbeat_stops_when_the_block_raises(capsys):
    with pytest.raises(RuntimeError, match="nvcc failed"):
        with engine.heartbeat(0.02):
            time.sleep(0.1)
            raise RuntimeError("nvcc failed")
    assert capsys.readouterr().err.count("% building the CUDA kernels") >= 2
    assert not _heartbeat_threads()
    time.sleep(0.1)
    assert capsys.readouterr().err == ""


def test_warm_kernels_builds_inside_the_heartbeat(monkeypatch, capsys):
    """On the card ``warm_kernels`` runs ``kernels.load`` and
    ``kernels.warm_up`` with the heartbeat on (here both stubbed, the
    build slow), and the heartbeat ends with them; on the CPU it does
    nothing."""
    from turbo_tpu_torch import kernels
    seen = []

    def load():
        seen.append(("load", len(_heartbeat_threads())))
        time.sleep(0.15)

    def warm_up(kp):
        seen.append(("warm_up", len(_heartbeat_threads())))
        raise RuntimeError("kernel warm-up failed")

    monkeypatch.setattr(engine, "HEARTBEAT_S", 0.02)
    monkeypatch.setattr(kernels, "load", load)
    monkeypatch.setattr(kernels, "warm_up", warm_up)
    card = types.SimpleNamespace(device=torch.device("cuda"), kernels=None)
    with pytest.raises(RuntimeError, match="warm-up failed"):
        engine.warm_kernels(card)
    assert seen == [("load", 1), ("warm_up", 1)]
    assert card.build_time >= 0.15
    assert "% building the CUDA kernels" in capsys.readouterr().err
    assert not _heartbeat_threads()
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    assert engine.warm_kernels(cpu) == 0.0 and len(seen) == 2


@pytest.mark.parametrize("kind", ["batched", "sharded"])
def test_warmup_chunk_stays_out_of_the_timers(kind, monkeypatch):
    """The first chunk is recorded with ``measured=False``: no sample and
    no device time; every later one is measured."""
    _, ts = _pair(kind)
    calls = []
    record = port_timers.PhaseTimers.record_chunk

    def spy(self, device_dur, *a, measured=True, **k):
        calls.append((self, device_dur, measured))
        return record(self, device_dur, *a, measured=measured, **k)

    monkeypatch.setattr(port_timers.PhaseTimers, "record_chunk", spy)
    monkeypatch.setenv("TURBO_TPU_PROFILE_SPLIT", "0")
    ts.solve(chunk=4)
    assert len(calls) >= 3
    assert [m for _, _, m in calls] == [False] + [True] * (len(calls) - 1)
    timers = calls[0][0]
    assert len(timers._samples) == len(calls) - 1
    assert timers.device_time == pytest.approx(
        sum(d for _, d, _ in calls[1:]), rel=1e-12)
