"""The port's checkpoint (``solver/checkpoint.py``) against the JAX
package's.

The file format is the JAX package's (a pickle of the state as numpy
arrays, format 5, with its guards), so a file either package wrote must
load in the other into an equal state, a cut and resumed search must
finish as the uncut one, both engines cut and resumed at the same place
must give equal statistics (tolerance zero), and every guard must refuse
its mismatch with a warning that says why.
"""
import functools
import pickle

import numpy as np
import pytest

from test_torch_engine import STATS, _assert_same_state
from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.fzn import parse_fzn_text as jax_parse
from turbo_tpu.solver import checkpoint as jax_ckpt
from turbo_tpu.solver.engine import BatchedSolver as JaxSolver
from turbo_tpu.solver.engine import EngineConfig as JaxConfig
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.instances import GOLOMB_OPT, golomb
from turbo_tpu_torch.solver import checkpoint as ckpt
from turbo_tpu_torch.solver.config import EngineConfig
from turbo_tpu_torch.solver.convert import search_state_to_numpy
from turbo_tpu_torch.solver.engine import BatchedSolver

KW = dict(num_dives=8, subproblems_power=6, max_depth=96, fp_max_iters=10000,
          fp_cap_auto=False)


def _no_tail(s):  # steal and resplit are timed by the wall clock
    s._steal_open_branches = lambda *a, **k: None
    s._tail_resplit = lambda *a, **k: None
    return s


def _port(**kw):
    return _no_tail(BatchedSolver(compile_model(parse_fzn_text(golomb(6))),
                                  EngineConfig(**dict(KW, **kw)),
                                  device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax(table):
    return _no_tail(JaxSolver(jax_compile(jax_parse(golomb(6))),
                              JaxConfig(fp_layout="dv", use_table=table,
                                        **KW)))


def test_save_load_round_trip(tmp_path):
    s = _port()
    st, _ = s.run_steps(s.init_state(), 9)
    path = str(tmp_path / "ck.pkl")
    extras = {"resplit_base": (3, 5, 1), "resplit_rounds": 2,
              "steal_rounds": 4}
    ckpt.save_state(s, st, path, extras=extras)
    st2, got = ckpt.load_state(s, path)
    assert got == extras
    want = search_state_to_numpy(st)
    for k, v in search_state_to_numpy(st2).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert ckpt.load_state(s, str(tmp_path / "absent.pkl")) is None
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert payload["format"] == ckpt.FORMAT_VERSION == jax_ckpt.FORMAT_VERSION
    # Written as the JAX state's field would be; the resuming run's cap
    # wins, so nothing reads it back.
    assert (payload["state"]["fp_cap"] == s.cfg.fp_max_iters).all()


@pytest.mark.parametrize("table", [True, False])
def test_cut_and_resumed_search_is_the_uncut_one(table, tmp_path, capsys):
    path = str(tmp_path / "ck.pkl")
    full = _port(use_table=table).solve(chunk=8, fp_cap=10000)
    assert (full.status, full.objective) == ("optimal", GOLOMB_OPT[6])
    r1 = _port(use_table=table).solve(chunk=8, fp_cap=10000, node_limit=60,
                                      checkpoint_path=path)
    assert r1.status in ("sat", "unknown") and 60 <= r1.nodes < full.nodes
    r2 = _port(use_table=table).solve(chunk=8, fp_cap=10000,
                                      checkpoint_path=path)
    assert "ignored" not in capsys.readouterr().err
    for k in STATS:
        assert getattr(r2, k) == getattr(full, k), k
    # The JAX engine cut at the same place and resumed ends the same way,
    # from its own file and from the port's.
    jpath = str(tmp_path / "jck.pkl")
    js = _jax(table)
    j1 = js.solve(chunk=8, fp_cap=10000, node_limit=60, checkpoint_path=jpath)
    assert j1.nodes == r1.nodes
    j2 = js.solve(chunk=8, fp_cap=10000, checkpoint_path=jpath)
    _port(use_table=table).solve(chunk=8, fp_cap=10000, node_limit=60,
                                 checkpoint_path=path)
    j3 = js.solve(chunk=8, fp_cap=10000, checkpoint_path=path)
    for k in STATS:
        assert getattr(j2, k) == getattr(j3, k) == getattr(full, k), k


@pytest.mark.parametrize("table", [True, False])
def test_jax_written_file_loads_into_an_equal_state(table, tmp_path):
    js, ts = _jax(table), _port(use_table=table)
    jst = js.make_step_n(7)(js.init_state())
    tst, _ = ts.run_steps(ts.init_state(), 7)
    path = str(tmp_path / "jax.pkl")
    jax_ckpt.save_state(js, jst, path, extras={"steal_rounds": 1})
    st, extras = ckpt.load_state(ts, path)
    assert extras == {"steal_rounds": 1}
    _assert_same_state(jst, st, "loaded from the JAX package's file")
    # The loaded state steps on as the port's own does.
    a, _ = ts.run_steps(st, 20)
    b, _ = ts.run_steps(tst, 20)
    want = search_state_to_numpy(b)
    for k, v in search_state_to_numpy(a).items():
        if k not in ("lb", "ub"):  # bot-lane stores differ, as in JAX
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    # And the port's file loads in the JAX package, with its cap.
    ckpt.save_state(ts, tst, path)
    jst2, _ = jax_ckpt.load_state(js, path)
    _assert_same_state(jst2, tst, "the port's file in the JAX package")
    assert int(np.asarray(jst2.fp_cap)[0]) == js.cfg.fp_max_iters


REJECTS = {
    "format": ("format", 4, "format 4 != 5"),
    "no_format": ("format", None, "format None != 5"),
    "shapes": ("shape_signature", "other", "different instance/plan shapes"),
    "digest": ("data_digest", "other", "different plan data"),
    "num_dives": ("num_dives", 16, "different num_dives/max_depth"),
    "max_depth": ("max_depth", 95, "different num_dives/max_depth"),
    "shards": ("num_shards", 2, "different shard count"),
    "split": ("num_sub_total", 32, "different EPS split"),
    "table": ("use_table", False, "different table mode"),
    "state": ("state", {"lb": 0}, "KeyError"),
}


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_each_mismatch_is_refused_with_its_warning(case, tmp_path, capsys):
    s = _port()
    path = str(tmp_path / "ck.pkl")
    ckpt.save_state(s, s.init_state(), path)
    assert ckpt.load_state(s, path) is not None
    key, value, why = REJECTS[case]
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload[key] = value
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    capsys.readouterr()
    assert ckpt.load_state(s, path) is None
    err = capsys.readouterr().err
    assert f"% warning: checkpoint {path} ignored" in err and why in err
    assert "starting fresh" in err


def test_refused_file_starts_fresh_and_is_overwritten(tmp_path, capsys):
    path = tmp_path / "ck.pkl"
    path.write_bytes(b"not a pickle")
    r = _port().solve(chunk=8, fp_cap=10000, node_limit=30,
                      checkpoint_path=str(path))
    assert "ignored (UnpicklingError" in capsys.readouterr().err
    assert r.status in ("sat", "unknown") and r.nodes >= 30
    # Another solver shape refuses the file the cut run wrote.
    other = _port(num_dives=4)
    assert ckpt.load_state(other, str(path)) is None
    assert "different num_dives/max_depth" in capsys.readouterr().err
    r2 = _port().solve(chunk=8, fp_cap=10000, checkpoint_path=str(path))
    assert (r2.status, r2.objective) == ("optimal", GOLOMB_OPT[6])
    assert r2.nodes > r.nodes


def test_periodic_checkpoint_is_written(tmp_path):
    path = tmp_path / "ck.pkl"
    r = _port().solve(chunk=4, fp_cap=10000, checkpoint_path=str(path),
                      checkpoint_every_s=0.0)
    assert r.status == "optimal"
    # Written during the run (a run that ends on its own writes no final
    # file), and loadable.
    assert path.exists()
    st, extras = ckpt.load_state(_port(), str(path))
    assert set(extras) == {"resplit_base", "resplit_rounds", "steal_rounds"}
    assert int(st.nodes.sum()) <= r.nodes
