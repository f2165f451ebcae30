"""The port's host layer: its own copy, never loading jax or the JAX package.

``turbo_tpu_torch.host`` is a copy of the JAX package's numpy modules
(and of ``native/fzn_parser.cpp``); the copies compute what the
originals compute (TNF, plan, the copied host functions of
``turbo_tpu_torch/solver/config.py``), and the port's CLI runs no file
of ``turbo_tpu/`` or ``native/``. The solver API runs on the card unless
asked for the CPU.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from turbo_tpu.compile.model import compile_model as jax_compile
from turbo_tpu.frontend.fzn import parse_fzn_text as jax_parse
from turbo_tpu.solver import engine as jax_engine
from turbo_tpu.solver.plan import build_plan as jax_build_plan
from turbo_tpu_torch.host.compile.model import compile_model
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text
from turbo_tpu_torch.host.solver.plan import build_plan
from turbo_tpu_torch.instances import golomb, random_model
from turbo_tpu_torch.solver import config as port_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
HOST_MODULES = ("frontend.ast", "frontend.fzn", "frontend.native",
                "frontend.xcsp3", "compile.tnf", "compile.model",
                "compile.analyze", "core.ops", "solver.plan",
                "solver.oracle", "solver.deduce_np", "solver.strategy",
                "solver.timers", "utils.config", "utils.output",
                "utils.checker")
MODELS = [random_model(3), random_model(4, n_vars=9, n_cons=24), golomb(5)]


def _same(a, b, path="root"):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, path


def _cli_without_jax(tmp_path, extra=()):
    """The port's CLI on a tiny model in a fresh interpreter, with the
    host layer and the solver modules imported; fails if jax or the JAX
    package was loaded."""
    model = tmp_path / "m.fzn"
    model.write_text(random_model(0))
    mods = ", ".join(repr(f"turbo_tpu_torch.host.{m}") for m in HOST_MODULES)
    code = (
        "import importlib, sys\n"
        "import turbo_tpu_torch.cli as cli\n"
        f"for m in ({mods}):\n"
        "    importlib.import_module(m)\n"
        "import turbo_tpu_torch.solver.engine, turbo_tpu_torch.kernels\n"
        "import turbo_tpu_torch.parallel.mesh\n"
        f"rc = cli.main([{str(model)!r}, '-platform', 'cpu', '-s'] + "
        f"{list(extra)!r})\n"
        "assert rc == 0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'turbo_tpu' not in sys.modules\n"
        "print('NOJAX')\n")
    # One torch thread: the suite's other workers hold the cores, and an
    # oversubscribed pool of threads slows the run several times over.
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NOJAX" in r.stdout and "----------" in r.stdout


def test_cli_never_loads_jax(tmp_path):
    """The port's CLI on a tiny model, in a fresh interpreter: jax is
    never imported, by the CLI or by the host layer it shares."""
    _cli_without_jax(tmp_path)


def test_cli_multi_never_loads_jax(tmp_path):
    """The same under ``-arch multi`` (``parallel/mesh.py``)."""
    _cli_without_jax(tmp_path, ["-arch", "multi", "-or", "4", "-sub", "3"])


def test_port_sources_import_no_jax():
    for f in (ROOT / "turbo_tpu_torch").rglob("*.py"):
        text = f.read_text()
        assert "import jax" not in text and "from jax" not in text, f


def test_cli_runs_only_port_files(tmp_path):
    """The port's CLI in a fresh interpreter (the native parser built
    from a cold build directory): every loaded ``turbo_tpu_torch`` module
    lies under ``turbo_tpu_torch/``, and no file under ``turbo_tpu/`` or
    ``native/`` is opened, imported or handed to a compiler."""
    model = tmp_path / "m.fzn"
    model.write_text(random_model(0))
    code = (
        "import os, sys\n"
        "seen = []\n"
        "def hook(event, args):\n"
        "    if event == 'open' and isinstance(args[0], str):\n"
        "        seen.append(os.path.abspath(args[0]))\n"
        "    elif event == 'subprocess.Popen':\n"
        "        seen.extend(os.path.abspath(str(a)) for a in args[1])\n"
        "sys.addaudithook(hook)\n"
        "import turbo_tpu_torch.cli as cli\n"
        "from turbo_tpu_torch.host.frontend import native\n"
        f"native._SO = {str(tmp_path / 'build' / 'libfznparser.so')!r}\n"
        f"rc = cli.main([{str(model)!r}, '-platform', 'cpu', '-s'])\n"
        "assert rc == 0 and native._lib is not None\n"
        "for name, m in list(sys.modules.items()):\n"
        "    if name.startswith('turbo_tpu_torch'):\n"
        f"        f = getattr(m, '__file__', None) or ''\n"
        f"        assert f.startswith({str(ROOT / 'turbo_tpu_torch')!r}), (name, f)\n"
        f"for bad in ({str(ROOT / 'turbo_tpu') + os.sep!r}, "
        f"{str(ROOT / 'native') + os.sep!r}):\n"
        "    hit = [f for f in seen if f.startswith(bad)]\n"
        "    assert not hit, hit[:5]\n"
        f"assert {str(ROOT / 'turbo_tpu_torch' / 'host' / 'native' / 'fzn_parser.cpp')!r} in seen\n"
        "print('PORT-ONLY')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "PORT-ONLY" in r.stdout


def test_port_sources_name_no_jax_package_path():
    """No port source reaches into the JAX package's directory or the
    repository's native/ directory (the host layer used to, through a
    ``__path__`` pointing at ``turbo_tpu/``)."""
    for f in (ROOT / "turbo_tpu_torch").rglob("*.py"):
        text = f.read_text()
        assert "submodule_search_locations" not in text, f
        assert "__path__" not in text, f
        assert 'find_spec("turbo_tpu")' not in text, f
    from turbo_tpu_torch.host.frontend import native
    host = ROOT / "turbo_tpu_torch" / "host"
    assert pathlib.Path(native._SRC).resolve() == host / "native" / "fzn_parser.cpp"
    assert pathlib.Path(native._SO).resolve().is_relative_to(host / "native")
    assert (pathlib.Path(native._SRC).read_bytes()
            == (ROOT / "native" / "fzn_parser.cpp").read_bytes())


def test_solver_api_defaults_to_the_card():
    import torch
    from turbo_tpu_torch.solver.engine import BatchedSolver
    tnf = compile_model(parse_fzn_text(golomb(4)))
    cfg = port_config.EngineConfig(num_dives=4)
    if torch.cuda.is_available():
        assert BatchedSolver(tnf, cfg).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchedSolver(tnf, cfg)
    assert BatchedSolver(tnf, cfg, device="cpu").device.type == "cpu"


def test_sharded_solver_defaults_to_the_card():
    """One shard per visible card by default; repeated devices are lane
    groups on one device."""
    import torch
    from turbo_tpu_torch.parallel.mesh import ShardedSolver
    tnf = compile_model(parse_fzn_text(golomb(4)))
    cfg = port_config.EngineConfig(num_dives=4)
    if torch.cuda.device_count() > 1:
        with pytest.raises(NotImplementedError, match="A12"):
            ShardedSolver(tnf, cfg)
    elif torch.cuda.is_available():
        s = ShardedSolver(tnf, cfg)
        assert (s.n_shards, s.device.type) == (1, "cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedSolver(tnf, cfg)
    s = ShardedSolver(tnf, cfg, devices=["cpu"] * 3)
    assert (s.n_shards, s.device.type, s.solver.num_shards) == (3, "cpu", 3)


@pytest.mark.parametrize("mi", range(len(MODELS)))
def test_tnf_and_plan_equal_to_jax_package(mi):
    text = MODELS[mi]
    tnf_j = jax_compile(jax_parse(text))
    tnf_t = compile_model(parse_fzn_text(text))
    _same(tnf_j, tnf_t)
    _same(jax_build_plan(tnf_j), build_plan(tnf_t))


@pytest.mark.parametrize("mi", range(len(MODELS)))
def test_copied_host_functions_equal_originals(mi):
    text = MODELS[mi]
    tnf_j = jax_compile(jax_parse(text))
    tnf_t = compile_model(parse_fzn_text(text))
    for seed, eps in ((1, "default"), (7, "first_fail"), (3, "input_order")):
        kw = dict(seed=seed, eps_var_order=eps, num_dives=16)
        cj, ct = jax_engine.EngineConfig(**kw), port_config.EngineConfig(**kw)
        pj, pt = jax_build_plan(tnf_j), build_plan(tnf_t)
        assert (jax_engine.apply_strategy_config(pj, cj)
                == port_config.apply_strategy_config(pt, ct))
        _same(pj.strategies, pt.strategies)
        assert jax_engine.auto_max_depth(pj) == port_config.auto_max_depth(pt)
        for k in (0, 5):
            for D, shards in ((16, 1), (1024, 1), (64, 4)):
                a = dataclasses.replace(cj, subproblems_power=k, num_dives=D)
                b = dataclasses.replace(ct, subproblems_power=k, num_dives=D)
                assert (jax_engine.choose_subproblems_power(
                            tnf_j, a, shards, allow_probe=False)
                        == port_config.choose_subproblems_power(
                            tnf_t, b, shards, allow_probe=False))
    # The probe is wall-clock bounded; these trees are far inside it.
    assert (jax_engine.probe_tree_power(tnf_j, probe_timeout_s=30)
            == port_config.probe_tree_power(tnf_t, probe_timeout_s=30))


def test_random_strategies_shuffle_like_the_original():
    text = """
    var 0..5: a :: output_var; var 0..5: b :: output_var;
    var 0..5: c :: output_var; var 0..5: d :: output_var;
    constraint int_lin_le([1, 1, 1, 1], [a, b, c, d], 9);
    solve :: int_search([a, b, c, d], random, indomain_min, complete)
        maximize a;
    """
    pj = jax_build_plan(jax_compile(jax_parse(text)))
    pt = build_plan(compile_model(parse_fzn_text(text)))
    # The compiler maps `random` to input_order; set it on the plan.
    for p in (pj, pt):
        p.strategies[0].var_order = "random"
    jax_engine.apply_strategy_config(pj, jax_engine.EngineConfig(seed=11))
    port_config.apply_strategy_config(pt, port_config.EngineConfig(seed=11))
    _same(pj.strategies, pt.strategies)


def test_engine_config_defaults_are_the_jax_defaults():
    """The port's EngineConfig carries the JAX defaults for every field
    it has (the EPS table and cap calibration on), so the port's CLI
    runs the JAX CLI's default search. The one exception is the plane
    layout inside the fixpoint: both layouts give equal stores, and on
    the card the transposed one costs the step two copies each way."""
    jax_cfg, port_cfg = jax_engine.EngineConfig(), port_config.EngineConfig()
    fields = [f.name for f in dataclasses.fields(port_cfg)]
    assert {"use_table", "fp_cap_auto", "fp_mode", "fp_layout",
            "wac1_threshold"} <= set(fields)
    assert (port_cfg.fp_layout, jax_cfg.fp_layout) == ("dv", "vd")
    for f in fields:
        if f != "fp_layout":
            assert getattr(port_cfg, f) == getattr(jax_cfg, f), f
