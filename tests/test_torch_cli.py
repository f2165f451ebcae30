"""The port's CLI against ``turbo_tpu.cli`` on in-line models.

Both CLIs run their defaults (EPS table, live cap calibration), then
``-fp wac1``, ``-arch hybrid`` and a ``-checkpoint`` resume. Each model
has a unique optimal solution, so both must print the same solution
block and the same final separator, and the same set of ``%%%mzn-stat``
keys.
"""
import re

import pytest

import turbo_tpu.cli as jax_cli
import turbo_tpu_torch.cli as port_cli
from turbo_tpu_torch.instances import golomb

MODELS = {
    "golomb4": golomb(4),
    "element_member": """
array [1..6] of int: t = [4, 9, 2, 9, 7, 5];
var 1..6: i :: output_var;
var {2,4,7,9}: r :: output_var;
var 1..6: j;
constraint array_int_element(i, t, r);
constraint int_ne(i, j);
solve minimize r;
""",
    "linear": """
var 0..10: x :: output_var;
var 0..10: y :: output_var;
var 0..20: s :: output_var;
constraint int_lin_le([2, 3], [x, y], 12);
constraint int_le(y, x);
constraint int_lin_eq([1, 1, -1], [x, y, s], 0);
solve :: int_search([x, y], first_fail, indomain_split, complete) maximize s;
""",
}


def _run(main, path, capsys, extra):
    assert main([str(path), "-s", "-platform", "cpu", "-or", "8"] + extra) == 0
    out = capsys.readouterr().out
    keys = set(re.findall(r"^%%%mzn-stat: (\w+)=", out, re.M))
    body = [l for l in out.splitlines() if not l.startswith("%")]
    cut = body.index("----------")
    return body[:cut], body[cut + 1:], keys


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cli_output_matches_jax_cli(name, tmp_path, capsys):
    path = tmp_path / f"{name}.fzn"
    path.write_text(MODELS[name])
    sol_j, tail_j, keys_j = _run(jax_cli.main, path, capsys, ["-arch", "tpu"])
    sol_t, tail_t, keys_t = _run(port_cli.main, path, capsys, [])
    assert sol_t == sol_j
    assert tail_t == tail_j == ["=========="]
    assert keys_t == keys_j


def test_unported_options_raise(tmp_path):
    """Every option is ported; ``-hosts 2`` without ``-coordinator``
    raises the JAX CLI's ValueError."""
    path = tmp_path / "m.fzn"
    path.write_text(MODELS["linear"])
    argv = [str(path), "-platform", "cpu", "-hosts", "2"]
    with pytest.raises(ValueError, match="-coordinator") as want:
        jax_cli.main(argv)
    with pytest.raises(ValueError, match="-coordinator") as got:
        port_cli.main(argv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,extra", [("golomb4", []), ("linear", []),
                                        ("pairs", ["-a"])])
def test_cli_multi_matches_jax_cli(name, extra, tmp_path, capsys):
    """``-arch multi``: the port (one shard under ``-platform cpu``)
    prints the solution blocks, final separator and stat keys of the JAX
    CLI on its 8 virtual CPU devices (a unique optimum; under ``-a`` on
    a satisfaction model the same set of blocks)."""
    path = tmp_path / f"{name}.fzn"
    path.write_text(MODELS.get(name, PAIRS))
    args = ["-arch", "multi", "-sub", "4"] + extra
    out = {}
    for label, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        assert main([str(path), "-s", "-platform", "cpu", "-or", "4"]
                    + args) == 0
        text = capsys.readouterr().out
        body = [l for l in text.splitlines() if not l.startswith("%")]
        blocks = "\n".join(body).split("----------")
        out[label] = (sorted(blocks[:-1]), blocks[-1],
                      set(re.findall(r"^%%%mzn-stat: (\w+)=", text, re.M)))
    assert out["port"] == out["jax"]
    assert out["port"][1].strip() == "=========="
    assert len(out["port"][0]) == (6 if extra else 1)


PAIRS = """
var 1..4: x :: output_var;
var 1..4: y :: output_var;
constraint int_lt(x, y);
solve satisfy;
"""


OPTIONS = {
    "wac1": ["-fp", "wac1"],
    "wac1_threshold": ["-fp", "wac1", "-wac1_threshold", "2"],
    "wac1_below_threshold": ["-fp", "wac1", "-wac1_threshold", "100000"],
    "hybrid": ["-arch", "hybrid"],
    "hybrid_wac1": ["-arch", "hybrid", "-fp", "wac1"],
    "hybrid_intermediate": ["-arch", "hybrid", "-i"],
}


@pytest.mark.parametrize("opt", sorted(OPTIONS))
@pytest.mark.parametrize("name", ["golomb4", "linear"])
def test_cli_options_match_jax_cli(name, opt, tmp_path, capsys):
    """``-fp wac1`` and ``-arch hybrid``: the same solution blocks,
    separators and stat keys as the JAX CLI."""
    path = tmp_path / f"{name}.fzn"
    path.write_text(MODELS[name])
    extra = OPTIONS[opt]
    arch = [] if "-arch" in extra else ["-arch", "tpu"]
    sol_j, tail_j, keys_j = _run(jax_cli.main, path, capsys, arch + extra)
    sol_t, tail_t, keys_t = _run(port_cli.main, path, capsys, extra)
    assert sol_t == sol_j
    assert tail_t == tail_j and tail_t[-1] == "=========="
    assert keys_t == keys_j
    assert ("wac1_threshold" in keys_t) == ("wac1" in extra)


@pytest.mark.parametrize("arch", ["tpu", "hybrid"])
def test_cli_checkpoint_resume_matches_jax_cli(arch, tmp_path, capsys):
    """``-checkpoint``: a run cut by ``-cutnodes`` writes the file and
    prints no final separator; the next run resumes from it and closes.
    Both CLIs print the same blocks and stat keys in both runs."""
    path = tmp_path / "golomb6.fzn"
    path.write_text(golomb(6))
    base = ["-arch", arch, "-sub", "5"]
    outs = {}

    def run(main, extra):
        assert main([str(path), "-s", "-platform", "cpu", "-or", "8"]
                    + base + extra) == 0
        out = capsys.readouterr().out
        return ([l for l in out.splitlines() if not l.startswith("%")],
                set(re.findall(r"^%%%mzn-stat: (\w+)=", out, re.M)))

    for label, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        ck = tmp_path / f"{label}.ckpt"
        cut = run(main, ["-checkpoint", str(ck), "-cutnodes", "40"])
        assert ck.exists()
        outs[label] = (cut, run(main, ["-checkpoint", str(ck)]))
    (cut_j, res_j), (cut_t, res_t) = outs["jax"], outs["port"]
    # Cut: the same blocks (if any) and no final separator.
    assert cut_t == cut_j and "==========" not in cut_t[0]
    assert res_t == res_j
    assert "m5 = 17;" in res_t[0] and res_t[0][-1] == "=========="
