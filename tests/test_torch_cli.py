"""The port's CLI against ``turbo_tpu.cli`` on in-line models.

Both CLIs run their defaults (EPS table, live cap calibration). Each
model has a unique optimal solution, so both must print the same
solution block and the same final separator, and the same set of
``%%%mzn-stat`` keys.
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
    path = tmp_path / "m.fzn"
    path.write_text(MODELS["linear"])
    for extra, what in ((["-arch", "hybrid"], "-arch hybrid"),
                        (["-checkpoint", str(tmp_path / "c")], "-checkpoint")):
        with pytest.raises(NotImplementedError, match=what):
            port_cli.main([str(path), "-platform", "cpu"] + extra)
