"""The plain reference: the FlatZinc checker of printed solutions on
the generators' models, and the seeded constraint order."""
import random

from portbench import reference
from portbench.generators import golomb, queens

# Optimal rulers (OEIS A003022), the first difference below the last.
RULERS = {5: [0, 1, 4, 9, 11], 6: [0, 1, 4, 10, 12, 17],
          7: [0, 1, 4, 10, 18, 23, 25], 8: [0, 1, 4, 9, 15, 22, 32, 34]}


def golomb_output(marks, final="==========", objective=None):
    m = len(marks)
    lines = [f"m{i} = {v};" for i, v in enumerate(marks)]
    lines += [f"d{i}_{j} = {marks[j] - marks[i]};"
              for i in range(m) for j in range(i + 1, m)]
    lines.append(f"mark = array1d(1..{m}, [{', '.join(map(str, marks))}]);")
    lines.append("----------")
    if final:
        lines.append(final)
    obj = marks[-1] if objective is None else objective
    lines += ["%%%mzn-stat: nodes=10", f"%%%mzn-stat: objective={obj}",
              "%%%mzn-stat-end"]
    return "\n".join(lines) + "\n"


def judge_golomb(m, text, seed=0, expect="proof"):
    model = reference.parse(golomb.generate(m, seed))
    return reference.judge(model, reference.read_output(model, text), expect,
                           golomb.OPTIMUM[m])


def test_checker_accepts_golomb_optima():
    for m, marks in RULERS.items():
        assert marks[-1] == golomb.OPTIMUM[m]
        for seed in (0, 7, 2**40 + 3):
            j = judge_golomb(m, golomb_output(marks), seed)
            assert not j.failed(), (m, seed, j)


def test_checker_rejects_corrupted_golomb():
    marks = RULERS[8]
    # A mark altered where it is printed: its differences no longer hold.
    text = golomb_output(marks).replace("m3 = 9;", "m3 = 10;")
    assert judge_golomb(8, text).violations > 0
    # A ruler whose differences repeat (all printed consistently).
    assert judge_golomb(8, golomb_output([0, 1, 2, 9, 15, 22, 32, 34])
                        ).violations > 0
    # The objective statistic not the printed value.
    assert judge_golomb(8, golomb_output(marks, objective=33)
                        ).objective_mismatch == 1
    # A proof claimed at a ruler that is valid but not optimal.
    longer = [0, 1, 4, 9, 15, 22, 32, 48]
    j = judge_golomb(8, golomb_output(longer))
    assert j.violations == 0 and j.wrong_optimum == 1
    # No proof printed where one is due; nothing printed at all.
    assert judge_golomb(8, golomb_output(marks, final=None)).unproved == 1
    j = judge_golomb(8, "=====UNKNOWN=====\n")
    assert j.unanswered == 1 and j.unproved == 1
    assert judge_golomb(8, "=====UNSATISFIABLE=====\n").wrong_optimum == 1
    # A window's answer needs no proof; how far it fell short of the
    # optimum is the gap, held to the limit its traffic states.
    j = judge_golomb(8, golomb_output(longer, final=None), expect="solution")
    assert not j.failed() and j.objective_gap == 48 - 34
    assert j.failed({"objective_gap": 13}) and not j.failed(
        {"objective_gap": 14})
    assert judge_golomb(8, golomb_output(marks, final=None),
                        expect="solution").objective_gap == 0


def all_queens(n):
    out, q = [], []

    def place(c):
        if c == n:
            out.append([r + 1 for r in q])
            return
        for r in range(n):
            if all(r != s and abs(r - s) != c - i for i, s in enumerate(q)):
                q.append(r)
                place(c + 1)
                q.pop()
    place(0)
    return out


def queens_output(sols, n):
    blocks = [f"q = array1d(1..{n}, [{', '.join(map(str, s))}]);\n----------\n"
              for s in sols]
    return "".join(blocks) + "==========\n"


def test_checker_accepts_queens_counts():
    for n in (6, 7, 8):
        model = reference.parse(queens.generate(n, n))
        sols = all_queens(n)
        out = reference.read_output(model, queens_output(sols, n))
        assert len(out.solutions) == queens.COUNT[n]
        assert len({tuple(sorted(s.items())) for s in out.solutions}) \
            == queens.COUNT[n]
        assert not reference.judge(model, out, "solution", None).failed()
        bad = list(sols[0])
        bad[1] = bad[0]  # two queens on one row
        j = reference.judge(model, reference.read_output(
            model, queens_output([bad], n)), "solution", None)
        assert j.violations > 0


def test_permutation_keeps_the_model():
    for gen, size in ((golomb, 9), (queens, 8)):
        base = gen.generate(size, 0).splitlines()
        for seed in (1, 99, 2**45 + 1):
            text = gen.generate(size, seed).splitlines()
            assert sorted(text) == sorted(base)
            cons = [ln for ln in text if ln.startswith("constraint")]
            assert cons != [ln for ln in base if ln.startswith("constraint")]
            # Declarations first, the solve item last, as FlatZinc wants.
            assert text[-1] == base[-1]
            assert text[:len(text) - len(cons) - 1] == \
                base[:len(base) - len(cons) - 1]
    assert golomb.generate(9, 5) == golomb.generate(9, 5)
    rng = random.Random(3)
    for _ in range(3):
        seed = rng.getrandbits(63)
        assert not judge_golomb(7, golomb_output(RULERS[7]), seed).failed()
