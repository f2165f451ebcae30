"""K8 alone on golomb(12) search stores, by cap, in one checkout.

``python scripts/k8_bench.py TREE [prof]`` runs, with the
``turbo_tpu_torch`` of checkout TREE (for example a copy of the tree with
another design of ``kernels/csrc/wac1.cu``), 40 steps of golomb(12) at
D=512 under ``fp_mode="wac1"``, cap 16, on the card; holds K8 on the
state's stores equal to ``fixpoint_wac1_plain`` at caps 16 and 10000
(tolerance 0: all integer); and prints one JSON line of medians of 15
launches (CUDA events): K8 at caps 1, 2, 4 and 16, its step entry and
its global-memory path at cap 16. ``prof``: one launch at cap 16 and
nothing else (for a build that prints its own counters).
"""
import json
import pathlib
import sys

tree = str(pathlib.Path(sys.argv[1]).resolve())
sys.path.insert(0, tree)
import torch  # noqa: E402
from turbo_tpu_torch import kernels  # noqa: E402
from turbo_tpu_torch.host.compile.model import compile_model  # noqa: E402
from turbo_tpu_torch.host.frontend.fzn import parse_fzn_text  # noqa: E402
from turbo_tpu_torch.instances import golomb  # noqa: E402
from turbo_tpu_torch.solver.config import EngineConfig  # noqa: E402
from turbo_tpu_torch.solver.engine import BatchedSolver  # noqa: E402

assert kernels.__file__.startswith(tree), kernels.__file__
kernels.load()
s = BatchedSolver(compile_model(parse_fzn_text(golomb(12))),
                  EngineConfig(num_dives=512, fp_mode="wac1",
                               fp_cap_auto=False), device="cuda:0")
st = s.init_state()
st, _ = s.run_steps(st, 40, 16)
torch.cuda.synchronize()
kp, pk = s.kernels.kernel_plan, s.kernels
lb, ub = st.lb.clone(), st.ub.clone()
if sys.argv[2:] == ["prof"]:
    print("=== PROF START", flush=True)
    kernels.wac1(kp, lb, ub, 16, 16)
    torch.cuda.synchronize()
    sys.exit(0)
for cap in (16, 10000):
    got = kernels.wac1(kp, lb, ub, cap, 16)
    want = pk.fixpoint_wac1_plain(lb, ub, cap, 16)
    for g, w in zip(got, want):
        assert torch.equal(g, w), cap
    print("iters: mean", float(got[2].float().mean()), "max",
          int(got[2].max()), flush=True)


def median(fn, reps=15):
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]


strat = torch.zeros(512, dtype=torch.int32, device="cuda:0")
res = {c: median(lambda c=c: kernels.wac1(kp, lb, ub, c, 16))
       for c in (1, 2, 4, 16)}
res["step16"] = median(lambda: kernels.wac1.step(kp, lb, ub, 16, 16, strat))
res["global16"] = median(lambda: kernels.wac1(kp, lb, ub, 16, 16, smem=False))
print(json.dumps({"tree": tree, **res}), flush=True)
