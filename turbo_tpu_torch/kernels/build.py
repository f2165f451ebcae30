"""Build the CUDA kernels with nvcc into a shared library and load it.

The sources in ``csrc/`` have a plain C interface; each is compiled for
Hopper (``sm_90a``) by its own nvcc, all started together, and the
objects are linked into ``_build/libturbo_kernels_<hash>.so``, keyed by
a hash of the sources and flags, and loaded through ``ctypes``. The
build happens at first use; a failure raises (nothing falls back to the
plain torch versions). ``without_skip`` builds and launches from a
second library whose K1 and K8 run every rule in every sweep and pass,
for measurements only.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

from ..solver import tree_probe

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("fixpoint.cu", "classify.cu", "select.cu", "table_refill.cu",
           "table_leaf.cu", "open_count.cu", "step.cu", "step_tail.cu",
           "wac1.cu", "steal.cu", "xcard.cu")
# No FMA contraction: K6's float32 deds must round the multiply and the
# add separately, as the plain torch version does.
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs = {}          # no_skip -> loaded library
_no_skip = False    # the wrappers launch from the build without the skip
build_log = ""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of turbo_tpu_torch cannot be built")


def _digest(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _bind(lib):
    P = ctypes.c_void_p
    I = ctypes.c_int
    for fn in (lib.tt_fixpoint, lib.tt_fixed_sweeps, lib.tt_fixpoint_t):
        fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, P, P]
    lib.tt_fixpoint_step.argtypes = [P] * 8 + [I, I, I, P, P] + [P] * 11
    lib.tt_fixpoint_step_stamped.argtypes = (lib.tt_fixpoint_step.argtypes
                                             + [P, P])
    lib.tt_fixpoint_level.argtypes = [P, P, P, I, I, I, P]
    lib.tt_fixpoint_blocks_per_sm.argtypes = [P, I, I, P]
    lib.tt_wac1.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, P, P]
    lib.tt_wac1_step.argtypes = [P] * 8 + [I, I, I, I, P, P] + [P] * 11
    lib.tt_wac1_step_stamped.argtypes = lib.tt_wac1_step.argtypes + [P, P]
    lib.tt_wac1_level.argtypes = [P, P, P, I, I, I, I, P]
    lib.tt_wac1_blocks_per_sm.argtypes = [P, I, I, P]
    lib.tt_classify.argtypes = [P, P, P, P, P, I, P, P]
    lib.tt_select.argtypes = [P, P, P, P, P, P, P, P, P, P, P, P, I, P, P]
    lib.tt_table_refill.argtypes = [P] * 8 + [I, I, I, P]
    lib.tt_table_leaf.argtypes = [P] * 8 + [I, I, I, I, I, P]
    lib.tt_open_count.argtypes = [P, P, P, P, P, I, I, P]
    lib.tt_steal.argtypes = [P, I, P]
    lib.tt_step_head.argtypes = [P, P, P, P]
    lib.tt_step_head_timed.argtypes = [P, P, P, P, P]
    lib.tt_step_post.argtypes = [P, P, P, I, I, P]
    lib.tt_step_post_timed.argtypes = [P, P, P, I, I, P, P]
    lib.tt_step_copy.argtypes = [P, P, P]
    lib.tt_step_live.argtypes = [P, P, P]
    lib.tt_xcard.argtypes = [P, I, I, P, P, P]
    lib.tt_enable_peer.argtypes = [I, I]
    loads = [getattr(lib, f"tt_{s[:-3]}_load") for s in SOURCES]
    for fn in loads:
        fn.argtypes = [P, I]
    lib.tt_runtime_init.argtypes = []
    for fn in (lib.tt_fixpoint, lib.tt_fixed_sweeps, lib.tt_fixpoint_t,
               lib.tt_fixpoint_step, lib.tt_fixpoint_step_stamped,
               lib.tt_fixpoint_level, lib.tt_fixpoint_blocks_per_sm,
               lib.tt_wac1, lib.tt_wac1_step, lib.tt_wac1_step_stamped,
               lib.tt_wac1_level, lib.tt_wac1_blocks_per_sm,
               lib.tt_classify, lib.tt_select, lib.tt_table_refill,
               lib.tt_table_leaf, lib.tt_open_count, lib.tt_step_head,
               lib.tt_step_head_timed,
               lib.tt_step_post, lib.tt_step_post_timed,
               lib.tt_step_copy, lib.tt_step_live, lib.tt_steal,
               lib.tt_xcard, lib.tt_enable_peer,
               lib.tt_runtime_init, *loads):
        fn.restype = I
    lib.tt_error_string.argtypes = [I]
    lib.tt_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def without_skip():
    """Inside the block every wrapper launches from a library built with
    ``-DTT_NO_SKIP`` (K1 runs every rule in every sweep, K8 in every
    pass), which chip_smoke.py times against the normal build; the
    solver never uses it. Yields the library."""
    global _no_skip
    prev, _no_skip = _no_skip, True
    try:
        yield load()
    finally:
        _no_skip = prev


def load():
    """Build (at first use, once per source hash) and load the kernel
    library (the one without the skip inside ``without_skip``);
    raises when the kernels cannot be built. Builds and loads the host
    library of the EPS tree probe (``solver/tree_probe.py``) first, so
    that no request compiles it."""
    global build_log
    tree_probe.load()
    key = _no_skip
    if key in _libs:
        return _libs[key]
    flags = FLAGS + (("-DTT_NO_SKIP",) if key else ())
    out = BUILD_DIR / f"libturbo_kernels_{_digest(flags)}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs = [tmp.with_name(f"{tmp.name}.{s}.o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(o),
                                   str(CSRC / s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs, failed = [], []
        for s, pr in zip(SOURCES, procs):
            logs.append(f"== {s}\n{pr.communicate()[0]}")
            if pr.returncode != 0:
                failed.append(f"{s} ({pr.returncode})")
        if not failed:
            r = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                                *map(str, objs)], capture_output=True,
                               text=True)
            logs.append(f"== link\n{r.stdout}{r.stderr}")
            if r.returncode != 0:
                failed.append(f"link ({r.returncode})")
        for o in objs:
            o.unlink(missing_ok=True)
        build_log = "".join(logs)
        (BUILD_DIR / "build.log").write_text(build_log)
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n"
                               f"{build_log}")
        os.replace(tmp, out)
    _libs[key] = _bind(ctypes.CDLL(str(out)))
    return _libs[key]
