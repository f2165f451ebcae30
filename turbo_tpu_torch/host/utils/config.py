"""Command-line configuration, mirroring the reference's flag surface.

The accepted flags follow the reference's `parse_args`
(src/config.cpp:128-220; usage text at src/config.cpp:11-44) so the
solver is a drop-in for MiniZinc `.msc` integration, plus TPU-specific
extras. Arch names: `cpu` = sequential oracle; `tpu` (alias
`barebones`, `gpu`) = batched dive-and-solve on the accelerator;
`multi` = dive batch sharded over all visible devices.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class Configuration:
    problem_path: str = ""
    arch: str = "tpu"
    timeout_ms: int = 0                  # 0 = no timeout (-t)
    print_all_solutions: bool = False    # -a
    stop_after_n_solutions: int = 1      # -n
    print_intermediate: bool = False     # -i
    free_search: bool = False            # -f
    print_statistics: bool = False       # -s
    verbose: int = 0                     # -v (counted)
    print_ast: bool = False              # -ast
    or_nodes: int = 0                    # -or (dives per device; 0 = auto,
                                         # config.hpp:74 + occupancy default)
    subproblems_power: int = 0           # -sub (2^n subproblems)
    subproblems_factor: int = 300        # -subfactor
    stop_after_n_nodes: int = 0          # -cutnodes (0 = inf)
    seed: int = 1                        # -seed
    max_depth: int = 0                   # -stack analog: decision stack
                                         # depth; 0 = auto from instance
    eps_var_order: str = "default"
    eps_value_order: str = "default"
    disable_simplify: bool = False
    shave: bool = False                  # (TPU extra) root shaving presolve
    force_ternarize: bool = False
    disable_network_analysis: bool = False
    checkpoint_path: str = ""
    fixpoint: str = "ac1"                # -fp <ac1|wac1>
    wac1_threshold: int = 0              # -wac1_threshold
    version_tag: str = ""                # -version (echo-only, config.cpp:36)
    hardware: str = ""                   # -hardware (echo-only, config.cpp:37)
    platform: str = ""                   # -platform (TPU extra): force the
                                         # jax platform; empty = probe the
                                         # default with a hang watchdog
    only_global_memory: bool = False     # -globalmem (no-op on TPU: there is
                                         # no shared-vs-global placement axis)
    # Multi-host EPS (TPU extras; the reference scales past one GPU via
    # SLURM job arrays, hpc/run-helios.sh — here one solver spans hosts
    # over jax.distributed, parallel/multihost.py).
    hosts: int = 1                       # -hosts (processes in the run)
    host_id: int = 0                     # -host_id (this process's index)
    coordinator: str = ""                # -coordinator host:port rendezvous


def parse_args(argv=None) -> Configuration:
    p = argparse.ArgumentParser(
        prog="turbo-tpu",
        description="TPU-native FlatZinc constraint solver "
                    "(propagate-and-search, EPS dive-and-solve)")
    p.add_argument("problem", help="path to .fzn model")
    p.add_argument("-t", type=int, default=0, metavar="MS",
                   help="timeout in milliseconds (0 = none)")
    p.add_argument("-timeout", type=int, default=None, metavar="MS",
                   help="same as -t; overrides -t when both are given "
                        "(config.cpp:13)")
    p.add_argument("-a", action="store_true",
                   help="print all solutions (satisfaction)")
    p.add_argument("-n", type=int, default=1, metavar="N",
                   help="stop after N solutions (satisfaction)")
    p.add_argument("-i", action="store_true",
                   help="print intermediate solutions (optimization)")
    p.add_argument("-f", action="store_true",
                   help="free search: ignore model search annotations")
    p.add_argument("-s", action="store_true", help="print statistics")
    p.add_argument("-v", action="count", default=0, help="verbose (repeatable)")
    p.add_argument("-ast", action="store_true", help="print the parsed model")
    p.add_argument("-arch", default="tpu",
                   choices=["cpu", "tpu", "barebones", "gpu", "hybrid", "multi"],
                   help="solver architecture")
    p.add_argument("-or", dest="or_nodes", type=int, default=None,
                   help="parallel dives per device (GPU blocks analog); "
                        "default 64")
    p.add_argument("-p", dest="and_nodes", type=int, default=None,
                   help="same as -or (config.cpp:22); mutually exclusive "
                        "with -or")
    p.add_argument("-sub", type=int, default=-1, metavar="N",
                   help="create 2^N EPS subproblems (-1 = auto, "
                        "config.cpp:30)")
    p.add_argument("-subfactor", type=int, default=300,
                   help="subproblems per dive lane (auto -sub)")
    p.add_argument("-cutnodes", type=int, default=0,
                   help="stop after N nodes (0 = no limit)")
    p.add_argument("-seed", type=int, default=1)
    p.add_argument("-stack", type=int, default=0, metavar="DEPTH",
                   help="decision stack depth per dive (0 = auto-size "
                        "from the instance; reference: stack KB, "
                        "config.cpp:35)")
    p.add_argument("-eps_var_order", default="default")
    p.add_argument("-eps_value_order", default="default")
    p.add_argument("-fp", default="ac1", choices=["ac1", "wac1"],
                   help="fixpoint variant: ac1 = Jacobi sweep over all "
                        "propagators; wac1 = per-group local fixpoints "
                        "(warp-fixpoint analog, config.cpp:25-27)")
    p.add_argument("-wac1_threshold", type=int, default=0,
                   help="use ac1 when fewer propagators than this "
                        "(config.cpp:28)")
    p.add_argument("-disable_simplify", action="store_true")
    p.add_argument("-shave", action="store_true",
                   help="enable the root bound-shaving presolve (TPU "
                        "extra; measured no-op on the golden proofs - "
                        "see DESIGN.md - so off by default)")
    p.add_argument("-force_ternarize", action="store_true")
    p.add_argument("-disable_network_analysis", action="store_true")
    p.add_argument("-globalmem", action="store_true",
                   help="accepted for compatibility (config.cpp:43); no "
                        "shared-vs-global memory axis exists on TPU")
    p.add_argument("-hardware", default="", metavar="DESC",
                   help='hardware description echoed in statistics '
                        '("CPU;RAM;TPU", config.cpp:37)')
    p.add_argument("-checkpoint", default="", metavar="PATH",
                   help="periodically save search state; resume if PATH exists")
    p.add_argument("-platform", default="", metavar="NAME",
                   help="force the jax platform (e.g. cpu); empty = use "
                        "the environment default, probed with a hang "
                        "watchdog (TURBO_TPU_PLATFORM env equivalent)")
    p.add_argument("-hosts", type=int,
                   default=int(os.environ.get("TURBO_TPU_HOSTS", "1")),
                   metavar="N",
                   help="number of cooperating host processes (multi-host "
                        "EPS over jax.distributed; default 1 = single "
                        "host; env TURBO_TPU_HOSTS)")
    p.add_argument("-host_id", type=int,
                   default=int(os.environ.get("TURBO_TPU_HOST_ID", "0")),
                   metavar="I",
                   help="this process's index in a -hosts N run "
                        "(env TURBO_TPU_HOST_ID)")
    p.add_argument("-coordinator",
                   default=os.environ.get("TURBO_TPU_COORDINATOR", ""),
                   metavar="HOST:PORT",
                   help="jax.distributed rendezvous address, required "
                        "when -hosts > 1 (env TURBO_TPU_COORDINATOR)")
    p.add_argument("-version", default="", metavar="TAG",
                   help="version identifier echoed in statistics for "
                        "replicability (config.cpp:36)")
    p.add_argument("--version", action="version",
                   version=_version_string())
    a = p.parse_args(argv)
    if a.or_nodes is not None and a.and_nodes is not None:
        p.error("the options -or and -p cannot be used at the same time")
    or_nodes = a.or_nodes if a.or_nodes is not None else \
        (a.and_nodes if a.and_nodes is not None else 0)
    arch = {"barebones": "tpu", "gpu": "tpu"}.get(a.arch, a.arch)
    return Configuration(
        problem_path=a.problem, arch=arch,
        timeout_ms=(a.timeout if a.timeout is not None else a.t),
        print_all_solutions=a.a,
        stop_after_n_solutions=(0 if a.a else a.n),
        print_intermediate=a.i or a.a, free_search=a.f,
        print_statistics=a.s, verbose=a.v, print_ast=a.ast,
        or_nodes=or_nodes,
        subproblems_power=(0 if a.sub < 0 else a.sub),
        subproblems_factor=a.subfactor, stop_after_n_nodes=a.cutnodes,
        seed=a.seed, max_depth=a.stack,
        eps_var_order=a.eps_var_order, eps_value_order=a.eps_value_order,
        checkpoint_path=a.checkpoint,
        disable_simplify=a.disable_simplify,
        shave=a.shave,
        force_ternarize=a.force_ternarize,
        disable_network_analysis=a.disable_network_analysis,
        fixpoint=a.fp, wac1_threshold=a.wac1_threshold,
        version_tag=a.version, hardware=a.hardware,
        platform=a.platform,
        only_global_memory=a.globalmem,
        hosts=a.hosts, host_id=a.host_id, coordinator=a.coordinator)


def _version_string() -> str:
    from .. import __version__

    return f"turbo-tpu {__version__}"
