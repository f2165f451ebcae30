"""``graph_replay_pct.window``'s share over every proof of the window:
each proof builds a new solver, and so new graphs."""
import pathlib

from portbench import harness


def read(cell):
    window = harness.load_module(
        pathlib.Path(__file__).with_name("graph_replay_pct.window.py"),
        "metric")
    return window.read(cell)
