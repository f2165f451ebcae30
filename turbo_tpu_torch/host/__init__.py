"""The port's host layer: its own copy of the JAX package's numpy modules.

Copied unchanged from ``turbo_tpu/`` (the same subpackages, so the
relative imports hold), so that the port runs no file of the JAX
package; ``tests/test_torch_host.py`` holds each copy to its original:

- ``frontend.ast``, ``frontend.fzn``, ``frontend.native``,
  ``frontend.xcsp3`` (``native/fzn_parser.cpp``, built with g++ into
  ``native/build/`` at first use)
- ``compile.tnf``, ``compile.model``, ``compile.analyze``
- ``core.ops``
- ``solver.plan``, ``solver.oracle``, ``solver.deduce_np``,
  ``solver.strategy``, ``solver.timers``
- ``utils.config``, ``utils.output``, ``utils.checker``

What differs from the originals: the path of the native parser's source
and build in ``frontend/native.py``, and four docstrings that named a
local checkout of the reference.
"""
from .. import __version__  # noqa: F401  (utils.config reads it)
