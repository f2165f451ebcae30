"""The JAX package's host layer, shared without a copy.

``__path__`` points at the ``turbo_tpu`` package directory, so
``turbo_tpu_torch.host.X`` loads the file ``turbo_tpu/X.py`` as a module
of this package, and ``turbo_tpu/__init__.py`` (which imports jax) never
runs. Only these modules may be imported through it; they import
nothing of jax:

- ``frontend.ast``, ``frontend.fzn``, ``frontend.native``,
  ``frontend.xcsp3``
- ``compile.tnf``, ``compile.model``, ``compile.analyze``
- ``core.ops``
- ``solver.plan``, ``solver.oracle``, ``solver.deduce_np``,
  ``solver.strategy``, ``solver.timers``
- ``utils.config``, ``utils.output``, ``utils.checker``

Importing any other module through it (``solver.engine``,
``solver.propagate_jax``, ``utils.device``, ...) pulls in jax and is a
bug; ``tests/test_torch_host.py`` guards against it.
"""
import importlib.util as _ilu

from .. import __version__  # noqa: F401  (utils.config reads it)

__path__ = list(_ilu.find_spec("turbo_tpu").submodule_search_locations)
