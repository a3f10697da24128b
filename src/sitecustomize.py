"""Start-up hook for processes run with ``PYTHONPATH=src``: the jax 0.9
compatibility patch of the repo-root ``conftest.py``, for processes that
pytest does not start (subprocess tests, scripts importing ``repro``).

``repro.core.efta`` asks ``optimization_barrier_p in
batching.primitive_batchers``. On jax 0.9 that mapping is a
``PrimitiveBatchersProxy`` without ``__contains__``, so the ``in`` test
raises ``TypeError`` and importing ``repro.core`` fails. Answering "not
registered" makes ``efta.py`` register its own (identity) batching rule, as
it does on the jax versions that have no proxy.

The patch is lazy: a ``sys.meta_path`` finder waits for
``jax._src.interpreters.batching`` to load and patches it then. A process
that never imports jax (the PyTorch port, a machine without jax) imports
nothing here.
"""
import importlib.abc
import importlib.machinery
import sys

_TARGET = "jax._src.interpreters.batching"


def _patch(module) -> None:
    proxy = getattr(module, "PrimitiveBatchersProxy", None)
    if proxy is not None:
        proxy.__contains__ = lambda self, p: False


class _PatchingLoader(importlib.abc.Loader):
    def __init__(self, loader):
        self._loader = loader

    def create_module(self, spec):
        return self._loader.create_module(spec)

    def exec_module(self, module):
        self._loader.exec_module(module)
        _patch(module)


class _BatchingFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path, target=None):
        if fullname != _TARGET:
            return None
        spec = importlib.machinery.PathFinder.find_spec(fullname, path, target)
        if spec is not None and spec.loader is not None:
            spec.loader = _PatchingLoader(spec.loader)
        return spec


if _TARGET in sys.modules:
    _patch(sys.modules[_TARGET])
else:
    sys.meta_path.insert(0, _BatchingFinder())
