"""Repo-wide pytest setup.

1. jax compat shim, installed before any test module imports ``repro``.
   ``repro.core.efta`` asks ``optimization_barrier_p in
   batching.primitive_batchers``; on jax 0.9 that mapping is a
   ``PrimitiveBatchersProxy`` without ``__contains__``, so the ``in`` test
   raises ``TypeError`` and every module importing ``repro.core`` fails at
   collection. Answering "not registered" makes ``efta.py`` register its own
   (identity) batching rule, exactly as it does on the jax versions that
   have no proxy. The shim lives here rather than in a test helper so that
   every pytest-xdist worker installs it, whichever test files it collects.

2. The ``cuda`` marker for tests that need an NVIDIA card. Whether a card is
   present is decided inside each test (``tests/_torch_util.py``), never at
   import or collection time, so every worker collects the same tests.
"""
try:
    from jax._src.interpreters import batching as _jax_batching
except ImportError:           # no jax installed: nothing to patch
    _jax_batching = None

if _jax_batching is not None and hasattr(_jax_batching,
                                         "PrimitiveBatchersProxy"):
    _jax_batching.PrimitiveBatchersProxy.__contains__ = \
        lambda self, p: False


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (CUDA kernels of repro_torch); skipped "
        "with a reason where torch.cuda.is_available() is false")
