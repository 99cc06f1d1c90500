"""astarpa_tpu_torch — the batch aligner of ``astarpa_tpu`` ported to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The JAX package ``astarpa_tpu`` is the reference this port is held
against, by the tests only: the port imports torch, never jax, and nothing
of ``astarpa_tpu``.  It keeps its own copies of the framework-free modules
it needs (``types``, ``generate``/``chacha``, ``oracle``, ``domain``,
``ops.bitpack`` and the ``native`` loader, which builds the C++ sources in
the repository's ``native/``).

Public API:

- :class:`BatchAligner` — exact costs (``cost``, ``cost_iter``) and CIGARs
  (``align``, ``align_iter``) for many pairs on one device.  It runs on the
  card and raises without one; ``BatchAligner(device="cpu")`` runs the
  kernels' plain torch versions instead.
- ``ops.nw_kernel.nw_cost_pairs`` and ``aligners.nw.nw_cost_batch`` —
  full-rectangle NW edit distances (cost only, kernel K11), with the same
  device rule.
- ``generate``, ``oracle``, ``native``, ``domain`` — pair generation, the
  edit-distance oracle, the native C++ runtime, domain hulls to per-pair
  schedules.
"""

__all__ = ["BatchAligner", "BatchStats", "generate", "oracle", "native", "domain"]


def __getattr__(name):
    # Lazy: importing the package loads no torch code.
    if name in ("BatchAligner", "BatchStats"):
        from .parallel import runner

        return getattr(runner, name)
    if name in ("generate", "oracle", "native", "domain"):
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
