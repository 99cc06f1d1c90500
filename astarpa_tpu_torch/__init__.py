"""astarpa_tpu_torch — the batch aligner of ``astarpa_tpu`` ported to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The JAX package ``astarpa_tpu`` is the reference this port is held
against.  The port reuses, by import, the parts of it that have no
framework dependency (``types``, ``generate``, ``oracle``, ``native``,
``domain`` and ``ops.bitpack``) and never loads JAX.

Public API:

- :class:`BatchAligner` — exact costs (``cost``, ``cost_iter``) and CIGARs
  (``align``, ``align_iter``) for many pairs on one device,
  ``BatchAligner(device="cuda")``.
- ``generate``, ``oracle``, ``native``, ``domain`` — the shared
  framework-free modules (pair generation, the edit-distance oracle, the
  native C++ runtime, domain hulls to per-pair schedules).
"""

__all__ = ["BatchAligner", "BatchStats", "generate", "oracle", "native", "domain"]


def __getattr__(name):
    # Lazy, as in astarpa_tpu: importing the package loads no torch code.
    if name in ("BatchAligner", "BatchStats"):
        from .parallel import runner

        return getattr(runner, name)
    if name in ("generate", "oracle", "native", "domain"):
        import importlib

        return importlib.import_module(f"astarpa_tpu.{name}")
    raise AttributeError(name)
