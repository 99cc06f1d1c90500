"""astarpa_tpu_torch — the batch aligner of ``astarpa_tpu`` ported to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The JAX package ``astarpa_tpu`` is the reference this port is held
against, by the tests only: the port imports torch, never jax, and nothing
of ``astarpa_tpu``.  It keeps its own copies of the framework-free modules
it needs (``types``, ``generate``/``chacha``, ``oracle``, ``domain``,
``params``, ``pairs_io``, ``astar/``, ``heuristic/``, ``ops.bitpack``,
``search``, ``affine/``, ``base/``, ``experimental/``, ``vis/``,
``testing``, ``utils/`` and the ``native`` loader, which builds the C++
sources in the repository's ``native/``).

Public API:

- :class:`BatchAligner` — exact costs (``cost``, ``cost_iter``) and CIGARs
  (``align``, ``align_iter``) for many pairs on one device, or split over
  several (``mesh=``).  It runs on the card and raises without one;
  ``BatchAligner(device="cpu")`` runs the kernels' plain torch versions
  instead.  ``parallel.multihost.MultiHostRunner`` streams a stripe of the
  input a process over ``torch.distributed``.
- :func:`astarpa2_nw`, :func:`astarpa2_simple`, :func:`astarpa2_full` —
  single-pair block aligners returning ``(cost, Cigar)``; :func:`astarpa`,
  :func:`astarpa_gcsh` — the A* search on the host.
- ``ops.nw_kernel.nw_cost_pairs`` and ``aligners.nw.nw_cost_batch`` —
  full-rectangle NW edit distances (cost only, kernel K11), with the same
  device rule.
- ``generate``, ``oracle``, ``native``, ``domain`` — pair generation, the
  edit-distance oracle, the native C++ runtime, domain hulls to per-pair
  schedules; ``params``, ``pairs_io``, ``cli`` and ``fuzz`` as the JAX
  package's.
- Host utilities copied from the JAX package: the semi-global pattern
  search (``from astarpa_tpu_torch.search import search``, not a lazy
  export, as in the reference); ``affine`` cost models and CIGARs and the
  ``base`` aligners over them (``DiagonalTransition``, ``NwAffine``);
  ``experimental`` (``dt_align_compressed``, ``PathHeuristic``, whose path
  comes from the block aligner on its ``device``); the visualizer ``vis``
  that ``AstarPa(v=...)`` and the block aligner call, and the figure suite
  ``python -m astarpa_tpu_torch.figures``; the ``pa-test`` harness
  ``testing``; ``utils.timer``; and ``ops.layouts``, the five scalar
  traversal orders of the word grid on int32-view tensors.
"""

from .generate import ErrorModel, generate_model, uniform_fixed
from .types import Cigar, CigarElem, CigarOp, Pos

__all__ = ["BatchAligner", "BatchStats", "Cigar", "CigarElem", "CigarOp", "Pos",
           "ErrorModel", "generate_model", "uniform_fixed", "astarpa", "astarpa_gcsh",
           "astarpa2_nw", "astarpa2_simple", "astarpa2_full", "generate", "oracle",
           "native", "domain"]

_API = ("astarpa2_nw", "astarpa2_simple", "astarpa2_full", "astarpa", "astarpa_gcsh")


def __getattr__(name):
    # Lazy: importing the package loads no torch code.
    if name in ("BatchAligner", "BatchStats"):
        from .parallel import runner

        return getattr(runner, name)
    if name in _API:
        from . import api

        return getattr(api, name)
    if name == "AstarPa":
        from .astar import AstarPa

        return AstarPa
    if name in ("generate", "oracle", "native", "domain"):
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
