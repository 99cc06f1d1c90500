"""Experimental prototypes (re-design of the `astarpa-next` crate, L9).

The port's own copy of ``astarpa_tpu/experimental/``."""

from .compressed_history import CompressedHistory, dt_align_compressed
from .path_pruning import PathHeuristic

__all__ = ["CompressedHistory", "PathHeuristic", "dt_align_compressed"]
