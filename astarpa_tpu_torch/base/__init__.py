"""Reference-grade aligners over general cost models (re-design of the
`pa-base-algos` crate): band-doubling affine NW and diagonal-transition
(WFA/BiWFA).

The port's own copy of ``astarpa_tpu/base/`` (pure Python and numpy on the
host, the code kept identical).  Not on the batch path, which runs the
CUDA kernels; used for cost-model generality and differential testing."""

from .dt import DiagonalTransition
from .nw_affine import NwAffine

__all__ = ["NwAffine", "DiagonalTransition"]
