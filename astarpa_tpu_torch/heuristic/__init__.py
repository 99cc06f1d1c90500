"""The port's own copy of ``astarpa_tpu/heuristic/`` (framework-free: it
imports only :mod:`..types` and :mod:`..utils.split_vec`), kept identical
in behaviour so the block aligner (:mod:`..aligners.astarpa2`) imports
nothing of the JAX package."""
