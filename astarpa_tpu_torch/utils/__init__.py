"""The port's own copy of ``astarpa_tpu/utils/split_vec.py``, which the
heuristic copies (:mod:`..heuristic.sh`) import."""
