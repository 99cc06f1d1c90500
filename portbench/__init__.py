"""The benchmark of ``astarpa_tpu_torch``: run ``python portbench/run.py``."""
