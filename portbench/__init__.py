"""The benchmark of zest_tpu_torch: see ``portbench/run.py``."""
