"""The benchmark of treensearch_tpu_torch on one NVIDIA H100: captured
SPH step loops, run one cell at a time by ``nsbench/run.py``."""
