"""kvbench: the benchmark of ``foundationdb_tpu_torch``'s conflict
resolver on one CUDA card.  ``python -m kvbench --help``."""
