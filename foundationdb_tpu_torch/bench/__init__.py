"""Benchmark workload components (the mako reimplementation).

Reference: REF:bindings/c/test/mako/mako.c — keyed workload generator with
zipfian hot keys, fixed-width keys and r/w mixes.  chip_smoke.py at the
repo root drives the resolver with it.
"""

from .workload import ZipfianGenerator, MakoWorkload

__all__ = ["ZipfianGenerator", "MakoWorkload"]
