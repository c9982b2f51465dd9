"""Shared bench statistics helpers.

One home for the None-on-empty percentile policy (percentiles from zero
samples must be null + a sample count, never 0.0), so every benchmark
reports latency identically.
"""

from __future__ import annotations

import numpy as np


def latency_ms(latencies: list[float], pcts: tuple[float, ...]) -> dict:
    """{"p<P>_ms": value-or-None for each P} + {"n_samples": N}.
    Latencies are seconds; outputs are milliseconds."""
    out: dict = {"n_samples": len(latencies)}
    if latencies:
        arr = np.array(latencies)
        for p in pcts:
            out[f"p{p:g}_ms"] = float(np.percentile(arr, p) * 1e3)
    else:
        for p in pcts:
            out[f"p{p:g}_ms"] = None
    return out


# the stderr line on which a bench process reports its hand-kernel
# launches: a parent that runs it as a subprocess (bench/north_star.py)
# adds them to its own
LAUNCHES = "[bench] launches "


def print_launches() -> None:
    """This process's hand-kernel launches, one ``LAUNCHES`` line on
    stderr."""
    import json
    import sys

    from ..ops import kernels
    print(LAUNCHES + json.dumps(kernels.launch_counts()), file=sys.stderr,
          flush=True)
