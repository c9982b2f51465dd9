"""Percentiles, as the port's ``bench/stats.py`` takes them: from zero
samples a percentile is null beside its sample count, never 0."""

from __future__ import annotations

import numpy as np


def latency_ms(latencies: list[float], pcts: tuple[float, ...]) -> dict:
    """{"p<P>_ms": value or None for each P} and {"n_samples": N};
    latencies in seconds, values in milliseconds."""
    out: dict = {"n_samples": len(latencies)}
    arr = np.array(latencies)
    for p in pcts:
        out[f"p{p:g}_ms"] = float(np.percentile(arr, p) * 1e3) \
            if latencies else None
    return out
