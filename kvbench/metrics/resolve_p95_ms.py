"""The 95th percentile over every batch of the measured window of the
time from its group's hand-off to the entry until its verdicts are back
on the host (host clock)."""

from .. import stats


def read(run):
    return stats.latency_ms(list(run.latencies_s()), (95,))["p95_ms"]
