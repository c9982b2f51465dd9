"""Commit-path latency instrumentation: per-stage stats + sampled per-txn
TraceBatch probes.

Reference: the reference attributes per-transaction stage latency with
``TraceBatch`` events (REF:flow/Trace.h TraceBatch; SURVEY §5.1 "latency
probes via TraceBatch for sampled transactions") and aggregates role-side
stage timings into rolled metrics.  Two instruments here:

- ``StageStats`` — a per-role accumulator of (stage -> seconds) samples;
  roles on the commit path (GrvProxy, CommitProxy, Resolver) record each
  stage's duration, and harnesses (bench/e2e.py) read ``summary()`` to
  put a GRV-wait / batch-fill / version-wait / resolve / push breakdown
  in the bench artifact.
- ``TraceBatch`` — sampled per-transaction probes: roughly 1 in
  ``1/CLIENT_LATENCY_PROBE_SAMPLE`` transactions carries a probe; each
  stage appends a (name, t) pair and the flush emits ONE structured
  "TransactionTrace" TraceEvent with stage deltas in ms, so a single
  sampled txn's whole commit path can be read off one trace line.
"""

from __future__ import annotations

from typing import Optional

from .trace import TraceEvent


class StageStats:
    """Bounded per-stage duration accumulator (seconds in, ms out)."""

    __slots__ = ("name", "_samples", "_count", "_sum", "_max", "cap")

    def __init__(self, name: str, cap: int = 65536) -> None:
        self.name = name
        self.cap = cap
        self._samples: dict[str, list[float]] = {}
        self._count: dict[str, int] = {}
        self._sum: dict[str, float] = {}
        # running max, tracked OUTSIDE the bounded sample list: a stall
        # arriving after the cap fills must still move max_ms (the whole
        # point of the apply-path consumer)
        self._max: dict[str, float] = {}

    def record(self, stage: str, seconds: float) -> None:
        s = self._samples.setdefault(stage, [])
        n = self._count.get(stage, 0)
        self._count[stage] = n + 1
        self._sum[stage] = self._sum.get(stage, 0.0) + seconds
        # seed-or-raise, never strict-compare against a 0.0 default: a
        # virtual-time clock (SimEventLoop) measures synchronous work as
        # EXACTLY 0.0 seconds, and `0.0 > 0.0` left the stage out of
        # _max while _samples had it — summary() then KeyErrored
        m = self._max.get(stage)
        if m is None or seconds > m:
            self._max[stage] = seconds
        # ring overwrite, not first-N: percentiles must track the
        # TRAILING cap samples on a long-lived role, or a regression
        # arriving after the reservoir fills never moves p50/p99
        if len(s) < self.cap:
            s.append(seconds)
        else:
            s[n % self.cap] = seconds

    def reset(self) -> None:
        self._samples.clear()
        self._count.clear()
        self._sum.clear()
        self._max.clear()

    def summary(self) -> dict[str, dict[str, float]]:
        """{stage: {n, mean_ms, p50_ms, p99_ms, max_ms}} — percentiles
        over the (bounded) retained samples, mean over everything
        recorded.  ``max_ms`` names the worst single sample — the
        apply-path consumer wants the longest event-loop occupancy, not
        just the p99 (one 900ms index merge IS the r5 incident)."""
        out: dict[str, dict[str, float]] = {}
        for stage, s in self._samples.items():
            if not s:
                continue
            xs = sorted(s)
            n = self._count[stage]
            out[stage] = {
                "n": n,
                "mean_ms": round(self._sum[stage] / n * 1e3, 3),
                "p50_ms": round(xs[len(xs) // 2] * 1e3, 3),
                "p99_ms": round(xs[min(len(xs) - 1,
                                       int(len(xs) * 0.99))] * 1e3, 3),
                "max_ms": round(self._max[stage] * 1e3, 3),
            }
        return out


def merge_summaries(summaries: list[dict]) -> dict[str, dict[str, float]]:
    """Weighted-mean merge of several roles' summaries (percentiles take
    the max across roles — conservative for a breakdown artifact)."""
    out: dict[str, dict[str, float]] = {}
    for s in summaries:
        for stage, row in s.items():
            cur = out.get(stage)
            if cur is None:
                out[stage] = dict(row)
                continue
            n = cur["n"] + row["n"]
            cur["mean_ms"] = round((cur["mean_ms"] * cur["n"]
                                    + row["mean_ms"] * row["n"]) / n, 3)
            cur["p50_ms"] = max(cur["p50_ms"], row["p50_ms"])
            cur["p99_ms"] = max(cur["p99_ms"], row["p99_ms"])
            if "max_ms" in cur or "max_ms" in row:
                cur["max_ms"] = max(cur.get("max_ms", 0.0),
                                    row.get("max_ms", 0.0))
            cur["n"] = n
    return out


# process-wide probe-eviction rollup: per-instance
# ``evictions`` counts die with their owning client object, so probe
# loss under load was silent — role metrics() and the worker gauges
# read THIS.  Reset with span.reset_totals() (same determinism contract:
# a harness re-running a seeded sim in one process restarts the count).
EVICTIONS_TOTAL = {"probe_evictions": 0}


class TraceBatch:
    """Sampled per-transaction stage probes (one trace line per sampled
    txn).  ``attach()`` rolls the sampling dice; probes on unsampled ids
    are no-ops, so the fast path costs one dict lookup."""

    def __init__(self, sample_rate: float = 0.01, clock=None,
                 live_cap: int = 4096) -> None:
        # deterministic counter-based sampling (no RNG: the probe must
        # not perturb seeded simulation streams)
        self._every = max(1, int(round(1.0 / sample_rate))) \
            if sample_rate > 0 else 0
        self._n = 0
        self._live: dict[int, list[tuple[str, float]]] = {}
        self._clock = clock
        # bound the live table: a sampled txn abandoned without
        # flush/discard (client crash mid-retry, dropped task) would
        # otherwise leak its probe record forever.  Insertion order IS
        # age (dict semantics), so eviction drops the oldest probe.
        self._live_cap = max(1, live_cap)
        self.evictions = 0

    def _now(self) -> float:
        if self._clock is not None:
            return self._clock()
        import asyncio
        return asyncio.get_running_loop().time()

    def attach(self, txn_id: int) -> bool:
        """Maybe start a probe for this transaction; True if sampled."""
        if not self._every:
            return False
        self._n += 1
        if self._n % self._every:
            return False
        self._live[txn_id] = [("start", self._now())]
        if len(self._live) > self._live_cap:
            oldest = next(iter(self._live))
            del self._live[oldest]
            self.evictions += 1
            EVICTIONS_TOTAL["probe_evictions"] += 1
        return True

    def event(self, txn_id: int, name: str) -> None:
        rec = self._live.get(txn_id)
        if rec is not None:
            rec.append((name, self._now()))

    def discard(self, txn_id: int) -> None:
        self._live.pop(txn_id, None)

    def flush(self, txn_id: int, outcome: str = "committed") -> Optional[dict]:
        """Emit the sampled txn's stage deltas as one TransactionTrace
        event; returns the {stage: ms} dict (None if not sampled)."""
        rec = self._live.pop(txn_id, None)
        if rec is None:
            return None
        ev = TraceEvent("TransactionTrace")
        ev.detail("Txn", txn_id).detail("Outcome", outcome)
        deltas: dict[str, float] = {}
        for (prev_name, prev_t), (name, t) in zip(rec, rec[1:]):
            ms = round((t - prev_t) * 1e3, 3)
            deltas[name] = ms
            ev.detail(name.title().replace("_", "") + "Ms", ms)
        total = round((rec[-1][1] - rec[0][1]) * 1e3, 3)
        deltas["total"] = total
        ev.detail("TotalMs", total).log()
        return deltas
