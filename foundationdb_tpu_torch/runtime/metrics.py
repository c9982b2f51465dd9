"""The per-process metrics plane — the cluster flight recorder's source side.

Reference: REF:fdbrpc/Stats.h — every role owns CounterCollections whose
``traceCounters`` actor emits one ``*Metrics`` TraceEvent per interval,
and REF:fdbserver/Status.actor.cpp aggregates the latest emission into
``status json``.  Before this module the port wired that loop into only
two roles (commit proxy, storage) as private ``asyncio.sleep`` loops;
everything else was visible only at the instant someone pulled
``cluster_status``, and the version frontiers the ratekeeper reads every
interval were never recorded anywhere.

Here every role registers ONE :class:`MetricsSource` — its existing
``CounterCollection``/``Histogram``/``RateMeter`` instruments plus cheap
gauge callbacks (version frontiers, queue depths, MVCC window occupancy,
lsm compaction debt, device-pipeline depth, SlowTask stalls) — into the
hosting process's :class:`MetricsRegistry`, and ONE emitter actor per
worker drains the whole registry every ``METRICS_INTERVAL``.  The
emitter sleeps on the event loop's clock, so under ``SimEventLoop`` the
cadence is virtual time and same-seed traces stay bit-identical; the
emission order is registration order (recruitment order — itself
deterministic under the sim), never set/dict iteration over ids.

The trace file becomes a flight recorder: ``tools/metrics_tool.py``
reconstructs any role's gauge as a time-series from the rolled JSONL
alone (``lag`` rebuilds the per-tag durability-lag series, ``recovery``
the version-cut audit), so an incident can be replayed after the fact
instead of reproduced under a live status poll.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Optional

from .trace import CounterCollection, Histogram, TraceEvent, TraceLog, get_trace_log


class MetricsSource:
    """One role's registered instruments, emitted as one ``<Name>Metrics``
    event per interval (counters with rates + meter rates + gauge values
    as details) plus each histogram's own ``Histogram*`` event.

    Gauges are zero-argument callables sampled AT EMIT TIME — they must
    be cheap (attribute reads) and may return any JSON-serializable
    scalar.  A gauge that raises is skipped for that emission (a dying
    subsystem must not take the whole metrics plane down with it)."""

    __slots__ = ("name", "id", "counters", "histograms", "meters", "_gauges")

    def __init__(self, name: str, id_: str = "",
                 counters: CounterCollection | None = None) -> None:
        self.name = name
        # adopt the role's existing collection (its counters keep being
        # bumped by the hot path) or create an empty one for gauge-only
        # sources; an adopted collection's id (e.g. the storage tag) is
        # authoritative for the source too, so registry snapshot keys
        # and trace-event IDs always agree
        self.counters = counters if counters is not None \
            else CounterCollection(name, str(id_))
        self.id = str(id_) or self.counters.id
        self.histograms: list[Histogram] = []
        self.meters: list = []                 # RateMeter ducks
        self._gauges: dict[str, Callable[[], Any]] = {}

    def gauge(self, name: str, fn: Callable[[], Any]) -> "MetricsSource":
        self._gauges[name] = fn
        return self

    def histogram(self, h: Histogram) -> "MetricsSource":
        self.histograms.append(h)
        return self

    def meter(self, m) -> "MetricsSource":
        self.meters.append(m)
        return self

    def gauge_values(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for name, fn in self._gauges.items():
            try:
                out[name] = fn()
            except Exception:  # noqa: BLE001 — skip, never take the plane down
                continue
        return out

    def _meter_fields(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for m in self.meters:
            s = m.snapshot()
            base = _camel(m.name)
            out[f"{base}Count"] = s["count"]
            out[f"{base}PerSec"] = s["per_sec"]
            out[f"{base}MeanBatch"] = s["mean_batch"]
        return out

    def snapshot(self) -> dict[str, Any]:
        """Point-in-time view (status/lag rollups, tests): counter values
        + gauges + meter rates, with no trace emission (meters may
        rotate their trailing-window marks — the multi-poller-safe
        behavior they already have)."""
        out = {n: c.value for n, c in self.counters.counters.items()}
        out.update(self._meter_fields())
        out.update(self.gauge_values())
        return out

    def emit(self, log: TraceLog | None = None) -> None:
        lg = log or get_trace_log()
        extra = self._meter_fields()
        extra.update(self.gauge_values())
        self.counters.log_metrics(lg, extra=extra)
        for h in self.histograms:
            # the source's id rides each histogram event too, so a
            # multi-instance role's latency series stay distinct
            h.log_metrics(lg, id_=self.id)


def _camel(name: str) -> str:
    return "".join(p.title() for p in name.split("_"))


class MetricsRegistry:
    """Per-process (per-worker) registry of MetricsSources + the ONE
    emitter actor that drains them.

    Registration order is emission order — recruitment order, which a
    seeded sim replays exactly — so same-seed trace streams stay
    bit-identical with the plane on."""

    def __init__(self) -> None:
        self._sources: list[MetricsSource] = []
        self._task: asyncio.Task | None = None
        self.emissions = 0          # emitter passes completed

    # --- registration ---

    def register(self, source: MetricsSource,
                 default_id: str | None = None) -> MetricsSource:
        if default_id is not None and not source.id:
            source.id = str(default_id)
            if not source.counters.id:
                source.counters.id = str(default_id)
        if source not in self._sources:
            self._sources.append(source)
        return source

    def unregister(self, source: MetricsSource | None) -> None:
        if source is not None and source in self._sources:
            self._sources.remove(source)

    def add_role(self, obj: Any, default_id: str | None = None
                 ) -> MetricsSource | None:
        """Register a role object's source, duck-typed on
        ``metrics_source()`` (roles without one are silently skipped —
        the worker hosts whatever it is asked to)."""
        fn = getattr(obj, "metrics_source", None)
        if fn is None:
            return None
        return self.register(fn(), default_id=default_id)

    def sources(self) -> list[MetricsSource]:
        return list(self._sources)

    def snapshot(self) -> dict[str, dict]:
        """{``Name/id``: values} across every registered source."""
        out: dict[str, dict] = {}
        for s in self._sources:
            out[f"{s.name}/{s.id}"] = s.snapshot()
        return out

    # --- emission ---

    def emit_all(self, log: TraceLog | None = None) -> None:
        for s in list(self._sources):
            s.emit(log)
        self.emissions += 1

    def start_emitter(self, interval: float) -> None:
        """Start the one per-process emitter actor (idempotent).  Must be
        called with a running event loop; the sleep rides the loop clock,
        so sim runs emit on the virtual-time cadence."""
        if self._task is not None and not self._task.done():
            return
        self._task = asyncio.get_running_loop().create_task(
            self._emit_loop(interval), name="metrics-emitter")

    async def _emit_loop(self, interval: float) -> None:
        while True:
            await asyncio.sleep(interval)
            try:
                self.emit_all()
            except Exception as e:  # noqa: BLE001 — a broken source must
                # not kill the plane for every other role on this worker
                TraceEvent("MetricsEmitError", severity=30) \
                    .detail("Error", repr(e)[:200]).log()

    async def stop_emitter(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
