"""``watch(key)`` on change feeds — upstream's watches (SURVEY §2.3),
rebuilt as a layer.

The core already has a storage-side watch (``Transaction.watch`` →
``ss.watch_value``); this surface is its feed-riding sibling: a watch
registers at a read version, and fires on the FIRST committed mutation
touching its key at or after that version — delivered by the shared
:class:`~..layers.feed_consumer.LayerFeedConsumer`, whose cursor
re-routes across shard moves, failovers and recoveries by construction.
Fire semantics are **at-least-once**: a reconnect replays the
undelivered span exactly-once, so a fire is never lost, and the
registry is allowed to fire spuriously (e.g. when its bounded mutation
memory cannot prove a quiet history) but never to miss.

Immediate fire: registration consults the registry's per-key
last-mutation memory (and the recorded ``clear_range`` spans) — a watch
registered at a version at or below an already-delivered mutation fires
on the spot, without waiting for new feed traffic.  Both memories are
bounded: pruning raises a conservative floor below which registration
fires immediately rather than guessing (spurious, never missed).
"""

from __future__ import annotations

import asyncio

from ..core.data import MutationType, Version
from ..runtime.errors import ClientInvalidOperation

__all__ = ["WatchRegistry", "Watch"]

# bounded mutation memory: prune the per-key map beyond this many
# entries (oldest versions first), raising the conservative floor
_MUTATION_MEMORY = 65536


class Watch:
    """One pending watch: resolved with the firing version."""

    __slots__ = ("key", "version", "baseline", "baseline_version",
                 "future", "registered_at")

    def __init__(self, key: bytes, version: Version,
                 baseline: bytes | None, baseline_version: Version,
                 future: asyncio.Future, registered_at: float) -> None:
        self.key = key
        self.version = version            # fire on mutations >= this
        self.baseline = baseline          # value at baseline_version
        self.baseline_version = baseline_version
        self.future = future
        self.registered_at = registered_at


class WatchRegistry:
    def __init__(self, db, consumer, name: str = "watches",
                 limit: int | None = None) -> None:
        self.db = db
        self.consumer = consumer
        self.name = name
        knobs = db.cluster.knobs
        self.limit = limit if limit is not None else knobs.LAYER_WATCH_LIMIT
        self._pending: dict[bytes, list[Watch]] = {}
        self._pending_count = 0
        # per-key last delivered mutation version + recorded range
        # clears, both with a conservative pruning floor
        self._last_mutation: dict[bytes, Version] = {}
        self._range_clears: list[tuple[bytes, bytes, Version]] = []
        self._memory_floor: Version = 0
        self.registered = 0
        self.fired = 0
        self.immediate_fires = 0
        self.fire_latency_total = 0.0
        self.fire_latency_max = 0.0
        self._msource = None
        consumer.add_sink(self)

    # --- registration ---

    async def watch(self, key: bytes, version: Version | None = None
                    ) -> asyncio.Future:
        """Register a watch on ``key``; the returned future resolves
        with the version of the first mutation at or after the watch
        version (default: a fresh read version).  The baseline value is
        read at the same version for the checker's missed-fire audit."""
        if self._pending_count >= self.limit:
            raise ClientInvalidOperation(
                f"watch registry {self.name!r} at its limit ({self.limit})")
        loop = asyncio.get_running_loop()
        tr = self.db.create_transaction()
        try:
            if version is not None:
                tr.set_read_version(version)
            baseline_version = await tr.get_read_version()
            baseline = await tr.get(key, snapshot=True)
        finally:
            tr.reset()
        watch_version = version if version is not None else baseline_version
        fut: asyncio.Future = loop.create_future()
        self.registered += 1
        fired_at = self._already_fired(key, watch_version)
        if fired_at:
            self.immediate_fires += 1
            self.fired += 1
            fut.set_result(fired_at)
            return fut
        w = Watch(key, watch_version, baseline, baseline_version, fut,
                  loop.time())
        self._pending.setdefault(key, []).append(w)
        self._pending_count += 1
        return fut

    def _already_fired(self, key: bytes, watch_version: Version
                       ) -> Version:
        """The version of an already-delivered mutation at or after
        ``watch_version``, or 0.  Below the pruning floor the history is
        unknowable — fire spuriously (at-least-once allows it; missing
        would not be allowed)."""
        if watch_version <= self._memory_floor:
            return max(self._memory_floor, 1)
        last = self._last_mutation.get(key, 0)
        if last >= watch_version:
            return last
        for b, e, v in self._range_clears:
            if b <= key < e and v >= watch_version:
                return v
        return 0

    def pending_watches(self) -> list[Watch]:
        """Flat snapshot of unfired watches — the checker's view; taken
        synchronously so it is atomic w.r.t. the feed sink."""
        return [w for ws in self._pending.values() for w in ws]

    @property
    def pending_count(self) -> int:
        return self._pending_count

    # --- feed sink ---

    def _fire(self, key: bytes, version: Version) -> None:
        ws = self._pending.get(key)
        if not ws:
            return
        keep: list[Watch] = []
        loop = asyncio.get_running_loop()
        for w in ws:
            if version >= w.version:
                if not w.future.done():
                    w.future.set_result(version)
                lat = loop.time() - w.registered_at
                self.fired += 1
                self.fire_latency_total += lat
                self.fire_latency_max = max(self.fire_latency_max, lat)
                self._pending_count -= 1
            else:
                keep.append(w)
        if keep:
            self._pending[key] = keep
        else:
            del self._pending[key]

    def on_mutations(self, version: Version, batch) -> None:
        for m in batch:
            t = int(m.type)
            if t == MutationType.CLEAR_RANGE:
                b, e = m.param1, m.param2
                self._range_clears.append((b, e, version))
                for k in [k for k in self._pending if b <= k < e]:
                    self._fire(k, version)
            else:
                self._last_mutation[m.param1] = version
                self._fire(m.param1, version)
        self._prune()

    def _prune(self) -> None:
        if len(self._last_mutation) > _MUTATION_MEMORY:
            by_version = sorted(self._last_mutation.items(),
                                key=lambda kv: kv[1])
            drop = by_version[:len(by_version) - _MUTATION_MEMORY // 2]
            for k, v in drop:
                self._memory_floor = max(self._memory_floor, v)
                del self._last_mutation[k]
        if len(self._range_clears) > _MUTATION_MEMORY // 16:
            keep = len(self._range_clears) // 2
            for _b, _e, v in self._range_clears[:-keep]:
                self._memory_floor = max(self._memory_floor, v)
            self._range_clears = self._range_clears[-keep:]

    # --- metrics / status surface ---

    @property
    def fire_latency_mean(self) -> float:
        return self.fire_latency_total / self.fired if self.fired else 0.0

    def metrics_source(self):
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("LayerWatch", self.name)
            s.gauge("Pending", lambda: self._pending_count)
            s.gauge("Registered", lambda: self.registered)
            s.gauge("Fired", lambda: self.fired)
            s.gauge("ImmediateFires", lambda: self.immediate_fires)
            s.gauge("FireLatencyMeanMs",
                    lambda: round(self.fire_latency_mean * 1000, 3))
            s.gauge("FireLatencyMaxMs",
                    lambda: round(self.fire_latency_max * 1000, 3))
            self._msource = s
        return self._msource

    def stats(self) -> dict:
        return {"kind": "watches", "pending": self._pending_count,
                "registered": self.registered, "fired": self.fired,
                "immediate_fires": self.immediate_fires,
                "fire_latency_mean_ms":
                    round(self.fire_latency_mean * 1000, 3),
                "fire_latency_max_ms":
                    round(self.fire_latency_max * 1000, 3)}
