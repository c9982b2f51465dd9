"""Invalidating read-through cache — the millions-of-users read tier.

Entries are **versioned**: ``key -> (value, fill_version)`` where the
fill version is the read version the value was fetched at.  The feed
sink evicts an entry the moment any committed mutation touching its key
is delivered, so a surviving entry is valid through the consumer's
freshness frontier — the entry's effective version is
``max(fill_version, frontier)``, which is exactly what ``get(key,
at_least=V)`` checks: a hit is served only when the entry is provably
fresh at or above the caller's read-version floor, otherwise the cache
reads through and refills.

The fill path closes the obvious race: a mutation delivered BETWEEN the
read-through's snapshot and its store (the asyncio interleave) marks
the in-flight fill, and a fill whose read version is below the marking
mutation's version is discarded instead of cached — the feed's eviction
already ran and must not be undone by a stale store.

Capacity is a plain LRU (``LAYER_CACHE_CAPACITY``); hit/miss/
invalidation counts feed the metrics plane and the zipf hit-rate floor
the perf-smoke stage asserts.
"""

from __future__ import annotations

import collections

from ..core.data import MutationType, Version

__all__ = ["ReadThroughCache"]


class ReadThroughCache:
    def __init__(self, db, consumer, capacity: int | None = None,
                 name: str = "cache") -> None:
        self.db = db
        self.consumer = consumer
        self.name = name
        knobs = db.cluster.knobs
        self.capacity = capacity if capacity is not None \
            else knobs.LAYER_CACHE_CAPACITY
        self._entries: collections.OrderedDict[bytes, tuple] = \
            collections.OrderedDict()           # key -> (value, fill_version)
        self._filling: dict[bytes, Version] = {}  # key -> invalidation ver
        self._fill_refs: dict[bytes, int] = {}    # concurrent fills in flight
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0
        self.discarded_fills = 0
        self._msource = None
        consumer.add_sink(self)

    # --- read surface ---

    def effective_version(self, key: bytes) -> Version | None:
        """The version a cached entry is provably valid through, or
        None when the key is not cached."""
        e = self._entries.get(key)
        if e is None:
            return None
        return max(e[1], self.consumer.frontier)

    async def get(self, key: bytes, at_least: Version | None = None
                  ) -> bytes | None:
        """The value of ``key``, served from cache when the entry is
        fresh at or above ``at_least`` (default: any cached entry —
        still never stale beyond the feed frontier)."""
        return (await self.get_versioned(key, at_least))[0]

    async def get_versioned(self, key: bytes,
                            at_least: Version | None = None
                            ) -> tuple[bytes | None, Version]:
        """``(value, valid_through)``: the value plus the version it is
        provably valid at — a hit's ``max(fill_version, frontier)``, a
        read-through's fill version.  The staleness proof the workloads
        and the bench stage assert rides this pair."""
        e = self._entries.get(key)
        if e is not None:
            valid_through = max(e[1], self.consumer.frontier)
            if at_least is None or valid_through >= at_least:
                self.hits += 1
                self._entries.move_to_end(key)
                return e[0], valid_through
        self.misses += 1
        # read through, guarding against an invalidation delivered
        # while the fetch is in flight; the marker is refcounted so
        # concurrent fills of the same key each see it
        self._fill_refs[key] = self._fill_refs.get(key, 0) + 1
        self._filling.setdefault(key, 0)
        try:
            tr = self.db.create_transaction()
            try:
                fill_version = await tr.get_read_version()
                value = await tr.get(key, snapshot=True)
            finally:
                tr.reset()
            invalidated_at = self._filling.get(key, 0)
        finally:
            self._fill_refs[key] -= 1
            if self._fill_refs[key] <= 0:
                del self._fill_refs[key]
                self._filling.pop(key, None)
        if invalidated_at > fill_version:
            self.discarded_fills += 1
            return value, fill_version
        self._entries[key] = (value, fill_version)
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return value, fill_version

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot_entries(self) -> list[tuple[bytes, bytes | None, Version]]:
        """(key, value, fill_version) triples — the checker's view;
        taken synchronously so it is atomic w.r.t. the feed sink."""
        return [(k, v, ver) for k, (v, ver) in self._entries.items()]

    # --- feed sink ---

    def _invalidate(self, key: bytes, version: Version) -> None:
        if key in self._entries:
            e = self._entries[key]
            if version > e[1]:
                del self._entries[key]
                self.invalidations += 1
        if key in self._filling:
            self._filling[key] = max(self._filling[key], version)

    def on_mutations(self, version: Version, batch) -> None:
        for m in batch:
            t = int(m.type)
            if t == MutationType.CLEAR_RANGE:
                b, e = m.param1, m.param2
                for k in [k for k in self._entries if b <= k < e]:
                    self._invalidate(k, version)
                for k in [k for k in self._filling if b <= k < e]:
                    self._filling[k] = max(self._filling[k], version)
            else:
                self._invalidate(m.param1, version)

    # --- metrics / status surface ---

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def metrics_source(self):
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("LayerCache", self.name)
            s.gauge("Entries", lambda: len(self._entries))
            s.gauge("Hits", lambda: self.hits)
            s.gauge("Misses", lambda: self.misses)
            s.gauge("Invalidations", lambda: self.invalidations)
            s.gauge("Evictions", lambda: self.evictions)
            s.gauge("HitRate", lambda: round(self.hit_rate, 4))
            self._msource = s
        return self._msource

    def stats(self) -> dict:
        return {"kind": "cache", "entries": len(self._entries),
                "capacity": self.capacity, "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "discarded_fills": self.discarded_fills,
                "hit_rate": round(self.hit_rate, 4)}
