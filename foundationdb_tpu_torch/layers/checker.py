"""Layer consistency checker — the scrubber discipline applied to
derived state.

The scrubber (core/scrubber.py) audits REPLICAS of authoritative state;
this checker audits DERIVATIONS of it: index rows, cache entries and
pending watches, cross-verified against the primary keyspace read
through the ordinary transactional path.  Same rules of engagement:

- **pin a version** before comparing anything, and read both sides of
  every comparison at pinned versions so concurrent commits can never
  manufacture a diff;
- **page the authoritative keyspace** via packed range reads
  (``LAYER_CHECK_PAGE_ROWS`` rows per page);
- **name divergent keys exactly** — one severity-40 ``LayerMismatch``
  per divergent key, carrying the layer, the key, the pinned version
  and both sides' evidence;
- **refusals are never mismatches** — a checkpoint that moved mid-read,
  a frontier that will not catch up, a version fallen out of the MVCC
  window all count as refusals and end the sub-check without a verdict.

Per-layer invariant:

- transactional index: rows at pinned version V are BIT-IDENTICAL to a
  rebuild-from-scan of the primary range at V;
- async index: at a stable checkpoint (frontier F, flush commit C), the
  index subspace read at any version >= C equals the rebuild at F;
- cache: every entry with fill version <= pinned V, once the feed
  frontier passes V, byte-equals the authoritative value at V;
- watches: once the frontier passes pinned V, no watch registered at or
  below V may still be pending if the authoritative value at V differs
  from its registration baseline (one-sided: ABA flips are invisible to
  a value check and at-least-once semantics do not require catching
  them).
"""

from __future__ import annotations

import asyncio

from ..core.data import Version
from ..runtime.trace import TraceEvent

__all__ = ["LayerConsistencyChecker"]

# stable-checkpoint attempts before the async-index sub-check refuses
_MAX_CHECK_RETRIES = 8


class LayerConsistencyChecker:
    """One pass = one ``check()`` call; returns the verdict dict and
    emits key-exact ``LayerMismatch`` events for every divergence."""

    def __init__(self, db, index=None, cache=None, watches=None,
                 name: str = "layer-check", knobs=None) -> None:
        self.db = db
        self.index = index
        self.cache = cache
        self.watches = watches
        self.name = name
        self.knobs = knobs if knobs is not None else db.cluster.knobs
        self.passes = 0
        self.divergences = 0
        self.refusals = 0
        self.rows_checked = 0
        self._msource = None

    # --- evidence ---

    def _mismatch(self, layer: str, key: bytes, version: Version,
                  expected, actual) -> None:
        self.divergences += 1
        TraceEvent("LayerMismatch", severity=40) \
            .detail("Layer", layer) \
            .detail("Key", key.hex()) \
            .detail("Version", version) \
            .detail("Expected", "<missing>" if expected is None
                    else bytes(expected)[:64].hex()) \
            .detail("Actual", "<missing>" if actual is None
                    else bytes(actual)[:64].hex()) \
            .log()

    def _refuse(self, layer: str, why: str) -> None:
        self.refusals += 1
        TraceEvent("LayerCheckRefused", severity=20) \
            .detail("Layer", layer).detail("Why", why).log()

    # --- paged pinned reads ---

    async def _page_range(self, begin: bytes, end: bytes,
                          version: Version) -> list[tuple[bytes, bytes]]:
        """Every row of [begin, end) at pinned ``version`` (snapshot,
        paged).  Raises on refusal (too-old, moved) — callers convert
        to a refusal verdict."""
        page = self.knobs.LAYER_CHECK_PAGE_ROWS
        tr = self.db.create_transaction()
        out: list[tuple[bytes, bytes]] = []
        try:
            tr.set_read_version(version)
            cursor = begin
            while True:
                rows = await tr.get_range(cursor, end, limit=page,
                                          snapshot=True)
                out.extend(rows)
                self.rows_checked += len(rows)
                if len(rows) < page:
                    return out
                cursor = rows[-1][0] + b"\x00"
        finally:
            tr.reset()

    async def _pin(self) -> Version:
        tr = self.db.create_transaction()
        try:
            return await tr.get_read_version()
        finally:
            tr.reset()

    def _rebuild_rows(self, index, primary_rows) -> set:
        """The expected index row-key set for a primary snapshot."""
        expected: set = set()
        for k, v in primary_rows:
            for iv in index._extract(k, v):
                expected.add(index.row_key(iv, k))
        return expected

    # --- sub-checks ---

    async def _check_index(self) -> dict:
        index = self.index
        ib, ie = index.index.key(), index.index.range(())[1]
        if index.mode == "transactional":
            # one pinned version serves both sides: the hook keeps rows
            # atomic with the primary, so ANY version must agree
            version = await self._pin()
            try:
                primary = await self._page_range(index.primary_begin,
                                                 index.primary_end, version)
                actual = await self._page_range(ib, ie, version)
            except Exception as e:  # noqa: BLE001
                self._refuse("index", repr(e)[:200])
                return {"checked": 0, "divergences": 0, "refused": True}
            return self._diff_index(version, primary, actual)
        # async mode: compare at a STABLE checkpoint — unchanged across
        # the whole read, else the flush that moved it explains any diff
        for _ in range(_MAX_CHECK_RETRIES):
            ck = index.checkpoint()
            if ck is None:
                await asyncio.sleep(self.knobs.LAYER_FEED_POLL_INTERVAL)
                continue
            frontier, commit = ck
            version = await self._pin()     # >= commit by GRV contract
            try:
                actual = await self._page_range(ib, ie, version)
                primary = await self._page_range(index.primary_begin,
                                                 index.primary_end, frontier)
            except Exception as e:  # noqa: BLE001
                self._refuse("index", repr(e)[:200])
                return {"checked": 0, "divergences": 0, "refused": True}
            if index.checkpoint() != ck:
                continue                    # moved mid-read: no verdict
            return self._diff_index(frontier, primary, actual)
        self._refuse("index", "no stable checkpoint after %d attempts"
                     % _MAX_CHECK_RETRIES)
        return {"checked": 0, "divergences": 0, "refused": True}

    def _diff_index(self, version: Version, primary_rows,
                    actual_rows) -> dict:
        expected = self._rebuild_rows(self.index, primary_rows)
        actual = {k for k, _v in actual_rows}
        before = self.divergences
        for rk in sorted(expected - actual):
            self._mismatch("index", rk, version, b"", None)
        for rk in sorted(actual - expected):
            self._mismatch("index", rk, version, None, b"")
        return {"checked": len(expected | actual),
                "divergences": self.divergences - before, "refused": False}

    async def _check_cache(self) -> dict:
        cache = self.cache
        version = await self._pin()
        try:
            await cache.consumer.wait_frontier(version)
        except TimeoutError:
            self._refuse("cache", "frontier stalled below pin")
            return {"checked": 0, "divergences": 0, "refused": True}
        # snapshot AFTER the frontier passes the pin, synchronously:
        # every mutation at or below the pin has already run the sink
        entries = [(k, v, ver) for k, v, ver in cache.snapshot_entries()
                   if ver <= version]
        if not entries:
            return {"checked": 0, "divergences": 0, "refused": False}
        keys = [k for k, _v, _ver in entries]
        tr = self.db.create_transaction()
        try:
            tr.set_read_version(version)
            truth = await tr.get_multi(keys, snapshot=True)
        except Exception as e:  # noqa: BLE001
            self._refuse("cache", repr(e)[:200])
            return {"checked": 0, "divergences": 0, "refused": True}
        finally:
            tr.reset()
        before = self.divergences
        self.rows_checked += len(entries)
        for (k, v, _ver), auth in zip(entries, truth):
            if v != auth:
                self._mismatch("cache", k, version, auth, v)
        return {"checked": len(entries),
                "divergences": self.divergences - before, "refused": False}

    async def _check_watches(self) -> dict:
        watches = self.watches
        version = await self._pin()
        try:
            await watches.consumer.wait_frontier(version)
        except TimeoutError:
            self._refuse("watches", "frontier stalled below pin")
            return {"checked": 0, "divergences": 0, "refused": True}
        pending = [w for w in watches.pending_watches()
                   if w.baseline_version <= version]
        if not pending:
            return {"checked": 0, "divergences": 0, "refused": False}
        keys = [w.key for w in pending]
        tr = self.db.create_transaction()
        try:
            tr.set_read_version(version)
            truth = await tr.get_multi(keys, snapshot=True)
        except Exception as e:  # noqa: BLE001
            self._refuse("watches", repr(e)[:200])
            return {"checked": 0, "divergences": 0, "refused": True}
        finally:
            tr.reset()
        before = self.divergences
        self.rows_checked += len(pending)
        for w, auth in zip(pending, truth):
            if auth != w.baseline and not w.future.done():
                # the value changed at or below the pin, the change was
                # delivered (frontier >= pin), yet the watch never fired
                self._mismatch("watches", w.key, version, w.baseline, auth)
        return {"checked": len(pending),
                "divergences": self.divergences - before, "refused": False}

    # --- the pass ---

    async def check(self) -> dict:
        """One full pass over every attached layer."""
        out: dict = {"divergences_before": self.divergences}
        if self.index is not None:
            out["index"] = await self._check_index()
        if self.cache is not None:
            out["cache"] = await self._check_cache()
        if self.watches is not None:
            out["watches"] = await self._check_watches()
        self.passes += 1
        out["divergences"] = self.divergences - out.pop("divergences_before")
        out["refusals"] = self.refusals
        out["rows_checked"] = self.rows_checked
        out["passes"] = self.passes
        return out

    # --- metrics / status surface ---

    def metrics_source(self):
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("LayerCheck", self.name)
            s.gauge("Passes", lambda: self.passes)
            s.gauge("Divergences", lambda: self.divergences)
            s.gauge("Refusals", lambda: self.refusals)
            s.gauge("RowsChecked", lambda: self.rows_checked)
            self._msource = s
        return self._msource

    def stats(self) -> dict:
        return {"kind": "checker", "passes": self.passes,
                "divergences": self.divergences,
                "refusals": self.refusals,
                "rows_checked": self.rows_checked}
