"""The shared feed-consumption core every layer rides.

One :class:`LayerFeedConsumer` owns one whole-database change feed
(client/change_feed.py's exactly-once cursor) and fans each delivered
``(version, MutationBatch)`` entry to its registered sinks in
registration order.  The consumer's **freshness frontier** is the
highest version proven fully delivered to every sink: the cursor
advances only past versions all owning shards have heartbeated, and the
frontier advances only after every sink has returned for every entry at
or below it — so a layer that finished ``on_mutations`` for frontier F
has seen EVERY committed mutation at or below F, across shard moves,
failovers and recoveries (the cursor's coverage gate and min-heartbeat
merge provide that; this module adds nothing to the delivery contract).

The consumer also:

- pops the feed ``LAYER_FEED_POP_LAG_VERSIONS`` behind the frontier so
  retention stays bounded (the backup agent's pop discipline);
- publishes ``\\xff/layers/progress/<name>`` every
  ``LAYER_PROGRESS_INTERVAL`` seconds so ``cluster.layers`` in status
  can report frontier lag without an RPC surface to the client;
- registers one MetricsSource (frontier, entries, reconnects) when
  handed a registry.

Sink protocol (duck-typed): ``on_mutations(version, batch)`` per feed
entry, optional ``on_frontier(version)`` after each cursor round; either
may be a plain function or a coroutine function.  Sinks run in
registration order and a sink exception tears the consumer down loudly
(a layer silently skipping mutations would corrupt derived state — the
checker would catch it, but the consumer must not make it easy).
"""

from __future__ import annotations

import asyncio
import inspect

from ..core.change_feed import WHOLE_DB_BEGIN, WHOLE_DB_END
from ..core.data import Version
from ..core.system_data import layer_progress_key
from ..runtime.errors import ChangeFeedDestroyed
from ..runtime.trace import TraceEvent

__all__ = ["LayerFeedConsumer"]


class LayerFeedConsumer:
    """One whole-db feed, many layer sinks, one freshness frontier."""

    def __init__(self, db, name: str = "layers",
                 feed_id: bytes | None = None, knobs=None) -> None:
        self.db = db
        self.name = name
        self.feed_id = feed_id if feed_id is not None \
            else b"layers/" + name.encode()
        self.knobs = knobs if knobs is not None else db.cluster.knobs
        self._sinks: list = []
        self._task: asyncio.Task | None = None
        self.registration_version: Version = 0
        self.frontier: Version = 0        # proven-delivered version
        self.entries_delivered = 0
        self.batches_delivered = 0
        self.reconnects = 0
        self.pops = 0
        self.destroyed = False
        self._last_pop: Version = 0
        self._last_publish = 0.0
        self._msource = None

    # --- sink registration ---

    def add_sink(self, sink) -> None:
        if sink not in self._sinks:
            self._sinks.append(sink)

    # --- lifecycle ---

    async def start(self) -> Version:
        """Destroy-then-create the feed (the backup agent's fresh
        registration discipline: the commit version of the CREATE is the
        layer's time zero) and begin pulling.  Returns the registration
        version — the frontier starts there."""
        await self.db.destroy_change_feed(self.feed_id)
        vb = await self.db.create_change_feed(self.feed_id, WHOLE_DB_BEGIN,
                                              WHOLE_DB_END)
        self.registration_version = vb
        self.frontier = vb
        self._last_pop = vb
        loop = asyncio.get_running_loop()
        self._task = loop.create_task(self._pull_loop(),
                                      name=f"layer-feed-{self.name}")
        return vb

    async def stop(self, destroy: bool = False) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._task = None
        if destroy and not self.destroyed:
            try:
                await self.db.destroy_change_feed(self.feed_id)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    async def wait_frontier(self, version: Version,
                            timeout: float = 30.0) -> Version:
        """Block until the frontier proves everything at or below
        ``version`` delivered to every sink (loop-clock deadline)."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while self.frontier < version:
            if self._task is not None and self._task.done():
                self._task.result()     # surface the pull loop's death
            if loop.time() > deadline:
                raise TimeoutError(
                    f"layer feed {self.name!r} frontier stalled at "
                    f"{self.frontier} < {version}")
            await asyncio.sleep(self.knobs.LAYER_FEED_POLL_INTERVAL)
        return self.frontier

    # --- metrics / status surface ---

    def metrics_source(self):
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("LayerFeed", self.name)
            s.gauge("Frontier", lambda: self.frontier)
            s.gauge("RegistrationVersion",
                    lambda: self.registration_version)
            s.gauge("EntriesDelivered", lambda: self.entries_delivered)
            s.gauge("Reconnects", lambda: self.reconnects)
            s.gauge("Pops", lambda: self.pops)
            self._msource = s
        return self._msource

    def stats(self) -> dict:
        return {"kind": "feed", "frontier": self.frontier,
                "registration_version": self.registration_version,
                "entries": self.entries_delivered,
                "batches": self.batches_delivered,
                "reconnects": self.reconnects, "pops": self.pops,
                "destroyed": self.destroyed}

    # --- the pull loop ---

    async def _dispatch(self, method: str, *args) -> None:
        for sink in self._sinks:
            fn = getattr(sink, method, None)
            if fn is None:
                continue
            r = fn(*args)
            if inspect.isawaitable(r):
                await r

    async def _pull_loop(self) -> None:
        cursor = self.db.read_change_feed(self.feed_id, self.frontier + 1)
        while True:
            try:
                entries = await cursor.next()
            except asyncio.CancelledError:
                raise
            except ChangeFeedDestroyed:
                # terminal: the feed's retained segments are gone — a
                # rebuilt cursor could silently skip, so don't
                self.destroyed = True
                TraceEvent("LayerFeedDestroyed", severity=30) \
                    .detail("Name", self.name) \
                    .detail("Frontier", self.frontier).log()
                return
            except Exception as e:  # noqa: BLE001 — rebuild off the frontier
                self.reconnects += 1
                TraceEvent("LayerFeedReconnect", severity=20) \
                    .detail("Name", self.name) \
                    .detail("Frontier", self.frontier) \
                    .detail("Error", repr(e)[:200]).log()
                await asyncio.sleep(self.knobs.LAYER_FEED_POLL_INTERVAL)
                cursor = self.db.read_change_feed(self.feed_id,
                                                  self.frontier + 1)
                continue
            for v, batch in entries:
                await self._dispatch("on_mutations", v, batch)
                self.entries_delivered += 1
                self.batches_delivered += len(batch)
            # the cursor owns everything below cursor.version across
            # every shard — only NOW is that span proven delivered
            self.frontier = max(self.frontier, cursor.version - 1)
            await self._dispatch("on_frontier", self.frontier)
            await self._maintain()

    async def _maintain(self) -> None:
        """Retention pop + progress publish, both best-effort: a locked
        or briefly headless cluster costs a skipped round, never the
        pull loop."""
        pop_to = self.frontier - self.knobs.LAYER_FEED_POP_LAG_VERSIONS
        if pop_to > self._last_pop:
            try:
                await self.db.pop_change_feed(self.feed_id, pop_to)
                self._last_pop = pop_to
                self.pops += 1
            except Exception:  # noqa: BLE001
                pass
        loop = asyncio.get_running_loop()
        if loop.time() - self._last_publish \
                >= self.knobs.LAYER_PROGRESS_INTERVAL:
            self._last_publish = loop.time()
            try:
                await self.publish_progress()
            except Exception:  # noqa: BLE001
                pass

    async def publish_progress(self, extra: dict | None = None) -> None:
        """Write the ``\\xff/layers/progress/<name>`` row status reads
        back (the backup-progress discipline; see core/system_data.py)."""
        from ..rpc.wire import encode
        stats = self.stats()
        # splat each sink's own stats alongside the feed's so the
        # cluster.layers rollup shows index/cache/watch state per
        # consumer without any of them publishing separately
        stats["sinks"] = [s.stats() for s in self._sinks
                          if hasattr(s, "stats")]
        if extra:
            stats.update(extra)
        blob = encode(stats)

        async def go(tr):
            tr.lock_aware = True
            tr.set(layer_progress_key(self.name), blob)
        await self.db.run(go, max_retries=3)
