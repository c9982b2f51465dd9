"""The commit proxy role — batches client commits through the pipeline.

Reference: REF:fdbserver/CommitProxyServer.actor.cpp::commitBatch — the
five-stage pipeline per batch:
  1. accumulate transactions for COMMIT_BATCH_INTERVAL (or count/byte cap)
  2. GetCommitVersionRequest → sequencer: (prev_version, version)
  3. broadcast ResolveTransactionBatchRequest to EVERY resolver (conflict
     ranges clipped to each resolver's partition); AND the verdicts
  4. tag committed mutations by shard map; substitute versionstamps
  5. push to every TLog; report committed to sequencer; reply to clients
Batches overlap: stage 2 of batch N+1 can start while batch N resolves —
version ordering is preserved by prev_version chaining in the resolver
and TLog, exactly like the reference.
"""

from __future__ import annotations

import asyncio
import struct

from ..ops.batch import COMMITTED, CONFLICT, TOO_OLD, TxnRequest
from ..runtime import span as _span
from ..runtime.errors import (ClientInvalidOperation, ClusterVersionChanged,
                              CommitUnknownResult, NotCommitted,
                              TransactionTooOld)
from ..runtime.knobs import Knobs
from .data import (PRIVATE_TYPES, SYSTEM_PREFIX, CommitResult,
                   CommitTransactionRequest, Mutation, MutationBatch,
                   MutationBatchBuilder, MutationType, Version,
                   pack_versionstamp)
from .resolver import ResolveBatchRequest, Resolver, clip_txn_to_range
from .sequencer import Sequencer
from .shard_map import ShardMap, write_team_drops


def is_state_txn(req: CommitTransactionRequest) -> bool:
    """A transaction that mutates the system keyspace is a "state
    transaction" (REF:fdbserver/CommitProxyServer.actor.cpp
    txnStateTransactions): its mutations must be applied by EVERY commit
    proxy in version order, so it is resolved alone in its batch with
    unclipped conflict ranges on every resolver.

    Verdict-agreement invariant: every resolver must compute the SAME
    verdict for a state transaction, or the proxies' metadata histories
    diverge.  Unclipped ranges alone don't give that — resolvers' write
    HISTORIES are per-partition — so state transactions may take read
    conflicts only within the system keyspace, whose full write history
    every resolver holds (all ``\\xff`` writes arrive via broadcast
    state transactions).  The proxy rejects violators up front."""
    for m in req.mutations:
        if m.type == MutationType.CLEAR_RANGE:
            if m.param2 > SYSTEM_PREFIX:
                return True
        elif m.param1 >= SYSTEM_PREFIX:
            return True
    return False


def check_state_txn_reads(req: CommitTransactionRequest) -> None:
    """Enforce the verdict-agreement invariant (see is_state_txn)."""
    for rb, _re in req.read_conflict_ranges:
        if rb < SYSTEM_PREFIX:
            raise ClientInvalidOperation(
                "system-key transactions may not take read conflicts on "
                "user keys (cross-resolver verdict agreement)")


class CommitProxy:
    def __init__(self, knobs: Knobs, sequencer: Sequencer,
                 resolvers: list[Resolver], log_system,
                 shard_map: ShardMap, backup_tags: dict[str, int] | None = None,
                 locked: bytes | None = None) -> None:
        self.knobs = knobs
        self.sequencer = sequencer
        self.resolvers = resolvers
        self.log_system = log_system
        # continuous-backup mutation tagging (REF:fdbserver/
        # BackupWorker/backup tags): while a backup tag is active, every
        # committed mutation is ALSO pushed under it, so backup agents can
        # pull the full ordered mutation stream.  Versioned like the shard
        # maps — \xff/backup/tag[s/<name>] state transactions flip the
        # armed set at an exact commit version on every proxy.  Several
        # named tags (file backup + DR) stream concurrently.
        self._backup_tags: list[tuple[Version, dict[str, int]]] = \
            [(-1, dict(backup_tags or {}))]
        # database lock (REF: lockedKey in ProxyCommitData): while set,
        # only lock-aware transactions may commit.  Versioned the same way.
        self._locks: list[tuple[Version, bytes | None]] = [(-1, locked)]
        # registered change feeds: feed id -> (begin, end).  Unlike the
        # shard maps / backup tags / locks, no consumer ever needs the
        # registry AT a historical version — markers are computed inside
        # _apply_metadata, which runs strictly in version order — so a
        # plain dict suffices (\xff/changeFeeds state transactions
        # mutate it at their exact commit version on every proxy, and
        # the OWNING proxy injects PRIVATE_FEED_* markers into the
        # owning storage tags' streams)
        self._feeds: dict[bytes, tuple[bytes, bytes]] = {}
        # versioned shard-map history: the map at index i is effective for
        # commit versions >= its change version.  Layout changes arrive as
        # state-transaction entries (the txnStateStore of this proxy) and
        # append snapshots, so pipelined batches always tag with the map
        # as of their OWN version even when a later batch applied a newer
        # layout first.
        self._maps: list[tuple[Version, ShardMap]] = [(-1, shard_map)]
        self.state_applied_version: Version = -1
        # drop markers computed per applied layout-change version.  Kept
        # separately from _apply_state_entries' return value because the
        # entry for version V may be applied by ANOTHER in-flight batch
        # whose reply arrived first — the batch that OWNS version V must
        # still find and push V's markers exactly once.
        self._pending_drops: dict[Version,
                                  list[tuple[int, int, bytes, bytes]]] = {}
        self._queue: asyncio.Queue = asyncio.Queue()
        self._batcher_task: asyncio.Task | None = None
        self._inflight: set[asyncio.Task] = set()
        self.total_batches = 0
        self.total_committed = 0
        self.total_conflicts = 0
        # routed-mesh accounting, one slot per resolver
        # partition: how many sends went out, how many were header-only
        # version advances (every txn clipped empty), and how many txns
        # rode the sparse sub-batches.  The imbalance across slots is the
        # signal the CC's heat-driven boundary rebalance consumes.
        self.route_stats = [{"sends": 0, "header_only": 0, "txns_routed": 0}
                            for _ in resolvers]
        # this proxy's fully-acked frontier: the newest version whose
        # push every hosting log acked.  Rides every later push (real
        # and empty) as TLogPushRequest.known_committed, giving
        # downstream consumers a committed floor (feed heartbeats must
        # never expose a possibly-unacked applied tip).
        self._known_committed: Version = 0
        from ..runtime.trace import CounterCollection, Histogram
        from ..runtime.latency_probe import StageStats
        self.counters = CounterCollection("ProxyCommit")
        self.latency_hist = Histogram("ProxyCommit", "BatchLatency")
        # per-stage commit-path breakdown: batch_fill /
        # version_wait / resolve / push, read by bench harnesses
        self.stages = StageStats("CommitProxy")
        # CommitDebug span events for sampled txns: queued / batch
        # milestones / reply, keyed by the wire-propagated trace id
        self.spans = _span.SpanSink("CommitProxy")
        self._msource = None
        # fail-stop (see _repair_chain): once set, new commits are refused
        # and the role-liveness ping probes dead, driving an epoch recovery
        self._failed: BaseException | None = None

    @property
    def shard_map(self) -> ShardMap:
        return self._maps[-1][1]

    def map_at(self, version: Version) -> ShardMap:
        for v, m in reversed(self._maps):
            if v <= version:
                return m
        return self._maps[0][1]

    def backup_tags_at(self, version: Version) -> tuple[int, ...]:
        for v, tags in reversed(self._backup_tags):
            if v <= version:
                return tuple(sorted(set(tags.values())))
        return ()

    def locked_at(self, version: Version) -> bytes | None:
        for v, uid in reversed(self._locks):
            if v <= version:
                return uid
        return None

    # --- metadata mutations (REF:fdbserver/ApplyMetadataMutation.cpp) ---

    def _apply_state_entries(self, entries, own_version: Version | None = None
                             ) -> list[tuple[int, int, bytes, bytes]]:
        """Apply committed state entries in version order; returns the
        private markers (shard drops, feed lifecycle) for the entry at
        ``own_version`` (only the proxy that owns that batch pushes them
        to the TLogs — exactly once).  The markers are retrieved from
        _pending_drops rather than the apply call, because a pipelined
        batch at a higher version may have applied our entry before our
        own reply arrived.  Entries arrive sorted by version; the
        piggyback ships mutations packed (MutationBatch) since 713."""
        for v, muts in sorted(entries or [], key=lambda e: e[0]):
            if v <= self.state_applied_version:
                continue
            markers = self._apply_metadata(v, muts)
            if markers:
                self._pending_drops[v] = markers
                if len(self._pending_drops) > 256:
                    # entries owned by other proxies are never popped;
                    # old ones can no longer be claimed by any batch
                    self._pending_drops.pop(min(self._pending_drops))
            self.state_applied_version = v
        if own_version is None:
            return []
        return self._pending_drops.pop(own_version, [])

    def _apply_metadata(self, version: Version, muts
                        ) -> list[tuple[int, int, bytes, bytes]]:
        """Returns (tag, private mutation type, param1, param2) markers
        the owning batch must inject into those tags' streams."""
        from ..rpc.wire import decode
        from ..runtime.trace import TraceEvent
        from .system_data import (BACKUP_PREFIX, BACKUP_TAGS_PREFIX,
                                  CHANGE_FEED_POP_PREFIX, CHANGE_FEED_PREFIX,
                                  LAYOUT_KEY, LOCKED_KEY, backup_tag_key)
        backup_key = BACKUP_PREFIX + b"tag"
        markers: list[tuple[int, int, bytes, bytes]] = []
        for m in muts:
            # -- change-feed lifecycle (create / pop via SET) --
            if m.type == MutationType.SET_VALUE \
                    and m.param1.startswith(CHANGE_FEED_PREFIX):
                fid = m.param1[len(CHANGE_FEED_PREFIX):]
                try:
                    info = decode(m.param2)
                    fb, fe = bytes(info["b"]), bytes(info["e"])
                except Exception as e:  # noqa: BLE001 — bad blob: ignore
                    TraceEvent("ProxyBadFeed", severity=30) \
                        .detail("Error", repr(e)[:100]).log()
                    continue
                # clamp \xff-exclusive (whole-db feeds cover exactly the
                # user keyspace; a forged registration must not make a
                # feed observe system writes)
                fe = min(fe, SYSTEM_PREFIX)
                if fb >= fe:
                    continue
                if fid not in self._feeds:  # re-register is idempotent
                    self._feeds[fid] = (fb, fe)
                    for t in self._maps[-1][1].tags_for_range(fb, fe):
                        markers.append(
                            (t, int(MutationType.PRIVATE_FEED_REGISTER),
                             fid, bytes(m.param2)))
                    TraceEvent("ProxyFeedRegistered") \
                        .detail("Version", version).detail("Feed", fid) \
                        .detail("Begin", fb).detail("End", fe).log()
                continue
            if m.type == MutationType.SET_VALUE \
                    and m.param1.startswith(CHANGE_FEED_POP_PREFIX):
                fid = m.param1[len(CHANGE_FEED_POP_PREFIX):]
                rng = self._feeds.get(fid)
                try:
                    int(decode(m.param2))
                except Exception as e:  # noqa: BLE001 — bad blob: a
                    # forwarded garbage payload would crash every owning
                    # storage server's apply loop
                    TraceEvent("ProxyBadFeedPop", severity=30) \
                        .detail("Error", repr(e)[:100]).log()
                    rng = None
                if rng is not None:
                    for t in self._maps[-1][1].tags_for_range(*rng):
                        markers.append(
                            (t, int(MutationType.PRIVATE_FEED_POP),
                             fid, bytes(m.param2)))
                continue
            # -- mutation-log tag arm/disarm (named slots) --
            name = None
            if m.param1 == backup_key:
                name = ""
            elif m.param1.startswith(BACKUP_TAGS_PREFIX):
                name = m.param1[len(BACKUP_TAGS_PREFIX):].decode(
                    errors="replace")
            if m.type == MutationType.SET_VALUE and name is not None:
                try:
                    tag = int(decode(m.param2))
                except Exception:  # noqa: BLE001 — bad blob: disable
                    tag = None
                cur = dict(self._backup_tags[-1][1])
                if tag is None:
                    cur.pop(name, None)
                else:
                    cur[name] = tag
                self._backup_tags.append((version, cur))
                TraceEvent("ProxyBackupTag").detail("Version", version) \
                    .detail("Name", name).detail("Tag", tag).log()
                continue
            if m.type == MutationType.CLEAR_RANGE:
                cur = {n: t for n, t in self._backup_tags[-1][1].items()
                       if not (m.param1 <= backup_tag_key(n) < m.param2)}
                if cur != self._backup_tags[-1][1]:
                    self._backup_tags.append((version, cur))
                    TraceEvent("ProxyBackupTag").detail("Version", version) \
                        .detail("Armed", sorted(cur)).log()
                # -- change-feed destroy (clear of the registration key) --
                doomed = {fid: rng for fid, rng in self._feeds.items()
                          if m.param1 <= CHANGE_FEED_PREFIX + fid < m.param2}
                for fid, rng in doomed.items():
                    del self._feeds[fid]
                    for t in self._maps[-1][1].tags_for_range(*rng):
                        markers.append(
                            (t, int(MutationType.PRIVATE_FEED_DESTROY),
                             fid, b""))
                    TraceEvent("ProxyFeedDestroyed") \
                        .detail("Version", version).detail("Feed", fid) \
                        .log()
                if m.param1 <= LOCKED_KEY < m.param2:
                    self._locks.append((version, None))
                    self.sequencer.report_lock(version, None)
                    TraceEvent("ProxyDbLock").detail("Version", version) \
                        .detail("Locked", False).log()
            # -- database lock/unlock --
            if m.type == MutationType.SET_VALUE and m.param1 == LOCKED_KEY:
                self._locks.append((version, bytes(m.param2)))
                self.sequencer.report_lock(version, bytes(m.param2))
                TraceEvent("ProxyDbLock").detail("Version", version) \
                    .detail("Locked", True).log()
                continue
            if m.type != MutationType.SET_VALUE or m.param1 != LAYOUT_KEY:
                continue
            try:
                layout = decode(m.param2)
                new = ShardMap([bytes(b) for b in layout["boundaries"]],
                               [list(t) for t in layout["teams"]])
            except Exception as e:  # noqa: BLE001 — a bad blob must not
                TraceEvent("ProxyBadLayout", severity=40) \
                    .detail("Error", repr(e)[:100]).log()   # kill the proxy
                continue
            drop_type = int(MutationType.PRIVATE_DROP_SHARD)
            markers.extend((t, drop_type, b, e) for t, b, e
                           in write_team_drops(self._maps[-1][1], new))
            self._maps.append((version, new))
            TraceEvent("ProxyLayoutApplied").detail("Version", version) \
                .detail("Shards", len(new.shard_tags)) \
                .detail("Drops", len(markers)).log()
        return markers

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._batcher_task = loop.create_task(
            self._batcher_loop(), name="commit-proxy-batcher")

    def metrics_source(self):
        """This role's registration in the per-worker MetricsRegistry —
        replaces the ad-hoc per-role metrics sleep loop.
        Gauges: the proxy's acked frontier + metadata frontier and the
        commit-path queue/in-flight depths (rising queue depth with flat
        KnownCommitted is a wedged version chain at one glance)."""
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("ProxyCommit", counters=self.counters)
            s.histogram(self.latency_hist)
            s.gauge("KnownCommitted", lambda: self._known_committed)
            s.gauge("StateAppliedVersion", lambda: self.state_applied_version)
            s.gauge("QueueDepth", lambda: self._queue.qsize())
            s.gauge("InflightBatches", lambda: len(self._inflight))
            # routed-mesh totals; the per-partition split rides
            # each resolver's own SkippedBatches/RoutedBatches gauges
            s.gauge("RoutedHeaderSends", lambda: sum(
                r["header_only"] for r in self.route_stats))
            s.gauge("RoutedTxnsSent", lambda: sum(
                r["txns_routed"] for r in self.route_stats))
            self._msource = s
        return self._msource

    async def stop(self) -> None:
        tasks = list(self._inflight)
        if self._batcher_task is not None:
            tasks.append(self._batcher_task)
            self._batcher_task = None
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        self._inflight.clear()
        # requests still queued or parked in a cancelled batch would await
        # forever; their outcome is genuinely unknown (broken promise)
        from ..runtime.errors import RequestMaybeDelivered
        while not self._queue.empty():
            _, fut, _t, _ctx = self._queue.get_nowait()
            if not fut.done():
                fut.set_exception(RequestMaybeDelivered())

    # --- client-facing ---

    async def metrics(self) -> dict:
        """Role counters for status (span rollup + commit load)."""
        from ..runtime.profiler import stall_metrics
        from ..runtime.span import process_counters
        return {
            "total_batches": self.total_batches,
            "total_committed": self.total_committed,
            "total_conflicts": self.total_conflicts,
            "known_committed": self._known_committed,
            "route_stats": [dict(r) for r in self.route_stats],
            **self.spans.counters(),
            **stall_metrics(),
            **process_counters(),
        }

    async def commit(self, req: CommitTransactionRequest) -> CommitResult:
        if self._failed is not None:
            raise ClusterVersionChanged() from self._failed
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        # capture the wire-propagated span NOW: the batch runs in its own
        # task later, where the request context is long gone
        ctx = _span.current_span()
        if ctx is not None and ctx.sampled:
            self.spans.event("CommitDebug", ctx,
                             "CommitProxyServer.commit.queued")
        else:
            ctx = None
        self._queue.put_nowait((req, fut, loop.time(), ctx))
        return await fut

    # --- batching (REF: commitBatcher) ---

    async def _batcher_loop(self) -> None:
        from ..runtime.buggify import buggify
        from ..runtime.rng import deterministic_random
        if buggify("proxy_tiny_batches", fire_p=1.0):
            # pathological batching knob (BUGGIFY knob randomization):
            # near-zero window makes every txn its own batch
            self.knobs = self.knobs.override(COMMIT_BATCH_INTERVAL=1e-5)
        elif buggify("proxy_fat_batches", fire_p=1.0):
            self.knobs = self.knobs.override(
                COMMIT_BATCH_INTERVAL=self.knobs.COMMIT_BATCH_INTERVAL * 20)
        loop = asyncio.get_running_loop()
        last_real_commit = loop.time()
        while True:
            # while clients are active, emit empty batches during gaps so
            # versions keep flowing (storage durability floors, resolver
            # windows, and GRV freshness all ride the version clock —
            # REF: the master's always-advancing version stream)
            if loop.time() - last_real_commit < self.knobs.IDLE_COMMIT_LIMIT:
                try:
                    first = await asyncio.wait_for(
                        self._queue.get(),
                        self.knobs.COMMIT_EMPTY_BATCH_INTERVAL)
                except asyncio.TimeoutError:
                    await self._empty_batch()
                    continue
            else:
                first = await self._queue.get()
            last_real_commit = loop.time()
            while first is not None:
                # state transactions (system-key writers) resolve ALONE in
                # their batch: every resolver must compute the same verdict
                # from the same (unclipped) view, which a singleton batch
                # guarantees without any cross-resolver agreement protocol
                state_item = None
                if is_state_txn(first[0]):
                    batch, state_item = [], first
                    nbytes = 0
                else:
                    batch = [first]
                    nbytes = first[0].expected_size()
                first = None
                deadline = loop.time() + self.knobs.COMMIT_BATCH_INTERVAL
                while (state_item is None
                       and len(batch) < self.knobs.COMMIT_BATCH_COUNT_LIMIT
                       and nbytes < self.knobs.COMMIT_BATCH_BYTE_LIMIT):
                    try:
                        # drain the backlog WITHOUT yielding: a burst that
                        # outgrew one batch must become consecutive
                        # prev-chained batch tasks created in this same
                        # loop turn, so they all submit to the resolver
                        # before its pipeline pump runs — that back-to-back
                        # submission is the fusion window that keeps >= 2
                        # groups in flight on the live path (a
                        # wait_for here yields per txn, which let the pump
                        # drain after every single batch and pinned the
                        # live fused group mean at 1.0)
                        item = self._queue.get_nowait()
                    except asyncio.QueueEmpty:
                        timeout = deadline - loop.time()
                        if timeout <= 0:
                            break
                        try:
                            item = await asyncio.wait_for(self._queue.get(),
                                                          timeout)
                        except asyncio.TimeoutError:
                            break
                    if is_state_txn(item[0]):
                        state_item = item      # flush batch, then this alone
                        break
                    batch.append(item)
                    nbytes += item[0].expected_size()
                # overlapped pipelining: run the batch as its own task;
                # version ordering downstream comes from prev_version
                # chaining
                for b in ([batch] if batch else []) + \
                        ([[state_item]] if state_item else []):
                    t = loop.create_task(
                        self._commit_batch(b), name="commit-batch")
                    self._inflight.add(t)
                    t.add_done_callback(self._inflight.discard)
                # backlog remaining after a full batch: form the next one
                # NOW (same turn), for the same fusion window
                if state_item is None:
                    try:
                        first = self._queue.get_nowait()
                    except asyncio.QueueEmpty:
                        first = None

    async def _empty_batch(self) -> None:
        """Advance the version chain with no transactions."""
        prev_version = version = None
        try:
            prev_version, version = await self.sequencer.get_commit_version()
            replies = await asyncio.gather(*(r.resolve(
                ResolveBatchRequest(prev_version, version, [], None,
                                    self.state_applied_version))
                for r in self.resolvers))
            self._apply_state_entries(replies[0].state_entries)
            await self.log_system.push(prev_version, version, {},
                                       self._known_committed)
            if version > self._known_committed:
                self._known_committed = version
            self.sequencer.report_committed(version)
        except Exception as e:
            from ..runtime.trace import TraceEvent
            TraceEvent("EmptyBatchFailed", severity=30) \
                .detail("Error", repr(e)[:200]).detail("Version", version).log()
            # an assigned version must never be abandoned (re-resolving or
            # re-pushing an empty batch is harmless)
            if version is not None:
                await self._repair_chain(prev_version, version, False, False)

    @staticmethod
    def _join_abort_words(reply, final: list[int],
                          idx: list[int] | None) -> bool:
        """Bitmask AND-join: fold a reply's packed abort
        words into ``final`` touching only set bits; ``idx`` maps the
        reply's positions to batch positions (None = identity, the
        broadcast twin).  Bit decode is conflict_bit + too_old_bit —
        exactly the codes pack_abort_words packed, so the result is
        bit-identical to the per-verdict scatter.  Returns False when
        the reply carries no words (knob off / old peer) and the caller
        must run the scatter twin."""
        words = reply.abort_words
        if words is None:
            return False
        nw = len(words) // 2
        for w in range(nw):
            cw = words[w]
            while cw:
                b = (cw & -cw).bit_length() - 1
                cw &= cw - 1
                i = w * 32 + b
                v = 1 + ((words[nw + w] >> b) & 1)
                j = i if idx is None else idx[i]
                if v > final[j]:
                    final[j] = v
        return True

    # --- the pipeline (REF: commitBatch) ---

    async def _commit_batch(self, batch: list[tuple[CommitTransactionRequest,
                                                    asyncio.Future, float,
                                                    object]]
                            ) -> None:
        # Pre-validate anything that could raise during tagging (malformed
        # versionstamp offsets) BEFORE a version is assigned, so a bad
        # request fails alone instead of wedging the version chain.
        now = asyncio.get_running_loop().time()
        for _req, _fut, t_enq, _ctx in batch:
            self.stages.record("batch_fill", now - t_enq)
        valid: list[tuple[CommitTransactionRequest, asyncio.Future,
                          _span.SpanContext | None]] = []
        for req, fut, _t, ctx in batch:
            try:
                if is_state_txn(req):
                    check_state_txn_reads(req)
                    # the database lock gates state transactions BEFORE
                    # resolution: once resolved, a state txn's metadata
                    # mutations ride every resolver's committed-state
                    # stream to every proxy unconditionally, so rejecting
                    # it afterwards would leave proxies' metadata applied
                    # for a commit the client was told failed (REF: the
                    # lockedKey check gating applyMetadataMutations).
                    # The local lock view can be STALE-LOCKED on an idle
                    # cluster (an unlock committed through another proxy
                    # only reaches us via state entries): resolve an
                    # empty batch first — it applies every pending state
                    # entry — and only reject if still locked.  The
                    # refresh is rate-limited so a tight client retry
                    # loop against a genuinely locked database costs one
                    # version-chain round per second, not one per retry.
                    if self._locks[-1][1] is not None \
                            and not getattr(req, "lock_aware", False):
                        now = asyncio.get_running_loop().time()
                        if now - getattr(self, "_lock_refreshed", -1e9) > 1.0:
                            self._lock_refreshed = now
                            await self._empty_batch()
                        if self._locks[-1][1] is not None:
                            from ..runtime.errors import DatabaseLocked
                            raise DatabaseLocked()
                for m in req.mutations:
                    if m.type in PRIVATE_TYPES:
                        # proxies append private markers themselves after
                        # tagging; one arriving IN a client request is
                        # forged and would discard a shard or corrupt a
                        # feed's lifecycle
                        raise ClientInvalidOperation(
                            "private mutation type in client commit")
                    self._substitute_versionstamp(m, 0, 0)
                valid.append((req, fut, ctx))
            except Exception as pre_err:
                # pair the .queued event for a pre-validation reject
                self.spans.event("CommitDebug", ctx,
                                 "CommitProxyServer.commitBatch.Rejected",
                                 Error=type(pre_err).__name__)
                if not fut.done():
                    from ..runtime.errors import DatabaseLocked
                    fut.set_exception(
                        pre_err if isinstance(pre_err, DatabaseLocked)
                        else ClientInvalidOperation())
        if not valid:
            return
        reqs = [r for r, _, _ in valid]
        futs = [f for _, f, _ in valid]
        ctxs = [c for _, _, c in valid]
        # sampled txns riding this batch; downstream hops (resolver, TLog
        # push) key to the FIRST — extra sampled txns keep their
        # proxy-level milestones but lose per-hop spans (counted dropped)
        sampled = [c for c in ctxs if c is not None]
        batch_ctx = sampled[0] if sampled else None
        if len(sampled) > 1:
            self.spans.drop(len(sampled) - 1)
        for c in sampled:
            self.spans.event("CommitDebug", c,
                             "CommitProxyServer.commitBatch.Before",
                             Txns=len(reqs))
        batch_began = asyncio.get_running_loop().time()
        prev_version = version = None
        resolved = pushed = push_started = False
        repair_tagged: dict[int, MutationBatch] | None = None
        is_state = any(is_state_txn(r) for r in reqs)
        loop = asyncio.get_running_loop()
        try:
            t0 = loop.time()
            prev_version, version = await self.sequencer.get_commit_version()
            self.stages.record("version_wait", loop.time() - t0)
            for c in sampled:
                self.spans.event("CommitDebug", c,
                                 "CommitProxyServer.commitBatch."
                                 "GotCommitVersion", Version=version)
            txns = [TxnRequest(r.read_conflict_ranges, r.write_conflict_ranges,
                               r.read_snapshot) for r in reqs]
            state_txns = None
            if is_state:
                # singleton by the batcher's construction; ranges ride
                # unclipped + mutations piggyback so every resolver logs
                # the identical committed-state stream.  Packed since
                # 713: one encode here, and the resolver's state log +
                # every proxy's reply share the same columnar struct the
                # rest of the pipeline speaks.
                assert len(reqs) == 1
                state_txns = [(0, MutationBatch.from_mutations(
                    reqs[0].mutations))]

            # Routed mesh: each resolver gets ONLY the txns
            # whose clipped conflict ranges are non-empty on its
            # partition (a sparse sub-batch — the index map stays here
            # and the verdicts scatter back below), and a partition every
            # txn clips empty against gets a header-only version advance
            # (empty txns) it answers without touching its backend.
            # State batches stay broadcast, unclipped and alone (the
            # verdict-agreement invariant).  Knob off = the broadcast
            # twin below, verbatim.
            routed = self.knobs.RESOLVER_MESH_ROUTING and not is_state
            final = [COMMITTED] * len(reqs)

            # broadcast to all resolvers, clipped to each partition
            async def ask(res: Resolver):
                sent = txns if is_state else \
                    [clip_txn_to_range(t, res.key_range) for t in txns]
                return await res.resolve(
                    ResolveBatchRequest(prev_version, version, sent,
                                        state_txns,
                                        self.state_applied_version))

            async def ask_routed(res: Resolver, sub: list[TxnRequest]):
                return await res.resolve(
                    ResolveBatchRequest(prev_version, version, sub, None,
                                        self.state_applied_version))
            t0 = loop.time()
            # the resolver hop inherits a child span via the contextvar:
            # gather's tasks copy the active context at creation, so the
            # (possibly remote) resolvers see the sampled trace
            if routed:
                index_maps: list[list[int]] = []
                subs: list[list[TxnRequest]] = []
                for ri, res in enumerate(self.resolvers):
                    sub, idx = [], []
                    for i, t in enumerate(txns):
                        ct = clip_txn_to_range(t, res.key_range)
                        if ct.read_ranges or ct.write_ranges:
                            sub.append(ct)
                            idx.append(i)
                    subs.append(sub)
                    index_maps.append(idx)
                    st = self.route_stats[ri]
                    st["sends"] += 1
                    st["txns_routed"] += len(sub)
                    if not sub:
                        st["header_only"] += 1
                    # per-partition scatter events:
                    # a sampled txn's timeline shows WHICH partitions
                    # resolved it — and which answered header-only —
                    # instead of one opaque resolve hop
                    for c in sampled:
                        self.spans.event("CommitDebug", c,
                                         "CommitProxyServer.commitBatch."
                                         "RoutedScatter", Partition=ri,
                                         Txns=len(sub),
                                         HeaderOnly=int(not sub))
                with _span.child_scope(batch_ctx):
                    replies = await asyncio.gather(
                        *(ask_routed(r, sub)
                          for r, sub in zip(self.resolvers, subs)))
                for c in sampled:
                    self.spans.event("CommitDebug", c,
                                     "CommitProxyServer.commitBatch."
                                     "RoutedGather", Version=version,
                                     Partitions=len(self.resolvers))
                # scatter the sparse verdicts into the AND-join: a txn a
                # partition never judged contributes COMMITTED there —
                # identical to broadcasting its empty clip (no ranges,
                # no conflict).  TOO_OLD dominates, then CONFLICT.
                # A reply carrying abort_words (RESOLVER_VERDICT_BITMASK)
                # takes the bitmask join: all-COMMITTED partitions — the
                # steady-state majority — skip the scatter outright, and
                # aborting ones touch only their set bits.
                for reply, idx in zip(replies, index_maps):
                    if not self._join_abort_words(reply, final, idx):
                        for j, v in zip(idx, reply.verdicts):
                            final[j] = max(final[j], v)
            else:
                with _span.child_scope(batch_ctx):
                    replies = await asyncio.gather(
                        *(ask(r) for r in self.resolvers))
                # AND the verdicts: TOO_OLD dominates, then CONFLICT
                for reply in replies:
                    if not self._join_abort_words(reply, final, None):
                        for i, v in enumerate(reply.verdicts):
                            final[i] = max(final[i], v)
            self.stages.record("resolve", loop.time() - t0)
            resolved = True
            for c in sampled:
                self.spans.event("CommitDebug", c,
                                 "CommitProxyServer.commitBatch."
                                 "AfterResolution", Version=version)

            # apply the committed state stream (our own state batch AND
            # other proxies' — identical on every resolver, take the
            # first's; a header-only reply still carries the piggyback)
            # BEFORE tagging, then tag with the map as of THIS batch's
            # version
            my_markers = self._apply_state_entries(
                replies[0].state_entries, own_version=version)
            shard_map = self.map_at(version)
            backup_tags = self.backup_tags_at(version)
            # database lock, authoritative as of THIS version (the state
            # entries above include any lock/unlock committed before us in
            # version order).  Applies to USER transactions only: their
            # exclusion from tagging is side-effect-free (the resolver
            # write-history entry causes at most spurious conflicts, never
            # a durable mutation).  A state txn that slipped the
            # pre-resolution check in the lock's propagation window
            # commits normally — its metadata is already in every
            # resolver's stream, and acking it keeps client and cluster
            # state consistent (the lock fences state txns steady-state,
            # like the reference).
            lock_uid = None if is_state else self.locked_at(version)

            # tag mutations of committed txns, in batch order; the log
            # system replicates each tag onto its hosting logs.  With a
            # backup tag active, the whole ordered stream rides under it
            # too (the continuous mutation-log backup feed).  The packed
            # MutationBatch is built ONCE here; each tag's payload is an
            # index slice of it (``select``), and a tag owning every
            # mutation — the single-shard common case — ships the batch
            # itself with zero copies.
            builder = MutationBatchBuilder()
            tag_idx: dict[int, list[int]] = {}
            order = 0
            orders: list[int] = [0] * len(reqs)
            locked_out: set[int] = set()
            for i, (req, verdict) in enumerate(zip(reqs, final)):
                if verdict != COMMITTED:
                    continue
                if lock_uid is not None and not getattr(req, "lock_aware",
                                                        False):
                    locked_out.add(i)
                    continue
                orders[i] = order
                for m in req.mutations:
                    m = self._substitute_versionstamp(m, version, order)
                    if m.type == MutationType.CLEAR_RANGE:
                        tags = shard_map.tags_for_range(m.param1, m.param2)
                    else:
                        tags = shard_map.tags_for_key(m.param1)
                    mi = builder.add(int(m.type), m.param1, m.param2)
                    for t in tags:
                        tag_idx.setdefault(t, []).append(mi)
                    for bt in backup_tags:
                        # a backup tag numerically colliding with a
                        # storage tag must not index the mutation twice
                        # (the seed's list append duplicated it — which
                        # double-applied atomics on that replica)
                        if bt not in tags:
                            tag_idx.setdefault(bt, []).append(mi)
                order += 1
            # private markers for metadata this batch committed (shard
            # handoffs, feed register/pop/destroy): each addressed tag
            # sees the marker at exactly this version in its own stream
            for t, mt, p1, p2 in my_markers:
                mi = builder.add(mt, p1, p2)
                tag_idx.setdefault(t, []).append(mi)
            batch_packed = builder.finish()
            tagged: dict[int, MutationBatch] = {
                t: batch_packed.select(ix) for t, ix in tag_idx.items()}
            repair_tagged = tagged

            push_started = True
            t0 = loop.time()
            with _span.child_scope(batch_ctx):
                await self.log_system.push(prev_version, version, tagged,
                                           self._known_committed)
            self.stages.record("push", loop.time() - t0)
            pushed = True
            if version > self._known_committed:
                self._known_committed = version
            for c in sampled:
                self.spans.event("CommitDebug", c,
                                 "CommitProxyServer.commitBatch."
                                 "AfterLogPush", Version=version)
            self.sequencer.report_committed(version)

            self.total_batches += 1
            self.counters.counter("CommitBatchIn").add(1)
            self.latency_hist.sample_seconds(
                asyncio.get_running_loop().time() - batch_began)
            for i, fut in enumerate(futs):
                if fut.done():
                    continue
                self.spans.event("CommitDebug", ctxs[i],
                                 "CommitProxyServer.commitBatch.Reply",
                                 Version=version,
                                 Committed=bool(final[i] == COMMITTED
                                                and i not in locked_out))
                if i in locked_out:
                    from ..runtime.errors import DatabaseLocked
                    fut.set_exception(DatabaseLocked())
                elif final[i] == COMMITTED:
                    self.total_committed += 1
                    self.counters.counter("TxnCommitOut").add(1)
                    fut.set_result(CommitResult(
                        version, pack_versionstamp(version, orders[i])))
                elif final[i] == TOO_OLD:
                    self.total_conflicts += 1
                    self.counters.counter("TxnConflicts").add(1)
                    fut.set_exception(TransactionTooOld())
                else:
                    self.total_conflicts += 1
                    self.counters.counter("TxnConflicts").add(1)
                    fut.set_exception(NotCommitted())
        except asyncio.CancelledError:
            # cancelled mid-push (role stop during an epoch change): some
            # TLog may already hold the batch, so the outcome is exactly
            # as ambiguous as the non-cancel failure path — a freely
            # retryable error here would let a client double-commit
            err = CommitUnknownResult() if push_started \
                else ClusterVersionChanged()
            for fut in futs:
                if not fut.done():
                    fut.set_exception(err)
            raise
        except Exception as e:
            from ..runtime.trace import TraceEvent
            TraceEvent("CommitBatchFailed", severity=30) \
                .detail("Version", version).detail("Resolved", resolved) \
                .detail("Pushed", pushed).detail("Error", repr(e)[:200]).log()
            for c in sampled:
                self.spans.event("CommitDebug", c,
                                 "CommitProxyServer.commitBatch.Error",
                                 Version=version, Error=type(e).__name__)
            # once any TLog may hold the batch, the outcome is ambiguous:
            # clients must see commit_unknown_result (maybe-committed), not
            # a freely-retryable transport error that would double-apply
            # mutations on retry (REF: NativeAPI tryCommit error mapping)
            client_err = CommitUnknownResult() if push_started else e
            for fut in futs:
                if not fut.done():
                    fut.set_exception(client_err)
            # complete the version chain: downstream roles are waiting on
            # prev_version ordering, and an abandoned version would wedge
            # every later batch cluster-wide
            if version is not None:
                await self._repair_chain(prev_version, version, resolved,
                                         pushed, repair_tagged,
                                         carries_state=is_state,
                                         cause=e)

    async def _repair_chain(self, prev_version: Version, version: Version,
                            resolved: bool, pushed: bool,
                            tagged: dict[int, MutationBatch] | None = None,
                            carries_state: bool = False,
                            cause: BaseException | None = None) -> None:
        """Complete an interrupted batch's version chain.  Once the batch
        RESOLVED, its verdicts (and any committed state transaction) are
        in every resolver's history, so the repair must push the batch's
        REAL payload — an empty substitute would let later batches commit
        durably on top of a layout change that never reached the logs
        (TLog pushes ack duplicates idempotently, so re-pushing a
        partially-delivered version is safe).  If a STATE-bearing batch
        resolved but the failure hit BEFORE tagging was computed
        (``tagged is None``), the payload cannot be reconstructed: the
        committed state txn is in every resolver's stream with its
        metadata mutations unrecoverable here.  Pushing an empty
        substitute would durably erase it, so the proxy FAIL-STOPS —
        refuses further commits and probes dead on its role-liveness
        slot — forcing an epoch recovery that rebuilds from the
        resolvers' state streams.  A pure USER batch in the same spot is
        safe to repair with an empty push: its clients already hold
        commit_unknown_result (maybe-committed permits not-committed),
        and the stray resolver write history costs at most spurious
        conflicts inside the MVCC window."""
        if resolved and tagged is None and carries_state:
            from ..runtime.trace import TraceEvent
            self._failed = cause or RuntimeError("unrepairable state batch")
            TraceEvent("CommitBatchUnrepairable", severity=30) \
                .detail("Version", version).log()
            return
        try:
            if not resolved:
                await asyncio.gather(*(r.resolve(
                    ResolveBatchRequest(prev_version, version, [], None,
                                        self.state_applied_version))
                    for r in self.resolvers))
            if not pushed:
                await self.log_system.push(prev_version, version,
                                           tagged if resolved and tagged
                                           else {}, self._known_committed)
            self.sequencer.report_committed(version)
        except Exception:
            pass  # a failed repair means the epoch is dead; recovery's job

    @staticmethod
    def _substitute_versionstamp(m: Mutation, version: Version,
                                 order: int) -> Mutation:
        """Splice the 10-byte commit versionstamp into key/value at the
        trailing 4-byte little-endian offset (API ≥ 520 wire format,
        REF:fdbserver/CommitProxyServer.actor.cpp)."""
        if m.type == MutationType.SET_VERSIONSTAMPED_KEY:
            stamped = CommitProxy._splice(m.param1, version, order)
            return Mutation(MutationType.SET_VALUE, stamped, m.param2)
        if m.type == MutationType.SET_VERSIONSTAMPED_VALUE:
            stamped = CommitProxy._splice(m.param2, version, order)
            return Mutation(MutationType.SET_VALUE, m.param1, stamped)
        return m

    @staticmethod
    def _splice(param: bytes, version: Version, order: int) -> bytes:
        if len(param) < 4:
            raise ValueError("versionstamp param lacks offset suffix")
        pos = struct.unpack("<I", param[-4:])[0]
        raw = param[:-4]
        if pos + 10 > len(raw):
            raise ValueError("versionstamp offset out of range")
        return raw[:pos] + pack_versionstamp(version, order) + raw[pos + 10:]
