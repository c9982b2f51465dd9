"""The storage server role — versioned reads over a pulled mutation stream.

Reference: REF:fdbserver/storageserver.actor.cpp — each storage server
owns key-range shards, continuously peeks its tag from the TLogs, applies
mutations in version order into the MVCC window (``update``), and serves
reads at exact versions (``getValueQ``/``getKeyValuesQ``): a read above
the applied version waits briefly (future_version), a read below the
window floor fails with transaction_too_old.  Atomic ops are evaluated
here, against the latest value, exactly like upstream.
"""

from __future__ import annotations

import asyncio

import time

from ..runtime.errors import FutureVersion, TransactionTooOld
from ..runtime.knobs import Knobs
from ..runtime.latency_probe import StageStats
from ..runtime.profiler import RateMeter
from ..runtime.profiler import stall_metrics as _stall_metrics
from ..runtime.span import SpanSink, child_scope, current_span
from ..runtime.span import process_counters as _process_trace_counters
from ..runtime.trace import Severity, TraceEvent, get_trace_log
from ..storage.kv_store import OP_CLEAR, OP_SET
from ..storage.packed_ops import DurabilityRing
from ..storage.versioned_map import VersionedMap
from .change_feed import ChangeFeedStore, ChangeFeedStreamReply
from .data import (KeyRange, Mutation, MutationBatch, MutationBatchBuilder,
                   MutationType, Version, apply_atomic)
from .tlog import TLog, Tag


class StorageServer:
    def __init__(self, knobs: Knobs, tag: Tag, shard: KeyRange,
                 log_system, epoch_begin_version: Version = 0,
                 engine=None, fetch_src=None,
                 fetch_version: Version = 0, device=None) -> None:
        from .log_system import LogSystem
        self.knobs = knobs
        self.tag = tag
        self.shard = shard
        self._meta_shard = shard     # narrows on live-move drops; persisted
        if not isinstance(log_system, LogSystem):
            # a bare TLog (or TLogClient stub) — unit-test convenience
            log_system = LogSystem.single([log_system], 1,
                                          epoch_begin_version)
        self.log_system = log_system
        self.engine = engine            # IKeyValueStore when durable
        # MVCC window: columnar generational store by
        # default — all-SET packed TLog batches seal straight into
        # immutable segments, drop_before retires whole segments.  The
        # knob-off twin is the legacy dict-of-chains window.
        self.vmap = VersionedMap(
            columnar=knobs.STORAGE_MVCC_COLUMNAR,
            seal_ops=knobs.STORAGE_MVCC_SEAL_OPS,
            seal_bytes=knobs.STORAGE_MVCC_SEAL_BYTES,
            seal_versions=knobs.STORAGE_MVCC_SEAL_VERSIONS)
        if engine is not None:
            # resume from the engine's durable version (0 for a fresh
            # engine — everything newer replays from the TLog)
            v0 = engine.meta.get("durable_version", 0)
        else:
            v0 = epoch_begin_version
        self.version: Version = v0
        self.durable_version: Version = v0
        self.oldest_version: Version = v0
        # committed floor learned from TLog peeks (knownCommittedVersion):
        # applied versions ABOVE it may still be clamped out by a
        # recovery, so feed heartbeats expose min(version, this) — a
        # consumer's cursor must never advance past data that could be
        # rolled back and re-assigned
        self.known_committed: Version = v0
        self.vmap.oldest_version = v0
        self.vmap.latest_version = v0
        # pending-durable ops, packed (a ring of MutationBatch segments
        # with a bisect version cursor — each durability tick commits a
        # slice instead of rebuilding a tuple list).
        # On durable deployments a DiskQueue side file attaches
        # (attach_dbuf_queue) so a throttled engine commit spills the
        # retained window to disk instead of growing RSS without bound
        # (the TLog keeps every replay copy, so the side file
        # carries no recovery obligation)
        self._dbuf = DurabilityRing(
            spill_bytes=knobs.STORAGE_DBUF_SPILL_BYTES)
        self._version_waiters: dict[Version, list[asyncio.Future]] = {}
        # feed streams parked until the COMMITTED frontier (not the raw
        # applied tip) reaches their cursor: (target, future)
        self._feed_waiters: list[tuple[Version, asyncio.Future]] = []
        self._watches: dict[bytes, list[tuple[bytes | None, asyncio.Future]]] = {}
        self._pull_task: asyncio.Task | None = None
        self._durability_task: asyncio.Task | None = None
        self.bytes_input = 0
        self.bytes_durable = 0    # ratekeeper queue metric
        self.total_reads = 0
        self.logical_bytes = 0    # approx live kv size (DD shard stats)
        # fetchKeys: a moved/split-in shard is not readable until the
        # snapshot from the source replica has landed
        self._fetch_src = fetch_src
        self._fetch_version = fetch_version
        self._fetch_done = asyncio.Event()
        if fetch_src is None:
            self._fetch_done.set()
        self._fetch_failed = False
        self._fetch_task: asyncio.Task | None = None
        # ranges this server relinquished (live shard moves): a
        # PRIVATE_DROP_SHARD marker in the tag stream records (version,
        # begin, end); reads ABOVE the drop version are refused with
        # wrong_shard_server so a stale-routed client refreshes its map,
        # while reads at or below it still serve from history
        # (REF:fdbserver/storageserver.actor.cpp changeServerKeys)
        self._dropped: list[tuple[Version, bytes, bytes]] = []
        # dropped ranges whose rows still occupy the engine; GC'd by the
        # durability loop once the drop version ages past the MVCC floor
        self._gc_pending: list[tuple[Version, bytes, bytes]] = []
        # shard heat: decayed read/write rates + sampled-key
        # reservoir folded from the accounting below (total_reads bumps,
        # apply mutation counts); shipped to DD/Ratekeeper via the
        # shard_metrics RPC so data distribution can act on LOAD, not
        # just logical_bytes
        from .shard_load import ShardHeatTracker
        self.heat = ShardHeatTracker(knobs, tag)
        from ..runtime.trace import CounterCollection
        self.counters = CounterCollection("Storage", str(tag))
        self._msource = None
        # apply-path observability (the r5 bench collapse was invisible
        # until a SlowTask fired; these make the next regression a
        # metric, not a timeout): per-batch apply timing + batch sizes
        # via StageStats, mutation throughput via a RateMeter, and the
        # index's merge counters read off the vmap
        # cap 4096: summary() sorts the retained samples on every
        # ratekeeper/status poll — keep that O(small), and the ring
        # rotates ~minutes of trailing apply history at load
        self.apply_stats = StageStats(f"storage-apply-{tag}", cap=4096)
        self.apply_meter = RateMeter("mutations_applied")
        self.apply_batch_size_max = 0
        # TransactionDebug span events for sampled reads; the batched
        # apply path is correlated by VERSION RANGE instead (see
        # _apply_batch — mutations do not carry trace ids)
        self.spans = SpanSink("StorageServer")
        # change feeds hosted by this server: armed by
        # PRIVATE_FEED_REGISTER markers in the tag stream, fed by the
        # apply path, served by change_feed_stream.  The worker swaps in
        # a DiskQueue-backed store (with recovered spill frames) on
        # durable deployments; registrations themselves ride the engine
        # meta so a rebooted replica re-arms before replaying the TLog.
        self.feeds = ChangeFeedStore()
        if engine is not None:
            self.feeds.restore(engine.meta.get("feeds") or [], [], 0)
        # deterministic 1-in-N server-side span roots for feed streams
        # arriving without a sampled client context
        from ..runtime.span import ServerSampler
        self._server_sampler = ServerSampler(namespace=2)
        self._device = device
        self._device_reads = None
        self.arm_device_reads()

    def arm_device_reads(self) -> None:
        """The device gather path for point-read serving: a device
        mirror of the engine's PackedKeyIndex answers get_values'
        missing-key pass with one vectorized searchsorted per batch.
        Engines without a packed index report inactive and the engine
        path serves.  The mirror lives on the server's device (the CUDA
        card unless the caller passes the CPU).  Called at construction,
        and by a worker that attaches a durable engine to a freshly
        recruited server after constructing it."""
        if self.engine is None or not self.knobs.STORAGE_DEVICE_READ_SERVE:
            return
        from ..device.read_serve import DeviceReadServer
        # version_fn feeds the staleness gauge:
        # how many versions the mirror trails THIS server's tip
        srv = DeviceReadServer(self.engine, self.knobs, device=self._device,
                               version_fn=lambda: self.version)
        self._device_reads = srv if srv.active else None

    def attach_dbuf_queue(self, queue) -> None:
        """Arm the durability ring's disk spill with a per-server
        DiskQueue side file.  Callers hand a FRESH (truncated)
        queue: ring contents above the durable floor replay from the
        TLog after any reboot, so stale side-file bytes must never be
        adopted — prefer ``attach_fresh_dbuf_queue``, which owns that
        invariant."""
        self._dbuf.queue = queue

    async def attach_fresh_dbuf_queue(self, fs, base: str) -> None:
        """THE one home of the spill side-file lifecycle (worker reboot
        adoption, recruits, Cluster.create): truncate
        ``<base>.dbuf.dq`` — never recover it — then open and attach.
        Stale bytes must never be adopted: everything the ring ever
        holds is above the durable floor and replays from the TLog."""
        from ..storage.disk_queue import DiskQueue
        f = fs.open(base + ".dbuf.dq")
        await f.truncate(0)
        await f.sync()
        queue, _ = await DiskQueue.open(f)
        self.attach_dbuf_queue(queue)

    async def _maybe_spill_dbuf(self) -> None:
        """Best-effort spill pass (pull/durability loop hook): failures
        keep the memory copy — losing buffered ops to a side-file error
        would be data loss, growing RSS is not."""
        try:
            spilled = await self._dbuf.maybe_spill()
        except Exception as e:  # noqa: BLE001 — retry on a later pass
            TraceEvent("StorageDbufSpillError", severity=30) \
                .detail("Tag", self.tag).error(e).log()
            return
        if spilled:
            TraceEvent("StorageDbufSpill").detail("Tag", self.tag) \
                .detail("Bytes", spilled) \
                .detail("MemBytes", self._dbuf.mem_bytes) \
                .detail("SpilledBytes", self._dbuf.spilled_bytes).log()

    async def metrics(self) -> dict:
        """Queue/lag sample for the Ratekeeper (StorageQueuingMetrics
        analog, REF:fdbserver/storageserver.actor.cpp)."""
        apply_ms = self.apply_stats.summary().get("apply_batch", {})
        meter = self.apply_meter.snapshot()
        idx = self.vmap.index_stats()
        heat_r, heat_w, heat_wb = self.heat.rates()
        return {
            "tag": self.tag,
            "mutations_applied": meter["count"],
            "mutations_per_sec": meter["per_sec"],
            "apply_batches": meter["batches"],
            "apply_batch_size_mean": meter["mean_batch"],
            "apply_batch_size_max": self.apply_batch_size_max,
            "apply_batch_p99_ms": apply_ms.get("p99_ms", 0.0),
            "apply_batch_max_ms": apply_ms.get("max_ms", 0.0),
            "index_keys": idx["keys"],
            "index_merges": idx["merges"],
            "index_merge_ms": idx["merge_ms"],
            # columnar window shape (0 under the legacy twin)
            "mvcc_segments": idx.get("segments", 0),
            "mvcc_resident_bytes": idx.get("resident_bytes", 0),
            "durable_engine": self.engine is not None,
            "queue_bytes": self.bytes_input - self.bytes_durable,
            "version": self.version,
            "durable_version": self.durable_version,
            "oldest_version": self.oldest_version,
            "known_committed": self.known_committed,
            "bytes_input": self.bytes_input,
            "logical_bytes": self.logical_bytes,
            "shard_begin": self.shard.begin,
            "shard_end": self.shard.end,
            "fetch_done": self._fetch_done.is_set(),
            "fetch_failed": self._fetch_failed,
            # scalar heat rates ride the metrics the Ratekeeper/status
            # already poll — the Ratekeeper's heat arm consumes THESE
            # (zero extra RPCs); only DD's split-point computation needs
            # the reservoir payload, via shard_metrics
            "shard_reads_per_sec": round(heat_r, 3),
            "shard_writes_per_sec": round(heat_w, 3),
            "shard_write_bytes_per_sec": round(heat_wb, 3),
            "shard_rw_per_sec": round(heat_r + heat_w, 3),
            **self._dbuf.stats(),
            # disk health: durable servers publish their
            # filesystem's decayed per-op latency + degraded flag — the
            # gray-failure signal status and the CC's FailureMonitor
            # poll consume
            **(self.engine.fs.health.snapshot()
               if self.engine is not None
               and getattr(self.engine, "fs", None) is not None
               and hasattr(self.engine.fs, "health") else {}),
            # engine-side compaction observability: the lsm
            # engine publishes write_amp / compact debt / commit-stall
            # counters; other engines carry no metrics() surface
            **(self.engine.metrics()
               if self.engine is not None
               and hasattr(self.engine, "metrics") else {}),
            **self.feeds.metrics(),
            **self.spans.counters(),
            **(self._device_reads.metrics()
               if self._device_reads is not None else {}),
            # slow-task stalls of the hosting process: empty under sim / when
            # no profiler is armed
            **_stall_metrics(),
            # process-wide trace-plane loss counters: status dedupes by
            # address, like slow tasks
            **_process_trace_counters(),
        }

    async def shard_metrics(self) -> dict:
        """The shard-heat sample DD and the Ratekeeper consume (
        the splitMetrics/getShardStateQ shape of
        REF:fdbserver/StorageMetrics.actor.cpp): decayed read/write
        rates over THIS server's shard plus the sampled-key reservoir —
        enough to rank shards by heat AND compute a split point inside
        the hot one without a range scan."""
        return {
            **self.heat.snapshot(self._meta_shard.begin,
                                 self._meta_shard.end),
            "queue_bytes": self.bytes_input - self.bytes_durable,
            "durable_engine": self.engine is not None,
            "logical_bytes": self.logical_bytes,
        }

    # --- lifecycle ---

    def start(self) -> None:
        loop = asyncio.get_running_loop()
        if self._fetch_src is not None and not self._fetch_done.is_set():
            self._fetch_task = loop.create_task(
                self._fetch_loop(), name=f"storage-{self.tag}-fetch")
        self._pull_task = loop.create_task(
            self._pull_loop(), name=f"storage-{self.tag}-pull")
        if self.engine is not None:
            self._durability_task = loop.create_task(
                self._durability_loop(), name=f"storage-{self.tag}-durability")

    def metrics_source(self):
        """This role's registration in the per-worker MetricsRegistry —
        replaces the ad-hoc per-role metrics sleep loop.
        The version frontiers the ratekeeper reads every interval
        (applied/durable/popped-floor/known-committed) are now RECORDED
        every interval, so a durability-lag incident can be replayed
        from the trace file (metrics_tool lag) instead of reproduced
        under a live status poll.  MVCC window occupancy, the
        durability-ring spill state and the lsm compaction debt ride
        the same series."""
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("Storage", counters=self.counters)
            s.meter(self.apply_meter)
            # engine-less servers never run the durability loop, so
            # their DurableVersion freezes at v0 — the marker lets lag
            # tooling skip them exactly like the ratekeeper does
            s.gauge("DurableEngine", lambda: int(self.engine is not None))
            s.gauge("Version", lambda: self.version)
            s.gauge("DurableVersion", lambda: self.durable_version)
            s.gauge("OldestVersion", lambda: self.oldest_version)
            s.gauge("KnownCommitted", lambda: self.known_committed)
            s.gauge("QueueBytes",
                    lambda: self.bytes_input - self.bytes_durable)
            s.gauge("BytesInput", lambda: self.bytes_input)
            s.gauge("BytesDurable", lambda: self.bytes_durable)
            s.gauge("FinishedQueries", lambda: self.total_reads)
            s.gauge("LogicalBytes", lambda: self.logical_bytes)
            s.gauge("IndexMerges",
                    lambda: self.vmap.index_stats()["merges"])
            # window occupancy: versions resident in the MVCC window +
            # the columnar shape (0 segments under the legacy twin)
            s.gauge("WindowVersions",
                    lambda: self.version - self.oldest_version)
            s.gauge("MvccSegments",
                    lambda: self.vmap.index_stats().get("segments", 0))
            s.gauge("MvccResidentBytes",
                    lambda: self.vmap.index_stats().get("resident_bytes", 0))
            s.gauge("DbufMemBytes", lambda: self._dbuf.mem_bytes)
            s.gauge("DbufSpilledBytes", lambda: self._dbuf.spilled_bytes)
            # device read mirror lag: versions the
            # mirror trails this server's tip — 0 when fresh or disarmed
            s.gauge("DeviceReadStaleness",
                    lambda: (self._device_reads.staleness_versions()
                             if self._device_reads is not None else 0))
            # engine-side compaction debt (lsm only; 0 elsewhere).
            # NOT named "LsmCompact*": the determinism children count
            # b"LsmCompact" to prove the background compactor ran, and
            # a gauge matching the substring would count as compactions
            s.gauge("CompactDebtBytes",
                    lambda: (self.engine.metrics().get(
                        "lsm_compact_debt_bytes", 0)
                        if self.engine is not None
                        and hasattr(self.engine, "metrics") else 0))
            self._msource = s
        return self._msource

    async def stop(self) -> None:
        for attr in ("_pull_task", "_durability_task",
                     "_fetch_task"):
            t = getattr(self, attr)
            if t is not None:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
                setattr(self, attr, None)
        if self.engine is not None:
            # the engine may own a background task of its own (the lsm
            # leveled compactor): a stopped role must not
            # leave it writing to — or resurrecting — the role's files
            # (stop_role(destroy=True) removes them right after)
            await self.engine.close()

    # --- recovery (REF: storageserver.actor.cpp rollback + rejoin) ---

    async def rejoin(self, generations: list, recovery_version: Version) -> None:
        """Adopt a recovered log system: roll back in-memory state above
        the recovery version (those mutations came from a generation's
        clamped, unacked suffix), swap in the new generation list, and
        restart the pull loop from the consistent cut."""
        from ..runtime.trace import TraceEvent
        if self.durable_version > recovery_version:
            # durable state is ahead of the recovered history — this
            # replica cannot be rolled back and must be discarded/refetched
            # (the reference kills the storage server here)
            TraceEvent("StorageRejoinAhead", severity=30) \
                .detail("Tag", self.tag) \
                .detail("DurableVersion", self.durable_version) \
                .detail("RecoveryVersion", recovery_version).log()
            raise TransactionTooOld()
        running = self._pull_task is not None
        if running:
            self._pull_task.cancel()
            try:
                await self._pull_task
            except asyncio.CancelledError:
                pass
            self._pull_task = None
        if self.version > recovery_version:
            self.vmap.rollback_after(recovery_version)
            self._dbuf.rollback_after(recovery_version)
            # feed entries captured from the dead generation's unacked
            # suffix must never reach a consumer: exactly-once depends
            # on rolling them back with the MVCC window
            self.feeds.rollback_after(recovery_version)
            self.version = recovery_version
        if any(v > recovery_version for v, _b, _e in self._dropped):
            # a PRIVATE_DROP_SHARD applied from a generation's unacked
            # suffix rolls back with it: the move never committed, this
            # team still owns the range.  The fence must lift AND the
            # pending engine GC must be cancelled — clearing a range we
            # still own would be physical data loss, not over-fencing.
            self._dropped = [(v, b, e) for v, b, e in self._dropped
                             if v <= recovery_version]
            self._gc_pending = [(v, b, e) for v, b, e in self._gc_pending
                                if v <= recovery_version]
            ms = KeyRange(self.shard.begin, self.shard.end)
            self._meta_shard = ms
            surviving = sorted(self._dropped)
            for v, b, e in surviving:       # re-narrow from surviving drops
                if b <= ms.begin and e >= ms.end:
                    ms = KeyRange(ms.begin, ms.begin)
                elif b <= ms.begin < e < ms.end:
                    ms = KeyRange(e, ms.end)
                elif ms.begin < b < ms.end <= e:
                    ms = KeyRange(ms.begin, b)
            self._meta_shard = ms
        self.log_system.generations[:] = generations
        TraceEvent("StorageRejoinRan").detail("Tag", self.tag) \
            .detail("Version", self.version) \
            .detail("RecoveryVersion", recovery_version) \
            .detail("PullRestarted", running).log()
        if running:
            self._pull_task = asyncio.get_running_loop().create_task(
                self._pull_loop(), name=f"storage-{self.tag}-pull")

    # --- fetchKeys (REF: storageserver.actor.cpp fetchKeys) ---

    async def _fetch_loop(self) -> None:
        """Stream the shard's snapshot at the fetch version from a source
        replica; mutations above it arrive via the normal tag pull, so
        snapshot + stream compose into an exact copy.  Reads are gated
        until the snapshot has fully landed (no partial-range phantoms)."""
        from ..runtime.errors import FdbError
        from ..runtime.trace import TraceEvent
        b, e, v = self.shard.begin, self.shard.end, self._fetch_version
        rows_total = 0
        # span the whole move-destination fetch: a
        # slow restore/relocation shows up as one fetchKeys span per
        # destination in the trace file, paired Before/After(.Error),
        # with the source page reads riding the activated context
        span_ctx = self._server_sampler.root(self.knobs.SERVER_SPAN_SAMPLE)
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.fetchKeys.Before",
                         Tag=self.tag, Begin=b, End=e, Version=v)
        from ..runtime.errors import error_from_code
        from .data import GV_ERROR_CODES, GetRangeRequest
        try:
            with child_scope(span_ctx):
                while True:
                    try:
                        # the move-destination snapshot rides the packed
                        # range reply: a refused chunk's status
                        # code maps back to the error class the legacy
                        # scalar path raised, so the retry/abort
                        # discipline below is unchanged
                        rep = await self._fetch_src.get_key_values_packed(
                            GetRangeRequest(b, e, v, 1000))
                        if rep.status:
                            raise error_from_code(
                                GV_ERROR_CODES[rep.status])
                        kvs, more = rep.rows(), rep.more
                    except FdbError as err:
                        from ..runtime.errors import \
                            TransactionTooOld as _TooOld
                        if isinstance(err, _TooOld):
                            # the snapshot version aged out of the source's
                            # MVCC window before the fetch finished: this
                            # destination cannot be completed exactly —
                            # fail the fetch and let the data distributor
                            # abort the move and retry with a fresh
                            # destination (the reference instead restarts
                            # fetchKeys at a newer version; our moves are
                            # all-or-nothing per attempt)
                            self._fetch_failed = True
                            TraceEvent("FetchKeysTooOld", severity=30) \
                                .detail("Tag", self.tag) \
                                .detail("Version", v).log()
                            self.spans.event(
                                "TransactionDebug", span_ctx,
                                "StorageServer.fetchKeys.Error",
                                Tag=self.tag, Error="TransactionTooOld")
                            return
                        if err.retryable:
                            await asyncio.sleep(0.1)
                            continue
                        raise
                    page: list[tuple[Version, int, bytes, bytes]] = []
                    for k, val in kvs:
                        k, val = bytes(k), bytes(val)
                        page.append((v, OP_SET, k, val))
                        self.logical_bytes += len(k) + len(val)
                        if self.engine is not None:
                            self._dbuf.append(v, OP_SET, k, val)
                    self.vmap.apply_batch(page)  # one index merge per page
                    rows_total += len(kvs)
                    if not more or not kvs:
                        break
                    b = bytes(kvs[-1][0]) + b"\x00"
                # change-feed handoff rides fetchKeys: the source
                # exports every overlapping feed's registration + retained
                # window at the fetch version; entries above it arrive
                # through this server's own tag pull, which is still gated
                # on _fetch_done — so registration lands before any capture
                # could miss.  Same retry discipline as the row pages.
                while True:
                    try:
                        exported = await self._fetch_src.fetch_feed_state(
                            self.shard.begin, self.shard.end, v)
                    except FdbError as err:
                        if err.retryable:
                            await asyncio.sleep(0.1)
                            continue
                        raise
                    self.feeds.install(exported)
                    break
        except BaseException as err:
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.fetchKeys.Error",
                             Tag=self.tag, Error=type(err).__name__)
            raise
        self._fetch_done.set()
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.fetchKeys.After",
                         Tag=self.tag, Rows=rows_total, Version=v)
        TraceEvent("FetchKeysComplete").detail("Tag", self.tag) \
            .detail("Rows", rows_total).detail("Version", v).log()

    async def _wait_fetched(self) -> None:
        if self._fetch_done.is_set():
            return
        from ..runtime.errors import FutureVersion
        try:
            await asyncio.wait_for(
                self._fetch_done.wait(),
                timeout=self.knobs.STORAGE_FUTURE_VERSION_WAIT)
        except asyncio.TimeoutError:
            raise FutureVersion() from None

    async def sample_split_key(self, begin: bytes, end: bytes) -> bytes | None:
        """Key splitting [begin, end) into halves by bytes — what the
        data distributor asks for (REF:fdbserver/StorageMetrics.actor.cpp
        splitMetrics).  None when the range has too few rows to split."""
        rows, _ = await self.get_latest_range(begin, end, limit=10_000)
        if len(rows) < 4:
            return None
        total = sum(len(k) + len(v) for k, v in rows)
        acc = 0
        for k, v in rows:
            acc += len(k) + len(v)
            if acc * 2 >= total:
                key = bytes(k)
                # never split at the boundaries themselves
                return key if begin < key < end else None
        return None

    # --- the update path (REF: storageserver.actor.cpp::update) ---

    async def _pull_loop(self) -> None:
        from ..runtime.errors import FdbError
        # a moved-in shard's snapshot fetch must fully land (at its
        # fetch version) BEFORE any pulled mutation above it applies:
        # under network clogging the pull otherwise outruns the stalled
        # fetch and violates the version-ordered apply invariant.  The
        # TLog retains the window — the reference buffers update
        # mutations during fetchKeys for the same reason
        # (REF:fdbserver/storageserver.actor.cpp fetchWaitingForVersion).
        # A FAILED fetch never completes this wait: the distributor
        # aborts the move and destroys this role.
        await self._fetch_done.wait()
        cursor = self.log_system.cursor(self.tag, self.version + 1)
        while True:
            try:
                reply = await cursor.next()
            except FdbError as e:
                # every live replica unreachable (partition/clog/kill):
                # back off and retry — the reference's peek cursor does
                # the same
                if e.retryable:
                    await asyncio.sleep(0.1)
                    continue
                raise
            kc = getattr(reply, "known_committed", 0)
            if kc > self.known_committed:
                self.known_committed = kc
                self._wake_committed_waiters()
            if not reply.entries and reply.end_version - 1 <= self.version:
                # no progress (e.g. the generation is locked but not yet
                # ended): poll gently instead of spinning
                await asyncio.sleep(self.knobs.TLOG_PEEK_RETRY)
                cursor.version = self.version + 1
                continue
            from ..runtime.buggify import buggify
            if buggify("storage_slow_pull"):
                # lagging storage: versions pile up, ratekeeper reacts,
                # peeks span generations after recoveries
                from ..runtime.rng import deterministic_random
                await asyncio.sleep(deterministic_random().random() * 0.1)
            # apply in bounded slices, yielding between them: a bulk
            # load's reply can carry 100k+ mutations and one synchronous
            # pass is a multi-100ms event-loop stall.  Versions are never
            # split across slices, so readers at any intermediate version
            # see a consistent prefix (the seed bumped per version too).
            entries = reply.entries
            cap = self.knobs.STORAGE_APPLY_CHUNK_MUTATIONS
            i = 0
            while i < len(entries):
                chunk = [entries[i]]
                nm = len(entries[i][1])
                i += 1
                while i < len(entries) and nm + len(entries[i][1]) <= cap:
                    chunk.append(entries[i])
                    nm += len(entries[i][1])
                    i += 1
                self._apply_batch(chunk)
                if i < len(entries):
                    await asyncio.sleep(0)
            # the memory-wall valve: a durability tick whose
            # engine commit drags (throttled disk) cannot spill from
            # inside its own await, so the PULL side sheds the retained
            # window to the side file whenever the budget is exceeded —
            # RSS stays bounded even while a commit is in flight
            if self._dbuf.needs_spill:
                await self._maybe_spill_dbuf()
            if reply.end_version - 1 > self.version:
                self._bump_version(reply.end_version - 1)
            if self.engine is None:
                # memory-only mode: nothing to persist, pop eagerly and
                # slide the MVCC window by forgetting (folding) history
                self.log_system.pop(self.tag, self.version + 1)
                floor = self.version - self.knobs.STORAGE_VERSION_WINDOW
                if floor > self.oldest_version:
                    self.oldest_version = floor
                    self.vmap.forget_before(floor)

    async def _durability_loop(self) -> None:
        """Migrate aged-out versions from the MVCC window into the engine
        (REF:fdbserver/storageserver.actor.cpp updateStorage): the window's
        floor is what becomes durable; newer versions stay memory-only,
        protected by the TLog, exactly like the reference."""
        from ..runtime.trace import TraceEvent
        while True:
            await asyncio.sleep(self.knobs.STORAGE_DURABILITY_LAG)
            if self._dbuf.needs_spill:
                await self._maybe_spill_dbuf()
            floor = self.version - self.knobs.STORAGE_VERSION_WINDOW
            if floor > self.durable_version:
                # O(slice): the packed ring bisects its version cursor;
                # nothing else in the buffer is touched.  The cursor only
                # advances AFTER the engine committed, so a failed tick
                # retries the identical slice.  Spilled frames at or
                # below the floor read back transparently (and a crc
                # failure raises into the retry below rather than
                # silently committing a short slice).
                try:
                    ops = await self._dbuf.peek_through(floor)
                except Exception as e:  # noqa: BLE001 — trace + retry
                    TraceEvent("StorageDurabilityError", severity=40).detail(
                        "Tag", self.tag).error(e).log()
                    continue
                try:
                    await self.engine.commit(ops, {
                        "durable_version": floor,
                        "tag": self.tag,
                        "shard": (self._meta_shard.begin,
                                  self._meta_shard.end),
                        # feed registrations ride the engine meta so a
                        # rebooted replica re-arms before TLog replay
                        "feeds": self.feeds.export_meta(),
                    })
                except Exception as e:
                    # disk trouble (ENOSPC, IO error): keep the buffer
                    # intact and retry next tick — losing the task would
                    # silently freeze durability and grow memory forever
                    TraceEvent("StorageDurabilityError", severity=40).detail(
                        "Tag", self.tag).error(e).log()
                    continue
                # the pop does side-file I/O since the disk spill (releasing
                # the spilled frames' dead prefix): disk trouble there
                # must not kill the task any more than in engine.commit
                # — the cursor didn't move, so the next tick re-peeks
                # and re-commits the identical slice (the documented
                # retry contract; engine re-commits are idempotent)
                try:
                    await self._dbuf.pop_through(floor)
                except Exception as e:  # noqa: BLE001 — retry next tick
                    TraceEvent("StorageDurabilityError", severity=40).detail(
                        "Tag", self.tag).error(e).log()
                    continue
                self.bytes_durable += ops.nbytes
                self.durable_version = floor
                self.oldest_version = floor
                self.vmap.drop_before(floor)  # engine authoritative <= floor
                # spill sealed feed segments BEFORE popping the TLog:
                # the pop drops their replay copies, so the side queue
                # must durably hold every sub-floor entry first — on
                # disk trouble the pop is withheld and the TLog keeps
                # the window until a later spill succeeds
                if self.feeds.feeds:
                    try:
                        await self.feeds.maybe_spill(floor)
                    except Exception as e:  # noqa: BLE001 — retry later
                        TraceEvent("ChangeFeedSpillError", severity=40) \
                            .detail("Tag", self.tag).error(e).log()
                        continue
                self.log_system.pop(self.tag, floor + 1)
            elif self.feeds.feeds:
                # idle tick: still release the side queue's popped
                # prefix, finish any previously-failed spill, and let
                # the withheld TLog pop catch up
                try:
                    await self.feeds.maybe_spill(self.durable_version)
                    self.log_system.pop(self.tag, self.durable_version + 1)
                except Exception as e:  # noqa: BLE001 — retry next tick
                    TraceEvent("ChangeFeedSpillError", severity=40) \
                        .detail("Tag", self.tag).error(e).log()
            # GC relinquished ranges (live-move handoffs): once the drop
            # version is STRICTLY below the durable floor, no legal read
            # can touch the range (reads at or below the drop version —
            # the only ones the fence allows — are too old), and the
            # narrowed meta shard excludes it after any reboot.  This
            # runs EVERY tick against the achieved floor, not only when
            # new data needed persisting: a server that just relinquished
            # its only hot range may never see another mutation, yet must
            # still shed the dropped rows.  A SEPARATE engine commit
            # AFTER oldest_version advances: a clear riding the main
            # batch would be observable by a still-legal history read
            # during the engine's internal awaits, before the floor moved.
            gc = [(v, b, e) for v, b, e in self._gc_pending
                  if v < self.oldest_version]
            if gc:
                try:
                    await self.engine.commit(
                        [(OP_CLEAR, b, e) for _v, b, e in gc], {
                            "durable_version": self.durable_version,
                            "tag": self.tag,
                            "shard": (self._meta_shard.begin,
                                      self._meta_shard.end),
                            # engines replace meta wholesale: omitting
                            # the feeds here would silently disarm every
                            # feed on the next reboot
                            "feeds": self.feeds.export_meta(),
                        })
                except Exception as e:   # noqa: BLE001 — retry next tick
                    TraceEvent("StorageDurabilityError", severity=40).detail(
                        "Tag", self.tag).error(e).log()
                    continue
                done = {(v, b, e) for v, b, e in gc}
                self._gc_pending = [t for t in self._gc_pending
                                    if t not in done]
                for _v, b, e in gc:
                    TraceEvent("StorageDroppedRangeGC").detail("Tag", self.tag) \
                        .detail("Begin", b).detail("End", e).log()

    def _get_latest(self, key: bytes) -> bytes | None:
        found, v = self.vmap.get2(key, self.vmap.latest_version)
        if found:
            return v
        return self.engine.get(key) if self.engine is not None else None

    def _drop_shard(self, version: Version, begin: bytes, end: bytes) -> None:
        """Relinquish [begin, end) as of ``version`` (live move handoff).

        ``self.shard`` (the boot-time range) keeps serving clips and
        history reads at or below the drop version; only ``_meta_shard``
        — what the durable meta records and the next boot declares —
        narrows, so a rebooted source refuses the moved range outright."""
        from ..runtime.errors import WrongShardServer
        from ..runtime.trace import TraceEvent
        self._dropped.append((version, begin, end))
        self._gc_pending.append((version, begin, end))
        ms = self._meta_shard
        if begin <= ms.begin and end >= ms.end:
            self._meta_shard = KeyRange(ms.begin, ms.begin)
        elif begin <= ms.begin < end < ms.end:
            self._meta_shard = KeyRange(end, ms.end)
        elif ms.begin < begin < ms.end <= end:
            self._meta_shard = KeyRange(ms.begin, begin)
        # approximate the stats handoff: the rows leave this server's
        # logical size (DD reads these for split decisions)
        dropped_bytes = 0
        for k, val in self.vmap.range_read(begin, end, version)[0]:
            dropped_bytes += len(k) + len(val)
        self.logical_bytes = max(0, self.logical_bytes - dropped_bytes)
        # watches anchored in the range can no longer fire here
        for key in [k for k in self._watches if begin <= k < end]:
            for _, fut in self._watches.pop(key):
                if not fut.done():
                    fut.set_exception(WrongShardServer())
        # feed handoff: a fully-relinquished feed fences at the drop
        # version (consumers re-route to the destination, which received
        # the retained window through fetch_feed_state); a partial drop
        # (split) excludes just the moved subrange so this server keeps
        # serving the keys it still owns
        self.feeds.fence(version, begin, end, remaining=self._meta_shard)
        TraceEvent("StorageShardDropped").detail("Tag", self.tag) \
            .detail("Begin", begin).detail("End", end) \
            .detail("Version", version).log()

    def _check_dropped(self, version: Version, begin: bytes,
                       end: bytes) -> None:
        """Refuse reads touching relinquished key space.

        Two fences compose: the in-memory drop list (exact handoff
        version, so reads at-or-below it still serve), and the boot-time
        shard bounds — narrowed drops persist via the engine meta, so a
        rebooted source with an empty drop list cannot silently serve a
        range it relinquished before the reboot (its engine may still
        hold the stale rows until cleanup)."""
        from ..runtime.errors import WrongShardServer
        if begin < self.shard.begin or end > self.shard.end:
            raise WrongShardServer()
        for dv, b, e in self._dropped:
            if version > dv and begin < e and b < end:
                raise WrongShardServer()

    def _apply(self, version: Version, mutations: list[Mutation]) -> None:
        """Single-version apply — thin wrapper over the batched path."""
        self._apply_batch([(version, mutations)])

    def _apply_batch(self,
                     entries: list[tuple[Version, MutationBatch]]) -> None:
        """Apply a whole TLog pull reply — every (version, mutations)
        pair — in ONE pass (REF: storageserver.actor.cpp::update applies
        a full peek reply per wait too).

        A packed ``MutationBatch`` of plain sets/clears with no watches
        armed takes the COLUMNAR fast path: the whole batch feeds
        ``vmap.apply_packed`` (param bytes sliced from the blob exactly
        once, no ``Mutation`` objects), the durability ring takes the
        batch as one zero-copy segment, and the byte accounting is O(1)
        off the blob length.  Everything else — atomics (read latest
        value), PRIVATE_DROP_SHARD (range-scan the handed-off rows),
        armed watches — falls back to lazy per-item decode; ops that
        observe state flush the pending run first, so they see exactly
        the sequential state."""
        if not entries:
            return
        t0 = time.perf_counter()
        # the trace-visible duration must come from the TRACE clock
        # (virtual under simulation): a wall-clock number in the JSONL
        # would break same-seed bit-identical sim output
        emit_debug = get_trace_log().min_severity <= Severity.DEBUG
        tt0 = get_trace_log().clock() if emit_debug else 0.0
        durable = self.engine is not None
        vops: list[tuple[Version, int, bytes, bytes]] = []
        nmut = 0

        def flush() -> None:
            nonlocal vops
            if vops:
                self.vmap.apply_batch(vops)
                vops = []

        for version, mutations in entries:
            if (isinstance(mutations, MutationBatch)
                    and mutations.simple_only and not self._watches):
                flush()
                nmut += len(mutations)
                self.bytes_input += mutations.nbytes
                self.logical_bytes += mutations.set_payload_bytes()
                self.heat.record_write_batch(mutations)
                self.vmap.apply_packed(version, mutations)
                if durable and b"\x01" in mutations.types:
                    self._mask_engine_rows(version, [
                        (m.param1, m.param2) for m in mutations
                        if m.type == MutationType.CLEAR_RANGE])
                if durable:
                    self._dbuf.extend_packed(version, mutations)
                if self.feeds.feeds:
                    # armed feeds retain zero-copy index slices of the
                    # SAME packed batch the apply path just consumed,
                    # clipped to this server's owned range
                    self.feeds.capture(version, mutations,
                                       shard=self._meta_shard)
                continue
            # feed capture on the lazy path retains the EFFECTIVE ops
            # (atomics resolved to the set/clear the engine stores) —
            # what a consumer replaying the feed must see
            fb = MutationBatchBuilder() if self.feeds.feeds else None
            for m in mutations:
                if m.type == MutationType.PRIVATE_DROP_SHARD:
                    flush()
                    self._drop_shard(version, m.param1, m.param2)
                    continue
                if m.type == MutationType.PRIVATE_FEED_REGISTER:
                    from ..rpc.wire import decode
                    try:
                        info = decode(m.param2)
                        self.feeds.register(m.param1, bytes(info["b"]),
                                            bytes(info["e"]), version)
                    except Exception as e:  # noqa: BLE001 — a corrupt
                        # marker must not take the whole pull loop (and
                        # every other feed) down with it
                        TraceEvent("BadFeedMarker", severity=30) \
                            .detail("Tag", self.tag).error(e).log()
                    if fb is None and self.feeds.feeds:
                        fb = MutationBatchBuilder()
                    continue
                if m.type == MutationType.PRIVATE_FEED_DESTROY:
                    self.feeds.destroy(m.param1)
                    continue
                if m.type == MutationType.PRIVATE_FEED_POP:
                    from ..rpc.wire import decode
                    try:
                        self.feeds.pop(m.param1, int(decode(m.param2)))
                    except Exception as e:  # noqa: BLE001 — see above
                        TraceEvent("BadFeedMarker", severity=30) \
                            .detail("Tag", self.tag).error(e).log()
                    continue
                nmut += 1
                self.bytes_input += len(m.param1) + len(m.param2)
                self.heat.record_write(m.param1,
                                       len(m.param1) + len(m.param2))
                if m.type == MutationType.SET_VALUE:
                    self.logical_bytes += len(m.param1) + len(m.param2)
                    vops.append((version, OP_SET, m.param1, m.param2))
                    if durable:
                        self._dbuf.append(version, OP_SET, m.param1, m.param2)
                    if fb is not None:
                        fb.add(OP_SET, m.param1, m.param2)
                    self._fire_watches(m.param1, m.param2)
                elif m.type == MutationType.CLEAR_RANGE:
                    vops.append((version, OP_CLEAR, m.param1, m.param2))
                    if durable:
                        flush()
                        self._mask_engine_rows(version,
                                               [(m.param1, m.param2)])
                        self._dbuf.append(version, OP_CLEAR, m.param1,
                                          m.param2)
                    if fb is not None:
                        fb.add(OP_CLEAR, m.param1, m.param2)
                    self._fire_watch_range(m.param1, m.param2)
                else:
                    # atomics resolve against the latest value (window or
                    # engine) and store as plain sets/clears downstream
                    flush()
                    existing = self._get_latest(m.param1)
                    new = apply_atomic(m.type, existing, m.param2)
                    if new is None:
                        end = m.param1 + b"\x00"
                        vops.append((version, OP_CLEAR, m.param1, end))
                        if durable:
                            self._dbuf.append(version, OP_CLEAR, m.param1,
                                              end)
                        if fb is not None:
                            fb.add(OP_CLEAR, m.param1, end)
                        self._fire_watches(m.param1, None)
                    else:
                        vops.append((version, OP_SET, m.param1, new))
                        if durable:
                            self._dbuf.append(version, OP_SET, m.param1, new)
                        if fb is not None:
                            fb.add(OP_SET, m.param1, new)
                        self._fire_watches(m.param1, new)
            if fb is not None and len(fb):
                self.feeds.capture(version, fb.finish(),
                                   shard=self._meta_shard)
        flush()
        self._bump_version(entries[-1][0])
        dt = time.perf_counter() - t0
        self.apply_stats.record("apply_batch", dt)
        self.apply_meter.add(nmut)
        if nmut > self.apply_batch_size_max:
            self.apply_batch_size_max = nmut
        # Apply-path correlation event: mutations carry no trace id (the
        # apply is asynchronous to every commit), so the analyzer joins a
        # sampled txn's commit VERSION against this batch's version range
        # instead.  DEBUG severity + the min_severity guard keep the hot
        # path free when nobody collects debug traces (the ≤5%
        # perf_smoke budget).
        if nmut and emit_debug:
            TraceEvent("StorageApplyDebug", severity=Severity.DEBUG) \
                .detail("Role", "StorageServer").detail("Tag", self.tag) \
                .detail("MinVersion", entries[0][0]) \
                .detail("MaxVersion", entries[-1][0]) \
                .detail("Mutations", nmut) \
                .detail("DurationMs",
                        round((get_trace_log().clock() - tt0) * 1e3, 3)) \
                .log()

    def _mask_engine_rows(self, version: Version,
                          ranges: list[tuple[bytes, bytes]]) -> None:
        """Tombstone, in the MVCC window at ``version``, every engine row
        in ``ranges`` that the window does not resolve at ``version``.
        Called right after the version's clears reached the window.  The
        window tombstones only keys it holds, and the engine keeps a
        cleared row until the clear itself is durable.  Without this, a
        read at or after the clear would serve that row (a key cold for
        longer than one window, or one the durability floor dropped from
        it).  A later set of the key in the same version is found and
        left alone."""
        vmap = self.vmap
        for b, e in ranges:
            for key, _ in self.engine.range(b, e):
                if not vmap.get2(key, version)[0]:
                    vmap.set(version, key, None)

    def _bump_version(self, version: Version) -> None:
        if version <= self.version:
            return
        self.version = version
        ready = [v for v in self._version_waiters if v <= version]
        for v in sorted(ready):
            for fut in self._version_waiters.pop(v):
                if not fut.done():
                    fut.set_result(None)
        if self._feed_waiters:
            self._wake_committed_waiters()

    def _feed_frontier(self) -> Version:
        """The newest version a feed stream may expose: applied AND known
        committed.  A server that never learned a committed floor (bare
        unit-test setups applying directly, no proxy pushes) serves the
        raw applied tip."""
        return min(self.version, self.known_committed) \
            if self.known_committed > 0 else self.version

    def _wake_committed_waiters(self) -> None:
        fr = self._feed_frontier()
        keep = []
        for target, fut in self._feed_waiters:
            if fr >= target:
                if not fut.done():
                    fut.set_result(None)
            else:
                keep.append((target, fut))
        self._feed_waiters = keep

    # --- read path ---

    async def _wait_for_version(self, version: Version) -> None:
        if version <= self.version:
            return
        fut = asyncio.get_running_loop().create_future()
        self._version_waiters.setdefault(version, []).append(fut)
        try:
            await asyncio.wait_for(
                fut, timeout=self.knobs.STORAGE_FUTURE_VERSION_WAIT)
        except asyncio.TimeoutError:
            raise FutureVersion() from None

    def _check_too_old(self, version: Version) -> None:
        if version < self.oldest_version:
            raise TransactionTooOld()

    async def get_value(self, key: bytes, version: Version) -> bytes | None:
        span_ctx = current_span()
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.read.Before",
                         Version=version, Tag=self.tag)
        try:
            await self._wait_fetched()
            await self._wait_for_version(version)
            self._check_too_old(version)
            self._check_dropped(version, key, key + b"\x00")
        except BaseException as e:
            # close the span: TooOld/FutureVersion are ROUTINE on
            # retried reads, and an unpaired .Before skews the analyzer
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.read.Error",
                             Version=version, Tag=self.tag,
                             Error=type(e).__name__)
            raise
        self.total_reads += 1
        self.heat.record_reads(1, key)
        found, v = self.vmap.get2(key, version)
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.read.After",
                         Version=version, Tag=self.tag)
        if found:
            return v
        # no window entry at or <= version: the engine's durable state
        # (exactly the window floor's state) is authoritative
        return self.engine.get(key) if self.engine is not None else None

    async def get_values(self, req) -> "GetValuesReply":
        """Batched point reads — the getValueQ shape with the per-key
        overhead amortized over the whole batch (
        REF:fdbserver/storageserver.actor.cpp getValueQ): ONE
        fetch/version wait, ONE too-old check, ONE read.Before/After
        span pair, ONE vmap probe pass and ONE engine descent serve
        every key.  Failures degrade per KEY via status codes in the
        reply (GV_*), so a single moved or too-old key never fails the
        batch RPC; batch-wide wait failures mark every key.  The
        request's keys are sorted (wire contract), which is what lets
        the shard/drop fences resolve as contiguous index runs and the
        engines descend once per leaf/block run."""
        from .data import (GV_FUTURE_VERSION, GV_MISSING, GV_TOO_OLD,
                           GV_WRONG_SHARD, GetValuesReply)
        span_ctx = current_span()
        n = len(req)
        version = req.version
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.read.Before",
                         Version=version, Tag=self.tag, Keys=n)
        batch_err = 0
        try:
            await self._wait_fetched()
            await self._wait_for_version(version)
        except FutureVersion:
            batch_err = GV_FUTURE_VERSION
        except BaseException as e:
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.read.Error",
                             Version=version, Tag=self.tag,
                             Error=type(e).__name__)
            raise
        if not batch_err and version < self.oldest_version:
            batch_err = GV_TOO_OLD
        if batch_err:
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.read.After",
                             Version=version, Tag=self.tag, Keys=n)
            return GetValuesReply.uniform(batch_err, n)
        keys = list(req.iter_keys())
        codes = bytearray(n)
        # shard-bound + relinquished-range fences: each fence marks a
        # contiguous run of the sorted batch (key k is outside
        # [shard.begin, shard.end) iff k < begin or k >= end — no key
        # sorts strictly between k and k+\x00)
        import bisect as _b
        for i in range(_b.bisect_left(keys, self.shard.begin)):
            codes[i] = GV_WRONG_SHARD
        for i in range(_b.bisect_left(keys, self.shard.end), n):
            codes[i] = GV_WRONG_SHARD
        for dv, db, de in self._dropped:
            if version > dv:
                for i in range(_b.bisect_left(keys, db),
                               _b.bisect_left(keys, de)):
                    codes[i] = GV_WRONG_SHARD
        values: list[bytes | None] = [None] * n
        missing: list[int] = []
        # fenced keys never reach the window/engine probes, and only
        # the keys actually SERVED count as reads (the scalar path's
        # accounting — a wrong_shard get_value raises before its
        # total_reads bump)
        live = [i for i in range(n) if not codes[i]]
        fenced = n - len(live)
        self.total_reads += len(live)
        if live:
            # one representative key per batch; the tracker's strided
            # reservoir accumulates variety across batches
            self.heat.record_reads(len(live), keys[live[len(live) // 2]])
        probe = self.vmap.get2_batch(
            keys if not fenced else [keys[i] for i in live], version)
        for i, (found, v) in zip(live, probe):
            if found:
                if v is None:           # tombstone at-or-below version
                    codes[i] = GV_MISSING
                else:
                    values[i] = v
            else:
                missing.append(i)
        if missing:
            if self.engine is not None:
                miss_keys = [keys[i] for i in missing]
                # device gather first: one vectorized
                # searchsorted over the mirrored key prefixes answers the
                # whole batch; None = take the engine path (below
                # threshold, stale mirror — identical results either way)
                got = None
                if self._device_reads is not None:
                    got = self._device_reads.get_batch(miss_keys)
                if got is None:
                    got = self.engine.get_batch(miss_keys)
                for i, v in zip(missing, got):
                    if v is None:
                        codes[i] = GV_MISSING
                    else:
                        values[i] = v
            else:
                for i in missing:
                    codes[i] = GV_MISSING
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.read.After",
                         Version=version, Tag=self.tag, Keys=n)
        return GetValuesReply.build(codes, values)

    async def get_latest_range(self, begin: bytes, end: bytes,
                               limit: int = 1000,
                               min_version: Version | None = None
                               ) -> tuple[list[tuple[bytes, bytes]], Version]:
        """Latest-applied-version scan — the recovery-time metadata read
        (txnStateStore materialization, REF:fdbserver/ApplyMetadataMutation
        .cpp): the controller reads ``\\xff`` configuration back through
        this without holding a read version, because it runs BEFORE the
        new epoch can hand any out.

        ``min_version``: wait until this replica has pulled through it
        first.  Recovery passes its recovery version — a metadata txn
        (lock, backup tag, configure) committed just before the crash is
        on the locked TLogs but maybe not yet applied here; reading a
        lagging snapshot would silently recover WITHOUT it (an unfenced
        primary after DR switchover, a disarmed backup stream)."""
        if min_version is not None:
            # plain poll (no future_version timeout): the caller bounds
            # the wait, and the locked generation keeps serving peeks so
            # the pull loop CAN catch up during recovery
            while self.version < min_version:
                await asyncio.sleep(0.05)
        b = max(begin, self.shard.begin)
        e = min(end, self.shard.end)
        if b >= e:
            return [], self.version
        rows, _ = await self.get_key_values(b, e, self.version, limit)
        return rows, self.version

    async def get_key_values(self, begin: bytes, end: bytes, version: Version,
                             limit: int = 0, reverse: bool = False,
                             byte_limit: int = 0
                             ) -> tuple[list[tuple[bytes, bytes]], bool]:
        span_ctx = current_span()
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.rangeRead.Before",
                         Version=version, Tag=self.tag)
        try:
            await self._wait_fetched()
            await self._wait_for_version(version)
            self._check_too_old(version)
            self._check_dropped(version, begin, end)
        except BaseException as e:
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.rangeRead.Error",
                             Version=version, Tag=self.tag,
                             Error=type(e).__name__)
            raise
        self.total_reads += 1
        self.heat.record_reads(1, max(begin, self.shard.begin))
        b = max(begin, self.shard.begin)
        e = min(end, self.shard.end)
        if b >= e:
            # still close the span: an unpaired .Before would skew the
            # analyzer's consecutive-pair segment stats
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.rangeRead.After",
                             Version=version, Tag=self.tag, Rows=0)
            return [], False
        if self.engine is None:
            result = self.vmap.range_read(b, e, version, limit, reverse,
                                          byte_limit)
        else:
            result = self._merged_range_read(b, e, version, limit, reverse,
                                             byte_limit)
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.rangeRead.After",
                         Version=version, Tag=self.tag, Rows=len(result[0]))
        return result

    def _merged_range_read(self, begin: bytes, end: bytes, version: Version,
                           limit: int, reverse: bool, byte_limit: int
                           ) -> tuple[list[tuple[bytes, bytes]], bool]:
        """Merge the MVCC window over the engine's durable state — the
        getKeyValuesQ read path when data spans memory and disk.

        ``more`` may be conservatively True when only invisible entries
        (tombstones / not-found chains) remain; the caller's next fetch
        then returns ([], False) — one wasted round trip, never a wrong
        result."""
        win = self.vmap.overlay_iter(begin, end, version, reverse)
        eng = self.engine.range(begin, end, reverse)
        out: list[tuple[bytes, bytes]] = []
        nbytes = 0
        w = next(win, None)
        g = next(eng, None)

        def before(a: bytes, b: bytes) -> bool:
            return a > b if reverse else a < b

        def emit(k: bytes, v: bytes) -> bool:
            nonlocal nbytes
            out.append((k, v))
            nbytes += len(k) + len(v)
            return bool((limit and len(out) >= limit)
                        or (byte_limit and nbytes >= byte_limit))

        while w is not None or g is not None:
            if w is not None and (g is None or not before(g[0], w[0])):
                wk, found, wv = w
                gval = None
                if g is not None and g[0] == wk:
                    gval = g[1]
                    g = next(eng, None)
                if found:
                    if wv is not None and emit(wk, wv):
                        return out, (next(win, None) is not None
                                     or g is not None)
                elif gval is not None:
                    # window has a chain but nothing <= version: durable
                    # state (the engine row) applies
                    if emit(wk, gval):
                        return out, (next(win, None) is not None
                                     or g is not None)
                w = next(win, None)
            else:
                if emit(g[0], g[1]):
                    return out, (w is not None or next(eng, None) is not None)
                g = next(eng, None)
        return out, False

    async def get_key_values_packed(self, req) -> "GetRangeReply":
        """Columnar range read — the getKeyValuesQ shape with the reply
        packed (PROTOCOL_VERSION 715).  Rows ship as one sorted
        key blob + LE cumulative u32 bounds and a value blob + bounds;
        a chunk that cannot be served refuses WHOLESALE with a per-chunk
        status byte (GV_TOO_OLD / GV_FUTURE_VERSION / GV_WRONG_SHARD)
        instead of raising, so the client's replica failover can
        distinguish a lagging replica from a moved range — the
        GetValuesReply discipline applied to ranges.  Result rows are
        byte-identical to ``get_key_values`` on the same arguments
        (tested on randomized workloads); only the extraction differs:
        the engine hands whole block/leaf runs to a run-wise MVCC
        overlay merge instead of the per-row generator walk."""
        from ..runtime.errors import WrongShardServer
        from .data import (GV_FUTURE_VERSION, GV_TOO_OLD, GV_WRONG_SHARD,
                           GetRangeReply)
        span_ctx = current_span()
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.rangeRead.Before",
                         Version=req.version, Tag=self.tag)
        status = 0
        try:
            await self._wait_fetched()
            await self._wait_for_version(req.version)
        except FutureVersion:
            status = GV_FUTURE_VERSION
        except BaseException as e:
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.rangeRead.Error",
                             Version=req.version, Tag=self.tag,
                             Error=type(e).__name__)
            raise
        if not status and req.version < self.oldest_version:
            status = GV_TOO_OLD
        if not status:
            try:
                self._check_dropped(req.version, req.begin, req.end)
            except WrongShardServer:
                status = GV_WRONG_SHARD
        if status:
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.rangeRead.After",
                             Version=req.version, Tag=self.tag, Rows=0,
                             Status=status)
            return GetRangeReply.refuse(status)
        self.total_reads += 1
        self.heat.record_reads(1, max(req.begin, self.shard.begin))
        b = max(req.begin, self.shard.begin)
        e = min(req.end, self.shard.end)
        if b >= e:
            rows: list = []
            more = False
        elif req.reverse:
            # reverse scans keep the row-wise merge (the selector-
            # resolution shape, never the scan-heavy one); the reply
            # still rides the packed columns
            rows, more = (self.vmap.range_read(b, e, req.version,
                                               req.limit, True,
                                               req.byte_limit)
                          if self.engine is None else
                          self._merged_range_read(b, e, req.version,
                                                  req.limit, True,
                                                  req.byte_limit))
        elif self.engine is None:
            rows, more = self.vmap.range_rows(b, e, req.version,
                                              req.limit, req.byte_limit)
        else:
            rows, more = self._merged_range_packed(b, e, req.version,
                                                   req.limit,
                                                   req.byte_limit)
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.rangeRead.After",
                         Version=req.version, Tag=self.tag, Rows=len(rows))
        return GetRangeReply.from_rows(rows, more)

    def _merged_range_packed(self, begin: bytes, end: bytes,
                             version: Version, limit: int, byte_limit: int
                             ) -> tuple[list[tuple[bytes, bytes]], bool]:
        """Run-wise MVCC-overlay-over-engine merge for FORWARD packed
        range reads: the engine yields whole block/leaf runs
        (``range_runs``), the — usually small — overlay bisects into
        each run's span, and untouched run segments are emitted as bulk
        list slices instead of the per-row ``next(win)/next(eng)``
        generator walk of ``_merged_range_read``.  Overlay entries
        resolve lazily (``get2`` only on consumption), so a
        limit-bounded scan probes no more chains than the legacy path.

        ``more`` is conservatively True whenever a limit cut the scan —
        the same contract ``_merged_range_read`` already documents (a
        trailing stretch of tombstones costs the caller one empty
        fetch, never a wrong result).  The byte budget is enforced
        INSIDE every bulk push (the whole-batch sum is one C-speed
        transpose; the per-row scan runs only at the crossing), never
        deferred to a post-hoc cut — a scan whose chunk row limit grew
        large over small rows and then hits a huge-value region must
        stop extracting at the budget, exactly like the legacy emit,
        not materialize limit × max-row bytes first."""
        import bisect as _b
        vmap = self.vmap
        ov_keys = vmap.overlay_keys(begin, end)
        get2 = vmap.get2
        out: list[tuple[bytes, bytes]] = []
        nbytes = 0
        hit = False

        def first(r):
            return r[0]

        def push(rows) -> bool:
            """Bulk-append ``rows``, enforcing limit/byte_limit exactly
            like the legacy emit (the crossing row is included)."""
            nonlocal nbytes, hit
            if not rows:
                return hit
            if limit:
                room = limit - len(out)
                if len(rows) >= room:
                    rows = rows[:room]
                    hit = True
            if byte_limit:
                ks, vs = zip(*rows)      # C-speed transpose + len sums
                total = sum(map(len, ks)) + sum(map(len, vs))
                if nbytes + total < byte_limit:
                    nbytes += total       # whole batch fits: no row scan
                else:
                    take = len(rows)
                    for idx, r in enumerate(rows):
                        nbytes += len(r[0]) + len(r[1])
                        if nbytes >= byte_limit:
                            take = idx + 1
                            hit = True
                            break
                    if take < len(rows):
                        rows = rows[:take]
            out.extend(rows)
            return hit

        oi, on = 0, len(ov_keys)
        for run in self.engine.range_runs(begin, end):
            if hit:
                return out, True
            if oi >= on or ov_keys[oi] > run[-1][0]:
                # no overlay key lands in this run's span: the whole
                # engine run is the merged result — one bulk append
                if push(run):
                    return out, True
                continue
            pos, rn = 0, len(run)
            run_last = run[-1][0]
            while oi < on and ov_keys[oi] <= run_last:
                wk = ov_keys[oi]
                oi += 1
                cut = _b.bisect_left(run, wk, pos, rn, key=first)
                if cut > pos and push(run[pos:cut]):
                    return out, True
                pos = cut
                dup = pos < rn and run[pos][0] == wk
                found, wv = get2(wk, version)
                if found:
                    # window wins: emit its value (a tombstone emits
                    # nothing) and skip the superseded engine row
                    if dup:
                        pos += 1
                    if wv is not None and push([(wk, wv)]):
                        return out, True
                elif dup:
                    # chain exists but nothing <= version: the durable
                    # engine row is authoritative
                    if push([run[pos]]):
                        return out, True
                    pos += 1
            if pos < rn and push(run[pos:]):
                return out, True
        # engine exhausted: the overlay's tail may still hold live rows
        while not hit and oi < on:
            wk = ov_keys[oi]
            oi += 1
            found, wv = get2(wk, version)
            if found and wv is not None:
                push([(wk, wv)])
        return out, hit

    async def get_key(self, req) -> "GetKeyReply":
        """Packed selector resolution — the getKeyQ shape (
        PROTOCOL_VERSION 716): find the ``req.offset``-th live row of
        this server's clip of [begin, end) at ``req.version`` (from the
        end when ``req.reverse``) and reply with ONE key plus the live
        count, instead of shipping ``offset`` full rows through the
        range path.  Rows are located by the same merged extraction the
        packed range read uses (engine block runs + lazy MVCC overlay
        forward; the row-wise reverse merge backward), so the resolved
        key is byte-identical to what a range row-probe returned.
        Refusals ride the GV_* status byte wholesale, the GetRangeReply
        discipline."""
        from ..runtime.errors import WrongShardServer
        from .data import (GV_FUTURE_VERSION, GV_TOO_OLD, GV_WRONG_SHARD,
                           GetKeyReply)
        span_ctx = current_span()
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.getKey.Before",
                         Version=req.version, Tag=self.tag)
        status = 0
        try:
            await self._wait_fetched()
            await self._wait_for_version(req.version)
        except FutureVersion:
            status = GV_FUTURE_VERSION
        except BaseException as e:
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.getKey.Error",
                             Version=req.version, Tag=self.tag,
                             Error=type(e).__name__)
            raise
        if not status and req.version < self.oldest_version:
            status = GV_TOO_OLD
        if not status:
            try:
                self._check_dropped(req.version, req.begin, req.end)
            except WrongShardServer:
                status = GV_WRONG_SHARD
        if status:
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.getKey.After",
                             Version=req.version, Tag=self.tag,
                             Status=status)
            return GetKeyReply(status, 0, b"")
        self.total_reads += 1
        self.heat.record_reads(1, max(req.begin, self.shard.begin))
        b = max(req.begin, self.shard.begin)
        e = min(req.end, self.shard.end)
        n = max(1, req.offset)
        if b >= e:
            rows: list = []
        elif req.reverse:
            rows = (self.vmap.range_read(b, e, req.version, n, True, 0)
                    if self.engine is None else
                    self._merged_range_read(b, e, req.version, n,
                                            True, 0))[0]
        elif self.engine is None:
            rows = self.vmap.range_rows(b, e, req.version, n, 0)[0]
        else:
            rows = self._merged_range_packed(b, e, req.version, n, 0)[0]
        count = len(rows)
        key = bytes(rows[-1][0]) if count >= n else b""
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.getKey.After",
                         Version=req.version, Tag=self.tag, Count=count)
        return GetKeyReply(0, count, key)

    async def scrub_page(self, req) -> "ScrubPageReply":
        """Paged shard checksums — the consistency-scan read shape
        (PROTOCOL_VERSION 718): digest this server's clip of
        [begin, end) at a pinned version, one 8-byte blake2b per
        ``page_rows`` live rows, at most ``max_pages`` pages per call.

        Rows come off the SAME extraction the packed range read uses
        (engine block runs + lazy MVCC overlay forward merge), and each
        page hashes in three bulk updates — length column, key blob,
        value blob — so the digest pass never runs per-row Python
        frames beyond the shared transpose.  Pages cut on LOGICAL row
        count, so replicas running different engines (or none) page
        identically over identical data; any replica-visible divergence
        lands in some page's digest.  Refusals (too-old / future /
        moved range) ride the GV_* status byte WHOLESALE — a refusal
        tells the scrubber to re-pin or re-route, never that replicas
        diverge.  Scrub reads deliberately skip the read counters and
        the heat reservoir: the audit plane must not steer DD's heat
        policy or the ratekeeper."""
        import hashlib
        from ..runtime.errors import WrongShardServer
        from .data import (GV_FUTURE_VERSION, GV_TOO_OLD, GV_WRONG_SHARD,
                           ScrubPageReply, _NATIVE_LE, _array)
        span_ctx = current_span()
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.scrubPage.Before",
                         Version=req.version, Tag=self.tag)
        status = 0
        try:
            await self._wait_fetched()
            await self._wait_for_version(req.version)
        except FutureVersion:
            status = GV_FUTURE_VERSION
        except BaseException as e:
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.scrubPage.Error",
                             Version=req.version, Tag=self.tag,
                             Error=type(e).__name__)
            raise
        if not status and req.version < self.oldest_version:
            status = GV_TOO_OLD
        if not status:
            try:
                self._check_dropped(req.version, req.begin, req.end)
            except WrongShardServer:
                status = GV_WRONG_SHARD
        if status:
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.scrubPage.After",
                             Version=req.version, Tag=self.tag, Pages=0,
                             Status=status)
            return ScrubPageReply.refuse(status)
        b = max(req.begin, self.shard.begin)
        e = min(req.end, self.shard.end)
        page_rows = max(1, req.page_rows)
        limit = page_rows * max(1, req.max_pages)
        if b >= e:
            rows: list = []
            more = False
        elif self.engine is None:
            rows, more = self.vmap.range_rows(b, e, req.version, limit, 0)
        else:
            rows, more = self._merged_range_packed(b, e, req.version,
                                                   limit, 0)
        pages: list[tuple[bytes, int, bytes]] = []
        for i in range(0, len(rows), page_rows):
            chunk = rows[i:i + page_rows]
            if more and len(chunk) < page_rows:
                # a partial page with rows beyond it cannot digest
                # stably (the next call re-reads those rows into a
                # differently-aligned page) — resume from the last FULL
                # page instead.  Unreachable with byte_limit=0 (the row
                # limit is a page multiple); kept as a contract guard.
                break
            ks = [r[0] for r in chunk]
            vs = [r[1] for r in chunk]
            h = hashlib.blake2b(digest_size=8)
            lens = _array("I", map(len, ks))
            lens.extend(map(len, vs))
            if not _NATIVE_LE:
                lens.byteswap()
            h.update(lens.tobytes())
            h.update(b"".join(ks))
            h.update(b"".join(vs))
            pages.append((bytes(chunk[-1][0]), len(chunk), h.digest()))
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.scrubPage.After",
                         Version=req.version, Tag=self.tag,
                         Pages=len(pages))
        return ScrubPageReply.from_pages(pages, bool(more and pages))

    def corrupt_for_test(self, key: bytes, value: bytes) -> None:
        """TEST-ONLY bit-rot injection: apply a divergent row to THIS
        replica alone, bypassing the log system — in-window at the
        current version, so both the digest pass and the bisect read
        observe the same wrong row.  Nothing in the product calls
        this; the scrub tests and the perf_smoke scrub stage use it to
        prove a single flipped row is caught key-exactly."""
        self._apply(self.version, [Mutation.set(key, value)])

    # --- change feeds (REF: storageserver.actor.cpp changeFeedStreamQ) ---

    async def change_feed_stream(self, req) -> ChangeFeedStreamReply:
        """One long-poll of a feed cursor: every retained entry of the
        feed at versions in [req.begin_version, reply.end_version), in
        version order.  An empty reply with an advanced end_version is
        the heartbeat that lets a consumer prove absence-of-data for a
        version range and resume exactly-once after a failover.  Spans:
        sampled client contexts propagate; otherwise a deterministic
        1-in-N server-side root covers streaming consumers that never
        run transactions."""
        from ..runtime.errors import (ChangeFeedNotRegistered,
                                      ChangeFeedPopped, WrongShardServer)
        span_ctx = current_span()
        if span_ctx is None:
            span_ctx = self._server_sampler.root(
                self.knobs.SERVER_SPAN_SAMPLE)
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.changeFeedStream.Before",
                         Feed=req.feed_id, Begin=req.begin_version,
                         Tag=self.tag)
        self.feeds.streams_served += 1
        try:
            await self._wait_fetched()
            f = self.feeds.feeds.get(req.feed_id)
            if f is None:
                raise ChangeFeedNotRegistered()
            if f.fence is not None and req.begin_version > f.fence:
                # range relinquished: the destination holds the window
                raise WrongShardServer()
            if req.begin_version <= f.popped_version:
                raise ChangeFeedPopped()
            if req.begin_version > self._feed_frontier():
                # bounded long-poll for COMMITTED progress; a quiet tag
                # returns an empty heartbeat instead of parking forever
                fut = asyncio.get_running_loop().create_future()
                self._feed_waiters.append((req.begin_version, fut))
                try:
                    await asyncio.wait_for(
                        fut, timeout=self.knobs.CHANGE_FEED_POLL_WAIT)
                except asyncio.TimeoutError:
                    pass
                finally:
                    # reclaim the parked slot on timeout AND on
                    # cancellation (a disconnecting consumer): repeated
                    # polls on a quiet tag must not grow the list (a
                    # slot already removed by the wake pass filters as
                    # a no-op)
                    self._feed_waiters = [
                        (t2, f2) for t2, f2 in self._feed_waiters
                        if f2 is not fut]
            tip = self._feed_frontier()
            limit = req.byte_limit or self.knobs.CHANGE_FEED_STREAM_BYTES
            try:
                entries, truncated = await self.feeds.read(
                    req.feed_id, req.begin_version, limit, tip)
                ranges = self.feeds.serving_ranges(req.feed_id,
                                                   self._meta_shard)
            except KeyError:
                # destroyed between the fence check and the spill read
                raise ChangeFeedNotRegistered() from None
        except BaseException as e:
            self.spans.event("TransactionDebug", span_ctx,
                             "StorageServer.changeFeedStream.Error",
                             Feed=req.feed_id, Tag=self.tag,
                             Error=type(e).__name__)
            raise
        end = (truncated + 1) if truncated is not None else tip + 1
        self.spans.event("TransactionDebug", span_ctx,
                         "StorageServer.changeFeedStream.After",
                         Feed=req.feed_id, Tag=self.tag,
                         Entries=len(entries), End=end)
        return ChangeFeedStreamReply(entries, end, f.popped_version, ranges)

    async def fetch_feed_state(self, begin: bytes, end: bytes,
                               version: Version) -> list:
        """Feed half of the fetchKeys handoff: export every overlapping
        feed's registration + retained window at or below ``version``
        for a move destination (REF:fdbserver/storageserver.actor.cpp
        fetchChangeFeedApplier)."""
        return await self.feeds.handoff(begin, end, version)

    # --- watches (REF: storageserver.actor.cpp watchValueQ) ---

    async def watch_value(self, key: bytes, value: bytes | None,
                          version: Version) -> None:
        """Completes when the key's value differs from ``value``."""
        await self._wait_for_version(version)
        current = self._get_latest(key)
        if current != value:
            return
        fut = asyncio.get_running_loop().create_future()
        self._watches.setdefault(key, []).append((value, fut))
        await fut

    def _fire_watches(self, key: bytes, new_value: bytes | None) -> None:
        ws = self._watches.pop(key, None)
        if not ws:
            return
        keep = []
        for expected, fut in ws:
            if new_value != expected:
                if not fut.done():
                    fut.set_result(None)
            else:
                keep.append((expected, fut))
        if keep:
            self._watches[key] = keep

    def _fire_watch_range(self, begin: bytes, end: bytes) -> None:
        for key in [k for k in self._watches if begin <= k < end]:
            self._fire_watches(key, None)
