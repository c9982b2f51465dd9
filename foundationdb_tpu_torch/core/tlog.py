"""The transaction log (TLog) role — the durability point of every commit.

Reference: REF:fdbserver/TLogServer.actor.cpp — commits arrive as tagged
message sets at a version; each storage server "peeks" only its tag and
"pops" versions it has made durable.  Version ordering across proxies is
enforced the same way as the resolver: a push for (prev_version, version)
waits until prev_version is the log's tip.

This first implementation keeps messages in memory (the sim-correctness
target); the DiskQueue-backed durable variant plugs in behind the same
push/peek/pop surface (see storage/disk_queue.py once durability lands).
"""

from __future__ import annotations

import asyncio
import bisect
import dataclasses

from ..runtime.knobs import Knobs
from ..runtime.span import SpanSink, current_span
from .data import MutationBatch, Version, as_mutation_batch

Tag = int


class _TagStore:
    """One tag's retained messages, version-indexed.

    ``versions`` is ascending, aligned with ``entries``; pops advance
    ``start`` (amortized trim) so peek is O(log n + result) instead of the
    old linear rescan of the whole retained list.  ``spilled_below`` marks
    the in-memory floor: older entries were evicted to the DiskQueue and
    are re-read on demand (spill-by-reference,
    REF:fdbserver/TLogServer.actor.cpp).
    """

    __slots__ = ("versions", "entries", "sizes", "start", "mem_bytes",
                 "spilled_below")

    def __init__(self) -> None:
        self.versions: list[Version] = []
        self.entries: list[MutationBatch] = []
        self.sizes: list[int] = []
        self.start = 0
        self.mem_bytes = 0
        self.spilled_below: Version = 0

    def append(self, version: Version, msgs: MutationBatch, nbytes: int) -> None:
        self.versions.append(version)
        self.entries.append(msgs)
        self.sizes.append(nbytes)
        self.mem_bytes += nbytes

    def slice_from(self, begin: Version) -> list[tuple[Version, MutationBatch]]:
        i = max(self.start, bisect.bisect_left(self.versions, begin))
        return list(zip(self.versions[i:], self.entries[i:]))

    def pop_below(self, version: Version) -> None:
        i = bisect.bisect_left(self.versions, version)
        if i > self.start:
            self.mem_bytes -= sum(self.sizes[self.start:i])
            self.start = i
        if self.start > 64 and self.start * 2 > len(self.versions):
            del self.versions[:self.start]
            del self.entries[:self.start]
            del self.sizes[:self.start]
            self.start = 0

    def evict_below(self, version: Version) -> int:
        """Spill: drop in-memory entries < version (they stay in the disk
        queue); returns bytes freed."""
        i = bisect.bisect_left(self.versions, version)
        if i <= self.start:
            self.spilled_below = max(self.spilled_below, version)
            return 0
        freed = sum(self.sizes[self.start:i])
        del self.versions[:i]
        del self.entries[:i]
        del self.sizes[:i]
        self.start = 0
        self.mem_bytes -= freed
        self.spilled_below = max(self.spilled_below, version)
        return freed


@dataclasses.dataclass
class TLogPushRequest:
    """TLogCommitRequest: messages grouped by destination tag.

    Values are packed ``MutationBatch``es on the wire (PROTOCOL_VERSION
    712); a bare ``list[Mutation]`` is still accepted at ``push`` for
    sidecar producers and tests and is packed at the boundary.

    ``known_committed`` is the pushing proxy's fully-acked frontier
    (REF:fdbserver/TLogServer.actor.cpp knownCommittedVersion): every
    version at or below it was acked by EVERY hosting log of an earlier
    batch.  It rides every push — real and empty — so consumers that
    must never observe a possibly-unacked version (change-feed
    heartbeats) have a committed floor to clamp against."""
    prev_version: Version
    version: Version
    messages: dict[Tag, MutationBatch]
    known_committed: Version = 0


@dataclasses.dataclass
class TLogPeekReply:
    entries: list[tuple[Version, MutationBatch]]
    end_version: Version       # caller has everything < end_version for this tag
    # the serving log's known-committed frontier: entries above it MAY
    # still be clamped out by a recovery (unacked suffix) — change-feed
    # heartbeats must not advance a consumer past it
    known_committed: Version = 0


class TLog:
    def __init__(self, knobs: Knobs, epoch_begin_version: Version = 0,
                 queue=None) -> None:
        self.knobs = knobs
        self.version: Version = epoch_begin_version
        # fully-acked frontier learned from proxy pushes (the epoch's
        # begin version is committed by recovery's definition)
        self.known_committed: Version = epoch_begin_version
        self.queue = queue                      # DiskQueue when durable
        self.path: str | None = None            # backing file when durable
        self._frame_ends: list[tuple[Version, int]] = []  # for pop_to + spill reads
        self._hosted: set[Tag] = set()          # tags ever pushed here
        self._tag_tip: dict[Tag, Version] = {}  # highest version pushed per tag
        self._log: dict[Tag, _TagStore] = {}
        self._poppable: dict[Tag, Version] = {}
        self._push_waiters: dict[Version, list[asyncio.Future]] = {}
        self._peek_waiters: list[asyncio.Future] = []
        self._pop_task: asyncio.Task | None = None
        self._pop_target = 0
        self.locked = False          # generation locked by recovery
        self.total_pushes = 0
        self.total_bytes = 0
        # CommitDebug span events for sampled pushes (wire-propagated)
        self.spans = SpanSink("TLog")
        self._msource = None

    @classmethod
    async def open(cls, knobs: Knobs, fs, path: str,
                   epoch_begin_version: Version = 0) -> "TLog":
        """Open a durable TLog, replaying surviving records (the DiskQueue
        recovery path of REF:fdbserver/TLogServer.actor.cpp).  A torn tail
        from a crash is discarded — exactly the unfsynced suffix."""
        from ..rpc.wire import decode
        from ..storage.disk_queue import DiskQueue
        f = fs.open(path)
        queue, frames = await DiskQueue.open(f)
        tlog = cls(knobs, epoch_begin_version, queue)
        tlog.path = path            # for worker-side file GC on destroy
        for frame, end in frames:
            rec = decode(frame)
            version = rec["v"]
            for tag, msgs in rec["m"].items():
                # new frames hold packed MutationBatches (nbytes O(1));
                # frames written before the 712 format hold Mutation
                # lists and pack once here — recovery equivalence across
                # the format change
                msgs = as_mutation_batch(msgs)
                nbytes = msgs.nbytes
                tlog._store(tag).append(version, msgs, nbytes)
                tlog._hosted.add(tag)
                tlog._tag_tip[tag] = max(tlog._tag_tip.get(tag, 0), version)
                tlog.total_bytes += nbytes
            tlog.version = max(tlog.version, version)
            tlog._frame_ends.append((version, end))
        # the durable tip may exceed the surviving frames' versions:
        # popped frames are gone but their pushes WERE acked (the header
        # meta carries the tip so recovery versions never regress below
        # storage durability)
        tlog.version = max(tlog.version, queue.meta)
        return tlog

    def _store(self, tag: Tag) -> _TagStore:
        st = self._log.get(tag)
        if st is None:
            st = self._log[tag] = _TagStore()
        return st

    @property
    def mem_bytes(self) -> int:
        return sum(st.mem_bytes for st in self._log.values())

    def _popped_frontier(self) -> Version:
        """The slowest hosted tag's pop floor — how far behind durability
        the laggiest storage consumer of this log runs (0 until every
        hosted tag has popped at least once)."""
        if not self._hosted:
            return 0
        return min(self._poppable.get(t, 0) for t in self._hosted)

    async def metrics(self) -> dict:
        """Queue sample for the Ratekeeper (TLogQueuingMetrics analog).
        Durable logs also publish their disk's decayed latency +
        degraded flag (the gray-failure signal — the TLog fsyncs
        on every commit, so a stalling disk shows up here first)."""
        from ..runtime.profiler import stall_metrics
        from ..runtime.span import process_counters
        health = getattr(getattr(self.queue, "file", None), "health", None)
        return {
            "queue_bytes": self.queue.bytes_used if self.queue is not None else 0,
            "mem_bytes": self.mem_bytes,
            "version": self.version,
            "known_committed": self.known_committed,
            "popped": self._popped_frontier(),
            "locked": self.locked,
            **(health.snapshot() if health is not None else {}),
            **self.spans.counters(),
            **stall_metrics(),
            **process_counters(),
        }

    def metrics_source(self):
        """This role's registration in the per-worker MetricsRegistry: the
        log's version frontiers (tip / known-committed /
        popped floor) and queue depths, recorded every interval — the
        TLog half of the durability-lag flight record (a growing
        tip-minus-popped gap IS a storage consumer falling behind)."""
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("TLog")
            s.gauge("Version", lambda: self.version)
            s.gauge("KnownCommitted", lambda: self.known_committed)
            s.gauge("Popped", lambda: self._popped_frontier())
            s.gauge("QueueBytes",
                    lambda: self.queue.bytes_used
                    if self.queue is not None else 0)
            s.gauge("MemBytes", lambda: self.mem_bytes)
            s.gauge("TotalPushes", lambda: self.total_pushes)
            s.gauge("TotalBytes", lambda: self.total_bytes)
            s.gauge("Locked", lambda: int(self.locked))
            self._msource = s
        return self._msource

    async def _wait_for_version(self, prev_version: Version) -> None:
        if self.version >= prev_version:
            return
        fut = asyncio.get_running_loop().create_future()
        self._push_waiters.setdefault(prev_version, []).append(fut)
        await fut

    async def lock(self) -> Version:
        """Stop accepting pushes and report the tip — TLogLockResult in the
        reference's recovery (REF:fdbserver/TLogServer.actor.cpp
        tLogLock): the old generation is frozen so the recovery version
        can be computed from stable tips.  Peeks and pops still work;
        blocked peek long-polls are woken so cursors can roll over."""
        from ..runtime.trace import TraceEvent
        if not self.locked:
            self.locked = True
            TraceEvent("TLogLocked").detail("Tip", self.version).log()
            for fut in self._peek_waiters:
                if not fut.done():
                    fut.set_result(None)
            self._peek_waiters.clear()
            # pushes already parked on the version chain will never be
            # satisfied by a locked log; fail them out
            for futs in self._push_waiters.values():
                for fut in futs:
                    if not fut.done():
                        from ..runtime.errors import TLogStopped
                        fut.set_exception(TLogStopped())
            self._push_waiters.clear()
        return self.version

    async def push(self, req: TLogPushRequest) -> Version:
        """Append and make durable; returns the version once fsync'd.

        In-memory engine: durability is immediate.  The version-ordering
        wait still applies so peeks never observe gaps.
        """
        span_ctx = current_span()
        self.spans.event("CommitDebug", span_ctx, "TLog.push.Before",
                         Version=req.version)
        try:
            return await self._push_impl(req, span_ctx)
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            # TLogStopped is ROUTINE during recovery; every .Before
            # must close or the analyzer's pair stats skew
            self.spans.event("CommitDebug", span_ctx, "TLog.push.Error",
                             Version=req.version, Error=type(e).__name__)
            raise

    async def _push_impl(self, req: TLogPushRequest, span_ctx) -> Version:
        if self.locked:
            from ..runtime.errors import TLogStopped
            raise TLogStopped()
        if req.known_committed > self.known_committed:
            self.known_committed = req.known_committed
        await self._wait_for_version(req.prev_version)
        if self.locked:
            from ..runtime.errors import TLogStopped
            raise TLogStopped()
        if req.version <= self.version:
            # duplicate push: a proxy retrying after an ambiguous result
            # (RequestMaybeDelivered / chain repair) re-sends a version this
            # log already holds.  Re-appending would make peeks serve the
            # version twice and atomic ops apply twice on this replica's
            # consumers — ack idempotently instead (a version's content is
            # deterministic for its batch, so the stored copy is identical).
            self.total_pushes += 1
            self.spans.event("CommitDebug", span_ctx, "TLog.push.After",
                             Version=req.version, Duplicate=True)
            return self.version
        # normalize IN PLACE so the DiskQueue frame below stores the
        # packed form too — appends, spill re-reads, and recovery all
        # share one encode done at (or before) the proxy
        messages = req.messages
        for tag, msgs in messages.items():
            if not isinstance(msgs, MutationBatch):
                messages[tag] = msgs = as_mutation_batch(msgs)
            if msgs:
                nbytes = msgs.nbytes
                self._store(tag).append(req.version, msgs, nbytes)
                self._hosted.add(tag)
                self._tag_tip[tag] = max(self._tag_tip.get(tag, 0),
                                         req.version)
                self.total_bytes += nbytes
        if self.queue is not None:
            # transient disk errors (the sim's injected IoError, a real
            # EIO) retry in place with backoff instead of failing the
            # push RPC per glitch — the push is tracked so a
            # commit-side retry can never append the frame twice (a
            # duplicate frame would replay the version twice after a
            # reboot).  DiskCorrupt is NOT retried: committed-data
            # damage must surface, not spin.
            from ..runtime.errors import IoError
            pushed = not messages
            attempt = 0
            while True:
                try:
                    if not pushed:
                        from ..rpc.wire import encode
                        end = await self.queue.push(
                            encode({"v": req.version, "m": messages}))
                        self._frame_ends.append((req.version, end))
                        pushed = True
                    # the fsync that makes commits durable; the tip
                    # rides the header so a reopened log still reports
                    # it after pops AND after idle periods of frameless
                    # (empty-batch) versions — either way a reboot must
                    # never report a tip below what storage has durably
                    # applied
                    await self.queue.commit(meta=req.version)
                    break
                except IoError as e:
                    attempt += 1
                    if attempt >= 8:
                        raise
                    from ..runtime.trace import TraceEvent
                    TraceEvent("TLogDiskError", severity=30) \
                        .detail("Version", req.version) \
                        .detail("Attempt", attempt).error(e).log()
                    await asyncio.sleep(0.01 * attempt)
            if self.locked:
                # lock() captured the tip while we were waiting on disk: the
                # recovery version excludes this push, so acking it would
                # lose an acked commit to the generation clamp.  The frame
                # is on disk but never acked — the client sees an ambiguous
                # result, which discarding satisfies.  This applies to
                # frameless (empty-message) pushes too: the commit's data
                # may live on OTHER logs, and acking here lets the proxy
                # ack a client while this log's lock-reported tip already
                # clamps the generation below the version.
                from ..runtime.errors import TLogStopped
                raise TLogStopped()
        from ..runtime.buggify import buggify
        from ..runtime.rng import deterministic_random
        if buggify("tlog_slow_commit"):
            # rare fsync stall: pushes ack late, version chains back up
            await asyncio.sleep(deterministic_random().random() * 0.05)
        self.version = req.version
        self.total_pushes += 1
        if buggify("tlog_early_spill") and self.queue is not None:
            # force the spill path long before the threshold would
            for st_ in self._log.values():
                if len(st_.versions) - st_.start > 4:
                    st_.evict_below(min(st_.versions[st_.start + 2],
                                        self.version))
        self._maybe_spill()
        ready = [v for v in self._push_waiters if v <= req.version]
        for v in sorted(ready):
            for fut in self._push_waiters.pop(v):
                if not fut.done():
                    fut.set_result(None)
        for fut in self._peek_waiters:
            if not fut.done():
                fut.set_result(None)
        self._peek_waiters.clear()
        self.spans.event("CommitDebug", span_ctx, "TLog.push.After",
                         Version=req.version)
        return req.version

    async def peek(self, tag: Tag, begin_version: Version) -> TLogPeekReply:
        """Long-poll: block until the log tip passes begin_version, then
        return all of tag's messages in [begin_version, tip].  A locked
        log never advances, so it answers immediately — the cursor uses
        the (possibly short) end_version to roll to the next generation.

        In-memory entries are found by binary search (O(log n + result));
        a peek below a spilled tag's in-memory floor re-reads the disk
        queue's frames for the missing prefix."""
        while self.version < begin_version and not self.locked:
            fut = asyncio.get_running_loop().create_future()
            self._peek_waiters.append(fut)
            await fut
        # snapshot the tip FIRST and clamp entries to it: a push appends
        # its slab before bumping the version (with awaits in between when
        # durability or BUGGIFY stalls land there), and serving an entry
        # beyond the reported end would make the cursor apply that version
        # twice on the next peek (replica divergence found by
        # ConsistencyCheck at sim seed 10)
        tip = self.version
        kc = self.known_committed
        st = self._log.get(tag)
        if st is None:
            return TLogPeekReply([], tip + 1, kc)
        entries: list[tuple[Version, MutationBatch]] = []
        if begin_version < st.spilled_below and self.queue is not None:
            entries.extend(e for e in await self._peek_spilled(
                tag, begin_version, st.spilled_below) if e[0] <= tip)
        entries.extend(
            e for e in st.slice_from(max(begin_version, st.spilled_below))
            if e[0] <= tip)
        return TLogPeekReply(entries, tip + 1, kc)

    async def _peek_spilled(self, tag: Tag, begin: Version,
                            below: Version) -> list:
        """Re-read frames covering versions [begin, below) from the disk
        queue and filter this tag's messages."""
        from ..rpc.wire import decode
        i = bisect.bisect_left(self._frame_ends, (begin, -1))
        if i >= len(self._frame_ends):
            return []
        off = self._frame_ends[i - 1][1] if i > 0 else 0
        j = bisect.bisect_left(self._frame_ends, (below, -1))
        stop = self._frame_ends[j - 1][1] if j > 0 else 0
        out = []
        for payload, _end in await self.queue.read_frames(off, stop):
            rec = decode(payload)
            v = rec["v"]
            if begin <= v < below and tag in rec["m"] and rec["m"][tag]:
                out.append((v, as_mutation_batch(rec["m"][tag])))
        return out

    def _maybe_spill(self) -> None:
        """Keep retained memory under TLOG_SPILL_THRESHOLD by evicting the
        laggiest tags' oldest entries (they stay in the disk queue, keyed
        by the frame index, and are re-read on peek).  Memory-only logs
        cannot spill — their threshold is advisory."""
        if self.queue is None:
            return
        limit = self.knobs.TLOG_SPILL_THRESHOLD
        total = self.mem_bytes
        if total <= limit:
            return
        target = limit // 2
        from ..runtime.trace import TraceEvent
        for tag, st in sorted(self._log.items(),
                              key=lambda kv: -kv[1].mem_bytes):
            if total <= target:
                break
            # evict this tag's older half (bounded below by what's on disk:
            # everything < self.version is fsync'd before ack)
            mid_i = st.start + (len(st.versions) - st.start) // 2
            if mid_i >= len(st.versions):
                continue
            mid_v = min(st.versions[mid_i], self.version)
            freed = st.evict_below(mid_v)
            total -= freed
            if freed:
                TraceEvent("TLogSpilled").detail("Tag", tag) \
                    .detail("Below", mid_v).detail("FreedBytes", freed).log()

    def pop(self, tag: Tag, version: Version) -> None:
        """Storage server declares everything < version durable; discard."""
        self._poppable[tag] = max(self._poppable.get(tag, 0), version)
        st = self._log.get(tag)
        if st is not None:
            st.pop_below(version)
        if self.queue is not None and self._hosted:
            # the disk queue can advance only past versions every hosted
            # tag has popped; a tag that never popped pins the queue.  A
            # tag popped past its last pushed version is retired — it no
            # longer constrains (a deactivated backup tag must not pin
            # the queue forever); it re-constrains if data arrives again.
            active = [self._poppable.get(t, 0) for t in self._hosted
                      if self._poppable.get(t, 0) <= self._tag_tip.get(t, 0)]
            frontier = min(active) if active else self.version + 1
            keep = 0
            pop_off = None
            for v, end in self._frame_ends:
                if v < frontier:
                    keep += 1
                    pop_off = end
                else:
                    break
            if pop_off is not None:
                del self._frame_ends[:keep]
                self._schedule_pop(pop_off)

    async def stop(self) -> None:
        """Host teardown: quiesce the disk-queue pop worker so a stopped
        role can't keep writing the queue header (or race a destroy)."""
        if self._pop_task is not None and not self._pop_task.done():
            self._pop_task.cancel()
            try:
                await self._pop_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._pop_task = None

    def _schedule_pop(self, offset: int) -> None:
        """Serialize disk-queue pops through one strongly-held worker task
        (concurrent pop_to calls could write the header out of order, and
        the loop holds tasks only weakly)."""
        self._pop_target = max(getattr(self, "_pop_target", 0), offset)
        if self._pop_task is not None and not self._pop_task.done():
            return

        async def worker():
            from ..runtime.trace import TraceEvent
            while True:
                target = self._pop_target
                if self.queue._front >= target:
                    return
                try:
                    await self.queue.pop_to(target)
                except Exception as e:
                    TraceEvent("TLogPopError", severity=40).detail(
                        "Error", repr(e)).log()
                    return
        self._pop_task = asyncio.get_running_loop().create_task(
            worker(), name="tlog-pop")
