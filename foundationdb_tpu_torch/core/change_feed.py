"""Change feeds — versioned streaming change capture over packed batches.

Reference: REF:fdbserver/storageserver.actor.cpp (changeFeedStreamQ /
ChangeFeedInfo) + REF:fdbclient/SystemData.cpp changeFeedPrefix — a feed
is a durable, version-ordered stream of every committed mutation inside
a key range, served by the storage servers that own the range.  Upstream
built the subsystem as the backbone of its blob/backup pipeline; here it
is the serving path for derived readers (caches, indexes, replication
fan-out).

The storage server already holds every mutation it applies as a packed
``MutationBatch`` (PROTOCOL_VERSION 712); a feed retains *index slices*
of those batches (``MutationBatch.select`` — the identity slice is
zero-copy), so N subscribers cost one retained reference per version,
never a re-materialized ``Mutation`` list.

Retention model:

- entries newer than the storage durable floor live in memory only and
  ROLL BACK with the MVCC window on recovery (they came from a log
  generation's possibly-unacked suffix — exactly-once delivery depends
  on this);
- every sealed entry at or below the durable floor spills to a
  DiskQueue-backed side queue (one per storage server, frames tagged
  by feed id) BEFORE the TLog pop drops its replay copy, and is re-read
  on demand — the spill-by-reference discipline of the TLog, promoted
  to a durability obligation;
- ``pop`` advances a consumer's durable low-water mark: entries at or
  below it are discarded and the side queue's dead prefix is released.
"""

from __future__ import annotations

import bisect
import dataclasses

from .data import SYSTEM_PREFIX, KeyRange, MutationBatch, Version

__all__ = ["ChangeFeedStreamRequest", "ChangeFeedStreamReply",
           "FeedState", "ChangeFeedStore",
           "WHOLE_DB_BEGIN", "WHOLE_DB_END"]

# Whole-database feeds: a feed may cover the ENTIRE user
# keyspace, \xff-exclusively — the backbone of the feed-native backup.
# System writes are excluded at capture (every feed range ends at or
# below \xff and capture clips to it), registration/pop/destroy markers
# route to ALL current owners through the proxy's tags_for_range over
# the live shard map, and DD splits/moves keep routing via the
# fetch_feed_state handoff exactly as for ranged feeds.
WHOLE_DB_BEGIN: bytes = b""
WHOLE_DB_END: bytes = SYSTEM_PREFIX


@dataclasses.dataclass
class ChangeFeedStreamRequest:
    """One long-poll of a feed cursor (ChangeFeedStreamRequest,
    REF:fdbclient/StorageServerInterface.h).  ``begin_version`` is the
    consumer's resume cursor: the reply carries every retained entry at
    versions in [begin_version, end_version)."""
    feed_id: bytes
    begin_version: Version
    byte_limit: int = 0


@dataclasses.dataclass
class ChangeFeedStreamReply:
    """``entries`` is [(version, MutationBatch)] in version order.
    ``end_version`` is the heartbeat: the consumer owns everything below
    it for this shard, even when ``entries`` is empty — that is what
    lets a cursor resume exactly-once after a storage failover.
    ``popped_version`` echoes the feed's durable low-water mark.
    ``ranges`` lists the feed subranges THIS server currently serves
    (its shard ∩ the feed range, minus handed-off pieces): the cursor
    requires its polled replies to jointly cover the whole feed range
    before advancing — a stale shard map after a split would otherwise
    silently miss the moved half (no error ever fires: the old owner
    answers happily for the keys it kept)."""
    entries: list
    end_version: Version
    popped_version: Version
    ranges: list | None = None


class FeedState:
    """One feed's retained window on one storage server."""

    __slots__ = ("feed_id", "range", "register_version", "popped_version",
                 "versions", "batches", "sizes", "start", "mem_bytes",
                 "spilled", "spilled_bytes", "fence", "excluded")

    def __init__(self, feed_id: bytes, begin: bytes, end: bytes,
                 register_version: Version,
                 popped_version: Version = 0) -> None:
        self.feed_id = feed_id
        self.range = KeyRange(begin, end)
        self.register_version = register_version
        self.popped_version = popped_version
        # in-memory retained entries, version-ascending (amortized-trim
        # start index, the _TagStore pattern)
        self.versions: list[Version] = []
        self.batches: list[MutationBatch] = []
        self.sizes: list[int] = []
        self.start = 0
        self.mem_bytes = 0
        # spilled entries: (version, frame_start, frame_end, nbytes),
        # version-ascending, strictly older than every in-memory entry
        self.spilled: list[tuple[Version, int, int, int]] = []
        self.spilled_bytes = 0
        # set when this server's ENTIRE intersection with the feed was
        # relinquished (live move handoff): streams above the fence
        # refuse with wrong_shard_server so consumers re-route to the
        # destination
        self.fence: Version | None = None
        # subranges handed off by PARTIAL drops (a split moving only the
        # suffix), as (drop version, begin, end): the destination is
        # authoritative for them — this server filters them out of
        # capture AND serving, so the consumer's per-shard merge never
        # sees a mutation twice.  Versioned so a rolled-back drop
        # (recovery clamping an unacked flip) un-excludes.
        self.excluded: list[tuple[Version, bytes, bytes]] = []

    def retain(self, version: Version, batch: MutationBatch) -> None:
        self.versions.append(version)
        self.batches.append(batch)
        nb = batch.nbytes
        self.sizes.append(nb)
        self.mem_bytes += nb

    def entry_count(self) -> int:
        return len(self.versions) - self.start + len(self.spilled)

    def pop(self, version: Version) -> None:
        """Advance the low-water mark; discard retained entries <= it."""
        if version <= self.popped_version:
            return
        self.popped_version = version
        i = bisect.bisect_right(self.versions, version)
        if i > self.start:
            self.mem_bytes -= sum(self.sizes[self.start:i])
            self.start = i
        if self.start > 64 and self.start * 2 > len(self.versions):
            del self.versions[:self.start]
            del self.batches[:self.start]
            del self.sizes[:self.start]
            self.start = 0
        keep = [e for e in self.spilled if e[0] > version]
        if len(keep) != len(self.spilled):
            self.spilled_bytes = sum(e[3] for e in keep)
            self.spilled = keep

    def rollback_after(self, version: Version) -> None:
        """Discard in-memory entries newer than ``version`` (storage
        rejoin: the unacked suffix of a dead log generation rolls back
        before any consumer could be handed it).  Spilled entries never
        need rolling back — spill is gated at the durable floor, and a
        replica whose durable floor exceeds the recovery version is
        discarded outright (StorageServer.rejoin)."""
        while len(self.versions) > self.start \
                and self.versions[-1] > version:
            self.versions.pop()
            self.batches.pop()
            self.mem_bytes -= self.sizes.pop()

def _subtract_ranges(pieces: list[tuple[bytes, bytes]],
                     excluded: list[tuple[Version, bytes, bytes]]
                     ) -> list[tuple[bytes, bytes]]:
    """Subtract every excluded (version, begin, end) subrange from the
    piece list — the one home of the interval arithmetic shared by
    clear-clipping and serving-range computation."""
    for _v, b, e in excluded:
        nxt = []
        for cb, ce in pieces:
            if ce <= b or e <= cb:
                nxt.append((cb, ce))
                continue
            if cb < b:
                nxt.append((cb, b))
            if e < ce:
                nxt.append((e, ce))
        pieces = nxt
    return pieces


def _filter_excluded(batch: MutationBatch,
                     excluded: list[tuple[Version, bytes, bytes]]
                     ) -> MutationBatch:
    """Drop/clip ops inside handed-off subranges: SETs on excluded keys
    vanish, CLEARs are clipped around every excluded subrange (the
    destination delivers its own copy for those keys — without the
    clip, a range clear spanning the split point would reach the
    consumer from both shards).  Returns the ORIGINAL object untouched
    when nothing matches."""
    if not excluded:
        return batch
    from .data import MutationBatchBuilder
    builder = MutationBatchBuilder()
    changed = False
    for t, p1, p2 in batch.iter_ops():
        if t == 0:
            if any(b <= p1 < e for _v, b, e in excluded):
                changed = True
                continue
            builder.add(t, p1, p2)
        else:
            pieces = _subtract_ranges([(p1, p2)], excluded)
            if pieces != [(p1, p2)]:
                changed = True
            for cb, ce in pieces:
                builder.add(t, cb, ce)
    if not changed:
        return batch
    return builder.finish()


class ChangeFeedStore:
    """Every feed hosted by one storage server + the shared spill queue.

    ``capture`` is the apply-path hook: synchronous, zero-cost when no
    feed is armed.  Disk-touching surfaces (``read`` of a spilled
    prefix, ``maybe_spill``) are async and run from the storage role's
    read/durability paths.
    """

    def __init__(self, queue=None) -> None:
        self.feeds: dict[bytes, FeedState] = {}
        self.queue = queue          # DiskQueue side file when durable
        # spill frames in offset order: (start, end, feed_id, version);
        # the dead prefix (popped/destroyed feeds) is released via pop_to
        self._frames: list[tuple[int, int, bytes, Version]] = []
        # cached segment decomposition of the armed feed ranges (the
        # capture hook's one-interval-pass index):
        # (key, boundaries, covering-feed lists); rebuilt whenever the
        # eligible feed set or its clipped ranges change
        self._seg_cache: tuple | None = None
        # serializes stream reads against spills: a read's disk awaits
        # must not interleave with maybe_spill moving entries between
        # the memory window and the spilled list, or the read's stale
        # snapshot loses (or doubles) exactly the moved versions
        self._io_lock = None
        self.streams_served = 0
        self.total_captured = 0

    def _lock(self):
        import asyncio
        if self._io_lock is None:   # lazily: the store may be built
            self._io_lock = asyncio.Lock()   # outside a running loop
        return self._io_lock

    # --- lifecycle markers (applied from the tag's mutation stream) ---

    def register(self, feed_id: bytes, begin: bytes, end: bytes,
                 version: Version) -> None:
        """Idempotent: a re-delivered marker (recovery replay) is a no-op.
        The range is clamped \\xff-exclusive — system writes must never
        enter a feed even if a forged/corrupt registration names them
        (the client and proxy already enforce this; defense in depth)."""
        if feed_id in self.feeds:
            return
        end = min(end, SYSTEM_PREFIX)
        if begin >= end:
            return
        self.feeds[feed_id] = FeedState(feed_id, begin, end, version)

    def destroy(self, feed_id: bytes) -> None:
        self.feeds.pop(feed_id, None)

    def pop(self, feed_id: bytes, version: Version) -> None:
        f = self.feeds.get(feed_id)
        if f is not None:
            f.pop(version)

    def fence(self, version: Version, begin: bytes, end: bytes,
              remaining: KeyRange | None = None) -> None:
        """The shard relinquished [begin, end) as of ``version``.

        A feed whose ENTIRE intersection with this server's remaining
        range is gone hard-fences: streams above ``version`` refuse
        with wrong_shard_server and consumers re-route to the
        destination (which received the retained window via
        fetch_feed_state).  A PARTIAL handoff (a split moving only the
        suffix) instead EXCLUDES the moved subrange: this server keeps
        serving the feed for the keys it still owns, while the
        destination is authoritative for the moved keys at every
        version — so the consumer's per-shard merge sees each mutation
        exactly once."""
        for f in self.feeds.values():
            if not (f.range.begin < end and begin < f.range.end):
                continue
            if remaining is not None and not remaining.empty \
                    and remaining.begin < f.range.end \
                    and f.range.begin < remaining.end:
                f.excluded.append((version, begin, end))
            else:
                f.fence = version if f.fence is None \
                    else min(f.fence, version)

    def rollback_after(self, version: Version) -> None:
        for fid in [fid for fid, f in self.feeds.items()
                    if f.register_version > version]:
            del self.feeds[fid]
        for f in self.feeds.values():
            f.rollback_after(version)
            if f.fence is not None and f.fence > version:
                f.fence = None
            if any(v > version for v, _b, _e in f.excluded):
                f.excluded = [x for x in f.excluded if x[0] <= version]

    # --- the capture hook (storage apply path) ---

    def capture(self, version: Version, batch: MutationBatch,
                shard: KeyRange | None = None) -> None:
        """Retain this version's slice of ``batch`` for every armed feed
        whose range it touches.  ``batch`` holds only plain SET/CLEAR
        ops (the apply path feeds the packed fast-path batch directly,
        and builds an effective batch of resolved atomics otherwise).

        ``shard`` clips the capture to this server's owned range: a
        CLEAR spanning a shard boundary inside the feed range arrives
        on EVERY overlapping tag's stream, and without the clip the
        consumer's per-shard merge would deliver it once per shard —
        each server must capture only the piece it answers for (the
        same contract ``serving_ranges`` advertises)."""
        if not self.feeds or not batch:
            return
        # eligibility is per (feed, version): cheap O(feeds) each call
        elig: list[tuple[bytes, bytes, FeedState]] = []
        for f in self.feeds.values():
            if version <= f.register_version or version <= f.popped_version:
                continue
            if f.fence is not None and version > f.fence:
                continue
            rb, re_ = f.range.begin, f.range.end
            if shard is not None:
                rb, re_ = max(rb, shard.begin), min(re_, shard.end)
                if rb >= re_:
                    continue
            elig.append((rb, re_, f))
        if not elig:
            return
        # ONE interval pass over the batch: the
        # eligible feed ranges decompose into disjoint segments (cached
        # across applies while the feed set is stable), each op bisects
        # into its segment(s) once, and the covering feeds collect op
        # INDICES — so a server hosting many overlapping feeds scans the
        # batch once, not once per feed.  Per-feed slice assembly
        # (select + boundary clip) is unchanged.
        bounds, cover = self._segments(elig)
        idxs: list[list[int]] = [[] for _ in elig]
        last = [-1] * len(elig)
        nseg = len(cover)
        for i, (t, p1, p2) in enumerate(batch.iter_ops()):
            if t == 0:
                s = bisect.bisect_right(bounds, p1) - 1
                if 0 <= s < nseg:
                    for fpos in cover[s]:
                        idxs[fpos].append(i)
            else:
                lo = bisect.bisect_right(bounds, p1) - 1
                if lo < 0:
                    lo = 0
                hi = min(bisect.bisect_left(bounds, p2), nseg)
                for s in range(lo, hi):
                    for fpos in cover[s]:
                        if last[fpos] != i:
                            last[fpos] = i
                            idxs[fpos].append(i)
        for (rb, re_, f), fidx in zip(elig, idxs):
            if fidx:
                # one clip pass: excluded pieces plus everything outside
                # [rb, re_) — SETs are already range-filtered, this
                # trims boundary-spanning CLEARs to exactly the piece
                # this server serves
                clip = list(f.excluded)
                if rb > b"":
                    clip.append((0, b"", rb))
                clip.append((0, re_, b"\xff\xff\xff\xff"))
                sub = _filter_excluded(batch.select(fidx), clip)
                if sub:
                    f.retain(version, sub)
                    self.total_captured += len(sub)

    def _segments(self, elig: list) -> tuple[list[bytes], list[list[int]]]:
        """Disjoint elementary segments of the eligible (clipped) feed
        ranges: ``bounds[s]`` starts segment s = [bounds[s],
        bounds[s+1]) and ``cover[s]`` lists the positions in ``elig``
        covering it (the final boundary starts no segment).  Cached on
        the exact (feed identity, clipped range) tuple — stable across
        the thousands of applies between feed lifecycle events."""
        key = tuple((id(f), rb, re_) for rb, re_, f in elig)
        cached = self._seg_cache
        if cached is not None and cached[0] == key:
            return cached[1], cached[2]
        pts = sorted({p for rb, re_, _f in elig for p in (rb, re_)})
        cover: list[list[int]] = [[] for _ in range(max(0, len(pts) - 1))]
        for fpos, (rb, re_, _f) in enumerate(elig):
            for s in range(bisect.bisect_left(pts, rb),
                           bisect.bisect_left(pts, re_)):
                cover[s].append(fpos)
        self._seg_cache = (key, pts, cover)
        return pts, cover

    # --- the stream read ---

    async def read(self, feed_id: bytes, begin_version: Version,
                   byte_limit: int, through_version: Version
                   ) -> tuple[list, Version | None]:
        """Retained entries of ``feed_id`` in [begin_version,
        through_version], oldest first: the spilled prefix re-read from
        the side queue, then the in-memory window.  Returns (entries,
        truncated_at): ``truncated_at`` is the last delivered version
        when the byte limit cut the scan short, else None (exhausted)."""
        async with self._lock():
            return await self._read_locked(feed_id, begin_version,
                                           byte_limit, through_version)

    async def _read_locked(self, feed_id: bytes, begin_version: Version,
                           byte_limit: int, through_version: Version
                           ) -> tuple[list, Version | None]:
        from ..rpc.wire import decode
        f = self.feeds[feed_id]
        excluded = f.excluded
        out: list[tuple[Version, MutationBatch]] = []
        nbytes = 0
        lo = bisect.bisect_left(f.spilled, (begin_version, -1, -1, -1))
        for v, st, en, nb in f.spilled[lo:]:
            if v > through_version:
                return out, None
            # a corrupt spilled frame raises DiskCorrupt from read_frames: the
            # stream RPC fails LOUDLY instead of the old
            # behavior of silently skipping the version — a consumer
            # must never be heartbeated past data it was never handed.
            # An empty result only means the frame range was released by
            # a concurrent pop, which IS silently skippable.
            frames = await self.queue.read_frames(st, en)
            if not frames:
                continue        # released concurrently by a pop
            rec = decode(frames[0][0])
            sub = _filter_excluded(MutationBatch(*rec["pk"]), excluded)
            if sub:
                out.append((v, sub))
                nbytes += nb
            if byte_limit and nbytes >= byte_limit:
                return out, v
        i = bisect.bisect_left(f.versions, begin_version, lo=f.start)
        while i < len(f.versions):
            v = f.versions[i]
            if v > through_version:
                break
            sub = _filter_excluded(f.batches[i], excluded)
            if sub:
                out.append((v, sub))
                nbytes += f.sizes[i]
            if byte_limit and nbytes >= byte_limit:
                return out, v
            i += 1
        return out, None

    # --- spill / release (durability-loop hooks) ---

    async def maybe_spill(self, floor: Version,
                          mem_limit: int = 0) -> int:
        """Release the side queue's dead prefix, then spill EVERY sealed
        entry at or below ``floor`` (the storage durable floor) to the
        side queue.  This is a durability obligation, not a memory
        optimization: the durability tick pops the TLog past the floor,
        so an unspilled sub-floor entry's only copy would die with the
        process — a rebooted replica would then heartbeat consumers
        past data it silently lost.  Entries above the floor never
        spill: they may still roll back with the MVCC window (and
        replay from the TLog after a reboot), and a disk queue cannot
        un-append.  ``mem_limit`` > 0 caps the pass for tests (spill
        down to half the cap, oldest first).  Returns bytes spilled.

        Crash/retry discipline: frames are pushed AND fsync'd before a
        single piece of bookkeeping (spilled lists, memory trim)
        mutates, all of which then happens in one synchronous step under
        the io lock — a failed push/commit leaves the store exactly as
        it was (the orphan frames are re-pushed on retry and the stale
        copies skipped at restore by the duplicate-version guard), a
        concurrent stream read can never observe an entry in both the
        memory window and the spilled list, and the post-commit trim is
        by VERSION, not index — a pop applied from the tag stream
        during the push awaits compacts the memory lists safely."""
        async with self._lock():
            await self._release()
            if self.queue is None:
                return 0
            from ..rpc.wire import encode
            total = sum(f.mem_bytes for f in self.feeds.values())
            target = mem_limit // 2 if mem_limit else None
            spilled = 0
            # snapshot (feed, version, size, frame start, frame end) —
            # VALUES, never indices: the lists may compact under a
            # concurrent pop while the pushes await
            pushed: list[tuple[FeedState, Version, int, int, int]] = []
            for f in sorted(self.feeds.values(), key=lambda x: -x.mem_bytes):
                if target is not None and total - spilled <= target:
                    break
                i = f.start
                hi = bisect.bisect_right(f.versions, floor)
                seal = list(zip(f.versions[i:hi], f.batches[i:hi],
                                f.sizes[i:hi]))
                for v, b, nb in seal:
                    if target is not None and total - spilled <= target:
                        break
                    start_off = self.queue.end_offset
                    end_off = await self.queue.push(encode({
                        "f": f.feed_id, "v": v,
                        "pk": (b.types, b.bounds, b.blob)}))
                    pushed.append((f, v, nb, start_off, end_off))
                    spilled += nb
            if not pushed:
                return 0
            # fsync BEFORE any bookkeeping: the TLog pops past the
            # durable floor, so a crash between trim and sync would lose
            # the only copy of acked feed data — and a FAILED sync must
            # leave no record either, or the retry would double-spill
            await self.queue.commit()
            tops: dict[bytes, Version] = {}
            for f, v, nb, st, en in pushed:
                if self.feeds.get(f.feed_id) is not f:
                    continue            # destroyed mid-spill: dead frame
                if v <= f.popped_version:
                    continue            # popped mid-spill: dead frame
                self._frames.append((st, en, f.feed_id, v))
                f.spilled.append((v, st, en, nb))
                f.spilled_bytes += nb
                tops[f.feed_id] = v
            for f in {id(p[0]): p[0] for p in pushed}.values():
                top = tops.get(f.feed_id)
                if top is None:
                    continue
                i = bisect.bisect_right(f.versions, top, lo=f.start)
                if i > f.start:
                    # [start:i) holds exactly the entries just spilled
                    # (or popped mid-spill); the dead prefix below
                    # ``start`` is untouched, so ``start`` stays valid
                    f.mem_bytes -= sum(f.sizes[f.start:i])
                    del f.versions[f.start:i]
                    del f.batches[f.start:i]
                    del f.sizes[f.start:i]
            return spilled

    async def _release(self) -> None:
        """Trim the side queue's dead prefix (popped or destroyed)."""
        if self.queue is None:
            return
        off = None
        while self._frames:
            st, en, fid, v = self._frames[0]
            f = self.feeds.get(fid)
            if f is None or v <= f.popped_version:
                off = en
                self._frames.pop(0)
            else:
                break
        if off is not None:
            await self.queue.pop_to(off)

    def serving_ranges(self, feed_id: bytes,
                       shard: KeyRange) -> list[tuple[bytes, bytes]]:
        """The feed subranges this server answers for: its (narrowed)
        shard ∩ the feed range, minus handed-off exclusions."""
        f = self.feeds[feed_id]
        b = max(shard.begin, f.range.begin)
        e = min(shard.end, f.range.end)
        if b >= e:
            return []
        return _subtract_ranges([(b, e)], f.excluded)

    # --- durable metadata + recovery ---

    def export_meta(self) -> list[dict]:
        """Registration metadata for the engine's meta dict: enough to
        re-arm every feed after a reboot (entries above the durable
        floor replay from the TLog; spilled ones recover from the side
        queue)."""
        return [{"id": f.feed_id, "b": f.range.begin, "e": f.range.end,
                 "rv": f.register_version, "pv": f.popped_version,
                 "ex": [list(x) for x in f.excluded]}
                for f in self.feeds.values()]

    def restore(self, meta: list[dict], frames: list[tuple[bytes, int]],
                front: int) -> None:
        """Reboot path: re-arm feeds from engine meta and re-index the
        side queue's surviving frames (``frames`` is DiskQueue.open's
        payload list; ``front`` the queue's first live offset)."""
        from ..rpc.wire import decode
        for m in meta or []:
            f = FeedState(bytes(m["id"]), bytes(m["b"]), bytes(m["e"]),
                          m["rv"], m["pv"])
            f.excluded = [(v, bytes(b), bytes(e))
                          for v, b, e in m.get("ex") or []]
            self.feeds[bytes(m["id"])] = f
        pos = front
        for payload, end in frames:
            try:
                rec = decode(payload)
            except Exception:  # noqa: BLE001 — torn frame: skip
                pos = end
                continue
            fid, v = bytes(rec["f"]), rec["v"]
            f = self.feeds.get(fid)
            # the monotonic-version guard also drops orphan frames from
            # a spill attempt whose fsync failed before bookkeeping (the
            # retry re-pushed identical content at a later offset)
            if f is not None and v > f.popped_version \
                    and (not f.spilled or v > f.spilled[-1][0]):
                nb = len(rec["pk"][2])
                self._frames.append((pos, end, fid, v))
                f.spilled.append((v, pos, end, nb))
                f.spilled_bytes += nb
            pos = end

    # --- data-distribution handoff (rides fetchKeys) ---

    async def handoff(self, begin: bytes, end: bytes,
                      through_version: Version) -> list[dict]:
        """Export every feed overlapping [begin, end) for a move
        destination: registration + retained entries at or below the
        fetch version, clipped to the moving range.  Entries above it
        arrive at the destination through its own tag pull."""
        out: list[dict] = []
        for f in self.feeds.values():
            if not (f.range.begin < end and begin < f.range.end):
                continue
            entries, _ = await self.read(f.feed_id, f.popped_version + 1,
                                         0, through_version)
            clipped: list[tuple[Version, MutationBatch]] = []
            cb, ce = max(begin, f.range.begin), min(end, f.range.end)
            if cb >= ce:
                continue
            # same clip discipline as capture: CLEARs spanning the
            # handoff boundary must not reach the destination whole, or
            # the kept part would be delivered by both sides
            clip = [(0, ce, b"\xff\xff\xff\xff")]
            if cb > b"":
                clip.append((0, b"", cb))
            for v, batch in entries:
                idxs = [i for i, (t, p1, p2) in enumerate(batch.iter_ops())
                        if (cb <= p1 < ce if t == 0
                            else (p1 < ce and cb < p2))]
                if idxs:
                    sub = _filter_excluded(batch.select(idxs), clip)
                    if sub:
                        clipped.append((v, sub))
            out.append({"id": f.feed_id, "b": f.range.begin,
                        "e": f.range.end, "rv": f.register_version,
                        "pv": f.popped_version, "entries": clipped})
        return out

    def install(self, exported: list[dict]) -> None:
        """Destination side of ``handoff``: arm the feeds and seed their
        retained windows with the source's entries."""
        for m in exported:
            fid = bytes(m["id"])
            f = self.feeds.get(fid)
            if f is None:
                f = self.feeds[fid] = FeedState(
                    fid, bytes(m["b"]), bytes(m["e"]), m["rv"], m["pv"])
            for v, batch in m["entries"]:
                if not f.versions or v > f.versions[-1]:
                    f.retain(v, batch)

    # --- observability ---

    def metrics(self) -> dict:
        return {
            "feeds_active": len(self.feeds),
            # ids, not just a count: the status rollup needs the DISTINCT
            # union across servers (max undercounts disjoint placements,
            # sum double-counts replicas)
            "feed_ids": sorted(self.feeds),
            "feed_entries": sum(f.entry_count()
                                for f in self.feeds.values()),
            "feed_mem_bytes": sum(f.mem_bytes
                                  for f in self.feeds.values()),
            "feed_spilled_bytes": sum(f.spilled_bytes
                                      for f in self.feeds.values()),
            "feed_streams_served": self.streams_served,
            "feed_mutations_captured": self.total_captured,
        }
