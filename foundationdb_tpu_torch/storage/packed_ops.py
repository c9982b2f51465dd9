"""Packed op slices — the storage durability buffer and its engine feed.

Reference: REF:fdbserver/storageserver.actor.cpp updateStorage — the
reference drains the MVCC window's aged-out versions into the engine in
version order.  The seed kept that pending set as a Python list of
(version, (op, p1, p2)) tuples rebuilt by TWO full list comprehensions
per durability tick: O(total buffered) per
tick regardless of how little aged out.

``DurabilityRing`` replaces it with an append-only ring of packed
segments (each a simple-only ``MutationBatch`` — op codes ARE the engine
WAL op codes) plus a bisect version cursor: each tick commits the slice
of whole segments at or below the durable floor and advances the cursor,
O(slice) instead of O(buffer).  A TLog pull batch that took the storage
fast path lands here as ONE zero-copy segment (the same types/bounds/
blob objects, no per-op materialization); stragglers (resolved atomics,
fetchKeys rows) accumulate into small builder segments.

DISK SPILL: the ring
retains every version between the engine's durable floor and the
applied tip — a THROTTLED engine commit (slow disk, a ratekeeper-wedged
durability tick) therefore grew RSS without bound.  When retained
memory exceeds ``spill_bytes``, ``maybe_spill`` moves the OLDEST sealed
segments into a per-server DiskQueue side file (one crc-framed record
per segment: version + the raw (types, bounds, blob) columns), fsync
BEFORE the memory copy drops — ``ChangeFeedStore.maybe_spill``'s
discipline.  The per-tick commit slice reads spilled frames back
transparently (``peek_through``), bit-identical to the memory copy.

The side file carries NO recovery obligation: everything in the ring is
above the durable floor, so the TLog — popped only after the engine
commit — still holds every replay copy, and a rebooted replica rebuilds
the ring from the TLog (the side file is truncated at attach).  That is
also why ``rollback_after`` (storage rejoin) only trims bookkeeping:
frames of a rolled-back suffix become dead bytes the next ``pop_to``
releases, never decoded again.  A failed spill push/fsync mutates no
bookkeeping — the retry re-pushes fresh frames and the orphan bytes are
overwritten or released; a read-back crc failure raises (the durability
loop traces + retries) rather than silently committing a short slice.

``PackedOps`` is the slice handed to ``engine.commit``: iterable of
(op, p1, p2) for engines that replay ops, with ``wire_parts()`` exposing
the raw (types, bounds, blob) triples so the memory engine's WAL frame
encodes three contiguous byte strings per segment instead of thousands
of tuple elements.
"""

from __future__ import annotations

import bisect

from ..core.data import MutationBatch, MutationBatchBuilder, Version

__all__ = ["PackedOps", "DurabilityRing"]


class PackedOps:
    """An ordered, zero-copy run of packed op segments."""

    __slots__ = ("segments",)

    def __init__(self, segments: list[MutationBatch]) -> None:
        self.segments = segments

    def __len__(self) -> int:
        return sum(len(s) for s in self.segments)

    def __bool__(self) -> bool:
        return any(self.segments)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.segments)

    def __iter__(self):
        for seg in self.segments:
            yield from seg.iter_ops()

    def wire_parts(self) -> list[tuple[bytes, bytes, bytes]]:
        return [(s.types, s.bounds, s.blob) for s in self.segments]


class DurabilityRing:
    """Version-ordered packed op buffer with a bisect commit cursor.

    Segments are (version, MutationBatch) pairs appended in apply order;
    versions are non-decreasing, and a version is never split across the
    commit floor (the floor compares whole versions).  ``peek_through``
    returns the committable slice WITHOUT consuming it — the caller pops
    only after the engine commit succeeded, so a failed tick retries the
    same slice (the disk-trouble contract of the seed's loop).

    With a side ``queue`` attached (durable deployments), the oldest
    sealed segments may live on disk instead of in the lists below —
    ``_spilled`` tracks them as (version, frame start, frame end,
    nbytes, ops) in version order, always a PREFIX of the ring (spill
    takes from the front, appends land in memory).  ``peek_through`` /
    ``pop_through`` become awaitable to read/release them; the sync
    surfaces (append/extend/rollback/len) never touch the disk.
    """

    __slots__ = ("_versions", "_segs", "_start", "_pend", "_pend_version",
                 "queue", "spill_bytes", "mem_bytes", "spilled_bytes",
                 "_spilled", "spills", "spill_frames", "_io_lock")

    def __init__(self, queue=None, spill_bytes: int = 0) -> None:
        self._versions: list[Version] = []
        self._segs: list[MutationBatch] = []
        self._start = 0                     # segments below are committed
        self._pend: MutationBatchBuilder | None = None
        self._pend_version: Version = -1
        # --- disk spill ---
        self.queue = queue                  # DiskQueue side file when durable
        self.spill_bytes = spill_bytes      # memory budget; 0 = never spill
        self.mem_bytes = 0                  # payload bytes in [_start:]
        self.spilled_bytes = 0              # payload bytes living on disk
        self._spilled: list[tuple[Version, int, int, int, int]] = []
        self.spills = 0                     # observability: spill passes
        self.spill_frames = 0               # ...and frames written
        self._io_lock = None                # lazily built asyncio.Lock

    def _lock(self):
        import asyncio
        if self._io_lock is None:   # lazily: rings are built outside loops
            self._io_lock = asyncio.Lock()
        return self._io_lock

    def append(self, version: Version, op: int, p1: bytes, p2: bytes) -> None:
        """Buffer one op (atomics resolved at apply time, fetchKeys rows)."""
        if self._pend is not None and self._pend_version != version:
            self._seal()
        if self._pend is None:
            self._pend = MutationBatchBuilder()
            self._pend_version = version
        self._pend.add(op, p1, p2)

    def extend_packed(self, version: Version, batch: MutationBatch) -> None:
        """Buffer a whole simple-only batch as one zero-copy segment."""
        self._seal()
        self._versions.append(version)
        self._segs.append(batch)
        self.mem_bytes += batch.nbytes

    def _seal(self) -> None:
        if self._pend is not None and len(self._pend):
            seg = self._pend.finish()
            self._versions.append(self._pend_version)
            self._segs.append(seg)
            self.mem_bytes += seg.nbytes
        self._pend = None

    def __len__(self) -> int:
        n = sum(len(s) for s in self._segs[self._start:])
        n += sum(t[4] for t in self._spilled)
        if self._pend is not None:
            n += len(self._pend)
        return n

    @property
    def retained_bytes(self) -> int:
        """Resident payload bytes (memory segments only — the quantity
        the spill budget bounds)."""
        return self.mem_bytes

    @property
    def needs_spill(self) -> bool:
        return (self.queue is not None and self.spill_bytes > 0
                and self.mem_bytes > self.spill_bytes)

    # --- the commit slice ---

    def peek_memory_through(self, floor: Version) -> PackedOps:
        """The committable MEMORY slice: every buffered op at version <=
        floor.  Spill-free deployments (no queue) use this directly."""
        self._seal()
        i = bisect.bisect_right(self._versions, floor, lo=self._start)
        return PackedOps(self._segs[self._start:i])

    async def peek_through(self, floor: Version) -> PackedOps:
        """The committable slice — spilled frames at or below ``floor``
        read back transparently (oldest first, exactly the order they
        left memory), then the memory slice.  Raises IOError when a
        spilled frame fails its crc — a silently short slice would
        commit a hole the TLog pop then makes permanent."""
        if not self._spilled or self._spilled[0][0] > floor:
            return self.peek_memory_through(floor)
        async with self._lock():
            segs: list[MutationBatch] = []
            # iterate a SNAPSHOT: a rejoin rollback between frame reads
            # may trim the bookkeeping list under us
            for v, st, en, _nb, _ops in list(self._spilled):
                if v > floor:
                    break
                frames = await self.queue.read_frames(st, en)
                if not frames:
                    raise IOError(
                        f"spilled durability frame [{st},{en}) at version "
                        f"{v} unreadable (crc/short read)")
                from ..rpc.wire import decode
                rec = decode(frames[0][0])
                segs.append(MutationBatch(*(bytes(p) for p in rec["pk"])))
        mem = self.peek_memory_through(floor)
        return PackedOps(segs + mem.segments)

    def pop_memory_through(self, floor: Version) -> None:
        """Advance the cursor past the committed slice (amortized trim)."""
        i = bisect.bisect_right(self._versions, floor, lo=self._start)
        self.mem_bytes -= sum(s.nbytes for s in self._segs[self._start:i])
        self._start = i
        if self._start > 64 and self._start * 2 > len(self._segs):
            del self._versions[:self._start]
            del self._segs[:self._start]
            self._start = 0

    async def pop_through(self, floor: Version) -> None:
        """Pop the committed slice: the spilled frames' dead disk prefix
        releases FIRST (pop_to does real file I/O — header write,
        possibly a compaction; a failure leaves every piece of
        bookkeeping untouched so the caller's next tick retries), then
        the bookkeeping and memory cursor advance synchronously.  Fully
        serialized behind the io lock — the memory trim can compact
        list indices, and a spill pass awaiting its pushes must never
        observe that mid-flight."""
        async with self._lock():
            if self._spilled and self._spilled[0][0] <= floor:
                i = 0
                while i < len(self._spilled) and self._spilled[i][0] <= floor:
                    i += 1
                # frames are appended in offset order and this drops a
                # prefix, so the release offset is the last dead frame's
                # end (rolled-back dead bytes below it go with it)
                await self.queue.pop_to(self._spilled[i - 1][2])
                dead = self._spilled[:i]
                del self._spilled[:i]
                self.spilled_bytes -= sum(t[3] for t in dead)
            self.pop_memory_through(floor)

    # --- spill (the memory-wall valve; durability/pull-loop hook) ---

    async def maybe_spill(self) -> int:
        """Move the oldest sealed memory segments to the side queue
        until resident bytes drop to half the budget (hysteresis: a
        ring hovering at the budget must not pay a spill pass per
        append).  Frames are pushed AND fsync'd before any bookkeeping
        or memory trim (the ChangeFeedStore.maybe_spill discipline), so
        a failed push/sync leaves the ring exactly as it was — the
        orphan bytes are overwritten by the retry or released by a
        later pop.  Returns bytes spilled."""
        if not self.needs_spill:
            return 0
        async with self._lock():
            if not self.needs_spill:        # raced with another pass
                return 0
            from ..rpc.wire import encode
            self._seal()
            target = self.spill_bytes // 2
            budget = self.mem_bytes - target
            pushed: list[tuple[MutationBatch,
                               tuple[Version, int, int, int, int]]] = []
            # snapshot the front slice as OBJECTS, never indices: a
            # rejoin rollback is sync and may trim/compact the lists
            # between the pushes' awaits (pop_through serializes behind
            # the lock, rollback cannot)
            for v, seg in zip(self._versions[self._start:],
                              self._segs[self._start:]):
                if budget <= 0:
                    break
                st = self.queue.end_offset
                en = await self.queue.push(encode(
                    {"v": v, "pk": (seg.types, seg.bounds, seg.blob)}))
                pushed.append((seg, (v, st, en, seg.nbytes, len(seg))))
                budget -= seg.nbytes
            if not pushed:
                return 0
            await self.queue.commit()       # fsync BEFORE the memory drop
            # re-locate each pushed segment by IDENTITY: one rolled back
            # mid-spill already left the window — its frames are dead
            # bytes a later pop releases, never bookkept
            alive = {id(s): j for j, s in enumerate(self._segs)}
            spilled = 0
            used: set[int] = set()
            drops: list[tuple[int, tuple]] = []
            for seg, rec in pushed:
                j = alive.get(id(seg))
                if j is None or j < self._start or j in used:
                    continue
                used.add(j)
                drops.append((j, rec))
            for j, rec in sorted(drops, reverse=True):
                del self._versions[j]
                del self._segs[j]
                self._spilled.append(rec)
                self.mem_bytes -= rec[3]
                spilled += rec[3]
            self._spilled.sort(key=lambda t: (t[0], t[1]))
            self.spilled_bytes += spilled
            if spilled:
                self.spills += 1
                self.spill_frames += len(drops)
            return spilled

    # --- rollback (storage rejoin) ---

    def rollback_after(self, version: Version) -> None:
        """Discard buffered ops newer than ``version`` (storage rejoin:
        the unacked suffix of a dead log generation rolls back before
        it could ever become durable).  Spilled frames of the suffix
        drop from the bookkeeping only — their bytes are dead on disk
        until a later pop releases them (a disk queue cannot un-append;
        nothing ever reads an untracked frame)."""
        if self._pend is not None and self._pend_version > version:
            self._pend = None
        self._seal()
        i = bisect.bisect_right(self._versions, version, lo=self._start)
        self.mem_bytes -= sum(s.nbytes for s in self._segs[i:])
        del self._versions[i:]
        del self._segs[i:]
        if self._spilled and self._spilled[-1][0] > version:
            keep = [t for t in self._spilled if t[0] <= version]
            self.spilled_bytes -= sum(t[3] for t in self._spilled[len(keep):])
            self._spilled = keep

    # --- observability ---

    def stats(self) -> dict:
        return {
            "dbuf_mem_bytes": self.mem_bytes,
            "dbuf_spilled_bytes": self.spilled_bytes,
            "dbuf_spilled_frames": len(self._spilled),
            "dbuf_spills": self.spills,
        }
