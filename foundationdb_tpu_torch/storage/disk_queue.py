"""DiskQueue — the append-only durable record queue under the TLog.

Reference: REF:fdbserver/DiskQueue.actor.cpp — FDB's TLog writes redo
records into a page-aligned two-file queue; push appends, commit fsyncs,
pop logically truncates the front.  Records surviving a crash are exactly
those up to the last completed sync (proved in sim by AsyncFileNonDurable).

Format: a 4KB header page holding TWO alternating crc32-stamped header
slots (magic, generation, physical front, caller meta, durable frontier),
followed by frames [u32 len][u32 crc32][payload].  Each header write goes
to the slot its generation selects, so a torn or corrupted header write
from a kill always leaves the previous slot's older header intact —
the dual-commit-header discipline the btree engine already uses.

Recovery scans frames from the header's front.  The header's *durable
frontier* (the append position as of a previously COMPLETED sync — it
deliberately lags one commit, so a torn in-flight commit can never
over-claim) splits the scan into two regimes:

- a bad crc AT OR PAST the frontier is a torn tail from a crash —
  discarded, today's behavior;
- a bad crc BEFORE the frontier is corruption of COMMITTED data — the
  recovery raises ``DiskCorrupt`` loudly instead of silently truncating
  acked frames (the silent-truncation bug this split fixes).

``meta`` is caller-owned and rides the header under the same sync (the
TLog stores its durable tip version here: popped frames vanish, so the
tip of the surviving frames UNDERSTATES how far the log durably acked —
recovery computed from that would precede storage durability and wedge
every rejoin).

Offsets handed to callers are *logical* and monotonic: physical
compaction (copying the live region down over a large popped prefix)
shifts the mapping internally, so offsets recorded across a compaction
stay valid.  Compaction only runs when the live region fits inside the
popped prefix, so a crash mid-copy can never damage bytes the current
header still references.
"""

from __future__ import annotations

import struct
import zlib

from ..runtime.errors import DiskCorrupt

_FRAME = struct.Struct("<II")
# magic, generation, physical front offset, caller meta, durable
# frontier (physical), crc32 of the five preceding fields
_HEADER = struct.Struct("<QQQQQI")
_LEGACY_HEADER = struct.Struct("<QQQ")   # the older header: magic, front, meta
_MAGIC = 0xFDB7D15C  # arbitrary magic for our queue files
_HEADER_SIZE = 4096
_SLOT = 512                         # header slot stride (one sim sector)
_COMPACT_SLACK = 1 << 22            # compact when popped prefix > 4MB


class DiskQueue:
    def __init__(self, file) -> None:
        self.file = file
        self._front = _HEADER_SIZE   # logical offset of first live frame
        self._end = _HEADER_SIZE     # logical append position
        self._shift = 0              # logical - physical
        self._gen = 0                # header generation (slot parity)
        self._synced_end = _HEADER_SIZE  # logical end at the last sync
        self._hdr_synced = -1        # durable frontier the header carries
        self.meta = 0                # caller-owned u64, durable w/ commits

    def _phys(self, logical: int) -> int:
        return logical - self._shift

    @staticmethod
    def _read_best_header(raw: bytes) -> tuple | None:
        """Newest valid header slot: (gen, front, meta, synced) — or the
        legacy single-slot format, or None (fresh/never-synced file)."""
        best = None
        for slot in (0, 1):
            chunk = raw[slot * _SLOT: slot * _SLOT + _HEADER.size]
            if len(chunk) < _HEADER.size:
                continue
            magic, gen, front, meta, synced, crc = _HEADER.unpack(chunk)
            if magic != _MAGIC or crc != zlib.crc32(chunk[:-4]):
                continue
            if best is None or gen > best[0]:
                best = (gen, front, meta, synced)
        if best is not None:
            return best
        if len(raw) >= _LEGACY_HEADER.size:
            magic, front, meta = _LEGACY_HEADER.unpack_from(raw)
            if magic == _MAGIC:
                # pre-dual-slot file: no recorded frontier — the whole
                # scan runs in torn-tail mode (the old behavior)
                return (0, front, meta, _HEADER_SIZE)
        return None

    @classmethod
    async def open(cls, file) -> tuple["DiskQueue", list[tuple[bytes, int]]]:
        """Open + recover: returns (queue, [(payload, end_offset), ...]) —
        the end offset is what pop_to() takes to discard through a frame.

        Raises ``DiskCorrupt`` when a frame BEFORE the recorded durable
        frontier fails its crc (committed data damaged — never silently
        truncated); a bad frame at or past it is a torn tail, discarded."""
        q = cls(file)
        size = file.size()
        durable = _HEADER_SIZE
        if size > 0:
            # the header slots are read whenever ANY bytes exist — not
            # only past the full header page.  A file shorter than the
            # header page whose surviving slot records a durable
            # frontier is a LENGTH regression of the header page itself
            # (truncation of committed state, which a torn kill can
            # never produce: synced bytes are untouchable) — the frame
            # scan below then finds the frontier unreachable and raises
            # DiskCorrupt instead of silently re-initializing the queue
            best = cls._read_best_header(await file.read(0, 2 * _SLOT))
            if best is not None:
                gen, front, meta, synced = best
                if _HEADER_SIZE <= front:
                    q._gen = gen
                    q._front = front     # logical == physical on a fresh open
                    q.meta = meta
                    durable = max(synced, _HEADER_SIZE)
        payloads: list[tuple[bytes, int]] = []
        pos = q._front
        while pos + _FRAME.size <= size:
            ln, crc = _FRAME.unpack(await file.read(pos, _FRAME.size))
            data = await file.read(pos + _FRAME.size, ln)
            if len(data) < ln or zlib.crc32(data) != crc:
                if pos < durable:
                    raise DiskCorrupt(
                        f"disk queue frame at {pos} is inside the "
                        f"committed region (durable frontier {durable}) "
                        f"and failed its crc — refusing to silently "
                        f"truncate acked data")
                break               # torn tail: discard from here
            pos += _FRAME.size + ln
            payloads.append((data, pos))
        if pos < durable:
            # the file ends before the durable frontier: committed
            # frames are missing outright (a truncated/overwritten file,
            # not a crash — a torn kill can never shorten synced bytes)
            raise DiskCorrupt(
                f"disk queue ends at {pos} before the durable frontier "
                f"{durable} — committed frames are missing")
        q._end = pos
        q._synced_end = pos         # everything surviving sits on disk
        await file.truncate(pos)    # drop any torn tail bytes
        if size < _HEADER_SIZE:
            await q._write_header()
        return q, payloads

    async def _write_header(self) -> None:
        """One crc-stamped header into the generation's slot; the other
        slot keeps the previous header, so a torn header write can never
        orphan the queue.  The generation advances only AFTER the write
        call returns: a transient IoError raised from the write must
        leave the parity untouched, or the retry would land on the
        OPPOSITE slot — the one holding the freshest synced header."""
        gen = self._gen + 1
        body = _HEADER.pack(_MAGIC, gen, self._phys(self._front),
                            self.meta, self._phys(self._synced_end), 0)[:-4]
        await self.file.write((gen % 2) * _SLOT,
                              body + zlib.crc32(body).to_bytes(4, "little"))
        self._gen = gen
        self._hdr_synced = self._synced_end

    async def push(self, payload: bytes) -> int:
        """Append one frame; returns its logical end offset (record this
        to pop_to() later)."""
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        await self.file.write(self._phys(self._end), frame)
        self._end += len(frame)
        return self._end

    async def commit(self, meta: int | None = None) -> None:
        """Make all pushed frames durable (the TLog's fsync point).
        ``meta`` rides the header under the same sync, as does the
        durable frontier of the PREVIOUS completed sync — lagging one
        commit on purpose: a header claiming this commit's frames while
        the same kill tears them would turn every crash into a false
        corruption alarm."""
        if (meta is not None and meta != self.meta) \
                or self._synced_end > self._hdr_synced:
            if meta is not None:
                self.meta = meta
            await self._write_header()
        await self.file.sync()
        self._synced_end = self._end

    async def pop_to(self, offset: int) -> None:
        """Discard everything before logical ``offset``; physically
        compact when worthwhile and safe."""
        if offset <= self._front:
            return
        self._front = min(offset, self._end)
        await self._write_header()
        popped_phys = self._phys(self._front) - _HEADER_SIZE
        live = self._end - self._front
        if popped_phys > _COMPACT_SLACK and live <= popped_phys:
            data = await self.file.read(self._phys(self._front), live)
            await self.file.write(_HEADER_SIZE, data)
            await self.file.sync()          # live bytes safe at new home
            self._synced_end = self._end
            self._shift += popped_phys
            await self._write_header()      # recovery now reads the copy
            # the remapped header must be DURABLE before the truncate is
            # even issued: a torn kill keeping the truncate but dropping
            # the header write would otherwise leave the old header
            # pointing past the shortened file — recovery would then
            # raise a false 'committed frames missing' DiskCorrupt for a
            # legitimate crash and brick the boot
            await self.file.sync()
            await self.file.truncate(_HEADER_SIZE + live)
            await self.file.sync()

    async def read_frames(self, from_logical: int,
                          to_logical: int | None = None) -> list[tuple[bytes, int]]:
        """Re-read live frames in [from_logical, to_logical) — the TLog's
        spilled-by-reference peek path (REF:fdbserver/TLogServer.actor.cpp
        spilled data stays in the DiskQueue and is read back on demand).

        Every frame in the live region was pushed whole by this process,
        so a crc mismatch here is CORRUPTION, raised as ``DiskCorrupt``
        — a silent short read would hand the caller a hole it can't
        distinguish from a released prefix.  Frames already
        released by pop_to simply fall outside [front, end) and return
        an empty/short list, never an error."""
        pos = max(from_logical, self._front)
        stop = self._end if to_logical is None else min(to_logical, self._end)
        out: list[tuple[bytes, int]] = []
        while pos + _FRAME.size <= stop:
            ln, crc = _FRAME.unpack(await self.file.read(self._phys(pos),
                                                         _FRAME.size))
            data = await self.file.read(self._phys(pos) + _FRAME.size, ln)
            if len(data) < ln or zlib.crc32(data) != crc:
                raise DiskCorrupt(
                    f"disk queue frame at {pos} failed its crc on "
                    f"read-back (live region [{self._front}, {stop}))")
            pos += _FRAME.size + ln
            out.append((data, pos))
        return out

    @property
    def end_offset(self) -> int:
        return self._end

    @property
    def front_offset(self) -> int:
        """First live logical offset (recovery re-indexes frames from
        here — the change-feed side queue's restore path)."""
        return self._front

    @property
    def bytes_used(self) -> int:
        return self._end - self._front
