"""LSM key-value engine: memtable + WAL + sorted-run files + compaction.

Reference: the disk-backed IKeyValueStore engines —
REF:fdbserver/VersionedBTree.actor.cpp (Redwood) and
REF:fdbserver/KeyValueStoreRocksDB.actor.cpp — behind the same
IKeyValueStore surface as kv_store.MemoryKVStore.  Where the memory
engine caps the database at RAM and rewrites O(db) snapshots, this engine
keeps only the memtable in RAM:

- writes land in the WAL (DiskQueue, fsync per commit) + memtable;
- a full memtable flushes to an immutable sorted-run file (data blocks +
  a sparse index block + footer), newest-first;
- reads consult memtable then runs newest→oldest through a small LRU
  block cache (sync block reads — the page-cache path);
- compaction keeps the run count bounded.  Two disciplines live behind
  knob ``LSM_LEVELED_COMPACTION`` (the STORAGE_MVCC_COLUMNAR
  pattern — the monolithic twin kept verbatim for the A/B):

  * LEVELED (default): L0 holds the overlapping flush runs; L1+ hold
    key-range-DISJOINT partitioned runs.  A background compactor task
    picks the fullest level by debt score, merges one input set (the
    oldest L0 suffix, or one over-full level's largest partition) with
    only the OVERLAPPING next-level partitions, and rewrites just that
    slice — write amplification drops from O(keyspace) per cycle to
    O(overlap), and ``commit()`` never awaits a merge: it only nudges
    the compactor.  Merges are budget-sliced (knob
    ``LSM_COMPACT_SLICE_BYTES`` of input per event-loop yield), the
    common 2-source slice goes vectorized through
    ``KeyRun.run_positions`` + np.insert column stitches over the
    decoded blocks (the segment pair-merge discipline), and
    the heapq k-way merge is retained for k>2 fan-ins.  Tombstones
    drop only when the output level is the deepest non-empty one.

  * MONOLITHIC (knob off): every run merges into ONE from ``commit()``
    past ``_MAX_RUNS`` — the tiered behavior, verbatim.

- the MANIFEST names the live runs + per-run LEVEL (old manifests load
  as all-L0, so a pre-leveled disk upgrades in place and either mode
  opens the other's state) + engine metadata; every state change
  (flush/compact) writes MANIFEST atomically after the new files are
  durable, so a crash at any point — including mid-compaction, in
  either direction — recovers to a consistent run set.  Run files the
  manifest does not name (a kill between run write and manifest, or
  between manifest and input removal) are swept at open.
"""

from __future__ import annotations

import asyncio
import bisect
import heapq
import time
from collections import OrderedDict
from typing import Iterator

from ..rpc.wire import decode, encode
from .disk_queue import DiskQueue
from .key_runs import KeyRun
from .kv_store import OP_CLEAR, OP_SET

_TOMBSTONE = None          # value None in runs marks a deletion
_BLOCK_BYTES = 1 << 16
_MEMTABLE_BYTES = 1 << 22  # flush threshold (4MB)
_MAX_RUNS = 6              # compact when exceeded (monolithic mode) /
#                            L0 run-count trigger (leveled mode) — ONE
#                            constant so the monkeypatched test/smoke
#                            thresholds drive both twins identically
_MEM_RUN_ROWS = 2048       # memtable rows per bulk run (range_runs)
_CACHE_BLOCKS = 256        # LRU block cache entries (~16MB)
_FOOTER = b"LSM1"
_L0_MERGE_MAX = 16         # L0 runs one compaction folds at most
_L0_MERGE_MAX_BYTES = 64 << 20  # ...and at most this many input bytes
#                            a burst
#                            of fat L0 runs otherwise wedges the single
#                            compactor in one giant merge while debt at
#                            deeper levels starves; the pick stays the
#                            contiguous OLDEST suffix (shadowing safety),
#                            just a shorter one, and always takes >= 1 run
_COMPACT_RETRY_S = 0.5     # backoff after a failed (IoError) compaction
_COMPACT_MAX_RETRIES = 20  # consecutive NON-IoError failures before the
#                            compactor poisons the store: transient disk
#                            errors retry forever (gray failure owns a
#                            persistently bad disk), a DETERMINISTIC bug
#                            must surface loudly, not livelock forever


def _close_sync(f) -> None:
    """Best-effort close from a sync context (run-construction failure
    cleanup): both file types' ``close()`` coroutines contain no awaits,
    so one send() drives them to completion; anything else is dropped —
    this path only exists to keep error retries from leaking fds."""
    try:
        f.close().send(None)
    except StopIteration:
        pass
    except Exception:  # noqa: BLE001 — cleanup best-effort
        pass


class _Run:
    """One immutable sorted-run file: block-sparse index in RAM, data
    blocks read on demand through the shared cache."""

    def __init__(self, fs, path: str, cache: "_BlockCache") -> None:
        self.path = path
        self._f = fs.open(path)
        self._cache = cache
        self.level = 0          # leveled-compaction home (0 = overlapping)
        self._last: bytes | None = None     # span cache (last_key())
        try:
            size = self._f.size()
            self.bytes = size   # file size — the level-fullness operand
            foot = self._f.read_sync(size - 12, 12)
            if foot[8:] != _FOOTER:
                # runs are named by a manifest written only AFTER the
                # run file synced, so a bad footer is never a torn flush
                # — it is corruption of committed data, raised loudly
                from ..runtime.errors import DiskCorrupt
                raise DiskCorrupt(f"bad sorted-run footer in committed "
                                  f"run {path}")
            idx_off = int.from_bytes(foot[:8], "little")
            self.index = decode(
                self._f.read_sync(idx_off, size - 12 - idx_off))
            # index: list of [first_key, offset, length].  The sparse
            # index (block first keys) is a COLUMNAR KeyRun
            # (storage/key_runs.py): one blob + bounds +
            # cached u64 prefixes — the same layout PackedKeyIndex's
            # base run uses, deduplicating the searchsorted-over-
            # prefixes discipline this file had grown its own copy of
            # (the old first_keys list + _fk_pfx pair)
            self.first_keys = KeyRun.from_keys(
                [bytes(e[0]) for e in self.index])
        except BaseException:
            # construction failure (IoError mid-read, corrupt footer):
            # release the fd — open()/compactor callers RETRY, and each
            # leaked handle on a real fs walks toward EMFILE
            f, self._f = self._f, None
            _close_sync(f)
            raise

    def _block(self, i: int) -> list:
        key = (self.path, i)
        blk = self._cache.get(key)
        if blk is None:
            _, off, ln = self.index[i]
            blk = decode(self._f.read_sync(off, ln))
            self._cache.put(key, blk)
        return blk

    async def close(self) -> None:
        """Release the run's file handle (idempotent) — called when the
        run is retired by a compaction or the store closes; a real fd
        left open on an unlinked file leaks until EMFILE."""
        f, self._f = self._f, None
        if f is not None:
            await f.close()

    # --- key span (the leveled compactor's overlap operands) ---

    def first_key(self) -> bytes:
        return self.first_keys.key(0)

    def last_key(self) -> bytes:
        """Largest key in the run (one cached block decode — the sparse
        index only names block FIRST keys)."""
        if self._last is None:
            self._last = bytes(self._block(len(self.index) - 1)[-1][0])
        return self._last

    def iter_blocks(self) -> Iterator[list]:
        """Every data block in key order — the compaction input stream
        (rows include tombstones).  Reads AROUND the shared LRU block
        cache on miss: each input block is consumed exactly once and
        its file is deleted right after the merge, so inserting them
        would only evict the read path's hot set."""
        for i in range(len(self.index)):
            blk = self._cache.get((self.path, i))
            if blk is None:
                _, off, ln = self.index[i]
                blk = decode(self._f.read_sync(off, ln))
            yield blk

    def get(self, key: bytes) -> tuple[bool, bytes | None]:
        """(found, value-or-tombstone)."""
        i = self.first_keys.bisect_right(key) - 1
        if i < 0:
            return False, None
        blk = self._block(i)
        keys = [bytes(e[0]) for e in blk]
        j = bisect.bisect_left(keys, key)
        if j < len(keys) and keys[j] == key:
            v = blk[j][1]
            return True, (bytes(v) if v is not None else None)
        return False, None

    def get_batch_into(self, keys: list[bytes], idxs: list[int],
                       out: list) -> list[int]:
        """Probe ``keys[i] for i in idxs`` (idxs ascending over sorted
        keys) against this run, writing hits — including tombstones —
        into ``out``; returns the still-unresolved indices for the next
        (older) run.  The block per probe resolves in ONE vectorized
        ``searchsorted`` over the sparse index's cached u64 prefixes
        (``KeyRun.batch_bisect`` — the shared home of the
        PackedKeyIndex bound-batch discipline), a bisect refining
        inside the equal-prefix band; each touched block is then
        decoded exactly once per batch."""
        fk = self.first_keys
        if not fk:
            return idxs
        blocks = [b - 1 for b in
                  fk.batch_bisect([keys[i] for i in idxs], side="right",
                                  sorted_keys=True)]
        remaining: list[int] = []
        cur = -1
        bkeys: list[bytes] = []
        blk: list = []
        for i, b in zip(idxs, blocks):
            if b < 0:
                remaining.append(i)
                continue
            if b != cur:        # idxs sorted => blocks non-decreasing
                cur = b
                blk = self._block(b)
                bkeys = [bytes(e[0]) for e in blk]
            j = bisect.bisect_left(bkeys, keys[i])
            if j < len(bkeys) and bkeys[j] == keys[i]:
                v = blk[j][1]
                out[i] = bytes(v) if v is not None else None
            else:
                remaining.append(i)
        return remaining

    def iter_range(self, begin: bytes, end: bytes,
                   reverse: bool = False) -> Iterator[tuple[bytes, bytes | None]]:
        lo = max(0, self.first_keys.bisect_right(begin) - 1)
        hi = self.first_keys.bisect_left(end)
        blocks = range(lo, min(hi + 1, len(self.index)))
        if reverse:
            blocks = reversed(blocks)
        for i in blocks:
            blk = self._block(i)
            entries = reversed(blk) if reverse else blk
            for k, v in entries:
                k = bytes(k)
                if k < begin or k >= end:
                    continue
                yield k, (bytes(v) if v is not None else None)

    def range_blocks(self, begin: bytes,
                     end: bytes) -> Iterator[list]:
        """Forward block RUNS of [begin, end): each touched block
        decoded once, the boundary blocks trimmed by bisect, interior
        blocks sliced wholesale — the searchsorted-over-sorted-index
        discipline of ``get_batch_into`` generalized from point probes
        to interval extraction.  Rows include tombstones
        (value None): the engine-level newest-wins merge needs them."""
        fk = self.first_keys
        if not fk:
            return
        first = lambda e: e[0]  # noqa: E731 — bisect key
        lo = max(0, fk.bisect_right(begin) - 1)
        stop = max(fk.bisect_left(end), lo + 1)
        for i in range(lo, stop):
            # the decoder already hands back bytes keys/values, so rows
            # pass through with NO per-row re-materialization: interior
            # blocks yield the cached block list itself (read-only by
            # contract), boundary blocks yield one slice
            blk = self._block(i)
            if i == lo or i == stop - 1:
                s = (bisect.bisect_left(blk, begin, key=first)
                     if i == lo else 0)
                t = (bisect.bisect_left(blk, end, key=first)
                     if i == stop - 1 else len(blk))
                if s >= t:
                    continue
                yield blk[s:t] if (s or t < len(blk)) else blk
            else:
                yield blk


class _BlockCache:
    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()

    def get(self, key):
        blk = self._d.get(key)
        if blk is not None:
            self._d.move_to_end(key)
        return blk

    def put(self, key, blk) -> None:
        self._d[key] = blk
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def drop_file(self, path: str) -> None:
        for k in [k for k in self._d if k[0] == path]:
            del self._d[k]


class LsmSparseIndex:
    """Merged block directory over every sorted run — the lsm engine's
    ``packed_index``.

    The per-run sparse indexes (block first keys) merge into ONE sorted
    ``KeyRun`` with parallel (run, block) back-pointer columns and a
    per-run prefix-max table, so a probe key's candidate block in EVERY
    run falls out of a single sorted-array bound:

        pos = bisect_right(merged, key)
        candidate block of run r = blockmax[pos][r]
          (== bisect_right(run_r.first_keys, key) - 1, by construction)

    That single sorted u64-prefix array is exactly the shape the device
    read mirror consumes (device/read_serve.py): one vectorized
    ``searchsorted`` per ``get_values`` batch locates the candidate
    block in every run at once, replacing the per-run host searchsorted
    descent — the surface where the device gather finally sits over a
    real probe structure instead of MemoryKVStore's O(1) dict.

    ``gen`` bumps whenever the run SET changes (open/flush/compact);
    memtable writes never stale it — the memtable is probed host-side
    by ``get_batch_located``, the lsm twin of the pending-overlay
    contract the PackedKeyIndex mirror already has."""

    device_mode = "blocks"      # host refinement the device mirror needs

    __slots__ = ("_store", "gen", "_cache")

    def __init__(self, store: "LSMKVStore") -> None:
        self._store = store
        self.gen = 0
        self._cache: tuple | None = None    # (merged KeyRun, blockmax)

    def bump(self) -> None:
        self.gen += 1
        self._cache = None

    def _ensure(self) -> tuple:
        if self._cache is None:
            import numpy as np
            runs = self._store._runs
            entries: list[tuple[bytes, int, int]] = []
            for r_i, run in enumerate(runs):
                fk = run.first_keys
                entries.extend((fk.key(b_i), r_i, b_i)
                               for b_i in range(len(fk)))
            entries.sort()
            merged = KeyRun.from_keys([e[0] for e in entries])
            n, nr = len(entries), len(runs)
            blockmax = np.full((n + 1, max(nr, 1)), -1, dtype=np.int64)
            if n and nr:
                run_of = np.fromiter((e[1] for e in entries),
                                     dtype=np.int64, count=n)
                block_of = np.fromiter((e[2] for e in entries),
                                       dtype=np.int64, count=n)
                for r in range(nr):
                    col = np.where(run_of == r, block_of, -1)
                    # blocks within a run appear in ascending order, so
                    # the running max IS the newest block at-or-before
                    np.maximum.accumulate(col, out=col)
                    blockmax[1:, r] = col
            self._cache = (merged, blockmax)
        return self._cache

    # --- the device-mirror surface (DeviceKeyDirectory contract) ---

    def base_run(self) -> KeyRun:
        return self._ensure()[0]

    def pending_run(self) -> list[bytes]:
        return []               # the memtable is handled host-side

    def base_prefixes(self):
        return self._ensure()[0].prefixes()


class LSMKVStore:
    """IKeyValueStore-compatible LSM engine (see kv_store.MemoryKVStore
    for the surface contract)."""

    def __init__(self, fs, prefix: str, knobs=None) -> None:
        from ..runtime.knobs import KNOBS
        self.fs = fs
        self.prefix = prefix
        self.knobs = knobs if knobs is not None else KNOBS
        self.meta: dict = {}
        self._mem: dict[bytes, bytes | None] = {}   # None = tombstone
        self._mem_index: list[bytes] = []
        self._mem_bytes = 0
        # serving order, newest-wins by position: L0 newest-first, then
        # each deeper level's disjoint partitions.  ``_runs`` is the ONE
        # flattened list every read path (and the sparse index) walks;
        # ``_levels`` is the compactor's structured view of the same
        # runs — ``_rebuild_runs`` keeps them in lockstep.
        self._runs: list[_Run] = []                 # newest first
        self._levels: list[list[_Run]] = [[]]
        self._cache = _BlockCache(_CACHE_BLOCKS)
        self._sparse = LsmSparseIndex(self)
        self._wal: DiskQueue | None = None
        self._wal_file = None
        self._gen = 0
        self._wal_gen = 0
        # --- leveled background compaction ---
        self._leveled = bool(self.knobs.LSM_LEVELED_COMPACTION)
        self._io_lock = asyncio.Lock()      # run-set install + MANIFEST
        self._compact_task: asyncio.Task | None = None
        self._compact_event = asyncio.Event()
        self._job_active = False
        self._poison: Exception | None = None   # DiskCorrupt from the
        #                                         compactor, re-raised
        #                                         loudly at next commit
        self._closed = False
        # write-amplification accounting: ingested = flushed run bytes,
        # rewritten = compaction output bytes (both modes count the
        # same way, so the A/B ratio is apples-to-apples)
        self.flush_bytes = 0
        self.compact_bytes = 0
        self.compactions = 0
        self._stall_s_max = 0.0     # commit-path compaction stalls
        self._stall_s_total = 0.0
        self._stalls = 0
        # the dual-slot manifest persist (rpc/wire.SlottedBlob); open()
        # replaces it with the loaded/armed instance
        from ..rpc.wire import SlottedBlob
        self._man_sb = SlottedBlob(fs, prefix,
                                   (".MANIFEST.a", ".MANIFEST.b"))

    # --- lifecycle ---

    @classmethod
    async def _load_manifest(cls, fs, prefix: str
                             ) -> tuple[dict | None, int, "SlottedBlob"]:
        """Newest valid manifest from the shared dual-slot helper
        (rpc/wire.py ``SlottedBlob`` — ONE audited corruption policy),
        falling back to the two pre-helper
        slot formats: the crc-framed dict-with-seq slots, and
        the original rewritten-in-place single file (which a torn kill
        could destroy outright).  Returns (manifest, slots seen, the
        armed helper for subsequent saves)."""
        from ..rpc.wire import SlottedBlob, unframe
        sb = SlottedBlob(fs, prefix, (".MANIFEST.a", ".MANIFEST.b"))
        payload, found = await sb.load()
        if payload is not None:
            return decode(payload), found, sb
        best = None
        for suffix in (".MANIFEST.a", ".MANIFEST.b"):
            f = fs.open(prefix + suffix)
            blob = await f.read(0, f.size())
            await f.close()
            if not blob:
                continue
            try:
                man = decode(unframe(blob))
            except Exception:  # noqa: BLE001 — torn slot: other one wins
                continue
            if best is None or man.get("seq", 0) > best.get("seq", 0):
                best = man
        if best is not None:
            # keep the slot alternation continuous across the envelope
            # migration: the next save must NOT target the only valid
            # old-format slot
            sb.seed(best.get("seq", 0))
            return best, found, sb
        legacy = fs.open(prefix + ".MANIFEST")
        blob = await legacy.read(0, legacy.size())
        await legacy.close()
        if blob:
            found += 1
            try:
                return decode(blob), found, sb
            except Exception:  # noqa: BLE001 — caller decides torn/corrupt
                pass
        return None, found, sb

    @classmethod
    async def open(cls, fs, prefix: str, knobs=None) -> "LSMKVStore":
        kv = cls(fs, prefix, knobs)
        try:
            return await kv._open_into(fs, prefix)
        except BaseException:
            # a failed open (IoError mid-read, DiskCorrupt) releases
            # every handle it acquired: the worker adoption path RETRIES
            # transient errors, and each leaked run/WAL fd on a real fs
            # walks toward EMFILE
            await kv.close()
            raise

    async def _open_into(self, fs, prefix: str) -> "LSMKVStore":
        kv, cls = self, type(self)
        man, slots_seen, kv._man_sb = await cls._load_manifest(fs, prefix)
        if man is not None:
            kv.meta = man["meta"]
            kv._gen = man["gen"]
            kv._wal_gen = man.get("wal_gen", 0)
            # per-run levels: manifests predating the leveled
            # compactor carry no "levels" — every run loads as L0
            # (overlapping), exactly the monolithic twin's shape, and
            # the compactor partitions it in place from there
            levels = man.get("levels") or [0] * len(man["runs"])
            for path, lvl in zip(man["runs"], levels):
                run = _Run(fs, str(path), kv._cache)
                run.level = int(lvl)
                kv._level(run.level).append(run)
            for lvl_runs in kv._levels[1:]:
                # disjoint levels serve in any order; keep them sorted
                # by span so overlap selection stays a clean scan
                lvl_runs.sort(key=lambda r: r.first_key())
            kv._rebuild_runs()
            kv._sparse.bump()
        kv._wal_file = fs.open(prefix + ".wal")
        kv._wal, frames = await DiskQueue.open(kv._wal_file)
        recs = [decode(frame) for frame, _end in frames]
        if man is None and slots_seen:
            # manifest slots exist but none decodes.  A kill tearing the
            # FIRST-ever manifest write is legitimate (the WAL was not
            # yet popped, so gen-0 frames rebuild everything); but WAL
            # frames at gen > 0 — or committed runs with no WAL at all —
            # prove a synced manifest once existed and was popped
            # against: recovering without it would silently resurrect a
            # partial ancient state
            gens = [r["gen"] for r in recs]
            has_runs = bool(fs.listdir(prefix + ".run."))
            if (gens and min(gens) > 0) or (has_runs and not gens):
                from ..runtime.errors import DiskCorrupt
                raise DiskCorrupt(
                    f"no readable MANIFEST among {slots_seen} slots for "
                    f"{prefix} while committed runs/WAL generations "
                    f"reference one — the committed run set is damaged, "
                    f"refusing silent recovery")
        for rec in recs:
            if rec["gen"] < kv._wal_gen:
                continue        # folded into a flushed run already
            kv._apply_mem(rec["ops"])
            kv.meta = rec["meta"]
        kv._mem_index = sorted(kv._mem)
        if man is not None:
            # sweep run files the manifest does not name: a kill between
            # a compaction's run write and its manifest (new runs
            # orphaned) or between manifest and input removal (old runs
            # orphaned) leaves unnamed files — harmless to serving,
            # reclaimed here so either crash direction converges.  BOTH
            # modes sweep: the monolithic twin leaves the same orphans
            # at the same crash cuts, and a leveled-mode crash may be
            # reopened with the knob off (either mode opens the other's
            # MANIFEST)
            live = {r.path for r in kv._runs}
            for path in fs.listdir(prefix + ".run."):
                if path not in live:
                    fs.remove(path)
        if kv._leveled and kv._has_debt():
            # inherited run debt: a reopened store
            # starts compacting immediately instead of waiting for the
            # next commit to re-check the trigger
            kv._nudge()
        return kv

    async def close(self) -> None:
        self._closed = True
        t = self._compact_task
        if t is not None and not t.done():
            t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        if self._wal_file is not None:
            await self._wal_file.close()
            self._wal_file = None
        # the level view, not _runs: a failed open() cleans up runs
        # loaded before _rebuild_runs ever ran
        for lvl_runs in self._levels:
            for r in lvl_runs:
                try:
                    await r.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass

    def __len__(self) -> int:
        n = 0
        for _ in self.range(b"", b"\xff\xff\xff\xff"):
            n += 1
        return n

    # --- reads ---

    @property
    def packed_index(self) -> LsmSparseIndex:
        """The merged sparse-index directory — the capability probe the
        device read path keys on (device/read_serve.py)."""
        return self._sparse

    def get(self, key: bytes) -> bytes | None:
        if key in self._mem:
            return self._mem[key]
        for run in self._runs:
            found, v = run.get(key)
            if found:
                return v
        return None

    def get_batch(self, keys: list[bytes]) -> list[bytes | None]:
        """Batched point reads over SORTED keys (the multiget engine
        fall-through): one memtable dict pass, then each run probed
        once via its vectorized sparse-index search — every touched
        data block decodes once per batch instead of once per key."""
        out: list[bytes | None] = [None] * len(keys)
        mem = self._mem
        pending: list[int] = []
        for i, k in enumerate(keys):
            if k in mem:
                out[i] = mem[k]     # value or tombstone (None): resolved
            else:
                pending.append(i)
        for run in self._runs:
            if not pending:
                break
            pending = run.get_batch_into(keys, pending, out)
        return out

    def get_batch_located(self, keys: list[bytes],
                          pos: list[int]) -> list[bytes | None]:
        """Finish a device-located batch: ``pos[i]`` is the
        bisect_right of ``keys[i]`` over the merged sparse directory
        (``packed_index.base_run()``) — computed by the device mirror's
        vectorized searchsorted.  The host half probes the memtable
        first, then each run's candidate block newest→oldest, resolving
        tombstones newest-wins — result identical to ``get_batch`` on
        the same keys by construction (the directory's prefix-max table
        reproduces exactly each run's ``bisect_right(first_keys) - 1``
        block choice), and tested."""
        _merged, blockmax = self._sparse._ensure()
        out: list[bytes | None] = [None] * len(keys)
        mem = self._mem
        runs = self._runs
        bkeys_cache: dict[tuple[int, int], list[bytes]] = {}
        for i, k in enumerate(keys):
            if k in mem:
                out[i] = mem[k]
                continue
            row = blockmax[pos[i]]
            for r_i in range(len(runs)):
                b = int(row[r_i])
                if b < 0:
                    continue
                ck = (r_i, b)
                bkeys = bkeys_cache.get(ck)
                blk = runs[r_i]._block(b)
                if bkeys is None:
                    bkeys = [bytes(e[0]) for e in blk]
                    bkeys_cache[ck] = bkeys
                j = bisect.bisect_left(bkeys, k)
                if j < len(bkeys) and bkeys[j] == k:
                    v = blk[j][1]
                    out[i] = bytes(v) if v is not None else None
                    break
        return out

    def range(self, begin: bytes, end: bytes,
              reverse: bool = False) -> Iterator[tuple[bytes, bytes]]:
        """Newest-wins k-way merge of memtable + runs, tombstones elided."""
        sources: list[Iterator[tuple[bytes, bytes | None]]] = []

        def mem_iter():
            lo = bisect.bisect_left(self._mem_index, begin)
            hi = bisect.bisect_left(self._mem_index, end)
            keys = self._mem_index[lo:hi]
            if reverse:
                keys = list(reversed(keys))
            for k in keys:
                yield k, self._mem[k]

        sources.append(mem_iter())
        sources.extend(r.iter_range(begin, end, reverse) for r in self._runs)
        yield from _merge(sources, reverse)

    def _mem_runs(self, begin: bytes, end: bytes) -> Iterator[list]:
        """Memtable rows of [begin, end) as bulk runs, tombstones kept."""
        lo = bisect.bisect_left(self._mem_index, begin)
        hi = bisect.bisect_left(self._mem_index, end)
        mem = self._mem
        for i in range(lo, hi, _MEM_RUN_ROWS):
            yield [(k, mem[k])
                   for k in self._mem_index[i:min(i + _MEM_RUN_ROWS, hi)]]

    def range_runs(self, begin: bytes,
                   end: bytes) -> Iterator[list]:
        """Forward scan of [begin, end) as bulk row RUNS: newest-wins
        across memtable + sorted runs with tombstones elided, flattened
        output byte-identical to ``range(..., reverse=False)``.  Rows
        are (key, value) SEQUENCES — tuples or the block decoder's
        2-item lists — and runs may alias cached block storage:
        consumers index and slice, never mutate or type-match.

        A range held by ONE source (the post-compaction common case)
        streams its block runs straight through.  Overlapping sources
        merge SEGMENT-wise: each round cuts at the smallest buffered
        tail key — so no source decodes blocks past what the consumer
        needs — and resolves the segment with one C-speed sort + linear
        dedup (newest source first) instead of a per-row heap."""
        sources = [self._mem_runs(begin, end)]
        sources += [r.range_blocks(begin, end) for r in self._runs]
        # newest first: position in ``bufs`` is the win priority on
        # duplicate keys (memtable beats every run, newer runs beat
        # older); filtering exhausted sources preserves relative order
        bufs: list[list] = []
        for src in sources:
            rows = next(src, None)
            if rows:
                bufs.append([rows, src])
        first = lambda r: r[0]  # noqa: E731 — bisect key
        while bufs:
            if len(bufs) == 1:
                rows, src = bufs[0]
                while rows is not None:
                    live = [e for e in rows if e[1] is not None]
                    if live:
                        yield live
                    rows = next(src, None)
                return
            pivot = min(rows[-1][0] for rows, _src in bufs)
            seg: list[list] = []
            for entry in bufs:
                rows, src = entry
                if rows[-1][0] <= pivot:
                    part = rows
                    entry[0] = next(src, None)
                else:
                    cut = bisect.bisect_right(rows, pivot, key=first)
                    part = rows[:cut]
                    entry[0] = rows[cut:]
                if part:
                    seg.append(part)
            bufs = [entry for entry in bufs if entry[0]]
            if not seg:
                continue
            if len(seg) > 1:
                # span-disjoint parts (sequential flushes stripe the
                # keyspace, so segments usually interleave WITHOUT
                # overlapping) concatenate in span order — no sort, no
                # per-row dedup
                order = sorted(range(len(seg)), key=lambda i: seg[i][0][0])
                if all(seg[order[i]][-1][0] < seg[order[i + 1]][0][0]
                       for i in range(len(order) - 1)):
                    for i in order:
                        live = [e for e in seg[i] if e[1] is not None]
                        if live:
                            yield live
                    continue
                # overlapping parts: (key, priority, value) triples —
                # one sort resolves order AND newest-wins (priority
                # breaks key ties; a key appears at most once per
                # source, so values are never compared)
                merged: list[tuple] = []
                for prio, part in enumerate(seg):
                    merged += [(k, prio, v) for k, v in part]
                merged.sort()
                out: list[tuple[bytes, bytes]] = []
                last = None
                for k, _prio, v in merged:
                    if k == last:
                        continue
                    last = k
                    if v is not None:
                        out.append((k, v))
                if out:
                    yield out
                continue
            live = [e for e in seg[0] if e[1] is not None]
            if live:
                yield live

    # --- writes ---

    def _apply_mem(self, ops: list[tuple[int, bytes, bytes]]) -> None:
        for op, p1, p2 in ops:
            if op == OP_SET:
                old = self._mem.get(p1)
                self._mem[p1] = p2
                self._mem_bytes += len(p1) + len(p2) - (len(old) if old else 0)
            else:
                # a clear becomes per-key tombstones over every key known
                # ANYWHERE (memtable or runs) in [p1, p2): point lookups
                # must see the deletion without a range check
                for k, _ in list(self.range(p1, p2)):
                    self._mem[k] = _TOMBSTONE
                for k in [k for k in self._mem if p1 <= k < p2]:
                    self._mem[k] = _TOMBSTONE

    async def commit(self, ops, meta: dict) -> None:
        if self._poison is not None:
            # the background compactor hit committed-data corruption:
            # surface it LOUDLY on the commit path
            # instead of serving on silently with compaction wedged
            raise self._poison
        if not isinstance(ops, list):
            # PackedOps slice from the durability ring: this engine's WAL
            # frames stay tuple-shaped, so materialize the slice once
            ops = [(op, p1, p2) for op, p1, p2 in ops]
        rec = encode({"gen": self._gen, "ops": ops, "meta": meta})
        await self._wal.push(rec)
        await self._wal.commit()
        self._apply_mem(ops)
        self.meta = meta
        self._mem_index = sorted(self._mem)
        if self._mem_bytes > _MEMTABLE_BYTES:
            await self._flush()
        if self._leveled:
            # never await a merge here: debt only NUDGES the background
            # compactor (checked every commit, not just after a flush
            # this commit triggered — the decoupled trigger)
            pending = self._has_debt()
            if pending:
                self._nudge()
            if pending or self._job_active:
                # one loop yield per commit while a merge is in flight:
                # a tight commit burst whose awaits never suspend (the
                # in-memory sim fs) would otherwise starve the
                # compactor outright — L0 then grows without bound and
                # every read/clear walks the pile.  The yield hands the
                # merge exactly one slice (LSM_COMPACT_SLICE_BYTES), so
                # this is ALSO the only compaction cost a commit can
                # ever see — bounded, and ~100x smaller than the
                # monolithic twin's inline merge-all (perf_smoke
                # --stage compact holds it at ≤20%)
                await asyncio.sleep(0)
        elif len(self._runs) > _MAX_RUNS:
            t0 = time.perf_counter()
            await self._compact()
            self._note_stall(time.perf_counter() - t0)

    # --- flush / compaction ---

    async def _write_run(self, items: Iterator[tuple[bytes, bytes | None]],
                         drop_tombstones: bool) -> str | None:
        """Single-run file write (flush / monolithic compaction): the
        ``_RunWriter`` streaming format with an unbounded partition
        target, so exactly one run emerges — ONE home for the on-disk
        run layout (block emit / index / footer / fsync)."""
        w = _RunWriter(self, 1 << 62)
        rows: list = []
        try:
            for row in items:
                rows.append(row)
                if len(rows) >= 4096:
                    await w.add_rows(rows, drop_tombstones)
                    rows = []
            if rows:
                await w.add_rows(rows, drop_tombstones)
            paths = await w.finish()
        except BaseException:
            await w.abort()
            raise
        return paths[0] if paths else None

    async def _write_manifest(self) -> None:
        """One save through the shared dual-slot helper: the
        slot not being written always holds the previous valid manifest,
        so a kill tearing this write can never lose the committed run
        set, and a failed (retried) write re-targets the same slot.
        Callers racing the background compactor hold ``_io_lock``."""
        await self._man_sb.save(encode({
            "gen": self._gen, "wal_gen": self._wal_gen, "meta": self.meta,
            "runs": [r.path for r in self._runs],
            "levels": [r.level for r in self._runs]}))

    async def _flush(self) -> None:
        def items():
            for k in self._mem_index:
                yield k, self._mem[k]

        path = await self._write_run(items(), drop_tombstones=not self._runs)
        # install + manifest under the io lock: the background
        # compactor's install is the only concurrent manifest writer,
        # and the SlottedBlob alternation must never interleave
        t0 = time.perf_counter()
        async with self._io_lock:
            wait = time.perf_counter() - t0
            if wait > 0.0005:
                self._note_stall(wait)      # leveled-mode commit stall:
                #                             waiting out an install
            if path is not None:
                run = _Run(self.fs, path, self._cache)
                run.level = 0
                self._levels[0].insert(0, run)
                self._rebuild_runs()
                self._sparse.bump()
                self.flush_bytes += run.bytes
            # WAL records below the new gen are folded into the run
            self._wal_gen = self._gen
            await self._write_manifest()
            await self._wal.pop_to(self._wal.end_offset)
        self._mem.clear()
        self._mem_index = []
        self._mem_bytes = 0

    async def _compact(self) -> None:
        """Monolithic compaction (knob off): merge every run into one
        (tombstones drop at the bottom) — the tiered behavior,
        awaited inline from commit(), kept verbatim as the A/B twin."""
        old = list(self._runs)
        merged = _merge([r.iter_range(b"", b"\xff\xff\xff\xff")
                         for r in old], reverse=False, keep_tombstones=False)
        path = await self._write_run(merged, drop_tombstones=True)
        if path:
            run = _Run(self.fs, path, self._cache)
            self.compact_bytes += run.bytes
            self._levels = [[run]]
        else:
            self._levels = [[]]
        self._rebuild_runs()
        self._sparse.bump()
        await self._write_manifest()
        self.compactions += 1
        for r in old:
            self._cache.drop_file(r.path)
            await r.close()
            self.fs.remove(r.path)

    # --- leveled background compaction ---

    def _level(self, i: int) -> list:
        while len(self._levels) <= i:
            self._levels.append([])
        return self._levels[i]

    def _rebuild_runs(self) -> None:
        """Re-derive the flattened serving list from the level view
        (priority = position: L0 newest-first, then deeper levels)."""
        while len(self._levels) > 1 and not self._levels[-1]:
            self._levels.pop()
        self._runs = [r for lvl in self._levels for r in lvl]

    def _note_stall(self, dt: float) -> None:
        self._stalls += 1
        self._stall_s_total += dt
        if dt > self._stall_s_max:
            self._stall_s_max = dt

    def _level_cap(self, i: int) -> int:
        """Byte capacity of level i >= 1 before its fullness scores a
        compaction: the L0-equivalent budget times FANOUT**(i-1).  Reads
        the module constants at call time so monkeypatched test/smoke
        thresholds scale the whole geometry."""
        base = max(1, _MEMTABLE_BYTES * (_MAX_RUNS + 1))
        return base * (max(2, self.knobs.LSM_LEVEL_FANOUT) ** (i - 1))

    def _over_budget(self):
        """Yields (level, over_bytes, score) for every level past its
        budget — the ONE home of the compaction trigger condition:
        `_debt_bytes`/`_has_debt`/`_pick_job` all derive from it, so
        the commit-path trigger and the job selector can never
        disagree.  O(levels) arithmetic, no key spans, no block
        decodes."""
        l0 = self._levels[0]
        if len(l0) > _MAX_RUNS:
            yield (0, sum(r.bytes for r in l0[_MAX_RUNS:]),
                   len(l0) / _MAX_RUNS)
        for i in range(1, len(self._levels)):
            runs = self._levels[i]
            if not runs:
                continue
            cap = self._level_cap(i)
            size = sum(r.bytes for r in runs)
            if size > cap:
                yield i, size - cap, size / cap

    def _debt_bytes(self) -> int:
        """Bytes of run data sitting past its level's budget — the
        compactor's backlog (0 = idle)."""
        if not self._leveled:
            return (sum(r.bytes for r in self._runs)
                    if len(self._runs) > _MAX_RUNS else 0)
        return sum(over for _lvl, over, _score in self._over_budget())

    def _has_debt(self) -> bool:
        """Whether any level is past its budget — `_pick_job() is not
        None` at per-commit-trigger cost."""
        return self._leveled and \
            next(self._over_budget(), None) is not None

    def _pick_job(self):
        """The next compaction, by debt score (level fullness; the
        overlap bytes it implies are what the job then bounds itself
        to), or None when every level is inside budget.  Deterministic:
        no RNG, ties broken by level then run path, so same-seed sims
        replay the same schedule."""
        if not self._leveled:
            return None
        # max() keeps the FIRST maximal element: ties break to the
        # shallower level, like the strict-> scan it replaces
        best = max(self._over_budget(), key=lambda t: t[2], default=None)
        if best is None:
            return None
        lvl = best[0]
        l0 = self._levels[0]
        if lvl == 0:
            # the OLDEST L0 suffix (list is newest-first), bounded by
            # count AND cumulative bytes: the remaining newer runs keep
            # shadowing the output correctly
            n, acc = 0, 0
            for r in reversed(l0):          # oldest first
                if n >= _L0_MERGE_MAX:
                    break
                acc += r.bytes
                if n > 0 and acc > _L0_MERGE_MAX_BYTES:
                    break
                n += 1
            sel = list(l0[-n:])
        else:
            runs = self._levels[lvl]
            sel = [max(runs, key=lambda r: (r.bytes, r.path))]
        lo = min(r.first_key() for r in sel)
        hi = max(r.last_key() for r in sel)
        out = lvl + 1
        nxt = self._levels[out] if out < len(self._levels) else []
        overlap = [r for r in nxt
                   if not (r.last_key() < lo or hi < r.first_key())]
        # tombstones drop only at the DEEPEST non-empty level: nothing
        # below the output can hold an older shadowed version
        drop = not any(self._levels[j]
                       for j in range(out + 1, len(self._levels)))
        return sel, overlap, lvl, out, drop

    def _nudge(self) -> None:
        """Wake (spawning lazily) the background compactor — the only
        thing the commit path ever does about compaction debt."""
        if not self._leveled or self._poison is not None or self._closed:
            return
        if self._compact_task is None or self._compact_task.done():
            self._compact_task = asyncio.get_running_loop().create_task(
                self._compact_loop(), name=f"lsm-compact-{self.prefix}")
        self._compact_event.set()

    async def wait_compaction_idle(self) -> None:
        """Drain the compactor to a debt-free state (tests / smokes /
        benches — production never waits)."""
        if not self._leveled:
            return
        while True:
            if self._poison is not None:
                raise self._poison
            if self._closed:
                return      # nothing left to drain the debt — a closed
                #             store must not spin a waiter forever
            if not self._job_active and not self._has_debt():
                return
            self._nudge()
            await asyncio.sleep(0.01)

    async def _compact_loop(self) -> None:
        from ..runtime.errors import DiskCorrupt, IoError
        from ..runtime.trace import TraceEvent
        failures = 0
        while not self._closed:
            try:
                job = self._pick_job()
                if job is None:
                    self._compact_event.clear()
                    await self._compact_event.wait()
                    continue
                self._job_active = True
                try:
                    await self._run_job(*job)
                finally:
                    self._job_active = False
                failures = 0
            except asyncio.CancelledError:
                raise
            except DiskCorrupt as e:
                # committed-data corruption must be LOUD: the
                # compactor stops and the next commit re-raises
                self._poison = e
                TraceEvent("LsmCompactCorrupt", severity=40) \
                    .detail("Prefix", self.prefix).error(e).log()
                return
            except Exception as e:  # noqa: BLE001 — retry/poison below
                if isinstance(e, IoError):
                    # transient disk trouble: retry forever with backoff
                    # — a persistently bad disk is the PR-11 gray-failure
                    # machinery's job (degraded flag, DD avoidance), and
                    # a healed one must find a LIVE compactor, never a
                    # store poisoned by a long-gone outage.  The
                    # non-IoError count is NOT reset here (only a
                    # completed job resets it): interleaved disk faults
                    # must not defeat the deterministic-bug backstop
                    pass
                else:
                    failures += 1
                    if failures >= _COMPACT_MAX_RETRIES:
                        # a non-disk error failing every retry is a
                        # DETERMINISTIC bug: poison the store so the next
                        # commit raises it — debt silently growing while
                        # the loop spins at 2Hz is the one livelock shape
                        # this subsystem must never have
                        self._poison = e
                        TraceEvent("LsmCompactWedged", severity=40) \
                            .detail("Prefix", self.prefix) \
                            .detail("Failures", failures).error(e).log()
                        return
                TraceEvent("LsmCompactError", severity=30) \
                    .detail("Prefix", self.prefix).error(e).log()
                await asyncio.sleep(_COMPACT_RETRY_S)

    async def _run_job(self, sel: list, overlap: list, src_level: int,
                       out_level: int, drop: bool) -> None:
        """One compaction: merge ``sel`` (newer) with the overlapping
        next-level partitions, write partition-sized output runs, then
        install atomically — new runs fsync'd BEFORE the manifest names
        them, input files removed only AFTER, so a kill at any await
        recovers to a valid run set in either direction."""
        from ..runtime.trace import TraceEvent
        if len(sel) == 1 and not overlap:
            # trivial move (the RocksDB discipline): a single input run
            # disjoint with the ENTIRE output level just changes its
            # level field — zero bytes rewritten, one manifest write.
            # This is how a deep level absorbs spill from the one above
            # without the geometric rewrite the debt score would
            # otherwise keep charging.
            run = sel[0]
            async with self._io_lock:
                src = self._level(src_level)
                src[:] = [r for r in src if r is not run]
                run.level = out_level
                out = self._level(out_level)
                out.append(run)
                out.sort(key=lambda r: r.first_key())
                self._rebuild_runs()
                self._sparse.bump()
                await self._write_manifest()
            self.compactions += 1
            TraceEvent("LsmCompactMove").detail("Prefix", self.prefix) \
                .detail("Level", src_level).detail("OutLevel", out_level) \
                .detail("Bytes", run.bytes).log()
            return
        inputs = sel + overlap      # newest-first = win priority
        writer = _RunWriter(self, max(2 * _MEMTABLE_BYTES, 4 * _BLOCK_BYTES))
        budget = max(1, self.knobs.LSM_COMPACT_SLICE_BYTES)
        consumed = 0

        async def write(rows: list) -> None:
            nonlocal consumed
            consumed += await writer.add_rows(rows, drop)
            if consumed >= budget:
                # the slice budget: yield the loop so commits never
                # queue behind a long merge
                consumed = 0
                await asyncio.sleep(0)

        try:
            await self._merge_streams(inputs, write)
            paths = await writer.finish()
        except BaseException:
            await writer.abort()
            raise
        new_runs = []
        try:
            for p in paths:
                r = _Run(self.fs, p, self._cache)
                r.level = out_level
                new_runs.append(r)
        except BaseException:
            for r in new_runs:      # constructed runs hold open fds
                try:
                    await r.close()
                except Exception:  # noqa: BLE001 — cleanup best-effort
                    pass
            for p in paths:
                try:
                    self.fs.remove(p)
                except Exception:  # noqa: BLE001 — cleanup best-effort
                    pass
            raise
        async with self._io_lock:
            gone = {id(r) for r in inputs}
            src = self._level(src_level)
            src[:] = [r for r in src if id(r) not in gone]
            out = self._level(out_level)
            out[:] = [r for r in out if id(r) not in gone]
            out.extend(new_runs)
            out.sort(key=lambda r: r.first_key())
            self._rebuild_runs()
            self._sparse.bump()     # level changes stale the directory
            #                         exactly like run-set changes
            await self._write_manifest()
        self.compactions += 1
        self.compact_bytes += writer.bytes_written
        for r in inputs:
            self._cache.drop_file(r.path)
            try:
                await r.close()
                self.fs.remove(r.path)
            except Exception:  # noqa: BLE001 — orphan swept at next open
                pass
        TraceEvent("LsmCompact").detail("Prefix", self.prefix) \
            .detail("Level", src_level).detail("OutLevel", out_level) \
            .detail("Inputs", len(sel)).detail("Overlap", len(overlap)) \
            .detail("OutRuns", len(new_runs)) \
            .detail("Bytes", writer.bytes_written).log()

    async def _merge_streams(self, inputs: list, write) -> None:
        """Pivot-sliced newest-wins merge of whole input runs (the
        ``range_runs`` discipline over full block streams): each round
        cuts at the smallest buffered tail key; span-disjoint parts
        concatenate with NO merge work, the common 2-source slice goes
        vectorized (``_merge_pair_rows``), and k>2 fan-ins keep the
        heapq path.  Tombstones pass through — the writer owns the
        bottom-level drop."""
        first = lambda e: e[0]  # noqa: E731 — bisect key
        bufs: list[list] = []
        for run in inputs:
            it = run.iter_blocks()
            blk = next(it, None)
            if blk:
                bufs.append([blk, it])
        while bufs:
            if len(bufs) == 1:
                rows, src = bufs[0]
                while rows is not None:
                    await write(rows)
                    rows = next(src, None)
                return
            pivot = min(rows[-1][0] for rows, _src in bufs)
            seg: list[list] = []
            for entry in bufs:
                rows, src = entry
                if rows[-1][0] <= pivot:
                    part = rows
                    entry[0] = next(src, None)
                else:
                    cut = bisect.bisect_right(rows, pivot, key=first)
                    part = rows[:cut]
                    entry[0] = rows[cut:]
                if part:
                    seg.append(part)
            bufs = [entry for entry in bufs if entry[0]]
            if not seg:
                continue
            if len(seg) == 1:
                await write(seg[0])
                continue
            order = sorted(range(len(seg)), key=lambda i: seg[i][0][0])
            if all(seg[order[i]][-1][0] < seg[order[i + 1]][0][0]
                   for i in range(len(order) - 1)):
                # span-disjoint parts (striped flushes): emit in span
                # order, zero merge work
                for i in order:
                    await write(seg[i])
                continue
            if len(seg) == 2:
                await write(_merge_pair_rows(seg[0], seg[1]))
                continue
            await write(list(_merge([iter(p) for p in seg], reverse=False,
                                    keep_tombstones=True)))

    def metrics(self) -> dict:
        """Compaction observability (merged into the storage role's
        metrics and rolled up by status)."""
        return {
            "lsm_runs": len(self._runs),
            "lsm_levels": [len(lvl) for lvl in self._levels],
            "lsm_leveled": self._leveled,
            "lsm_ingest_bytes": self.flush_bytes,
            "lsm_compact_bytes": self.compact_bytes,
            "lsm_compactions": self.compactions,
            "lsm_write_amp": round(self.compact_bytes
                                   / max(1, self.flush_bytes), 3),
            "lsm_compact_debt_bytes": self._debt_bytes(),
            "lsm_compact_stall_ms": round(self._stall_s_max * 1e3, 3),
            "lsm_compact_stalls": self._stalls,
        }


class _RunWriter:
    """Streams merged rows into partition-sized sorted-run files — the
    ``_write_run`` block format, incremental: blocks emit at
    ``_BLOCK_BYTES``, a run closes (index + footer + fsync) past the
    partition target at a block boundary, so one compaction yields a
    span-ordered sequence of disjoint runs."""

    def __init__(self, store: "LSMKVStore", target_bytes: int) -> None:
        self.store = store
        self.target = max(1, target_bytes)
        self.f = None
        self.path: str | None = None
        self.off = 0
        self.index: list = []
        self.block: list = []
        self.bbytes = 0
        self.out: list[str] = []
        self.bytes_written = 0

    async def _open_run(self) -> None:
        s = self.store
        s._gen += 1
        self.path = f"{s.prefix}.run.{s._gen:08d}"
        self.f = s.fs.open(self.path)
        await self.f.truncate(0)
        self.off = 0
        self.index = []

    async def _emit_block(self) -> None:
        if not self.block:
            return
        blob = encode(self.block)
        self.index.append([self.block[0][0], self.off, len(blob)])
        await self.f.write(self.off, blob)
        self.off += len(blob)
        self.block = []
        self.bbytes = 0

    async def _close_run(self) -> None:
        await self._emit_block()
        if self.f is None:
            return
        f, path = self.f, self.path
        self.f = None
        self.path = None
        if not self.index:
            await f.close()
            self.store.fs.remove(path)
            return
        idx = encode(self.index)
        await f.write(self.off, idx)
        await f.write(self.off + len(idx),
                      self.off.to_bytes(8, "little") + _FOOTER)
        await f.sync()
        await f.close()
        self.bytes_written += self.off + len(idx) + 12
        self.out.append(path)

    async def add_rows(self, rows: list, drop_tombstones: bool) -> int:
        """Append merged rows (ascending keys, already deduplicated);
        returns the input bytes consumed (the slice-budget operand)."""
        nbytes = 0
        for e in rows:
            k, v = e[0], e[1]
            nbytes += len(k) + (len(v) if v is not None else 0)
            if v is None and drop_tombstones:
                continue
            if self.f is None:
                await self._open_run()
            self.block.append([k, v])
            self.bbytes += len(k) + (len(v) if v is not None else 0)
            if self.bbytes >= _BLOCK_BYTES:
                await self._emit_block()
                if self.off >= self.target:
                    await self._close_run()
        return nbytes

    async def finish(self) -> list[str]:
        await self._close_run()
        return self.out

    async def abort(self) -> None:
        """Best-effort cleanup of partial output (the job failed or was
        cancelled): unnamed files are also swept at next open."""
        f, path = self.f, self.path
        self.f = None
        self.path = None
        try:
            if f is not None:
                await f.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        for p in self.out + ([path] if path else []):
            try:
                self.store.fs.remove(p)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self.out = []


def _merge_pair_rows(newer: list, older: list) -> list:
    """Vectorized 2-source merge slice (the segment pair-merge
    discipline applied to compaction): the two key columns resolve in
    ONE ``KeyRun.run_positions`` call, the merged key blob stitches via
    np.insert gathers (``merge_newest_wins``), and values follow one
    int source-index column — no per-row key comparisons at all."""
    ka = KeyRun.from_keys([bytes(r[0]) for r in older])
    kb = KeyRun.from_keys([bytes(r[0]) for r in newer])
    keys, src = ka.merge_newest_wins(kb)
    vals = [r[1] for r in older] + [r[1] for r in newer]
    return [(k, vals[s]) for k, s in zip(keys, src.tolist())]


def _merge(sources, reverse: bool, keep_tombstones: bool = False):
    """K-way merge, earlier sources win on equal keys; tombstones elided
    from the output unless kept (compaction intermediate)."""
    heap = []
    for si, it in enumerate(sources):
        it = iter(it)
        first = next(it, None)
        if first is not None:
            k = first[0]
            heap.append(((_rk(k) if reverse else k), si, first, it))
    heapq.heapify(heap)
    last_key = None
    while heap:
        _, si, (k, v), it = heapq.heappop(heap)
        nxt = next(it, None)
        if nxt is not None:
            heapq.heappush(heap, ((_rk(nxt[0]) if reverse else nxt[0]),
                                  si, nxt, it))
        if k == last_key:
            continue            # an older source's version of the same key
        last_key = k
        if v is None and not keep_tombstones:
            continue
        yield k, v


class _rk(bytes):
    """Reversed byte ordering for descending merges."""
    __slots__ = ()

    def __lt__(self, other):    # type: ignore[override]
        return bytes.__gt__(self, other)
