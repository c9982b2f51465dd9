"""Persistent key-value engine: in-memory map + WAL + snapshot.

Reference: REF:fdbserver/KeyValueStoreMemory.actor.cpp — FDB's "memory"
engine holds the full map in RAM and makes it durable with an operation
log on a DiskQueue, periodically snapshotting the whole map so the log
can be truncated.  Same design here: commit() appends one encoded op
batch frame + fsync; recovery = load newest complete snapshot, replay
the WAL after it.  The engine also persists a small metadata dict
(durable version, tag, shard) the storage server needs to resume.

The IKeyValueStore surface (get/range/commit/meta) is engine-neutral:
a B-tree or LSM engine can replace this behind it (IKeyValueStore,
REF:fdbserver/IKeyValueStore.h).
"""

from __future__ import annotations

from typing import Iterator

from ..core.data import MutationBatch
from ..rpc.wire import decode, encode, frame as _frame, unframe as _unframe
from .disk_queue import DiskQueue
from .key_index import PackedKeyIndex
from .packed_ops import PackedOps

_SNAPSHOT_WAL_BYTES = 1 << 24   # rewrite snapshot when WAL exceeds 16MB
# rows per bulk run yielded by range_runs: big enough to amortize the
# per-run call, small enough that a limit-bounded scan never over-probes
RANGE_RUN_ROWS = 2048

OP_SET = 0
OP_CLEAR = 1


class MemoryKVStore:
    def __init__(self, fs, prefix: str) -> None:
        self.fs = fs
        self.prefix = prefix
        self._data: dict[bytes, bytes] = {}
        # PackedKeyIndex instead of the seed's flat bisect.insort list:
        # the engine sees the same batched workload as the MVCC window
        # (durability ticks, GC clears), so it gets the same structure —
        # amortized O(log n) inserts and ONE vectorized searchsorted for
        # a batch of clear bounds
        self._index = PackedKeyIndex()
        self.meta: dict = {}
        self._wal: DiskQueue | None = None
        self._wal_file = None
        self._snap_gen = 0

    # --- lifecycle ---

    @classmethod
    async def open(cls, fs, prefix: str, knobs=None) -> "MemoryKVStore":
        # ``knobs`` accepted for engine-factory uniformity (the lsm
        # engine keys its compaction mode on it); unused here
        kv = cls(fs, prefix)
        # newest complete snapshot wins; exact "<prefix>.snap." match so
        # "storage-1" never picks up "storage-10"'s snapshots
        snap_paths = [p for p in fs.listdir(prefix)
                      if p.startswith(prefix + ".snap.")]
        loaded = None
        for path in sorted(snap_paths, reverse=True):
            f = fs.open(path)
            try:
                blob = await f.read(0, f.size())
                if not blob:
                    continue
                try:
                    payload = _unframe(blob)
                except ValueError:
                    payload = blob      # pre-frame snapshot: raw decode
                snap = decode(payload)
                kv._data = dict(snap["data"])
                kv.meta = snap["meta"]
                kv._snap_gen = snap["gen"]
                loaded = path
                break
            except Exception:
                continue    # torn snapshot: fall back to an older one
            finally:
                await f.close()
        kv._wal_file = fs.open(prefix + ".wal")
        kv._wal, frames = await DiskQueue.open(kv._wal_file)
        recs = [decode(frame) for frame, _end in frames]
        if snap_paths and loaded is None:
            # snapshot files exist but NONE decodes.  A kill tearing the
            # FIRST-ever snapshot write is a legitimate crash: the WAL
            # was not yet popped against it, so its surviving frames
            # carry generations BELOW the torn file's and rebuild the
            # whole state.  But frames at or past the newest snapshot
            # generation — or no frames at all — prove a snapshot once
            # synced and was popped against: recovering over an empty
            # map would silently resurrect a partial ancient state
            # (the lsm _load_manifest discipline)
            newest = max(int(p.rsplit(".", 1)[1]) for p in snap_paths)
            gens = [r["gen"] for r in recs]
            if not gens or min(gens) >= newest:
                from ..runtime.errors import DiskCorrupt
                raise DiskCorrupt(
                    f"no readable snapshot among {len(snap_paths)} "
                    f"on-disk snapshot files for {prefix} while the WAL "
                    f"references one — committed engine state is "
                    f"damaged, refusing to recover silently")
        kv._index.add_many(sorted(kv._data))
        for rec in recs:
            if rec["gen"] < kv._snap_gen:
                continue    # already folded into the snapshot
            if "pk" in rec:
                # packed frame (712 format): (types, bounds, blob)
                # segments straight back into the apply pass
                kv._apply(PackedOps([MutationBatch(*p) for p in rec["pk"]]))
            else:
                # pre-712 frame: the tuple-list op log
                kv._apply(rec["ops"])
            kv.meta = rec["meta"]
        return kv

    def _apply(self, ops) -> None:
        """ops: ordered (OP_SET, key, value) / (OP_CLEAR, begin, end) —
        any iterable of triples (a tuple list, or a ``PackedOps`` slice
        decoded lazily per op).

        Maintains data AND index together.  Fresh keys batch into one
        sorted overlay append; a run of consecutive clears (the
        durability loop's GC commit is exactly that) resolves every
        bound in ONE vectorized ``ranges_keys`` call instead of the
        seed's full-dict scan per clear."""
        data = self._data
        index = self._index
        fresh: list[bytes] = []
        clears: list[tuple[bytes, bytes]] = []

        def flush_clears() -> None:
            dead: set[bytes] = set()
            for keys in index.ranges_keys(clears):
                dead.update(keys)
            for k in dead:
                del data[k]
            index.discard_many(list(dead))
            clears.clear()

        for op, p1, p2 in ops:
            if op == OP_SET:
                if clears:
                    flush_clears()
                if p1 not in data:
                    fresh.append(p1)
                data[p1] = p2
            else:
                # clears must see fresh keys from this batch in the index
                if fresh:
                    index.add_many(fresh)
                    fresh = []
                clears.append((p1, p2))
        if clears:
            flush_clears()
        if fresh:
            index.add_many(fresh)

    # --- reads ---

    @property
    def packed_index(self):
        """The engine's PackedKeyIndex — the capability probe the device
        read path keys on (device/read_serve.py)."""
        return self._index

    def get(self, key: bytes) -> bytes | None:
        return self._data.get(key)

    def get_batch(self, keys: list[bytes]) -> list[bytes | None]:
        """Batched point reads (sorted keys by the wire contract; this
        engine's dict probe doesn't care)."""
        get = self._data.get
        return [get(k) for k in keys]

    def range(self, begin: bytes, end: bytes,
              reverse: bool = False) -> Iterator[tuple[bytes, bytes]]:
        keys = self._index.keys_in_range(begin, end)
        if reverse:
            keys = reversed(keys)
        for k in keys:
            v = self._data.get(k)
            if v is not None:
                yield k, v

    def range_runs(self, begin: bytes,
                   end: bytes) -> Iterator[list[tuple[bytes, bytes]]]:
        """Forward scan of [begin, end) as bulk row RUNS — the columnar
        range-read extraction.  The PackedKeyIndex resolves
        the whole interval in one bound query; values resolve per run
        (a C-speed list comprehension over the key slice), so a
        limit-bounded caller that stops consuming never probes the
        tail.  Flattened output is byte-identical to ``range``."""
        keys = self._index.keys_in_range(begin, end)
        data = self._data
        for i in range(0, len(keys), RANGE_RUN_ROWS):
            run = [(k, v) for k in keys[i:i + RANGE_RUN_ROWS]
                   if (v := data.get(k)) is not None]
            if run:
                yield run

    def __len__(self) -> int:
        return len(self._data)

    # --- writes ---

    async def commit(self, ops, meta: dict) -> None:
        """Durably apply one ordered op batch (the durability tick).

        A ``PackedOps`` slice rides into the WAL frame as its raw
        (types, bounds, blob) byte strings — the same objects the TLog
        pull handed the durability ring, zero-copy end to end; a plain
        tuple list (GC clears, engine tests) keeps the legacy frame
        shape."""
        if isinstance(ops, PackedOps):
            rec = encode({"gen": self._snap_gen, "pk": ops.wire_parts(),
                          "meta": meta})
        else:
            rec = encode({"gen": self._snap_gen, "ops": ops, "meta": meta})
        await self._wal.push(rec)
        await self._wal.commit()
        self._apply(ops)        # data + index together, clears batched
        self.meta = meta
        if self._wal.bytes_used > _SNAPSHOT_WAL_BYTES:
            await self._snapshot()

    async def _snapshot(self) -> None:
        self._snap_gen += 1
        path = f"{self.prefix}.snap.{self._snap_gen:08d}"
        f = self.fs.open(path)
        # crc-framed so a torn write from a kill FAILS the frame check
        # instead of decoding into garbage rows (the BackupContainer
        # frame discipline)
        blob = _frame(encode({"gen": self._snap_gen, "data": self._data,
                              "meta": self.meta}))
        await f.write(0, blob)
        await f.truncate(len(blob))
        await f.sync()
        await f.close()
        # restart the WAL: future records carry the new gen; old frames are
        # skipped on recovery via the gen check
        await self._wal.pop_to(self._wal.end_offset)
        # the new snapshot is durable: superseded generations are garbage
        for old in list(self.fs.listdir(self.prefix)):
            if old.startswith(self.prefix + ".snap.") and old != path:
                self.fs.remove(old)

    async def close(self) -> None:
        if self._wal_file is not None:
            await self._wal_file.close()
