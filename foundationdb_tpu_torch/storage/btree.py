"""Copy-on-write B+tree key-value engine (the Redwood-class analog).

Reference: REF:fdbserver/VersionedBTree.actor.cpp — FDB's production
"ssd" engine Redwood is a copy-on-write paged B+tree: updates rewrite
the modified leaf-to-root path into fresh pages, and a small commit
header atomically switches the durable root, so a crash at any point
recovers to the last committed tree with no WAL replay.  This engine
keeps that shape with an append-friendly layout:

- nodes (leaves + internals) are encoded blobs appended to the current
  tree file; a commit bulk-applies the op batch functionally — every
  modified node is rewritten at the file tail, unmodified subtrees are
  shared by reference (off, len);
- the commit point is a tiny header written to one of TWO alternating
  header files (gen parity picks the slot): {gen, file, root, end,
  count, meta}.  The data file is fsynced BEFORE the header, the header
  after, so a torn commit always leaves one older decodable header and
  the tree it names is fully durable — recovery is "read both headers,
  take the newest that decodes" (Redwood's dual pager-commit-header);
- dead versions of rewritten nodes accumulate in the file; when it grows
  past a multiple of the live size the whole tree is compacted into a
  fresh file (bulk rebuild) and the old file removed — the role
  Redwood's free list + lazy page reuse plays, traded for sequential-only
  writes (the right trade on this fs abstraction: no block reuse means
  no torn-page hazard and no free-list recovery logic);
- reads traverse from the in-memory root through a shared LRU node cache
  (the pager cache), synchronous block reads like the LSM engine.

Unlike the LSM engine there is no WAL and no memtable: the op batch IS
the durability tick, and reads have no merge across runs — point reads
are one root-to-leaf descent, ranges are an in-order walk.

The IKeyValueStore surface (open/get/range/commit/meta/close) matches
kv_store.MemoryKVStore (REF:fdbserver/IKeyValueStore.h).
"""

from __future__ import annotations

import bisect
from typing import Iterator

from ..rpc.wire import decode, encode, frame, unframe
from .kv_store import OP_CLEAR, OP_SET
from .lsm import _BlockCache

_LEAF_BYTES = 1 << 13       # split leaves past ~8KB encoded payload
_FANOUT = 64                # max children per internal node
_CACHE_NODES = 512          # shared LRU node cache entries
_COMPACT_MIN = 1 << 20      # never compact files under 1MB
_COMPACT_FACTOR = 5         # compact when file > factor * post-compact size


class BTreeKVStore:
    """IKeyValueStore-compatible copy-on-write B+tree engine."""

    def __init__(self, fs, prefix: str) -> None:
        self.fs = fs
        self.prefix = prefix
        self.meta: dict = {}
        self._gen = 0
        self._fileno = 0
        self._f = None
        self._root: tuple[int, int] | None = None   # (off, len) in _f
        self._end = 0                               # durable append offset
        self._count = 0
        self._cache = _BlockCache(_CACHE_NODES)
        self._live_size = 0     # file end right after the last compaction
        self._heads = [None, None]      # the two alternating header files

    # --- lifecycle ---

    def _file_path(self, fileno: int) -> str:
        return f"{self.prefix}.bt.{fileno:08d}"

    def _head_path(self, slot: int) -> str:
        return f"{self.prefix}.head{slot}"

    @classmethod
    async def open(cls, fs, prefix: str, knobs=None) -> "BTreeKVStore":
        # ``knobs`` accepted for engine-factory uniformity (the lsm
        # engine keys its compaction mode on it); unused here
        kv = cls(fs, prefix)
        best = None
        for slot in (0, 1):
            hf = fs.open(kv._head_path(slot))
            kv._heads[slot] = hf
            blob = await hf.read(0, hf.size())
            if not blob:
                continue
            try:
                # crc-framed so a torn header write FAILS
                # the checksum instead of possibly decoding into garbage
                # (pre-frame headers decode raw for compatibility)
                try:
                    payload = unframe(blob)
                except ValueError:
                    payload = blob
                head = decode(payload)
                gen = int(head["gen"])
            except Exception:   # torn header: the other slot has the commit
                continue
            if best is None or gen > best["gen"]:
                best = head
        if best is not None:
            kv._gen = int(best["gen"])
            kv._fileno = int(best["file"])
            kv._root = (tuple(best["root"]) if best["root"] is not None
                        else None)
            kv._end = int(best["end"])
            kv._count = int(best["count"])
            kv._live_size = int(best.get("live", kv._end))
            kv.meta = best["meta"]
        kv._f = fs.open(kv._file_path(kv._fileno))
        # garbage from a torn commit may sit past the durable end or in
        # orphaned files from an interrupted compaction — both harmless
        # (never referenced), but orphan files are removed for hygiene
        for path in fs.listdir(prefix + ".bt."):
            if path != kv._file_path(kv._fileno):
                fs.remove(path)
        return kv

    async def close(self) -> None:
        if self._f is not None:
            await self._f.close()
            self._f = None
        for hf in self._heads:
            if hf is not None:
                await hf.close()
        self._heads = [None, None]

    def __len__(self) -> int:
        return self._count

    # --- node io ---

    def _read_node(self, ref: tuple[int, int]) -> list:
        key = (self._fileno, ref[0])
        node = self._cache.get(key)
        if node is None:
            node = decode(self._f.read_sync(ref[0], ref[1]))
            self._cache.put(key, node)
        return node

    # --- reads ---

    def get(self, key: bytes) -> bytes | None:
        ref = self._root
        if ref is None:
            return None
        node = self._read_node(ref)
        while node[0] == 0:
            kids = node[1]              # [[first_key, off, len], ...]
            i = bisect.bisect_right([bytes(c[0]) for c in kids], key) - 1
            if i < 0:
                i = 0
            ref = (kids[i][1], kids[i][2])
            node = self._read_node(ref)
        entries = node[1]
        keys = [bytes(e[0]) for e in entries]
        j = bisect.bisect_left(keys, key)
        if j < len(keys) and keys[j] == key:
            return bytes(entries[j][1])
        return None

    def get_batch(self, keys: list[bytes]) -> list[bytes | None]:
        """Batched point reads over SORTED keys: ONE root-to-leaf
        descent per leaf RUN — every consecutive probe key routing to
        the same leaf resolves off the single decoded node, so a batch
        of n keys over l distinct leaves costs l descents instead of n
        (the multiget engine fall-through)."""
        out: list[bytes | None] = [None] * len(keys)
        if self._root is None or not keys:
            return out
        i, n = 0, len(keys)
        while i < n:
            ref = self._root
            node = self._read_node(ref)
            upper: bytes | None = None  # tightest right bound on the path
            while node[0] == 0:
                kids = node[1]
                firsts = [bytes(c[0]) for c in kids]
                j = bisect.bisect_right(firsts, keys[i]) - 1
                if j < 0:
                    j = 0
                if j + 1 < len(kids):
                    nb = firsts[j + 1]
                    if upper is None or nb < upper:
                        upper = nb
                ref = (kids[j][1], kids[j][2])
                node = self._read_node(ref)
            entries = node[1]
            lkeys = [bytes(e[0]) for e in entries]
            # every probe key below the path's right bound lives (if
            # anywhere) in THIS leaf
            hi = n if upper is None else bisect.bisect_left(keys, upper, i)
            for t in range(i, max(hi, i + 1)):
                j2 = bisect.bisect_left(lkeys, keys[t])
                if j2 < len(lkeys) and lkeys[j2] == keys[t]:
                    out[t] = bytes(entries[j2][1])
            i = max(hi, i + 1)
        return out

    def range(self, begin: bytes, end: bytes,
              reverse: bool = False) -> Iterator[tuple[bytes, bytes]]:
        if self._root is None:
            return
        yield from self._walk(self._root, begin, end, reverse)

    def range_runs(self, begin: bytes,
                   end: bytes) -> Iterator[list[tuple[bytes, bytes]]]:
        """Forward scan of [begin, end) as whole LEAF runs — one run per
        decoded leaf, the in-range slice extracted wholesale by two
        bisects instead of a per-row yield (the columnar range-read
        extraction).  Flattened output is byte-identical to
        ``range``; a limit-bounded caller that stops consuming leaves
        the remaining subtrees untouched."""
        if self._root is None:
            return
        yield from self._walk_runs(self._root, begin, end)

    def _walk_runs(self, ref, begin, end):
        node = self._read_node(ref)
        if node[0] == 0:
            kids = node[1]
            firsts = [bytes(c[0]) for c in kids]
            lo = max(0, bisect.bisect_right(firsts, begin) - 1)
            hi = min(bisect.bisect_left(firsts, end) + 1, len(kids))
            for i in range(lo, hi):
                yield from self._walk_runs((kids[i][1], kids[i][2]),
                                           begin, end)
        else:
            entries = node[1]
            keys = [bytes(e[0]) for e in entries]
            lo = bisect.bisect_left(keys, begin)
            hi = bisect.bisect_left(keys, end)
            if lo < hi:
                yield [(keys[i], bytes(entries[i][1]))
                       for i in range(lo, hi)]

    def _walk(self, ref, begin, end, reverse):
        """In-order walk of [begin, end); ``end=None`` means unbounded —
        the whole-tree walk compaction relies on (a key range would
        silently drop any key sorting above the chosen sentinel)."""
        node = self._read_node(ref)
        if node[0] == 0:
            kids = node[1]
            firsts = [bytes(c[0]) for c in kids]
            # children whose key range can intersect [begin, end)
            lo = max(0, bisect.bisect_right(firsts, begin) - 1)
            hi = len(kids) if end is None else \
                min(bisect.bisect_left(firsts, end) + 1, len(kids))
            idxs = range(lo, hi)
            if reverse:
                idxs = reversed(idxs)
            for i in idxs:
                yield from self._walk((kids[i][1], kids[i][2]),
                                      begin, end, reverse)
        else:
            entries = node[1]
            keys = [bytes(e[0]) for e in entries]
            lo = bisect.bisect_left(keys, begin)
            hi = len(keys) if end is None else bisect.bisect_left(keys, end)
            idxs = range(lo, hi)
            if reverse:
                idxs = reversed(idxs)
            for i in idxs:
                yield keys[i], bytes(entries[i][1])

    # --- writes ---

    async def commit(self, ops, meta: dict) -> None:
        """Durably apply one ordered op batch (a tuple list or a
        ``PackedOps`` slice — only iterated): CoW-update the tree at the
        file tail, fsync data, then flip the commit header."""
        eff: dict[bytes, bytes | None] = {}
        for op, p1, p2 in ops:
            if op == OP_SET:
                eff[p1] = p2
            else:
                assert op == OP_CLEAR
                for k, _ in self.range(p1, p2):
                    eff[k] = None
                for k in [k for k in eff if p1 <= k < p2]:
                    eff[k] = None
        self.meta = meta
        # meta-only commits still flip the header (durable_version bumps)
        await self._apply(sorted(eff.items()))

    async def _apply(self, items: list[tuple[bytes, bytes | None]]) -> None:
        self._pending: list[bytes] = []     # node blobs to append
        self._pend_off = self._end
        new_refs, delta = (self._update(self._root, items)
                           if items else
                           ([(None, *self._root)] if self._root else [], 0))
        # collapse to a single root (possibly adding internal levels)
        while len(new_refs) > 1:
            new_refs = [self._write_internal(chunk)
                        for chunk in _chunks(new_refs, _FANOUT)]
        if self._pending:
            await self._f.write(self._pend_off, b"".join(self._pending))
            await self._f.sync()
        self._end = self._pend_off + sum(len(b) for b in self._pending)
        self._root = ((new_refs[0][1], new_refs[0][2])
                      if new_refs else None)
        self._count += delta
        self._pending = []
        if self._end > _COMPACT_MIN and \
                self._end > _COMPACT_FACTOR * max(self._live_size, 1):
            await self._compact()
        else:
            await self._write_header()

    def _append_node(self, node: list) -> tuple[bytes | None, int, int]:
        """Stage a node blob for the tail write; returns its ref entry
        (first_key, off, len)."""
        blob = encode(node)
        off = self._pend_off + sum(len(b) for b in self._pending)
        self._pending.append(blob)
        first = (bytes(node[1][0][0]) if node[1] else None)
        self._cache.put((self._fileno, off), node)
        return (first, off, len(blob))

    def _write_internal(self, child_refs) -> tuple[bytes, int, int]:
        node = [0, [[fk, off, ln] for fk, off, ln in child_refs]]
        return self._append_node(node)

    def _update(self, ref, items):
        """Functionally apply sorted (key, value|None) items under ``ref``.
        Returns ([(first_key, off, len), ...] replacement refs — empty if
        the subtree vanished, possibly several if it split), count delta.
        Unmodified subtrees are returned by reference, never rewritten."""
        if ref is None:
            live = [(k, v) for k, v in items if v is not None]
            return self._build_leaves(live), len(live)
        node = self._read_node(ref)
        if node[0] == 1:
            entries = [(bytes(e[0]), bytes(e[1])) for e in node[1]]
            merged: list[tuple[bytes, bytes]] = []
            delta = 0
            i = j = 0
            while i < len(entries) or j < len(items):
                if j >= len(items) or \
                        (i < len(entries) and entries[i][0] < items[j][0]):
                    merged.append(entries[i])
                    i += 1
                    continue
                k, v = items[j]
                existed = i < len(entries) and entries[i][0] == k
                if existed:
                    i += 1
                if v is None:
                    delta -= 1 if existed else 0
                else:
                    delta += 0 if existed else 1
                    merged.append((k, v))
                j += 1
            return self._build_leaves(merged), delta
        # internal: partition items among children by routing ranges
        kids = node[1]
        firsts = [bytes(c[0]) for c in kids]
        out_refs: list = []
        delta = 0
        changed = False
        pos = 0
        for ci in range(len(kids)):
            hi_key = firsts[ci + 1] if ci + 1 < len(kids) else None
            hi = len(items)
            if hi_key is not None:
                hi = bisect.bisect_left(items, (hi_key,), pos)
            sub = items[pos:hi]
            pos = hi
            if not sub:
                out_refs.append((firsts[ci], kids[ci][1], kids[ci][2]))
                continue
            refs, d = self._update((kids[ci][1], kids[ci][2]), sub)
            delta += d
            changed = True
            out_refs.extend(refs)
        if not changed:
            return [(firsts[0], ref[0], ref[1])], 0
        if not out_refs:
            return [], delta
        return [self._write_internal(chunk)
                for chunk in _chunks(out_refs, _FANOUT)], delta

    def _build_leaves(self, entries):
        """Pack sorted live entries into appended leaves by byte budget."""
        refs = []
        block: list = []
        bbytes = 0
        for k, v in entries:
            block.append([k, v])
            bbytes += len(k) + len(v) + 8
            if bbytes >= _LEAF_BYTES:
                refs.append(self._append_node([1, block]))
                block, bbytes = [], 0
        if block:
            refs.append(self._append_node([1, block]))
        return refs

    async def _write_header(self) -> None:
        self._gen += 1
        head = {"gen": self._gen, "file": self._fileno,
                "root": (list(self._root) if self._root else None),
                "end": self._end, "count": self._count,
                "live": self._live_size, "meta": self.meta}
        hf = self._heads[self._gen % 2]
        blob = frame(encode(head))
        await hf.write(0, blob)
        await hf.truncate(len(blob))
        await hf.sync()

    # --- compaction ---

    async def _compact(self) -> None:
        """Rewrite the live tree into a fresh file (sequential bulk
        build), flip the header to it, remove the old file.  A crash
        before the header flip leaves an orphan file that open() GCs."""
        old_f, old_path = self._f, self._file_path(self._fileno)
        items = list(self._walk(self._root, b"", None, False)) \
            if self._root else []
        self._fileno += 1
        self._f = self.fs.open(self._file_path(self._fileno))
        await self._f.truncate(0)
        self._pending = []
        self._pend_off = 0
        refs = self._build_leaves(items)
        while len(refs) > 1:
            refs = [self._write_internal(chunk)
                    for chunk in _chunks(refs, _FANOUT)]
        if self._pending:
            await self._f.write(0, b"".join(self._pending))
            await self._f.sync()
        self._end = sum(len(b) for b in self._pending)
        self._live_size = self._end
        self._root = (refs[0][1], refs[0][2]) if refs else None
        self._pending = []
        await self._write_header()
        await old_f.close()
        self.fs.remove(old_path)
        # evict the dead file's nodes so they stop crowding the LRU
        for k in [k for k in self._cache._d if k[0] != self._fileno]:
            del self._cache._d[k]


def _chunks(seq, n):
    return [seq[i:i + n] for i in range(0, len(seq), n)]
