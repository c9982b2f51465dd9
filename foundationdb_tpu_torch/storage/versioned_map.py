"""MVCC versioned key-value map — the storage server's in-memory window.

Reference: REF:fdbserver/VersionedMap.h — upstream keeps a persistent
red-black tree (PTree) per version so the last ~5 seconds of versions are
all readable at once while TLog data ahead of the durable version is
replayed.  Two implementations live here behind one constructor
(the ``columnar=False`` pattern of PackedKeyIndex):

LEGACY (``columnar=False``) — per-key version chains over one sorted key
index: ``_chains[key]`` is an append-only list of (version,
value-or-None) in increasing version order (None = tombstone), plus a
``_touched`` deque driving incremental compaction.  Fine while the MVCC
window stays small; on a huge hot set the dict-of-PyObject-lists is the
dominant RSS and GC load of the whole server, every
``forget_before``/``drop_before`` tick does per-key list
surgery, and ``get2_batch`` bisects one Python chain at a time.

COLUMNAR (default) — a generational window:

- a small mutable **tip**: the per-key chain dict, scoped to versions
  above the last seal, bounded by the seal budget (ops / bytes /
  version span), with its own PackedKeyIndex for range scans;
- immutable **sealed segments**, newest first: a distinct-key sorted
  ``KeyRun`` + a cumulative per-key entry-count column + parallel int64
  version / value-offset columns over ONE value blob (offset -1 = the
  tombstone bit).  ``apply_packed`` seals a whole all-SET TLog batch
  into a segment near-zero-copy — the segment's value blob IS the
  ``MutationBatch`` blob, only the keys are re-sorted;
- reads probe tip-then-segments-newest-first.  ``get2_batch`` narrows
  each segment with ONE vectorized prefix-searchsorted band per batch
  (the key-run probe discipline) instead of a per-key dict+bisect;
- ``drop_before`` retires whole segments at-or-below the floor in
  O(segments); ``forget_before`` advances the floor and lazily FOLDS
  wholly-below segments into a base segment with geometric
  amortization; ``rollback_after`` truncates the tip and the suffix
  segments.

Entries an eager compactor would delete may linger inside retained
segments; they are INVISIBLE by the floor rules below, so the two modes
are observably equivalent (tests/test_mvcc_window.py proves it against
the legacy twin and the brute-force model on randomized interleavings):

- drop floor: a resolved entry at or below ``_drop_floor`` reads as
  found=False (the engine is authoritative — what ``drop_before``
  physically deleted in legacy mode);
- forget base: the newest entry at or below ``oldest_version`` stays
  readable (legacy kept it as the folded chain base);
- dead keys: a key whose newest entry anywhere is a tombstone at or
  below ``oldest_version`` reads as found=False (legacy removed the
  single-tombstone chain).

Known semantic gap REPRODUCED deliberately (pre-existing, both modes):
``clear_range`` materializes
tombstones only for keys currently IN the window — a key cold for
longer than one MVCC window (its chain dropped to the engine) then
cleared serves its stale engine row until the clear itself becomes
durable.  Fixing it needs range tombstones in the window (upstream
keeps clears as range nodes in the PTree); the columnar rewrite keeps
the legacy behavior bit-for-bit so the A/B twin stays meaningful.
"""

from __future__ import annotations

import bisect
import time
from array import array as _array
from collections import deque
from typing import Iterator

from ..core.data import Version
# apply_batch op codes ARE the engine's WAL op codes — one definition,
# so the storage server can feed either surface from the same tuples
from .key_index import PackedKeyIndex
from .key_runs import KeyRun
from .kv_store import OP_CLEAR, OP_SET

__all__ = ["VersionedMap", "LegacyVersionedMap", "ColumnarVersionedMap",
           "OP_SET", "OP_CLEAR"]

# --- columnar seal / compaction defaults (constructor-overridable; the
#     storage server passes the STORAGE_MVCC_* knobs through, and the
#     knob defaults ARE the one definition — re-exported here so direct
#     constructions and knob-driven ones can never drift) ---
from ..runtime.knobs import Knobs as _Knobs

SEAL_OPS = _Knobs.STORAGE_MVCC_SEAL_OPS          # tip entries before a seal
SEAL_BYTES = _Knobs.STORAGE_MVCC_SEAL_BYTES      # tip key+value bytes
SEAL_VERSIONS = _Knobs.STORAGE_MVCC_SEAL_VERSIONS  # tip version span (just
#                            under the 5M-version MVCC window: a low-rate
#                            trickle stays tip-resident for its whole life)
_DIRECT_SEAL_MIN = 256     # all-SET packed batches this big seal directly
_SEG_CAP = 12              # live segments before adjacent pairs merge
_FOLD_MIN_SEGS = 2         # wholly-below-floor segments before a fold
_BATCH_MIN = 16            # below this, batched probes fall back to bisect
_RANGE_WINDOW = 4096       # candidate keys per layer per range-walk step
_SMALL_PROBE_BATCH = 64    # point-probe batches at or under this ride the
# per-key recent-hit cache instead of the per-segment
#                            vectorized probe — the transient-KeyRun setup
#                            cost only amortizes at larger batches
_PROBE_CACHE_CAP = 1 << 17  # recent-hit cache entries before a reset


def VersionedMap(columnar: bool = True, seal_ops: int = SEAL_OPS,
                 seal_bytes: int = SEAL_BYTES,
                 seal_versions: int = SEAL_VERSIONS):
    """Construct the MVCC window — columnar by default, the legacy
    dict-of-chains twin behind ``columnar=False`` (the equivalence / RSS
    A/B baseline, exactly PackedKeyIndex's pattern)."""
    if columnar:
        return ColumnarVersionedMap(seal_ops=seal_ops,
                                    seal_bytes=seal_bytes,
                                    seal_versions=seal_versions)
    return LegacyVersionedMap()


class LegacyVersionedMap:
    """The dict-of-per-key-chains window (the legacy layout)."""

    columnar = False

    def __init__(self) -> None:
        self._chains: dict[bytes, list[tuple[Version, bytes | None]]] = {}
        self._index = PackedKeyIndex()
        self.oldest_version: Version = 0   # reads below this raise at the role layer
        self.latest_version: Version = 0   # newest version any entry carries
        # every write/tombstone pushes (version, key) here in version
        # order; compaction (forget_before / drop_before) pops entries at
        # or below its target and touches ONLY those keys, and
        # rollback_after pops the strict suffix above its target — a
        # full-map walk per GC tick measured ~1s of event-loop stall per
        # million keys on a 1-cpu host (the r5 YCSB-at-1M-rows collapse).
        # A server uses one consumer (engine-less -> forget,
        # engine-backed -> drop).
        self._touched: deque[tuple[Version, bytes]] = deque()

    def __len__(self) -> int:
        return len(self._index)

    def keys(self) -> list[bytes]:
        """Full sorted key list (test/debug surface; O(n))."""
        return self._index.to_list()

    def index_stats(self) -> dict:
        return self._index.stats()

    # --- writes (storage role applies mutations in version order) ---

    def set(self, version: Version, key: bytes, value: bytes) -> None:
        assert version >= self.latest_version, \
            f"mutations must arrive in version order " \
            f"(v={version} < latest={self.latest_version})"
        self.latest_version = version
        self._touched.append((version, key))
        chain = self._chains.get(key)
        if chain is None:
            self._chains[key] = [(version, value)]
            self._index.add(key)
        elif chain[-1][0] == version:
            chain[-1] = (version, value)
        else:
            chain.append((version, value))

    def clear_range(self, version: Version, begin: bytes, end: bytes) -> None:
        assert version >= self.latest_version
        self.latest_version = version
        for key in self._index.keys_in_range(begin, end):
            chain = self._chains[key]
            if chain[-1][1] is not None:          # live at tip: tombstone it
                self._touched.append((version, key))
                if chain[-1][0] == version:
                    chain[-1] = (version, None)
                else:
                    chain.append((version, None))

    def apply_batch(self, ops: list[tuple[Version, int, bytes, bytes]]) -> int:
        """Apply a version-ordered run of (version, OP_SET|OP_CLEAR,
        p1, p2) ops — a whole TLog pull reply in one call.

        Sets are chain-appends with the index insert DEFERRED: fresh keys
        are collected and merged into the index in one sorted pass at the
        end (or just before a clear, whose range scan must see them).
        State after the call is identical to the equivalent sequence of
        ``set``/``clear_range`` calls (tests/test_versioned_map.py proves
        this against the brute-force model); only the cost differs —
        O(batch + merge) instead of O(batch × index).
        """
        chains = self._chains
        touched = self._touched
        index = self._index
        fresh: list[bytes] = []
        latest = self.latest_version
        n = len(ops)
        i = 0
        while i < n:
            version, op, p1, p2 = ops[i]
            assert version >= latest, \
                f"mutations must arrive in version order " \
                f"(v={version} < latest={latest})"
            latest = version
            if op == OP_SET:
                touched.append((version, p1))
                chain = chains.get(p1)
                if chain is None:
                    chains[p1] = [(version, p2)]
                    fresh.append(p1)
                elif chain[-1][0] == version:
                    chain[-1] = (version, p2)
                else:
                    chain.append((version, p2))
                i += 1
                continue
            # a run of consecutive clears: the range scans must see fresh
            # keys from this batch, and with no intervening inserts all
            # the runs' bounds can resolve in one vectorized pass
            if fresh:
                index.add_many(fresh)
                fresh = []
            j = i
            while j < n and ops[j][1] == OP_CLEAR:
                j += 1
            run = ops[i:j]
            for (version, _op, begin, end), keys in zip(
                    run, index.ranges_keys([(o[2], o[3]) for o in run])):
                assert version >= latest, \
                    f"mutations must arrive in version order " \
                    f"(v={version} < latest={latest})"
                latest = version
                for key in keys:
                    chain = chains[key]
                    if chain[-1][1] is not None:
                        touched.append((version, key))
                        if chain[-1][0] == version:
                            chain[-1] = (version, None)
                        else:
                            chain.append((version, None))
            i = j
        if fresh:
            index.add_many(fresh)
        self.latest_version = latest
        return n

    def apply_packed(self, version: Version, batch) -> int:
        """Apply one version's simple-only packed ``MutationBatch`` (type
        codes are OP_SET/OP_CLEAR by construction — MutationType values 0
        and 1) straight off its columnar arrays: param bytes are sliced
        from the blob exactly once, and no per-op tuple or ``Mutation``
        object is ever built.  State after the call is identical to
        ``apply_batch`` over the equivalent (version, op, p1, p2) run
        (tests/test_mutation_batch.py proves equivalence on randomized
        workloads)."""
        assert version >= self.latest_version, \
            f"mutations must arrive in version order " \
            f"(v={version} < latest={self.latest_version})"
        chains = self._chains
        touched = self._touched
        index = self._index
        types = batch.types
        offs = batch.offsets()
        blob = batch.blob
        fresh: list[bytes] = []
        clears: list[tuple[bytes, bytes]] = []

        def flush_clears() -> None:
            for keys in index.ranges_keys(clears):
                for key in keys:
                    chain = chains[key]
                    if chain[-1][1] is not None:
                        touched.append((version, key))
                        if chain[-1][0] == version:
                            chain[-1] = (version, None)
                        else:
                            chain.append((version, None))
            clears.clear()

        prev = 0
        for i in range(len(types)):
            e1, e2 = offs[2 * i], offs[2 * i + 1]
            p1 = blob[prev:e1]
            if types[i] == OP_SET:
                if clears:
                    flush_clears()
                p2 = blob[e1:e2]
                touched.append((version, p1))
                chain = chains.get(p1)
                if chain is None:
                    chains[p1] = [(version, p2)]
                    fresh.append(p1)
                elif chain[-1][0] == version:
                    chain[-1] = (version, p2)
                else:
                    chain.append((version, p2))
            else:
                # clears must see fresh keys from this batch in the
                # index; consecutive clears resolve vectorized
                if fresh:
                    index.add_many(fresh)
                    fresh = []
                clears.append((p1, blob[e1:e2]))
            prev = e2
        if clears:
            flush_clears()
        if fresh:
            index.add_many(fresh)
        self.latest_version = version
        return len(types)

    # --- reads ---

    def get(self, key: bytes, version: Version) -> bytes | None:
        found, value = self.get2(key, version)
        return value if found else None

    def get2(self, key: bytes, version: Version) -> tuple[bool, bytes | None]:
        """(found, value): found=False means this map has no entry at or
        below ``version`` — the caller falls through to the persistent
        engine (the PTree→IKeyValueStore read path of getValueQ,
        REF:fdbserver/storageserver.actor.cpp)."""
        chain = self._chains.get(key)
        if chain is None:
            return False, None
        i = bisect.bisect_right(chain, version, key=lambda e: e[0]) - 1
        if i < 0:
            return False, None
        return True, chain[i][1]

    def get2_batch(self, keys: list[bytes],
                   version: Version) -> list[tuple[bool, bytes | None]]:
        """Batched ``get2`` — one pass over the whole probe list (the
        multiget read path's window probe).  Result i is
        exactly ``get2(keys[i], version)``; callers separate the
        found=False entries in the same pass and resolve them through
        the engine's ``get_batch``.

        Cheaper than a ``get2`` loop by construction, not cleverness:
        one bound method per batch instead of per key, and the common
        cases — no chain at all, or the chain tip already at-or-below
        ``version`` (every key outside the current commit wave) —
        resolve without the keyed bisect."""
        chains = self._chains
        out: list[tuple[bool, bytes | None]] = []
        append = out.append
        br = bisect.bisect_right
        for key in keys:
            chain = chains.get(key)
            if chain is None:
                append((False, None))
                continue
            v0, val = chain[-1]
            if v0 <= version:
                append((True, val))
            elif chain[0][0] > version:
                append((False, None))
            else:
                i = br(chain, version, key=lambda e: e[0]) - 1
                append((True, chain[i][1]))
        return out

    def get_latest(self, key: bytes) -> bytes | None:
        chain = self._chains.get(key)
        return chain[-1][1] if chain else None

    def range_iter(self, begin: bytes, end: bytes, version: Version,
                   reverse: bool = False) -> Iterator[tuple[bytes, bytes]]:
        keys = self._index.keys_in_range(begin, end)
        if reverse:
            keys = list(reversed(keys))
        for key in keys:
            v = self.get(key, version)
            if v is not None:
                yield key, v

    def range_read(self, begin: bytes, end: bytes, version: Version,
                   limit: int = 0, reverse: bool = False,
                   byte_limit: int = 0) -> tuple[list[tuple[bytes, bytes]], bool]:
        """Returns (kv pairs, more) where more=True means limits truncated."""
        out: list[tuple[bytes, bytes]] = []
        nbytes = 0
        it = self.range_iter(begin, end, version, reverse)
        for kv in it:
            out.append(kv)
            nbytes += len(kv[0]) + len(kv[1])
            if (limit and len(out) >= limit) or (byte_limit and nbytes >= byte_limit):
                # one probe to learn if anything remains
                more = next(it, None) is not None
                return out, more
        return out, False

    def overlay_keys(self, begin: bytes, end: bytes) -> list[bytes]:
        """Sorted keys with a chain in [begin, end) — the overlay the
        run-wise packed range merge bisects into the engine's runs.  Entries
        resolve lazily via ``get2`` so a
        limit-bounded merge never probes past its cut."""
        return self._index.keys_in_range(begin, end)

    def range_rows(self, begin: bytes, end: bytes, version: Version,
                   limit: int = 0, byte_limit: int = 0
                   ) -> tuple[list[tuple[bytes, bytes]], bool]:
        """Forward bulk range read — result identical to
        ``range_read(begin, end, version, limit, False, byte_limit)``
        (tested), built in ONE tight loop over the interval's key slice
        instead of the per-row generator chain: the engine-less packed
        range path.  ``more`` is exact, like ``range_read``'s:
        True iff a live row remains past the cut."""
        keys = self._index.keys_in_range(begin, end)
        chains = self._chains
        br = bisect.bisect_right

        def _ver(e):
            return e[0]

        out: list[tuple[bytes, bytes]] = []
        nbytes = 0
        i, n = 0, len(keys)
        while i < n:
            key = keys[i]
            i += 1
            chain = chains[key]
            v0, val = chain[-1]
            if v0 > version:
                if chain[0][0] > version:
                    continue
                val = chain[br(chain, version, key=_ver) - 1][1]
            if val is None:
                continue
            out.append((key, val))
            nbytes += len(key) + len(val)
            if (limit and len(out) >= limit) \
                    or (byte_limit and nbytes >= byte_limit):
                # probe ahead for the exact `more`: the next LIVE row,
                # skipping tombstones/not-yet-visible chains (what
                # range_read's one-probe continuation does)
                while i < n:
                    k2 = keys[i]
                    i += 1
                    c2 = chains[k2]
                    v0, val = c2[-1]
                    if v0 > version:
                        if c2[0][0] > version:
                            continue
                        val = c2[br(c2, version, key=_ver) - 1][1]
                    if val is not None:
                        return out, True
                return out, False
        return out, False

    def overlay_iter(self, begin: bytes, end: bytes, version: Version,
                     reverse: bool = False):
        """Yield (key, found, value) for every key with a chain in range —
        including not-found and tombstone markers — for merging over an
        engine's range iterator."""
        keys = self._index.keys_in_range(begin, end)
        if reverse:
            keys = list(reversed(keys))
        for key in keys:
            found, v = self.get2(key, version)
            yield key, found, v

    # --- compaction (setOldestVersion analog) ---

    def _pop_touched(self, version: Version) -> set[bytes]:
        """Keys with at least one entry at or below ``version`` — every
        such entry has a queued (version, key) record by construction."""
        keys: set[bytes] = set()
        q = self._touched
        while q and q[0][0] <= version:
            keys.add(q.popleft()[1])
        return keys

    def _remove_dead(self, dead: list[bytes]) -> None:
        """Drop fully-compacted keys from chains and index in one batched
        pass (the seed's per-key bisect+del was the quadratic shape on
        the compaction side)."""
        if not dead:
            return
        for key in dead:
            del self._chains[key]
        self._index.discard_many(dead)

    def forget_before(self, version: Version) -> None:
        """Drop history below ``version``; reads at >= version unaffected.
        Touches only keys written at or below ``version`` (incremental)."""
        if version <= self.oldest_version:
            return
        self.oldest_version = version
        dead: list[bytes] = []
        for key in self._pop_touched(version):
            chain = self._chains.get(key)
            if chain is None:
                continue
            # newest entry <= version becomes the base; older ones go
            i = len(chain) - 1
            while i > 0 and chain[i][0] > version:
                i -= 1
            if i > 0:
                del chain[:i]
            if len(chain) == 1 and chain[0][1] is None and chain[0][0] <= version:
                dead.append(key)
        self._remove_dead(dead)

    def rollback_after(self, version: Version) -> None:
        """Discard every entry newer than ``version`` — the storage-server
        rollback at recovery (REF:fdbserver/storageserver.actor.cpp
        rollback): mutations the server applied from a log generation's
        unacked suffix were clamped out of the recovered history and must
        be un-applied before pulling from the new generation.

        Incremental: the touched queue is version-sorted (writes arrive
        in version order), and every chain entry above ``version`` has a
        queued record — so popping the queue's suffix names exactly the
        affected chains, no full-map walk.  Popping the suffix also IS
        the stale-record purge: a higher-version record left at the
        front would park ``_pop_touched`` (it pops while monotonically
        <= target) and stall compaction for every key queued behind it."""
        if version >= self.latest_version:
            return
        self.latest_version = version
        q = self._touched
        if version >= self.oldest_version:
            keys: set[bytes] = set()
            while q and q[-1][0] > version:
                keys.add(q.pop()[1])
            items = [(k, c) for k in keys
                     if (c := self._chains.get(k)) is not None]
        else:
            # rolling below the readable floor (never legal from the role
            # layer, but keep the seed's full-walk semantics as a net)
            items = list(self._chains.items())
            self._touched = deque(e for e in q if e[0] <= version)
            # the stale floor would otherwise park drop/forget_before
            # (their <= oldest_version early-return) until the new
            # generation climbed past it — void it like the columnar
            # twin does, so the nets stay observably equivalent
            self.oldest_version = version
        dead: list[bytes] = []
        for key, chain in items:
            i = len(chain)
            while i > 0 and chain[i - 1][0] > version:
                i -= 1
            if i < len(chain):
                del chain[i:]
            if not chain:
                dead.append(key)
        self._remove_dead(dead)

    def drop_before(self, version: Version) -> None:
        """Remove entries at or below ``version`` entirely (they are now
        durable in the engine); reads at those versions must fall through.
        Mirrors the PTree erase after makeVersionDurable.  Touches only
        keys written at or below ``version`` (incremental)."""
        if version <= self.oldest_version:
            return
        self.oldest_version = version
        dead: list[bytes] = []
        for key in self._pop_touched(version):
            chain = self._chains.get(key)
            if chain is None:
                continue
            i = 0
            while i < len(chain) and chain[i][0] <= version:
                i += 1
            if i > 0:
                del chain[:i]
            if not chain:
                dead.append(key)
        self._remove_dead(dead)


# ---------------------------------------------------------------------------
# Columnar window
# ---------------------------------------------------------------------------


import numpy as np


def _np_q(arr: _array) -> np.ndarray:
    """Zero-copy int64 view of an array('q') column (vector ops only;
    scalar access stays on the stdlib array — the KeyRun discipline)."""
    return np.frombuffer(arr, dtype=np.int64)


def _q_from(npa: np.ndarray) -> _array:
    """array('q') column from an int64 ndarray (one C-speed copy)."""
    a = _array("q")
    a.frombytes(np.ascontiguousarray(npa, dtype=np.int64).tobytes())
    return a


class _Segment:
    """One immutable sealed run of MVCC entries.

    ``keys`` holds the DISTINCT sorted keys; ``counts`` is the cumulative
    entry count per key (so key j's entries live at
    [counts[j-1], counts[j]) — counts[-1] == total entries).  Per entry,
    ``versions`` ascends within each key (ties across layers are broken
    by segment order, never inside one segment), and ``vstarts[i] == -1``
    is the tombstone bit; live values are ``vblob[vstarts[i]:vends[i]]``.
    ``vblob`` may BE a ``MutationBatch`` blob (the near-zero-copy direct
    seal) — offsets are absolute into whatever blob the segment carries.
    """

    __slots__ = ("keys", "counts", "versions", "vstarts", "vends", "vblob",
                 "min_version", "max_version", "fanout1", "_npcols")

    def __init__(self, keys: KeyRun, counts: _array, versions: _array,
                 vstarts: _array, vends: _array, vblob: bytes,
                 min_version: Version, max_version: Version) -> None:
        self.keys = keys
        self.counts = counts
        self.versions = versions
        self.vstarts = vstarts
        self.vends = vends
        self.vblob = vblob
        self.min_version = min_version
        self.max_version = max_version
        # one entry per key — the direct-seal shape; lets range
        # extraction and the batched probe skip the per-key version
        # bisect entirely
        self.fanout1 = len(versions) == len(keys)
        self._npcols = None

    def np_cols(self):
        """(versions, vstarts, vends) as cached zero-copy int64 views —
        the vectorized probe/extraction operands."""
        if self._npcols is None:
            self._npcols = (np.frombuffer(self.versions, dtype=np.int64),
                            np.frombuffer(self.vstarts, dtype=np.int64),
                            np.frombuffer(self.vends, dtype=np.int64))
        return self._npcols

    def __len__(self) -> int:
        return len(self.versions)

    @property
    def nbytes(self) -> int:
        """Resident bytes of the columns (the memory-wall accounting)."""
        return (self.keys.nbytes + len(self.vblob)
                + 8 * (len(self.counts) + 3 * len(self.versions)))

    def find(self, key: bytes) -> int:
        """Distinct-key index of ``key`` or -1."""
        j = self.keys.bisect_left(key)
        if j < len(self.keys) and self.keys.key(j) == key:
            return j
        return -1

    def band(self, j: int) -> tuple[int, int]:
        c = self.counts
        return (c[j - 1] if j else 0), c[j]

    def value(self, i: int) -> bytes | None:
        s = self.vstarts[i]
        return None if s < 0 else self.vblob[s:self.vends[i]]

    def resolve(self, j: int, version: Version
                ) -> tuple[Version, bytes | None] | None:
        """Newest entry of key j at or below ``version`` as (entry
        version, value-or-tombstone-None); None when every entry of the
        key is above ``version``."""
        lo, hi = self.band(j)
        vs = self.versions
        i = bisect.bisect_right(vs, version, lo, hi) - 1
        if i < lo:
            return None
        return vs[i], self.value(i)

    def newest(self, j: int) -> tuple[Version, bytes | None]:
        lo, hi = self.band(j)
        return self.versions[hi - 1], self.value(hi - 1)

    def key_span(self, begin: bytes, end: bytes) -> tuple[int, int]:
        return self.keys.bisect_left(begin), self.keys.bisect_left(end)

    def entries_of(self, j: int) -> list[tuple[Version, bytes | None]]:
        lo, hi = self.band(j)
        vs = self.versions
        return [(vs[i], self.value(i)) for i in range(lo, hi)]

    def truncated(self, version: Version) -> "_Segment | None":
        """Entries at or below ``version`` only (rollback); None when
        nothing survives."""
        if self.max_version <= version:
            return self
        b = _SegmentBuilder()
        keys = self.keys
        for j in range(len(keys)):
            kept = [e for e in self.entries_of(j) if e[0] <= version]
            if kept:
                b.add_key(keys.key(j), kept)
        return b.finish()


class _SegmentBuilder:
    """Accumulates (key, entries) in sorted key order into one segment."""

    __slots__ = ("_keys", "_counts", "_versions", "_vstarts", "_vends",
                 "_chunks", "_pos", "_n", "_vmin", "_vmax")

    def __init__(self) -> None:
        self._keys: list[bytes] = []
        self._counts = _array("q")
        self._versions = _array("q")
        self._vstarts = _array("q")
        self._vends = _array("q")
        self._chunks: list[bytes] = []
        self._pos = 0
        self._n = 0
        self._vmin: Version | None = None
        self._vmax: Version | None = None

    def add_key(self, key: bytes,
                entries: list[tuple[Version, bytes | None]]) -> None:
        self._keys.append(key)
        for ver, val in entries:
            self._versions.append(ver)
            if val is None:
                self._vstarts.append(-1)
                self._vends.append(-1)
            else:
                self._vstarts.append(self._pos)
                self._pos += len(val)
                self._vends.append(self._pos)
                self._chunks.append(val)
            if self._vmin is None or ver < self._vmin:
                self._vmin = ver
            if self._vmax is None or ver > self._vmax:
                self._vmax = ver
        self._n += len(entries)
        self._counts.append(self._n)

    def finish(self) -> _Segment | None:
        if not self._keys:
            return None
        return _Segment(KeyRun.from_keys(self._keys), self._counts,
                        self._versions, self._vstarts, self._vends,
                        b"".join(self._chunks), self._vmin, self._vmax)


class ColumnarVersionedMap:
    """Generational columnar MVCC window — see the module docstring."""

    columnar = True

    def __init__(self, seal_ops: int = SEAL_OPS,
                 seal_bytes: int = SEAL_BYTES,
                 seal_versions: int = SEAL_VERSIONS) -> None:
        self.seal_ops = max(1, seal_ops)
        self.seal_bytes = max(1, seal_bytes)
        self.seal_versions = max(1, seal_versions)
        self.oldest_version: Version = 0
        self.latest_version: Version = 0
        # entries at or below this are dropped-invisible (the engine is
        # authoritative); forget mode never advances it
        self._drop_floor: Version = 0
        # tombstone registry + dead markers: legacy's dead-key removal
        # is TEMPORAL — a lone tombstone judged dead when the floor
        # crossed it stays dead even if the key is re-set later, which
        # retained entries alone cannot reconstruct.  Every tombstone
        # write queues (version, key) here (version-ordered, the
        # _touched discipline restricted to clears); ``forget_before``
        # pops the at-or-below prefix and marks keys whose newest entry
        # is that tombstone in ``_dead`` (key -> tombstone version).  A
        # marker is a PER-KEY drop floor: every entry of the key at or
        # below it reads found=False (legacy removed the whole chain),
        # merges prune those entries physically, and a marker retires
        # only once no remaining layer reaches that far back — pruning
        # just the tombstone would resurrect older shadowed values
        # still sitting in layers outside the merge.
        self._clears: deque[tuple[Version, bytes]] = deque()
        self._dead: dict[bytes, Version] = {}
        # mutable tip: per-key chains for versions above the last seal
        self._tip: dict[bytes, list[tuple[Version, bytes | None]]] = {}
        self._tip_index = PackedKeyIndex()
        self._tip_entries = 0
        self._tip_bytes = 0
        self._tip_min: Version | None = None
        # immutable sealed segments, NEWEST FIRST (resolution order is
        # layer order; version ranges are non-increasing down the list,
        # ties at layer boundaries resolved by layer)
        self._segments: list[_Segment] = []
        self._sealed_through: Version = 0
        # recent-hit probe cache:
        # key -> (version, value, found) — the key's NEWEST sealed
        # entry (or found=False for a key certified to live in no
        # segment) — so a repeat point probe against a multi-segment
        # window resolves at the legacy dict-hit shape: tip miss,
        # cache hit, done.  Entries are recorded only from walks that
        # skipped NO newer segment (a version-filtered walk cannot
        # certify the newest entry), answer only bounds at-or-above
        # the cached version, and the whole cache clears on ANY
        # segment-list change (seal/merge/fold/drop/rollback); newer
        # TIP writes need no invalidation — the tip probe runs first
        # and shadows the cache exactly when it should.
        self._probe_cache: dict[bytes, tuple[Version, bytes | None,
                                             bool]] = {}
        # observability
        self.seals = 0
        self.compactions = 0
        self.folds = 0
        self.seal_s = 0.0

    # --- accounting / observability ---

    def __len__(self) -> int:
        # distinct-key UPPER BOUND (duplicates across layers counted
        # once per layer) — the O(1) metrics surface; ``keys()`` is the
        # exact-but-O(n) test surface
        return len(self._tip) + sum(len(s.keys) for s in self._segments)

    @property
    def nbytes(self) -> int:
        return self._tip_bytes + sum(s.nbytes for s in self._segments)

    def index_stats(self) -> dict:
        return {
            "keys": len(self),
            "pending": self._tip_entries,
            "merges": self.seals + self.compactions + self.folds,
            "merge_ms": round(self.seal_s * 1e3, 3),
            "base_bytes": sum(s.keys.nbytes for s in self._segments),
            "columnar": True,
            "segments": len(self._segments),
            "entries": self._tip_entries + sum(len(s) for s in
                                               self._segments),
            "resident_bytes": self.nbytes,
            "seals": self.seals,
            "folds": self.folds,
        }

    def keys(self) -> list[bytes]:
        """Sorted keys a legacy map would still hold a chain for
        (test/debug surface; O(n))."""
        out: list[bytes] = []
        dead = self._dead
        for key, group in self._groups(b"", None):
            ver, _val = self._newest_in_group(group)
            if ver <= self._drop_floor:
                continue        # every entry dropped to the engine
            d = dead.get(key)
            if d is not None and ver <= d:
                continue        # dead: judged at a past forget tick
            out.append(key)
        return out

    # --- internal: layer resolution ---

    def _resolve_tip(self, key: bytes, version: Version
                     ) -> tuple[Version, bytes | None] | None:
        """Tip probe: None = no chain OR chain entirely above
        ``version`` (older layers may still answer)."""
        chain = self._tip.get(key)
        if chain is None:
            return None
        v0, val = chain[-1]
        if v0 <= version:
            return v0, val
        if chain[0][0] > version:
            return None
        i = bisect.bisect_right(chain, version, key=lambda e: e[0]) - 1
        return chain[i]

    def _finish(self, key: bytes, ver: Version,
                val: bytes | None) -> tuple[bool, bytes | None]:
        """Apply the visibility rules to a resolved entry."""
        if ver <= self._drop_floor:
            # everything at or below the resolved version is older still:
            # all dropped to the engine — fall through
            return False, None
        if self._dead:
            d = self._dead.get(key)
            if d is not None and ver <= d:
                # dead key: legacy forget removed the whole chain when
                # the floor crossed its lone tombstone — the marker is
                # a per-key drop floor over everything it shadowed
                return False, None
        return True, val

    # --- reads ---

    def get(self, key: bytes, version: Version) -> bytes | None:
        found, value = self.get2(key, version)
        return value if found else None

    def get2(self, key: bytes, version: Version) -> tuple[bool, bytes | None]:
        r = self._resolve_tip(key, version)
        if r is not None:
            return self._finish(key, r[0], r[1])
        return self._get2_sealed(key, version)

    def _get2_sealed(self, key: bytes, version: Version
                     ) -> tuple[bool, bytes | None]:
        """``get2`` below the tip (probe cache, then the segment walk)
        — the entry point for callers that already know the tip missed
        (the small-batch fast path), so the tip dict probe is not paid
        twice per key."""
        hint = self._probe_cache.get(key)
        if hint is not None:
            ver, val, found = hint
            if not found:
                # clean-walk-certified: the key lives in NO segment
                return False, None
            if version >= ver:
                # the cached entry is the key's newest sealed entry and
                # the bound clears it: the answer, at dict-hit cost
                # (_finish re-applies the CURRENT floor/dead rules —
                # they move without touching the segment list)
                return self._finish(key, ver, val)
            # bound below the newest sealed entry: rare — full walk
        clean = True        # no newer segment skipped or unresolved yet
        for seg in self._segments:
            if seg.min_version > version:
                clean = False   # a version-filtered walk cannot certify
                #                 the newest sealed entry for any key
                continue
            j = seg.find(key)
            if j < 0:
                continue
            r = seg.resolve(j, version)
            if r is not None:
                if clean:
                    nv, nval = seg.newest(j)
                    if r[0] == nv:
                        # resolved the newest entry of the key's newest
                        # holding segment == its newest sealed entry
                        if len(self._probe_cache) >= _PROBE_CACHE_CAP:
                            self._probe_cache.clear()
                        self._probe_cache[key] = (nv, nval, True)
                return self._finish(key, r[0], r[1])
            clean = False   # the band sits wholly above the bound: an
            #                 older layer may answer, but not with the
            #                 key's newest sealed entry
        if clean:
            # a clean full walk proves the key is in NO segment: cache
            # the negative so repeat misses skip the walk outright
            if len(self._probe_cache) >= _PROBE_CACHE_CAP:
                self._probe_cache.clear()
            self._probe_cache[key] = (0, None, False)
        return False, None

    def get2_batch(self, keys: list[bytes],
                   version: Version) -> list[tuple[bool, bytes | None]]:
        """Batched ``get2`` — the tip resolves as dict probes; each
        segment then answers every still-unresolved key with ONE
        vectorized prefix-searchsorted band per segment (the key-run
        probe discipline) refined by a bisect inside the band."""
        n = len(keys)
        out: list[tuple[bool, bytes | None] | None] = [None] * n
        pending: list[int] = []
        tip = self._tip
        br = bisect.bisect_right
        finish = self._finish
        for i, key in enumerate(keys):
            chain = tip.get(key)
            if chain is None:
                pending.append(i)
                continue
            v0, val = chain[-1]
            if v0 <= version:
                out[i] = finish(key, v0, val)
            elif chain[0][0] > version:
                pending.append(i)
            else:
                k = br(chain, version, key=lambda e: e[0]) - 1
                out[i] = finish(key, chain[k][0], chain[k][1])
        if not pending or not self._segments:
            for i in pending:
                out[i] = (False, None)
            return out  # type: ignore[return-value]
        if n <= _SMALL_PROBE_BATCH:
            # small point-probe batches: the per-segment vectorized probe's
            # transient-
            # KeyRun setup swamps ≤64-key batches — ride the per-key
            # recent-hit cache instead.  The hit path is inlined (one
            # cache dict get + the floor rules), so a warm repeat
            # probe resolves at the legacy dict-hit shape; only cache
            # misses and below-newest version bounds pay a walk.
            cache = self._probe_cache
            drop = self._drop_floor
            dead = self._dead
            for i in pending:
                key = keys[i]
                hint = cache.get(key)
                if hint is None:
                    # pending ⇒ the tip already missed: walk below it
                    out[i] = self._get2_sealed(key, version)
                    continue
                ver, val, found = hint
                if not found or ver <= drop:
                    out[i] = (False, None)
                elif version < ver:
                    out[i] = self._get2_sealed(key, version)
                elif dead and (d := dead.get(key)) is not None \
                        and ver <= d:
                    out[i] = (False, None)
                else:
                    out[i] = (True, val)
            return out  # type: ignore[return-value]
        # a sorted probe list (the wire contract of the multiget path)
        # unlocks the fully-vectorized run-vs-run probe: the probe keys
        # become ONE transient KeyRun whose prefixes encode once, each
        # segment answers the WHOLE batch with one two-level
        # searchsorted (run_positions), and newest-layer-wins resolves
        # as vectorized masks — no per-key dict/bisect work at all.
        srt = n > 1 and all(keys[x] <= keys[x + 1] for x in range(n - 1))
        if srt:
            prun = KeyRun.from_keys(keys)
            if n < 512:
                # list-based encode (2 numpy calls) beats the columnar
                # _pfx_from (~10) at small probe batches; above the
                # crossover the vectorized column encode wins
                from ..ops.keycode import encode_prefix_u64
                prun.adopt_prefixes(
                    encode_prefix_u64(keys),
                    encode_prefix_u64([k[8:16] for k in keys]),
                    np.fromiter(map(len, keys), dtype=np.int64, count=n))
            done = np.zeros(n, dtype=bool)
            done[[i for i in range(n) if out[i] is not None]] = True
            res_ver = np.zeros(n, dtype=np.int64)
            res_s = np.zeros(n, dtype=np.int64)
            res_e = np.zeros(n, dtype=np.int64)
            res_seg = np.full(n, -1, dtype=np.int64)
            for si, seg in enumerate(self._segments):
                if done.all():
                    break
                if seg.min_version > version:
                    continue
                pos, dupm = seg.keys.run_positions(prun)
                if seg.fanout1:
                    npv, nps, npe = seg.np_cols()
                    safe = np.where(dupm, pos, 0)
                    vers = npv[safe]
                    hit = dupm & (vers <= version) & ~done
                    if hit.any():
                        done |= hit
                        res_ver[hit] = vers[hit]
                        res_s[hit] = nps[safe][hit]
                        res_e[hit] = npe[safe][hit]
                        res_seg[hit] = si
                    continue
                # multi-entry segment: per-key band bisect for the
                # still-unresolved matches only
                cand = np.nonzero(dupm & ~done)[0]
                for i in cand.tolist():
                    r = seg.resolve(int(pos[i]), version)
                    if r is None:
                        continue
                    done[i] = True
                    if r[1] is None:
                        # tombstone: settle through the reconciliation
                        # pass (the drop-floor / dead-marker rules)
                        res_ver[i] = r[0]
                        res_seg[i] = si
                        res_s[i] = -1
                    else:
                        # finish applies the same visibility rules
                        # inline; out[i] set skips the reconciliation
                        out[i] = finish(keys[i], r[0], r[1])
            drop = self._drop_floor
            dead = self._dead
            segs = self._segments
            rsl = res_s.tolist()
            rel = res_e.tolist()
            rvl = res_ver.tolist()
            rgl = res_seg.tolist()
            for i in range(n):
                if out[i] is not None:
                    continue
                g = rgl[i]
                if g < 0:
                    out[i] = (False, None)
                    continue
                ver = rvl[i]
                if ver <= drop:
                    out[i] = (False, None)
                    continue
                if dead:
                    d = dead.get(keys[i])
                    if d is not None and ver <= d:
                        out[i] = (False, None)
                        continue
                s = rsl[i]
                out[i] = (True, None) if s == -1 \
                    else (True, segs[g].vblob[s:rel[i]])
            return out  # type: ignore[return-value]
        for seg in self._segments:
            if not pending:
                break
            if seg.min_version > version:
                continue
            nxt: list[int] = []
            probe = [keys[i] for i in pending]
            fnd = seg.keys.batch_find(probe)
            for p, i in enumerate(pending):
                j = fnd[p]
                if j < 0:
                    nxt.append(i)
                    continue
                r = seg.resolve(j, version)
                if r is None:
                    nxt.append(i)
                    continue
                out[i] = finish(probe[p], r[0], r[1])
            pending = nxt
        for i in pending:
            out[i] = (False, None)
        return out  # type: ignore[return-value]

    def _newest_entry(self, key: bytes) -> tuple[Version, bytes | None] | None:
        """The key's newest entry across all layers, or None."""
        chain = self._tip.get(key)
        if chain is not None:
            return chain[-1]
        for seg in self._segments:
            j = seg.find(key)
            if j >= 0:
                return seg.newest(j)
        return None

    def get_latest(self, key: bytes) -> bytes | None:
        e = self._newest_entry(key)
        if e is None or e[0] <= self._drop_floor:
            return None     # absent or dropped: the engine is authoritative
        d = self._dead.get(key) if self._dead else None
        if d is not None and e[0] <= d:
            return None     # dead: the legacy chain was removed
        return e[1]

    # --- range reads (merged candidate walk) ---

    def _candidates(self, begin: bytes, end: bytes | None
                    ) -> list[tuple[bytes, int, int]]:
        """(key, layer, position) for every layer occurrence in
        [begin, end) — ONE C-speed sort puts same-key occurrences
        adjacent with the newest layer first (layer 0 = tip)."""
        out: list[tuple[bytes, int, int]] = []
        if end is None:
            tipkeys = self._tip_index.to_list()
        else:
            tipkeys = self._tip_index.keys_in_range(begin, end)
        out.extend((k, 0, 0) for k in tipkeys)
        for layer, seg in enumerate(self._segments, start=1):
            lo = seg.keys.bisect_left(begin) if begin else 0
            hi = (seg.keys.bisect_left(end) if end is not None
                  else len(seg.keys))
            if lo >= hi:
                continue
            ks = seg.keys.slice_keys(lo, hi)
            out.extend(zip(ks, (layer,) * len(ks), range(lo, hi)))
        out.sort()
        return out

    def _groups(self, begin: bytes, end: bytes | None):
        """Yield (key, [(layer, pos), ...]) per distinct key in range,
        occurrences newest layer first — WINDOWED: candidates
        materialize at most ``_RANGE_WINDOW`` keys per layer per step,
        so a limit-bounded consumer over a huge range (the chunked
        packed-scan continuation) pays O(consumed × layers), never the
        whole remaining range per chunk."""
        cur = begin
        while True:
            if end is not None and cur >= end:
                return
            # pivot: the window-th key of whichever layer reaches it
            # first (strictly > cur since keys are distinct and sorted,
            # so every step progresses)
            pivot = end
            for seg in self._segments:
                lo = seg.keys.bisect_left(cur)
                kth = lo + _RANGE_WINDOW
                if kth < len(seg.keys):
                    k = seg.keys.key(kth)
                    if pivot is None or k < pivot:
                        pivot = k
            if pivot is None:
                allk = self._tip_index.to_list()
                tipkeys = allk[bisect.bisect_left(allk, cur):]
            else:
                tipkeys = self._tip_index.keys_in_range(cur, pivot)
            if len(tipkeys) > _RANGE_WINDOW:
                pivot = tipkeys[_RANGE_WINDOW]
                tipkeys = tipkeys[:_RANGE_WINDOW]
            cands: list[tuple[bytes, int, int]] = []
            cands.extend((k, 0, 0) for k in tipkeys)
            for layer, seg in enumerate(self._segments, start=1):
                lo = seg.keys.bisect_left(cur)
                hi = (seg.keys.bisect_left(pivot) if pivot is not None
                      else len(seg.keys))
                if lo < hi:
                    ks = seg.keys.slice_keys(lo, hi)
                    cands.extend(zip(ks, (layer,) * len(ks),
                                     range(lo, hi)))
            cands.sort()
            i, n = 0, len(cands)
            while i < n:
                key = cands[i][0]
                j = i + 1
                while j < n and cands[j][0] == key:
                    j += 1
                yield key, cands[i:j]
                i = j
            if pivot is None:
                return
            cur = pivot

    def _newest_in_group(self, group) -> tuple[Version, bytes | None]:
        _k, layer, pos = group[0]
        if layer == 0:
            return self._tip[_k][-1]
        return self._segments[layer - 1].newest(pos)

    def _resolve_group(self, key: bytes, group,
                       version: Version) -> tuple[bool, bytes | None]:
        for _k, layer, pos in group:
            if layer == 0:
                r = self._resolve_tip(key, version)
            else:
                seg = self._segments[layer - 1]
                if seg.min_version > version:
                    continue
                r = seg.resolve(pos, version)
            if r is not None:
                return self._finish(key, r[0], r[1])
        return False, None

    def overlay_keys(self, begin: bytes, end: bytes) -> list[bytes]:
        """Sorted distinct keys with any entry in [begin, end) — the
        overlay the run-wise packed range merge bisects into the
        engine's runs.  May include keys that resolve
        found=False (retained-but-invisible entries); the consumer's
        lazy ``get2`` makes those indistinguishable from absent chains."""
        out: list[bytes] = []
        last = None
        for cand in self._candidates(begin, end):
            if cand[0] != last:
                last = cand[0]
                out.append(last)
        return out

    def overlay_iter(self, begin: bytes, end: bytes, version: Version,
                     reverse: bool = False):
        """Yield (key, found, value) for every key with an entry in
        range — the row-wise merge feed (engine-backed legacy + reverse
        paths).  Forward iteration stays LAZY (the windowed group walk
        — a limit-bounded consumer never pays for the range's tail);
        reverse — the selector-resolution shape, small by contract —
        materializes and flips."""
        if reverse:
            groups = list(self._groups(begin, end))
            groups.reverse()
            for key, group in groups:
                found, val = self._resolve_group(key, group, version)
                yield key, found, val
            return
        for key, group in self._groups(begin, end):
            found, val = self._resolve_group(key, group, version)
            yield key, found, val

    def range_iter(self, begin: bytes, end: bytes, version: Version,
                   reverse: bool = False) -> Iterator[tuple[bytes, bytes]]:
        for key, found, val in self.overlay_iter(begin, end, version,
                                                 reverse):
            if found and val is not None:
                yield key, val

    def range_read(self, begin: bytes, end: bytes, version: Version,
                   limit: int = 0, reverse: bool = False,
                   byte_limit: int = 0
                   ) -> tuple[list[tuple[bytes, bytes]], bool]:
        """Returns (kv pairs, more); more=True means limits truncated."""
        out: list[tuple[bytes, bytes]] = []
        nbytes = 0
        it = self.range_iter(begin, end, version, reverse)
        for kv in it:
            out.append(kv)
            nbytes += len(kv[0]) + len(kv[1])
            if (limit and len(out) >= limit) \
                    or (byte_limit and nbytes >= byte_limit):
                more = next(it, None) is not None
                return out, more
        return out, False

    def range_rows(self, begin: bytes, end: bytes, version: Version,
                   limit: int = 0, byte_limit: int = 0
                   ) -> tuple[list[tuple[bytes, bytes]], bool]:
        """Forward bulk range read, result identical to ``range_read``
        without reverse (tested) — the engine-less packed range path.
        The hot shape — one sealed fanout-1 segment covering the range
        at-or-below ``version``, no tip or sibling overlap — extracts
        rows as C-speed column slices with no per-key resolution at
        all; mixed layers fall back to the merged candidate walk."""
        fast = self._range_rows_fast(begin, end, version, limit, byte_limit)
        if fast is not None:
            return fast
        return self.range_read(begin, end, version, limit, False,
                               byte_limit)

    def _range_rows_fast(self, begin: bytes, end: bytes, version: Version,
                         limit: int, byte_limit: int):
        """The single-segment bulk extraction, or None to fall back."""
        if (self._drop_floor or self._dead) and self._segments:
            return None     # dropped/dead-invisible entries need the walk
        owner = None
        for layer, seg in enumerate(self._segments, start=1):
            lo, hi = seg.key_span(begin, end)
            if lo >= hi:
                continue
            if owner is not None:
                return None
            owner = (seg, lo, hi)
        if owner is None:
            return None     # tip-only (or empty): the walk handles it
        if self._tip_index.keys_in_range(begin, end):
            return None
        seg, lo, hi = owner
        if not seg.fanout1 or seg.max_version > version \
                or seg.min_version <= self._drop_floor:
            return None
        out: list[tuple[bytes, bytes]] = []
        nbytes = 0
        blob = seg.vblob
        step = 4096
        for base in range(lo, hi, step):
            top = min(base + step, hi)
            ks = seg.keys.slice_keys(base, top)
            starts = seg.vstarts[base:top].tolist()
            ends = seg.vends[base:top].tolist()
            for off, (k, s, e) in enumerate(zip(ks, starts, ends)):
                if s < 0:
                    continue            # tombstone
                v = blob[s:e]
                out.append((k, v))
                nbytes += len(k) + len(v)
                if (limit and len(out) >= limit) \
                        or (byte_limit and nbytes >= byte_limit):
                    # exact `more`: probe ahead for the next live row
                    pos = base + off + 1
                    vs2 = seg.vstarts
                    while pos < hi:
                        if vs2[pos] >= 0:
                            return out, True
                        pos += 1
                    return out, False
        return out, False

    # --- writes ---

    def _tip_append(self, version: Version, key: bytes,
                    value: bytes | None, fresh: list[bytes] | None) -> None:
        """One entry into the tip chain (index insert via ``fresh`` when
        deferred, direct otherwise)."""
        chain = self._tip.get(key)
        if chain is None:
            self._tip[key] = [(version, value)]
            if fresh is None:
                self._tip_index.add(key)
            else:
                fresh.append(key)
            self._tip_entries += 1
            self._tip_bytes += len(key) + (len(value) if value else 0)
        elif chain[-1][0] == version:
            old = chain[-1][1]
            chain[-1] = (version, value)
            self._tip_bytes += ((len(value) if value else 0)
                                - (len(old) if old else 0))
        else:
            chain.append((version, value))
            self._tip_entries += 1
            self._tip_bytes += len(key) + (len(value) if value else 0)
        if value is None:
            # tombstone registry: drives the eager dead-key judgment in
            # forget_before (see the constructor comment)
            self._clears.append((version, key))
        if self._tip_min is None:
            self._tip_min = version

    def _live_newest(self, key: bytes) -> bool:
        """True when a legacy chain for ``key`` would exist with a LIVE
        tip — the clear_range predicate (the newest entry anywhere is a
        value above the drop floor and the dead marker)."""
        e = self._newest_entry(key)
        if e is None or e[1] is None or e[0] <= self._drop_floor:
            return False
        d = self._dead.get(key) if self._dead else None
        return d is None or e[0] > d

    def _clear_keys(self, ranges: list[tuple[bytes, bytes]]
                    ) -> list[list[bytes]]:
        """Per range: sorted distinct keys with any entry in it (the
        clear_range candidate sets; tip + segments merged)."""
        tip_parts = self._tip_index.ranges_keys(ranges)
        out: list[list[bytes]] = []
        for (b, e), tipkeys in zip(ranges, tip_parts):
            parts = [tipkeys] if tipkeys else []
            for seg in self._segments:
                lo, hi = seg.key_span(b, e)
                if lo < hi:
                    parts.append(seg.keys.slice_keys(lo, hi))
            if not parts:
                out.append([])
            elif len(parts) == 1:
                out.append(parts[0])
            else:
                allk = set()
                for p in parts:
                    allk.update(p)
                out.append(sorted(allk))
        return out

    def set(self, version: Version, key: bytes, value: bytes) -> None:
        assert version >= self.latest_version, \
            f"mutations must arrive in version order " \
            f"(v={version} < latest={self.latest_version})"
        self.latest_version = version
        self._tip_append(version, key, value, None)
        self._maybe_seal()

    def clear_range(self, version: Version, begin: bytes,
                    end: bytes) -> None:
        assert version >= self.latest_version
        self.latest_version = version
        for key in self._clear_keys([(begin, end)])[0]:
            if self._live_newest(key):
                self._tip_append(version, key, None, None)
        self._maybe_seal()

    def apply_batch(self, ops: list[tuple[Version, int, bytes, bytes]]
                    ) -> int:
        """Version-ordered (version, OP_SET|OP_CLEAR, p1, p2) run —
        state-equivalent to the set/clear_range loop (tested against the
        legacy twin and the brute-force model)."""
        fresh: list[bytes] = []
        latest = self.latest_version
        n = len(ops)
        i = 0
        while i < n:
            version, op, p1, p2 = ops[i]
            assert version >= latest, \
                f"mutations must arrive in version order " \
                f"(v={version} < latest={latest})"
            latest = version
            if op == OP_SET:
                self._tip_append(version, p1, p2, fresh)
                i += 1
                continue
            # a run of consecutive clears: candidate sets must see fresh
            # keys from this batch, and the tip bounds resolve in one
            # vectorized pass
            if fresh:
                self._tip_index.add_many(fresh)
                fresh = []
            j = i
            while j < n and ops[j][1] == OP_CLEAR:
                j += 1
            run = ops[i:j]
            for (version, _op, _b, _e), keys in zip(
                    run, self._clear_keys([(o[2], o[3]) for o in run])):
                latest = version
                for key in keys:
                    if self._live_newest(key):
                        self._tip_append(version, key, None, None)
            i = j
        if fresh:
            self._tip_index.add_many(fresh)
        self.latest_version = latest
        self._maybe_seal()
        return n

    def apply_packed(self, version: Version, batch) -> int:
        """One version's simple-only packed ``MutationBatch`` straight
        off its columnar arrays.  An all-SET batch of at least
        ``_DIRECT_SEAL_MIN`` ops SEALS DIRECTLY into a segment: the
        value column IS the batch blob (zero value copies), only the
        keys are sorted into a fresh ``KeyRun``.  Smaller or
        clear-bearing batches ride the tip like ``apply_batch``."""
        assert version >= self.latest_version, \
            f"mutations must arrive in version order " \
            f"(v={version} < latest={self.latest_version})"
        types = batch.types
        n = len(types)
        if (n >= _DIRECT_SEAL_MIN and batch.simple_only
                and b"\x01" not in types):
            self._seal_batch(version, batch)
            return n
        offs = batch.offsets()
        blob = batch.blob
        fresh: list[bytes] = []
        clears: list[tuple[bytes, bytes]] = []

        def flush_clears() -> None:
            for keys in self._clear_keys(clears):
                for key in keys:
                    if self._live_newest(key):
                        self._tip_append(version, key, None, None)
            clears.clear()

        prev = 0
        for i in range(n):
            e1, e2 = offs[2 * i], offs[2 * i + 1]
            p1 = blob[prev:e1]
            if types[i] == OP_SET:
                if clears:
                    flush_clears()
                self._tip_append(version, p1, blob[e1:e2], fresh)
            else:
                if fresh:
                    self._tip_index.add_many(fresh)
                    fresh = []
                clears.append((p1, blob[e1:e2]))
            prev = e2
        if clears:
            flush_clears()
        if fresh:
            self._tip_index.add_many(fresh)
        self.latest_version = version
        self._maybe_seal()
        return n

    def _seal_batch(self, version: Version, batch) -> None:
        """Direct seal of one all-SET packed batch (near-zero-copy: the
        value offsets point into the batch's own blob)."""
        t0 = time.perf_counter()
        if self._tip:
            self._seal_tip()    # older layer must seal first
        from itertools import starmap
        blob = batch.blob
        n = len(batch.types)
        bounds = np.frombuffer(batch.bounds, dtype="<u4").astype(np.int64)
        e1 = bounds[0::2]
        e2 = bounds[1::2]
        kstarts = np.empty(n, dtype=np.int64)
        kstarts[0] = 0
        kstarts[1:] = e2[:-1]
        # one C-speed map-of-slices; already-sorted batches (bulk loads,
        # fetchKeys pages) skip the pair sort entirely
        keys = list(map(blob.__getitem__,
                        starmap(slice, zip(kstarts.tolist(), e1.tolist()))))
        dup = len({*keys}) != n
        if not dup and n > 1 \
                and all(keys[x] < keys[x + 1] for x in range(n - 1)):
            dkeys = keys
            vstarts = _q_from(e1)
            vends = _q_from(e2)
            versions = _q_from(np.full(n, version, dtype=np.int64))
            counts = _q_from(np.arange(1, n + 1, dtype=np.int64))
        elif not dup:
            pairs = sorted(zip(keys, range(n)))
            order = np.array([i for _k, i in pairs], dtype=np.int64)
            dkeys = [k for k, _i in pairs]
            vstarts = _q_from(e1[order])
            vends = _q_from(e2[order])
            versions = _q_from(np.full(n, version, dtype=np.int64))
            counts = _q_from(np.arange(1, n + 1, dtype=np.int64))
        else:
            pairs = sorted(zip(keys, range(n)))
            # duplicates within one version: the LAST occurrence wins
            # (the legacy same-version chain-tip replace); the sort is
            # stable, so equal keys keep batch order
            dkeys = []
            vstarts = _array("q")
            vends = _array("q")
            versions = _array("q")
            counts = _array("q")
            last = None
            for k, i in pairs:
                if k == last:
                    vstarts[-1] = e1[i]
                    vends[-1] = e2[i]
                    continue
                last = k
                dkeys.append(k)
                vstarts.append(e1[i])
                vends.append(e2[i])
                versions.append(version)
                counts.append(len(dkeys))
        seg = _Segment(KeyRun.from_keys(dkeys), counts, versions,
                       vstarts, vends, blob, version, version)
        self._segments.insert(0, seg)
        self._probe_cache.clear()
        self._sealed_through = version
        self.latest_version = version
        self.seals += 1
        self.seal_s += time.perf_counter() - t0
        self._compact()

    def _maybe_seal(self) -> None:
        if not self._tip:
            return
        if (self._tip_entries >= self.seal_ops
                or self._tip_bytes >= self.seal_bytes
                or (self._tip_min is not None
                    and self.latest_version - self._tip_min
                    >= self.seal_versions)):
            self._seal_tip()
            self._compact()

    def _seal_tip(self) -> None:
        """Freeze the tip into one sealed segment (key-sorted via the
        tip's own index — no re-sort of the chains dict)."""
        if not self._tip:
            return
        t0 = time.perf_counter()
        b = _SegmentBuilder()
        tip = self._tip
        for key in self._tip_index.to_list():
            b.add_key(key, tip[key])
        seg = b.finish()
        if seg is not None:
            self._segments.insert(0, seg)
            self._probe_cache.clear()
            self._sealed_through = max(self._sealed_through,
                                       seg.max_version)
        self._tip = {}
        self._tip_index = PackedKeyIndex()
        self._tip_entries = 0
        self._tip_bytes = 0
        self._tip_min = None
        self.seals += 1
        self.seal_s += time.perf_counter() - t0

    # --- compaction / fold ---

    def _merge_pair(self, old: _Segment, new: _Segment) -> _Segment | None:
        """Merge two ADJACENT layers into one segment, fully
        vectorized: the newer (smaller) side's keys locate in the older
        run with one two-level batched bisect, the int64 entry columns
        combine as single ``np.insert`` calls, and the value blobs
        CONCATENATE — offsets are absolute, so no value byte is ever
        copied until a vacuum.  Entries the floor rules make permanently
        invisible are pruned on the way out (``_prune_build``)."""
        A, B = old, new
        posb_np, dup = A.keys.run_positions(B.keys)
        ca = np.diff(_np_q(A.counts), prepend=0)
        cb = np.diff(_np_q(B.counts), prepend=0)
        prev_cum = np.concatenate([np.zeros(1, dtype=np.int64),
                                   _np_q(A.counts)])
        # entry-space insertion points: a duplicate key's B entries land
        # AFTER its A band (B is the newer layer — bisect_right tie
        # order preserved); a fresh key's land at its band gap
        ins_entry = prev_cum[posb_np + dup]
        ins_rep = np.repeat(ins_entry, cb)
        versions = np.insert(_np_q(A.versions), ins_rep, _np_q(B.versions))
        shift = len(A.vblob)
        vsb = _np_q(B.vstarts)
        veb = _np_q(B.vends)
        vstarts = np.insert(_np_q(A.vstarts), ins_rep,
                            np.where(vsb < 0, vsb, vsb + shift))
        vends = np.insert(_np_q(A.vends), ins_rep,
                          np.where(veb < 0, veb, veb + shift))
        vblob = A.vblob + B.vblob
        ca2 = ca.copy()
        np.add.at(ca2, posb_np[dup], cb[dup])
        fresh = ~dup
        fresh_pos = posb_np[fresh]
        counts_per = np.insert(ca2, fresh_pos, cb[fresh])
        # one gather-based columnar stitch; the prefix/length caches
        # ride along via np.insert (prefixes are position-independent)
        keys = A.keys.insert_run_at(fresh_pos, B.keys, fresh)
        return self._prune_build(keys, counts_per, versions, vstarts,
                                 vends, vblob)

    def _prune_build(self, keys: KeyRun, counts_per: np.ndarray,
                     versions: np.ndarray, vstarts: np.ndarray,
                     vends: np.ndarray, vblob: bytes) -> _Segment | None:
        """Drop permanently-invisible entries and build the segment:
        everything at or below the drop floor goes; per key, entries
        below the newest at-or-below the forget floor go (the legacy
        folded chain prefix); tombstones carrying a ``_dead`` marker go
        (the legacy dead-key removal, judged eagerly in forget_before)
        and their markers retire.  All vectorized (reduceat over entry
        bands); the value blob keeps dead bytes until a vacuum pass
        rewrites it at >50% waste."""
        ne = len(versions)
        if ne == 0:
            return None
        drop = self._drop_floor
        forget = self.oldest_version
        starts = np.concatenate([np.zeros(1, dtype=np.int64),
                                 np.cumsum(counts_per)[:-1]])
        keep = versions > drop
        le = versions <= forget
        base = None
        if le.any():
            band_id = np.repeat(np.arange(len(counts_per)), counts_per)
            idx = np.where(le, np.arange(ne), -1)
            base = np.maximum.reduceat(idx, starts)
            keep &= (~le) | (np.arange(ne) == base[band_id])
        if self._dead:
            dkeys = sorted(self._dead)
            dpos = keys.batch_find(dkeys, assume_sorted=True)
            cum = np.cumsum(counts_per)
            for k, p in zip(dkeys, dpos):
                if p < 0:
                    continue
                # the marker is a per-key drop floor: every entry it
                # shadows goes.  The marker itself stays — other layers
                # outside this merge may still hold entries that old
                # (forget_before retires it once none can)
                ver = self._dead[k]
                lo, hi = int(starts[p]), int(cum[p])
                for e in range(lo, hi):
                    if versions[e] <= ver:
                        keep[e] = False
        if not keep.all():
            versions = versions[keep]
            vstarts = vstarts[keep]
            vends = vends[keep]
            new_per = np.add.reduceat(keep.astype(np.int64), starts)
            gone = np.nonzero(new_per == 0)[0]
            if len(gone):
                keys = keys.delete_at(gone.tolist())
                new_per = new_per[new_per > 0]
            counts_per = new_per
            if len(versions) == 0:
                return None
        live = int(np.where(vstarts >= 0, vends - vstarts, 0).sum())
        if len(vblob) > 2 * live + 4096:
            # vacuum: >50% of the blob is dead value bytes — rewrite it
            sl = vstarts.tolist()
            el = vends.tolist()
            parts = [vblob[s:e] for s, e in zip(sl, el) if s >= 0]
            lens = np.where(vstarts < 0, 0, vends - vstarts)
            ends2 = np.cumsum(lens)
            vends = np.where(vstarts < 0, -1, ends2)
            vstarts = np.where(vstarts < 0, -1, ends2 - lens)
            vblob = b"".join(parts)
        return _Segment(keys, _q_from(np.cumsum(counts_per)),
                        _q_from(versions), _q_from(vstarts),
                        _q_from(vends), vblob,
                        int(versions.min()), int(versions.max()))

    def _compact(self) -> None:
        """Bound the live segment count with binary-counter tiering:
        the fresh seal at the head merges into its older neighbor while
        it has grown to a comparable size, cascading — every entry is
        merged O(log n) times total and the live layer count stays
        O(log(entries / seal budget)).  A hard cap backstops degenerate
        seal patterns by merging the smallest adjacent pair."""
        segs = self._segments
        t0 = time.perf_counter()
        did = 0
        while len(segs) >= 2 and 2 * len(segs[0]) >= len(segs[1]):
            merged = self._merge_pair(segs[1], segs[0])
            segs[1:2] = []
            segs[0:1] = [merged] if merged is not None else []
            did += 1
        while len(segs) > _SEG_CAP:
            best, bi = None, 0
            for i in range(len(segs) - 1):
                n = len(segs[i]) + len(segs[i + 1])
                if best is None or n < best:
                    best, bi = n, i
            merged = self._merge_pair(segs[bi + 1], segs[bi])
            segs[bi:bi + 2] = [merged] if merged is not None else []
            did += 1
        if did:
            self._probe_cache.clear()
            self.compactions += did
            self.seal_s += time.perf_counter() - t0

    # --- compaction floors (setOldestVersion analogs) ---

    def forget_before(self, version: Version) -> None:
        """Advance the readable floor; entries below each key's newest
        at-or-below ``version`` become permanently invisible and are
        reclaimed by the lazy fold (geometrically amortized so a hot
        2M-key base is not re-merged every durability tick).  Dead keys
        are judged EAGERLY off the tombstone registry — the temporal
        half of legacy semantics that retained entries cannot encode."""
        if version <= self.oldest_version:
            return
        self.oldest_version = version
        q = self._clears
        while q and q[0][0] <= version:
            _v, key = q.popleft()
            e = self._newest_entry(key)
            if (e is not None and e[1] is None
                    and self._drop_floor < e[0] <= version):
                # newest entry is a tombstone the floor just crossed:
                # the legacy fold would remove this chain outright
                self._dead[key] = e[0]
        if self._tip and self._tip_min is not None \
                and version >= self._tip_min:
            self._seal_tip()
        below = [s for s in self._segments if s.max_version <= version]
        if len(below) >= _FOLD_MIN_SEGS:
            base = below[-1]
            newer_mass = sum(len(s) for s in below[:-1])
            if newer_mass > len(base) or len(base) < 4096:
                # fold only once the newer wholly-below mass EXCEEDS
                # the base (geometric amortization: each fold at least
                # doubles it, so a key folds O(log n) times total — an
                # every-tick fold would re-merge a 2M-entry base per
                # durability tick, the r5 shape again).  Between folds
                # the tiered compaction's per-merge prune keeps
                # reclaiming superseded entries.
                t0 = time.perf_counter()
                keep = [s for s in self._segments
                        if s.max_version > version]
                # pairwise oldest-up fold: each step one vectorized
                # pair merge, every merge pruning on the way out
                acc: _Segment | None = below[-1]
                for s in reversed(below[:-1]):
                    acc = s if acc is None else self._merge_pair(acc, s)
                if acc is not None:
                    keep.append(acc)
                self._segments = keep
                self._probe_cache.clear()
                self.folds += 1
                self.seal_s += time.perf_counter() - t0
        self._retire_markers()

    def _retire_markers(self) -> None:
        """Drop dead markers no remaining layer can reach: once every
        layer's oldest entry is newer than a marker, nothing it shadows
        exists anywhere and the dict entry is moot."""
        if not self._dead:
            return
        gmin: Version | None = None
        for s in self._segments:
            gmin = s.min_version if gmin is None else min(gmin,
                                                         s.min_version)
        if self._tip and self._tip_min is not None:
            gmin = self._tip_min if gmin is None else min(gmin,
                                                          self._tip_min)
        if gmin is None:
            self._dead.clear()
        else:
            self._dead = {k: v for k, v in self._dead.items() if v >= gmin}

    def drop_before(self, version: Version) -> None:
        """Entries at or below ``version`` are now durable in the
        engine: whole segments at-or-below the floor retire in
        O(segments); a straddling segment's sub-floor entries turn
        invisible via the drop-floor read rule and fall out at its next
        merge."""
        if version <= self.oldest_version:
            return
        self.oldest_version = version
        self._drop_floor = version
        q = self._clears
        while q and q[0][0] <= version:
            q.popleft()     # dropped-invisible: no dead judgment needed
        if self._dead:
            self._dead = {k: v for k, v in self._dead.items()
                          if v > version}
        if self._tip and self._tip_min is not None \
                and version >= self._tip_min:
            self._seal_tip()
        keep = [s for s in self._segments if s.max_version > version]
        if len(keep) != len(self._segments):
            self._segments = keep
            self._probe_cache.clear()

    def rollback_after(self, version: Version) -> None:
        """Discard every entry newer than ``version`` (storage rejoin):
        suffix segments drop whole, a straddling segment truncates, and
        the tip trims per chain (bounded by the seal budget)."""
        if version >= self.latest_version:
            return
        self.latest_version = version
        q = self._clears
        while q and q[-1][0] > version:
            q.pop()         # the rolled-back suffix's registry records
        if version < self.oldest_version:
            # rolling below the readable floor (the legacy full-walk
            # net): markers could otherwise outlive a version the new
            # generation re-uses
            self._clears = deque(e for e in self._clears
                                 if e[0] <= version)
            if self._dead:
                self._dead = {k: v for k, v in self._dead.items()
                              if v <= version}
            # ...and so could the FLOORS: a stale drop floor above the
            # rollback target would read every new-generation write at
            # or below it as engine-durable-and-dropped (found=False)
            # while the legacy twin serves it — the judgments both
            # floors encode are void for versions the new generation
            # re-uses.  (Entries physically retained at or below the
            # target stay at-or-below the lowered drop floor, so
            # nothing previously dropped resurrects.)
            self.oldest_version = version
            if self._drop_floor > version:
                self._drop_floor = version
        if self._tip:
            dead: list[bytes] = []
            entries = 0
            nbytes = 0
            vmin: Version | None = None
            for key, chain in self._tip.items():
                i = len(chain)
                while i > 0 and chain[i - 1][0] > version:
                    i -= 1
                if i < len(chain):
                    del chain[i:]
                if not chain:
                    dead.append(key)
                    continue
                entries += len(chain)
                for ver, val in chain:
                    nbytes += len(key) + (len(val) if val else 0)
                    if vmin is None or ver < vmin:
                        vmin = ver
            for key in dead:
                del self._tip[key]
            self._tip_index.discard_many(dead)
            self._tip_entries = entries
            self._tip_bytes = nbytes
            self._tip_min = vmin
        segs: list[_Segment] = []
        for s in self._segments:
            if s.min_version > version:
                continue                    # whole layer rolled back
            if s.max_version > version:
                t = s.truncated(version)
                if t is not None:
                    segs.append(t)
            else:
                segs.append(s)
        self._segments = segs
        self._probe_cache.clear()
        if self._sealed_through > version:
            self._sealed_through = version
