"""Columnar sorted key runs — the shared home of the big-run layout.

Reference: the storage memory walls.  Two structures in this
repo keep a large sorted run of keys: ``PackedKeyIndex._base`` (the
MVCC/engine key index, storage/key_index.py) and the lsm engine's
per-run sparse index (the block first-keys, storage/lsm.py).  Both were
plain Python ``list[bytes]`` — ~50-100 bytes of PyObject overhead per
key, so 10M keys burned ~1GB before storing a single value, and both
had independently grown the same keycode-u64-prefix ``searchsorted``
fast path.

``KeyRun`` is that run gone columnar (the ``PackedRows`` discipline
applied to keys): ONE contiguous blob of concatenated keys plus a
cumulative int64 end-offset column, with the keycode-packed uint64
prefixes cached alongside.  Per-key memory drops to ~key_len + 8 (+8
once the prefixes are built); merges become one vectorized
``np.insert`` over the length column + an O(overlay)-segment blob
stitch; probes bisect straight over blob slices.

Two probe disciplines compose:

- the u64-prefix ``searchsorted`` narrows a batch to equal-prefix bands
  in one vectorized call (the PackedKeyIndex/lsm idiom, now one home);
- the exact bisect runs over LOCAL blob/bounds variables (the bounds
  column is a stdlib ``array('q')`` precisely so scalar indexing stays
  a ~50ns Python int, not a numpy scalar box), and batched bisects over
  SORTED probes carry a monotone lower bound — key i's insertion point
  floors key i+1's search — which matters exactly when a keyspace
  shares its first 8 bytes and the prefix bands collapse to the whole
  run.

The run is IMMUTABLE: mutation surfaces (``merge_sorted``,
``delete_keys``) return a new run sharing no state with the old one, so
readers holding a reference (a device mirror mid-upload, a spilled
segment) can never observe a half-built state.  The sequence protocol
(``__len__``/``__getitem__``/``__iter__``) makes a run a drop-in for
the sorted ``list[bytes]`` it replaces wherever callers only index,
slice, and bisect.
"""

from __future__ import annotations

from array import array as _array

import numpy as np

__all__ = ["KeyRun"]

_ITER_CHUNK = 4096      # keys materialized per __iter__ slab

# batched probes below this fall back to a per-key bisect: one scalar
# np.searchsorted costs ~5µs of call overhead where bisect is ~1µs (the
# PackedKeyIndex threshold reasoning, kept at the shared home)
_BATCH_MIN = 16


class KeyRun:
    """One immutable columnar sorted run of byte keys."""

    __slots__ = ("blob", "bounds", "_pfx", "_pfx2", "_lens")

    def __init__(self, blob: bytes = b"",
                 bounds: _array | None = None) -> None:
        self.blob = blob
        self.bounds = bounds if bounds is not None else _array("q")
        self._pfx: np.ndarray | None = None
        self._pfx2: np.ndarray | None = None
        self._lens: np.ndarray | None = None

    # --- construction ---

    @classmethod
    def from_keys(cls, keys: list[bytes]) -> "KeyRun":
        """Pack an already-sorted key list (duplicates permitted for
        directory uses; the index contract keeps them distinct)."""
        if not keys:
            return cls()
        from itertools import accumulate
        return cls(b"".join(keys), _array("q", accumulate(map(len, keys))))

    def _np_bounds(self) -> np.ndarray:
        """Zero-copy numpy view of the bounds column (vector ops only —
        scalar access stays on the stdlib array)."""
        return np.frombuffer(self.bounds, dtype=np.int64)

    # --- sequence protocol (drop-in for the sorted list it replaces) ---

    def __len__(self) -> int:
        return len(self.bounds)

    def __bool__(self) -> bool:
        return len(self.bounds) > 0

    def key(self, i: int) -> bytes:
        b = self.bounds
        return self.blob[(b[i - 1] if i else 0):b[i]]

    def __getitem__(self, i):
        if isinstance(i, slice):
            lo, hi, step = i.indices(len(self.bounds))
            keys = self.slice_keys(lo, hi)
            return keys if step == 1 else keys[::step]
        n = len(self.bounds)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self.key(i)

    def __iter__(self):
        n = len(self.bounds)
        for lo in range(0, n, _ITER_CHUNK):
            yield from self.slice_keys(lo, min(lo + _ITER_CHUNK, n))

    def __eq__(self, other) -> bool:
        if isinstance(other, KeyRun):
            return self.blob == other.blob and self.bounds == other.bounds
        if isinstance(other, (list, tuple)):
            return len(self) == len(other) and self.to_list() == list(other)
        return NotImplemented

    __hash__ = None  # type: ignore[assignment] — mutable-adjacent semantics

    def slice_keys(self, lo: int, hi: int) -> list[bytes]:
        """Rows [lo, hi) materialized as ``list[bytes]`` — the bounds
        unpack is C-speed map-of-slices (the PackedRows.rows idiom),
        never a per-key Python loop."""
        n = len(self.bounds)
        lo, hi = max(0, lo), min(hi, n)
        if lo >= hi:
            return []
        from itertools import starmap
        ends = self.bounds[lo:hi].tolist()
        starts = [self.bounds[lo - 1] if lo else 0] + ends[:-1]
        return list(map(self.blob.__getitem__,
                        starmap(slice, zip(starts, ends))))

    def to_list(self) -> list[bytes]:
        return self.slice_keys(0, len(self.bounds))

    @property
    def nbytes(self) -> int:
        """Resident bytes of the columnar storage (blob + bounds +
        prefixes when built) — what the memory-wall accounting reports."""
        n = len(self.blob) + len(self.bounds) * self.bounds.itemsize
        if self._pfx is not None:
            n += self._pfx.nbytes
        return n

    # --- prefixes (the vectorized-searchsorted operand) ---

    def _pfx_from(self, skip: int) -> np.ndarray:
        """u64 of key bytes [skip, skip+8) per key, zero-padded —
        computed straight off the columns."""
        n = len(self.bounds)
        if n == 0:
            return np.zeros(0, dtype=np.uint64)
        flat = np.frombuffer(self.blob, dtype=np.uint8)
        ends = self._np_bounds()
        starts = np.empty(n, dtype=np.int64)
        starts[0] = 0
        starts[1:] = ends[:-1]
        starts = starts + skip
        plens = np.minimum(np.maximum(ends - starts, 0), 8)
        buf = np.zeros((n, 8), dtype=np.uint8)
        cols = np.arange(8)[None, :]
        mask = cols < plens[:, None]
        src = np.minimum(starts[:, None] + cols, max(len(flat) - 1, 0))
        buf[mask] = flat[src[mask]]
        return buf.view(">u8").ravel().astype(np.uint64)

    def prefixes(self) -> np.ndarray:
        """keycode-u64 prefixes of every key (cached) — computed straight
        off the columns, byte-identical to
        ``keycode.encode_prefix_u64(self.to_list())`` without the join."""
        if self._pfx is None:
            self._pfx = self._pfx_from(0)
        return self._pfx

    def lens(self) -> np.ndarray:
        """Per-key byte lengths (cached) — run_positions' tie-breaker."""
        if self._lens is None:
            self._lens = np.diff(self._np_bounds(), prepend=0)
        return self._lens

    def prefixes2(self) -> np.ndarray:
        """SECOND-word prefixes (key bytes [8, 16), cached): the rescue
        level for keyspaces sharing their first 8 bytes, where the
        primary bands collapse to the whole run (the band-
        collapse shape).  Within an equal-``prefixes()`` band, keys sort
        by this word, so a second searchsorted restricted to the band
        is exact up to 16 bytes."""
        if self._pfx2 is None:
            self._pfx2 = self._pfx_from(8)
        return self._pfx2

    # --- point probes ---
    #
    # Hand-rolled bisects over LOCAL blob/bounds: the inner loop is a
    # python-int index, one blob slice and one compare per step —
    # bisect.bisect_left(self, ...) would pay __getitem__ dispatch,
    # bounds checks and len() per step, measured ~6x slower at 2M keys.

    def bisect_left(self, key: bytes, lo: int = 0, hi: int | None = None
                    ) -> int:
        bounds = self.bounds
        blob = self.blob
        if hi is None:
            hi = len(bounds)
        while lo < hi:
            mid = (lo + hi) >> 1
            if blob[(bounds[mid - 1] if mid else 0):bounds[mid]] < key:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def bisect_right(self, key: bytes, lo: int = 0, hi: int | None = None
                     ) -> int:
        bounds = self.bounds
        blob = self.blob
        if hi is None:
            hi = len(bounds)
        while lo < hi:
            mid = (lo + hi) >> 1
            if key < blob[(bounds[mid - 1] if mid else 0):bounds[mid]]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def __contains__(self, key: bytes) -> bool:
        i = self.bisect_left(key)
        return i < len(self.bounds) and self.key(i) == key

    # --- batched probes (ONE vectorized searchsorted for the batch) ---

    def batch_bisect(self, keys: list[bytes], side: str = "left",
                     sorted_keys: bool = False) -> list[int]:
        """Exact insertion points for many keys — prefix searchsorted +
        per-key bisect refinement, with a plain-bisect fallback below
        the amortization threshold.  ``sorted_keys=True`` (the merge /
        delete path) additionally floors each refinement at the
        previous result, and COLLAPSED bands (a keyspace sharing its
        first 8 bytes maps every probe to the whole run — the
        band-collapse shape) re-narrow through one second-word
        searchsorted per distinct band (``prefixes2``), so the
        refinement never degenerates to m full-run bisects."""
        point = self.bisect_left if side == "left" else self.bisect_right
        m = len(keys)
        if m < _BATCH_MIN or len(self.bounds) < _BATCH_MIN:
            if not sorted_keys:
                return [point(k) for k in keys]
            out: list[int] = []
            prev = 0
            for k in keys:
                prev = point(k, prev)
                out.append(prev)
            return out
        from ..ops.keycode import encode_prefix_u64
        pfx = self.prefixes()
        probes = encode_prefix_u64(keys)
        los = np.searchsorted(pfx, probes, side="left").tolist()
        his = np.searchsorted(pfx, probes, side="right").tolist()
        out = [0] * m
        prev = 0
        i = 0
        while i < m:
            lo, hi = los[i], his[i]
            j = i + 1
            while j < m and los[j] == lo and his[j] == hi:
                j += 1
            if hi - lo > 32 and (hi - lo) > 2 * (j - i):
                # collapsed band shared by probes [i, j): one restricted
                # second-word searchsorted re-narrows them all
                pfx2 = self.prefixes2()
                p2 = encode_prefix_u64([k[8:16] for k in keys[i:j]])
                l2 = (lo + np.searchsorted(pfx2[lo:hi], p2,
                                           side="left")).tolist()
                h2 = (lo + np.searchsorted(pfx2[lo:hi], p2,
                                           side="right")).tolist()
                for p in range(i, j):
                    blo, bhi = l2[p - i], h2[p - i]
                    if sorted_keys and prev > blo:
                        blo = prev
                    if bhi < blo:
                        bhi = blo
                    prev = point(keys[p], blo, bhi)
                    out[p] = prev
            else:
                for p in range(i, j):
                    blo, bhi = lo, hi
                    if sorted_keys and prev > blo:
                        blo = prev
                    if bhi < blo:
                        bhi = blo
                    prev = point(keys[p], blo, bhi)
                    out[p] = prev
            i = j
        return out

    def adopt_prefixes(self, pfx: np.ndarray | None,
                       pfx2: np.ndarray | None,
                       lens: np.ndarray | None = None) -> "KeyRun":
        """Install precomputed prefix (and optionally length) caches
        (the segment-merge path: prefixes are position-independent, so
        a merge can np.insert the parents' cached arrays instead of
        re-encoding the whole run)."""
        self._pfx = pfx
        self._pfx2 = pfx2
        if lens is not None:
            self._lens = lens
        return self

    def run_positions(self, other: "KeyRun"
                      ) -> tuple[np.ndarray, np.ndarray]:
        """(left insertion positions, exact-match mask) of another
        SORTED run's keys in this run — the columnar MVCC merge/probe
        primitive, fully vectorized: one searchsorted pair
        over the first-word prefixes, one per collapsed band over the
        second word, and a LENGTH compare settles order and equality
        for prefix-tied keys of <= 16 bytes (a shorter key is a strict
        prefix of the longer, so it sorts first; equal length means
        equal key).  Only ties past 16 bytes fall back to byte-level
        bisects."""
        m = len(other)
        nA = len(self.bounds)
        if m == 0:
            return (np.zeros(0, dtype=np.int64),
                    np.zeros(0, dtype=bool))
        if nA == 0:
            return (np.zeros(m, dtype=np.int64),
                    np.zeros(m, dtype=bool))
        pa = self.prefixes()
        pb = other.prefixes()
        lo = np.searchsorted(pa, pb, side="left").astype(np.int64)
        hi = np.searchsorted(pa, pb, side="right")
        pos = lo.copy()
        dup = np.zeros(m, dtype=bool)
        amb = hi > lo
        if not amb.any():
            return pos, dup
        pa2 = self.prefixes2()
        pb2 = other.prefixes2()
        lenA = self.lens()
        lenB = other.lens()
        ai = np.nonzero(amb)[0]
        # ``other`` is sorted, so equal-prefix probes (hence equal
        # bands) are contiguous in ai; group by the band's lo value
        band_lo = lo[ai]
        cuts = np.nonzero(np.diff(band_lo))[0] + 1
        group_starts = np.concatenate([[0], cuts, [len(ai)]])
        hard: list[int] = []
        for g in range(len(group_starts) - 1):
            gi = ai[group_starts[g]:group_starts[g + 1]]
            blo = int(lo[gi[0]])
            bhi = int(hi[gi[0]])
            sub2 = pa2[blo:bhi]
            p2 = pb2[gi]
            l2 = blo + np.searchsorted(sub2, p2, side="left")
            h2 = blo + np.searchsorted(sub2, p2, side="right")
            pos[gi] = l2
            sz = h2 - l2
            one = sz == 1
            if one.any():
                ii = gi[one]
                p1 = l2[one]
                la = lenA[p1]
                lb = lenB[ii]
                easy = (la <= 16) & (lb <= 16)
                dup[ii[easy & (la == lb)]] = True
                pos[ii[easy & (la < lb)]] += 1
                hard.extend(ii[~easy].tolist())
            multi = sz > 1
            if multi.any():
                hard.extend(gi[multi].tolist())
        if hard:
            okey = other.key
            n = nA
            for i in hard:
                k = okey(i)
                p = self.bisect_left(k, int(lo[i]), int(hi[i]))
                pos[i] = p
                dup[i] = p < n and self.key(p) == k
        return pos, dup

    def merge_newest_wins(self, newer: "KeyRun"
                          ) -> tuple["KeyRun", np.ndarray]:
        """Distinct-key union of self (the OLDER layer) and ``newer``,
        duplicate keys taking the newer side — the lsm leveled
        compactor's 2-source merge primitive.  Returns
        (merged run, per-merged-row source index: [0, len(self)) names
        self's rows, [len(self), len(self)+len(newer)) names newer's),
        so a parallel value column resolves with one fancy-index pass.
        Fully vectorized: one ``run_positions`` call locates every
        newer key, duplicates overwrite in the source-index column, and
        the merged key blob stitches through ``insert_run_at``'s
        byte-gather."""
        nA = len(self.bounds)
        nB = len(newer.bounds)
        if nA == 0:
            return newer, np.arange(nB, dtype=np.int64)
        if nB == 0:
            return self, np.arange(nA, dtype=np.int64)
        pos, dup = self.run_positions(newer)
        src = np.arange(nA, dtype=np.int64)
        di = np.nonzero(dup)[0]
        if len(di):
            src[pos[di]] = nA + di
        fresh = ~dup
        fi = np.nonzero(fresh)[0]
        merged = np.insert(src, pos[fresh], nA + fi)
        keys = self.insert_run_at(pos[fresh], newer, fresh)
        return keys, merged

    def batch_find(self, keys: list[bytes],
                   assume_sorted: bool = False) -> list[int]:
        """Exact positions of ``keys`` (or -1 where absent) — the
        columnar MVCC window's per-segment probe: the
        two-level ``batch_bisect`` banding plus one membership slice
        compare per probe."""
        n = len(self.bounds)
        if not keys or n == 0:
            return [-1] * len(keys)
        pos = self.batch_bisect(keys, "left", sorted_keys=assume_sorted)
        key_at = self.key
        return [p if p < n and key_at(p) == k else -1
                for p, k in zip(pos, keys)]

    # --- mutation (immutable: each returns a NEW run) ---

    def merge_sorted(self, new_keys: list[bytes]) -> "KeyRun":
        """Merge a sorted list of distinct keys NOT already present:
        insertion points resolve in one monotone batched pass, the new
        bounds build as one ``np.insert`` + cumsum, and the blob
        stitches from O(m) segment slices — never a per-key pass over
        the base."""
        if not new_keys:
            return self
        if not len(self.bounds):
            return KeyRun.from_keys(new_keys)
        pos = self.batch_bisect(new_keys, "left", sorted_keys=True)
        return self.insert_at(pos, new_keys)

    def insert_run_at(self, pos: np.ndarray, other: "KeyRun",
                      mask: np.ndarray) -> "KeyRun":
        """Stitch ``other``'s rows selected by ``mask`` in at ascending
        insertion points ``pos`` (one per selected row) — the columnar
        MVCC segment merge's key build.  Fully vectorized:
        the merged blob assembles through ONE byte-level gather over the
        two source blobs, and the prefix/length caches merge by
        ``np.insert`` instead of re-encoding (prefixes are
        position-independent)."""
        m = int(mask.sum())
        if m == 0:
            return self
        if not len(self.bounds):
            if m == len(other.bounds):
                return other
            # partial adoption of another run: fall back to the list path
            from itertools import compress
            return KeyRun.from_keys(
                list(compress(other.to_list(), mask.tolist())))
        lenA = self.lens()
        lenBall = other.lens()
        lenB = lenBall[mask]
        endsB = other._np_bounds()
        startsB = (endsB - lenBall)[mask] + len(self.blob)
        endsA = self._np_bounds()
        startsA = endsA - lenA
        flat = np.frombuffer(self.blob + other.blob, dtype=np.uint8)
        mstarts = np.insert(startsA, pos, startsB)
        mlens = np.insert(lenA, pos, lenB)
        tot = int(mlens.sum())
        row_off = np.concatenate([np.zeros(1, dtype=np.int64),
                                  np.cumsum(mlens)[:-1]])
        gidx = np.repeat(mstarts - row_off, mlens) \
            + np.arange(tot, dtype=np.int64)
        bounds = _array("q")
        bounds.frombytes(np.cumsum(mlens).tobytes())
        out = KeyRun(flat[gidx].tobytes(), bounds)
        if self._pfx is not None and other._pfx is not None:
            out._pfx = np.insert(self._pfx, pos, other._pfx[mask])
        if self._pfx2 is not None and other._pfx2 is not None:
            out._pfx2 = np.insert(self._pfx2, pos, other._pfx2[mask])
        out._lens = mlens
        return out

    def insert_at(self, pos: list[int], new_keys: list[bytes]) -> "KeyRun":
        """Stitch ``new_keys`` in at precomputed ascending insertion
        points (the merge_sorted build with the bisect pass already
        paid — the columnar MVCC segment merge's shape)."""
        if not new_keys:
            return self
        if not len(self.bounds):
            return KeyRun.from_keys(new_keys)
        ends = self.bounds
        np_ends = self._np_bounds()
        base_lens = np.diff(np_ends, prepend=0)
        new_lens = np.fromiter(map(len, new_keys), dtype=np.int64,
                               count=len(new_keys))
        merged = np.insert(base_lens, pos, new_lens)
        bounds = _array("q")
        bounds.frombytes(np.cumsum(merged).tobytes())
        parts: list[bytes] = []
        blob = self.blob
        prev = 0
        for p, k in zip(pos, new_keys):
            boff = ends[p - 1] if p else 0
            if boff > prev:
                parts.append(blob[prev:boff])
                prev = boff
            parts.append(k)
        if prev < len(blob):
            parts.append(blob[prev:])
        return KeyRun(b"".join(parts), bounds)

    def delete_keys(self, dead: list[bytes]) -> tuple["KeyRun", int]:
        """Remove every present key of ``dead``; returns (new run,
        number removed).  Locations resolve in one monotone batched
        pass; the survivor columns build from O(d) segment slices."""
        if not dead or not len(self.bounds):
            return self, 0
        dead_sorted = sorted(set(dead))
        pos = self.batch_bisect(dead_sorted, "left", sorted_keys=True)
        n = len(self.bounds)
        hit = [p for p, k in zip(pos, dead_sorted)
               if p < n and self.key(p) == k]
        if not hit:
            return self, 0
        return self.delete_at(hit), len(hit)

    def delete_at(self, hit: list[int]) -> "KeyRun":
        """Remove the keys at the given ascending positions (the
        located half of ``delete_keys``; the columnar MVCC segment
        prune's shape)."""
        ends = self.bounds
        lens = np.diff(self._np_bounds(), prepend=0)
        bounds = _array("q")
        bounds.frombytes(np.cumsum(np.delete(lens, hit)).tobytes())
        parts: list[bytes] = []
        blob = self.blob
        prev = 0
        for p in hit:
            start = ends[p - 1] if p else 0
            if start > prev:
                parts.append(blob[prev:start])
            prev = ends[p]
        if prev < len(blob):
            parts.append(blob[prev:])
        return KeyRun(b"".join(parts), bounds)
