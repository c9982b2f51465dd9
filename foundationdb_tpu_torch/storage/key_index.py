"""Packed sorted key index — the VersionedMap's range-scan structure.

Reference: REF:fdbserver/VersionedMap.h keeps keys in a persistent
red-black tree, paying O(log n) per insert.  The seed's Python port used
one flat sorted list with ``bisect.insort`` per fresh key — an O(n) list
memmove per insert, O(n²) across a bulk load, which is exactly the r5
YCSB-at-1M-rows collapse (BENCH_r05.json: ~900ms SlowTask stalls all in
``bisect.insort``).

The replacement is two sorted runs merged lazily:

- ``_base``   — the big immutable sorted run.  COLUMNAR by default: a
``storage/key_runs.py`` ``KeyRun`` — one contiguous key
  blob + cumulative int64 bounds with the keycode-u64 prefixes cached
  alongside — so per-key memory is ~key_len + 8 instead of the ~50-100
  bytes of PyObject overhead a ``list[bytes]`` pays (10M keys: tens of
  MB instead of ~1GB).  ``columnar=False`` keeps the plain-list base —
  the genuinely-old layout, retained as the equivalence/RSS A/B
  baseline (tools/perf_smoke.py --stage bigkeys measures both).
- ``_pending``— a small sorted ``list[bytes]`` overlay absorbing
  inserts (always tiny relative to the base; object overhead is noise).

Inserts go to the overlay (cheap memmove while it is small); when the
overlay outgrows ``max(_PENDING_MIN, len(base) >> _MERGE_SHIFT)`` the two
runs are merged in ONE pass — columnar: a vectorized ``np.insert`` over
the bounds + an O(m)-segment blob stitch; list: concat + Timsort's
galloping two-run merge.  Because the merge threshold scales with the
base, a key insert costs amortized O(log n) work overall in either mode
— the same cost class as the PTree.

Batch inserts (``add_many``) skip the per-key overlay memmove entirely;
batch removals (``discard_many``) are one located pass.

Bound queries (range scans, clear_range) binary-search both runs.  For
BATCHES of ranges (``ranges_keys``, fed by a run of consecutive clears
in ``VersionedMap.apply_batch``) a numpy ``searchsorted`` over the
cached keycode-u64 prefixes resolves every bound in one vectorized
call, with a bisect refining inside the equal-prefix band — the same
pack-keys-into-lane-arrays idiom the TPU resolver uses, applied to the
storage role.  The prefix cache now lives on the ``KeyRun`` itself, the
ONE home the lsm sparse index and the device read mirror share.
"""

from __future__ import annotations

import bisect
import time

import numpy as np

from .key_runs import KeyRun

_PENDING_MIN = 1024     # overlay always allowed to reach this size
_MERGE_SHIFT = 3        # ...or base/8, whichever is larger
_ADD_PENDING_CAP = 8192  # single-key adds merge earlier: insort's memmove
#                          over a base/8-sized overlay would itself go
#                          quadratic across a long run of lone set() calls
_NP_MIN = 1 << 14       # numpy prefix fast path needs a base this large...
_NP_BOUNDS_MIN = 16     # ...and this many bounds to amortize call overhead
_SMALL_DISCARD = 32     # list mode: below this, per-key del beats a filter
_CHANGE_LOG_CAP = 64    # retained per-gen change spans; older mutations
#                         degrade sharded mirrors to a full re-split


class PackedKeyIndex:
    __slots__ = ("_base", "_pending", "_list_pfx", "merges", "merge_s",
                 "gen", "columnar", "changes")

    def __init__(self, columnar: bool = True) -> None:
        self.columnar = columnar
        self._base: KeyRun | list[bytes] = KeyRun() if columnar else []
        self._list_pfx: np.ndarray | None = None   # list-mode prefix cache
        self._pending: list[bytes] = []     # sorted overlay
        self.merges = 0                      # observability: merge count
        self.merge_s = 0.0                   # ...and total merge seconds
        # base-run generation: bumped whenever _base mutates (merge,
        # discard).  Device mirrors (device/read_serve.py) stamp their
        # uploaded copy with this and refresh on mismatch; the pending
        # overlay is probed host-side, so inserts alone never stale them
        self.gen = 0
        # per-gen change spans: each base mutation records
        # (gen, lo_key, hi_key) — the key span it touched (None span =
        # a gen bump that changed no keys).  The sharded device mirror
        # reads changed_since() to re-upload ONLY the shards whose key
        # range a merge/discard intersected.
        self.changes: list[tuple[int, bytes | None, bytes | None]] = []

    def __len__(self) -> int:
        return len(self._base) + len(self._pending)

    def __iter__(self):
        yield from self._merged(self._base, self._pending)

    def _base_bisect(self, key: bytes, lo: int = 0,
                     hi: int | None = None) -> int:
        base = self._base
        if self.columnar:
            return base.bisect_left(key, lo, hi)
        return bisect.bisect_left(base, key, lo,
                                  len(base) if hi is None else hi)

    def __contains__(self, key: bytes) -> bool:
        i = bisect.bisect_left(self._pending, key)
        if i < len(self._pending) and self._pending[i] == key:
            return True
        base = self._base
        i = self._base_bisect(key)
        return i < len(base) and base[i] == key

    def to_list(self) -> list[bytes]:
        return list(self)

    # --- inserts ---

    def add(self, key: bytes) -> None:
        """Insert one key NOT already present (amortized O(log n))."""
        pending = self._pending
        if pending and key > pending[-1]:
            pending.append(key)         # sequential keys: no memmove
        else:
            bisect.insort(pending, key)
        if len(pending) >= min(max(_PENDING_MIN,
                                   len(self._base) >> _MERGE_SHIFT),
                               _ADD_PENDING_CAP):
            self._merge()

    def add_many(self, keys: list[bytes]) -> None:
        """Bulk-insert distinct keys not already present: one sort over
        the overlay, one merge when it overflows — never a per-key pass
        over the base."""
        if not keys:
            return
        self._pending.extend(keys)
        self._pending.sort()
        self._maybe_merge()

    def _maybe_merge(self) -> None:
        if len(self._pending) >= max(_PENDING_MIN,
                                     len(self._base) >> _MERGE_SHIFT):
            self._merge()

    def _merge(self) -> None:
        t0 = time.perf_counter()
        pend = self._pending
        span = (pend[0], pend[-1]) if pend else (None, None)
        if self.columnar:
            # one vectorized bounds insert + O(overlay) blob stitch
            self._base = self._base.merge_sorted(self._pending)
        else:
            # two sorted runs back to back: Timsort's run detection makes
            # this a single galloping merge, O(n+m)
            self._base = self._base + self._pending
            self._base.sort()
        self._pending = []
        self._list_pfx = None
        self.merges += 1
        self.gen += 1
        self._note_change(*span)
        self.merge_s += time.perf_counter() - t0

    # --- removals ---

    def discard_many(self, keys: list[bytes]) -> None:
        """Remove keys (each assumed present in at most one run) in one
        located pass per run — never a per-key bisect+del over the base."""
        if not keys:
            return
        dead = set(keys)
        if self._pending:
            kept = [k for k in self._pending if k not in dead]
            removed = len(self._pending) - len(kept)
            if removed:
                self._pending = kept
                if removed == len(dead):
                    return
        if self.columnar:
            self._base, removed = self._base.delete_keys(list(dead))
            if removed:
                self.gen += 1
                self._note_change(min(dead), max(dead))
            return
        base = self._base
        if len(dead) <= _SMALL_DISCARD:
            hit = False
            for k in sorted(dead):
                i = bisect.bisect_left(base, k)
                if i < len(base) and base[i] == k:
                    del base[i]
                    hit = True
            if hit:
                self._list_pfx = None
                self.gen += 1
                self._note_change(min(dead), max(dead))
        else:
            nb = len(base)
            self._base = [k for k in base if k not in dead]
            if len(self._base) != nb:
                self._list_pfx = None
                self.gen += 1
                self._note_change(min(dead), max(dead))

    # --- bound queries ---
    #
    # A LONE bound query stays on bisect: measured at 1M keys, plain
    # bisect_left is ~0.8µs (list) / a few µs of per-step key slicing
    # (columnar) while a scalar np.searchsorted costs ~5µs of numpy call
    # overhead per probe.  The numpy prefix path only wins BATCHED,
    # where one vectorized searchsorted over all 2N bounds amortizes the
    # call overhead — see ranges_keys.

    def keys_in_range(self, begin: bytes, end: bytes) -> list[bytes]:
        """Sorted keys in [begin, end) across both runs."""
        return self._slice(self._base_bisect(begin),
                           self._base_bisect(end),
                           begin, end)

    def _base_slice(self, lo: int, hi: int):
        base = self._base
        return base.slice_keys(lo, hi) if self.columnar else base[lo:hi]

    def _slice(self, blo: int, bhi: int,
               begin: bytes, end: bytes) -> list[bytes]:
        plo = bisect.bisect_left(self._pending, begin)
        phi = bisect.bisect_left(self._pending, end)
        if plo == phi:
            return self._base_slice(blo, bhi)
        if blo == bhi:
            return self._pending[plo:phi]
        return list(self._merged(self._base_slice(blo, bhi),
                                 self._pending[plo:phi]))

    def _prefixes(self) -> np.ndarray:
        if self.columnar:
            return self._base.prefixes()
        if self._list_pfx is None:
            from ..ops.keycode import encode_prefix_u64
            self._list_pfx = encode_prefix_u64(self._base)
        return self._list_pfx

    def ranges_keys(self,
                    ranges: list[tuple[bytes, bytes]]) -> list[list[bytes]]:
        """Keys for many [begin, end) ranges — the clear_range bounds
        fast path.  All 2N bounds resolve in ONE vectorized searchsorted
        over the keycode-packed uint64 prefixes of the base run; a
        per-bound bisect then refines within the (usually tiny)
        equal-prefix band.  The index must not mutate between the ranges
        (apply_batch guarantees this: a run of consecutive clears has no
        intervening inserts)."""
        if len(self._base) < _NP_MIN or 2 * len(ranges) < _NP_BOUNDS_MIN:
            return [self.keys_in_range(b, e) for b, e in ranges]
        from ..ops.keycode import encode_prefix_u64
        flat = [k for r in ranges for k in r]
        pfx = self._prefixes()
        probes = encode_prefix_u64(flat)
        los = np.searchsorted(pfx, probes, side="left")
        his = np.searchsorted(pfx, probes, side="right")
        out = []
        for i, (begin, end) in enumerate(ranges):
            blo = self._base_bisect(begin,
                                    int(los[2 * i]), int(his[2 * i]))
            bhi = self._base_bisect(end,
                                    int(los[2 * i + 1]), int(his[2 * i + 1]))
            out.append(self._slice(blo, bhi, begin, end))
        return out

    @staticmethod
    def _merged(a, b):
        """Two-run sorted merge (both runs hold distinct keys; either
        may be a list or a KeyRun — only indexing/iteration is used)."""
        if not b:
            yield from a
            return
        if not a:
            yield from b
            return
        i = j = 0
        na, nb = len(a), len(b)
        while i < na and j < nb:
            if a[i] <= b[j]:
                yield a[i]
                i += 1
            else:
                yield b[j]
                j += 1
        if i < na:
            yield from (a.slice_keys(i, na) if isinstance(a, KeyRun)
                        else a[i:])
        else:
            yield from (b.slice_keys(j, nb) if isinstance(b, KeyRun)
                        else b[j:])

    # --- device-mirror accessors (device/read_serve.py) ---

    def base_run(self):
        """The sorted base run itself (NOT a copy — read-only callers).
        A ``KeyRun`` in columnar mode, a plain list otherwise; both
        support len/index/bisect."""
        return self._base

    def pending_run(self) -> list[bytes]:
        """The sorted pending overlay (NOT a copy — read-only callers)."""
        return self._pending

    def base_prefixes(self) -> np.ndarray:
        """The base run's keycode-u64 prefixes (the cached array the
        numpy bound path uses — one home for the encoding)."""
        return self._prefixes()

    def _note_change(self, lo: bytes | None, hi: bytes | None) -> None:
        self.changes.append((self.gen, lo, hi))
        if len(self.changes) > _CHANGE_LOG_CAP:
            del self.changes[:len(self.changes) // 2]

    def changed_since(self, gen: int
                      ) -> list[tuple[bytes, bytes]] | None:
        """Key spans the base mutations after ``gen`` touched, or None
        when the log cannot account for EVERY bump since then (trimmed
        entries, a caller older than the cap) — the sharded mirror then
        falls back to a full re-split.  Empty-span bumps (a merge with
        nothing pending) count toward completeness but add no span."""
        if gen == self.gen:
            return []
        recent = [e for e in self.changes if e[0] > gen]
        if len(recent) != self.gen - gen:
            return None
        return [(lo, hi) for _g, lo, hi in recent if lo is not None]

    # --- observability ---

    def stats(self) -> dict:
        return {
            "keys": len(self),
            "pending": len(self._pending),
            "merges": self.merges,
            "merge_ms": round(self.merge_s * 1e3, 3),
            "base_bytes": (self._base.nbytes if self.columnar else None),
            "columnar": self.columnar,
        }
