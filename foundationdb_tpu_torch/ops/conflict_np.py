"""NumPy twin of the device conflict kernels — the deterministic CPU reference.

Same semantics, slab for slab, as ops/conflict_torch.py, so the device
and the CPU produce bit-identical verdicts AND ring state; simulation
always runs this twin (SURVEY.md §4: determinism with an accelerator in
the loop is hard part #1, solved by never putting it in the sim loop).

Replaces the reference's ConflictSet (REF:fdbserver/SkipList.cpp): where
the reference walks a probabilistic skip list per range with SSE prefetch,
we brute-force compare every read range in the batch against a
fixed-capacity ring of (interval, version) write records — embarrassingly
parallel, exactly what a TPU's VPU wants.

Ring semantics (canonical oldest-first ring, mirroring the r5 device
kernel):

- slots are kept oldest-first: slot C-1 is the newest write; appending a
  batch's slab of B*R records shifts the ring left by B*R and writes the
  slab at the tail.  Lanes that insert nothing store the sentinel
  interval [S, S) (overlaps nothing) but still carry the batch's commit
  version, keeping the ring version-dense so the device's window
  fast-path edge test is sound;
- the B*R slots shifted out are evicted history: the too-old ``floor``
  rises to their max version — history older than the evicted records is
  gone, so any snapshot preceding it gets TOO_OLD — the same safe
  fallback the reference applies when history is compacted
  (setOldestVersion / MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
  REF:fdbserver/Resolver.actor.cpp).
"""

from __future__ import annotations

import numpy as np

from . import keycode
from .batch import COMMITTED, CONFLICT, TOO_OLD, EncodedBatch
from .keycode import DEFAULT_WIDTH


def _possibly_lt(a, b, width):
    both_trunc = (a[..., -1] == width + 1) & (b[..., -1] == width + 1)
    return keycode.lex_lt(a, b) | (keycode.lex_eq(a, b) & both_trunc)


def _overlap(ab, ae, bb, be, width):
    """Conservative interval overlap: [ab,ae) might intersect [bb,be)."""
    return _possibly_lt(ab, be, width) & _possibly_lt(bb, ae, width)


class NumpyConflictSet:
    """Fixed-capacity conflict history ring + batch resolve.

    The ring is allocated lazily on the first batch (slab size = B*R);
    ``capacity`` is rounded up to a whole number of slabs, exactly as
    JaxConflictSet does.
    """

    def __init__(self, capacity: int, width: int = DEFAULT_WIDTH,
                 oldest_version: int = 0):
        self.capacity = capacity
        self.width = width
        self.floor = np.int64(oldest_version)
        # Internal storage is a classic pointer ring (_hb/_he/_hver + ptr):
        # a host array overwrites S_ slots in place, where the device
        # kernel's canonical shift is nearly free HBM traffic but a full
        # O(C) memcpy per batch here (measured 2x slower sim suite).  The
        # SEMANTICS are identical — the slab at ptr is always the oldest
        # retained — and the ``hb``/``he``/``hver`` properties expose the
        # canonical oldest-first view for state-parity tests.
        self._hb = None   # [C, L] uint32 (row-major on host; device twin is [L, C])
        self._he = None
        self._hver = None  # [C] int64, -1 = never written
        self.ptr = 0
        self.used = 0     # slots ever written (bounds the history scan)
        self._slab = None

    def _canonical(self, arr):
        p = self.ptr
        return np.concatenate([arr[p:], arr[:p]], axis=0)

    @property
    def hb(self):
        """Canonical (oldest-first) view — matches the device layout."""
        return self._canonical(self._hb)

    @property
    def he(self):
        return self._canonical(self._he)

    @property
    def hver(self):
        return self._canonical(self._hver)

    def _ensure_state(self, B: int, R: int) -> None:
        if self._hb is not None:
            if self._slab != B * R:
                raise ValueError(
                    f"batch shape changed: slab {B * R} != {self._slab}")
            return
        self._slab = B * R
        cap = ((self.capacity + self._slab - 1) // self._slab) * self._slab
        self.capacity = cap
        L = keycode.nlanes(self.width)
        S = keycode.sentinel(self.width)
        self._hb = np.tile(S, (cap, 1))
        self._he = np.tile(S, (cap, 1))
        self._hver = np.full(cap, -1, np.int64)

    # --- ConflictSet API (mirrors newConflictSet/setOldestVersion/resolve) ---

    def set_oldest_version(self, v: int) -> None:
        self.floor = max(self.floor, np.int64(v))

    @property
    def oldest_version(self) -> int:
        return int(self.floor)

    def resolve_encoded(self, eb: EncodedBatch, commit_version: int) -> np.ndarray:
        """Returns verdicts [B] int8; appends the batch's slab to the ring."""
        B, R, L = eb.shape
        self._ensure_state(B, R)
        S_ = B * R
        w = self.width
        snap = eb.read_snapshot  # [B]

        too_old = snap < self.floor

        # 1. reads vs history ring, sliced to ever-written slots (order is
        #    irrelevant to a full scan; the TPU twin scans its full
        #    fixed-shape ring — sentinel rows compare identically to
        #    absent ones, so verdicts match exactly)
        U = self.used
        hit = _overlap(eb.read_begin[:, :, None, :], eb.read_end[:, :, None, :],
                       self._hb[None, None, :U, :],
                       self._he[None, None, :U, :], w)
        newer = self._hver[None, None, :U] > snap[:, None, None]
        hist_conflict = (hit & newer).any(axis=(1, 2))           # [B]

        # 2. intra-batch: reads of i vs writes of j: [B,R,1,1,L] x [1,1,B,R,L] -> [B,B]
        m = _overlap(eb.read_begin[:, :, None, None, :], eb.read_end[:, :, None, None, :],
                     eb.write_begin[None, None, :, :, :], eb.write_end[None, None, :, :, :], w)
        M = m.any(axis=(1, 3))
        np.fill_diagonal(M, False)

        # 3. sequential commit resolution (order within batch matters; the
        #    reference's checkIntraBatchConflicts walks txns in order too)
        committed = np.zeros(B, dtype=bool)
        verdict = np.full(B, COMMITTED, dtype=np.int8)
        for i in range(B):
            if snap[i] < 0:           # padding txn
                continue
            if too_old[i]:
                verdict[i] = TOO_OLD
            elif hist_conflict[i] or (committed[:i] & M[i, :i]).any():
                verdict[i] = CONFLICT
            else:
                committed[i] = True

        # 4. append the slab at ptr — the oldest retained slab (identical
        #    semantics to the device kernel's canonical shift-left-and-
        #    append; only the storage rotation differs).  Committed writes
        #    keep their ranges, every other lane stores the sentinel
        #    interval; the whole slab takes commit_version.  The S_
        #    evicted slots raise the floor to their max version.
        SEN = keycode.sentinel(w)
        valid_w = eb.write_begin[..., -1] != 0xFFFFFFFF          # [B,R]
        ins = (committed[:, None] & valid_w).reshape(S_)
        p = self.ptr
        old = self._hver[p:p + S_]
        self.floor = max(self.floor, np.int64(old.max(initial=np.int64(-1))))
        self._hb[p:p + S_] = np.where(ins[:, None],
                                      eb.write_begin.reshape(S_, L), SEN)
        self._he[p:p + S_] = np.where(ins[:, None],
                                      eb.write_end.reshape(S_, L), SEN)
        self._hver[p:p + S_] = commit_version
        self.ptr = (p + S_) % self.capacity
        self.used = min(self.capacity, self.used + S_)
        return verdict
