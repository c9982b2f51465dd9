"""The resolve-batch wire/device format.

Mirrors CommitTransactionRef (REF:fdbclient/CommitTransaction.h):
each transaction carries read_conflict_ranges, write_conflict_ranges and a
read_snapshot version; a ResolveTransactionBatchRequest
(REF:fdbserver/ResolverInterface.h) carries a batch of them plus the batch
commit version.  Here the ranges are pre-encoded into fixed-shape uint32
lane arrays so a whole batch is one device dispatch.

Shapes (B txns, R padded ranges per txn, L key lanes):
    read_begin/read_end/write_begin/write_end : [B, R, L] uint32
    read_snapshot                             : [B] int64
Padding rows use the all-ones SENTINEL key so [S, S) overlaps nothing.
Transactions beyond the real count have read_snapshot = -1 (ignored).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from . import keycode
from .keycode import DEFAULT_WIDTH


@dataclasses.dataclass
class TxnRequest:
    """One transaction's conflict info, host-side (byte-string ranges)."""
    read_ranges: list[tuple[bytes, bytes]]
    write_ranges: list[tuple[bytes, bytes]]
    read_snapshot: int


# Verdict codes (match the reference's ConflictBatch::TransactionCommitted /
# TransactionConflict / TransactionTooOld trichotomy, REF:fdbserver/SkipList.cpp)
COMMITTED = 0
CONFLICT = 1
TOO_OLD = 2


def _serialize(txns: list[TxnRequest], R: int | None = None):
    """(key blob, offsets [nkeys+1] int64, nr [n] int32, nw [n] int32,
    snapshots [n] int64) of txns in the wire order: per txn its read
    ranges' begin,end then its write ranges'.  With ``R``, a txn with
    more than R ranges of either kind raises."""
    n = len(txns)
    parts: list[bytes] = []
    nr = np.empty(n, dtype=np.int32)
    nw = np.empty(n, dtype=np.int32)
    snaps = np.empty(n, dtype=np.int64)
    for i, t in enumerate(txns):
        if R is not None and (len(t.read_ranges) > R
                              or len(t.write_ranges) > R):
            raise ValueError(
                f"txn {i} has {len(t.read_ranges)}r/{len(t.write_ranges)}w "
                f"ranges; bucket is {R}")
        nr[i] = len(t.read_ranges)
        nw[i] = len(t.write_ranges)
        for b, e in t.read_ranges:
            parts.append(b)
            parts.append(e)
        for b, e in t.write_ranges:
            parts.append(b)
            parts.append(e)
        snaps[i] = t.read_snapshot
    blob, _, offs = keycode._blob(parts)
    return blob, offs, nr, nw, snaps


@dataclasses.dataclass
class WireBatch:
    """A resolve batch in serialized proxy→resolver form — the payload a
    commit proxy ships over the wire (REF:fdbserver/ResolverInterface.h
    ResolveTransactionBatchRequest is likewise a flat serialized arena,
    not an object graph).  One blob holds every range endpoint in txn
    order (per txn: nr read ranges' begin,end then nw write ranges');
    offs are cumulative byte offsets (len nkeys+1).  Both resolver
    backends consume this layout natively, so the measured resolver
    stage starts at the received bytes."""
    blob: bytes
    offs: np.ndarray        # [nkeys+1] int64
    nr: np.ndarray          # [n] int32 read-range counts
    nw: np.ndarray          # [n] int32 write-range counts
    snapshots: np.ndarray   # [n] int64
    count: int


def wire_from_txns(txns: list[TxnRequest]) -> WireBatch:
    """Serialize TxnRequests into the wire layout (what a proxy does as
    it builds the batch)."""
    return WireBatch(*_serialize(txns), len(txns))


def txns_from_wire(w: WireBatch) -> list[TxnRequest]:
    """Deserialize a WireBatch back into TxnRequests (the fallback when a
    backend lacks a native wire path)."""
    out = []
    blob, offs = w.blob, w.offs
    key = 0
    for i in range(w.count):
        rr, wr = [], []
        for dst, cnt in ((rr, int(w.nr[i])), (wr, int(w.nw[i]))):
            for _ in range(cnt):
                dst.append((blob[offs[key]:offs[key + 1]],
                            blob[offs[key + 1]:offs[key + 2]]))
                key += 2
        out.append(TxnRequest(rr, wr, int(w.snapshots[i])))
    return out


@dataclasses.dataclass
class IdBatch:
    """A batch in endpoint-id form (dictionary transfer compression):
    each u32 is a slot in the device-resident lane dictionary; 0 is the
    sentinel slot (padding).  36B/endpoint lane rows become 4B ids."""
    read_begin: np.ndarray   # [B, R] uint32 slot ids
    read_end: np.ndarray
    write_begin: np.ndarray
    write_end: np.ndarray
    read_snapshot: np.ndarray  # [B] int64
    count: int


class DictEncoder:
    """Host mirror of the device lane dictionary (native hash table).

    ``encode(txns)`` returns an IdBatch and appends (slot, lanes) updates
    for endpoints not yet device-resident into the current group's update
    buffers; ``begin_group`` starts a fresh update buffer and group stamp
    (slots referenced since the stamp are never evicted, so every id in a
    group gathers the right lanes on device).  Returns None when a batch
    overflows the update buffer — the caller re-encodes it via the lanes
    path but MUST still ship the partial updates (they are real table
    insertions).  ``take(words)`` hands out the fused path's host buffers
    (the conflict set's pinned, event-fenced ring on a CUDA device); by
    default a ring of plain host buffers.
    """

    _N_FUSED_BUFS = 8

    def __init__(self, slots: int, width: int, max_upd: int,
                 take: Callable[[int], np.ndarray] | None = None) -> None:
        self._lib = keycode._keycodec()
        if width > 1024:
            # the native lane-row stack buffer is sized for this bound
            raise ValueError(f"KEY_ENCODE_BYTES {width} > 1024 unsupported")
        self.slots = slots
        self.width = width
        self.L = keycode.nlanes(width)
        self.max_upd = max_upd
        self._take = self._fused_buf if take is None else take
        self._h = self._lib.kc_dict_new(slots)
        self.upd_slots = np.zeros(max_upd, dtype=np.uint32)
        self.upd_lanes = np.full((self.L, max_upd), 0xFFFFFFFF,
                                 dtype=np.uint32)
        self.n_upd = 0

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.kc_dict_free(self._h)
        except Exception:   # noqa: BLE001 — interpreter teardown
            pass

    def begin_group(self) -> None:
        self._lib.kc_dict_group(self._h)
        # pad slots stay 0 (the sentinel slot) and pad lanes stay SENTINEL,
        # so unused update rows scatter a no-op.  Only the first n_upd
        # entries were written since the last clear: clearing those alone
        # leaves the buffers as a full clear would (at R=8, B=64 the
        # whole of them is ~21 MB)
        n = self.n_upd
        self.upd_slots[:n] = 0
        self.upd_lanes[:, :n] = 0xFFFFFFFF
        self.n_upd = 0

    def _fused_buf(self, words: int) -> np.ndarray:
        bufs = getattr(self, "_fused_bufs", None)
        if bufs is None or bufs[0].size < words:
            bufs = [np.zeros(words, dtype=np.uint32)
                    for _ in range(self._N_FUSED_BUFS)]
            self._fused_bufs = bufs
            self._fused_i = 0
        self._fused_i = (self._fused_i + 1) % self._N_FUSED_BUFS
        return bufs[self._fused_i]

    def encode(self, txns: list[TxnRequest], batch_size: int,
               ranges_per_txn: int) -> IdBatch | None:
        B, R = batch_size, ranges_per_txn
        n = len(txns)
        if n > B:
            raise ValueError(f"batch of {n} exceeds batch_size {B}")
        blob, offs, nr, nw, sn = _serialize(txns, R)
        snap = np.full(B, -1, dtype=np.int64)
        snap[:n] = sn
        rbi = np.empty((B, R), dtype=np.uint32)
        rei = np.empty((B, R), dtype=np.uint32)
        wbi = np.empty((B, R), dtype=np.uint32)
        wei = np.empty((B, R), dtype=np.uint32)
        rc = self._lib.kc_encode_batch_ids(
            self._h, blob, offs, nr, nw, n, B, R, self.width,
            rbi, rei, wbi, wei, self.upd_slots, self.upd_lanes,
            self.max_upd, self.n_upd)
        if rc < 0:
            self.n_upd = -(rc + 1)      # partial updates are still real
            return None
        self.n_upd = int(rc)
        return IdBatch(rbi, rei, wbi, wei, snap, n)

    def encode_group_wire(self, wires: list[WireBatch], batch_size: int,
                          ranges_per_txn: int, k_pad: int):
        """encode_group on already-serialized WireBatches: no Python txn
        walk at all — blob concatenation + one native call.

        Returns (ids, snaps, counts, compact): when every range in the
        group is a point range [k, k+'\\0'), ``compact`` is True and
        ``ids`` holds only the 2-segment [rb | wb] begin ids — the end
        rows are derived on device, halving id transfer."""
        B, R = batch_size, ranges_per_txn
        counts = np.fromiter((w.count for w in wires), np.int32, len(wires))
        # the native walk writes batch k's ids at k*B*R: out-of-bound
        # counts must raise here, not corrupt native heap
        if len(wires) > k_pad or (len(counts) and int(counts.max()) > B):
            raise ValueError(f"{len(wires)} wires of up to {B} txns "
                             f"exceed a group of {k_pad}")
        nr = np.concatenate([w.nr for w in wires])
        nw = np.concatenate([w.nw for w in wires])
        if len(nr) and (int(nr.max()) > R or int(nw.max()) > R):
            raise ValueError(f"wire range count exceeds bucket {R}")
        self.begin_group()
        sizes = [len(w.blob) for w in wires]
        bases = np.zeros(len(wires) + 1, dtype=np.int64)
        np.cumsum(sizes, out=bases[1:])
        offs = np.concatenate(
            [w.offs[:-1] + bases[i] for i, w in enumerate(wires)]
            + [bases[-1:]])
        blob = b"".join(w.blob for w in wires)
        ids = np.zeros(4 * k_pad * B * R, dtype=np.uint32)
        compact_out = np.zeros(1, dtype=np.int64)
        rc = self._lib.kc_encode_group_ids2(
            self._h, blob, offs, nr, nw, counts, len(wires), k_pad, B, R,
            self.width, ids, self.upd_slots, self.upd_lanes, self.max_upd,
            compact_out)
        snaps = np.full((k_pad, B), -1, dtype=np.int64)
        for k, w in enumerate(wires):
            snaps[k, :w.count] = w.snapshots
        if rc < 0:
            self.n_upd = -(rc + 1)
            return None
        self.n_upd = int(rc)
        compact = bool(compact_out[0])
        if compact:
            ids = ids[:2 * k_pad * B * R]
        return ids, snaps, counts, compact

    def encode_group(self, chunks: list[list[TxnRequest]], batch_size: int,
                     ranges_per_txn: int, k_pad: int):
        """encode_group_wire over TxnRequest chunks: serialize each chunk
        (what a proxy does) and take the wire path.  Same return
        contract."""
        return self.encode_group_wire([wire_from_txns(c) for c in chunks],
                                      batch_size, ranges_per_txn, k_pad)

    def encode_group_fused(self, wires: list[WireBatch], batch_size: int,
                           ranges_per_txn: int, k_pad: int,
                           versions: list[int]):
        """ONE native call does all group assembly: walks the K wires'
        buffers in place (no Python concatenation), decides compactness,
        encodes endpoint ids with prefetched hash probes, and writes
        ids + snapshots + commit versions into one fused u32 buffer from
        ``take``.  The caller ships ``fused[:total]`` as a SINGLE copy.

        Returns (fused_view, counts, compact, off_pi, n_upd) or None on
        update-buffer overflow (same contract as encode_group_wire: the
        partial updates are real and must still ship)."""
        import ctypes

        from .conflict_torch import FUSED_UPD_BUCKETS
        K, B, R = len(wires), batch_size, ranges_per_txn
        # the native encoder's buffers assume every wire fits the kernel shape;
        # out-of-bound counts must raise here, not corrupt native heap
        if K > k_pad:
            raise ValueError(f"{K} wires exceed a group of {k_pad}")
        for w in wires:
            if w.count > B:
                raise ValueError(f"wire batch of {w.count} exceeds {B}")
            if len(w.nr) and (int(w.nr.max()) > R or int(w.nw.max()) > R):
                raise ValueError(f"wire range count exceeds bucket {R}")
        self.begin_group()
        # update region sized to the largest SHIPPABLE bucket, not
        # max_upd: overflow past the bucket routes through
        # apply_dict_updates with U=0, so fused never carries more
        u_cap = min(self.max_upd, FUSED_UPD_BUCKETS[-1])
        words = 4 * k_pad * B * R + 2 + 2 * (k_pad * B + k_pad) \
            + u_cap + self.L * u_cap
        fused = self._take(words)
        counts = np.fromiter((w.count for w in wires), np.int32, K)
        vers = np.asarray(versions, dtype=np.int64)
        PtrArr = ctypes.c_void_p * K
        # bytes objects and numpy arrays stay referenced via `wires`/`holds`
        holds = [np.ascontiguousarray(w.offs, dtype=np.int64) for w in wires]
        holds_nr = [np.ascontiguousarray(w.nr, dtype=np.int32) for w in wires]
        holds_nw = [np.ascontiguousarray(w.nw, dtype=np.int32) for w in wires]
        holds_sn = [np.ascontiguousarray(w.snapshots, dtype=np.int64)
                    for w in wires]
        blobs = PtrArr(*(ctypes.cast(ctypes.c_char_p(w.blob), ctypes.c_void_p)
                         for w in wires))
        offs_l = PtrArr(*(a.ctypes.data for a in holds))
        nr_l = PtrArr(*(a.ctypes.data for a in holds_nr))
        nw_l = PtrArr(*(a.ctypes.data for a in holds_nw))
        sn_l = PtrArr(*(a.ctypes.data for a in holds_sn))
        compact_out = np.zeros(1, dtype=np.int64)
        off_pi_out = np.zeros(1, dtype=np.int64)
        rc = self._lib.kc_encode_group_fused(
            self._h, blobs, offs_l, nr_l, nw_l, sn_l, counts, vers,
            K, k_pad, B, R, self.width, fused,
            self.upd_slots, self.upd_lanes, self.max_upd,
            compact_out, off_pi_out)
        del holds, holds_nr, holds_nw, holds_sn
        if rc < 0:
            self.n_upd = -(rc + 1)
            return None
        self.n_upd = int(rc)
        return fused, counts, bool(compact_out[0]), int(off_pi_out[0]), \
            int(rc)

    def pack_updates_into(self, fused: np.ndarray, off_pi: int, k_pad: int,
                          batch_size: int, U: int) -> int:
        """Append the update block after the pi64 region and return the
        total word count to ship.  Slots past n_upd are 0 (sentinel slot)
        with sentinel lanes — a no-op scatter by construction."""
        off_upd = off_pi + 2 * (k_pad * batch_size + k_pad)
        if U:
            fused[off_upd:off_upd + U] = self.upd_slots[:U]
            fused[off_upd + U:off_upd + U + self.L * U].reshape(
                self.L, U)[:] = self.upd_lanes[:, :U]
        return off_upd + U + self.L * U


@dataclasses.dataclass
class EncodedBatch:
    read_begin: np.ndarray   # [B, R, L] uint32
    read_end: np.ndarray
    write_begin: np.ndarray
    write_end: np.ndarray
    read_snapshot: np.ndarray  # [B] int64
    count: int                 # real txn count <= B

    @property
    def shape(self):
        return self.read_begin.shape


def encode_batch(txns: list[TxnRequest], batch_size: int, ranges_per_txn: int,
                 width: int = DEFAULT_WIDTH) -> EncodedBatch:
    """Pack txns into fixed shapes; raises if a txn exceeds ranges_per_txn.

    One walk of the txn list, then one native call fills the four padded
    lane arrays from the key blob (native/keycodec.cpp kc_encode_batch).
    Callers (the commit proxy) split oversized txns across multiple range
    slots by chunking at a higher level, or bump the bucket size; the
    resolver role picks a bucket by knob.
    """
    B, R, L = batch_size, ranges_per_txn, keycode.nlanes(width)
    n = len(txns)
    if n > B:
        raise ValueError(f"batch of {n} exceeds batch_size {B}")
    blob, offs, nr, nw, sn = _serialize(txns, R)
    snap = np.full(B, -1, dtype=np.int64)
    snap[:n] = sn
    rb = np.empty((B, R, L), dtype=np.uint32)
    re = np.empty((B, R, L), dtype=np.uint32)
    wb = np.empty((B, R, L), dtype=np.uint32)
    we = np.empty((B, R, L), dtype=np.uint32)
    keycode._keycodec().kc_encode_batch(blob, offs, nr, nw, n, B, R, width,
                                        rb, re, wb, we)
    return EncodedBatch(rb, re, wb, we, snap, n)


def encode_batch_plain(txns: list[TxnRequest], batch_size: int,
                       ranges_per_txn: int,
                       width: int = DEFAULT_WIDTH) -> EncodedBatch:
    """``encode_batch``'s plain version: gather every key, encode them
    with numpy (``keycode.encode_keys_plain``), scatter into the padded
    arrays."""
    B, R, L = batch_size, ranges_per_txn, keycode.nlanes(width)
    n = len(txns)
    if n > B:
        raise ValueError(f"batch of {n} exceeds batch_size {B}")
    S = keycode.sentinel(width)
    rb = np.tile(S, (B, R, 1))
    re = np.tile(S, (B, R, 1))
    wb = np.tile(S, (B, R, 1))
    we = np.tile(S, (B, R, 1))
    snap = np.full(B, -1, dtype=np.int64)
    keys: list[bytes] = []
    ri, rj, wi, wj = [], [], [], []
    for i, t in enumerate(txns):
        if len(t.read_ranges) > R or len(t.write_ranges) > R:
            raise ValueError(
                f"txn {i} has {len(t.read_ranges)}r/{len(t.write_ranges)}w ranges; bucket is {R}")
        for j, (b, e) in enumerate(t.read_ranges):
            keys.append(b)
            keys.append(e)
            ri.append(i)
            rj.append(j)
        snap[i] = t.read_snapshot
    n_read_keys = len(keys)
    for i, t in enumerate(txns):
        for j, (b, e) in enumerate(t.write_ranges):
            keys.append(b)
            keys.append(e)
            wi.append(i)
            wj.append(j)
    if keys:
        enc = keycode.encode_keys_plain(keys, width)
        renc = enc[:n_read_keys].reshape(-1, 2, L)
        wenc = enc[n_read_keys:].reshape(-1, 2, L)
        if ri:
            rb[ri, rj] = renc[:, 0]
            re[ri, rj] = renc[:, 1]
        if wi:
            wb[wi, wj] = wenc[:, 0]
            we[wi, wj] = wenc[:, 1]
    return EncodedBatch(rb, re, wb, we, snap, len(txns))
