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

    Callers (the commit proxy) split oversized txns across multiple range
    slots by chunking at a higher level, or bump the bucket size; the
    resolver role picks a bucket by knob.
    """
    B, R, L = batch_size, ranges_per_txn, keycode.nlanes(width)
    n = len(txns)
    if n > B:
        raise ValueError(f"batch of {n} exceeds batch_size {B}")
    # gather every key, bulk-encode, scatter into the padded arrays
    # (per-key encode_key calls measured ~2.3ms/batch)
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
        enc = keycode.encode_keys(keys, width)
        renc = enc[:n_read_keys].reshape(-1, 2, L)
        wenc = enc[n_read_keys:].reshape(-1, 2, L)
        if ri:
            rb[ri, rj] = renc[:, 0]
            re[ri, rj] = renc[:, 1]
        if wi:
            wb[wi, wj] = wenc[:, 0]
            we[wi, wj] = wenc[:, 1]
    return EncodedBatch(rb, re, wb, we, snap, len(txns))
