"""The plain reference: an exact conflict check, in NumPy, over the same
generated transactions the program resolves.

FoundationDB's semantics (fdbserver/SkipList.cpp, ``ConflictBatch``),
batch by batch in commit order, each batch's txns in their order:

- a txn with read ranges whose snapshot is older than the conflict
  set's oldest version is TOO_OLD; the oldest version is the previous
  batch's commit version less ``mvcc_window`` (FoundationDB's
  MAX_WRITE_TRANSACTION_LIFE_VERSIONS), 0 for the first batch;
- otherwise it is a CONFLICT when one of its read ranges overlaps a
  write range that an earlier batch committed at a version above its
  snapshot, or a write range of an earlier txn of its own batch that
  committed;
- otherwise it is COMMITTED, and its write ranges enter the history at
  the batch's commit version.

Keys are compared as byte strings.  Every endpoint of the stream is
replaced by its rank among them all, which keeps their order, so two
ranges overlap exactly when they share a rank cell [r, r + 1).  This
module imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

COMMITTED, CONFLICT, TOO_OLD = 0, 1, 2


def endpoint_ranks(mat: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, int]:
    """(rank [E] int64, number of distinct endpoints): the keys' places
    in byte-string order.  Zero padding then the length compares as the
    keys do (a key that is a prefix of another sorts first)."""
    E, W = mat.shape
    if int(lens.max(initial=0)) > 255:
        raise ValueError("endpoints longer than 255 bytes")
    nwords = (W + 1 + 7) // 8
    rows = np.zeros((E, nwords * 8), dtype=np.uint8)
    rows[:, :W] = mat
    rows[:, -1] = lens
    # big-endian words compare as the bytes do
    words = rows.view(">u8").astype(np.uint64)
    order = np.lexsort(words.T[::-1])
    sw = words[order]
    new = np.ones(E, dtype=bool)
    new[1:] = (sw[1:] != sw[:-1]).any(axis=1)
    rank = np.empty(E, dtype=np.int64)
    rank[order] = np.cumsum(new) - 1
    return rank, int(new.sum())


def _cells(begin: np.ndarray, end: np.ndarray, owner: np.ndarray):
    """The rank cells each range [begin, end) covers, with its owner."""
    cnt = np.maximum(0, end - begin)
    own = np.repeat(owner, cnt)
    start = np.repeat(begin, cnt)
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    return own, start + (np.arange(cnt.sum()) - first)


def resolve(versions: np.ndarray, snapshots: np.ndarray, nr: np.ndarray,
            nw: np.ndarray, ranks: np.ndarray, n_ranks: int,
            mvcc_window: int) -> np.ndarray:
    """Verdicts [N, B] int8 of N batches of B txns (B <= 64).
    ``ranks`` holds each range's begin and end rank in wire order (per
    txn: its nr read ranges, then its nw write ranges)."""
    N, B = snapshots.shape
    if B > 64:
        raise ValueError("batches of more than 64 txns")
    n_txn = N * B
    nr = nr.reshape(-1).astype(np.int64)
    nw = nw.reshape(-1).astype(np.int64)
    per = nr + nw
    owner = np.repeat(np.arange(n_txn), per)
    pos = np.arange(owner.size) - np.repeat(np.cumsum(per) - per, per)
    is_read = pos < nr[owner]
    begin, end = ranks[0::2], ranks[1::2]
    r_txn, r_cell = _cells(begin[is_read], end[is_read], owner[is_read])
    w_txn, w_cell = _cells(begin[~is_read], end[~is_read], owner[~is_read])

    # intra-batch: reader i and an earlier writer j of its batch share a
    # cell -> bit j of mask[i]
    mask = np.zeros(n_txn, dtype=np.uint64)
    wkey = (w_txn // B) * n_ranks + w_cell
    order = np.argsort(wkey, kind="stable")
    skey = wkey[order]
    rkey = (r_txn // B) * n_ranks + r_cell
    lo = np.searchsorted(skey, rkey, side="left")
    hi = np.searchsorted(skey, rkey, side="right")
    cnt = hi - lo
    reader = np.repeat(r_txn, cnt)
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    writer = w_txn[order[np.repeat(lo, cnt) + (np.arange(cnt.sum())
                                                 - first)]]
    keep = writer < reader
    np.bitwise_or.at(mask, reader[keep],
                     np.left_shift(np.uint64(1),
                                   (writer[keep] % B).astype(np.uint64)))

    r_at = np.searchsorted(r_txn, np.arange(0, n_txn + 1, B))
    w_at = np.searchsorted(w_txn, np.arange(0, n_txn + 1, B))
    last = np.full(n_ranks, -1, dtype=np.int64)   # newest committed write
    out = np.empty((N, B), dtype=np.int8)
    has_reads = (nr > 0).reshape(N, B)
    lanes = np.left_shift(np.uint64(1), np.arange(B, dtype=np.uint64))
    for j in range(N):
        snap = snapshots[j]
        oldest = max(0, int(versions[j - 1]) - mvcc_window) if j else 0
        too_old = has_reads[j] & (snap < oldest)
        rt = r_txn[r_at[j]:r_at[j + 1]] - j * B
        rc = r_cell[r_at[j]:r_at[j + 1]]
        hist = np.zeros(B, dtype=bool)
        hist[rt[last[rc] > snap[rt]]] = True
        committed = ~too_old & ~hist
        m = mask[j * B:(j + 1) * B]
        bits = int(lanes[committed].sum())
        for i in np.flatnonzero((m != 0) & committed):
            if int(m[i]) & bits:
                committed[i] = False
                bits &= ~(1 << int(i))
        out[j] = np.where(too_old, TOO_OLD,
                          np.where(committed, COMMITTED, CONFLICT))
        wt = w_txn[w_at[j]:w_at[j + 1]] - j * B
        wc = w_cell[w_at[j]:w_at[j + 1]]
        last[wc[committed[wt]]] = versions[j]
    return out


def resolve_stream(stream, mvcc_window: int) -> np.ndarray:
    """``resolve`` over a ``kvbench.stream.Stream`` (one pass, from a
    fresh history)."""
    ranks, n = endpoint_ranks(stream.mat, stream.lens)
    return resolve(stream.versions, stream.snapshots, stream.nr, stream.nw,
                   ranks, n, mvcc_window)
