"""TPC-C's New-Order transaction (TPC-C Standard Specification v5.11,
clause 2.4) as the conflict ranges a resolver receives.

Each txn draws its home warehouse and district uniformly, the customer
by NURand(1023, 1, customers), 5 to 15 order lines with items by
NURand(8191, 1, items), and a remote supplying warehouse on
``remote_line_share`` of the lines (clause 2.4.1).  The district's
next order id is the contention point: every New-Order reads and writes
its district row.  The order id is the district's count of New-Orders
so far in the stream, from 3001 (clause 4.3.3.1 loads 3000 orders a
district).  Keys are tuple-packed as the port's ``bench/tpcc.py::_k``
packs them.

Conflict ranges of one New-Order:
  reads   warehouse, district, customer, each distinct stock row
  writes  district, order, new-order, the order's lines as one span
          [pack(line prefix) + 00, pack(line prefix) + ff), and each
          distinct stock row
Items are read at snapshot (no TPC-C transaction writes ITEM), so they
carry no conflict range.  Every range but the lines' span is a point
range [k, k + 00).
"""

from __future__ import annotations

import numpy as np

from .. import keys

MAX_LINES = 15


def _nurand(rng, a: int, x: int, y: int, c: int, size):
    """NURand(A, x, y) of clause 2.1.6 with the run constant ``c``."""
    return ((rng.integers(0, a + 1, size) | rng.integers(x, y + 1, size))
            + c) % (y - x + 1) + x


def _order_ids(district: np.ndarray, first: int) -> np.ndarray:
    """Each txn's rank among the earlier txns of its district, + first."""
    order = np.argsort(district, kind="stable")
    ranked = district[order]
    starts = np.flatnonzero(np.r_[True, ranked[1:] != ranked[:-1]])
    run = np.arange(ranked.size) - np.repeat(starts, np.diff(
        np.r_[starts, ranked.size]))
    out = np.empty_like(district)
    out[order] = run
    return out + first


def generate(schema: dict, n_txns: int, seed: int) -> dict:
    n = n_txns
    W = schema["warehouses"]
    D = schema["districts_per_warehouse"]
    C = schema["customers_per_district"]
    I = schema["items"]
    lo, hi = schema["order_lines"]
    rng = np.random.Generator(np.random.PCG64(seed))
    c_cust = int(rng.integers(0, 1024))
    c_item = int(rng.integers(0, 8192))
    w = rng.integers(1, W + 1, n)
    d = rng.integers(1, D + 1, n)
    c = _nurand(rng, 1023, 1, C, c_cust, n)
    nl = rng.integers(lo, hi + 1, n)
    items = _nurand(rng, 8191, 1, I, c_item, (n, MAX_LINES))
    remote = rng.random((n, MAX_LINES)) < schema["remote_line_share"]
    if W > 1:
        other = rng.integers(1, W, (n, MAX_LINES))
        other += other >= w[:, None]
        sw = np.where(remote, other, w[:, None])
    else:
        sw = np.broadcast_to(w[:, None], (n, MAX_LINES))
    o = _order_ids((w - 1) * D + (d - 1), schema["first_order_id"])

    # each txn's distinct stock rows (supplying warehouse, item), sorted
    big = np.iinfo(np.int64).max
    live = np.arange(MAX_LINES)[None, :] < nl[:, None]
    code = np.where(live, sw * (1 << 24) + items, big)
    code.sort(axis=1)
    dup = np.zeros_like(live)
    dup[:, 1:] = code[:, 1:] == code[:, :-1]
    code[dup] = big
    code.sort(axis=1)
    has = code != big
    ns = has.sum(axis=1)
    flat = code[has]
    stock = keys.tuple_keys("stock", flat >> 24, flat & ((1 << 24) - 1))
    srow = np.full((n, MAX_LINES), -1, dtype=np.int64)
    srow[has] = np.arange(flat.size)

    line = keys.tuple_keys("orderline", w, d, o)
    sets = [keys.tuple_keys("wh", w), keys.tuple_keys("dist", w, d),
            keys.tuple_keys("cust", w, d, c), keys.tuple_keys("order", w, d, o),
            keys.tuple_keys("neworder", w, d, o), stock]
    sets = [s for k in sets for s in (k, keys.with_suffix(k, 0))]
    WH, DIST, CUST, ORDER, NEWORDER, STOCK = 0, 2, 4, 6, 8, 10
    sets += [keys.with_suffix(line, 0x00), keys.with_suffix(line, 0xFF)]
    LINES = 12

    # the wire order of one txn's endpoints: reads then writes, each
    # range's begin then end; stock slots past ns are dropped
    t = np.arange(n)
    cols = []      # (set index, row per txn [n], valid per txn [n])
    everyone = np.ones(n, dtype=bool)

    def point(s, rows, valid=everyone):
        cols.append((s, rows, valid))
        cols.append((s + 1, rows, valid))

    for s in (WH, DIST, CUST):
        point(s, t)
    for k in range(MAX_LINES):
        point(STOCK, srow[:, k], has[:, k])
    for s in (DIST, ORDER, NEWORDER):
        point(s, t)
    cols.append((LINES, t, everyone))
    cols.append((LINES + 1, t, everyone))
    for k in range(MAX_LINES):
        point(STOCK, srow[:, k], has[:, k])
    which = np.stack([np.full(n, s) for s, _, _ in cols], axis=1)
    row = np.stack([r for _, r, _ in cols], axis=1)
    valid = np.stack([v for _, _, v in cols], axis=1)
    return {
        "nr": (3 + ns).astype(np.int32),
        "nw": (4 + ns).astype(np.int32),
        "keys": keys.gather(sets, which[valid], row[valid]),
        "points": False,
    }
