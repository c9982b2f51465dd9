"""mako's transactions (FoundationDB's bindings/c/test/mako): each txn
reads ``reads`` keys and writes ``writes`` keys, every one a point
conflict range [k, k + b'\\x00').  Keys are ``prefix`` + a zero-padded
decimal index, ``key_bytes`` long; the index is Zipf(theta) over
``n_keys`` ranks, scattered across the keyspace by a fixed permutation.

A copy of the port's ``bench/workload.py`` (``ZipfianGenerator`` and
``MakoWorkload``), vectorised: for one seed it draws the same indices in
the same order, so it gives the same keys.
"""

from __future__ import annotations

import numpy as np

from .. import keys


class ZipfianGenerator:
    """Zipf(theta) over [0, n): P(i) ~ 1/(i+1)**theta, by inverse CDF."""

    def __init__(self, n: int, theta: float, seed: int):
        ranks = np.arange(1, n + 1, dtype=np.float64)
        w = 1.0 / np.power(ranks, theta)
        self.cdf = np.cumsum(w)
        self.cdf /= self.cdf[-1]
        self.rng = np.random.Generator(np.random.PCG64(seed))
        # ranks go to keys through a fixed permutation, so the hot keys
        # scatter across the keyspace (mako scrambles too)
        self.perm = np.random.Generator(
            np.random.PCG64(seed ^ 0x5EED)).permutation(n)

    def sample(self, size: int) -> np.ndarray:
        u = self.rng.random(size)
        return self.perm[np.searchsorted(self.cdf, u)]


def generate(schema: dict, n_txns: int, seed: int) -> dict:
    reads, writes = schema["reads"], schema["writes"]
    prefix = schema["key_prefix"].encode()
    per = reads + writes
    zipf = ZipfianGenerator(schema["n_keys"], schema["zipf_theta"], seed)
    idx = zipf.sample(n_txns * per)
    begin = keys.decimal_keys(prefix, idx,
                              schema["key_bytes"] - len(prefix))
    end = keys.with_suffix(begin, 0)
    # wire order: per txn its ranges (reads, then writes), each range's
    # begin then end
    which = np.tile(np.array([0, 1], dtype=np.int64), idx.size)
    row = np.repeat(np.arange(idx.size), 2)
    return {
        "nr": np.full(n_txns, reads, dtype=np.int32),
        "nw": np.full(n_txns, writes, dtype=np.int32),
        "keys": keys.gather([begin, end], which, row),
        "points": True,
    }
