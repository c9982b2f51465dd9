"""mako-style workload generation (REF:bindings/c/test/mako/mako.c).

Keys follow mako's fixed-width scheme (``mako<zero-padded index>``,
32 bytes — exactly the kernel's default encode width, so encoded conflict
detection is *exact* on this workload and abort-rate parity with the CPU
baseline is a hard assertion, not a hope).  Hot-key skew is YCSB-style
zipfian (REF:bindings/c/test/mako/zipf.c).
"""

from __future__ import annotations

import numpy as np

from ..ops.batch import TxnRequest


class ZipfianGenerator:
    """Zipf(theta) over [0, n): P(i) ∝ 1/(i+1)^theta, sampled via inverse CDF."""

    def __init__(self, n: int, theta: float = 0.99, seed: int = 0):
        ranks = np.arange(1, n + 1, dtype=np.float64)
        w = 1.0 / np.power(ranks, theta)
        self.cdf = np.cumsum(w)
        self.cdf /= self.cdf[-1]
        self.rng = np.random.Generator(np.random.PCG64(seed))
        # keys are assigned to ranks via a fixed permutation so hot keys
        # scatter across the keyspace (mako scrambles too)
        self.perm = np.random.Generator(np.random.PCG64(seed ^ 0x5EED)).permutation(n)

    def sample(self, size: int) -> np.ndarray:
        u = self.rng.random(size)
        return self.perm[np.searchsorted(self.cdf, u)]


class MakoWorkload:
    """Generates commit batches for the resolver benchmark.

    50/50 read-write mako mix at the transaction level: each txn carries
    ``reads`` point-read conflict ranges and ``writes`` point-write ranges
    over the zipfian-skewed keyspace.
    """

    def __init__(self, n_keys: int = 1_000_000, theta: float = 0.99,
                 reads: int = 2, writes: int = 2, key_width: int = 32,
                 snapshot_lag_versions: int = 5_000, seed: int = 0):
        self.zipf = ZipfianGenerator(n_keys, theta, seed)
        self.reads = reads
        self.writes = writes
        self.prefix = b"mako"
        self.digits = key_width - len(self.prefix)
        self.lag = snapshot_lag_versions
        self.rng = np.random.Generator(np.random.PCG64(seed ^ 0xBEEF))

    def key(self, i: int) -> bytes:
        return self.prefix + str(i).zfill(self.digits).encode()

    def make_batches(self, n_batches: int, batch_size: int,
                     start_version: int = 1_000_000,
                     versions_per_batch: int = 1000):
        """Returns (batches, commit_versions): batches[i] is a list of
        TxnRequest sharing commit version commit_versions[i]."""
        per_txn = self.reads + self.writes
        idx = self.zipf.sample(n_batches * batch_size * per_txn)
        lags = self.rng.integers(0, self.lag, size=n_batches * batch_size)
        batches = []
        versions = []
        p = 0
        q = 0
        v = start_version
        for _ in range(n_batches):
            v += versions_per_batch
            txns = []
            for _ in range(batch_size):
                rr = []
                for _ in range(self.reads):
                    k = self.key(int(idx[p])); p += 1
                    rr.append((k, k + b"\x00"))
                wr = []
                for _ in range(self.writes):
                    k = self.key(int(idx[p])); p += 1
                    wr.append((k, k + b"\x00"))
                snap = max(0, v - versions_per_batch - int(lags[q])); q += 1
                txns.append(TxnRequest(rr, wr, snap))
            batches.append(txns)
            versions.append(v)
        return batches, versions
