"""Abort-parity gate: encoded-backend abort rates vs the exact baseline.

Reference: BASELINE.md calls abort-rate parity "a correctness gate, not
just a perf one".  The encoded (numpy/cuda) conflict backends are
*conservative by design* in two places — key encoding (fixed-width lane
prefixes) and range coalescing (txns with more than R ranges get
adjacent ranges merged) — so they may abort transactions the exact C++
interval-map baseline would commit.  This harness measures HOW MUCH, on
a range-heavy workload built to stress exactly those paths:

- identical batches (same seed, same commit versions) run through the
  exact backend and the encoded backend, each self-consistent; the
  aggregate abort rates are compared between the two executions;
- EVERY encoded verdict is then audited by a *shadow replay*: a fresh
  exact interval map is fed exactly the writes the ENCODED execution
  committed (in order), and each transaction's reads are checked
  against it at its own snapshot.  Unlike a first-divergence prefix
  comparison, the audit stays valid past any divergence — the shadow
  mirrors the encoded history, not the exact backend's;
- an encoded-COMMITTED verdict whose reads conflict with the encoded
  execution's own committed history is a SAFETY violation (the
  encoded execution would be non-serializable);
- an encoded abort the shadow would have committed is a *widening
  abort*, attributed to the fat-txn path (the txn had > R ranges) or
  to key encoding (it did not).

The gate: aggregate abort-rate delta relative to exact stays under
``max_rel_delta`` and the audit shows zero safety violations.
"""

from __future__ import annotations

import numpy as np

from ..ops.batch import COMMITTED, CONFLICT, TOO_OLD, TxnRequest
from ..runtime.knobs import Knobs


def parity_knobs(**overrides) -> Knobs:
    """THE gate configuration — the CLI, the tests and chip_smoke.py all
    measure this one shape (drift between them would silently gate
    different things)."""
    base = dict(RESOLVER_BATCH_TXNS=24, RESOLVER_RANGES_PER_TXN=8,
                CONFLICT_RING_CAPACITY=1 << 13, KEY_ENCODE_BYTES=32)
    base.update(overrides)
    return Knobs().override(**base)


class RangeHeavyWorkload:
    """TPC-C-shaped conflict traffic: point ops + contiguous range reads,
    with a configurable fraction of FAT transactions carrying more
    ranges than the kernel bucket R (forcing coalescing)."""

    def __init__(self, n_keys: int = 100_000, fat_fraction: float = 0.25,
                 fat_ranges: int = 12, seed: int = 0):
        self.n_keys = n_keys
        self.fat_fraction = fat_fraction
        self.fat_ranges = fat_ranges
        self.rng = np.random.Generator(np.random.PCG64(seed))

    def key(self, i: int) -> bytes:
        return b"rh" + str(int(i)).zfill(10).encode()

    def _span(self) -> tuple[bytes, bytes]:
        a = int(self.rng.integers(0, self.n_keys))
        w = int(self.rng.integers(1, 40))
        return self.key(a), self.key(min(a + w, self.n_keys))

    def make_batches(self, n_batches: int, batch_size: int,
                     start_version: int = 1_000_000,
                     versions_per_batch: int = 1000):
        batches, versions = [], []
        v = start_version
        for _ in range(n_batches):
            txns = []
            for _ in range(batch_size):
                fat = self.rng.random() < self.fat_fraction
                n_read = self.fat_ranges if fat else \
                    int(self.rng.integers(1, 4))
                reads = [self._span() for _ in range(n_read)]
                writes = [self._span()
                          for _ in range(int(self.rng.integers(1, 3)))]
                lag = int(self.rng.integers(0, 3)) * versions_per_batch
                txns.append(TxnRequest(reads, writes, max(0, v - lag)))
            batches.append(txns)
            versions.append(v)
            v += versions_per_batch
        return batches, versions


def run_parity(knobs: Knobs, encoded_kind: str = "numpy",
               n_batches: int = 60, batch_size: int = 32,
               seed: int = 7, device=None) -> dict:
    """Run the range-heavy workload through exact + encoded backends and
    classify the divergence.  Returns the gate report dict."""
    from ..ops.backends import make_conflict_backend
    wl = RangeHeavyWorkload(seed=seed)
    # warmup batches at lower versions: the encoded backend's exact
    # sidecar is born on the first fat txn and only trusted for
    # snapshots past its birth — production resolvers run warm, so the
    # measured window must too (cold-start coalescing is a harness
    # artifact, not steady-state behavior)
    warm, warm_vs = wl.make_batches(4, batch_size, start_version=900_000)
    batches, versions = wl.make_batches(n_batches, batch_size)
    R = knobs.RESOLVER_RANGES_PER_TXN

    # the exact baseline is always "cpp"; an encoded_kind of "cpp" would
    # run it twice and double-append warm rows into the shadow audit
    assert encoded_kind != "cpp", "encoded_kind must be an encoded backend"
    verdicts = {}
    enc_warm_verdicts: list[list[int]] = []
    for kind in ("cpp", encoded_kind):
        backend = make_conflict_backend(
            knobs.override(RESOLVER_CONFLICT_BACKEND=kind),
            device=device if kind != "cpp" else None)
        for txns, v in zip(warm, warm_vs):
            row = list(backend.resolve(txns, v))
            if kind == encoded_kind:
                # only the encoded execution's warm verdicts feed the
                # shadow audit; the exact backend's warmup just seeds
                # its own history
                enc_warm_verdicts.append(row)
        out = []
        for txns, v in zip(batches, versions):
            out.append(list(backend.resolve(txns, v)))
        verdicts[kind] = out

    exact, enc = verdicts["cpp"], verdicts[encoded_kind]
    counts = {"exact": {"committed": 0, "conflict": 0, "too_old": 0},
              "encoded": {"committed": 0, "conflict": 0, "too_old": 0}}
    names = {COMMITTED: "committed", CONFLICT: "conflict",
             TOO_OLD: "too_old"}
    for out, key in ((exact, "exact"), (enc, "encoded")):
        for batch in out:
            for code in batch:
                counts[key][names[code]] += 1

    # Shadow replay: audit EVERY encoded verdict, not a first-divergence
    # prefix (a prefix comparison goes blind after the first benign
    # widening abort — an unsafe verdict behind it would never be
    # counted).  A fresh exact interval map is fed exactly the writes
    # the ENCODED execution committed, in order; each txn's reads are
    # checked against it at the txn's own snapshot, so the audit is
    # valid for the whole run — the shadow mirrors the encoded history.
    from ..ops.conflict_cpp import CppConflictSet
    shadow = CppConflictSet()       # oldest stays 0: the audit never TooOlds
    widening_coalesce = widening_encoding = widening_too_old = 0
    safety_violations = 0
    audited = 0

    def replay(txns, v, verdict_row, count: bool) -> None:
        nonlocal widening_coalesce, widening_encoding, widening_too_old, \
            safety_violations, audited
        for t, n in zip(txns, verdict_row):
            [chk] = shadow.resolve_batch(
                [TxnRequest(t.read_ranges, [], t.read_snapshot)], v)
            if n == COMMITTED:
                if count and chk == CONFLICT:
                    safety_violations += 1
                shadow.resolve_batch([TxnRequest([], t.write_ranges, v)], v)
            elif count and chk == COMMITTED:
                fat = len(t.read_ranges) > R or len(t.write_ranges) > R
                if n == TOO_OLD:
                    widening_too_old += 1
                elif fat:
                    widening_coalesce += 1
                else:
                    widening_encoding += 1
            if count:
                audited += 1

    # warmup feeds the shadow's history but is not scored (the encoded
    # backend's sidecar is also born during warmup — same window)
    for (txns, v), row in zip(zip(warm, warm_vs), enc_warm_verdicts):
        replay(txns, v, row, count=False)
    for (txns, v), row in zip(zip(batches, versions), enc):
        replay(txns, v, row, count=True)

    total = n_batches * batch_size
    exact_aborts = total - counts["exact"]["committed"]
    enc_aborts = total - counts["encoded"]["committed"]
    rel = (enc_aborts - exact_aborts) / max(1, exact_aborts)
    return {
        "txns": total,
        "ranges_bucket_R": R,
        "abort_rate_exact": round(exact_aborts / total, 4),
        "abort_rate_encoded": round(enc_aborts / total, 4),
        "abort_rel_delta": round(rel, 4),
        "verdict_counts": counts,
        "txns_audited": audited,
        "widening_aborts_coalescing": widening_coalesce,
        "widening_aborts_encoding": widening_encoding,
        "widening_aborts_too_old": widening_too_old,
        "safety_violations": safety_violations,
    }


def main() -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--ranges-per-txn", type=int, default=8)
    ap.add_argument("--kind", default="numpy", choices=("numpy", "cuda"))
    ap.add_argument("--device", default=None,
                    help="torch device of the cuda kind (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    knobs = parity_knobs(RESOLVER_BATCH_TXNS=args.batch_size,
                         RESOLVER_RANGES_PER_TXN=args.ranges_per_txn)
    device = None
    if args.device is not None:
        import torch
        device = torch.device(args.device)
    report = run_parity(knobs, args.kind, args.batches, args.batch_size,
                        args.seed, device=device)
    print(json.dumps(report))
    return 1 if report["safety_violations"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
