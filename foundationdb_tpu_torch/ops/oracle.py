"""Brute-force conflict oracle over true byte strings — the ground truth.

Reimplements the *semantics* of the reference's ConflictSet
(REF:fdbserver/SkipList.cpp ConflictBatch::detectConflicts +
checkReadConflictRanges + checkIntraBatchConflicts) in the most obvious
possible way, the same role the ConflictRange workload's brute-force model
plays in the reference's simulation tests
(REF:fdbserver/workloads/ConflictRange.actor.cpp):

- a transaction is TOO_OLD if its read snapshot is older than
  oldest_version;
- it CONFLICTs if any of its read ranges overlaps a write recorded at a
  version newer than its read snapshot — including writes of
  earlier-in-batch transactions that committed (they commit at this
  batch's version, which is newer than any snapshot);
- otherwise it is COMMITTED and its write ranges are recorded at the
  batch's commit version.

Unbounded memory, O(everything) time: for tests only.
"""

from __future__ import annotations

from .batch import COMMITTED, CONFLICT, TOO_OLD, TxnRequest


def _overlaps(a: tuple[bytes, bytes], b: tuple[bytes, bytes]) -> bool:
    return a[0] < b[1] and b[0] < a[1]


class OracleConflictSet:
    def __init__(self, oldest_version: int = 0):
        self.history: list[tuple[bytes, bytes, int]] = []  # (begin, end, version)
        self.oldest_version = oldest_version

    def set_oldest_version(self, v: int) -> None:
        self.oldest_version = max(self.oldest_version, v)
        self.history = [h for h in self.history if h[2] > self.oldest_version]

    def resolve_batch(self, txns: list[TxnRequest], commit_version: int) -> list[int]:
        verdicts: list[int] = []
        committed_writes: list[tuple[bytes, bytes]] = []
        for t in txns:
            if t.read_snapshot < self.oldest_version:
                verdicts.append(TOO_OLD)
                continue
            conflict = False
            for r in t.read_ranges:
                if conflict:
                    break
                for (b, e, v) in self.history:
                    if v > t.read_snapshot and _overlaps(r, (b, e)):
                        conflict = True
                        break
                if not conflict:
                    for w in committed_writes:
                        if _overlaps(r, w):
                            conflict = True
                            break
            if conflict:
                verdicts.append(CONFLICT)
            else:
                verdicts.append(COMMITTED)
                committed_writes.extend(t.write_ranges)
        for (b, e) in committed_writes:
            self.history.append((b, e, commit_version))
        return verdicts

    # uniform backend interface (ops/backends.py)
    resolve = resolve_batch
