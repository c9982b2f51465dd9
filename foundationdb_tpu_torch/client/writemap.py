"""Per-transaction buffered-write state for read-your-writes.

Reference: REF:fdbclient/WriteMap.h — upstream keeps a PTree of write
entries (sets, clears, atomic-op stacks) merged on the fly with snapshot
data by RYWIterator.  Here: a dict of per-key operation stacks plus a
sorted list of disjoint cleared ranges; merging happens in
transaction.py's read path.

Per-key stack semantics (matching WriteMap's OperationStack):
  ('set', value)            — known value, stack resets
  ('clear',)                — known-missing, stack resets
  ('atomic', op, operand)*  — appended; base may be unknown (needs a
                              snapshot read to fold)
"""

from __future__ import annotations

import bisect

from ..core.data import Mutation, MutationType, apply_atomic, key_after


class WriteMap:
    def __init__(self) -> None:
        self._stacks: dict[bytes, list[tuple]] = {}
        self._clears: list[tuple[bytes, bytes]] = []  # disjoint, sorted
        self.mutations: list[Mutation] = []           # commit order preserved
        self.bytes = 0

    def __bool__(self) -> bool:
        return bool(self.mutations)

    # --- mutation entry points ---

    def set(self, key: bytes, value: bytes) -> None:
        self.mutations.append(Mutation.set(key, value))
        self.bytes += len(key) + len(value)
        self._stacks[key] = [("set", value)]

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self.mutations.append(Mutation.clear_range(begin, end))
        self.bytes += len(begin) + len(end)
        for k in [k for k in self._stacks if begin <= k < end]:
            self._stacks[k] = [("clear",)]
        self._insert_clear(begin, end)

    def atomic(self, op: MutationType, key: bytes, operand: bytes) -> None:
        self.mutations.append(Mutation(op, key, operand))
        self.bytes += len(key) + len(operand)
        stack = self._stacks.get(key)
        if stack is None:
            # a prior clear_range covering the key pins the base to missing
            stack = [("clear",)] if self.range_cleared(key) else []
            self._stacks[key] = stack
        stack.append(("atomic", op, operand))

    def _insert_clear(self, begin: bytes, end: bytes) -> None:
        merged = []
        for b, e in self._clears:
            if e < begin or b > end:
                merged.append((b, e))
            else:
                begin, end = min(begin, b), max(end, e)
        merged.append((begin, end))
        merged.sort()
        self._clears = merged

    # --- read-your-writes queries ---

    def range_cleared(self, key: bytes) -> bool:
        i = bisect.bisect_right(self._clears, (key, b"\xff" * 64)) - 1
        return i >= 0 and self._clears[i][0] <= key < self._clears[i][1]

    def lookup(self, key: bytes) -> tuple[str, object]:
        """('value', v|None) if fully determined by writes;
        ('stack', ops) if atomics need a snapshot base;
        ('none', None) if untouched."""
        stack = self._stacks.get(key)
        if stack is None:
            return ("value", None) if self.range_cleared(key) else ("none", None)
        return self._fold(stack)

    @staticmethod
    def _fold(stack: list[tuple]) -> tuple[str, object]:
        base_known = False
        value: bytes | None = None
        pending: list[tuple] = []
        for op in stack:
            if op[0] == "set":
                base_known, value, pending = True, op[1], []
            elif op[0] == "clear":
                base_known, value, pending = True, None, []
            else:
                pending.append(op)
        if not base_known and pending:
            return ("stack", pending)
        for _, aop, operand in pending:
            value = apply_atomic(aop, value, operand)
        return ("value", value)

    @staticmethod
    def fold_with_base(pending: list[tuple], base: bytes | None) -> bytes | None:
        value = base
        for _, aop, operand in pending:
            value = apply_atomic(aop, value, operand)
        return value

    def written_keys_in(self, begin: bytes, end: bytes) -> list[bytes]:
        return sorted(k for k in self._stacks if begin <= k < end)

    def clears_in(self, begin: bytes, end: bytes) -> list[tuple[bytes, bytes]]:
        return [(max(b, begin), min(e, end)) for b, e in self._clears
                if b < end and e > begin]
