"""Serializability-oracle workload — commit-order replay equality.

Reference: the idea of REF:fdbserver/workloads/ConflictRange.actor.cpp and
SerializabilityWorkload — random concurrent transactions whose *committed*
effects, replayed sequentially in commit order against a brute-force model,
must reproduce the exact final database state.  Catches: writes surviving
an abort verdict, lost committed writes, wrong commit ordering, RYW
leaking uncommitted state.

Tie-break within a commit version uses the versionstamp's batch-order
field — the same total order the proxy applied mutations in.
"""

from __future__ import annotations

import asyncio

from ..core.data import MutationType, apply_atomic
from ..runtime.errors import FdbError
from .workload import TestWorkload, register_workload


@register_workload
class SerializabilityWorkload(TestWorkload):
    name = "Serializability"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.n_keys = int(self.opt("keyCount", 32))
        self.txns = int(self.opt("transactionsPerClient", 25))
        self.prefix = bytes(self.opt("prefix", b"ser/"))
        # shared across clients via options dict (tester merges metrics,
        # but the committed-op log must be global)
        self.log = self.ctx.options.setdefault("_committed_log", [])
        self.committed = 0
        self.aborted = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%06d" % i

    async def start(self) -> None:
        for _ in range(self.txns):
            ops = self._random_ops()
            tr = self.db.create_transaction()
            while True:
                try:
                    for op in ops:
                        kind = op[0]
                        if kind == "get":
                            await tr.get(op[1])
                        elif kind == "range":
                            await tr.get_range(op[1], op[2], limit=10)
                        elif kind == "set":
                            tr.set(op[1], op[2])
                        elif kind == "clear":
                            tr.clear_range(op[1], op[2])
                        elif kind == "atomic":
                            tr.atomic_op(op[1], op[2], op[3])
                    await tr.commit()
                    if any(op[0] in ("set", "clear", "atomic") for op in ops):
                        # read-only txns have no versionstamp and no effects
                        self.log.append((tr.get_versionstamp(), ops))
                    self.committed += 1
                    break
                except FdbError as e:
                    if e.code == 1020:   # not_committed: abort, don't retry
                        self.aborted += 1
                        break
                    await tr.on_error(e)

    def _random_ops(self):
        ops = []
        for _ in range(self.rng.random_int(1, 6)):
            r = self.rng.random()
            k = self._key(self.rng.random_int(0, self.n_keys))
            if r < 0.25:
                ops.append(("get", k))
            elif r < 0.35:
                k2 = self._key(self.rng.random_int(0, self.n_keys))
                ops.append(("range", min(k, k2), max(k, k2) + b"\x00"))
            elif r < 0.70:
                ops.append(("set", k, b"v%d" % self.rng.random_int(0, 1 << 30)))
            elif r < 0.80:
                k2 = self._key(self.rng.random_int(0, self.n_keys))
                ops.append(("clear", min(k, k2), max(k, k2) + b"\x00"))
            else:
                ops.append(("atomic", MutationType.ADD, k,
                            self.rng.random_int(1, 100).to_bytes(8, "little")))
        return ops

    async def check(self) -> bool:
        # replay committed txns in (version, batch-order) order
        model: dict[bytes, bytes] = {}
        for _stamp, ops in sorted(self.log, key=lambda e: e[0]):
            for op in ops:
                if op[0] == "set":
                    model[op[1]] = op[2]
                elif op[0] == "clear":
                    for k in [k for k in model if op[1] <= k < op[2]]:
                        del model[k]
                elif op[0] == "atomic":
                    new = apply_atomic(op[1], model.get(op[2]), op[3])
                    if new is None:
                        model.pop(op[2], None)
                    else:
                        model[op[2]] = new
        actual = dict(await self.db.get_range(self.prefix, self.prefix + b"\xff"))
        return actual == model

    def metrics(self):
        return {"committed": self.committed, "aborted": self.aborted}
