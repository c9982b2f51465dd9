"""Cycle workload — the canonical lost-write detector.

Reference: REF:fdbserver/workloads/Cycle.actor.cpp — keys form a ring
(key i stores the index of its successor); transactions rotate three
adjacent nodes; the check phase walks the ring and asserts it is still a
single cycle visiting every node exactly once.  Any lost, phantom, or
non-serializable write breaks the permutation.
"""

from __future__ import annotations

import asyncio

from .workload import TestWorkload, register_workload


def _key(prefix: bytes, i: int) -> bytes:
    return prefix + b"%08d" % i


@register_workload
class CycleWorkload(TestWorkload):
    name = "Cycle"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.n = int(self.opt("nodeCount", 16))
        self.txns = int(self.opt("transactionsPerClient", 20))
        self.prefix = bytes(self.opt("prefix", b"cycle/"))
        self.ops_done = 0
        self.retries = 0

    async def setup(self) -> None:
        async def fill(tr):
            for i in range(self.n):
                tr.set(_key(self.prefix, i), b"%08d" % ((i + 1) % self.n))
        await self.db.run(fill)

    async def start(self) -> None:
        for _ in range(self.txns):
            a = self.rng.random_int(0, self.n)
            tr = self.db.create_transaction()
            while True:
                try:
                    ka = _key(self.prefix, a)
                    b = int(await tr.get(ka))
                    kb = _key(self.prefix, b)
                    c = int(await tr.get(kb))
                    kc = _key(self.prefix, c)
                    d = int(await tr.get(kc))
                    # rotate b out: a→c, c→b, b→d  (still one cycle)
                    tr.set(ka, b"%08d" % c)
                    tr.set(kc, b"%08d" % b)
                    tr.set(kb, b"%08d" % d)
                    await tr.commit()
                    break
                except BaseException as e:
                    await tr.on_error(e)   # re-raises if not retryable
                    self.retries += 1
            self.ops_done += 1

    async def check(self) -> bool:
        rows = await self.db.get_range(self.prefix, self.prefix + b"\xff")
        if len(rows) != self.n:
            return False
        succ = {int(k[len(self.prefix):]): int(v) for k, v in rows}
        seen = set()
        cur = 0
        for _ in range(self.n):
            if cur in seen:
                return False
            seen.add(cur)
            cur = succ[cur]
        return cur == 0 and len(seen) == self.n

    def metrics(self):
        return {"transactions": self.ops_done, "retries": self.retries}
