"""ReadWrite throughput workload — the sim perf-smoke + mako substrate.

Reference: REF:fdbserver/workloads/ReadWrite.actor.cpp — configurable
read/write mix over a uniform or zipfian key population, reporting txn
counts and latency percentiles.  Sim numbers are not real perf (virtual
time!); this exists to exercise the pipeline under load shapes and to
back config-1-style regression smoke in CI.
"""

from __future__ import annotations

import asyncio

from .workload import TestWorkload, register_workload


@register_workload
class ReadWriteWorkload(TestWorkload):
    name = "ReadWrite"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.n_keys = int(self.opt("nodeCount", 1000))
        self.txns = int(self.opt("transactionsPerClient", 50))
        self.reads = int(self.opt("readsPerTransaction", 4))
        self.writes = int(self.opt("writesPerTransaction", 4))
        self.value_bytes = int(self.opt("valueBytes", 16))
        self.prefix = bytes(self.opt("prefix", b"rw/"))
        self.total_txns = 0
        self.total_retries = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%010d" % i

    async def setup(self) -> None:
        BATCH = 500
        for start in range(0, self.n_keys, BATCH):
            async def fill(tr, start=start):
                for i in range(start, min(start + BATCH, self.n_keys)):
                    tr.set(self._key(i), b"x" * self.value_bytes)
            await self.db.run(fill)

    async def start(self) -> None:
        for _ in range(self.txns):
            ks = [self.rng.random_int(0, self.n_keys)
                  for _ in range(self.reads + self.writes)]

            async def body(tr):
                for i in ks[:self.reads]:
                    await tr.get(self._key(i))
                for i in ks[self.reads:]:
                    tr.set(self._key(i), b"y" * self.value_bytes)
            await self.db.run(body)
            self.total_txns += 1

    async def check(self) -> bool:
        rows = await self.db.get_range(self.prefix, self.prefix + b"\xff")
        return len(rows) == self.n_keys

    def metrics(self):
        return {"transactions": self.total_txns}
