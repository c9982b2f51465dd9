"""ConsistencyCheck + AtomicOps — reusable invariant workloads.

Reference: REF:fdbserver/workloads/ConsistencyCheck.actor.cpp (every
replica of every shard must return identical data at one read version)
and REF:fdbserver/workloads/AtomicOps.actor.cpp (concurrent atomic adds
must sum exactly — lost updates or double-applies shift the total).
"""

from __future__ import annotations

import asyncio
import struct

from ..core.data import MutationType
from ..runtime.trace import TraceEvent
from .workload import TestWorkload, register_workload


@register_workload
class ConsistencyCheckWorkload(TestWorkload):
    """check(): for every shard, read the full range from EACH replica at
    one read version and require bit-identical results."""

    name = "ConsistencyCheck"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.shards_checked = 0
        self.rows_checked = 0

    async def check(self) -> bool:
        if self.ctx.client_id != 0:
            return True
        from ..runtime.errors import FdbError
        last: Exception | None = None
        for _ in range(5):
            try:
                return await self._check_once()
            except FdbError as e:
                # the view can be stale after live moves / engine
                # migration (same epoch, seq bump): the retired source
                # roles answer endpoint_not_found to the raw replica
                # reads — refresh the view and retry
                last = e
                refresh = getattr(self.db, "refresh", None)
                if refresh is not None:
                    await refresh()
                await asyncio.sleep(0.25)
        raise last  # type: ignore[misc]

    async def _check_once(self) -> bool:
        tr = self.db.create_transaction()
        while True:
            try:
                version = await tr.get_read_version()
                break
            except Exception as e:  # noqa: BLE001 — retryable path
                await tr.on_error(e)
        cluster = getattr(self.db, "view", None) or self.db.cluster
        shard_map = cluster.shard_map
        ok = True
        for rng, _tags in shard_map.ranges():
            group = cluster.storage_for_key(rng.begin)
            replicas = getattr(group, "replicas", [group])
            results = []
            for rep in replicas:
                rows = []
                b = rng.begin
                while True:
                    kvs, more = await rep.get_key_values(
                        b, rng.end, version, 1000)
                    rows.extend((bytes(k), bytes(v)) for k, v in kvs)
                    if not more or not kvs:
                        break
                    b = bytes(kvs[-1][0]) + b"\x00"
                results.append(rows)
            for other in results[1:]:
                if other != results[0]:
                    TraceEvent("ConsistencyCheckFailed", severity=40) \
                        .detail("Begin", rng.begin).log()
                    ok = False
            self.shards_checked += 1
            self.rows_checked += len(results[0]) if results else 0
        return ok

    def metrics(self):
        return {"shards_checked": self.shards_checked,
                "rows_checked": self.rows_checked}


@register_workload
class AtomicOpsWorkload(TestWorkload):
    """Concurrent little-endian ADDs to shared counters; check() sums the
    per-client intents against the stored totals."""

    name = "AtomicOps"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.counters = int(self.opt("counters", 4))
        self.adds = int(self.opt("addsPerClient", 20))
        self.added: dict[int, int] = {}

    def _key(self, i: int) -> bytes:
        return b"atomic/%02d" % i

    def _intent_key(self) -> bytes:
        return b"atomic-intent/%02d" % self.ctx.client_id

    async def start(self) -> None:
        total_by_counter = {i: 0 for i in range(self.counters)}
        for _ in range(self.adds):
            i = int(self.rng.random_int(0, self.counters))
            n = int(self.rng.random_int(1, 10))

            async def do(tr, i=i, n=n):
                # the intent ledger rides the SAME transaction as the add,
                # so a maybe-committed retry can't double-count intents
                tr.add(self._key(i), struct.pack("<q", n))
                tr.add(self._intent_key(), struct.pack("<q", n))
            await self.db.run(do)
            total_by_counter[i] += n
        self.added = total_by_counter

    async def check(self) -> bool:
        if self.ctx.client_id != 0:
            return True
        async def read(tr):
            stored = 0
            for i in range(self.counters):
                v = await tr.get(self._key(i))
                stored += struct.unpack("<q", v)[0] if v else 0
            intents = 0
            rows = await tr.get_range(b"atomic-intent/", b"atomic-intent0",
                                      limit=0)
            for _k, v in rows:
                intents += struct.unpack("<q", v)[0]
            return stored, intents
        stored, intents = await self.db.run(read)
        if stored != intents:
            TraceEvent("AtomicOpsMismatch", severity=40) \
                .detail("Stored", stored).detail("Intents", intents).log()
        return stored == intents

    def metrics(self):
        return {"adds": float(self.adds)}
