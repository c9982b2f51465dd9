"""Increment + VersionStamp workloads — atomic-op and ordering checks.

Reference: REF:fdbserver/workloads/Increment.actor.cpp (every atomic
add lands exactly once across faults) and
REF:fdbserver/workloads/VersionStamp.actor.cpp (versionstamped keys
embed the true commit version/order, so their sort order IS the commit
order).
"""

from __future__ import annotations

from ..runtime.errors import FdbError
from .workload import TestWorkload, register_workload


@register_workload
class IncrementWorkload(TestWorkload):
    """Each client atomically adds 1 to a shared counter N times through
    the retry loop; commit_unknown_result makes exactly-once accounting
    subtle, so the workload tracks a per-client ledger key in the SAME
    transaction — at check time counter == sum of ledgers, proving no
    add was lost or double-applied relative to its ledger entry."""

    name = "Increment"
    KEY = b"incr/counter"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.n = int(self.opt("incrementsPerClient", 20))

    def _ledger(self, cid: int) -> bytes:
        return b"incr/ledger/%d" % cid

    async def start(self) -> None:
        cid = self.ctx.client_id
        for i in range(self.n):
            async def bump(tr, i=i):
                tr.add(self.KEY, (1).to_bytes(8, "little"))
                tr.add(self._ledger(cid), (1).to_bytes(8, "little"))
            await self.db.run(bump)

    async def check(self) -> bool:
        if self.ctx.client_id != 0:
            return True
        tr = self.db.create_transaction()
        while True:
            try:
                total = await tr.get(self.KEY)
                ledgers = await tr.get_range(b"incr/ledger/",
                                             b"incr/ledger0", limit=0)
                break
            except FdbError as e:
                await tr.on_error(e)
        got = int.from_bytes(total or b"\x00" * 8, "little")
        ledger_sum = sum(int.from_bytes(bytes(v), "little")
                         for _, v in ledgers)
        assert got == ledger_sum, (
            f"counter {got} != ledger sum {ledger_sum} — an atomic add "
            f"was lost or double-applied relative to its own transaction")
        return True

    def metrics(self):
        return {"increments": self.n}


@register_workload
class VersionStampWorkload(TestWorkload):
    """Versionstamped keys embed (commit version, batch order): after
    the run, the stamps' byte order must agree with the value sequence
    each client observed committing — commit order IS key order."""

    name = "VersionStamp"
    PREFIX = b"vs/"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.n = int(self.opt("stampsPerClient", 15))
        self.shared = ctx.options.setdefault("_vs_pool", {"committed": []})
        self.local_stamped = 0

    async def start(self) -> None:
        cid = self.ctx.client_id
        for i in range(self.n):
            tr = self.db.create_transaction()
            while True:
                try:
                    key = (self.PREFIX + b"\x00" * 10
                           + len(self.PREFIX).to_bytes(4, "little"))
                    tr.set_versionstamped_key(key, b"%d:%d" % (cid, i))
                    await tr.commit()
                    stamp = tr.get_versionstamp()
                    self.shared["committed"].append(
                        (bytes(stamp), b"%d:%d" % (cid, i)))
                    self.local_stamped += 1
                    break
                except FdbError as e:
                    # an unknown result may or may not have stamped a
                    # key; drop the sample rather than guess (the
                    # ordering check tolerates extras in the db)
                    if e.maybe_committed:
                        break
                    await tr.on_error(e)

    async def check(self) -> bool:
        if self.ctx.client_id != 0:
            return True
        tr = self.db.create_transaction()
        while True:
            try:
                rows = await tr.get_range(self.PREFIX,
                                          self.PREFIX + b"\xff", limit=0)
                break
            except FdbError as e:
                await tr.on_error(e)
        in_db = {bytes(k)[len(self.PREFIX):]: bytes(v) for k, v in rows}
        # every acked stamp exists at exactly its stamped key
        for stamp, val in self.shared["committed"]:
            assert in_db.get(stamp) == val, (
                f"stamp {stamp.hex()} expected {val!r}, "
                f"got {in_db.get(stamp)!r}")
        # stamps are unique, and within one client (whose commits are
        # strictly sequential) stamp byte-order equals commit order
        stamps = [s for s, _ in self.shared["committed"]]
        assert len(set(stamps)) == len(stamps), "duplicate versionstamps"
        per_client: dict[bytes, list[tuple[int, bytes]]] = {}
        for stamp, val in self.shared["committed"]:
            cid, i = val.split(b":")
            per_client.setdefault(cid, []).append((int(i), stamp))
        for cid, seq in per_client.items():
            seq.sort()
            raw = [s for _, s in seq]
            assert raw == sorted(raw), (
                f"client {cid!r}: versionstamp order diverges from "
                f"commit order")
        return True

    def metrics(self):
        # per-client count: the runner SUMS metrics across clients, and
        # the committed pool is shared
        return {"stamped": self.local_stamped}
