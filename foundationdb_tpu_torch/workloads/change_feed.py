"""Change-feed completeness workload — the exactly-once detector.

Reference: REF:fdbserver/workloads/ChangeFeeds.actor.cpp — writers
commit uniquely-keyed mutations inside the feed range while a consumer
tails the feed; the check phase asserts the stream is COMPLETE and
EXACT: every mutation whose commit was acknowledged appears exactly
once, at exactly its commit version, in non-decreasing version order.
A lost entry, a duplicate (double apply / double capture), a
wrong-version delivery, or an out-of-order batch each break a different
invariant — under buggify faults and attrition-driven failovers this is
the subsystem's proof obligation.

Coordination: clients of one spec share the options dict, so writers
publish their acknowledged (key, value, version) triples — and
maybe-committed strays — into a shared record the consumer's check
phase audits.
"""

from __future__ import annotations

import asyncio
import zlib

from ..runtime.errors import CommitUnknownResult
from .workload import TestWorkload, register_workload


@register_workload
class ChangeFeedWorkload(TestWorkload):
    name = "ChangeFeed"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.prefix = bytes(self.opt("prefix", b"cfw/"))
        self.feed_id = bytes(self.opt("feedId", b"cfw-feed"))
        self.txns = int(self.opt("transactionsPerClient", 20))
        # pop the feed once the consumer has processed this many entries
        # (0 disables) — exercises the durable low-water mark mid-stream
        self.pop_after = int(self.opt("popAfter", 0))
        sh = self.ctx.options.setdefault("_shared", {
            "committed": [],      # (key, value, version) acked to a writer
            "unknown": [],        # (key, value) with commit_unknown_result
            "delivered": [],      # (version, key, value) off the feed
            "writers_done": 0,
            "popped_at": 0,
        })
        self.shared = sh
        self.commits = 0
        self.retries = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%02d-%06d" % (self.ctx.client_id, i)

    async def setup(self) -> None:
        from ..core.data import strinc
        await self.db.create_change_feed(
            self.feed_id, self.prefix, strinc(self.prefix))

    async def start(self) -> None:
        if self.ctx.client_id == 0:
            await self._consume()
        else:
            await self._write()

    async def _write(self) -> None:
        for i in range(self.txns):
            key = self._key(i)
            value = b"w%02d-%06d" % (self.ctx.client_id, i)
            tr = self.db.create_transaction()
            while True:
                try:
                    tr.set(key, value)
                    v = await tr.commit()
                    self.shared["committed"].append((key, value, v))
                    self.commits += 1
                    break
                except CommitUnknownResult:
                    # retrying would risk a double-set the checker can't
                    # attribute; a unique key per txn lets the check
                    # accept 0-or-1 deliveries for these instead
                    self.shared["unknown"].append((key, value))
                    break
                except BaseException as e:
                    await tr.on_error(e)
                    self.retries += 1
        self.shared["writers_done"] += 1

    async def _consume(self) -> None:
        writer_count = self.ctx.client_count - 1
        cur = self.db.read_change_feed(self.feed_id)
        delivered = self.shared["delivered"]
        while True:
            for v, batch in await cur.next():
                for m in batch:
                    delivered.append((v, bytes(m.param1), bytes(m.param2)))
            if self.pop_after and not self.shared["popped_at"] \
                    and len(delivered) >= self.pop_after:
                # everything at or below the last processed version is
                # consumed; release it durably and remember the mark so
                # the check knows a post-pop resume must still be exact
                popv = delivered[-1][0]
                await self.db.pop_change_feed(self.feed_id, popv)
                self.shared["popped_at"] = popv
            if self.shared["writers_done"] >= writer_count:
                acked = self.shared["committed"]
                tip = max((v for _k, _v2, v in acked), default=0)
                if cur.version > tip:
                    return      # proven: everything <= tip delivered
            await asyncio.sleep(0)

    async def check(self) -> bool:
        committed = self.shared["committed"]
        unknown = {(k, val) for k, val in self.shared["unknown"]}
        delivered = self.shared["delivered"]
        # version order is non-decreasing as delivered
        versions = [v for v, _k, _val in delivered]
        if versions != sorted(versions):
            return False
        seen: dict[tuple[bytes, bytes], list[int]] = {}
        for v, k, val in delivered:
            seen.setdefault((k, val), []).append(v)
        ok = True
        for k, val, v in committed:
            got = seen.pop((k, val), [])
            # exactly once, at exactly the commit version
            if got != [v]:
                ok = False
        for (k, val), got in seen.items():
            # leftovers must be maybe-committed strays, at most once
            if (k, val) not in unknown or len(got) > 1:
                ok = False
        return ok

    def metrics(self):
        # the stream digest makes same-seed determinism checkable from
        # the results dict alone: two runs must agree bit-for-bit
        digest = 0
        if self.ctx.client_id == 0:
            blob = b"".join(b"%d\x00%s\x00%s\x01" % (v, k, val)
                            for v, k, val in self.shared["delivered"])
            digest = zlib.crc32(blob)
        return {"commits": self.commits, "retries": self.retries,
                "delivered": len(self.shared["delivered"])
                if self.ctx.client_id == 0 else 0,
                "stream_crc": float(digest),
                "popped_at": float(self.shared["popped_at"])
                if self.ctx.client_id == 0 else 0}
