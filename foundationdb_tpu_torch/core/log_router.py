"""LogRouter — one upstream tag pull fanned out to many consumers.

Reference: REF:fdbserver/LogRouter.actor.cpp — in multi-region/DR
topologies, N remote consumers (remote TLogs, DR/backup agents) must not
each impose a peek load on the primary TLogs.  A log router subscribes to
the tag ONCE (surviving recoveries exactly like a storage server's pull),
buffers a bounded window, and serves downstream ``peek``/``pop`` with
TLog semantics.  The buffer is trimmed — and the upstream tag popped — at
the *minimum* consumer pop, so the primary's disk queue is released as
soon as every consumer has the data, while one lagging consumer pins only
the router's memory, not the primary's.

Consumers are declared up front (the reference's routers likewise serve a
fixed set of pull locations per epoch): an undeclared consumer cannot
silently anchor-or-miss the trim floor.
"""

from __future__ import annotations

import asyncio
import bisect

from ..backup.stream import TagStream
from ..runtime.errors import ClientInvalidOperation, FdbError
from ..runtime.trace import TraceEvent
from .data import Version
from .tlog import TLogPeekReply, Tag


class LogRouter:
    """Pulls ``tag`` from ``db``'s log system starting at ``begin`` and
    serves it to the named ``consumers``.  ``peek``/``pop`` mirror the
    TLog surface so any cursor built for TLogs works against a router."""

    def __init__(self, db, tag: Tag, begin: Version,
                 consumers: list, poll_timeout: float = 1.0,
                 stream=None) -> None:
        if not consumers:
            raise ClientInvalidOperation("log router needs >=1 consumer")
        self.tag = tag
        # default upstream: a recovery-resilient TagStream (the DR path).
        # Epoch-scoped routers (multi-region remote feeds, re-recruited
        # every recovery like TLogs) pass a CursorStream instead.
        self.stream = stream if stream is not None \
            else TagStream(db, tag, begin)
        self._versions: list[Version] = []      # ascending, parallel to _msgs
        self._msgs: list[list] = []
        self._floor: Version = begin            # versions < floor trimmed
        self._end: Version = begin              # exclusive frontier
        self._pops: dict[str, Version] = {c: begin for c in consumers}
        self._progress = asyncio.Event()
        self._poll_timeout = poll_timeout
        self._task: asyncio.Task | None = None

    # --- lifecycle ---

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self._run(), name="log-router")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        # errors escaping TagStream.next() (e.g. fetch_cluster_state in
        # the ack-confirm round, outside TagStream's internal retry) must
        # not kill the router silently — consumers would long-poll an
        # unmoving frontier forever with no trace of why
        backoff = 0.25
        while True:
            try:
                entries, end = await self.stream.next()
            except asyncio.CancelledError:
                raise
            except Exception as e:   # noqa: BLE001 — retry with backoff
                TraceEvent("LogRouterPullError", severity=30) \
                    .detail("Tag", self.tag).detail("End", self._end) \
                    .error(e).log()
                # the cursor may have advanced past entries the failed
                # call never handed us (ack-confirm raised after the
                # pull): rewind to the emitted frontier or the retry
                # silently skips those versions
                self.stream.rewind(self._end - 1)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 5.0)
                continue
            backoff = 0.25
            for v, m in entries:
                self._versions.append(v)
                self._msgs.append(m)
            self._end = max(self._end, end)
            self._progress.set()
            self._progress = asyncio.Event()

    # --- the TLog-shaped downstream surface ---

    async def peek(self, consumer: str, begin: Version) -> TLogPeekReply:
        """Entries at versions >= begin (long-polls up to poll_timeout for
        progress, then answers with whatever frontier it has — the same
        prompt-reply contract as TLog.peek, so pull loops back off rather
        than hold connections)."""
        self._check_consumer(consumer)
        if begin < self._floor:
            # trimmed data can only be requested by a consumer rewinding
            # below its own pop — a protocol violation, not data loss
            raise ClientInvalidOperation(
                f"peek at {begin} below router floor {self._floor}")
        if self._end <= begin:
            ev = self._progress
            try:
                await asyncio.wait_for(ev.wait(), self._poll_timeout)
            except asyncio.TimeoutError:
                pass
        lo = bisect.bisect_left(self._versions, begin)
        entries = [(self._versions[i], self._msgs[i])
                   for i in range(lo, len(self._versions))]
        return TLogPeekReply(entries, max(self._end, begin))

    def pop(self, consumer: str, version: Version) -> None:
        """Consumer releases versions < ``version``.  The buffer trims —
        and the upstream tag pops — at min over all consumers."""
        self._check_consumer(consumer)
        self._pops[consumer] = max(self._pops[consumer], version)
        floor = min(self._pops.values())
        if floor <= self._floor:
            return
        cut = bisect.bisect_left(self._versions, floor)
        if cut:
            del self._versions[:cut]
            del self._msgs[:cut]
        self._floor = floor
        # TagStream.pop takes an INCLUSIVE through-version
        self.stream.pop(floor - 1)
        TraceEvent("LogRouterPopped").detail("Tag", self.tag) \
            .detail("Floor", floor).detail("Buffered", len(self._versions)) \
            .log()

    def _check_consumer(self, consumer: str) -> None:
        if consumer not in self._pops:
            raise ClientInvalidOperation(
                f"unknown log-router consumer {consumer!r}")

    # --- observability ---

    def metrics(self) -> dict:
        return {"tag": self.tag, "floor": self._floor, "end": self._end,
                "buffered": len(self._versions),
                "pops": dict(self._pops)}


class CursorStream:
    """TagStream-shaped pull over a FIXED epoch's LogSystem.  Multi-region
    remote-feed routers ride this: they are per-epoch recruits (rebuilt at
    every recovery, like the reference's log routers in
    REF:fdbserver/TagPartitionedLogSystem.actor.cpp), so a frozen
    generation view is correct — no cross-recovery cursor needed."""

    def __init__(self, log_system, tag: Tag, begin: Version) -> None:
        self.ls = log_system
        self.tag = tag
        self.cursor = log_system.cursor(tag, begin)

    async def next(self) -> tuple[list[tuple[Version, list]], Version]:
        reply = await self.cursor.next()
        return list(reply.entries), reply.end_version

    def pop(self, through: Version) -> None:
        """Inclusive through-version (the TagStream.pop contract)."""
        self.ls.pop(self.tag, through + 1)

    def rewind(self, to_frontier: Version) -> None:
        self.cursor.version = to_frontier + 1


class RouterStream:
    """A TagStream-shaped cursor over a LogRouter (in-process or a
    LogRouterClient stub): lets the DR agent pull through a router with
    no code change (`DRAgent(..., stream_factory=...)`)."""

    def __init__(self, router, consumer: str, begin: Version) -> None:
        self.router = router
        self.consumer = consumer
        self.frontier: Version = begin - 1

    async def next(self) -> tuple[list[tuple[Version, list]], Version]:
        while True:
            try:
                reply = await self.router.peek(self.consumer,
                                               self.frontier + 1)
            except asyncio.CancelledError:
                raise
            except ClientInvalidOperation:
                raise
            except FdbError:
                await asyncio.sleep(0.25)
                continue
            entries = [(v, m) for v, m in reply.entries
                       if v > self.frontier]
            if not entries and reply.end_version - 1 <= self.frontier:
                await asyncio.sleep(0.05)
                continue
            self.frontier = max(self.frontier, reply.end_version - 1)
            return entries, reply.end_version

    def pop(self, through: Version) -> None:
        self.router.pop(self.consumer, through + 1)
