"""Client surface for change feeds: create / read / pop / destroy.

Reference: REF:fdbclient/NativeAPI.actor.cpp (createChangeFeed /
getChangeFeedStreamActor / popChangeFeedMutations) — feed lifecycle is
ordinary transactions against the ``\\xff/changeFeeds`` system keyspace
(so registration is replicated, recovered and exactly-versioned like
any commit), and consumption is a merged cursor over the storage
servers owning the feed's range.

Exactly-once resume: the cursor's ``version`` field is the full resume
state.  Every ``next()`` long-polls all owning shards, delivers only
entries below the MINIMUM of the shards' heartbeat end-versions, and
advances the cursor to that minimum — so a consumer that crashes and
reconstructs a cursor from its last processed version re-reads nothing
and skips nothing, across storage failovers and range moves.
"""

from __future__ import annotations

import asyncio

from ..core.change_feed import ChangeFeedStreamRequest
from ..core.data import MutationBatch, Version
from ..core.system_data import change_feed_key, change_feed_pop_key
from ..runtime.errors import (ChangeFeedDestroyed, ChangeFeedNotRegistered,
                              ChangeFeedPopped, FdbError, InvertedRange,
                              KeyOutsideLegalRange)

__all__ = ["create_change_feed", "destroy_change_feed", "pop_change_feed",
           "ChangeFeedCursor"]


async def create_change_feed(db, feed_id: bytes, begin: bytes,
                             end: bytes) -> Version:
    """Register feed ``feed_id`` over [begin, end); returns the commit
    version — mutations strictly above it flow into the feed.
    Idempotent: re-creating an existing feed is a no-op server-side."""
    if begin >= end:
        raise InvertedRange()
    if end > b"\xff":
        raise KeyOutsideLegalRange("change feeds cover user keys only")
    from ..rpc.wire import encode
    blob = encode({"b": bytes(begin), "e": bytes(end)})
    tr = db.create_transaction()
    while True:
        try:
            tr.set(change_feed_key(feed_id), blob)
            return await tr.commit()
        except BaseException as e:
            await tr.on_error(e)   # re-raises if not retryable


async def destroy_change_feed(db, feed_id: bytes) -> None:
    """Unregister the feed; owning storage servers release every
    retained segment at the destroy's exact commit version."""
    async def go(tr):
        tr.clear(change_feed_key(feed_id))
    await db.run(go)


async def pop_change_feed(db, feed_id: bytes, version: Version) -> None:
    """Advance the feed's durable low-water mark: entries at or below
    ``version`` are released on every owning storage server (a resumed
    cursor below it fails with change_feed_popped)."""
    from ..rpc.wire import encode
    blob = encode(int(version))

    async def go(tr):
        tr.set(change_feed_pop_key(feed_id), blob)
    await db.run(go)


async def _feed_range(db, feed_id: bytes) -> tuple[bytes, bytes]:
    from ..rpc.wire import decode
    tr = db.create_transaction()
    try:
        raw = await tr.get(change_feed_key(feed_id), snapshot=True)
    finally:
        tr.reset()
    if not raw:
        raise ChangeFeedNotRegistered()
    info = decode(bytes(raw))
    return bytes(info["b"]), bytes(info["e"])


def _covers(begin: bytes, end: bytes,
            pieces: list[tuple[bytes, bytes]]) -> bool:
    """True when the union of ``pieces`` covers [begin, end)."""
    cur = begin
    for b, e in sorted((bytes(b), bytes(e)) for b, e in pieces):
        if b > cur:
            return False
        cur = max(cur, e)
        if cur >= end:
            return True
    return cur >= end


class ChangeFeedCursor:
    """Version-merged consumer over every shard of a feed's range.

    ``next()`` returns [(version, MutationBatch)] in non-decreasing
    version order (a version appears once per owning shard — shards
    carry disjoint keys) and advances ``self.version`` past everything
    returned; an empty list is a heartbeat (the range is proven quiet
    below the advanced cursor).  Construct with the last processed
    cursor to resume exactly-once.
    """

    def __init__(self, db, feed_id: bytes, begin_version: Version = 0,
                 begin: bytes | None = None, end: bytes | None = None,
                 byte_limit: int = 0) -> None:
        self._db = db
        self.feed_id = feed_id
        self.version = max(1, begin_version)   # next unseen version
        self._begin = begin
        self._end = end
        self._byte_limit = byte_limit
        self.popped_version: Version = 0
        self.entries_read = 0

    def _cluster(self):
        # Database wraps an in-process Cluster; RefreshingDatabase wraps
        # a RecoveredClusterView — both expose storages_for_range
        return getattr(self._db, "view", None) or self._db.cluster

    async def _refresh(self) -> None:
        refresh = getattr(self._db, "refresh", None)
        if refresh is not None:
            await refresh()

    async def next(self) -> list[tuple[Version, MutationBatch]]:
        not_registered = 0
        stale_map = 0
        while True:
            groups = self._cluster().storages_for_range(
                self._begin, self._end) if self._begin is not None else None
            if groups is None:
                self._begin, self._end = await _feed_range(self._db,
                                                           self.feed_id)
                continue
            req = ChangeFeedStreamRequest(self.feed_id, self.version,
                                          self._byte_limit)
            try:
                replies = await asyncio.gather(
                    *(g.change_feed_stream(req) for g in groups))
            except ChangeFeedPopped:
                raise
            except FdbError as e:
                if isinstance(e, ChangeFeedNotRegistered):
                    # racing a range handoff (the destination has not
                    # applied its REGISTER yet) — or genuinely destroyed;
                    # the replicated registration row distinguishes the
                    # two: a handoff leaves it intact, a destroy clears
                    # it, so a consumer gets the typed terminal error
                    # instead of a raw lookup failure after 50 retries
                    try:
                        await _feed_range(self._db, self.feed_id)
                    except ChangeFeedNotRegistered:
                        raise ChangeFeedDestroyed(
                            "change feed %r destroyed mid-drain at cursor "
                            "version %d" % (self.feed_id, self.version)
                        ) from e
                    except FdbError as probe:
                        if not probe.retryable:
                            raise
                        # row unreadable right now: stay in the bounded
                        # handoff retry rather than misclassifying
                    not_registered += 1
                    if not_registered > 50:
                        raise
                elif not e.retryable:
                    raise
                await self._refresh()
                await asyncio.sleep(0.1)
                continue
            # COVERAGE gate: after a range split/move the old owner keeps
            # answering for the keys it kept — no error ever fires — so
            # the cursor must prove the polled shards jointly cover the
            # feed range before advancing, else the moved half's
            # mutations would be silently skipped
            pieces: list[tuple[bytes, bytes]] = []
            known = True
            for r in replies:
                if r.ranges is None:      # pre-coverage peer: trust it
                    known = False
                    break
                pieces.extend(r.ranges)
            if known and not _covers(self._begin, self._end, pieces):
                stale_map += 1
                if stale_map > 100:
                    raise FdbError(
                        "change feed range %r-%r not fully served after "
                        "repeated refreshes" % (self._begin, self._end))
                await self._refresh()
                await asyncio.sleep(0.1)
                continue
            end = min(r.end_version for r in replies)
            self.popped_version = max(r.popped_version for r in replies)
            if end <= self.version:
                return []      # heartbeat with no progress: re-poll
            out: list[tuple[Version, MutationBatch]] = []
            for r in replies:          # group order == shard key order
                for v, batch in r.entries:
                    if self.version <= v < end:
                        out.append((v, batch))
            out.sort(key=lambda e: e[0])   # stable: shard order per version
            self.version = end
            self.entries_read += len(out)
            return out

    async def drain_through(self, version: Version,
                            deadline: float | None = None
                            ) -> list[tuple[Version, MutationBatch]]:
        """Poll until the cursor has proven everything at or below
        ``version`` delivered; returns the accumulated entries."""
        loop = asyncio.get_running_loop()
        out: list[tuple[Version, MutationBatch]] = []
        while self.version <= version:
            if deadline is not None and loop.time() > deadline:
                raise TimeoutError(
                    f"feed cursor stalled at {self.version} < {version}")
            out.extend(await self.next())
        return out
