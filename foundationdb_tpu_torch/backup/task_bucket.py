"""TaskBucket / FutureBucket — durable task scheduling in the keyspace.

Reference: REF:fdbclient/TaskBucket.actor.cpp + TaskBucket.h — the
reference's backup/restore/DR state machines are DAGs of small tasks
stored AS DATA: a task is a parameter bundle under a subspace, agents
claim one atomically (OCC makes double-claims impossible), renew a
lease while executing, and either finish (delete) or die (the expired
lease returns the task to the available set).  FutureBucket gives
persistent futures: a task "blocked" on an unset future is parked and
becomes available atomically when the future is set — that is how task
chains (snapshot → logs → finalize) survive agent crashes.

Layout under ``prefix`` (all values wire-encoded):

    prefix + "avail/" + <10B versionstamp>      -> params
    prefix + "busy/"  + <task id>               -> [deadline_version, params]
    prefix + "fut/"   + <future id>             -> b"" (unset) | b"1" (set)
    prefix + "park/"  + <future id> + <task id> -> params

Leases use the version clock (read versions advance at
``VERSIONS_PER_SECOND``), so "expired" is judged by the database's own
notion of now — no wall clocks in the data path.
"""

from __future__ import annotations

import asyncio

from ..core.data import Version
from ..rpc.wire import decode, encode
from ..runtime.errors import FdbError
from ..runtime.trace import TraceEvent


class FutureBucket:
    """Persistent futures under ``prefix``."""

    def __init__(self, db, prefix: bytes) -> None:
        self.db = db
        self.prefix = prefix

    def _key(self, fid: bytes) -> bytes:
        return self.prefix + b"fut/" + fid

    def create(self, tr, fid: bytes) -> bytes:
        """Declare an (unset) future inside the caller's transaction."""
        tr.set(self._key(fid), b"")
        return fid

    async def is_set(self, fid: bytes) -> bool:
        async def go(tr):
            v = await tr.get(self._key(fid))
            return v == b"1"
        return await self.db.run(go)

    async def set(self, fid: bytes) -> None:
        """Fire the future, then release its parked tasks in bounded
        chunks (one unbounded move could exceed the transaction size
        limit and make the future permanently unsettable).  The flag
        commits FIRST, so concurrent add(after=fid) routes straight to
        available and never parks into a drained area; a crash
        mid-drain leaves parked tasks under a set future, which
        ``sweep_fired`` (run by every agent alongside requeue_expired)
        self-heals."""
        async def flag(tr):
            tr.lock_aware = True
            tr.set(self._key(fid), b"1")
        await self.db.run(flag)
        while await self._drain_parked(fid):
            pass

    async def _drain_parked(self, fid: bytes, limit: int = 100) -> int:
        park = self.prefix + b"park/" + fid + b"/"

        async def go(tr):
            tr.lock_aware = True
            parked = await tr.get_range(park, park + b"\xff", limit=limit)
            for k, v in parked:
                suffix = bytes(k)[len(park):]
                tr.set(self.prefix + b"avail/" + suffix, bytes(v))
                tr.clear(bytes(k))
            return len(parked)
        return await self.db.run(go)

    async def sweep_fired(self, limit: int = 50) -> int:
        """Release tasks parked under ALREADY-SET futures (a crash
        between set()'s flag and its drain leaves them).  Any agent may
        run this; bounded per call."""
        park_all = self.prefix + b"park/"

        async def find(tr):
            return await tr.get_range(park_all, park_all + b"\xff",
                                      limit=limit)
        rows = await self.db.run(find)
        moved = 0
        seen: set[bytes] = set()
        for k, _v in rows:
            body = bytes(k)[len(park_all):]
            # layout: <fid> b"/" <10B stamp + 2B nonce>; the stamp may
            # contain 0x2f, so strip the fixed-length suffix positionally
            fid = body[:-13]
            if fid in seen:
                continue
            seen.add(fid)
            if await self.is_set(fid):
                moved += await self._drain_parked(fid)
        return moved


class TaskBucket:
    """Claim/execute/finish over the shared keyspace."""

    def __init__(self, db, prefix: bytes,
                 lease_seconds: float = 5.0,
                 versions_per_second: int = 1_000_000) -> None:
        self.db = db
        self.prefix = prefix
        self.lease_versions = int(lease_seconds * versions_per_second)
        self.futures = FutureBucket(db, prefix)
        import itertools
        self._nonce = itertools.count()

    # --- producers ---

    async def add(self, tr, params: dict,
                  after: bytes | None = None) -> None:
        """Enqueue inside the caller's transaction.  With ``after``, the
        task parks until that future fires — unless it ALREADY fired, in
        which case it goes straight to available (the read on the future
        key makes this race-free: a concurrent set() conflicts and one
        side retries).  The versionstamped key gives cluster-wide
        unique, commit-ordered task ids."""
        blob = encode(params)
        if after is not None:
            fired = await tr.get(self.futures._key(after))
            if fired == b"1":
                after = None
        if after is None:
            base = self.prefix + b"avail/"
        else:
            base = self.prefix + b"park/" + after + b"/"
        # every mutation in one transaction receives the SAME
        # (version, order) stamp, so two add()s in one txn would collide
        # on the bare stamp — a per-bucket nonce after the placeholder
        # disambiguates while keeping commit order as key order
        seq = (next(self._nonce) & 0xFFFF).to_bytes(2, "big")
        key = base + b"\x00" * 10 + seq
        tr.set_versionstamped_key(
            key + len(base).to_bytes(4, "little"), blob)

    async def add_task(self, params: dict, after: bytes | None = None) -> None:
        async def go(tr):
            tr.lock_aware = True
            await self.add(tr, params, after)
        await self.db.run(go)

    # --- consumers ---

    async def get_one(self) -> tuple[bytes, dict] | None:
        """Atomically claim the oldest available task: move it to the
        busy set with a lease deadline.  Returns (task_id, params) or
        None when nothing is available.  Two racing agents conflict on
        the task key — exactly one wins (the reference's OCC claim)."""
        avail = self.prefix + b"avail/"

        async def go(tr):
            tr.lock_aware = True
            rows = await tr.get_range(avail, avail + b"\xff", limit=1)
            if not rows:
                return None
            k, v = rows[0]
            tid = bytes(k)[len(avail):]
            rv = await tr.get_read_version()
            tr.clear(bytes(k))
            tr.set(self.prefix + b"busy/" + tid,
                   encode([rv + self.lease_versions, decode(bytes(v))]))
            return tid, decode(bytes(v))
        return await self.db.run(go)

    async def extend(self, task_id: bytes) -> bool:
        """Renew the lease; False if the task is no longer ours (it
        expired and was re-queued or finished)."""
        key = self.prefix + b"busy/" + task_id

        async def go(tr):
            tr.lock_aware = True
            cur = await tr.get(key)
            if cur is None:
                return False
            _, params = decode(bytes(cur))
            rv = await tr.get_read_version()
            tr.set(key, encode([rv + self.lease_versions, params]))
            return True
        return await self.db.run(go)

    async def finish(self, task_id: bytes) -> None:
        async def go(tr):
            tr.lock_aware = True
            tr.clear(self.prefix + b"busy/" + task_id)
        await self.db.run(go)

    async def requeue_expired(self) -> int:
        """Return expired busy tasks to the available set (any agent may
        run this; the reference folds it into getOne)."""
        busy = self.prefix + b"busy/"

        async def go(tr):
            tr.lock_aware = True
            rv = await tr.get_read_version()
            rows = await tr.get_range(busy, busy + b"\xff", limit=50)
            n = 0
            for k, v in rows:
                deadline, params = decode(bytes(v))
                if deadline >= rv:
                    continue
                tid = bytes(k)[len(busy):]
                tr.clear(bytes(k))
                tr.set(self.prefix + b"avail/" + tid, encode(params))
                n += 1
            return n
        n = await self.db.run(go)
        if n:
            TraceEvent("TaskBucketRequeued").detail("Count", n).log()
        return n

    async def sweep_fired(self, limit: int = 50) -> int:
        """Release tasks parked under already-set futures (see
        FutureBucket.sweep_fired — run by every agent)."""
        return await self.futures.sweep_fired(limit)

    async def is_empty(self) -> bool:
        a, b = self.prefix + b"avail/", self.prefix + b"busy/"

        async def go(tr):
            ra = await tr.get_range(a, a + b"\xff", limit=1)
            rb = await tr.get_range(b, b + b"\xff", limit=1)
            return not ra and not rb
        return await self.db.run(go)


async def task_agent(bucket: TaskBucket, handlers: dict,
                     idle_sleep: float = 0.1,
                     extend_every: float = 1.0) -> None:
    """One executor loop (the reference's taskBucket agent): claim, run
    the handler named by params["type"] with a lease-renewal heartbeat,
    finish.  Unknown types and handler errors leave the task to expire
    back to available (at-least-once execution, like the reference —
    handlers must be idempotent)."""
    while True:
        try:
            await bucket.requeue_expired()
            await bucket.sweep_fired()
            got = await bucket.get_one()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — an agent must not die silently
            if not isinstance(e, FdbError):
                # a programming error would otherwise kill the agent
                # TASK invisibly (create_task swallows it until gather)
                TraceEvent("TaskAgentError", severity=40) \
                    .detail("Error", repr(e)[:200]).log()
            await asyncio.sleep(idle_sleep)
            continue
        if got is None:
            await asyncio.sleep(idle_sleep)
            continue
        tid, params = got
        handler = handlers.get(params.get("type"))
        if handler is None:
            TraceEvent("TaskBucketUnknownType", severity=30) \
                .detail("Type", str(params.get("type"))).log()
            await asyncio.sleep(idle_sleep)
            continue

        async def heartbeat():
            while True:
                await asyncio.sleep(extend_every)
                if not await bucket.extend(tid):
                    return
        hb = asyncio.get_running_loop().create_task(heartbeat())
        try:
            await handler(params)
        except asyncio.CancelledError:
            hb.cancel()
            raise
        except Exception as e:  # noqa: BLE001 — the lease requeues it
            TraceEvent("TaskBucketTaskFailed", severity=30) \
                .detail("Error", repr(e)[:200]).log()
            hb.cancel()
            continue
        hb.cancel()
        await bucket.finish(tid)
