"""DR — asynchronous cluster-to-cluster replication + switchover.

Reference: REF:fdbclient/DatabaseBackupAgent.actor.cpp (`fdbdr`) — the
primary cluster streams its full mutation log to a secondary cluster,
which applies it in version order; `fdbdr switch` locks the primary,
drains the stream, and hands the application over to the secondary.

TPU-native mapping: the stream is a named mutation-log tag
(``\\xff/backup/tags/<name>``) armed on every commit proxy; the agent
pulls it from the primary's TLogs exactly like a storage server pulls
its own tag (TagStream), and applies each version's mutations to the
destination through ordinary transactions.  Progress is a key on the
DESTINATION (``\\xff/dr/applied``) read inside the same transaction that
applies a chunk, so a retry after an ambiguous commit can never
double-apply a non-idempotent atomic op.

Consistency: the destination is a strict prefix of the source's version
history between chunk boundaries — transaction atomicity is preserved
because a chunk boundary never splits one source version's mutations.
"""

from __future__ import annotations

import asyncio

from ..core.data import SYSTEM_PREFIX, Version
from ..rpc.wire import encode
from ..runtime.errors import FdbError
from ..runtime.trace import TraceEvent
from .stream import TagStream

# the DR feed's well-known mutation-log tag, far above any storage tag
# DataDistribution will ever allocate (DD uses max(existing tag)+1).
# Offset +1 preserves the historical numbering from when the file backup
# owned 1<<20 — the feed-native backup (agent.py) no longer uses a
# proxy-side tag at all, so DR is the raw tag stream's only client.
DR_TAG = (1 << 20) + 1
APPLIED_KEY = b"\xff/dr/applied"        # on the DESTINATION
DRAIN_KEY = b"\xff/dr/marker"           # on the SOURCE


class DrError(FdbError):
    code = 2381
    name = "dr_error"


def _replay_mutation(tr, m) -> None:
    """Replay one RAW tag-stream mutation on the destination: atomics
    re-evaluate against the destination's state — same inputs in the
    same order as the source, so the results are identical.  Private
    markers and the source's system metadata never replay."""
    from ..core.data import PRIVATE_TYPES, MutationType
    t = MutationType(m.type)
    if t in PRIVATE_TYPES:
        return
    if t == MutationType.CLEAR_RANGE:
        e = min(m.param2, SYSTEM_PREFIX)
        if m.param1 < e:
            tr.clear_range(m.param1, e)
        return
    if m.param1 >= SYSTEM_PREFIX:
        return
    if t == MutationType.SET_VALUE:
        tr.set(m.param1, m.param2)
    else:
        tr.atomic_op(t, m.param1, m.param2)


class DRAgent:
    """Replicate ``src`` into ``dest``; both are Database handles."""

    def __init__(self, src, dest, name: str = "dr",
                 tag: int = DR_TAG, rows_per_txn: int = 200,
                 stream_factory=None) -> None:
        self.src = src
        self.dest = dest
        self.name = name
        self.tag = tag
        self.rows_per_txn = rows_per_txn
        # (db, tag, begin) -> TagStream-shaped cursor; default pulls the
        # TLogs directly, a RouterStream factory pulls via a LogRouter
        self.stream_factory = stream_factory or \
            (lambda db, tag, begin: TagStream(db, tag, begin))
        self._task: asyncio.Task | None = None
        self._stream: TagStream | None = None
        # source-version frontier fully applied to dest (includes empty
        # spans: safe for drain even when no tagged mutations exist)
        self.applied_through: Version = -1
        self._drain_seq = 0

    # --- lifecycle ---

    @property
    def dest_lock_uid(self) -> bytes:
        return b"dr-dest:" + self.name.encode()

    async def start(self) -> Version:
        """Arm the tag, copy a consistent snapshot of the source into the
        destination, then stream every later mutation.  Returns the
        snapshot version: dest == src at that version once start returns.

        The DESTINATION is locked for the whole replication window (the
        reference's DatabaseBackupAgent does the same): a concurrent
        writer there would silently break the strict-prefix invariant —
        only this agent's lock-aware transactions may touch it until
        switchover (which unlocks it as it becomes the primary) or
        abort."""
        if self._task is not None and not self._task.done():
            raise DrError("dr already running")
        from ..core.management import lock_database
        await lock_database(self.dest, self.dest_lock_uid)
        va = await self._commit_tag(encode(self.tag))
        v0 = await self._snapshot_copy()
        assert v0 >= va, "snapshot read version precedes tag arm commit"
        self.applied_through = v0
        await self._set_applied_initial(v0)
        self._stream = self.stream_factory(self.src, self.tag, v0 + 1)
        self._task = asyncio.get_running_loop().create_task(
            self._apply_loop(), name="dr-apply")
        TraceEvent("DrStarted").detail("Tag", self.tag) \
            .detail("SnapshotVersion", v0).log()
        return v0

    async def stop(self) -> None:
        """Stop pulling (leaves the tag armed — use switchover/abort for
        a clean shutdown)."""
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def abort(self) -> None:
        """Disarm the tag, unlock the destination and stop: the
        destination stops converging and keeps whatever prefix it has.
        Pops through the DISARM version,
        not just the applied frontier — the abandoned span
        (applied_through, disarm] would otherwise pin the source TLogs'
        disk queue until the next recovery (a tag stops constraining the
        queue only once popped past its last pushed version)."""
        ve = await self._commit_tag(None)
        if self._stream is not None:
            self._stream.pop(max(self.applied_through, ve))
        await self.stop()
        await self._unlock_dest()
        TraceEvent("DrAborted").detail("Through", self.applied_through) \
            .detail("Disarmed", ve).log()

    async def _unlock_dest(self) -> None:
        from ..core.management import unlock_database
        await unlock_database(self.dest, self.dest_lock_uid)

    # --- the headline operation ---

    async def switchover(self, lock_uid: bytes = b"dr-switchover") -> Version:
        """Atomic role switch (REF: DatabaseBackupAgent::atomicSwitchover):
        lock the source so no further non-lock-aware commit lands, drain
        the stream, then disarm and stop.  On return the destination
        contains every transaction the source ever acknowledged, and the
        source is locked (unlock it only to fail back)."""
        from ..core.management import lock_database
        await lock_database(self.src, lock_uid)
        drained = await self.drain()
        await self.abort()          # also unlocks dest: it is primary now
        TraceEvent("DrSwitchover").detail("Drained", drained).log()
        return drained

    async def drain(self, timeout: float = 30.0) -> Version:
        """Commit a marker on the source and wait until the destination
        has applied through the marker's version."""
        tr = self.src.create_transaction()
        tr.lock_aware = True
        self._drain_seq += 1
        while True:
            try:
                tr.set(DRAIN_KEY, b"%d" % self._drain_seq)
                vd = await tr.commit()
                break
            except Exception as e:  # noqa: BLE001 — retry via on_error
                await tr.on_error(e)

        async def wait():
            while self.applied_through < vd:
                if self._task is None or self._task.done():
                    raise DrError("dr apply loop is not running")
                await asyncio.sleep(0.05)
        try:
            await asyncio.wait_for(wait(), timeout)
        except asyncio.TimeoutError:
            raise DrError(
                f"drain timed out: applied {self.applied_through} < {vd}")
        return vd

    # --- internals ---

    async def _commit_tag(self, value: bytes | None) -> Version:
        from .stream import commit_tag
        return await commit_tag(self.src, self.name, value)

    async def _snapshot_copy(self) -> Version:
        """Copy the source's user range into dest at ONE pinned source
        read version (the strict-cut discipline shared with
        BackupAgent.backup via paged_snapshot): returns that version."""
        from .stream import paged_snapshot

        async def wipe(tr):
            tr.lock_aware = True
            tr.clear_range(b"", SYSTEM_PREFIX)
        await self.dest.run(wipe)
        version: Version | None = None
        # columns mode: pages arrive as
        # PackedRows — the packed range replies' columns concatenated,
        # never a tuple list — and each destination chunk is one
        # bounds-rebased slice; rows materialize only at tr.set, where
        # a Mutation needs real bytes anyway
        async for page, version in paged_snapshot(self.src, b"",
                                                  SYSTEM_PREFIX,
                                                  columns=True):
            for start in range(0, len(page), self.rows_per_txn):
                chunk = page.slice(start, start + self.rows_per_txn)

                async def put(tr, chunk=chunk):
                    tr.lock_aware = True
                    for k, v in chunk:
                        tr.set(k, v)
                await self.dest.run(put)
        return version if version is not None else 0

    async def _set_applied_initial(self, v0: Version) -> None:
        async def put(tr):
            tr.lock_aware = True
            tr.set(APPLIED_KEY, b"%d" % v0)
        await self.dest.run(put)

    async def _apply_loop(self) -> None:
        try:
            while True:
                entries, end = await self._stream.next()
                if entries:
                    await self._apply_entries(entries)
                # only popped once applied: a crash between pull and apply
                # re-pulls from the persisted applied frontier
                self.applied_through = max(self.applied_through, end - 1)
                self._stream.pop(self.applied_through)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — a dead apply loop must be loud
            TraceEvent("DrApplyFailed", severity=40) \
                .detail("Error", repr(e)[:200]) \
                .detail("Through", self.applied_through).log()
            raise

    async def _apply_entries(self, entries) -> None:
        """Apply pulled versions to dest, chunked on version boundaries
        (a source transaction is never split across dest transactions),
        guarded by the applied-frontier key against double-apply.  Flushes
        by mutation count AND bytes: one source version never exceeds the
        proxies' COMMIT_BATCH_BYTE_LIMIT (1MB), well under the dest
        transaction size limit, so a version always fits one dest txn."""
        chunk: list[tuple[Version, list]] = []
        nmuts = nbytes = 0
        from ..core.data import MutationBatch
        for v, muts in entries:
            chunk.append((v, muts))
            nmuts += len(muts)
            # packed batches size in O(1); legacy Mutation lists sum
            nbytes += muts.nbytes if isinstance(muts, MutationBatch) \
                else sum(len(m.param1) + len(m.param2) for m in muts)
            if nmuts >= 500 or nbytes >= (1 << 20):
                await self._apply_chunk(chunk)
                chunk, nmuts, nbytes = [], 0, 0
        if chunk:
            await self._apply_chunk(chunk)

    async def _apply_chunk(self, chunk) -> None:
        last = chunk[-1][0]

        async def apply(tr):
            tr.lock_aware = True
            cur = await tr.get(APPLIED_KEY)
            applied = int(cur) if cur is not None else -1
            if applied >= last:
                return
            for v, muts in chunk:
                if v <= applied:
                    continue
                for m in muts:
                    _replay_mutation(tr, m)
            tr.set(APPLIED_KEY, b"%d" % last)
        await self.dest.run(apply)

    # --- observability ---

    async def status(self) -> dict:
        """Lag between the source's committed version and the applied
        frontier (the reference's `fdbdr status` headline number)."""
        tr = self.src.create_transaction()
        tr.lock_aware = True
        while True:
            try:
                src_version = await tr.get_read_version()
                break
            except Exception as e:  # noqa: BLE001 — retry via on_error
                await tr.on_error(e)
        return {
            "running": self._task is not None and not self._task.done(),
            "applied_through": self.applied_through,
            "source_version": src_version,
            "lag_versions": max(0, src_version - self.applied_through),
        }
