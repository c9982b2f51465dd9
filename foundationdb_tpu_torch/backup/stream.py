"""TagStream — a recovery-resilient, ack-safe cursor over a mutation tag.

Reference: the pull half of REF:fdbserver/BackupWorker.actor.cpp /
REF:fdbclient/DatabaseBackupAgent.actor.cpp — an agent subscribed to a
backup mutation tag pulls it from the TLogs exactly like a storage server
pulls its own tag, and must survive recoveries by re-reading the
published cluster state and rolling its cursor into the new log
generation.

**Ack safety.** A TLog peek can return versions that were pushed but
never fully replicated/acked; a recovery may roll those back (clients
saw commit_unknown_result).  Storage servers handle this with rollback at
rejoin; an external consumer (DR destination, backup file) has no
rollback, so TagStream must never emit them.  The gate (the
minKnownCommittedVersion discipline of REF:fdbserver/TLogServer.actor.cpp
peeks, implemented here with a confirm round instead of peek piggyback):

- entries at versions <= the view's CURRENT generation begin come from
  sealed (locked) generations, whose retained prefix is definitionally
  committed — safe;
- entries above it are confirmed against a source read version (GRV):
  v <= GRV implies v was acked (pushes ack only when every hosting log
  acked, and TLog version chains are gap-free, so a committed version
  subsumes everything below it) and an acked version survives every
  future recovery;
- the GRV is validated by re-reading the published epoch AFTER it: if
  the epoch moved since this view was built, the unconfirmed tail may
  have been rolled back — it is discarded and the cursor re-pulled from
  the new view (whose sealed-generation clamps drop exactly the
  rolled-back versions).  A GRV can only validate pulls from its own
  regime, never a phantom from before a recovery.

The emitted frontier (``end_version - 1``) is clamped the same way, so a
consumer persisting it as "applied through" can never skip real commits
that land numerically below a rolled-back peek tip.

Used by the DR agent and the LogRouter (so every router consumer
inherits safety).  The file-backup agent no longer pulls a tag at all —
it tails a whole-database CHANGE FEED whose cursor
provides the same ack-safety through the known-committed heartbeat
clamp (see backup/agent.py); TagStream remains the raw-tag path for
cluster-to-cluster DR.  The arm/disarm state transaction
(`commit_tag`) is shared by every tag producer.
"""

from __future__ import annotations

import asyncio

from ..core.data import Version
from ..core.system_data import backup_tag_key
from ..runtime.trace import TraceEvent


async def log_view(db):
    """A LogSystem view over the TLogs named by the freshest published
    cluster state — rebuilt by pullers whenever a recovery invalidates
    the old generation.  Returns (log_system, epoch, current_gen_begin)."""
    from ..core.cluster_client import fetch_cluster_state
    from ..core.log_system import LogSystem
    from ..core.worker import generations_from_config
    state = await fetch_cluster_state(db.coordinators)
    gens = generations_from_config(state["log_cfg"], db.view.transport, 0)
    return (LogSystem(gens), state["epoch"],
            state["log_cfg"][-1]["begin"])


async def paged_snapshot(db, begin: bytes, end: bytes,
                         page_size: int = 1000, columns: bool = False):
    """Async generator of (page, version): every page of [begin, end)
    read at ONE pinned read version (grabbed from the first transaction,
    pinned with set_read_version on the rest) — a strict cut; a
    transaction is either entirely in the snapshot or entirely absent.
    Shared by BackupAgent.backup (writes files) and DRAgent's initial
    copy (writes the destination).

    ``columns=True`` yields each page as a ``PackedRows`` — the packed
    range replies' columns concatenated, never a tuple list;
    the rows are byte-identical either way and the page keeps the
    ``len``/``[-1][0]`` row surface the cursor advance uses."""
    from ..runtime.errors import FdbError
    version: Version | None = None
    cursor = begin
    while True:
        tr = db.create_transaction()
        tr.lock_aware = True
        while True:
            try:
                if version is not None:
                    tr.set_read_version(version)
                if columns:
                    page = await tr.get_range_packed(cursor, end,
                                                     limit=page_size)
                else:
                    page = await tr.get_range(cursor, end, limit=page_size,
                                              snapshot=True)
                if version is None:
                    version = await tr.get_read_version()
                break
            except FdbError as e:
                await tr.on_error(e)
        # the version is pinned by the SAME transaction as the first page
        # read (even an empty one), so an empty source still gets a
        # consistent cut version — always yielded at least once
        yield page, version
        if len(page) < page_size:
            break
        cursor = bytes(page[-1][0]) + b"\x00"


async def commit_tag(db, name: str, value: bytes | None) -> Version:
    """Arm (value = encode(tag)) or disarm (None) the named mutation-log
    tag via the ``\\xff/backup/`` state transaction; returns the commit
    version.  Lock-aware: tag maintenance must work on a locked database
    (DR switchover disarms its source tag under the lock)."""
    tr = db.create_transaction()
    tr.lock_aware = True
    key = backup_tag_key(name)
    while True:
        try:
            if value is None:
                tr.clear(key)
            else:
                tr.set(key, value)
            return await tr.commit()
        except Exception as e:  # noqa: BLE001 — retry via on_error
            await tr.on_error(e)


class TagStream:
    """Iterate (entries, end_version) over a tag, across recoveries.

    ``next()`` blocks until the stream progresses: it returns a possibly
    empty entry list only when ``end_version`` advanced past the last
    returned frontier (empty commit batches advance it while the cluster
    is live), so callers can use ``end_version - 1`` as a drained
    frontier even when no tagged mutations exist.  Everything returned —
    entries and frontier alike — is ack-confirmed (see module docstring).
    """

    def __init__(self, db, tag: int, begin: Version) -> None:
        self.db = db
        self.tag = tag
        self.frontier: Version = begin - 1     # pulled through (inclusive)
        self._safe: Version = begin - 1        # ack-confirmed through
        self._ls = None
        self._cursor = None
        self.view_epoch: int | None = None
        self.current_gen_begin: Version = 0

    async def _view(self):
        """Rebuild the TLog view from the freshest published state."""
        self._ls, self.view_epoch, self.current_gen_begin = \
            await log_view(self.db)
        self._cursor = self._ls.cursor(self.tag, self.frontier + 1)

    async def _confirm(self) -> tuple[Version, int]:
        """(source read version, published epoch) — epoch read AFTER the
        GRV so epoch equality proves the GRV predates any recovery."""
        from ..core.cluster_client import fetch_cluster_state
        tr = self.db.create_transaction()
        tr.lock_aware = True
        while True:
            try:
                g = await tr.get_read_version()
                break
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — retry via on_error
                await tr.on_error(e)
        state = await fetch_cluster_state(self.db.coordinators)
        return g, state["epoch"]

    async def next(self) -> tuple[list[tuple[Version, list]], Version]:
        """The next ack-safe span: ([(version, mutations), ...],
        end_version), every entry version > the previous frontier."""
        while True:
            try:
                if self._cursor is None:
                    await self._view()
                reply = await self._cursor.next()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — recovery/partition: re-view
                TraceEvent("TagStreamError", severity=20) \
                    .detail("Tag", self.tag) \
                    .detail("Error", repr(e)[:200]) \
                    .detail("Through", self.frontier).log()
                self._cursor = None
                await asyncio.sleep(0.25)
                continue
            if not reply.entries and reply.end_version - 1 <= self.frontier:
                # no progress: idle, or a recovery locked this generation
                # and our view predates it (a locked log answers peeks
                # immediately with an unmoving tip) — re-view so the
                # cursor rolls into the new generation when there is one
                await asyncio.sleep(0.25)
                self._cursor = None
                continue
            # ---- ack-safety gate ----
            cap = max(self.current_gen_begin, self._safe)
            if reply.end_version - 1 > cap:
                g, epoch = await self._confirm()
                if epoch != self.view_epoch:
                    # a recovery slipped in since this view was built:
                    # the unconfirmed part of this reply may be rolled
                    # back — drop the whole reply and re-pull through
                    # the new view's sealed-generation clamps
                    TraceEvent("TagStreamEpochRoll") \
                        .detail("Tag", self.tag) \
                        .detail("ViewEpoch", self.view_epoch) \
                        .detail("NowEpoch", epoch).log()
                    self._cursor = None
                    continue
                self._safe = max(self._safe, g)
                cap = max(self.current_gen_begin, self._safe)
            entries = [(v, m) for v, m in reply.entries if v <= cap]
            end = min(reply.end_version, cap + 1)
            if not entries and end - 1 <= self.frontier:
                # everything in this reply is still unconfirmed
                # (mid-push tail): wait for acks (or a recovery) rather
                # than emit maybe-rolled-back versions
                await asyncio.sleep(0.05)
                self._rewind_cursor(self.frontier + 1)
                continue
            if end < reply.end_version:
                # re-pull the withheld tail next round
                self._rewind_cursor(end)
            self.frontier = max(self.frontier, end - 1)
            return entries, end

    def _rewind_cursor(self, version: Version) -> None:
        if self._cursor is not None:
            self._cursor.version = version

    def rewind(self, to_frontier: Version) -> None:
        """Step the stream back so versions > ``to_frontier`` are pulled
        again (a consumer failed to persist what it was handed)."""
        self.frontier = min(self.frontier, to_frontier)
        self._rewind_cursor(self.frontier + 1)

    def pop(self, through: Version) -> None:
        """Release the tag's frames <= ``through`` on the TLogs (the
        caller has made them durable elsewhere)."""
        if self._ls is not None:
            self._ls.pop(self.tag, through + 1)
