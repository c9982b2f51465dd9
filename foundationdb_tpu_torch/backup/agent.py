"""Feed-native backup/restore — whole-database change feeds + packed
snapshot containers + point-in-time restore-to-version.

Reference: REF:fdbclient/FileBackupAgent.actor.cpp +
REF:fdbbackup/backup.actor.cpp — the file backup writes range files (a
consistent cut) plus mutation-log files; restore streams the newest
snapshot at or below the target back in and replays the log window
above it.

This agent is built on the change-feed subsystem, NOT on a
proxy-pushed backup tag:

1. **Snapshot** (``backup()``): every range page read at ONE pinned
   version — a strictly consistent cut — written as packed columnar
   ``.kvr`` files through :class:`BackupContainer`.
2. **Continuous mutation log** (``start_continuous()``): the agent
   registers a WHOLE-DATABASE change feed (``[b"", b"\\xff")`` — system
   writes are excluded at capture) and tails it through
   ``ChangeFeedCursor``.  The cursor inherits everything the feed
   subsystem proved under chaos: the known-committed heartbeat clamp
   (a frontier can never expose applied-but-unacked versions a recovery
   might roll back), exactly-once resume across failovers and DD
   splits/moves, and DiskQueue spill on durable servers.  Entries land
   in crc-framed ``.mlog`` files; the ``logs.manifest`` ``through``
   frontier advances only past fsync'd files and IS the complete resume
   token — a killed agent resumes exactly-once from ``through + 1``
   (``resume_continuous``) with no proxy-side backup tag at all.
   Feed retention is released by popping the feed to the durable
   frontier, so the cluster never holds what the container already has.
3. **Restore-to-version** (``restore(to_version=...)``): newest snapshot
   at or below the target streamed back through normal batched commits,
   then the ``.mlog`` window ``(snapshot_version, target]`` replayed in
   version order.  Feed entries carry RESOLVED atomics (the storage
   apply path captures the effective set/clear), so replay is plain
   sets/clears — deterministic bytes, no atomic re-evaluation.  Every
   chunk is fenced by a restore-progress key: a retry after an
   ambiguous commit skips, and a CRASHED restore re-run with
   ``resume=True`` skips completed chunks idempotently.
"""

from __future__ import annotations

import asyncio

from ..client.database import Database
from ..core.data import SYSTEM_PREFIX, Version
from ..core.system_data import BACKUP_PREFIX, backup_progress_key
from ..rpc.wire import encode
from ..runtime import span as _span
from ..runtime.errors import (ChangeFeedNotRegistered, ChangeFeedPopped,
                              FdbError)
from ..runtime.knobs import KNOBS
from ..runtime.trace import TraceEvent
from .container import BackupContainer

RESTORE_PROGRESS_KEY = BACKUP_PREFIX + b"restore_progress"
# whole-database feed range: the entire user keyspace, \xff-exclusive
WHOLE_DB_BEGIN, WHOLE_DB_END = b"", b"\xff"


class RestoreError(FdbError):
    code = 2380
    name = "restore_error"


def _knobs_of(db):
    k = getattr(getattr(db, "cluster", None), "knobs", None)
    if k is None:
        k = getattr(getattr(db, "view", None), "knobs", None)
    return k or KNOBS


class BackupManifest:
    """One snapshot's description (kept for API/CLI compatibility)."""

    def __init__(self, version: int, range_files: list[str], rows: int,
                 bytes: int, format: int = 2) -> None:  # noqa: A002
        self.version = version
        self.range_files = range_files
        self.rows = rows
        self.bytes = bytes
        self.format = format


class BackupAgent:
    """Feed-native backup/restore over a Database handle + an async fs."""

    def __init__(self, db: Database, fs, directory: str,
                 rows_per_file: int | None = None) -> None:
        self.db = db
        self.fs = fs
        self.dir = directory.rstrip("/")
        self.name = self.dir.rsplit("/", 1)[-1]
        self.knobs = _knobs_of(db)
        self.rows_per_file = rows_per_file or self.knobs.BACKUP_SNAPSHOT_ROWS
        self.container = BackupContainer(fs, self.dir)
        self.feed_id = b"backup:" + self.name.encode()
        self._pull_task: asyncio.Task | None = None
        # mutation-log state (mirrors logs.manifest)
        self._log_begin: Version | None = None   # feed registration version
        self.log_through: Version = 0            # durable frontier (inclusive)
        self._log_files: list[tuple[Version, Version, str]] = []
        self._file_seq = 0
        self._log_stopped = False
        self._expired_before: Version | None = None
        self.bytes_logged = 0
        self.bytes_snapshotted = 0
        self.last_snapshot_version: Version | None = None
        # span roots for the snapshot/log writers:
        # backup agents never run inside a sampled transaction, so they
        # root their own deterministic counter-based server spans
        self.spans = _span.SpanSink("BackupAgent")
        self._sampler = _span.ServerSampler(namespace=4)

    # --- plumbing ---

    async def _grv(self) -> Version:
        tr = self.db.create_transaction()
        tr.lock_aware = True
        while True:
            try:
                v = await tr.get_read_version()
                tr.reset()
                return v
            except asyncio.CancelledError:
                raise
            except BaseException as e:  # noqa: BLE001 — retry via on_error
                await tr.on_error(e)

    async def _save_log_manifest(self) -> None:
        meta = {
            "feed": self.feed_id, "begin": self._log_begin,
            "through": self.log_through,
            "files": [[f, l, n] for f, l, n in self._log_files],
            "bytes": self.bytes_logged, "stopped": self._log_stopped}
        if self._expired_before is not None:
            # the GC marker survives every rewrite: this agent is the
            # manifest's only writer while tailing, so dropping it here
            # would erase the container's record of the expire cut
            meta["expired_before"] = self._expired_before
        await self.container.save_log_manifest(meta)

    def _load_log_state(self, meta: dict) -> None:
        self._log_begin = meta["begin"]
        self.log_through = meta["through"]
        self._log_files = [(f, l, str(n)) for f, l, n in meta["files"]]
        self._file_seq = len(self._log_files)
        self.bytes_logged = meta.get("bytes", 0)
        self._expired_before = meta.get("expired_before")

    async def expire_data_before(self, version: Version) -> dict:
        """GC the container (``BackupContainer.expire_data_before``) AND
        prune this agent's in-memory file mirror to match — THE expire
        surface while a continuous backup is live.  The agent is the
        manifest's only writer while tailing: a container-level expire
        alone would be silently undone by the next flush, which
        serializes ``_log_files`` from memory and would re-name the
        deleted ``.mlog`` bytes."""
        r = await self.container.expire_data_before(version)
        cut = r["kept_snapshot"]
        self._log_files = [(f, l, n) for f, l, n in self._log_files
                           if l > cut]
        self._expired_before = cut
        return r

    # --- continuous mutation log (the whole-db feed tail) ---

    async def start_continuous(self) -> Version:
        """Register the whole-database feed and start tailing it.
        Returns the registration version: every mutation strictly above
        it is captured.  A fresh activation starts a fresh file set (the
        prior activation's files stay on disk but leave the manifest)."""
        if self._pull_task is not None and not self._pull_task.done():
            raise RestoreError("continuous backup already running")
        await self.container.init()
        # destroy any prior incarnation so the re-registration commits a
        # FRESH registration version (re-registering an existing feed is
        # an idempotent no-op server-side — its commit version would NOT
        # be the capture floor)
        await self.db.destroy_change_feed(self.feed_id)
        vb = await self.db.create_change_feed(self.feed_id, WHOLE_DB_BEGIN,
                                              WHOLE_DB_END)
        self._log_begin = vb
        self.log_through = vb
        self._log_files = []
        self._file_seq = 0
        self._log_stopped = False
        self._expired_before = None
        self.bytes_logged = 0
        await self._save_log_manifest()
        self._pull_task = asyncio.get_running_loop().create_task(
            self._pull_loop(), name="backup-feed-tail")
        TraceEvent("BackupContinuousStarted").detail("Version", vb) \
            .detail("Feed", self.feed_id).log()
        return vb

    async def resume_continuous(self) -> Version:
        """Resume a killed agent from the container's durable frontier:
        ``logs.manifest``'s ``through`` is the complete resume token —
        the cursor re-reads nothing at or below it and skips nothing
        above it (the feed's exactly-once contract)."""
        if self._pull_task is not None and not self._pull_task.done():
            raise RestoreError("continuous backup already running")
        meta = await self.container.load_log_manifest()
        if meta is None:
            raise RestoreError("no mutation log to resume in container")
        if meta.get("stopped"):
            raise RestoreError(
                "mutation log was cleanly stopped (its feed is destroyed); "
                "start a fresh backup instead")
        self._load_log_state(meta)
        self.feed_id = bytes(meta["feed"])
        self._log_stopped = False
        # the feed must still exist on THIS cluster: a pull loop started
        # against a missing feed would die with only a trace event while
        # the caller believes capture resumed — the log would grow an
        # uncoverable hole.  Fail loudly instead.
        from ..client.change_feed import _feed_range
        try:
            await _feed_range(self.db, self.feed_id)
        except ChangeFeedNotRegistered:
            raise RestoreError(
                f"cannot resume: feed {self.feed_id!r} is not registered "
                f"on this cluster (container from another cluster, or the "
                f"feed was destroyed externally) — the mutation log has a "
                f"hole; start a fresh backup") from None
        self._pull_task = asyncio.get_running_loop().create_task(
            self._pull_loop(), name="backup-feed-tail")
        TraceEvent("BackupContinuousResumed") \
            .detail("Through", self.log_through) \
            .detail("Feed", self.feed_id).log()
        return self.log_through

    async def stop_continuous(self, drain_timeout: float = 10.0) -> Version:
        """Drain the log through a fresh read version (every commit at
        or below it is then durably in the container), stop the tail,
        and destroy the feed so the cluster releases its retention.
        Returns the drained frontier.

        If the drain TIMES OUT the feed is NOT destroyed and the
        manifest stays resumable: destroying it would irrecoverably
        discard the undrained window ``(log_through, target]`` — the
        caller can compare the returned frontier against its target and
        ``resume_continuous`` to finish, or destroy the feed itself."""
        if self._log_begin is None and self._pull_task is None:
            # never started/resumed on this object: nothing to stop,
            # and saving the manifest here would CLOBBER a crashed
            # incarnation's resumable log state with empty defaults
            return self.log_through
        target = await self._grv()
        deadline = asyncio.get_running_loop().time() + drain_timeout
        drained = True
        while self.log_through < target:
            if self._pull_task is None or self._pull_task.done() \
                    or asyncio.get_running_loop().time() > deadline:
                drained = False
                TraceEvent("BackupDrainTimeout", severity=30) \
                    .detail("Through", self.log_through) \
                    .detail("Target", target).log()
                break
            await asyncio.sleep(0.05)
        if self._pull_task is not None:
            self._pull_task.cancel()
            try:
                await self._pull_task
            except asyncio.CancelledError:
                pass
            self._pull_task = None
        if drained:
            try:
                await self.db.destroy_change_feed(self.feed_id)
            except Exception as e:  # noqa: BLE001 — cluster may be dying
                TraceEvent("BackupFeedDestroyFailed", severity=30) \
                    .detail("Error", repr(e)[:200]).log()
            self._log_stopped = True
        await self._save_log_manifest()
        await self._publish_progress(stopped=drained)
        TraceEvent("BackupContinuousStopped") \
            .detail("Through", self.log_through) \
            .detail("Drained", drained).log()
        return self.log_through

    async def _pull_loop(self) -> None:
        """Tail the whole-db feed; flush entries to crc-framed .mlog
        files; advance + persist the resume frontier only past durable
        files; pop the feed behind the frontier.

        Failure discipline: any error (fs write, feed poll) discards the
        unwritten buffer and REBUILDS the cursor from ``log_through + 1``
        — the feed re-delivers exactly the unpersisted span, so a write
        failure can never skip or double a mutation."""
        k = self.knobs
        loop = asyncio.get_running_loop()
        buf: list[tuple[Version, object]] = []
        last_flush = loop.time()
        last_pub = 0.0
        cur = self.db.read_change_feed(self.feed_id,
                                       begin_version=self.log_through + 1)
        while True:
            try:
                entries = await cur.next()
                buf.extend(entries)
                frontier = cur.version - 1
                now = loop.time()
                if buf and (len(buf) >= k.BACKUP_LOG_FLUSH_ENTRIES
                            or not entries
                            or now - last_flush
                            >= k.BACKUP_LOG_FLUSH_INTERVAL):
                    await self._flush(buf, frontier)
                    buf = []
                    last_flush = now
                elif not buf and frontier - self.log_through \
                        >= k.BACKUP_HEARTBEAT_VERSIONS:
                    # quiet feed: persist the proven-empty frontier so a
                    # resumed agent re-scans a bounded window
                    self.log_through = frontier
                    await self._save_log_manifest()
                    await self.db.pop_change_feed(self.feed_id,
                                                  self.log_through)
                if k.BACKUP_PROGRESS_PUBLISH \
                        and now - last_pub >= k.BACKUP_PROGRESS_INTERVAL:
                    last_pub = now
                    await self._publish_progress()
            except asyncio.CancelledError:
                raise
            except (ChangeFeedNotRegistered, ChangeFeedPopped) as e:
                # the feed is gone (destroyed externally) or the cluster
                # popped past our frontier — either way this tail cannot
                # continue exactly-once; fail loudly and stop
                TraceEvent("BackupFeedLost", severity=40) \
                    .detail("Error", type(e).__name__) \
                    .detail("Through", self.log_through).log()
                return
            except Exception as e:  # noqa: BLE001 — fs/cluster trouble:
                # re-pull the unpersisted span through a fresh cursor
                TraceEvent("BackupPullError", severity=30) \
                    .detail("Error", repr(e)[:200]) \
                    .detail("Through", self.log_through).log()
                buf = []
                await asyncio.sleep(0.25)
                cur = self.db.read_change_feed(
                    self.feed_id, begin_version=self.log_through + 1)

    async def _flush(self, buf: list, frontier: Version) -> None:
        """One durable .mlog flush: file fsync'd FIRST, then the manifest
        (with the advanced frontier) fsync'd, then the feed popped —
        crash between any two steps re-delivers, never loses."""
        first, last = buf[0][0], buf[-1][0]
        ctx = self._sampler.root(self.knobs.SERVER_SPAN_SAMPLE)
        self.spans.event("TransactionDebug", ctx,
                         "BackupAgent.logFile.Before",
                         First=first, Last=last, Entries=len(buf))
        try:
            name, nbytes = await self.container.write_log_file(
                first, last, self._file_seq, buf)
            self._file_seq += 1
            self._log_files.append((first, last, name))
            self.bytes_logged += nbytes
            self.log_through = max(self.log_through, frontier)
            await self._save_log_manifest()
            with _span.child_scope(ctx):
                await self.db.pop_change_feed(self.feed_id, self.log_through)
        except BaseException as e:
            self.spans.event("TransactionDebug", ctx,
                             "BackupAgent.logFile.Error",
                             Error=type(e).__name__)
            raise
        self.spans.event("TransactionDebug", ctx,
                         "BackupAgent.logFile.After",
                         Through=self.log_through, Bytes=nbytes)

    async def _publish_progress(self, stopped: bool = False) -> None:
        """``\\xff/backup/progress/<name>`` state transaction: the status
        aggregator's cluster.backup rollup reads these (frontiers, bytes,
        liveness via at_version vs the read version)."""
        tr = self.db.create_transaction()
        tr.lock_aware = True
        while True:
            try:
                tr.set(backup_progress_key(self.name), encode({
                    "log_through": self.log_through,
                    "log_begin": self._log_begin,
                    "snapshot_version": self.last_snapshot_version,
                    "bytes_logged": self.bytes_logged,
                    "bytes_snapshotted": self.bytes_snapshotted,
                    "stopped": stopped}))
                await tr.commit()
                return
            except asyncio.CancelledError:
                raise
            except BaseException as e:  # noqa: BLE001 — retry via on_error
                try:
                    await tr.on_error(e)
                except asyncio.CancelledError:
                    # the pull task is being cancelled mid-backoff: the
                    # cancellation is delivered ONCE — swallowing it here
                    # would leave stop_continuous awaiting the task forever
                    raise
                except BaseException:
                    return          # progress is best-effort observability

    # --- snapshot backup ---

    async def backup(self, begin: bytes = b"",
                     end: bytes = SYSTEM_PREFIX) -> BackupManifest:
        """Write one consistent packed snapshot of [begin, end) into the
        container (files first, manifest last).  Every page is read at
        ONE read version, so a transaction is either entirely in the
        snapshot or entirely absent.  A container holds many snapshots;
        restore picks the newest at or below its target."""
        from .stream import paged_snapshot
        await self.container.init()
        version: int | None = None
        files: list[str] = []
        rows = nbytes = 0
        idx = 0
        ctx = self._sampler.root(self.knobs.SERVER_SPAN_SAMPLE)
        # columns=True: pages arrive as the packed range replies'
        # columns and reach the .kvr frame with no tuple-list round
        # trip (byte-identical files, tested)
        async for page, version in paged_snapshot(self.db, begin, end,
                                                  self.rows_per_file,
                                                  columns=True):
            if not page:
                break
            self.spans.event("TransactionDebug", ctx,
                             "BackupAgent.snapshotFile.Before",
                             Version=version, Index=idx, Rows=len(page))
            try:
                name, n = await self.container.write_snapshot_page(
                    version, idx, page)
            except BaseException as e:
                self.spans.event("TransactionDebug", ctx,
                                 "BackupAgent.snapshotFile.Error",
                                 Error=type(e).__name__)
                raise
            self.spans.event("TransactionDebug", ctx,
                             "BackupAgent.snapshotFile.After",
                             Index=idx, Bytes=n)
            idx += 1
            files.append(name)
            rows += len(page)
            nbytes += n
        await self.container.finish_snapshot(version or 0, files, rows,
                                             nbytes)
        self.last_snapshot_version = version or 0
        self.bytes_snapshotted += nbytes
        TraceEvent("BackupComplete").detail("Version", version or 0) \
            .detail("Rows", rows).detail("Files", len(files)).log()
        return BackupManifest(version or 0, files, rows, nbytes)

    # --- restore-to-version ---

    async def restore(self, clear_first: bool = True,
                      begin: bytes = b"",
                      end: bytes = SYSTEM_PREFIX,
                      to_version: Version | None = None,
                      resume: bool = False) -> BackupManifest:
        """Point-in-time restore: the newest snapshot at or below the
        target streamed in through batched commits, then the .mlog
        window ``(snapshot_version, target]`` replayed in version order.
        With ``to_version`` None the target is the log's drained
        frontier (or the newest snapshot when no log exists).

        Idempotent resume: every chunk (the wipe included) is fenced by
        a restore-progress key.  A fresh call clears stale progress
        first; ``resume=True`` instead SKIPS chunks a crashed earlier
        run already committed — the chunk plan is deterministic from the
        container contents, so the fence indices line up."""
        snaps = await self.container.list_snapshots()
        if not snaps:
            raise RestoreError("no snapshot manifest in backup container")
        log = await self.container.load_log_manifest()
        if to_version is None:
            snap = snaps[-1]
            vt = max(snap["version"], log["through"] if log else 0)
        else:
            vt = to_version
            snap = await self.container.latest_snapshot_at_or_below(vt)
            if snap is None:
                raise RestoreError(
                    f"no snapshot at or below target {vt} "
                    f"(earliest is {snaps[0]['version']})")
        snap_v = snap["version"]
        replay = vt > snap_v
        if replay:
            if log is None:
                raise RestoreError("to_version given but no mutation log")
            if log["begin"] > snap_v:
                if to_version is not None:
                    raise RestoreError(
                        f"log begins at {log['begin']}, after snapshot "
                        f"{snap_v}: coverage hole ({snap_v}, "
                        f"{log['begin']}]")
                TraceEvent("RestoreLogsSkipped", severity=30) \
                    .detail("LogBegin", log["begin"]) \
                    .detail("SnapshotVersion", snap_v).log()
                replay = False
                vt = snap_v
            elif log["through"] < vt:
                raise RestoreError(
                    f"log covers through {log['through']}, wanted {vt}")

        # the chunk plan's identity: a stored progress index is only
        # meaningful under the SAME deterministic plan (same snapshot,
        # same target, same wipe, same file list).  A resume against a
        # different plan — a new to_version, a snapshot that landed
        # since — would otherwise skip chunks whose content was never
        # applied, silently.
        import hashlib as _hashlib
        plan_id = _hashlib.sha256(repr(
            (snap_v, vt, bool(clear_first), begin, end,
             [str(n) for n in snap["files"]])).encode()).hexdigest()[:16]
        plan_tag = plan_id.encode()

        ctx = self._sampler.root(self.knobs.SERVER_SPAN_SAMPLE)
        self.spans.event("TransactionDebug", ctx,
                         "BackupAgent.restore.Before",
                         SnapshotVersion=snap_v, ToVersion=vt,
                         Resume=resume)
        token = _span.activate(ctx) if ctx is not None else None
        try:
            def parse_progress(raw) -> int:
                """-1 unless ``raw`` carries THIS plan's fence."""
                if raw is None:
                    return -1
                tag, _, n = bytes(raw).partition(b":")
                return int(n) if tag == plan_tag and n else -1

            done_idx = -1
            if resume:
                done_idx = parse_progress(
                    await self.db.get(RESTORE_PROGRESS_KEY))
            else:
                async def pre(tr):
                    tr.clear(RESTORE_PROGRESS_KEY)
                await self.db.run(pre)
            idx = 0

            async def fence_run(idx, apply_ops):
                """One fenced chunk transaction (skips when a crashed
                run, or an ambiguous-commit retry, already did it —
                under the same plan; a stale fence from a DIFFERENT
                plan never skips)."""
                async def go(tr):
                    cur = parse_progress(
                        await tr.get(RESTORE_PROGRESS_KEY))
                    if cur >= idx:
                        return
                    apply_ops(tr)
                    tr.set(RESTORE_PROGRESS_KEY,
                           plan_tag + b":%d" % idx)
                await self.db.run(go)

            # chunk 0: the wipe (fenced too — a resumed restore must
            # never re-wipe rows already restored)
            if clear_first:
                if idx > done_idx:
                    await fence_run(idx, lambda tr:
                                    tr.clear_range(begin, end))
                idx += 1

            # snapshot chunks, one page file at a time
            restored = 0
            for name in snap["files"]:
                _v, rows = await self.container.read_snapshot_page(name)
                restored += len(rows)
                for start in range(0, len(rows), 200):
                    chunk = rows[start:start + 200]
                    if idx > done_idx:
                        def put(tr, chunk=chunk):
                            for kk, vv in chunk:
                                tr.set(kk, vv)
                        await fence_run(idx, put)
                    idx += 1
            if restored != snap["rows"]:
                raise RestoreError(
                    f"snapshot manifest promises {snap['rows']} rows, "
                    f"container holds {restored}")

            # mutation-log replay window (snap_v, vt]
            replayed = 0
            if replay:
                by_version: dict[int, list] = {}
                for first, last, name in log["files"]:
                    if last <= snap_v or first > vt:
                        continue
                    for v, mb in await self.container.read_log_file(
                            str(name)):
                        if snap_v < v <= vt:
                            # a version's shards may arrive as several
                            # disjoint batches: CONCATENATE, never
                            # replace
                            by_version.setdefault(v, []).extend(
                                mb.iter_ops())
                chunks: list[list] = [[]]
                for v in sorted(by_version):
                    chunks[-1].extend(by_version[v])
                    if len(chunks[-1]) >= 500:
                        chunks.append([])
                for chunk in (c for c in chunks if c):
                    if idx > done_idx:
                        def apply_muts(tr, chunk=chunk):
                            for t, p1, p2 in chunk:
                                self._replay_op(tr, t, p1, p2)
                        await fence_run(idx, apply_muts)
                    replayed += len(chunk)
                    idx += 1

            async def done(tr):
                tr.clear(RESTORE_PROGRESS_KEY)
            await self.db.run(done)
        except BaseException as e:
            self.spans.event("TransactionDebug", ctx,
                             "BackupAgent.restore.Error",
                             Error=type(e).__name__)
            if token is not None:
                _span.deactivate(token)
                token = None
            raise
        if token is not None:
            _span.deactivate(token)
        self.spans.event("TransactionDebug", ctx,
                         "BackupAgent.restore.After",
                         Rows=restored, Replayed=replayed)
        TraceEvent("RestoreComplete").detail("Rows", restored) \
            .detail("Replayed", replayed).detail("ToVersion", vt) \
            .detail("SnapshotVersion", snap_v).log()
        return BackupManifest(snap_v, [str(n) for n in snap["files"]],
                              snap["rows"], snap["bytes"])

    @staticmethod
    def _replay_op(tr, t: int, p1: bytes, p2: bytes) -> None:
        """Feed entries hold only resolved SET/CLEAR ops, clipped to the
        user keyspace at capture; the clips here are defense in depth."""
        if t == 1:                               # CLEAR_RANGE
            e = min(p2, SYSTEM_PREFIX)
            if p1 < e:
                tr.clear_range(p1, e)
        elif t == 0 and p1 < SYSTEM_PREFIX:      # SET_VALUE
            tr.set(p1, p2)
