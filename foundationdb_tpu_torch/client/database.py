"""Database handle + the retry-loop helper every binding exposes.

Reference: REF:fdbclient/NativeAPI.actor.h (Database/DatabaseContext) and
the ``db.run``/``@fdb.transactional`` pattern from
REF:bindings/python/fdb/impl.py — run a function against a fresh
transaction, commit, and loop through ``on_error`` on retryable failures.
"""

from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Callable

from ..core.cluster import Cluster
from ..core.data import Version
from .transaction import Transaction


class Database:
    def __init__(self, cluster: Cluster) -> None:
        self.cluster = cluster

    def create_transaction(self) -> Transaction:
        return Transaction(self.cluster)

    async def run(self, fn: Callable[[Transaction], Awaitable[Any]],
                  max_retries: int | None = None) -> Any:
        """The @transactional retry loop: fn(tr) then commit; retryable
        errors reset and re-run fn.  fn must be idempotent across retries
        (same contract as the reference)."""
        tr = self.create_transaction()
        attempts = 0
        while True:
            try:
                result = await fn(tr)
                await tr.commit()
                return result
            except BaseException as e:
                attempts += 1
                if max_retries is not None and attempts > max_retries:
                    raise
                await tr.on_error(e)   # re-raises if not retryable

    # --- one-shot conveniences ---

    async def get(self, key: bytes) -> bytes | None:
        return await self.run(lambda tr: tr.get(key))

    async def set(self, key: bytes, value: bytes) -> Version:
        async def go(tr: Transaction):
            tr.set(key, value)
        await self.run(go)
        return 0

    async def clear(self, key: bytes) -> None:
        async def go(tr: Transaction):
            tr.clear(key)
        await self.run(go)

    async def clear_range(self, begin: bytes, end: bytes) -> None:
        async def go(tr: Transaction):
            tr.clear_range(begin, end)
        await self.run(go)

    async def get_range(self, begin, end, limit: int = 0,
                        reverse: bool = False) -> list[tuple[bytes, bytes]]:
        return await self.run(lambda tr: tr.get_range(begin, end, limit, reverse))

    # --- change feeds (see client/change_feed.py) ---

    async def create_change_feed(self, feed_id: bytes, begin: bytes = b"",
                                 end: bytes = b"\xff") -> Version:
        """Register a feed over [begin, end); returns the registration's
        commit version (mutations strictly above it flow in).  The
        default range is the WHOLE user keyspace, \\xff-exclusive: system
        writes never enter a feed."""
        from .change_feed import create_change_feed
        return await create_change_feed(self, feed_id, begin, end)

    async def destroy_change_feed(self, feed_id: bytes) -> None:
        from .change_feed import destroy_change_feed
        await destroy_change_feed(self, feed_id)

    async def pop_change_feed(self, feed_id: bytes, version: Version) -> None:
        """Durably release feed data at or below ``version``."""
        from .change_feed import pop_change_feed
        await pop_change_feed(self, feed_id, version)

    def read_change_feed(self, feed_id: bytes, begin_version: Version = 0,
                         begin: bytes | None = None,
                         end: bytes | None = None):
        """A ChangeFeedCursor resuming at ``begin_version`` (exclusive of
        already-processed versions; pass 0 to start from registration)."""
        from .change_feed import ChangeFeedCursor
        return ChangeFeedCursor(self, feed_id, begin_version, begin, end)

    # --- feed-native backup / point-in-time restore ---

    def _backup_agents(self) -> dict:
        agents = getattr(self, "_backup_agents_by_dir", None)
        if agents is None:
            agents = self._backup_agents_by_dir = {}
        return agents

    async def start_backup(self, fs, directory: str,
                           snapshot: bool = True):
        """Start a feed-native backup into ``directory`` on ``fs``: arm
        the whole-database change-feed tail (the continuous mutation
        log) and, with ``snapshot``, write an initial consistent
        snapshot under it.  Returns the BackupAgent (kept on this
        handle for stop_backup).  A container holding a prior agent's
        mutation log is RESUMED exactly-once from its durable frontier
        instead of restarted."""
        from ..backup.agent import BackupAgent
        agent = BackupAgent(self, fs, directory)
        meta = await agent.container.load_log_manifest()
        if meta is not None and not meta.get("stopped", False):
            await agent.resume_continuous()
        else:
            await agent.start_continuous()
        # registered BEFORE the snapshot so a failed snapshot never
        # leaves a running tail the API cannot reach
        self._backup_agents()[agent.dir] = agent
        if snapshot:
            try:
                await agent.backup()
            except BaseException:
                # unwind the tail WITHOUT destroying the feed or the
                # manifest: the container stays resumable (a retry of
                # start_backup resumes it exactly-once) and the feed's
                # retention is released then — destroying here would
                # hole a resumed log irrecoverably
                if agent._pull_task is not None:
                    agent._pull_task.cancel()
                    try:
                        await agent._pull_task
                    except (asyncio.CancelledError, Exception):  # noqa: BLE001
                        pass
                    agent._pull_task = None
                self._backup_agents().pop(agent.dir, None)
                raise
        return agent

    async def stop_backup(self, directory: str,
                          drain_timeout: float = 10.0) -> Version:
        """Drain and stop the backup running into ``directory``;
        returns the drained log frontier (every commit at or below it
        is durably in the container)."""
        agent = self._backup_agents().get(directory.rstrip("/"))
        if agent is None:
            from ..backup.agent import RestoreError
            raise RestoreError(f"no backup running into {directory!r}")
        return await agent.stop_continuous(drain_timeout=drain_timeout)

    async def restore(self, fs, directory: str,
                      to_version: Version | None = None,
                      resume: bool = False):
        """Point-in-time restore from the container in ``directory``:
        the newest snapshot at or below ``to_version`` plus the .mlog
        replay window above it (see BackupAgent.restore)."""
        from ..backup.agent import BackupAgent
        agent = BackupAgent(self, fs, directory)
        return await agent.restore(to_version=to_version, resume=resume)
