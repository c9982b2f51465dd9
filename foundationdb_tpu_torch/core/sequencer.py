"""The sequencer (master) role — the cluster's single version authority.

Reference: REF:fdbserver/masterserver.actor.cpp — ``getVersion`` hands out
monotonically increasing commit versions advancing at ~VERSIONS_PER_SECOND
with wall time, and each assignment records the *previous* assigned
version so downstream roles (resolvers, TLogs) can process batches in
exact version order even when multiple proxies race
(GetCommitVersionRequest / prevVersion chaining).
"""

from __future__ import annotations

import asyncio

from ..runtime.errors import _err
from ..runtime.knobs import Knobs
from .data import Version

SequencerDeposed = _err(1191, "sequencer_deposed",
                        "Sequencer was locked by a newer epoch's recovery")


class Sequencer:
    def __init__(self, knobs: Knobs, epoch_begin_version: Version = 0,
                 db_lock_uid: bytes | None = None) -> None:
        self.knobs = knobs
        self._last_assigned: Version = epoch_begin_version
        self._committed: Version = epoch_begin_version
        self._base_version = epoch_begin_version
        self._base_time: float | None = None
        self._committed_waiters: list[tuple[Version, asyncio.Future]] = []
        self.locked = False
        # database-lock register: the sequencer is the hub BOTH proxy
        # kinds already round-trip, so commit proxies report lock-state
        # flips here and GRV proxies learn them with every batch — read
        # fencing without a new gossip path (the reference piggybacks
        # `locked` on GetReadVersionReply the same way).  Seeded from the
        # recovery's \xff read; versioned so stale reports can't regress.
        self._db_lock: tuple[Version, bytes | None] = (-1, db_lock_uid)
        self._msource = None

    async def metrics(self) -> dict:
        """Version-authority frontiers for status and the cluster.lag
        rollup: the assigned and committed frontiers are the
        top of every lag computation — storage durability lag is
        measured against the committed tip this role owns."""
        return {
            "last_assigned": self._last_assigned,
            "committed": self._committed,
            "locked": self.locked,
        }

    def metrics_source(self):
        """This role's registration in the per-worker MetricsRegistry: the
        version clock itself, recorded every interval —
        the reference frontier every other role's lag is read against."""
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("Sequencer")
            s.gauge("LastAssigned", lambda: self._last_assigned)
            s.gauge("Committed", lambda: self._committed)
            s.gauge("Locked", lambda: int(self.locked))
            self._msource = s
        return self._msource

    # --- epoch fencing ---

    async def lock(self) -> Version:
        """Fence a deposed sequencer (recovery calls this while locking the
        old TLog generation): no further commit versions are assigned and
        no further read versions are served — a GRV from a stale sequencer
        after a newer epoch committed elsewhere would be a stale-read hole.
        Commits in flight can't ack anyway (their generation's logs are
        locked); this closes the read side too."""
        self.locked = True
        for _, fut in self._committed_waiters:
            if not fut.done():
                fut.set_exception(SequencerDeposed())
        self._committed_waiters.clear()
        return self._last_assigned

    def _check_locked(self) -> None:
        if self.locked:
            raise SequencerDeposed()

    # --- commit version assignment (GetCommitVersionRequest) ---

    async def get_commit_version(self) -> tuple[Version, Version]:
        """Returns (prev_version, version) for one commit batch."""
        self._check_locked()
        loop = asyncio.get_running_loop()
        if self._base_time is None:
            self._base_time = loop.time()
        wall = self._base_version + int(
            (loop.time() - self._base_time) * self.knobs.VERSIONS_PER_SECOND)
        prev = self._last_assigned
        version = max(prev + 1, wall)
        self._last_assigned = version
        return prev, version

    # --- committed-version tracking (for GRV) ---

    def report_committed(self, version: Version) -> None:
        if version > self._committed:
            self._committed = version
            still = []
            for target, fut in self._committed_waiters:
                if version >= target and not fut.done():
                    fut.set_result(version)
                elif not fut.done():
                    still.append((target, fut))
            self._committed_waiters = still

    def report_lock(self, version: Version, uid: bytes | None) -> None:
        """A commit proxy applied a \\xff/dbLocked flip at ``version``."""
        if version > self._db_lock[0]:
            self._db_lock = (version, uid)

    async def get_live_committed_version(self) -> tuple[Version,
                                                        bytes | None]:
        """(version, db_lock_uid) a GRV proxy may serve as a read version
        (getLiveCommittedVersion in the reference; the lock rides the
        reply like GetReadVersionReply.locked).  Raises once the
        sequencer is deposed (locked by a newer epoch's recovery)."""
        self._check_locked()
        return self._committed, self._db_lock[1]

    async def wait_committed(self, version: Version) -> Version:
        if self._committed >= version:
            return self._committed
        fut = asyncio.get_running_loop().create_future()
        self._committed_waiters.append((version, fut))
        return await fut

    @property
    def committed_version(self) -> Version:
        return self._committed
