"""The log system — replicated, generational routing over TLogs.

Reference: REF:fdbserver/TagPartitionedLogSystem.actor.cpp +
REF:fdbserver/LogSystem.h — the commit proxy does not talk to individual
TLogs; it pushes through a LogSystem that (a) replicates each tag's
messages onto ``LOG_REPLICATION`` logs so a single TLog death loses no
acked commit, and (b) remembers *old generations* after a recovery so
storage servers can still peek history the new generation does not carry.

Generation semantics (the epoch/locking dance of REF:fdbserver/
masterserver.actor.cpp recovery):

- exactly one generation is *current* (unlocked); pushes go only there;
- recovery locks the old generation's surviving TLogs, computes
  ``recovery_version`` = min(tip over surviving logs) — every acked
  commit is ≤ that tip on *every* log because pushes ack only when all
  logs acked — and starts a new generation at that version;
- entries above a locked generation's end are unacked leftovers of
  half-pushed batches and are clamped out of every peek (their clients
  saw commit_unknown_result, so discarding is a legal outcome);
- a generation whose every hosting log for some tag is dead means real
  data loss; recovery must refuse rather than serve a gap (the
  ``log_data_loss`` error).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..runtime.errors import FdbError, LogDataLoss
from .data import Version
from .tlog import TLogPeekReply, TLogPushRequest, Tag


@dataclasses.dataclass
class LogGeneration:
    """One epoch's set of TLogs.  ``tlogs`` entries are TLog objects
    in-process or TLogClient stubs over RPC — same surface either way.
    ``end_version`` is None while current, else the generation's
    recovery_version: no entry above it is ever served.

    ``satellites`` are SYNCHRONOUS all-tag replica logs in the primary
    region's satellite DC (REF:fdbserver/TagPartitionedLogSystem.actor.cpp
    satellite TLogs): every push replicates the whole tagged batch to
    each satellite and acks only when they acked too, so losing the
    entire primary DC loses no acked commit — recovery locks the
    satellites and every tag peeks from them."""
    epoch: int
    begin_version: Version
    tlogs: list
    replication: int = 2
    end_version: Version | None = None
    dead: set[int] = dataclasses.field(default_factory=set)  # tlog indices
    satellites: list = dataclasses.field(default_factory=list)
    sat_dead: set[int] = dataclasses.field(default_factory=set)
    # per-tag log-router feeds (REF:fdbserver/LogRouter.actor.cpp): a
    # remote-region consumer of ``tag`` peeks its router FIRST so one
    # upstream pull serves the region; main logs remain the fallback, so
    # a dead router degrades to direct peeks instead of stalling
    routers: dict = dataclasses.field(default_factory=dict)

    def logs_for_tag(self, tag: Tag) -> list[int]:
        n = len(self.tlogs)
        k = max(1, min(self.replication, n))
        return [(tag + i) % n for i in range(k)]

    def live_logs_for_tag(self, tag: Tag) -> list[int]:
        return [i for i in self.logs_for_tag(tag) if i not in self.dead]

    def live_satellites(self) -> list[int]:
        return [i for i in range(len(self.satellites))
                if i not in self.sat_dead]


class LogSystem:
    """Push to the current generation; peek/pop across all of them."""

    def __init__(self, generations: Sequence[LogGeneration]) -> None:
        assert generations, "log system needs at least one generation"
        self.generations = list(generations)   # oldest → newest

    @classmethod
    def single(cls, tlogs: list, replication: int,
               begin_version: Version = 0, epoch: int = 0) -> "LogSystem":
        """The common case: one live generation over these logs."""
        return cls([LogGeneration(
            epoch=epoch, begin_version=begin_version, tlogs=list(tlogs),
            replication=max(1, min(replication, len(tlogs))))])

    @property
    def current(self) -> LogGeneration:
        return self.generations[-1]

    @property
    def tlogs(self) -> list:
        """The current generation's logs (ratekeeper reads queue depths)."""
        return self.current.tlogs

    # --- push (REF: LogSystem::push) ---

    async def push(self, prev_version: Version, version: Version,
                   tagged: dict[Tag, list],
                   known_committed: Version = 0) -> None:
        """Replicate each tag's messages onto its hosting logs; every log
        receives the push frame (possibly tagless) so all version chains
        stay gap-free.  Acks only when ALL logs acked — which is what makes
        min(tips) a safe recovery version later.  ``known_committed`` is
        the pusher's fully-acked frontier, forwarded to every log."""
        import asyncio
        gen = self.current
        per_log: list[dict[Tag, list]] = [{} for _ in gen.tlogs]
        for tag, msgs in tagged.items():
            if not msgs:
                continue
            for i in gen.logs_for_tag(tag):
                per_log[i][tag] = msgs
        from ..runtime.buggify import buggify

        async def one(t, msgs):
            if buggify("log_push_skew"):
                from ..runtime.rng import deterministic_random
                # replicas receive the push at very different times —
                # stresses recovery's min(tip) reasoning
                await asyncio.sleep(deterministic_random().random() * 0.03)
            return await t.push(TLogPushRequest(prev_version, version, msgs,
                                                known_committed))

        pushes = [one(t, msgs) for t, msgs in zip(gen.tlogs, per_log)]
        # satellites replicate the FULL tagged batch (all-tag copies) and
        # their acks gate the commit like any other log
        pushes += [one(s, dict(tagged)) for s in gen.satellites]
        await asyncio.gather(*pushes)

    # --- peek (REF: ILogSystem::peek / ServerPeekCursor) ---

    def cursor(self, tag: Tag, begin_version: Version) -> "LogCursor":
        return LogCursor(self, tag, begin_version)

    # --- pop ---

    def pop(self, tag: Tag, version: Version) -> None:
        for gen in self.generations:
            for i in gen.live_logs_for_tag(tag):
                try:
                    gen.tlogs[i].pop(tag, version)
                except FdbError:
                    pass    # a dying replica's pop is best-effort
            for i in gen.live_satellites():
                try:
                    gen.satellites[i].pop(tag, version)
                except FdbError:
                    pass
            r = gen.routers.get(tag)
            if r is not None:
                try:
                    r.pop(tag, version)     # trims the router's buffer
                except FdbError:
                    pass

    def mark_dead(self, gen_index: int, tlog_index: int) -> None:
        self.generations[gen_index].dead.add(tlog_index)

    # --- recovery support ---

    def drop_drained_generations(self, through_version: Version) -> None:
        """Old generations fully popped below ``through_version`` by every
        storage tag can be forgotten (REF: oldestBackupEpoch trimming)."""
        while (len(self.generations) > 1
               and self.generations[0].end_version is not None
               and self.generations[0].end_version <= through_version):
            self.generations.pop(0)


class LogCursor:
    """Merged peek across generations for one tag.

    Mirrors ILogSystem::ServerPeekCursor + MergedPeekCursor: within a
    generation, any live replica hosting the tag serves the peek (their
    contents are identical for acked versions); when the cursor's position
    passes a generation's end it rolls to the next one."""

    def __init__(self, log_system: LogSystem, tag: Tag,
                 begin_version: Version) -> None:
        self.ls = log_system
        self.tag = tag
        self.version = begin_version    # next version we want

    async def next(self) -> TLogPeekReply:
        """Return entries at versions >= self.version for this tag
        (possibly empty with an advanced end_version), advancing the
        cursor.  Blocks (long-poll) only on the current generation."""
        while True:
            gen_idx, gen = self._generation_for(self.version)
            is_current = gen_idx == len(self.ls.generations) - 1
            # router feed first (one upstream pull per remote region),
            # then main replicas, then the all-tag satellite fallback
            # that keeps every tag peekable after a whole primary-DC loss
            router = gen.routers.get(self.tag)
            stubs = [router] if router is not None else []
            stubs += [gen.tlogs[i] for i in gen.live_logs_for_tag(self.tag)]
            stubs += [gen.satellites[i] for i in gen.live_satellites()]
            if not stubs:
                raise LogDataLoss()
            last_err: Exception | None = None
            reply = None
            for t in stubs:
                try:
                    reply = await t.peek(self.tag, self.version)
                    break
                except FdbError as e:
                    if e.retryable:
                        last_err = e
                        continue
                    raise
            if reply is None:
                # every replica unreachable right now — surface the last
                # retryable error; the caller's pull loop backs off
                raise last_err  # type: ignore[misc]
            if gen.end_version is not None:
                # clamp: entries above a locked generation's end were
                # never acked and must not be applied.  Everything an
                # ENDED generation serves is committed by construction
                # (the recovery version IS the acked frontier), so its
                # known_committed is the clamp itself.
                clamp = gen.end_version
                entries = [(v, m) for v, m in reply.entries if v <= clamp]
                end = min(reply.end_version, clamp + 1)
                if end <= self.version and not entries and not is_current:
                    # generation exhausted: roll into the next one
                    self.version = max(self.version, clamp + 1)
                    continue
                self.version = max(self.version, end)
                return TLogPeekReply(entries, end, clamp)
            self.version = max(self.version, reply.end_version)
            return reply

    def _generation_for(self, version: Version) -> tuple[int, LogGeneration]:
        for idx, gen in enumerate(self.ls.generations):
            if gen.end_version is None or version <= gen.end_version:
                return idx, gen
        return len(self.ls.generations) - 1, self.ls.current
