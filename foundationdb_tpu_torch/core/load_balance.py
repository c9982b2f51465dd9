"""Replica selection for reads — loadBalance() over a storage team.

Reference: REF:fdbrpc/LoadBalance.actor.h + QueueModel.h — reads go to
the replica with the lowest modeled queue (outstanding requests +
failure penalty); on a retryable failure the next-best replica is tried
before the error surfaces.  This is what makes replication a read
scale-out axis (SURVEY.md §2.6) and rides over storage failures without
client-visible errors.
"""

from __future__ import annotations

import asyncio

from ..runtime.errors import FdbError
from ..runtime.rng import deterministic_random
from .data import KeyRange


class _ReplicaModel:
    """Per-replica queue model (QueueModel analog)."""

    def __init__(self, storage, index: int) -> None:
        self.storage = storage
        self.index = index
        self.outstanding = 0
        self.penalty_until = 0.0
        self.served = 0       # reads this replica answered (spread stats)

    def score(self, now: float) -> tuple[int, int]:
        return (1 if now < self.penalty_until else 0, self.outstanding)


class ReplicaGroup:
    """Storage-compatible read surface over a replication team."""

    def __init__(self, shard: KeyRange, replicas: list,
                 knobs=None) -> None:
        self.shard = shard
        self.tag = replicas[0].tag     # representative (for diagnostics)
        self._models = [_ReplicaModel(s, i) for i, s in enumerate(replicas)]
        # read-spreading policy (knob CLIENT_READ_LOAD_BALANCE):
        # how a HEALTHY team is ordered for the first attempt.  Failover
        # semantics — penalties, outstanding bookkeeping, wholesale-
        # refusal fallback — are identical under every policy; scalar
        # and batched reads share this one home.
        self.policy = (knobs.CLIENT_READ_LOAD_BALANCE
                       if knobs is not None else "score")
        self._rr = 0

    @property
    def replicas(self) -> list:
        return [m.storage for m in self._models]

    def spread_counts(self) -> list[int]:
        """Reads served per replica, in team order (spread diagnostics)."""
        return [m.served for m in self._models]

    @staticmethod
    def _degraded(m) -> bool:
        """FailureMonitor-degraded rank: the
        CC publishes the degraded machine set with the cluster state and
        cluster_client stamps each storage stub — a gray-failing disk
        should be the LAST read choice, not just avoided by recruitment.
        In-process roles carry no stamp and rank healthy (sims with the
        poll idle are bit-identical)."""
        return bool(getattr(m.storage, "degraded", False))

    def _order(self, now: float) -> list:
        # degraded replicas sort last under EVERY policy (the stable
        # sort composes with the per-policy order below, exactly like
        # the penalty class)
        if self.policy == "rotate" and len(self._models) > 1:
            # round-robin the healthy replicas (zipfian read fan-out);
            # the stable sort keeps rotation order within each penalty
            # class, so penalized replicas still sort last
            start = self._rr % len(self._models)
            self._rr += 1
            rot = self._models[start:] + self._models[:start]
            return sorted(rot, key=lambda m: (self._degraded(m),
                                              m.score(now)[0]))
        if self.policy == "least":
            # deterministic least-outstanding (stable index tiebreak)
            return sorted(self._models,
                          key=lambda m: (self._degraded(m), m.score(now)))
        # "score": the pre-heat policy — least-outstanding with a
        # random tiebreak among equals
        return sorted(self._models,
                      key=lambda m: (self._degraded(m), m.score(now),
                                     deterministic_random().random()))

    async def _failover(self, attempt):
        """THE replica-selection policy — policy-ordered iteration with
        outstanding/penalty bookkeeping, shared by scalar and batched
        reads so the two can never diverge.  ``attempt(storage)``
        returns (served, value); served=False penalizes the replica
        and remembers ``value`` as the every-replica-refused fallback.
        Retryable FdbErrors penalize and continue; others raise."""
        now = asyncio.get_running_loop().time()
        order = self._order(now)
        last_err: BaseException | None = None
        fallback = None
        have_fallback = False
        for m in order:
            m.outstanding += 1
            try:
                served, value = await attempt(m.storage)
            except FdbError as e:
                last_err = e
                if not e.retryable:
                    raise
                # penalize this replica and try the next one
                m.penalty_until = asyncio.get_running_loop().time() + 1.0
                continue
            finally:
                m.outstanding -= 1
            if served:
                m.served += 1
                return value
            fallback, have_fallback = value, True
            m.penalty_until = asyncio.get_running_loop().time() + 1.0
        if have_fallback:
            return fallback
        raise last_err  # all replicas failed

    async def _call(self, method: str, *args):
        async def attempt(storage):
            return True, await getattr(storage, method)(*args)
        return await self._failover(attempt)

    async def get_value(self, key: bytes, version: int):
        return await self._call("get_value", key, version)

    async def get_values(self, req):
        """Batched point reads with the same replica failover as scalar
        reads.  Per-key failures ride the reply as status codes (no
        exception, no failover — the whole team answers identically for
        a moved range), but a reply that is WHOLESALE future_version
        means only that this replica lags its team: try the next one,
        exactly as the scalar path's retryable-exception failover
        would."""
        from .data import GV_FUTURE_VERSION, GV_TOO_OLD

        async def attempt(storage):
            reply = await storage.get_values(req)
            # a WHOLESALE future_version (replica lags its team) or
            # too_old (replica's MVCC floor compacted past the read —
            # a teammate's independently-advancing floor may still
            # cover it) means only that THIS replica can't serve the
            # version: both are retryable per-replica on the scalar
            # path, so try the next one; if every replica refuses, the
            # client sees the code per key
            wholesale = bool(reply.codes) and (
                all(c == GV_FUTURE_VERSION for c in reply.codes)
                or all(c == GV_TOO_OLD for c in reply.codes))
            return not wholesale, reply

        return await self._failover(attempt)

    async def get_key_values(self, begin: bytes, end: bytes, version: int,
                             limit: int = 0, reverse: bool = False,
                             byte_limit: int = 0):
        return await self._call("get_key_values", begin, end, version,
                                limit, reverse, byte_limit)

    async def get_key_values_packed(self, req):
        """Packed range reads with the same replica failover as scalar
        reads.  A refused chunk carries its status ON the reply instead
        of raising, so the refusal classes the scalar path
        fails over on — this replica lags (future_version) or compacted
        past the read (too_old), and a relinquished range
        (wrong_shard) — penalize and try the next replica here too;
        only when every replica refuses does the client see the code
        (the scalar path's all-replicas-raised shape)."""
        async def attempt(storage):
            reply = await storage.get_key_values_packed(req)
            return reply.status == 0, reply

        return await self._failover(attempt)

    async def get_key(self, req):
        """Packed selector resolution with the same replica failover as
        the other packed reads: a refused reply (lagging replica,
        compacted floor, relinquished range) penalizes and tries the
        next teammate; only when every replica refuses does the client
        see the status code."""
        async def attempt(storage):
            reply = await storage.get_key(req)
            return reply.status == 0, reply

        return await self._failover(attempt)

    async def watch_value(self, key: bytes, value, version: int):
        return await self._call("watch_value", key, value, version)

    async def change_feed_stream(self, req):
        """Feed long-poll with the same replica failover as reads: the
        retained window is replicated (every team member captures from
        its own tag stream), so a dead replica costs one retry, not a
        gap in the stream."""
        return await self._call("change_feed_stream", req)
