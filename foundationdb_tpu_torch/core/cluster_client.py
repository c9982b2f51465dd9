"""Client view of a recovered cluster — stubs built from coordinated state.

Reference: REF:fdbclient/MonitorLeader.actor.cpp +
REF:fdbclient/NativeAPI.actor.cpp (DatabaseContext) — a client connects to
the coordinators named in its cluster file, fetches the latest published
cluster state (OpenDatabaseCoordRequest), and builds proxy/storage stubs
from it; when the state's epoch advances (a recovery happened) the client
re-points its stubs at the new transaction subsystem.

``RecoveredClusterView`` exposes exactly the surface
client/transaction.Transaction consumes (grv_proxies, commit_proxies,
storage_for_key, storages_for_range, knobs), so a Transaction cannot tell
this view from an in-process cluster.py assembly.
"""

from __future__ import annotations

import asyncio

from ..client.database import Database
from ..client.transaction import Transaction
from ..rpc.stubs import (CommitProxyClient, GrvProxyClient, StorageClient)
from ..rpc.transport import NetworkAddress, Transport
from ..runtime.errors import FdbError
from ..runtime.knobs import Knobs
from .data import KeyRange
from .load_balance import ReplicaGroup
from .shard_map import ShardMap


class RecoveredClusterView:
    """Stub bundle over the cluster state dict recover_once publishes."""

    def __init__(self, knobs: Knobs, transport: Transport, state: dict) -> None:
        self.knobs = knobs
        self.transport = transport
        self.epoch = -1
        self.seq = -1
        # same sampled per-txn probes as the in-process Cluster: THIS is
        # what roots distributed spans for clients of a real cluster —
        # without it, attribution stops at the wire
        from ..runtime.latency_probe import TraceBatch
        self.trace_batch = TraceBatch(knobs.CLIENT_LATENCY_PROBE_SAMPLE)
        self.update(state)

    def update(self, state: dict) -> None:
        """(Re)build stubs from a (possibly newer) cluster state.  A live
        shard move publishes the same epoch with a higher ``seq``."""
        if (state["epoch"], state.get("seq", 0)) <= (self.epoch, self.seq):
            return
        proto = state.get("protocol")
        if proto is not None and proto != self.knobs.PROTOCOL_VERSION:
            # a single-version client cannot speak to an upgraded
            # cluster; the multi-version facade catches this and
            # re-resolves against the new protocol
            from ..runtime.errors import ClusterVersionChanged
            raise ClusterVersionChanged(
                f"cluster protocol {proto}, client pinned "
                f"{self.knobs.PROTOCOL_VERSION}")
        t = self.transport

        def addr(a):
            return NetworkAddress(a[0], a[1])

        self.epoch = state["epoch"]
        self.seq = state.get("seq", 0)
        # raw published state: special-key modules (worker_interfaces)
        # read role addresses off it
        self.state = state
        self.commit_proxies = [
            CommitProxyClient(t, addr(p["addr"]), p["token"])
            for p in state["commit_proxies"]]
        self.grv_proxies = [
            GrvProxyClient(t, addr(p["addr"]), p["token"])
            for p in state["grv_proxies"]]
        # degraded machines (the CC's disk-health poll republishes the
        # set on change): stamp each storage stub so
        # ReplicaGroup ranks its replicas last for reads — gray-failure
        # avoidance for the READ path, not just recruitment/DD
        degraded = {tuple(a) for a in state.get("degraded", [])}
        self.storage_clients = []
        for s in state["storage"]:
            sc = StorageClient(t, addr(s["addr"]), s["token"], s["tag"],
                               KeyRange(s["begin"], s["end"]))
            sc.degraded = tuple(s.get("worker", ())) in degraded
            self.storage_clients.append(sc)
        self.shard_map = ShardMap(state["shard_boundaries"],
                                  state["shard_teams"])
        by_tag = {sc.tag: sc for sc in self.storage_clients}
        # reads load-balance over the replication team and fail over past
        # dead replicas (REF:fdbrpc/LoadBalance.actor.h)
        self._groups = []
        for rng, tags in self.shard_map.ranges():
            replicas = [by_tag[tg] for tg in tags if tg in by_tag]
            self._groups.append(ReplicaGroup(rng, replicas, self.knobs)
                                if replicas else None)

    # --- location lookup (getKeyLocation analog) ---

    def storage_for_key(self, key: bytes):
        g = self._groups[self.shard_map.shard_index(key)]
        if g is None:
            raise KeyError(f"no storage team for key {key!r}")
        return g

    def storages_for_range(self, begin: bytes, end: bytes):
        import bisect
        if begin >= end:
            return []
        lo = self.shard_map.shard_index(begin)
        # bisect_left keeps a range ending exactly on a boundary out of the
        # following shard (same rule as ShardMap.tags_for_range)
        hi = bisect.bisect_left(self.shard_map.boundaries, end)
        out = []
        for i in range(lo, min(hi, len(self._groups) - 1) + 1):
            g = self._groups[i]
            if g is not None:
                out.append(g)
        return out


async def open_cluster(knobs: Knobs, transport: Transport,
                       coordinators: list) -> RecoveredClusterView:
    """Fetch the freshest published cluster state from the coordinators
    (read-only open_database — never registers a read generation, so
    clients can't invalidate a recovering controller) and build a view."""
    state = await fetch_cluster_state(coordinators)
    return RecoveredClusterView(knobs, transport, state)


async def fetch_cluster_state(coordinators: list) -> dict:
    replies = await asyncio.gather(
        *(c.open_database() for c in coordinators), return_exceptions=True)
    best: dict | None = None
    moved: list | None = None
    for r in replies:
        if isinstance(r, BaseException) or not r:
            continue
        if "__moved_to__" in r:
            # a retired coordinator: the quorum moved (changeQuorum);
            # surface the forward so the caller repoints
            moved = r["__moved_to__"]
            continue
        if "__moving_to__" in r:
            # mid-change intent marker: the preserved state inside is
            # the live cluster state — clients keep working through the
            # move window
            r = r.get("__value__")
            if not r:
                continue
        if best is None or (r.get("epoch", 0), r.get("seq", 0)) > \
                (best.get("epoch", 0), best.get("seq", 0)):
            best = r
    if best is None:
        if moved is not None:
            from ..runtime.errors import CoordinatorsChanged
            e = CoordinatorsChanged()
            e.moved_to = moved
            raise e
        raise FdbError("no coordinator returned a cluster state")
    return best


class _RefreshingTransaction(Transaction):
    """Transaction whose retry path re-reads the coordinated state, so
    every caller of the standard tr.on_error() contract — workloads
    included — transparently follows recoveries to the new proxy
    generation (the client-side MonitorLeader analog)."""

    def __init__(self, db: "RefreshingDatabase") -> None:
        super().__init__(db.view)
        self._rdb = db

    async def on_error(self, e: BaseException) -> None:
        await self._rdb.refresh()
        await super().on_error(e)


class RefreshingDatabase(Database):
    """Database over a RecoveredClusterView + the coordinators backing it."""

    def __init__(self, view: RecoveredClusterView, coordinators: list) -> None:
        super().__init__(view)
        self.view = view
        self.coordinators = coordinators

    def create_transaction(self) -> Transaction:
        return _RefreshingTransaction(self)

    async def refresh(self) -> None:
        try:
            self.view.update(await fetch_cluster_state(self.coordinators))
        except FdbError as e:
            if e.code == 1039:      # cluster_version_changed must surface
                raise               # (the multi-version client re-resolves)
            pass

