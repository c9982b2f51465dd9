"""In-process cluster assembly — the single-process database.

Reference: the role recruitment that ClusterController performs
(REF:fdbserver/ClusterController.actor.cpp) reduced to its data plane:
one sequencer, N GRV proxies, N commit proxies, N resolvers (key-range
partitioned), N TLogs, N storage servers on a static shard map.  Roles
talk through direct async calls here; the RPC transport slots in at the
same method boundaries (each public role method is one RequestStream in
the reference), so moving a role out of process does not change role code.

Elections/recovery arrive with the coordination layer; this object is
also what a recovered "generation" of the transaction subsystem looks
like, so recovery later constructs one of these per epoch.
"""

from __future__ import annotations

import dataclasses

from ..runtime.knobs import KNOBS, Knobs
from .commit_proxy import CommitProxy
from .data import KeyRange, Version
from .grv_proxy import GrvProxy
from .load_balance import ReplicaGroup
from .log_system import LogSystem
from .ratekeeper import Ratekeeper
from .resolver import Resolver
from .sequencer import Sequencer
from .shard_map import ShardMap
from .storage_server import StorageServer
from .tlog import TLog


@dataclasses.dataclass
class ClusterConfig:
    """The role counts `fdbcli configure` would set
    (REF:fdbclient/DatabaseConfiguration.cpp: commit_proxies, grv_proxies,
    resolvers, logs, redundancy mode)."""
    commit_proxies: int = 1
    grv_proxies: int = 1
    resolvers: int = 1
    logs: int = 1
    storage_servers: int = 1      # number of shards
    replication: int = 1          # replicas per shard (single/double/triple)


class Cluster:
    def __init__(self, config: ClusterConfig | None = None,
                 knobs: Knobs | None = None,
                 epoch_begin_version: Version = 0,
                 tlogs: list[TLog] | None = None,
                 engines: dict[int, object] | None = None,
                 device=None) -> None:
        self.config = config or ClusterConfig()
        self.knobs = knobs or KNOBS
        c, k, v0 = self.config, self.knobs, epoch_begin_version

        self.sequencer = Sequencer(k, v0)
        # storage team per shard: replica r of shard s has tag s*RF+r
        # (the keyServers team assignment DataDistribution maintains)
        rf = max(1, c.replication)
        team_tags = [[s * rf + r for r in range(rf)]
                     for s in range(c.storage_servers)]
        self.shard_map = ShardMap.even(c.storage_servers, team_tags)
        self.tlogs = tlogs if tlogs is not None else [
            TLog(k, v0) for _ in range(c.logs)]
        # one shared log system: each tag replicated onto LOG_REPLICATION
        # logs, single generation until a recovery appends more
        self.log_system = LogSystem.single(self.tlogs, k.LOG_REPLICATION, v0)

        # resolver key partitions: even split of the whole keyspace
        res_map = ShardMap.even(c.resolvers)
        self.resolvers = [Resolver(k, res_map.shard_range(i), v0,
                                   device=device)
                          for i in range(c.resolvers)]

        self.storage_servers = []
        self._replica_groups: list[ReplicaGroup] = []
        for rng, tags in self.shard_map.ranges():
            team = []
            for tag in tags:
                engine = (engines or {}).get(tag)
                ss = StorageServer(k, tag, rng, self.log_system, v0,
                                   engine=engine)
                self.storage_servers.append(ss)
                team.append(ss)
            self._replica_groups.append(ReplicaGroup(rng, team, k))

        self.ratekeeper = Ratekeeper(k, self.storage_servers, self.tlogs)
        self.grv_proxies = [GrvProxy(k, self.sequencer, self.ratekeeper)
                            for _ in range(c.grv_proxies)]
        self.commit_proxies = [CommitProxy(k, self.sequencer, self.resolvers,
                                           self.log_system, self.shard_map)
                               for _ in range(c.commit_proxies)]
        # sampled per-txn stage probes (REF: TraceBatch; SURVEY §5.1)
        from ..runtime.latency_probe import TraceBatch
        self.trace_batch = TraceBatch(k.CLIENT_LATENCY_PROBE_SAMPLE)
        self._profiler = None
        self._started = False
        # the metrics plane: the in-process cluster is one
        # "worker" — every role registers in one registry, one emitter
        # drains it.  Registration order (role construction order) is
        # the deterministic emission order.
        from ..runtime.metrics import MetricsRegistry
        self.metrics_registry = MetricsRegistry()
        reg = self.metrics_registry
        reg.add_role(self.sequencer)
        for i, t in enumerate(self.tlogs):
            reg.add_role(t, default_id=str(i))
        for i, r in enumerate(self.resolvers):
            reg.add_role(r, default_id=str(i))
        for ss in self.storage_servers:
            reg.add_role(ss)
        reg.add_role(self.ratekeeper)
        for i, p in enumerate(self.grv_proxies):
            reg.add_role(p, default_id=str(i))
        for i, p in enumerate(self.commit_proxies):
            reg.add_role(p, default_id=str(i))

    @classmethod
    async def create(cls, config: ClusterConfig | None = None,
                     knobs: Knobs | None = None,
                     fs=None, data_dir: str | None = None,
                     device=None) -> "Cluster":
        """Build a cluster.  Without a file system this is the in-memory
        cluster.  The durable form (TLogs recovering their DiskQueues,
        storage servers their engines, the restart-resume half of
        checkpoint/resume, SURVEY.md §5.4(a)) is not ported yet: it
        comes with the durable engines and ``runtime/files.py`` (ROADMAP
        A4), and asking for it raises."""
        if fs is None or data_dir is None:
            return cls(config, knobs, device=device)
        raise NotImplementedError(
            "durable Cluster.create(fs=..., data_dir=...) is not ported yet "
            "(ROADMAP A4: durable storage); the port runs in-memory "
            "clusters only")

    # --- lifecycle ---

    def start(self) -> None:
        for ss in self.storage_servers:
            ss.start()
        for cp in self.commit_proxies:
            cp.start()
        self.ratekeeper.start()
        # slow-task profiler (REF:flow/Profiler.actor.cpp): no-op under
        # the virtual-time simulator, watchdog thread on a real loop
        from ..runtime.profiler import SlowTaskProfiler
        self._profiler = SlowTaskProfiler(self.knobs).start()
        if self.knobs.METRICS_EMITTER:
            self.metrics_registry.start_emitter(self.knobs.METRICS_INTERVAL)
        self._started = True

    async def stop(self) -> None:
        if self._profiler is not None:
            self._profiler.stop()
            self._profiler = None
        await self.metrics_registry.stop_emitter()
        await self.ratekeeper.stop()
        for cp in self.commit_proxies:
            await cp.stop()
        for r in self.resolvers:
            await r.stop()
        for ss in self.storage_servers:
            await ss.stop()
        self._started = False

    async def __aenter__(self) -> "Cluster":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # --- client-side location lookup (getKeyLocation analog) ---

    def storage_for_key(self, key: bytes) -> ReplicaGroup:
        return self._replica_groups[self.shard_map.shard_index(key)]

    def storages_for_range(self, begin: bytes, end: bytes) -> list[ReplicaGroup]:
        if begin >= end:
            return []
        import bisect as _b
        lo = self.shard_map.shard_index(begin)
        hi = _b.bisect_left(self.shard_map.boundaries, end)
        return self._replica_groups[lo:hi + 1]

    def _storage_by_tag(self, tag: int) -> StorageServer:
        for ss in self.storage_servers:
            if ss.tag == tag:
                return ss
        raise KeyError(f"no storage server with tag {tag}")
