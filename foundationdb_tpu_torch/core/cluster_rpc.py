"""Networked cluster assembly: every role behind an RPC boundary.

The same pipeline as cluster.py, but each role instance lives at its own
network address and its consumers hold client stubs — the multi-process
topology of the reference (one fdbserver process per role) realized over
the swappable Transport.  Under SimNetwork this runs on the virtual-time
loop with seeded latencies and injectable faults; the identical wiring
over TcpTransport is the real deployment path (server.py).

Reference: the recruitment wiring of REF:fdbserver/ClusterController.actor.cpp
reduced to static role placement (elections/recovery land with the
coordination layer).
"""

from __future__ import annotations

import dataclasses

from ..rpc.sim_transport import SimNetwork, SimTransport
from ..rpc.stubs import (CommitProxyClient, GrvProxyClient, ResolverClient,
                         SequencerClient, StorageClient, TLogClient,
                         serve_role)
from ..rpc.transport import NetworkAddress, Transport, WLTOKEN_FIRST_AVAILABLE
from ..runtime.knobs import KNOBS, Knobs
from .cluster import ClusterConfig
from .commit_proxy import CommitProxy
from .grv_proxy import GrvProxy
from .resolver import Resolver
from .sequencer import Sequencer
from .shard_map import ShardMap
from .storage_server import StorageServer
from .tlog import TLog

BASE = WLTOKEN_FIRST_AVAILABLE


class NetworkedCluster:
    """Client-side view: same surface Transaction needs from cluster.py."""

    def __init__(self, config: ClusterConfig | None = None,
                 knobs: Knobs | None = None,
                 network: SimNetwork | None = None,
                 epoch_begin_version: int = 0, device=None) -> None:
        # ``device`` is where the resolvers and the storage servers' read
        # mirrors run (the CUDA card by default), as in cluster.py
        self.config = config or ClusterConfig()
        self.knobs = knobs or KNOBS
        self.network = network or SimNetwork(self.knobs)
        c, k, v0 = self.config, self.knobs, epoch_begin_version
        self._servers: list[tuple[Transport, object]] = []
        port = 4500

        def spawn(role: str, obj) -> tuple[NetworkAddress, Transport]:
            nonlocal port
            addr = NetworkAddress("10.0.0.%d" % (len(self._servers) + 1), port)
            port += 1
            t = SimTransport(self.network, addr)
            serve_role(t, role, obj, BASE)
            self._servers.append((t, obj))
            return addr, t

        # sequencer
        self._sequencer_obj = Sequencer(k, v0)
        seq_addr, _ = spawn("sequencer", self._sequencer_obj)

        # client-side transport (one per consumer process; here one for the
        # assembly + one per role that consumes other roles)
        def client_transport() -> Transport:
            nonlocal port
            addr = NetworkAddress("10.0.1.%d" % port, port)
            port += 1
            return SimTransport(self.network, addr)

        self.shard_map = ShardMap.even(c.storage_servers)
        res_map = ShardMap.even(c.resolvers)

        # tlogs
        self._tlog_objs = [TLog(k, v0) for _ in range(c.logs)]
        tlog_addrs = [spawn("tlog", t)[0] for t in self._tlog_objs]

        # resolvers
        self._resolver_objs = [Resolver(k, res_map.shard_range(i), v0,
                                        device=device)
                               for i in range(c.resolvers)]
        res_addrs = [spawn("resolver", r)[0] for r in self._resolver_objs]

        # storage servers: each owns a client transport with a full
        # log-system view (stubs for every TLog) so cursor failover and
        # pops reach all replicas of its tag
        from .log_system import LogSystem

        def log_system_view(t: Transport) -> LogSystem:
            return LogSystem.single(
                [TLogClient(t, a, BASE) for a in tlog_addrs],
                k.LOG_REPLICATION, v0)

        self._storage_objs = []
        storage_meta = []
        for rng, tags in self.shard_map.ranges():
            for tag in tags:
                ss = StorageServer(k, tag, rng,
                                   log_system_view(client_transport()), v0,
                                   device=device)
                self._storage_objs.append(ss)
                addr, _ = spawn("storage", ss)
                storage_meta.append((addr, tag, rng))

        # commit proxies: stubs for sequencer, resolvers, tlogs
        self._proxy_objs = []
        proxy_addrs = []
        for _ in range(c.commit_proxies):
            t = client_transport()
            seq = SequencerClient(t, seq_addr, BASE)
            resolvers = [ResolverClient(t, a, BASE, r.key_range)
                         for a, r in zip(res_addrs, self._resolver_objs)]
            cp = CommitProxy(k, seq, resolvers, log_system_view(t),
                             self.shard_map)
            self._proxy_objs.append(cp)
            proxy_addrs.append(spawn("commit_proxy", cp)[0])

        # grv proxies
        self._grv_objs = []
        grv_addrs = []
        for _ in range(c.grv_proxies):
            t = client_transport()
            gp = GrvProxy(k, SequencerClient(t, seq_addr, BASE))
            self._grv_objs.append(gp)
            grv_addrs.append(spawn("grv_proxy", gp)[0])

        # the client's own stubs
        ct = client_transport()
        self.commit_proxies = [CommitProxyClient(ct, a, BASE)
                               for a in proxy_addrs]
        self.grv_proxies = [GrvProxyClient(ct, a, BASE) for a in grv_addrs]
        self.storage_clients = [StorageClient(ct, a, BASE, tag, rng)
                                for a, tag, rng in storage_meta]

    # --- lifecycle ---

    def start(self) -> None:
        for ss in self._storage_objs:
            ss.start()
        for cp in self._proxy_objs:
            cp.start()

    async def stop(self) -> None:
        for cp in self._proxy_objs:
            await cp.stop()
        for ss in self._storage_objs:
            await ss.stop()
        for t, _ in self._servers:
            await t.close()

    async def __aenter__(self):
        self.start()
        return self

    async def __aexit__(self, *exc):
        await self.stop()

    # --- location lookup for the client (getKeyLocation analog) ---

    def storage_for_key(self, key: bytes):
        tag = self.shard_map.tags_for_key(key)[0]
        return self._storage_by_tag(tag)

    def storages_for_range(self, begin: bytes, end: bytes):
        return [self._storage_by_tag(t)
                for t in self.shard_map.tags_for_range(begin, end)]

    def _storage_by_tag(self, tag: int):
        for sc in self.storage_clients:
            if sc.tag == tag:
                return sc
        raise KeyError(f"no storage client with tag {tag}")
