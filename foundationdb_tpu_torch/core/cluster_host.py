"""ClusterHost — one process: worker + election candidate + (maybe) the CC.

Reference: REF:fdbserver/worker.actor.cpp — every fdbserver process runs
``workerServer`` plus ``clusterController`` behind ``tryBecomeLeader``:
the process that wins the coordinator election runs the ClusterController
actor and everyone else registers their worker with it
(RegisterWorkerRequest); losing the lease stands the controller down and
the survivors re-elect.

Token-space convention: every host serves its Worker at the shared BASE
token block of its own transport, and the cluster-controller RPC surface
at ``BASE + CC_TOKEN_OFFSET`` — so a follower can dial any leader knowing
only its network address (exactly like the reference's well-known
endpoint tokens).
"""

from __future__ import annotations

import asyncio
from typing import Callable

from ..rpc.stubs import (ClusterControllerClient, WorkerClient, serve_role)
from ..rpc.transport import NetworkAddress, Transport
from ..runtime.knobs import Knobs
from ..runtime.trace import TraceEvent
from .cluster_controller import ClusterConfigSpec, ClusterController
from .coordination import (CoordinatedState, CoordinatorsUnreachable,
                           elect_leader, granted, quorum_round, tallied)
from .worker import Worker

CC_TOKEN_OFFSET = 8     # CC RPC surface inside the worker's token block


class ClusterHost:
    """Worker + election loop; runs the ClusterController while leading."""

    def __init__(self, host_id: int, knobs: Knobs, transport: Transport,
                 client_transport_factory: Callable[[], Transport],
                 base_token: int, coordinators: list,
                 spec: ClusterConfigSpec | None = None,
                 fs=None, data_dir: str = "data",
                 locality: dict | None = None,
                 coordinator_factory: Callable[[list], list] | None = None,
                 on_repoint: Callable[[list], None] | None = None,
                 device=None) -> None:
        self.id = host_id
        self.knobs = knobs
        # locality (dcid, ...) rides every worker registration so the
        # controller can recruit region-aware (REF:fdbrpc/Locality.h)
        self.locality = dict(locality or {})
        self.transport = transport
        self.make_client_transport = client_transport_factory
        self.base = base_token
        self.coordinators = coordinators
        # quorum-change support (changeQuorum): rebuild stubs for a new
        # coordinator set + notify (e.g. rewrite the cluster file)
        self.coordinator_factory = coordinator_factory
        self.on_repoint = on_repoint
        self.spec = spec or ClusterConfigSpec()
        self.worker = Worker(host_id, knobs, transport,
                             client_transport_factory, base_token,
                             fs=fs, data_dir=data_dir, device=device)
        self._resident_map: dict[int, tuple[NetworkAddress, int]] = {}
        self._resident_tlog_map: dict[tuple[int, int, int | None],
                                      tuple[NetworkAddress, int]] = {}
        self._client_t = client_transport_factory()
        self._registry: dict[NetworkAddress, WorkerClient] = {}
        self._leading = False
        self.cc: ClusterController | None = None
        self.dd = None          # live DataDistributor while leading
        self.scrubber = None    # live ConsistencyScrubber while leading
        self._task: asyncio.Task | None = None
        self._stopped = False
        serve_role(transport, "cluster_controller", self,
                   base_token + CC_TOKEN_OFFSET)

    @property
    def address(self) -> NetworkAddress:
        return self.transport.address

    # --- CC RPC surface (live on every host; meaningful when leading) ---

    async def register_worker(self, addr: list, worker_token: int,
                              resident: dict | None = None,
                              resident_tlogs: dict | None = None,
                              locality: dict | None = None) -> bool:
        """RegisterWorkerRequest analog; False tells the caller this host
        is not (or no longer) the cluster controller.  ``resident`` maps
        storage tags this worker holds on disk to their serving tokens;
        ``resident_tlogs`` maps (epoch, index, nonce) TLog copy
        identities to tokens — so a rebooted machine's replicas and log
        copies can be adopted back."""
        if not self._leading:
            return False
        wa = NetworkAddress(addr[0], addr[1])
        if wa not in self._registry:
            self._registry[wa] = WorkerClient(self._client_t, wa, worker_token)
            TraceEvent("CCRegisteredWorker").detail("Worker", str(wa)).log()
        if locality and self.cc is not None:
            self.cc.locality[wa] = dict(locality)
        if resident_tlogs and self.cc is not None:
            for key, token in resident_tlogs.items():
                self._resident_tlog_map[tuple(key)] = (wa, int(token))
            self.cc.resident_tlogs = self._resident_tlog_map
        if resident and self.cc is not None:
            new_tags = []
            for tag, token in resident.items():
                tag = int(tag)
                self._resident_map[tag] = (wa, int(token))
                self.cc.resident = self._resident_map
                state = self.cc.last_state
                if state is not None and tag not in self.cc.active_tags:
                    # the database needs this tag and no live copy was
                    # rejoined in the current epoch: recover to adopt it
                    needed = {s["tag"] for s in state["storage"]}
                    if tag in needed:
                        new_tags.append(tag)
            if new_tags:
                # a dead replica's data is back on a live machine: recover
                # so the next epoch adopts + rejoins it
                self.cc.request_recovery(f"storage_rejoin tags={new_tags}")
        return True

    async def get_cluster_state(self) -> dict | None:
        if self.cc is not None and getattr(self.cc, "last_state", None):
            return self.cc.last_state
        return None

    # --- lifecycle ---

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self.run(), name=f"cluster-host-{self.id}")

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self.cc is not None:
            await self.cc.stop()
        await self.worker.shutdown()

    # --- the main loop: elect, lead or follow, repeat ---

    async def run(self) -> None:
        from ..runtime.errors import CoordinatorsChanged, IoError
        k = self.knobs
        # reboot adoption retries transient disk errors (the sim's
        # injected IoError, a real EIO) like a respawning fdbserver —
        # anything else (DiskCorrupt included) still fails the host
        # loudly
        attempt = 0
        while True:
            try:
                await self.worker.open_resident()
                break
            except IoError as e:
                attempt += 1
                if attempt >= 20:
                    raise
                from ..runtime.trace import TraceEvent
                TraceEvent("ResidentOpenRetry", severity=30) \
                    .detail("Host", self.id).detail("Attempt", attempt) \
                    .error(e).log()
                await asyncio.sleep(0.25)
        # the metrics plane's per-worker emitter: armed here
        # so even a host with no recruited roles records its Worker
        # gauges (disk health, SlowTask stalls)
        self.worker._ensure_emitter()
        me = [self.address.ip, self.address.port]
        while not self._stopped:
            try:
                leader_id, leader_addr = await elect_leader(
                    self.coordinators, self.id, me, k)
            except CoordinatorsChanged:
                if not await self._follow_forward():
                    await asyncio.sleep(k.RECOVERY_RETRY_DELAY)
                continue
            except CoordinatorsUnreachable:
                # an unreachable quorum may be a RETIRED quorum: check
                # for forward pointers before blind retry
                if not await self._follow_forward():
                    await asyncio.sleep(k.RECOVERY_RETRY_DELAY)
                continue
            if leader_id == self.id:
                await self._lead()
            else:
                await self._follow(leader_addr)

    # --- quorum-change handling (changeQuorum) ---

    async def _follow_forward(self) -> bool:
        """If the current coordinator set has been retired, repoint to
        the forwarded set.  True if a repoint happened."""
        if self.coordinator_factory is None:
            return False
        k = self.knobs

        async def fwd(c):
            return await asyncio.wait_for(c.get_forward(), k.FAILURE_TIMEOUT)

        fwds = await asyncio.gather(*(fwd(c) for c in self.coordinators),
                                    return_exceptions=True)
        for f in fwds:
            if f and not isinstance(f, BaseException):
                # finish retiring the rest of the old set first (a visible
                # forward implies the new set holds the state): an
                # un-retired old MAJORITY could otherwise still elect a
                # leader for hosts that have not noticed the move yet.
                # Members of BOTH sets keep serving.
                new_keys = {(a[0], a[1]) for a in f}

                def shared(c) -> bool:
                    a = getattr(c, "_address", None)
                    return a is not None and (a.ip, a.port) in new_keys

                async def retire(c):
                    return await asyncio.wait_for(c.move(f),
                                                  k.FAILURE_TIMEOUT)
                await asyncio.gather(
                    *(retire(c) for c in self.coordinators if not shared(c)),
                    return_exceptions=True)
                self._repoint(f)
                return True
        return False

    def _repoint(self, addrs: list) -> None:
        TraceEvent("CoordinatorsRepointed").detail("Host", self.id) \
            .detail("NewSet", str(addrs)).log()
        self.coordinators = self.coordinator_factory(addrs)
        if self.on_repoint is not None:
            try:
                self.on_repoint(addrs)
            except Exception as e:  # noqa: BLE001 — cluster-file rewrite
                TraceEvent("RepointCallbackFailed", severity=30) \
                    .detail("Error", repr(e)[:200]).log()

    async def _maybe_complete_move(self, exc: BaseException | None) -> bool:
        """A CC that died on a quorum-change intent marker: complete the
        interrupted move (phases 2-3) and repoint.  Safe for any host to
        run; completion is idempotent (see complete_coordinator_move)."""
        from ..runtime.errors import CoordinatorsChanged
        moving_to = getattr(exc, "moving_to", None)
        if not isinstance(exc, CoordinatorsChanged):
            return False
        if moving_to is None:
            return await self._follow_forward()
        if self.coordinator_factory is None:
            return False
        from .coordination import complete_coordinator_move
        new_stubs = self.coordinator_factory(moving_to)
        try:
            await complete_coordinator_move(
                self.coordinators, new_stubs, moving_to,
                getattr(exc, "inner_value", None), self.knobs, self.id)
        except Exception as e:  # noqa: BLE001 — retry via the run loop
            TraceEvent("QuorumMoveCompleteFailed", severity=30) \
                .detail("Error", repr(e)[:200]).log()
            return False
        self._repoint(moving_to)
        return True

    async def _lead(self) -> None:
        """Run the ClusterController until the coordinator lease is lost."""
        k = self.knobs
        TraceEvent("BecameClusterController").detail("Host", self.id).log()
        self._registry.clear()
        self._registry[self.address] = WorkerClient(
            self._client_t, self.address, self.worker.base)
        for tag, token in self.worker.resident.items():
            self._resident_map[tag] = (self.address, token)
        for key, token in self.worker.resident_tlogs.items():
            self._resident_tlog_map[key] = (self.address, token)
        cstate = CoordinatedState(self.coordinators, self.id, knobs=k)
        self.cc = ClusterController(k, self.make_client_transport(), cstate,
                                    self._registry, self.spec, self.base)
        self.cc.resident = self._resident_map
        self.cc.resident_tlogs = self._resident_tlog_map
        if self.locality:
            self.cc.locality[self.address] = dict(self.locality)
        # the CC is a metrics source only while THIS host leads
        #; registered into the worker's registry so the one
        # per-process emitter carries it
        cc_src = self.worker.metrics_registry.add_role(self.cc)
        self._leading = True
        cc_task = asyncio.get_running_loop().create_task(
            self._run_cc(), name=f"cc-{self.id}")
        dd = None
        if k.DD_ENABLED:
            from .cluster_client import RecoveredClusterView, RefreshingDatabase
            from .data_distribution import DataDistributor

            async def start_dd():
                while self.cc is not None and self.cc.last_state is None:
                    await asyncio.sleep(0.25)
                if self.cc is None:
                    return None
                t = self.make_client_transport()
                view = RecoveredClusterView(k, t, self.cc.last_state)
                db = RefreshingDatabase(view, self.coordinators)
                d = DataDistributor(k, t, self.cc, db)
                d.start()
                self.worker.metrics_registry.add_role(d)
                self.dd = d     # reachable for manual moves (RandomMoveKeys)
                return d

            dd_task = asyncio.get_running_loop().create_task(
                start_dd(), name=f"dd-start-{self.id}")
        if k.SCRUB_ENABLED:
            from .scrubber import ConsistencyScrubber

            async def start_scrub():
                # the DD recruitment shape: wait for recovery to publish
                # a state, then run the singleton with the leading CC
                while self.cc is not None and self.cc.last_state is None:
                    await asyncio.sleep(0.25)
                if self.cc is None:
                    return None
                s = ConsistencyScrubber(k, self.make_client_transport(),
                                        self.cc)
                s.start()
                self.worker.metrics_registry.add_role(s)
                self.scrubber = s   # reachable for tests/status probes
                return s

            scrub_task = asyncio.get_running_loop().create_task(
                start_scrub(), name=f"scrub-start-{self.id}")
        try:
            while True:
                await asyncio.sleep(k.LEADER_HEARTBEAT_INTERVAL)
                if cc_task.done():
                    exc = cc_task.exception()
                    TraceEvent("CCActorDied", severity=40) \
                        .detail("Host", self.id) \
                        .detail("Error", repr(exc)[:200]).log()
                    # a CC killed by a quorum-change intent completes the
                    # move before standing down (changeQuorum crash path)
                    await self._maybe_complete_move(exc)
                    return
                # bound each renewal RPC: a dead coordinator must not
                # stall the round past the live coordinators' lease; a
                # renewal ends once a majority has renewed (or cannot)
                async def hb(c):
                    return await asyncio.wait_for(
                        c.leader_heartbeat(self.id),
                        timeout=k.LEADER_LEASE_DURATION / 4)
                majority = len(self.coordinators) // 2 + 1
                replies = await quorum_round(
                    [hb(c) for c in self.coordinators],
                    tallied(granted, majority))
                good = sum(1 for r in replies if r is True)
                if good < majority:
                    TraceEvent("CCLeaseLost", severity=30) \
                        .detail("Host", self.id).log()
                    return
        finally:
            self._leading = False
            self.worker.metrics_registry.unregister(cc_src)
            self.dd = None
            self.scrubber = None
            if k.DD_ENABLED:
                dd_task.cancel()
                try:
                    dd = dd_task.result() if dd_task.done() else None
                except BaseException:
                    dd = None
                if dd is not None:
                    self.worker.metrics_registry.unregister(
                        dd.metrics_source())
                    await dd.stop()
            if k.SCRUB_ENABLED:
                scrub_task.cancel()
                try:
                    scrub = scrub_task.result() if scrub_task.done() \
                        else None
                except BaseException:
                    scrub = None
                if scrub is not None:
                    self.worker.metrics_registry.unregister(
                        scrub.metrics_source())
                    await scrub.stop()
            cc_task.cancel()
            await asyncio.gather(cc_task, return_exceptions=True)
            await self.cc.stop()
            self.cc = None

    async def _run_cc(self) -> None:
        assert self.cc is not None
        await self.cc.run()

    async def _follow(self, leader_addr) -> None:
        """Register with the leader; return (to re-elect) when it dies or
        stops leading."""
        k = self.knobs
        stub = ClusterControllerClient(
            self._client_t, NetworkAddress(leader_addr[0], leader_addr[1]),
            self.base + CC_TOKEN_OFFSET)
        me = [self.address.ip, self.address.port]
        while not self._stopped:
            try:
                ok = await asyncio.wait_for(
                    stub.register_worker(me, self.worker.base,
                                         dict(self.worker.resident),
                                         dict(self.worker.resident_tlogs),
                                         dict(self.locality)),
                    timeout=k.FAILURE_TIMEOUT * 2)
            except (Exception, asyncio.TimeoutError):
                ok = False
            if not ok:
                return
            await asyncio.sleep(k.LEADER_HEARTBEAT_INTERVAL * 2)
