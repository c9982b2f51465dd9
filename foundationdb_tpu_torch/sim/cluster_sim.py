"""SimulatedCluster — machines, kills, reboots on the deterministic net.

Reference: REF:fdbserver/SimulatedCluster.actor.cpp — a simulated machine
is an IP (every process transport on it), a lossy filesystem and the
fdbserver process (here: ClusterHost, plus a durable Coordinator when the
machine is in the quorum).  Killing a machine drops every packet to/from
its IP AND its filesystem's unsynced writes — the crash semantics FDB's
recovery is proved against; rebooting brings up a fresh process over the
surviving disk state.

Storage machines are excluded from attrition by callers until
DataDistribution can re-replicate lost replicas (the reference's
MachineAttrition honors the same constraint via protectedAddresses).
"""

from __future__ import annotations

import asyncio
import itertools

from ..core.cluster_controller import ClusterConfigSpec
from ..core.cluster_client import (RecoveredClusterView,
                                   RefreshingDatabase, fetch_cluster_state)
from ..core.cluster_host import ClusterHost
from ..core.coordination import Coordinator
from ..rpc.sim_transport import SimNetwork, SimTransport
from ..rpc.stubs import CoordinatorClient, serve_role
from ..rpc.transport import (NetworkAddress, WLTOKEN_COORDINATOR,
                             WLTOKEN_FIRST_AVAILABLE)
from ..runtime.errors import FdbError
from ..runtime.files import DiskFaultProfile, SimFileSystem
from ..runtime.knobs import Knobs
from ..runtime.trace import TraceEvent

BASE = WLTOKEN_FIRST_AVAILABLE
SERVER_PORT = 5100


class SimMachine:
    """One machine: IP + lossy filesystem + (coordinator?) + ClusterHost."""

    def __init__(self, sim: "SimulatedCluster", index: int,
                 coordinator: bool) -> None:
        self.sim = sim
        self.index = index
        self.ip = f"10.1.0.{index + 1}"
        self.is_coordinator = coordinator
        # hostile-disk model: every machine carries a
        # DiskFaultProfile — disarmed by default (zero rng draws, so
        # same-seed traces with faults off stay bit-identical).  Knob
        # SIM_DISK_FAULTS arms it at boot from a per-machine split of
        # the sim rng; DiskFaultWorkload arms it mid-run.
        self.fault_profile = DiskFaultProfile()
        self.fs = SimFileSystem(profile=self.fault_profile)
        self.fs.health.configure(sim.knobs.DISK_HEALTH_HALFLIFE_S,
                                 sim.knobs.DISK_DEGRADED_LATENCY_MS)
        if sim.knobs.SIM_DISK_FAULTS:
            from ..runtime.rng import deterministic_random
            self.fault_profile.arm_from_knobs(
                sim.knobs, deterministic_random().split())
        self.addr = NetworkAddress(self.ip, SERVER_PORT)
        self.host: ClusterHost | None = None
        self.coordinator: Coordinator | None = None
        self.alive = False
        self._ports = itertools.count(5200)
        self._boots = 0

    def _client_transport(self) -> SimTransport:
        return SimTransport(self.sim.net,
                            NetworkAddress(self.ip, next(self._ports)))

    async def start(self) -> None:
        """Boot (or reboot) the machine's process.  With a fault profile
        armed, boot-time disk reads can fail (injected IoError) — the
        supervisor loop retries like a respawning fdbserver would,
        bounded so real corruption (DiskCorrupt) still fails the boot
        loudly after a few attempts."""
        attempt = 0
        while True:
            try:
                return await self._start_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — supervisor respawn
                attempt += 1
                from ..runtime.errors import DiskCorrupt
                if isinstance(e, DiskCorrupt) or attempt >= 20:
                    raise
                TraceEvent("SimMachineBootError", severity=30) \
                    .detail("IP", self.ip).detail("Attempt", attempt) \
                    .detail("Error", repr(e)[:120]).log()
                await asyncio.sleep(0.25)

    async def _start_once(self) -> None:
        self.sim.net.reboot_ip(self.ip)
        transport = SimTransport(self.sim.net, self.addr)  # replaces listener
        # EVERY machine serves a coordination register (idle unless its
        # address is in the connection string) so `coordinators` can move
        # the quorum onto any machine — like fdbserver, where any process
        # can host coordination when the connection string names it
        self.coordinator = await Coordinator.open(
            self.sim.knobs, self.fs, "coordination-0.fdq")
        serve_role(transport, "coordinator", self.coordinator,
                   WLTOKEN_COORDINATOR)

        from ..rpc.stubs import make_coordinator_stubs

        def coord_factory(addrs):
            return make_coordinator_stubs(
                addrs, transport_factory=self._client_transport)

        coord_stubs = coord_factory(self.sim.coord_addrs)
        # host ids must differ across boots or coordinators could confuse
        # two incarnations in the same election
        host_id = self.index + 100 * self._boots
        self._boots += 1
        locality = {}
        if self.sim.dcids is not None:
            locality["dcid"] = self.sim.dcids[self.index]
        self.host = ClusterHost(
            host_id, self.sim.knobs, transport, self._client_transport,
            BASE, coord_stubs, self.sim.spec,
            fs=self.fs if self.sim.durable_storage else None,
            data_dir="data", locality=locality,
            coordinator_factory=coord_factory, device=self.sim.device)
        self.host.start()
        self.alive = True

    async def kill(self) -> None:
        """Machine crash: network dark + unsynced writes lost + process
        coroutines stopped."""
        TraceEvent("SimMachineKill").detail("IP", self.ip).log()
        self.sim.net.kill_ip(self.ip)
        self.fs.kill_unsynced()
        self.alive = False
        if self.host is not None:
            await self.host.stop()
            self.host = None
        self.coordinator = None

    async def reboot(self) -> None:
        TraceEvent("SimMachineReboot").detail("IP", self.ip).log()
        await self.start()


class SimulatedCluster:
    """The machine fleet + shared network + client helpers."""

    def __init__(self, knobs: Knobs | None = None, n_machines: int = 6,
                 n_coordinators: int = 3,
                 spec: ClusterConfigSpec | None = None,
                 durable_storage: bool = False,
                 dcids: list[str] | None = None,
                 device=None) -> None:
        self.durable_storage = durable_storage
        # where every machine's resolvers and storage read mirrors run
        # (the CUDA card by default; ``torch.device("cpu")`` for the
        # kernels' plain versions)
        self.device = device
        # per-machine datacenter ids (multi-region topologies); rides
        # worker registration as locality
        assert dcids is None or len(dcids) == n_machines
        self.dcids = dcids
        # sim-scale resolver shapes: the numpy conflict twin scans the
        # whole ever-written ring per batch, and append-slab rings consume
        # B*R slots per batch — production-sized shapes (64x8 over 2^16
        # slots) cost ~seconds of real time per resolve in simulation
        self.knobs = (knobs or Knobs()).override(
            RESOLVER_BATCH_TXNS=16, RESOLVER_RANGES_PER_TXN=4,
            CONFLICT_RING_CAPACITY=1 << 12, KEY_ENCODE_BYTES=16)
        self.net = SimNetwork(self.knobs)
        self.spec = spec or ClusterConfigSpec(
            min_workers=n_machines, replication=2)
        self.machines = [SimMachine(self, i, i < n_coordinators)
                         for i in range(n_machines)]
        self.coord_addrs = [m.addr for m in self.machines[:n_coordinators]]
        self._client_ports = itertools.count(7000)

    async def start(self) -> None:
        for m in self.machines:
            await m.start()

    async def stop(self) -> None:
        for m in self.machines:
            if m.host is not None:
                await m.host.stop()

    # --- clients ---

    def client_transport(self) -> SimTransport:
        p = next(self._client_ports)
        return SimTransport(self.net, NetworkAddress("10.9.0.1", p))

    def coordinator_stubs(self, transport=None):
        t = transport or self.client_transport()
        return [CoordinatorClient(t, a, WLTOKEN_COORDINATOR)
                for a in self.coord_addrs]

    async def wait_epoch(self, n: int, poll: float = 0.25) -> dict:
        return await self.wait_state(lambda s: s.get("epoch", 0) >= n, poll)

    async def wait_state(self, pred, poll: float = 0.25) -> dict:
        """Poll the coordinators until the published cluster state
        satisfies ``pred`` (e.g. a live move's seq bump)."""
        stubs = self.coordinator_stubs()
        while True:
            try:
                state = await fetch_cluster_state(stubs)
                if pred(state):
                    return state
            except FdbError:
                pass
            await asyncio.sleep(poll)

    async def database(self) -> "RefreshingDatabase":
        t = self.client_transport()
        stubs = self.coordinator_stubs(t)
        state = await fetch_cluster_state(stubs)
        view = RecoveredClusterView(self.knobs, t, state)
        return RefreshingDatabase(view, stubs)

    async def kill_dc(self, dcid: str) -> list:
        """Region loss: kill every live machine whose locality is dcid."""
        victims = [m for m in self.machines
                   if self.dcids is not None and m.alive
                   and self.dcids[m.index] == dcid]
        for m in victims:
            await m.kill()
        return victims

    # --- fault targeting ---

    def leader_cc(self):
        """The live ClusterController, if any machine currently leads."""
        for m in self.machines:
            if m.alive and m.host is not None and m.host.cc is not None:
                return m.host.cc
        return None

    def leader_dd(self):
        """The live DataDistributor, if any machine currently leads."""
        for m in self.machines:
            if m.alive and m.host is not None \
                    and getattr(m.host, "dd", None) is not None:
                return m.host.dd
        return None

    def leader_scrubber(self):
        """The live ConsistencyScrubber, if any machine currently
        leads with SCRUB_ENABLED."""
        for m in self.machines:
            if m.alive and m.host is not None \
                    and getattr(m.host, "scrubber", None) is not None:
                return m.host.scrubber
        return None

    def storage_objects(self) -> list:
        """Every live in-process StorageServer object (scrub tests
        reach these to inject test-only corruption on ONE replica)."""
        out = []
        for m in self.machines:
            if m.alive and m.host is not None:
                for role, obj in m.host.worker.roles.values():
                    if role == "storage":
                        out.append(obj)
        return out

    async def txn_only_machines(self) -> list[SimMachine]:
        """Machines whose kill exercises recovery: hosting at least one
        txn-subsystem role, but no storage replica (re-replication needs
        DataDistribution) and not a coordinator.  The elected controller's
        machine may be included — CC failover is part of what attrition
        tests."""
        state = await self.wait_epoch(1)
        storage_ips = {s["worker"][0] for s in state["storage"]}
        role_ips = {state["sequencer"]["addr"][0]}
        role_ips |= {a[0] for a in state["log_cfg"][-1]["tlogs"]}
        role_ips |= {r["addr"][0] for r in state["resolvers"]}
        role_ips |= {p["addr"][0]
                     for p in state["commit_proxies"] + state["grv_proxies"]}
        if state.get("ratekeeper"):
            role_ips.add(state["ratekeeper"]["addr"][0])
        # coordinator protection derives from the CURRENT quorum — a
        # changeQuorum mid-run moves it, and the boot-time per-machine
        # flag would protect a retired member while exposing a new one
        coord_ips = {a.ip for a in self.coord_addrs}
        return [m for m in self.machines
                if m.ip not in coord_ips and m.ip not in storage_ips
                and m.ip in role_ips]
