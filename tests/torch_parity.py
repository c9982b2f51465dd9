"""A fixture the port's parity tests share.

Each package keeps BUGGIFY's switch in a module-level flag
(``runtime/buggify.py``), so a test that turns it on and leaves it on
changes every later simulation in the same worker process.  A parity
test runs the reference and the port under one seed and holds their
results equal, so both must run under the same fault injection: none.
"""

import asyncio
import importlib
import itertools
import types

import pytest


@pytest.fixture(autouse=True)
def buggify_off():
    """Both packages' BUGGIFY off for the test, as they were after it."""
    # the modules by name: each package's runtime exports a function
    # named buggify too
    ref, port = (importlib.import_module(f"{p}.runtime.buggify") for p in
                 ("foundationdb_tpu", "foundationdb_tpu_torch"))
    was = [m.buggify_enabled() for m in (ref, port)]
    for m in (ref, port):
        m.enable_buggify(False)
    yield
    for m, on in zip((ref, port), was):
        m.enable_buggify(on)


# --------------------------------------------------------------------------
# the multi-process cluster of either package, on its simulated network

def package(name: str):
    """The modules of one package (``foundationdb_tpu`` or
    ``foundationdb_tpu_torch``) that the cluster tests drive, as one
    namespace; ``device`` is the keyword the port's roles take (the CPU
    here), empty for the reference."""
    def m(path):
        return importlib.import_module(f"{name}.{path}")
    kw = {}
    if name == "foundationdb_tpu_torch":
        import torch
        kw = {"device": torch.device("cpu")}
    return types.SimpleNamespace(
        name=name, device_kw=kw,
        Transaction=m("client.transaction").Transaction,
        Database=m("client.database").Database,
        cluster_client=m("core.cluster_client"),
        cluster_controller=m("core.cluster_controller"),
        cluster_host=m("core.cluster_host"),
        coordination=m("core.coordination"),
        Worker=m("core.worker").Worker,
        sim_transport=m("rpc.sim_transport"),
        stubs=m("rpc.stubs"),
        transport=m("rpc.transport"),
        errors=m("runtime.errors"),
        Knobs=m("runtime.knobs").Knobs,
        run_simulation=m("runtime.simloop").run_simulation,
        trace=m("runtime.trace"))


class SimCluster:
    """Coordinators, workers and a cluster controller over one simulated
    network: the scaffolding of the reference's recovery tests, for
    either package (``P`` from ``package``)."""

    def __init__(self, P, knobs, n_workers: int = 6, n_coord: int = 3,
                 fs_factory=None, **worker_kw) -> None:
        self.P, self.knobs = P, knobs
        self.base = P.transport.WLTOKEN_FIRST_AVAILABLE
        self.net = P.sim_transport.SimNetwork(knobs)
        self._port = 6000
        self.coord_addrs = []
        for i in range(n_coord):
            addr = P.transport.NetworkAddress(f"10.0.0.{i + 1}", 4000)
            t = P.sim_transport.SimTransport(self.net, addr)
            P.stubs.serve_role(t, "coordinator",
                               P.coordination.Coordinator(knobs), self.base)
            self.coord_addrs.append(addr)
        self.worker_addrs, self.workers = [], []
        for i in range(n_workers):
            addr = P.transport.NetworkAddress(f"10.0.2.{i + 1}", 5000)
            t = P.sim_transport.SimTransport(self.net, addr)
            if fs_factory is not None:
                worker_kw["fs"] = fs_factory()
            self.workers.append(P.Worker(i, knobs, t, self.client_transport,
                                         self.base, **worker_kw))
            self.worker_addrs.append(addr)

    def client_transport(self):
        self._port += 1
        return self.P.sim_transport.SimTransport(
            self.net, self.P.transport.NetworkAddress(
                f"10.0.9.{self._port % 250}", self._port))

    def coordinator_stubs(self, transport=None):
        t = transport or self.client_transport()
        return [self.P.stubs.CoordinatorClient(t, a, self.base)
                for a in self.coord_addrs]

    def make_cc(self, spec=None):
        P = self.P
        ct = self.client_transport()
        cstate = P.coordination.CoordinatedState(self.coordinator_stubs(ct),
                                                 my_id=999)
        registry = {a: P.stubs.WorkerClient(ct, a, self.base)
                    for a in self.worker_addrs}
        return P.cluster_controller.ClusterController(
            self.knobs, ct, cstate, registry,
            spec or P.cluster_controller.ClusterConfigSpec(), self.base)

    async def client_view(self):
        ct = self.client_transport()
        state = await self.P.cluster_client.fetch_cluster_state(
            self.coordinator_stubs(ct))
        return self.P.cluster_client.RecoveredClusterView(self.knobs, ct,
                                                          state)

    async def database(self):
        """A RefreshingDatabase over the coordinators: follows recoveries
        and answers ``\\xff\\xff/status/json``."""
        ct = self.client_transport()
        stubs = self.coordinator_stubs(ct)
        view = await self.P.cluster_client.open_cluster(self.knobs, ct,
                                                        stubs)
        return self.P.cluster_client.RefreshingDatabase(view, stubs)

    async def wait_epoch(self, n: int, stubs=None) -> dict:
        stubs = stubs or self.coordinator_stubs()
        while True:
            try:
                state = await self.P.cluster_client.fetch_cluster_state(stubs)
                if state.get("epoch", 0) >= n:
                    return state
            except self.P.errors.FdbError:
                pass
            await asyncio.sleep(0.2)


async def commit_kv(P, view, items: dict) -> int:
    """Commit ``items`` in one transaction through ``view``, retrying
    through recoveries; returns the commit version."""
    tr = P.Transaction(view)
    while True:
        try:
            for k, v in items.items():
                tr.set(k, v)
            return await tr.commit()
        except P.errors.FdbError as e:
            await tr.on_error(e)


async def read_kv(P, view, keys) -> dict:
    tr = P.Transaction(view)
    while True:
        try:
            return {k: await tr.get(k) for k in keys}
        except P.errors.FdbError as e:
            await tr.on_error(e)


class HostCluster:
    """Machines each running a ClusterHost (worker, election candidate,
    and the cluster controller with data distribution and the scrubber
    while it leads) and a coordination register, over one simulated
    network: the shape of the reference's simulated cluster, for either
    package.  The first ``n_coord`` machines form the quorum."""

    def __init__(self, P, knobs, n_machines: int = 5, n_coord: int = 3,
                 spec=None) -> None:
        self.P, self.knobs = P, knobs
        self.net = P.sim_transport.SimNetwork(knobs)
        self.spec = spec or P.cluster_controller.ClusterConfigSpec(
            min_workers=n_machines, replication=2)
        NA = P.transport.NetworkAddress
        self.ips = [f"10.1.0.{i + 1}" for i in range(n_machines)]
        self.coord_addrs = [NA(ip, 5100) for ip in self.ips[:n_coord]]
        self.hosts = []
        self._client_ports = itertools.count(7000)

    async def start(self) -> None:
        P, NA = self.P, self.P.transport.NetworkAddress
        for i, ip in enumerate(self.ips):
            t = P.sim_transport.SimTransport(self.net, NA(ip, 5100))
            P.stubs.serve_role(t, "coordinator",
                               P.coordination.Coordinator(self.knobs),
                               P.transport.WLTOKEN_COORDINATOR)
            ports = itertools.count(5200)

            def factory(ip=ip, ports=ports):
                return P.sim_transport.SimTransport(self.net,
                                                    NA(ip, next(ports)))
            h = P.cluster_host.ClusterHost(
                i, self.knobs, t, factory, P.transport.WLTOKEN_FIRST_AVAILABLE,
                self.coordinator_stubs(factory()), self.spec,
                **P.device_kw)
            h.start()
            self.hosts.append(h)

    async def stop(self) -> None:
        for h in self.hosts:
            await h.stop()

    def client_transport(self):
        return self.P.sim_transport.SimTransport(
            self.net, self.P.transport.NetworkAddress(
                "10.9.0.1", next(self._client_ports)))

    def coordinator_stubs(self, transport=None):
        t = transport or self.client_transport()
        return [self.P.stubs.CoordinatorClient(
            t, a, self.P.transport.WLTOKEN_COORDINATOR)
            for a in self.coord_addrs]

    async def wait_epoch(self, n: int) -> dict:
        stubs = self.coordinator_stubs()
        while True:
            try:
                state = await self.P.cluster_client.fetch_cluster_state(stubs)
                if state.get("epoch", 0) >= n:
                    return state
            except self.P.errors.FdbError:
                pass
            await asyncio.sleep(0.25)

    async def database(self):
        t = self.client_transport()
        stubs = self.coordinator_stubs(t)
        view = await self.P.cluster_client.open_cluster(self.knobs, t, stubs)
        return self.P.cluster_client.RefreshingDatabase(view, stubs)

    def leader_scrubber(self):
        return next((h.scrubber for h in self.hosts
                     if getattr(h, "scrubber", None) is not None), None)

    def storage_objects(self) -> list:
        return [obj for h in self.hosts
                for role, obj in h.worker.roles.values() if role == "storage"]
