"""What the port's parity tests share.

Each package keeps BUGGIFY's switch in a module-level flag
(``runtime/buggify.py``), so a test that turns it on and leaves it on
changes every later simulation in the same worker process.  A parity
test runs the reference and the port under one seed and holds their
results equal, so both must run under the same fault injection: none.
The selected client API version (``client/multiversion.py``) is such a
flag too.

Beside the fixtures: the multi-process cluster of either package
(``package``, ``SimCluster``, ``HostCluster``), and the reference's own
test scenarios run against either package with what they showed
recorded (``run_reference_test``).
"""

import asyncio
import contextlib
import dataclasses
import enum
import functools
import importlib
import inspect
import itertools
import json
import os
import re
import sys
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



@pytest.fixture(autouse=True)
def api_version_reset():
    """Both packages' selected client API version unset before and after
    the test."""
    mods = [importlib.import_module(f"{p}.client.multiversion") for p in
            ("foundationdb_tpu", "foundationdb_tpu_torch")]
    for m in mods:
        m._reset_api_version_for_tests()
    yield
    for m in mods:
        m._reset_api_version_for_tests()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel worker processes: one CPU thread each
    for torch's ops keeps these tests from starving their neighbours."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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


# --------------------------------------------------------------------------
# the reference's own test scenarios, run against either package

REF, PORT = "foundationdb_tpu", "foundationdb_tpu_torch"
_TESTS = os.path.dirname(os.path.abspath(__file__))

# ``reference_module`` edits for the reference's multi-process scenarios
# run against the port: every server it spawns on the CPU (the kernels'
# plain versions), and one torch thread for each process it spawns with
# the scenario's environment, since several share this host's cores
SERVER_ON_CPU = ('"foundationdb_tpu_torch.server",',
                 '"foundationdb_tpu_torch.server", "--device", "cpu",')
ONE_THREAD = ('PYTHONPATH=REPO)', 'PYTHONPATH=REPO, OMP_NUM_THREADS="1")')


def reference_module(file: str, name: str,
                     edits: tuple = ()) -> types.ModuleType:
    """The reference's test module ``file`` with every import of the JAX
    package pointed at package ``name``: its scenarios, its seeds and
    its own assertions, run against either package.  The package's name
    changes in command lines too (``-m foundationdb_tpu.server``), and
    each ``(old, new)`` of ``edits`` is then replaced in the source, every
    ``old`` at least once."""
    path = os.path.join(_TESTS, file)
    with open(path) as f:
        src = f.read()
    if name != REF:
        src = re.sub(r"\bfoundationdb_tpu\b", name, src)
    for old, new in edits:
        assert old in src, f"{file} has no {old!r}"
        src = src.replace(old, new)
    mod = types.ModuleType(f"_{name}_{file[:-3]}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


# ``\xff\xff/status/json``'s document holds two kinds of field that the
# comparison leaves out: times taken on the host's clock (``*_ms``,
# ``*_us_per_batch``, the scrubber's pass duration), which differ from
# run to run of one package, and two gauges of the resolver's backend
# that differ by design between the reference's ``numpy`` twin and the
# port's ``cuda`` backend: the host-visible ring's occupancy (0.0 for a
# backend whose ring lives in tensors) and the verdict readback's bytes
# (a bitmask on ``cuda``)
STATUS_DOC = b'{"cluster": '
HOST_CLOCK = re.compile(r"(_ms|_us_per_batch|_duration_s)$")
BACKEND_GAUGES = {"window_occupancy", "device_readback_bytes"}


def status_outcome(doc: dict, path: str = ""):
    """The status document without its host-clock times and the
    resolver backend's gauges (``window_occupancy`` under ``cluster/lag``
    is the storage MVCC window's, and stays)."""
    if isinstance(doc, list):
        return [status_outcome(v, path) for v in doc]
    if not isinstance(doc, dict):
        return doc
    return {k: status_outcome(v, f"{path}/{k}") for k, v in doc.items()
            if not HOST_CLOCK.search(k)
            and not (k in BACKEND_GAUGES and path != "/cluster/lag")}


def plain(x, depth: int = 0):
    """``x`` as plain data for comparison across the two packages: their
    classes differ by module, so an object becomes its class name and,
    for dataclasses and named tuples, its fields.  A status document
    becomes ``status_outcome``'s."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (bytes, bytearray, memoryview)):
        x = bytes(x)
        if x.startswith(STATUS_DOC):
            return ("status", status_outcome(json.loads(x)))
        return x
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, BaseException):
        return (type(x).__name__, getattr(x, "code", None))
    if depth > 6:
        return type(x).__name__
    if hasattr(x, "_fields") and isinstance(x, tuple):
        return (type(x).__name__,
                [plain(v, depth + 1) for v in x])
    if isinstance(x, (list, tuple)):
        return [plain(v, depth + 1) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((plain(v, depth + 1) for v in x), key=repr)
    if isinstance(x, dict):
        return {plain(k, depth + 1): plain(v, depth + 1)
                for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name), depth + 1)
                 for f in dataclasses.fields(x)})
    if hasattr(x, "tolist"):
        return x.tolist()
    return type(x).__name__


# what a scenario shows, in order: every read, read version and commit
# version its transactions returned, every cluster state it waited for
# (the epoch and the recruited layout), and what every public method of
# the backup, DR, log-router and layer classes returned or raised
RECORDED = {
    "client.transaction.Transaction": ("get", "get_range",
                                       "get_read_version", "commit"),
    "sim.cluster_sim.SimulatedCluster": ("wait_state",),
    "backup.agent.BackupAgent": None,
    "backup.container.BackupContainer": None,
    "backup.task_bucket.TaskBucket": None,
    "backup.dr.DRAgent": None,
    "backup.stream.TagStream": None,
    "core.log_router.LogRouter": None,
    "layers.cache.ReadThroughCache": None,
    "layers.watches.WatchRegistry": None,
    "layers.feed_consumer.LayerFeedConsumer": None,
    "layers.index.SecondaryIndex": None,
    "layers.checker.LayerConsistencyChecker": None,
}


# the functions whose results a workload scenario returns: every
# workload's metrics (``run_workloads_on``, and ``run_workloads`` around
# it), the chaos run's (``simulate``) and the spec runner's, with its
# restart continuity (``run_spec``)
RESULTS = {"workloads.workload": ("run_workloads", "run_workloads_on"),
           "sim.run_one": ("simulate",),
           "sim.spec": ("run_spec",)}


def _recording(fn, label: str, log: list):
    if inspect.iscoroutinefunction(fn):
        async def wrapper(*a, **kw):
            try:
                r = await fn(*a, **kw)
            except BaseException as e:
                log.append((label, "raised", plain(e)))
                raise
            log.append((label, plain(r)))
            return r
    else:
        def wrapper(*a, **kw):
            try:
                r = fn(*a, **kw)
            except BaseException as e:
                log.append((label, "raised", plain(e)))
                raise
            log.append((label, plain(r)))
            return r
    return functools.wraps(fn)(wrapper)


def _owner(name: str, path: str):
    """Package ``name``'s module ``path``, or the class ``path`` names
    (``module.Class``)."""
    try:
        return importlib.import_module(f"{name}.{path}")
    except ModuleNotFoundError:
        mod, cls_name = path.rsplit(".", 1)
        return getattr(importlib.import_module(f"{name}.{mod}"), cls_name)


def record(mp, name: str, log: list, recorded: dict | None = None) -> list:
    """Patch package ``name`` (through ``mp``, a pytest MonkeyPatch) so
    that what its scenarios show goes into ``log``: ``RECORDED``'s
    methods, and ``recorded``'s (``{"module.Class" or "module": names}``,
    a module's functions called through the module); returns the list
    that collects every ``SimFileSystem`` the scenario makes.  A
    ``RESULTS`` function is replaced wherever a module of the package
    bound it by name."""
    for path, names in {**RECORDED, **(recorded or {})}.items():
        owner = _owner(name, path)
        label = path.rsplit(".", 1)[1]
        if names is None:
            names = [n for n, v in vars(owner).items()
                     if inspect.isfunction(v) and not n.startswith("_")]
        for n in names:
            mp.setattr(owner, n, _recording(getattr(owner, n),
                                            f"{label}.{n}", log))
    # every module first, so that none binds a wrapper by importing it
    mods = {p: importlib.import_module(f"{name}.{p}") for p in RESULTS}
    for path, names in RESULTS.items():
        mod = mods[path]
        for n in names:
            fn = getattr(mod, n)
            wrapper = _recording(fn, n, log)
            for m in list(sys.modules.values()):
                if getattr(m, "__name__", "").startswith(name + ".") \
                        and vars(m).get(n) is fn:
                    mp.setattr(m, n, wrapper)
    disks = []
    fs_cls = importlib.import_module(f"{name}.runtime.files").SimFileSystem
    init = fs_cls.__init__

    def fs_init(self, *a, **kw):
        init(self, *a, **kw)
        disks.append(self)
    mp.setattr(fs_cls, "__init__", fs_init)
    return disks


def patch_port(mp, device=None, retire: bool = True,
               mask: bool = True, majority: bool = True) -> None:
    """The port's clusters, simulated and in-process, and its resolvers
    and storage servers on ``device`` (the CPU by default, where the resolvers' and read
    mirrors' plain versions answer) unless a scenario names one.  With ``retire``
    false, the port's controller does not stop an ended generation's
    resolvers after a recovery (which the reference never does): the
    retire RPC draws from the simulated network, so without it a
    scenario with recoveries runs event for event as the reference's.
    Without ``mask`` the storage servers run ``unmasked``, without
    ``majority`` the client's refresh runs ``gathered``."""
    import torch
    device = device or torch.device("cpu")
    for path in ("core.cluster.Cluster", "sim.cluster_sim.SimulatedCluster",
                 "core.resolver.Resolver",
                 "core.storage_server.StorageServer"):
        mod, cls_name = path.rsplit(".", 1)
        cls = getattr(importlib.import_module(f"{PORT}.{mod}"), cls_name)

        def init(self, *a, _init=cls.__init__, **kw):
            if kw.get("device") is None:
                kw["device"] = device
            _init(self, *a, **kw)
        mp.setattr(cls, "__init__", init)
    if not retire:
        cc = importlib.import_module(f"{PORT}.core.cluster_controller")

        async def keep(self, prev_state):
            return None
        mp.setattr(cc.ClusterController, "_retire_resolvers", keep)
    if not mask:
        unmasked(mp)
    if not majority:
        gathered(mp)


def gathered(mp) -> None:
    """The port's client refresh and its coordinator rounds without their
    repairs of the reference's wait for the slowest coordinator (ROADMAP
    C3 and C4): ``fetch_cluster_state``, each phase of ``elect_leader``'s
    rounds, the leader's lease renewal and the coordinated state's reads
    and writes wait for every coordinator's reply, and a nomination lives
    NOMINATION_TIMEOUT, as the reference's do (``MAJORITY_ROUNDS`` off).
    A phase that returns on a majority cancels the last coordinator's
    request, whose reply then draws nothing from the simulated network,
    so with the repairs on a scenario's schedule parts from the
    reference's."""
    co = importlib.import_module(f"{PORT}.core.coordination")
    mp.setattr(co, "MAJORITY_ROUNDS", False)


def unmasked(mp) -> None:
    """The port's storage servers without their repair of the
    reference's stale read after a clear (ROADMAP C): a clear
    tombstones only the window's keys, and an engine row it covers is
    served until the clear is durable, as in the reference."""
    ss = importlib.import_module(f"{PORT}.core.storage_server")
    mp.setattr(ss.StorageServer, "_mask_engine_rows",
               lambda self, version, ranges: None)


@contextlib.contextmanager
def captured_trace(name: str):
    """The reference tests' ``captured_trace`` fixture for package
    ``name``: every INFO-or-worse trace event, as dicts."""
    tr = importlib.import_module(f"{name}.runtime.trace")
    events: list[dict] = []
    sink = tr.TraceLog(min_severity=tr.Severity.INFO)
    sink.sink = events.append
    prev = tr.get_trace_log()
    tr.set_trace_log(sink)
    try:
        yield events
    finally:
        tr.set_trace_log(prev)


def fresh_run(name: str) -> None:
    """Package ``name``'s process-wide state as a fresh process has it:
    BUGGIFY off, no client API version selected, and the span rollup,
    the span ids (which every role's status metrics report) and the
    transactions' class-wide probe ids (trace ids) at zero."""
    importlib.import_module(f"{name}.runtime.buggify").enable_buggify(False)
    importlib.import_module(
        f"{name}.client.multiversion")._reset_api_version_for_tests()
    importlib.import_module(f"{name}.runtime.span").reset_totals()
    importlib.import_module(
        f"{name}.client.transaction").Transaction._probe_counter = 0


def run_reference_test(file: str, test: str, name: str, mp,
                       device=None, retire: bool = True,
                       args=None, edits: tuple = (),
                       recorded: dict | None = None,
                       mask: bool = True, majority: bool = True,
                       left_out=()) -> dict:
    """Run the reference's ``file::test`` (with the parameters
    ``args``: a dict, or a function of the scenario's module that
    returns one; its source changed by ``edits`` as ``reference_module``
    changes it) against package ``name`` with its own assertions, from
    fresh process state (``fresh_run``); return what it
    showed: the transcript (with ``recorded``'s calls, as ``record``
    takes them), each simulated disk's bytes, and the
    LayerMismatch events it traced.  The port runs as
    ``patch_port(device, retire, mask, majority)`` sets it.  Each dict key named
    in ``left_out`` is dropped from the transcript (``without``)."""
    fresh_run(name)
    log: list = []
    with mp.context() as m:
        disks = record(m, name, log, recorded)
        if name == PORT:
            patch_port(m, device, retire, mask, majority)
        # the scenario's module binds the recorded functions by name
        mod = reference_module(file, name, edits)
        fn = getattr(mod, test)
        kw = (args(mod) if callable(args) else args) or {}
        with captured_trace(name) as events:
            if "captured_trace" in inspect.signature(fn).parameters:
                kw["captured_trace"] = events
            fn(**kw)
    return {"transcript": without(log, set(left_out)),
            "disks": [{p: bytes(b) for p, b in fs.disks.items()}
                      for fs in disks],
            "mismatches": [plain(e) for e in events
                           if e.get("Type") == "LayerMismatch"]}


def without(x, keys: set):
    """Plain data ``x`` with every dict entry whose key is in ``keys``
    dropped, at any depth."""
    if not keys:
        return x
    if isinstance(x, dict):
        return {k: without(v, keys) for k, v in x.items() if k not in keys}
    if isinstance(x, (list, tuple)):
        return type(x)(without(v, keys) for v in x)
    return x


def reference_cases(cases: dict) -> list:
    """``{file: [test, ...]}`` as pytest parameters ``(file, test)``."""
    return [pytest.param(f, t, id=f"{f[5:-3]}::{t[5:]}")
            for f, tests in cases.items() for t in tests]


def reference_param_cases(cases: dict) -> list:
    """``{file: [test, ...]}`` as pytest parameters ``(file, test,
    args)``: one for each case of a test's own ``parametrize`` marks
    (``args`` its keyword arguments), one with ``args`` empty for a test
    without them.  A test the reference marks ``slow`` gives cases
    marked ``slow`` too: tier-1 leaves both out."""
    out = []
    for f, tests in cases.items():
        mod = reference_module(f, REF)
        for t in tests:
            combos = [{}]
            marks = [pytest.mark.slow] if any(
                m.name == "slow"
                for m in getattr(getattr(mod, t), "pytestmark", [])) else []
            for m in getattr(getattr(mod, t), "pytestmark", []):
                if m.name != "parametrize":
                    continue
                names = [n.strip() for n in m.args[0].split(",")]
                combos = [{**kw, **dict(zip(names, v if len(names) > 1
                                            else (v,)))}
                          for kw in combos for v in m.args[1]]
            for kw in combos:
                ident = "-".join(str(v) for v in kw.values())
                out.append(pytest.param(
                    f, t, kw, id=f"{f[5:-3]}::{t[5:]}"
                    + (f"[{ident}]" if ident else ""), marks=marks))
    return out


class _Teardown:
    """A generator fixture's rest, run by ``undo``."""

    def __init__(self, gen) -> None:
        self.gen = gen

    def undo(self) -> None:
        next(self.gen, None)


def case_fixtures(test: str, args: dict, tmp_path_factory,
                  patches: list):
    """``run_reference_test``'s ``args`` for one case of the reference's
    ``test``: its parameters, and the pytest fixtures it asks for, each
    run its own: a fresh directory (``tmp_path``) and a MonkeyPatch
    (``monkeypatch``).  The module's ``autouse`` fixtures are set up
    first, with the same fixtures.  What needs undoing after the run (a
    MonkeyPatch, a generator fixture's teardown) is appended to
    ``patches``; the caller undoes it, last first."""
    def fixtures(mod):
        mp = pytest.MonkeyPatch()
        patches.append(mp)
        given = {"monkeypatch": mp}

        def call(fn):
            params = inspect.signature(fn).parameters
            if "tmp_path" in params and "tmp_path" not in given:
                given["tmp_path"] = tmp_path_factory.mktemp("case")
            return fn(**{k: given[k] for k in params if k in given})
        for v in list(vars(mod).values()):
            marker = getattr(v, "_fixture_function_marker", None)
            if marker is not None and marker.autouse:
                out = call(v._get_wrapped_function())
                if inspect.isgenerator(out):
                    next(out)
                    patches.append(_Teardown(out))
        kw = dict(args)
        wanted = inspect.signature(getattr(mod, test)).parameters
        for k in ("monkeypatch", "tmp_path"):
            if k in wanted:
                kw[k] = given.get(k) or tmp_path_factory.mktemp("case")
                given[k] = kw[k]
        return kw
    return fixtures


def assert_same(ref: dict, port: dict) -> None:
    """Two ``run_reference_test`` results equal, naming the first
    divergent event or file when they are not."""
    for i, (a, b) in enumerate(zip(ref["transcript"], port["transcript"])):
        assert a == b, f"event {i}: reference {a!r:.400} port {b!r:.400}"
    assert len(ref["transcript"]) == len(port["transcript"])
    assert len(ref["disks"]) == len(port["disks"])
    for i, (a, b) in enumerate(zip(ref["disks"], port["disks"])):
        assert sorted(a) == sorted(b), f"disk {i}: {sorted(set(a) ^ set(b))}"
        assert [p for p in a if a[p] != b[p]] == [], f"disk {i} bytes"
    assert ref == port


def hold_to_reference(file: str, test: str, mp, args=None,
                      recovers: bool = False, port_args=None,
                      port_edits: tuple = (),
                      recorded: dict | None = None,
                      stale_reads: bool = False, left_out=()) -> dict:
    """The reference's ``file::test`` run on both packages, each with its
    own assertions, and what they showed held equal (``assert_same``);
    returns the reference's.  ``port_args`` are the port's parameters
    where they differ from the reference's ``args``, ``port_edits`` the
    changes to the scenario's source for the port (``reference_module``).
    A scenario that ``recovers`` runs the port twice: as it is, with the
    assertions, and without the resolver retire (see ``patch_port``) for
    the comparison.  A scenario that reads a cleared engine row before
    the clear is durable (``stale_reads``: the reference serves the row,
    the port repairs that) runs the port twice the same way: as it is,
    and without the repair (``unmasked``) for the comparison.
    The port's client refresh returns once a majority of coordinators
    has answered (ROADMAP C3), which moves the simulator's schedule
    wherever a refresh returns before its last reply: so the port as it
    is must show what the reference showed, or, when it does not, the
    port with its refresh ``gathered`` must (both comparison runs above
    are gathered).  ``recorded`` adds calls to both transcripts
    (``record``), and ``left_out`` names the dict keys dropped from both
    (``without``)."""
    ref = run_reference_test(file, test, REF, mp, args=args,
                             recorded=recorded, left_out=left_out)
    port_args = args if port_args is None else port_args
    port = run_reference_test(file, test, PORT, mp, args=port_args,
                              edits=port_edits, recorded=recorded,
                              left_out=left_out)
    if recovers or stale_reads or port != ref:
        port = run_reference_test(file, test, PORT, mp, args=port_args,
                                  retire=not recovers, edits=port_edits,
                                  recorded=recorded, mask=not stale_reads,
                                  majority=False, left_out=left_out)
    assert_same(ref, port)
    return ref


def hold_case(file: str, test: str, args: dict, mp, tmp_path_factory,
              recorded: dict | None = None, recovers: bool = False,
              wall_clock: bool = False, port_edits: tuple = (),
              left_out=()) -> dict:
    """One case of the reference's ``file::test`` (its parameters
    ``args``, its fixtures from ``case_fixtures``) on both packages, each
    with its own assertions, held as ``hold_to_reference`` holds it;
    returns the reference's.  A ``wall_clock`` scenario runs an
    in-process cluster on a real event loop, whose versions come from
    the host's clock, so two runs of one package differ there: it is
    held to the same transactions' calls (``RECORDED``, not
    ``recorded``) in the same order and the same files on each
    simulated disk."""
    patches: list = []
    try:
        fx = case_fixtures(test, args, tmp_path_factory, patches)
        if not wall_clock:
            return hold_to_reference(file, test, mp, args=fx,
                                     recovers=recovers,
                                     port_edits=port_edits,
                                     recorded=recorded, left_out=left_out)
        ref = run_reference_test(file, test, REF, mp, args=fx)
        port = run_reference_test(file, test, PORT, mp, args=fx,
                                  edits=port_edits)
        assert [e[0] for e in ref["transcript"]] == \
            [e[0] for e in port["transcript"]]
        assert [sorted(d) for d in ref["disks"]] == \
            [sorted(d) for d in port["disks"]]
        return ref
    finally:
        for m in reversed(patches):
            m.undo()


def results_of(shown: dict, fn: str) -> list:
    """What each call of the recorded function ``fn`` returned, in
    order, from a ``run_reference_test`` result."""
    return [e[1] for e in shown["transcript"] if e[0] == fn and len(e) == 2]


def run_workload_specs(name: str, mp, specs: list, seed: int,
                       clients: int) -> dict:
    """Package ``name``'s ``run_workloads(specs)`` on the multi() cluster
    of tests/test_workloads.py (2 commit and 2 GRV proxies, 3 resolvers,
    2 logs, 4 storage servers), the port's on the CPU, from
    ``fresh_run``, with what it showed recorded as ``run_reference_test`` records it."""
    W = importlib.import_module(f"{name}.workloads.workload")
    C = importlib.import_module(f"{name}.core.cluster").ClusterConfig
    fresh_run(name)
    log: list = []
    with mp.context() as m:
        disks = record(m, name, log)
        if name == PORT:
            patch_port(m)
        W.run_workloads(specs, seed=seed, client_count=clients,
                        config=C(commit_proxies=2, grv_proxies=2,
                                 resolvers=3, logs=2, storage_servers=4))
    return {"transcript": log,
            "disks": [{p: bytes(b) for p, b in fs.disks.items()}
                      for fs in disks],
            "mismatches": []}


# --------------------------------------------------------------------------
# the perf smoke of either package

def perf_smoke(name: str):
    """Package ``name``'s perf smoke: the reference's ``tools/perf_smoke.py``
    (a script beside the package) or the port's ``tools.perf_smoke``."""
    if name == PORT:
        return importlib.import_module(f"{PORT}.tools.perf_smoke")
    return reference_tool("perf_smoke")


def stage_stats(name: str, stage: str, mp, constants: dict | None = None,
                record: tuple = (), mask: bool = True,
                majority: bool = True, **kw) -> dict:
    """Package ``name``'s perf-smoke ``stage`` (a ``*_seconds``
    function) from fresh process state (``fresh_run``), the port's on
    the CPU, with ``kw``; returns its stats.  ``constants`` sets the
    smoke's module constants for the run (each side's own);
    ``record`` names ``(module, function)`` pairs of the package, the
    module as ``importlib`` finds it (``None`` for the package prefix
    means the name is top-level, as the reference's ``tools/`` scripts
    are), whose every result is kept in the stats under
    ``"recorded"``: ``[(function, result), ...]``.  Without ``mask``
    the port's storage servers run without their stale-read repair
    (``unmasked``), without ``majority`` its client refresh without its
    majority return (``gathered``)."""
    import torch
    mod = perf_smoke(name)
    seen: list = []
    fresh_run(name)
    with mp.context() as m:
        for k, v in (constants or {}).items():
            m.setattr(mod, k, v)
        for path, fn in record:
            if name == REF and path.startswith("tools."):
                target = reference_tool(path[len("tools."):])
            else:
                target = importlib.import_module(f"{name}.{path}")
            real = getattr(target, fn)

            def recording(*a, _real=real, _fn=fn, **k):
                out = _real(*a, **k)
                seen.append((_fn, plain(out)))
                return out
            m.setattr(target, fn, recording)
        if name == PORT:
            kw["device"] = torch.device("cpu")
            if not mask:
                unmasked(m)
            if not majority:
                gathered(m)
        _, stats = getattr(mod, stage)(**kw)
    if record:
        stats["recorded"] = seen
    return stats


def port_stage_stats(ref: dict, stage: str, mp, keys, **kw) -> dict:
    """The port's perf-smoke ``stage`` as ``stage_stats`` runs it, as it
    is (the stage's own gates included): its stats when their ``keys``
    equal the reference's ``ref``; else, where the client's refresh
    returning on a majority of coordinators moved the simulator's
    schedule (ROADMAP C3), the stats of the port with its refresh
    ``gathered``."""
    port = stage_stats(PORT, stage, mp, **kw)
    if any(port[k] != ref[k] for k in keys):
        port = stage_stats(PORT, stage, mp, majority=False, **kw)
    return port


def reference_tool(name: str):
    """The reference's ``tools/<name>.py`` as the perf smoke imports it
    (a top-level module)."""
    tools = os.path.join(os.path.dirname(_TESTS), "tools")
    sys.path.insert(0, tools)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(tools)


def held_equal(ref: dict, port: dict, keys) -> dict:
    """The two stages' ``keys`` equal; returns the reference's."""
    a = {k: ref[k] for k in keys}
    b = {k: port[k] for k in keys}
    assert a == b, f"reference {a!r:.600} port {b!r:.600}"
    return a
