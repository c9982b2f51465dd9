"""Worker — the per-process role host the cluster controller recruits on.

Reference: REF:fdbserver/worker.actor.cpp (workerServer) — every fdbserver
process runs a worker that registers with the cluster controller and
spawns/destroys role actors on request.  Here the worker serves a
``recruit`` RPC taking a role name + a *serializable* parameter dict; it
builds the role object (constructing client stubs for the role's
dependencies from addresses in the params) and registers it at a fresh
token block on its own transport.

Serializable log-system config (the piece of cluster state that names TLog
generations) travels as plain dicts — see ``log_system_from_config``.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable

from ..rpc.stubs import (ResolverClient, SequencerClient, TLogClient,
                         serve_role)
from ..rpc.transport import Transport
from ..runtime.knobs import Knobs
from ..runtime.trace import TraceEvent
from .commit_proxy import CommitProxy
from .data import KeyRange
from .grv_proxy import GrvProxy
from .log_system import LogGeneration, LogSystem
from .ratekeeper import Ratekeeper
from .resolver import Resolver
from .sequencer import Sequencer
from .shard_map import ShardMap
from .storage_server import StorageServer
from .tlog import TLog

TOKEN_BLOCK = 16


def generations_from_config(cfg: list[dict], transport: Transport,
                            base_token: int) -> list[LogGeneration]:
    """Wire generation list → stub-backed LogGenerations.  Each TLog is
    dialed at its recruited token (cfg "token" list); ``base_token`` is
    only the legacy fallback for configs predating token plumbing."""
    from ..rpc.transport import NetworkAddress
    gens = []
    for g in cfg:
        tokens = g.get("token") or [base_token] * len(g["tlogs"])
        stubs = [TLogClient(transport, NetworkAddress(ip, port),
                            tok if tok is not None else base_token)
                 for (ip, port), tok in zip(g["tlogs"], tokens)]
        sats = [TLogClient(transport, NetworkAddress(ip, port), tok)
                for (ip, port), tok in zip(g.get("satellites") or [],
                                           g.get("sat_token") or [])]
        from ..rpc.stubs import LogRouterClient
        routers = {int(tag): LogRouterClient(
                       transport, NetworkAddress(ip, port), tok)
                   for tag, ip, port, tok in g.get("routers") or []}
        gens.append(LogGeneration(
            epoch=g["epoch"], begin_version=g["begin"], tlogs=stubs,
            replication=g["replication"], end_version=g["end"],
            dead=set(g["dead"]), satellites=sats,
            sat_dead=set(g.get("sat_dead") or []), routers=routers))
    return gens


class Worker:
    """Hosts role objects on one transport; recruited over RPC.

    ``client_transport_factory`` supplies fresh outbound transports for
    roles that consume other roles (each role gets its own, mirroring the
    reference's per-process FlowTransport with distinct endpoints).
    """

    ROLE_NAMES = ("sequencer", "tlog", "resolver", "storage",
                  "commit_proxy", "grv_proxy", "ratekeeper")

    def __init__(self, worker_id: int, knobs: Knobs, transport: Transport,
                 client_transport_factory: Callable[[], Transport],
                 base_token: int, fs=None, data_dir: str = "data",
                 device=None) -> None:
        self.id = worker_id
        # where the hosted resolvers and the storage servers' read mirrors
        # run (the CUDA card by default; ``torch.device("cpu")`` for the
        # kernels' plain versions)
        self.device = device
        self.knobs = knobs
        self.transport = transport
        self.make_client_transport = client_transport_factory
        self.base = base_token
        self.fs = fs                   # durable roles when set
        self.data_dir = data_dir
        self.roles: dict[int, tuple[str, Any]] = {}   # token -> (role, obj)
        self.resident: dict[int, int] = {}            # storage tag -> token
        # durable TLog copies found on disk after a reboot, keyed by the
        # identity baked into the filename: (epoch, index, nonce).  The
        # nonce is minted per RECRUITMENT by the controller, so a failed
        # recovery attempt's leftover file can never impersonate the
        # committed generation's copy of the same (epoch, index) — same
        # versions, different content ⇒ replica divergence if adopted.
        self.resident_tlogs: dict[tuple[int, int, int | None], int] = {}
        # the metrics plane: every hosted role registers its
        # MetricsSource here; ONE emitter actor per worker drains the
        # registry every METRICS_INTERVAL (started lazily — recruit and
        # reboot adoption are the first async entry points).  The worker
        # itself is a source: hosted-role count, disk health and the
        # process's SlowTask stalls.
        from ..runtime.metrics import MetricsRegistry, MetricsSource
        self.metrics_registry = MetricsRegistry()
        ws = MetricsSource("Worker", str(worker_id))
        ws.gauge("HostedRoles", lambda: len(self.roles))
        ws.gauge("SlowTaskStalls", self._profiler_stalls)
        ws.gauge("DiskLatencyMs", self._disk_latency_ms)
        # trace-plane loss counters: span drops
        # and probe evictions are process-wide, so the worker — one per
        # process — is their flight-record home
        ws.gauge("ProbeEvictions", self._probe_evictions)
        ws.gauge("SpanTotalsDropped", self._span_drops)
        self.metrics_registry.register(ws)
        self._role_sources: dict[int, object] = {}    # token -> MetricsSource
        serve_role(transport, "worker", self, base_token)

    @staticmethod
    def _profiler_stalls() -> int:
        from ..runtime.profiler import active_profiler
        p = active_profiler()
        return p.stalls if p is not None else 0

    @staticmethod
    def _probe_evictions() -> int:
        from ..runtime.latency_probe import EVICTIONS_TOTAL
        return EVICTIONS_TOTAL["probe_evictions"]

    @staticmethod
    def _span_drops() -> int:
        from ..runtime.span import TOTALS
        return TOTALS["dropped_spans"]

    def _disk_latency_ms(self) -> float:
        health = getattr(self.fs, "health", None) if self.fs is not None \
            else None
        return health.snapshot()["disk_latency_ms"] if health is not None \
            else 0.0

    def _ensure_emitter(self) -> None:
        if self.knobs.METRICS_EMITTER:
            self.metrics_registry.start_emitter(self.knobs.METRICS_INTERVAL)

    def _register_role_metrics(self, token: int, obj) -> None:
        src = self.metrics_registry.add_role(obj, default_id=str(token))
        if src is not None:
            self._role_sources[token] = src

    def _engine_cls(self, name: str | None = None):
        from ..storage import engine_class
        return engine_class(name or self.knobs.STORAGE_ENGINE)

    async def open_resident(self) -> dict[int, int]:
        """Reboot path: reopen every storage engine found on this
        machine's disk as a DORMANT storage server (no log system yet) and
        report {tag: token} so the cluster controller can adopt the
        replicas back at its next recovery
        (REF:fdbserver/worker.actor.cpp restoring rebooted storage roles)."""
        if self.fs is None:
            return {}
        prefix = f"{self.data_dir}/storage-"
        tags = set()
        for path in self.fs.listdir(prefix):
            rest = path[len(prefix):]
            tag = rest.split(".", 1)[0]
            if tag.isdigit():
                tags.add(int(tag))
        self._ensure_emitter()
        for tag in sorted(tags):
            if tag in self.resident:
                continue    # a retried adoption pass (transient IoError
                #             mid-open) must not serve the tag twice
            eng_name = None
            marker = f"{self.data_dir}/storage-{tag}.engine"
            if marker in self.fs.listdir(marker):
                mf = self.fs.open(marker)
                blob = await mf.read(0, mf.size())
                await mf.close()
                if blob:
                    eng_name = blob.decode(errors="replace")
            engine = await self._engine_cls(eng_name).open(
                self.fs, f"{self.data_dir}/storage-{tag}",
                knobs=self.knobs)
            meta = engine.meta
            if "shard" not in meta:
                # never completed a durability tick: useless — close it
                # (the WAL handle, and any engine-owned background task)
                # rather than abandoning it open every reboot
                await engine.close()
                continue
            shard = KeyRange(bytes(meta["shard"][0]), bytes(meta["shard"][1]))
            ls = LogSystem([LogGeneration(epoch=0, begin_version=0,
                                          tlogs=[], replication=1)])
            ss = StorageServer(self.knobs, tag, shard, ls, engine=engine,
                               device=self.device)
            await self._attach_feed_store(ss, f"{self.data_dir}/storage-{tag}")
            token = self._alloc_block()
            serve_role(self.transport, "storage", ss, token)
            self.roles[token] = ("storage", ss)
            self.resident[tag] = token
            self._register_role_metrics(token, ss)
            TraceEvent("WorkerResidentStorage").detail("Worker", self.id) \
                .detail("Tag", tag).detail("Token", token).log()
        # durable TLogs: reopen each generation copy LOCKED (old
        # generations never accept pushes again); recovery adopts them so
        # acked commits survive a whole-cluster power loss
        # (REF:fdbserver/TLogServer.actor.cpp tLogStart recovery of
        # persistent state from the DiskQueue)
        tprefix = f"{self.data_dir}/tlog-"
        for path in self.fs.listdir(tprefix):
            stem = path[len(tprefix):].split(".", 1)[0]
            try:
                parts = [int(x) for x in stem.split("-")]
            except ValueError:
                continue
            if len(parts) == 3:
                key = (parts[0], parts[1], parts[2])
            elif len(parts) == 2:       # pre-nonce naming
                key = (parts[0], parts[1], None)
            else:
                continue
            if key in self.resident_tlogs:
                continue    # already adopted by an earlier retry pass
            tlog = await TLog.open(self.knobs, self.fs, path)
            tlog.locked = True
            token = self._alloc_block()
            serve_role(self.transport, "tlog", tlog, token)
            self.roles[token] = ("tlog", tlog)
            self.resident_tlogs[key] = token
            self._register_role_metrics(token, tlog)
            TraceEvent("WorkerResidentTLog").detail("Worker", self.id) \
                .detail("Epoch", key[0]).detail("Index", key[1]) \
                .detail("Tip", tlog.version).detail("Token", token).log()
        return dict(self.resident)

    @property
    def address(self):
        return self.transport.address

    # --- recruitment RPC surface ---

    def _alloc_block(self) -> int:
        """A random unused token block, NOT sequential: sequential blocks
        repeat after a process reboot, and a stale client dialing a reused
        token would reach a different role's methods (the reference uses
        random endpoint UIDs for exactly this reason)."""
        from ..runtime.rng import deterministic_random
        rng = deterministic_random()
        while True:
            token = self.base + TOKEN_BLOCK * rng.random_int(1, 1 << 40)
            if token not in self.roles and \
                    token not in self.transport.dispatcher._handlers:
                return token

    async def recruit(self, role: str, params: dict) -> int:
        """Create a role object and serve it; returns its base token."""
        k = self.knobs
        token = self._alloc_block()
        if role == "tlog" and self.fs is not None \
                and "epoch" in (params or {}):
            # durable TLog: DiskQueue-backed, named by generation identity
            # + the controller's per-recruitment nonce so a rebooted
            # machine can reopen and report it, and a failed attempt's
            # leftover can never be adopted as the committed copy.
            # Truncated first — a retried recovery re-recruiting the same
            # identity must NOT resurrect a failed attempt's frames (same
            # version numbers, different content ⇒ replica divergence).
            stem = f"tlog-{params['epoch']}-{params['index']}"
            if params.get("nonce") is not None:
                stem += f"-{params['nonce']}"
            path = f"{self.data_dir}/{stem}.fdq"
            f = self.fs.open(path)
            await f.truncate(0)
            await f.sync()
            obj = await TLog.open(k, self.fs, path, params.get("v0", 0))
        else:
            obj = self._build_role(role, params or {}, k)
        if role == "storage" and self.fs is not None:
            # durable storage: attach a disk engine (memory engines stay
            # for diskless deployments).  A recruit is always a FRESH
            # replica (rejoins and reboot adoption never come through
            # here), so any on-disk leftovers under this tag — an aborted
            # live move's partial fetch, a failed recovery's recruit —
            # are garbage that must not resurface as stale rows.
            base = f"{self.data_dir}/storage-{params['tag']}"
            for p in self.fs.listdir(base):
                if p == base or p[len(base):len(base) + 1] == ".":
                    self.fs.remove(p)
            # durable engine-type marker: reboot adoption must reopen the
            # replica with the SAME engine class it was recruited with —
            # after a live `configure storage_engine=` migration different
            # tags on one machine run different engines, so the global
            # knob cannot answer this (REF:fdbserver/worker.actor.cpp
            # persists each storage file's KeyValueStoreType)
            eng_name = params.get("engine") or self.knobs.STORAGE_ENGINE
            mf = self.fs.open(base + ".engine")
            await mf.write(0, eng_name.encode())
            await mf.truncate(len(eng_name.encode()))
            await mf.sync()
            await mf.close()
            obj.engine = await self._engine_cls(eng_name).open(
                self.fs, f"{self.data_dir}/storage-{params['tag']}",
                knobs=self.knobs)
            # the engine arrives after construction, so the read mirror
            # is armed here (the reference never arms it on this path)
            obj.arm_device_reads()
            # durable change-feed side queue (spilled retention segments
            # survive reboots; a fresh recruit starts empty — the
            # leftover cleanup above removed any stale .feeds.dq)
            await self._attach_feed_store(obj, base)
            if "shard" not in obj.engine.meta:
                # persist the assignment IMMEDIATELY (the reference writes
                # storage metadata at creation): a replica that crashes
                # before its first durability tick must still be adoptable
                # after reboot — its data replays from the TLogs
                v0 = params.get("v0", 0)
                await obj.engine.commit([], {
                    "durable_version": v0, "tag": params["tag"],
                    "shard": (params["shard_begin"], params["shard_end"])})
            self.resident[params["tag"]] = token
        serve_role(self.transport, role, obj, token)
        self.roles[token] = (role, obj)
        self._register_role_metrics(token, obj)
        self._ensure_emitter()
        if hasattr(obj, "start"):
            obj.start()
        TraceEvent("WorkerRecruited").detail("Worker", self.id) \
            .detail("Role", role).detail("Token", token).log()
        return token

    async def _attach_feed_store(self, ss: StorageServer, base: str) -> None:
        """Attach the durable side queues to a storage server: a
        DiskQueue-backed ChangeFeedStore (registrations come from the
        engine meta, spilled retention segments re-index from the side
        queue's surviving frames), and the durability ring's
        spill file.  The ring's file is truncated FRESH:
        everything it ever holds is above the durable floor and replays
        from the TLog after a reboot, so stale bytes must never be
        adopted."""
        from ..storage.disk_queue import DiskQueue
        from .change_feed import ChangeFeedStore
        queue, frames = await DiskQueue.open(self.fs.open(base + ".feeds.dq"))
        store = ChangeFeedStore(queue)
        meta = ss.engine.meta.get("feeds") if ss.engine is not None else None
        store.restore(meta or [], frames, queue.front_offset)
        ss.feeds = store
        await ss.attach_fresh_dbuf_queue(self.fs, base)

    async def stop_role(self, token: int, destroy: bool = False) -> bool:
        """Stop a hosted role.  ``destroy=True`` additionally deletes the
        role's durable files — used when tearing down a FAILED recovery
        attempt's recruits or an aborted move's destinations, whose
        on-disk state must never resurface as an adoptable resident copy
        after a reboot (it shares identity/tag with the committed epoch's
        real data but diverges in content)."""
        entry = self.roles.pop(token, None)
        if entry is None:
            return False
        role, obj = entry
        self.metrics_registry.unregister(self._role_sources.pop(token, None))
        for i in range(TOKEN_BLOCK):
            self.transport.dispatcher.unregister(token + i)
        if role == "storage":
            # a stopped replica must not keep being reported resident, or
            # the controller would try to adopt a corpse
            self.resident = {t: tok for t, tok in self.resident.items()
                             if tok != token}
        if role == "tlog":
            self.resident_tlogs = {k: tok for k, tok
                                   in self.resident_tlogs.items()
                                   if tok != token}
        if hasattr(obj, "stop"):
            await obj.stop()
        if destroy and self.fs is not None:
            try:
                if role == "tlog" and getattr(obj, "path", None):
                    self.fs.remove(obj.path)
                elif role == "storage":
                    base = f"{self.data_dir}/storage-{obj.tag}"
                    for p in self.fs.listdir(base):
                        if p == base or p[len(base):len(base) + 1] == ".":
                            self.fs.remove(p)
            except Exception:  # noqa: BLE001 — GC is best-effort
                pass
        return True

    async def rejoin_storage(self, token: int, log_cfg: list,
                             recovery_version: int) -> bool:
        """Point a hosted storage server at a recovered log system; a
        dormant (reboot-resident) server starts pulling here."""
        entry = self.roles.get(token)
        if entry is None or entry[0] != "storage":
            return False
        ss: StorageServer = entry[1]
        gens = generations_from_config(log_cfg, self.make_client_transport(),
                                       self.base)
        await ss.rejoin(gens, recovery_version)
        if ss._pull_task is None:
            ss.start()
        return True

    async def list_roles(self) -> list[tuple[int, str]]:
        return sorted((tok, role) for tok, (role, _) in self.roles.items())

    async def disk_health(self) -> dict:
        """This machine's decayed disk latency + degraded flag (the
        gray-failure detection): the CC polls every live worker and
        feeds the answer into its FailureMonitor's degraded state so
        recruitment and DD move destinations can route around a
        slow-but-alive disk.  Diskless workers report healthy."""
        from ..runtime.profiler import stall_metrics
        health = getattr(self.fs, "health", None) if self.fs is not None \
            else None
        base = {"disk_latency_ms": 0.0, "disk_degraded": False} \
            if health is None else health.snapshot()
        # piggyback the process's SlowTask stalls:
        # the CC's health poll is the one place every worker is already
        # interrogated, so event-loop occupancy incidents reach the
        # controller without a new RPC surface
        return {**base, **stall_metrics()}

    # --- shutdown (machine kill) ---

    async def shutdown(self) -> None:
        await self.metrics_registry.stop_emitter()
        for token in list(self.roles):
            await self.stop_role(token)

    # --- role construction ---

    def _build_role(self, role: str, p: dict, k: Knobs):
        """Construct a role object, dialing every dependency at the token
        the cluster controller recorded when it recruited that dependency
        — NEVER at this worker's own base block (a worker hosts many roles
        on one transport, so base-token dialing reaches whatever role
        happens to live in block 0: a recovery that is dead on
        arrival)."""
        from ..rpc.stubs import RatekeeperClient, StorageClient
        from ..rpc.transport import NetworkAddress

        def addr(a):
            return NetworkAddress(a[0], a[1])

        if role == "sequencer":
            return Sequencer(k, p.get("v0", 0),
                             db_lock_uid=p.get("db_lock"))
        if role == "tlog":
            return TLog(k, p.get("v0", 0))
        if role == "resolver":
            return Resolver(k, KeyRange(p["begin"], p["end"]), p.get("v0", 0),
                            device=self.device)
        if role == "storage":
            t = self.make_client_transport()
            ls = LogSystem(generations_from_config(p["log_cfg"], t, self.base))
            fetch_src = None
            src = p.get("fetch_from")
            if src is not None:
                from ..rpc.stubs import StorageClient
                fetch_src = StorageClient(
                    self.make_client_transport(), addr(src["addr"]),
                    src["token"], src["tag"],
                    KeyRange(src["begin"], src["end"]))
            return StorageServer(k, p["tag"],
                                 KeyRange(p["shard_begin"], p["shard_end"]),
                                 ls, p.get("v0", 0), fetch_src=fetch_src,
                                 fetch_version=p.get("fetch_version", 0),
                                 device=self.device)
        if role == "log_router":
            # per-epoch remote-region feed: pulls ``tag`` once from the
            # recruiting epoch's log system, serves peek/pop to the
            # remote consumers (consumer names == the tag itself, so the
            # TLog-shaped cursor calls work against the router verbatim)
            from .log_router import CursorStream, LogRouter
            t = self.make_client_transport()
            ls = LogSystem(generations_from_config(p["log_cfg"], t,
                                                   self.base))
            begin = p.get("v0", 0) + 1
            return LogRouter(None, p["tag"], begin, consumers=[p["tag"]],
                             stream=CursorStream(ls, p["tag"], begin))
        if role == "ratekeeper":
            t = self.make_client_transport()
            storages = [StorageClient(t, addr(s["addr"]), s["token"],
                                      s["tag"], KeyRange(s["begin"], s["end"]))
                        for s in p["storage"]]
            gen = p["log_cfg"][-1]
            tlogs = [TLogClient(t, addr(a), tok)
                     for a, tok in zip(gen["tlogs"], gen["token"])]
            return Ratekeeper(k, storages, tlogs)
        if role == "commit_proxy":
            t = self.make_client_transport()
            seq = SequencerClient(t, addr(p["sequencer"]),
                                  p["sequencer_token"])
            resolvers = [
                ResolverClient(t, addr(a), tok, KeyRange(b, e))
                for a, b, e, tok in p["resolvers"]]
            ls = LogSystem(generations_from_config(p["log_cfg"], t, self.base))
            shard_map = ShardMap(p["shard_boundaries"], p["shard_teams"])
            return CommitProxy(k, seq, resolvers, ls, shard_map,
                               backup_tags=p.get("backup_tags"),
                               locked=p.get("locked"))
        if role == "grv_proxy":
            t = self.make_client_transport()
            seq = SequencerClient(t, addr(p["sequencer"]),
                                  p["sequencer_token"])
            rk = None
            if p.get("ratekeeper") is not None:
                rk = RatekeeperClient(t, addr(p["ratekeeper"]),
                                      p["ratekeeper_token"])
            return GrvProxy(k, seq, rk)
        raise ValueError(f"unknown role {role!r}")
