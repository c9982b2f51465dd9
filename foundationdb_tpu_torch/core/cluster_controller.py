"""ClusterController — elected singleton running epoch-based recovery.

Reference: REF:fdbserver/ClusterController.actor.cpp +
REF:fdbserver/masterserver.actor.cpp (the recovery state machine,
ClusterRecovery.actor.cpp in 7.x) — the elected controller owns the
transaction subsystem: on election (or on any transaction-role failure)
it runs one *recovery epoch*:

  READING_CSTATE    read the coordinated state (previous epoch's config)
  LOCKING_CSTATE    lock the previous TLog generation (tips freeze);
                    recovery_version = min(tip) over locked logs — safe
                    because pushes ack only when every log acked
  RECRUITING        pick live workers; recruit sequencer, TLogs,
                    resolvers, commit/GRV proxies for the new generation
  REJOINING         roll storage servers back to the recovery version and
                    point them at the new log system
  WRITING_CSTATE    publish the new epoch's config to the coordinators —
                    the commit point of the recovery
  ACCEPTING_COMMITS monitor role health; any failure starts a new epoch

Storage servers are durable roles: they survive epochs and rejoin each
new one.  The transaction subsystem (sequencer/logs/resolvers/proxies) is
rebuilt from scratch every epoch, exactly like the reference.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Any

from ..rpc.failure_monitor import FailureMonitor
from ..rpc.stubs import TLogClient, WorkerClient
from ..rpc.transport import NetworkAddress, Transport
from ..runtime.errors import FdbError, LogDataLoss
from ..runtime.knobs import Knobs
from ..runtime.trace import Severity, TraceEvent
from .coordination import CoordinatedState
from .shard_map import ShardMap


@dataclasses.dataclass
class ClusterConfigSpec:
    """Role counts for recruitment (DatabaseConfiguration analog)."""
    commit_proxies: int = 1
    grv_proxies: int = 1
    resolvers: int = 1
    logs: int = 2
    storage_servers: int = 2
    replication: int = 1          # storage replicas per shard
    log_replication: int = 2
    min_workers: int = 1          # recovery waits until this many registered
    # desired IKeyValueStore engine for storage recruits; None = the
    # worker's own STORAGE_ENGINE knob (set via `configure storage_engine=`)
    storage_engine: str | None = None
    # multi-region topology (REF:fdbclient/DatabaseConfiguration.cpp
    # regions): list of {"id": dcid, "priority": int,
    # "satellite": dcid | None, "satellite_logs": int}.  The highest-
    # priority region with live workers hosts the transaction subsystem;
    # its satellite DC hosts synchronous all-tag satellite TLogs; every
    # OTHER region gets one storage replica per shard (the async remote
    # copy reads fail over to when the primary region dies).  None =
    # single-region (region-blind) recruitment.
    regions: list | None = None


class ClusterController:
    """Runs on the elected worker.  ``workers`` maps address → WorkerClient
    for every known worker process (including dead ones; liveness comes
    from the failure monitor)."""

    def __init__(self, knobs: Knobs, transport: Transport,
                 cstate: CoordinatedState, workers: dict[NetworkAddress,
                                                         WorkerClient],
                 spec: ClusterConfigSpec, base_token: int) -> None:
        self.knobs = knobs
        self.transport = transport
        self.cstate = cstate
        self.workers = workers
        self.spec = spec
        self.base = base_token
        self.fm = FailureMonitor(transport, knobs)
        # worker locality (dcid etc.) reported at registration — drives
        # region-aware recruitment (REF:fdbrpc/Locality.h)
        self.locality: dict[NetworkAddress, dict] = {}
        # replicas proven lost (their registered worker disowned the
        # token) — dropped from recovery planning; address liveness alone
        # can never retire them because the respawned process stays alive
        self.dead_replicas: set[tuple[tuple, int]] = set()
        self.epoch = 0
        self.recovery_state = "READING_CSTATE"
        self.last_state: dict | None = None
        # storage tags resident on registered workers' disks (reboot
        # adoption; maintained by the cluster host)
        self.resident: dict[int, tuple[NetworkAddress, int]] = {}
        # durable TLog copies resident on rebooted machines, keyed by the
        # (epoch, index, recruitment-nonce) identity in their filenames
        self.resident_tlogs: dict[tuple[int, int, int | None],
                                  tuple[NetworkAddress, int]] = {}
        # tags successfully rejoined/recruited in the current epoch: a
        # registration reporting a resident tag OUTSIDE this set asks for
        # a recovery (the replica is stranded until rejoined)
        self.active_tags: set[int] = set()
        self._recovery_requested: asyncio.Event = asyncio.Event()
        self._attempt_recruits: list[tuple[NetworkAddress, int]] = []
        self._stopped = False
        self._audit_epoch = 0
        self._msource = None

    def metrics_source(self):
        """The controller's registration in the hosting worker's
        MetricsRegistry: epoch + recovery state machine
        position + fleet liveness, recorded every interval — the
        recovery half of the flight record (the RecoveryState audit
        events carry the per-step detail)."""
        if self._msource is None:
            from ..runtime.metrics import MetricsSource
            s = MetricsSource("ClusterController")
            s.gauge("Epoch", lambda: self.epoch)
            s.gauge("RecoveryState", lambda: self.recovery_state)
            s.gauge("LiveWorkers", lambda: len(self._live_workers()))
            s.gauge("DegradedMachines",
                    lambda: sum(1 for a in self.workers
                                if self.fm.is_degraded(a)))
            self._msource = s
        return self._msource

    def request_recovery(self, reason: str = "") -> None:
        """Ask the run() loop for a new epoch without a role failure —
        how DataDistribution applies a new shard layout."""
        TraceEvent("RecoveryRequested").detail("Reason", reason).log()
        self._recovery_requested.set()

    @staticmethod
    def _audit(step: str, epoch: int, **details) -> None:
        """One structured ``RecoveryState`` event per recovery step —
        the recovery audit trail (epoch, version
        cuts, knownCommitted, durable TLog copy adoption, all over
        TIME).  Severity-pinned at WARN_ALWAYS so no min_severity
        configuration hides a recovery from the flight record;
        ``metrics_tool recovery`` replays the full cut sequence from
        the trace file alone."""
        ev = TraceEvent("RecoveryState", severity=Severity.WARN_ALWAYS) \
            .detail("Step", step).detail("Epoch", epoch)
        for k, v in details.items():
            ev.detail(k, v)
        ev.log()

    # --- helpers ---

    def _live_workers(self) -> list[tuple[NetworkAddress, WorkerClient]]:
        return [(a, w) for a, w in sorted(self.workers.items())
                if self.fm.is_available(a)]

    async def _recruit(self, wa: NetworkAddress, role: str,
                       params: dict) -> tuple[list, int]:
        token = await self.workers[wa].recruit(role, params)
        self._attempt_recruits.append((wa, token))
        return [wa.ip, wa.port], token

    def _resident_copy(self, g: dict, i: int,
                       satellite: bool) -> tuple | None:
        """The rebooted durable copy of generation ``g``'s log ``i``
        (satellite index space is offset by 1000), if a registered
        worker reports one."""
        nk = "sat_nonce" if satellite else "nonce"
        count = len(g.get("satellites") or []) if satellite \
            else len(g["tlogs"])
        nonces = g.get(nk) or [None] * count
        res = self.resident_tlogs.get(
            (g.get("epoch"), (1000 + i if satellite else i), nonces[i]))
        if res is None or res[0] not in self.workers:
            return None
        return res

    def _repoint_resident(self, g: dict, i: int, satellite: bool,
                          event: str) -> None:
        """Rewrite an (ended) generation's recorded log endpoint to its
        rebooted durable copy — no locking, the generation is immutable."""
        res = self._resident_copy(g, i, satellite)
        if res is None:
            return
        ak, tk = ("satellites", "sat_token") if satellite \
            else ("tlogs", "token")
        toks = g.setdefault(tk, [self.base] * len(g[ak]))
        if (NetworkAddress(*g[ak][i]), toks[i]) != res:
            g[ak][i] = (res[0].ip, res[0].port)
            toks[i] = res[1]
            TraceEvent(event).detail("Epoch", g.get("epoch")) \
                .detail("Index", i).detail("Satellite", satellite) \
                .detail("Addr", str(res[0])).log()
            self._audit("durable_copy_adopted", self._audit_epoch,
                        SourceEpoch=g.get("epoch"), Index=i,
                        Satellite=satellite, Addr=str(res[0]),
                        OldGeneration=True)

    def order_for_recruitment(self, live: list) -> list:
        """Stable-partition (addr, worker) pairs: healthy disks first,
        degraded last.  Order within each class is preserved
        so same-seed recoveries with no degraded machine are
        pick-identical to the pre-gray-failure behavior."""
        degraded = [aw for aw in live if self.fm.is_degraded(aw[0])]
        if not degraded or len(degraded) == len(live):
            return live
        healthy = [aw for aw in live if not self.fm.is_degraded(aw[0])]
        TraceEvent("RecruitAvoidDegraded") \
            .detail("Degraded", [str(a) for a, _ in degraded]) \
            .detail("Healthy", len(healthy)).log()
        return healthy + degraded

    async def _stop_attempt_recruits(self) -> None:
        """Tear down a FAILED recovery attempt's recruits.  Orphaned
        pipelines are not just waste: an orphan sequencer+proxy pair keeps
        minting versions into TLogs no coordinated state knows about, and
        anything that consumed them (a rejoined storage server) ends up
        durably AHEAD of every recoverable generation — wedging all
        future recoveries with transaction_too_old."""
        recruits, self._attempt_recruits = self._attempt_recruits, []
        for wa, token in recruits:
            w = self.workers.get(wa)
            if w is None:
                continue
            try:
                # destroy=True: a failed attempt's durable files (TLog
                # queues, storage engines) must be GC'd, not just stopped
                # — left on disk they'd be reported resident after a
                # reboot and could shadow the committed epoch's real data
                await asyncio.wait_for(w.stop_role(token, True),
                                       timeout=self.knobs.FAILURE_TIMEOUT)
            except (Exception, asyncio.TimeoutError):  # noqa: BLE001
                pass        # dead worker: its roles died with it

    # --- the recovery state machine ---

    async def recover_once(self, prev_state: dict | None) -> dict:
        """Run one full recovery; returns the new cluster state dict."""
        k, spec = self.knobs, self.spec
        new_epoch = (prev_state["epoch"] + 1) if prev_state else 1
        self.recovery_state = "LOCKING_CSTATE"
        self._attempt_recruits = []
        self._audit_epoch = new_epoch   # adoption audits group under it
        TraceEvent("RecoveryStarted").detail("Epoch", new_epoch).log()
        self._audit("locking_cstate", new_epoch,
                    PrevEpoch=prev_state["epoch"] if prev_state else 0)

        # ---- lock the previous generation, compute recovery version ----
        recovery_version = 0
        old_log_cfg: list[dict] = []
        if prev_state:
            # fence the deposed sequencer first: its commits can no longer
            # ack (we are about to lock its generation's logs) and locking
            # it stops its GRV path from serving stale read versions
            seq_info = prev_state.get("sequencer")
            if seq_info:
                from ..rpc.stubs import SequencerClient
                stub = SequencerClient(
                    self.transport, NetworkAddress(*seq_info["addr"]),
                    seq_info["token"])
                try:
                    await asyncio.wait_for(
                        stub.lock(), timeout=k.FAILURE_TIMEOUT * 2)
                except (FdbError, asyncio.TimeoutError):
                    pass    # dead/unreachable: its commits can't ack anyway
            old_log_cfg = [dict(g) for g in prev_state["log_cfg"]]
            # EVERY ended generation's recorded endpoints may be stale
            # after a whole-cluster reboot, not just the latest one: a
            # storage replica whose durable floor predates the previous
            # generation pulls history from N generations back, so their
            # durable copies must be re-pointed at the rebooted
            # incarnations too (they reopen LOCKED; no lock round needed
            # — an ended generation is immutable).
            for g in old_log_cfg[:-1]:
                for i in range(len(g["tlogs"])):
                    self._repoint_resident(g, i, satellite=False,
                                           event="TLogAdoptedOldGen")
                for i in range(len(g.get("satellites") or [])):
                    self._repoint_resident(g, i, satellite=True,
                                           event="TLogAdoptedOldGen")
            cur = old_log_cfg[-1]
            tips: list[int] = []
            dead: list[int] = list(cur.get("dead", []))
            ct = self.transport
            for i, (ip, port) in enumerate(cur["tlogs"]):
                # lock the recorded copy; failing that, a rebooted
                # machine's reopened durable copy (same DiskQueue frames,
                # fresh address/token) — whole-cluster power loss
                # recovers through these
                candidates = [(NetworkAddress(ip, port),
                               cur["token"][i] if "token" in cur
                               else self.base)]
                res = self._resident_copy(cur, i, satellite=False)
                if res is not None:
                    candidates.append(res)
                locked = False
                for addr_c, tok_c in candidates:
                    stub = TLogClient(ct, addr_c, tok_c)
                    try:
                        tips.append(await asyncio.wait_for(
                            stub.lock(), timeout=k.FAILURE_TIMEOUT * 2))
                    except (FdbError, asyncio.TimeoutError):
                        continue
                    if (addr_c, tok_c) != candidates[0]:
                        cur["tlogs"][i] = (addr_c.ip, addr_c.port)
                        cur.setdefault("token",
                                       [self.base] * len(cur["tlogs"]))
                        cur["token"][i] = tok_c
                        TraceEvent("TLogAdopted") \
                            .detail("Epoch", cur.get("epoch")) \
                            .detail("Index", i) \
                            .detail("Addr", str(addr_c)).log()
                        self._audit("durable_copy_adopted", new_epoch,
                                    SourceEpoch=cur.get("epoch"), Index=i,
                                    Satellite=False, Addr=str(addr_c),
                                    Tip=tips[-1])
                    locked = True
                    break
                if not locked and i not in dead:
                    dead.append(i)
            # lock the satellites too: they hold EVERY tag, their acks
            # gated every commit, so their tips bound the recovery
            # version exactly like main logs and they keep all tags
            # peekable after a whole primary-DC loss
            sats = cur.get("satellites") or []
            sat_dead = list(cur.get("sat_dead", []))
            for i, (ip, port) in enumerate(sats):
                candidates = [(NetworkAddress(ip, port),
                               cur["sat_token"][i])]
                res = self._resident_copy(cur, i, satellite=True)
                if res is not None:
                    candidates.append(res)
                locked = False
                for addr_c, tok_c in candidates:
                    stub = TLogClient(ct, addr_c, tok_c)
                    try:
                        tips.append(await asyncio.wait_for(
                            stub.lock(), timeout=k.FAILURE_TIMEOUT * 2))
                    except (FdbError, asyncio.TimeoutError):
                        continue
                    if (addr_c, tok_c) != candidates[0]:
                        cur["satellites"][i] = (addr_c.ip, addr_c.port)
                        cur["sat_token"][i] = tok_c
                        TraceEvent("SatelliteTLogAdopted") \
                            .detail("Epoch", cur.get("epoch")) \
                            .detail("Index", i).log()
                        self._audit("durable_copy_adopted", new_epoch,
                                    SourceEpoch=cur.get("epoch"), Index=i,
                                    Satellite=True, Addr=str(addr_c),
                                    Tip=tips[-1])
                    locked = True
                    break
                if not locked and i not in sat_dead:
                    sat_dead.append(i)
            all_sats_dead = len(sat_dead) >= len(sats)
            n = len(cur["tlogs"])
            # every storage tag needs a live replica in the locked
            # generation; a tag whose every hosting log is dead — AND no
            # live satellite copy exists — means real data loss and
            # recovery MUST refuse rather than serve a gap
            # (log_system.py's cursor-level LogDataLoss, enforced here
            # before the cluster ever accepts a commit)
            repl = max(1, min(cur["replication"], n))
            needed_tags = {s["tag"] for s in prev_state.get("storage", [])}
            for tag in sorted(needed_tags):
                hosts = [(tag + j) % n for j in range(repl)]
                if all(h in dead for h in hosts) and all_sats_dead:
                    TraceEvent("RecoveryDataLoss", severity=40) \
                        .detail("Tag", tag).detail("Hosts", hosts).log()
                    raise LogDataLoss()
            if not tips:
                raise FdbError("no lockable logs")
            recovery_version = min(tips)
            cur["end"] = recovery_version
            cur["dead"] = sorted(dead)
            cur["sat_dead"] = sorted(sat_dead)
            # THE version cut: the previous generation ends at the
            # minimum locked tip; every acked commit above it on any
            # single log is clamped out (the 6 (e) suspect territory —
            # record the full tip vector, not just the min)
            self._audit("locked_tlogs", new_epoch,
                        PrevEpoch=cur.get("epoch"),
                        Tips=list(tips),
                        RecoveryVersion=recovery_version,
                        GenerationEnd=cur["end"],
                        DeadLogs=sorted(dead),
                        DeadSatellites=sorted(sat_dead))
        self.epoch = new_epoch

        # ---- materialize the database's own metadata (txnStateStore
        # read): \xff/conf/ overrides the recruitment spec and
        # \xff/keyServers/layout carries DataDistribution's desired shard
        # layout, both written by ordinary transactions ----
        spec, layout, excluded, backup_tags, locked, res_bounds = \
            await self._read_system_state(prev_state, spec,
                                          recovery_version)
        self._audit("read_system_state", new_epoch,
                    RecoveryVersion=recovery_version,
                    Locked=locked is not None,
                    BackupTags=sorted(backup_tags or {}),
                    HasLayout=layout is not None)

        # ---- recruit the new transaction subsystem ----
        self.recovery_state = "RECRUITING"
        live = [(a, w) for a, w in self._live_workers()
                if f"{a.ip}:{a.port}" not in excluded]
        self._audit("recruiting", new_epoch,
                    LiveWorkers=len(live),
                    Degraded=sum(1 for a, _ in live
                                 if self.fm.is_degraded(a)),
                    Logs=spec.logs, Resolvers=spec.resolvers,
                    CommitProxies=spec.commit_proxies,
                    GrvProxies=spec.grv_proxies)
        # min_workers gates only the INITIAL cluster creation (so recruits
        # spread over the fleet instead of piling onto the first
        # registrant); later epochs recover with whoever survives
        needed = max(1, spec.min_workers) if prev_state is None else 1
        if len(live) < needed:
            raise FdbError("waiting for workers")

        # ---- region-aware worker pools: the transaction subsystem lives
        # in the highest-priority region with live workers; its satellite
        # DC hosts synchronous satellite TLogs; other regions get storage
        # replicas (REF:fdbserver/ClusterController recruitment across
        # DatabaseConfiguration regions) ----
        primary_region = None
        sat_workers: list = []
        remote_dcs: list[str] = []
        by_dc: dict = {}
        txn_live = live
        if spec.regions:
            def dc_of(a: NetworkAddress):
                return (self.locality.get(a) or {}).get("dcid")
            for a, w in live:
                by_dc.setdefault(dc_of(a), []).append((a, w))
            ordered = sorted(spec.regions,
                             key=lambda r: -int(r.get("priority", 0)))
            for r in ordered:
                if by_dc.get(r["id"]):
                    primary_region = r
                    break
            if primary_region is None:
                raise FdbError("no live workers in any configured region")
            txn_live = by_dc[primary_region["id"]]
            sat_dc = primary_region.get("satellite")
            sat_workers = by_dc.get(sat_dc, []) if sat_dc else []
            remote_dcs = [r["id"] for r in ordered
                          if r is not primary_region and by_dc.get(r["id"])]
            TraceEvent("RecoveryRegions") \
                .detail("Primary", primary_region["id"]) \
                .detail("SatelliteWorkers", len(sat_workers)) \
                .detail("RemoteDcs", remote_dcs).log()

        # deprioritize gray-failed machines: workers whose
        # disk the health poll marked degraded sort LAST, so the
        # round-robin pick() lands txn roles on them only when the
        # healthy pool is exhausted — never refuse outright (a small
        # fleet must still recover on a slow disk)
        txn_live = self.order_for_recruitment(txn_live)

        def pick(i: int) -> NetworkAddress:
            return txn_live[i % len(txn_live)][0]

        rv = recovery_version
        seq_addr, seq_tok = await self._recruit(
            pick(0), "sequencer", {"v0": rv, "db_lock": locked})

        from ..runtime.rng import deterministic_random
        rng = deterministic_random()
        tlog_addrs, tlog_toks, tlog_nonces = [], [], []
        for i in range(spec.logs):
            # the nonce disambiguates THIS recruitment's durable file from
            # any failed earlier attempt's leftover for the same
            # (epoch, index) — reboot adoption matches on the full triple
            nonce = rng.random_int(1, 1 << 40)
            a, t = await self._recruit(pick(1 + i), "tlog",
                                       {"v0": rv, "epoch": new_epoch,
                                        "index": i, "nonce": nonce})
            tlog_addrs.append(a)
            tlog_toks.append(t)
            tlog_nonces.append(nonce)

        # satellite TLogs: all-tag synchronous replicas in the primary
        # region's satellite DC.  Index space 1000+ keeps their durable
        # (epoch, index, nonce) file identities disjoint from main logs.
        sat_addrs, sat_toks, sat_nonces = [], [], []
        if primary_region is not None and sat_workers:
            for i in range(max(1, int(primary_region.get(
                    "satellite_logs", 1)))):
                nonce = rng.random_int(1, 1 << 40)
                wa = sat_workers[i % len(sat_workers)][0]
                a, t = await self._recruit(wa, "tlog",
                                           {"v0": rv, "epoch": new_epoch,
                                            "index": 1000 + i,
                                            "nonce": nonce})
                sat_addrs.append(a)
                sat_toks.append(t)
                sat_nonces.append(nonce)

        new_gen = {
            "epoch": new_epoch,
            "begin": rv,
            "end": None,
            "tlogs": [tuple(a) for a in tlog_addrs],
            "replication": min(spec.log_replication, spec.logs),
            "dead": [],
            "token": tlog_toks,
            "nonce": tlog_nonces,
            "satellites": [tuple(a) for a in sat_addrs],
            "sat_token": sat_toks,
            "sat_nonce": sat_nonces,
            "sat_dead": [],
        }
        log_cfg = old_log_cfg + [new_gen]

        res_map = ShardMap.even(spec.resolvers)
        # heat-driven resolver remap: DD wrote a desired
        # boundary list; THIS epoch boundary is where it takes effect —
        # the resolvers recruit on the new ranges and each partition's
        # conflict window rebuilds from the tlogs like any recovery.
        # Validated here (strictly increasing, interior, right count)
        # so a stale blob from an older spec can never wedge recovery.
        if self.knobs.RESOLVER_REBALANCE and res_bounds is not None \
                and spec.resolvers > 1 \
                and len(res_bounds) == spec.resolvers - 1 \
                and all(res_bounds[i] < res_bounds[i + 1]
                        for i in range(len(res_bounds) - 1)) \
                and res_bounds[0] > b"" \
                and res_bounds[-1] < res_map.keyspace_end:
            res_map = ShardMap(res_bounds,
                               [[i] for i in range(spec.resolvers)])
            self._audit("resolver_rebalance", new_epoch,
                        Boundaries=[b.hex() for b in res_bounds])
        resolver_info = []
        for i in range(spec.resolvers):
            r = res_map.shard_range(i)
            a, t = await self._recruit(pick(1 + spec.logs + i), "resolver",
                                       {"begin": r.begin, "end": r.end,
                                        "v0": rv})
            resolver_info.append((tuple(a), r.begin, r.end, t))

        # ---- storage: recruit (epoch 1) / rejoin / move per the desired
        # layout.  A range whose tag assignment changed (a DataDistribution
        # split or move written to \xff/keyServers/layout) gets a freshly
        # recruited server that fetchKeys-streams the snapshot at the
        # recovery version from a surviving source replica; mutations above
        # it arrive via its new tag.  REF:fdbserver/MoveKeys.actor.cpp. ----
        self.recovery_state = "REJOINING"
        self._audit("rejoining", new_epoch, RecoveryVersion=rv)
        wire_log_cfg = [self._wire_gen(g) for g in log_cfg]

        async def recruit_remote_routers(remote_tags: dict[int, str]):
            """One log router per remote storage tag, recruited IN the
            remote DC: the region's replica peeks its router instead of
            imposing cross-region peek load on the primary TLogs
            (REF:fdbserver/LogRouter.actor.cpp).  The router pulls from
            the router-less wire config (it must not route through
            itself); storage recruits/rejoins after this get the
            router-bearing config."""
            nonlocal wire_log_cfg
            for tag, dc in sorted(remote_tags.items()):
                pool = by_dc.get(dc) or []
                if not pool:
                    continue
                wa = pool[tag % len(pool)][0]
                a, t = await self._recruit(wa, "log_router", {
                    "tag": tag, "v0": rv, "log_cfg": wire_log_cfg})
                new_gen["routers"] = new_gen.get("routers", []) \
                    + [[tag, a[0], a[1], t]]
            if remote_tags:
                wire_log_cfg = [self._wire_gen(g) for g in log_cfg]

        storage_meta: list[dict] = []
        active_tags: set[int] = set()
        # rejoin RPCs run AFTER the coordinated state commits (pass 2):
        # a storage server must never consume versions from a generation
        # no cstate records — a failed attempt's orphan pipeline would
        # push it durably ahead of every recoverable generation
        rejoin_plan: list[tuple[NetworkAddress, dict]] = []
        if prev_state:
            prev_storage = list(prev_state["storage"])
            if layout:
                from .system_data import (flip_move_dest_entries,
                                          normalize_layout)
                # a flipped-but-unpublished live move's destinations are
                # known only to the layout's move journal; merge them so
                # they rejoin instead of being refetched from sources
                # that already dropped the range
                known = {s["tag"] for s in prev_storage}
                prev_storage += [d for d in flip_move_dest_entries(layout)
                                 if d["tag"] not in known]
                # in-flight (dual-tagged) moves roll BACK to their source
                # team; flipped moves roll forward
                layout = normalize_layout(layout)
            boundaries = (layout or {}).get(
                "boundaries", prev_state["shard_boundaries"])
            teams = (layout or {}).get("teams", prev_state["shard_teams"])
            shard_map = ShardMap([bytes(b) for b in boundaries],
                                 [list(t) for t in teams])
            prev_by_tag = {s["tag"]: s for s in prev_storage}
            if remote_dcs:
                await recruit_remote_routers({
                    s["tag"]: s["dcid"] for s in prev_storage
                    if s.get("dcid") in remote_dcs})
            # what each REGISTERED worker actually hosts right now: a
            # respawned incarnation at a live address silently dropped
            # every pre-crash role; catching that HERE drops the corpse
            # replica in this attempt instead of failing pass-2 rejoin
            # and cascading another whole epoch
            hosted: dict[NetworkAddress, set[int]] = {}
            for hwa, hw in list(self.workers.items()):
                try:
                    roles = await asyncio.wait_for(
                        hw.list_roles(), timeout=k.FAILURE_TIMEOUT)
                    hosted[hwa] = {int(t) for t, _ in roles}
                except (FdbError, asyncio.TimeoutError, OSError):
                    continue        # unknown: keep legacy behavior
            rejoined: set[int] = set()
            si = 0
            for rng, team in shard_map.ranges():
                for tag in team:
                    ps = prev_by_tag.get(tag)
                    if ps is not None and ps["begin"] <= rng.begin \
                            and ps["end"] >= rng.end:
                        if tag in rejoined:
                            continue
                        rejoined.add(tag)
                        s = dict(ps)
                        wa = NetworkAddress(s["worker"][0], s["worker"][1])
                        # a replica whose machine died or rebooted lives on
                        # through its disk: when a registered worker
                        # reports the tag resident at a DIFFERENT location/
                        # token than the stale meta (a rebooted incarnation
                        # serves at a fresh random token), adopt the
                        # resident copy (REF:fdbserver/worker.actor.cpp
                        # storage rejoin after reboot)
                        res = self.resident.get(tag)
                        if res is not None and self.fm.is_available(res[0]) \
                                and res[0] in self.workers \
                                and (not self.fm.is_available(wa)
                                     or (res[0], res[1])
                                     != (wa, s["token"])):
                            s["worker"] = [res[0].ip, res[0].port]
                            s["addr"] = [res[0].ip, res[0].port]
                            s["token"] = res[1]
                            wa = res[0]
                            TraceEvent("StorageAdopted") \
                                .detail("Tag", tag) \
                                .detail("Worker", str(res[0])).log()
                            self._audit("storage_adopted", new_epoch,
                                        Tag=tag, Addr=str(res[0]))
                        if wa in hosted and s["token"] not in hosted[wa] \
                                and self.resident.get(tag) is None:
                            # the registered worker disowns the token and
                            # no durable copy reported resident: lost
                            self.dead_replicas.add((tuple(s["addr"]),
                                                    s["token"]))
                        if (tuple(s["addr"]), s["token"]) in \
                                self.dead_replicas:
                            # a confirmed-lost replica (its live worker
                            # disowned the token): drop it from the team
                            # — reads fail over to the survivors, and a
                            # future resident report at a NEW token can
                            # still be adopted above
                            TraceEvent("StorageReplicaDropped",
                                       severity=30) \
                                .detail("Tag", tag) \
                                .detail("Addr", str(s["addr"])).log()
                            continue
                        storage_meta.append(s)
                        w = self.workers.get(wa)
                        if w is None:
                            if self.fm.is_available(wa):
                                # alive but not yet registered with this
                                # (new) CC — completing recovery would
                                # strand the replica on the ended
                                # generation; fail and retry
                                raise FdbError("waiting for storage workers")
                            TraceEvent("StorageRejoinPlan") \
                                .detail("Tag", tag) \
                                .detail("Decision", "worker-dead") \
                                .detail("Addr", str(wa)).log()
                            continue   # dead: reads fail over to its team
                        if not self.fm.is_available(wa):
                            # skipped now; a registration reporting the tag
                            # resident re-triggers recovery via active_tags
                            TraceEvent("StorageRejoinPlan") \
                                .detail("Tag", tag) \
                                .detail("Decision", "fm-unavailable") \
                                .detail("Addr", str(wa)).log()
                            continue
                        TraceEvent("StorageRejoinPlan").detail("Tag", tag) \
                            .detail("Decision", "rejoin") \
                            .detail("Addr", str(wa)).log()
                        rejoin_plan.append((wa, s))
                    else:
                        # moved/split-in range: fetch from a live replica of
                        # the covering source shard
                        src = next(
                            (p for p in prev_storage
                             if p["begin"] <= rng.begin and p["end"] >= rng.end
                             and self.fm.is_available(
                                 NetworkAddress(*p["worker"]))),
                            None)
                        if src is None:
                            raise FdbError("no live source for moved shard")
                        wa = pick(30 + si)
                        si += 1
                        eng = spec.storage_engine or self.knobs.STORAGE_ENGINE
                        a, t = await self._recruit(wa, "storage", {
                            "tag": tag, "shard_begin": rng.begin,
                            "shard_end": rng.end, "v0": rv,
                            "log_cfg": wire_log_cfg, "engine": eng,
                            "fetch_from": {"addr": src["addr"],
                                           "token": src["token"],
                                           "tag": src["tag"],
                                           "begin": src["begin"],
                                           "end": src["end"]},
                            "fetch_version": rv})
                        storage_meta.append({
                            "worker": [wa.ip, wa.port], "addr": a,
                            "token": t, "tag": tag, "engine": eng,
                            "begin": rng.begin, "end": rng.end})
                        active_tags.add(tag)
                        TraceEvent("StorageMoveRecruited").detail("Tag", tag) \
                            .detail("Begin", rng.begin).detail("End", rng.end).log()
        else:
            rf = max(1, spec.replication)
            # with regions, each shard team carries ``rf`` primary-region
            # replicas plus ONE replica per live remote region — the
            # async remote copy reads fail over to on region loss
            per = rf + len(remote_dcs)
            team_tags = [[s * per + r for r in range(per)]
                         for s in range(spec.storage_servers)]
            shard_map = ShardMap.even(spec.storage_servers, team_tags)
            if remote_dcs:
                await recruit_remote_routers({
                    team[rf + d_i]: dc
                    for team in team_tags
                    for d_i, dc in enumerate(remote_dcs)})
            i = 0
            eng = spec.storage_engine or self.knobs.STORAGE_ENGINE
            rr_by_dc: dict[str, int] = {}
            for rng, tags in shard_map.ranges():
                for r_i, tag in enumerate(tags):
                    if r_i < rf:
                        wa = pick(i)
                        dc = (primary_region or {}).get("id")
                        i += 1
                    else:
                        dc = remote_dcs[r_i - rf]
                        pool = by_dc[dc]
                        rr_by_dc[dc] = rr_by_dc.get(dc, 0) + 1
                        wa = pool[rr_by_dc[dc] % len(pool)][0]
                    a, t = await self._recruit(wa, "storage", {
                        "tag": tag, "shard_begin": rng.begin,
                        "shard_end": rng.end, "v0": 0,
                        "log_cfg": wire_log_cfg, "engine": eng})
                    entry = {
                        "worker": [wa.ip, wa.port], "addr": a,
                        "token": t, "tag": tag, "engine": eng,
                        "begin": rng.begin, "end": rng.end}
                    if dc is not None:
                        entry["dcid"] = dc
                    storage_meta.append(entry)
                    active_tags.add(tag)

        # ---- ratekeeper (admission control over the new storage set) ----
        rk_addr, rk_tok = await self._recruit(pick(7), "ratekeeper", {
            "storage": storage_meta, "log_cfg": wire_log_cfg})

        # ---- proxies (they need everything above) ----
        boundaries = shard_map.boundaries
        teams = shard_map.shard_tags
        proxy_params = {
            "sequencer": seq_addr, "sequencer_token": seq_tok,
            "resolvers": [(list(a), b, e, t) for a, b, e, t in resolver_info],
            "log_cfg": wire_log_cfg,
            "shard_boundaries": boundaries, "shard_teams": teams,
            "ratekeeper": rk_addr, "ratekeeper_token": rk_tok,
            "backup_tags": backup_tags, "locked": locked,
        }
        commit_info, grv_info = [], []
        for i in range(spec.commit_proxies):
            a, t = await self._recruit(pick(10 + i), "commit_proxy",
                                       dict(proxy_params))
            commit_info.append((a, t))
        for i in range(spec.grv_proxies):
            a, t = await self._recruit(pick(20 + i), "grv_proxy",
                                       dict(proxy_params))
            grv_info.append((a, t))

        # ---- commit the new epoch ----
        self.recovery_state = "WRITING_CSTATE"
        self._audit("writing_cstate", new_epoch,
                    RecoveryVersion=rv,
                    NewGenerationBegin=new_gen["begin"],
                    TLogs=len(tlog_addrs),
                    Satellites=len(sat_addrs),
                    StorageTags=sorted(s["tag"] for s in storage_meta),
                    RejoinPlanned=len(rejoin_plan))
        state = {
            "epoch": new_epoch,
            "seq": 0,
            "protocol": k.PROTOCOL_VERSION,
            "primary_dc": (primary_region or {}).get("id"),
            "regions": spec.regions,
            "recovery_version": rv,
            "log_cfg": log_cfg,
            "sequencer": {"addr": seq_addr, "token": seq_tok},
            "resolvers": [{"addr": list(a), "begin": b, "end": e, "token": t}
                          for a, b, e, t in resolver_info],
            "storage": storage_meta,
            "ratekeeper": {"addr": rk_addr, "token": rk_tok},
            "commit_proxies": [{"addr": a, "token": t} for a, t in commit_info],
            "grv_proxies": [{"addr": a, "token": t} for a, t in grv_info],
            "shard_boundaries": boundaries,
            "shard_teams": teams,
        }
        await self.cstate.write(state)
        self.last_state = state
        self._attempt_recruits = []      # committed: these roles ARE the epoch

        # ---- pass 2: rejoin storage onto the now-COMMITTED generation.
        # A failure here cannot orphan anything (the epoch is in cstate;
        # the next recovery locks this generation, whose tips are >= all
        # versions any rejoined server will ever apply) — so failures log
        # and request another recovery instead of raising. ----
        for wa, s in rejoin_plan:
            w = self.workers.get(wa)
            try:
                ok = await asyncio.wait_for(
                    w.rejoin_storage(s["token"], wire_log_cfg, rv),
                    timeout=k.FAILURE_TIMEOUT * 4)
                if not ok:
                    # the registered worker no longer hosts that token:
                    # a respawned incarnation whose (non-durable) replica
                    # died with the old process.  The ADDRESS stays alive
                    # forever, so address-level liveness will never
                    # retire this entry — without marking the REPLICA
                    # dead, every epoch re-plans the corpse and recovery
                    # loops for good (a durable copy instead re-reports
                    # residency and is adopted, never reaching here).
                    self.dead_replicas.add((tuple(s["addr"]), s["token"]))
                    raise FdbError("storage replica lost (token gone)")
                active_tags.add(s["tag"])
            except (FdbError, asyncio.TimeoutError) as e:
                TraceEvent("StorageRejoinFailed", severity=30) \
                    .detail("Tag", s["tag"]).detail("Error", repr(e)[:100]) \
                    .log()
                self.request_recovery(f"storage_rejoin_failed tag={s['tag']}")

        self.active_tags = active_tags
        self.recovery_state = "ACCEPTING_COMMITS"
        TraceEvent("RecoveryComplete").detail("Epoch", new_epoch) \
            .detail("RecoveryVersion", rv).log()
        self._audit("accepting_commits", new_epoch,
                    RecoveryVersion=rv,
                    ActiveTags=sorted(active_tags))
        await self._retire_resolvers(prev_state)
        return state

    async def _retire_resolvers(self, prev_state: dict | None) -> None:
        """Stop the ended generation's resolvers on the live workers
        that still host them.  A resolver keeps its conflict history on
        the device; left running after its generation ends it would
        hold one ring (and dictionary) on the card per recovery.  The
        ended generation's sequencer is locked, so nothing can resolve
        through them any more.  Best effort: a dead worker's roles died
        with it."""
        for r in (prev_state or {}).get("resolvers", []):
            wa = NetworkAddress(*r["addr"])
            w = self.workers.get(wa)
            if w is None or not self.fm.is_available(wa):
                continue
            try:
                await asyncio.wait_for(w.stop_role(r["token"]),
                                       timeout=self.knobs.FAILURE_TIMEOUT)
            except (FdbError, asyncio.TimeoutError, OSError):
                pass

    async def publish_state(self, mutate) -> dict:
        """Publish a mid-epoch cluster-state update — how a live shard
        move's flip reaches clients without a recovery.  ``mutate(state)
        -> state`` transforms a copy of the last state; the sequence
        number bumps so client views rebuild (epoch ties, seq advances).
        Refuses when a newer epoch exists (this controller is deposed)."""
        assert self.last_state is not None, "publish before first recovery"
        new = mutate(dict(self.last_state))
        new["seq"] = self.last_state.get("seq", 0) + 1
        _, cur = await self.cstate.read()
        if cur is not None and cur.get("epoch", 0) > self.epoch:
            raise FdbError("deposed: newer epoch published")
        await self.cstate.write(new)
        self.last_state = new
        TraceEvent("StatePublished").detail("Epoch", self.epoch) \
            .detail("Seq", new["seq"]).log()
        return new

    async def _read_system_state(self, prev_state: dict | None, spec,
                                 recovery_version: Version | None = None):
        """Read the ``\\xff`` metadata range from a surviving storage
        replica: conf keys merge into the recruitment spec
        (REF:fdbclient/SystemData.cpp / DatabaseConfiguration::
        fromKeyValues) and the keyServers layout (if any) becomes the
        desired shard map.  Epoch 1 has no storage yet; an unreachable
        metadata shard falls back to the static spec — recovery must
        never wedge on configuration reads."""
        from ..rpc.stubs import StorageClient
        from ..rpc.wire import decode
        from .data import KeyRange, SYSTEM_PREFIX
        from .system_data import (KEY_SERVERS_PREFIX, LOCKED_KEY,
                                  REGIONS_KEY, RESOLVER_BOUNDARIES_KEY,
                                  decode_backup_tags, decode_conf,
                                  spec_with_conf)
        if not prev_state:
            return spec, None, set(), {}, None, None
        sys_end = SYSTEM_PREFIX + b"\xfe"
        for s in prev_state.get("storage", []):
            if not (s["begin"] <= SYSTEM_PREFIX < s["end"]):
                continue
            wa = NetworkAddress(s["worker"][0], s["worker"][1])
            if not self.fm.is_available(wa):
                continue
            stub = StorageClient(self.transport, NetworkAddress(*s["addr"]),
                                 s["token"], s["tag"],
                                 KeyRange(s["begin"], s["end"]))
            try:
                # the replica must have pulled through the recovery
                # version: a lock/backup-tag/configure txn committed just
                # before the crash is on the locked TLogs but may not be
                # applied here yet — a lagging snapshot would silently
                # recover without it
                rows, _ = await asyncio.wait_for(
                    stub.get_latest_range(SYSTEM_PREFIX, sys_end, 1000,
                                          recovery_version),
                    timeout=self.knobs.FAILURE_TIMEOUT * 2)
            except (FdbError, asyncio.TimeoutError):
                continue
            rows = [(bytes(k), bytes(v)) for k, v in rows]
            conf = decode_conf(rows)
            from .management import decode_excluded
            excluded = decode_excluded(rows)
            layout = None
            locked = None
            res_bounds = None
            backup_tags = decode_backup_tags(rows)
            for key, v in rows:
                if key == KEY_SERVERS_PREFIX + b"layout":
                    try:
                        layout = decode(v)
                    except Exception:  # noqa: BLE001 — bad layout ignored
                        layout = None
                elif key == RESOLVER_BOUNDARIES_KEY:
                    # DD's heat-driven resolver remap: applied
                    # below at recruitment, validated there
                    try:
                        res_bounds = [bytes(b) for b in decode(v)]
                    except Exception:  # noqa: BLE001 — bad blob ignored
                        res_bounds = None
                elif key == LOCKED_KEY:
                    locked = bytes(v)
                elif key == REGIONS_KEY:
                    # regions configured through the database itself
                    # override the static spec (configure_regions)
                    try:
                        regs = decode(v)
                        spec = dataclasses.replace(
                            spec, regions=[dict(r) for r in regs] or None)
                    except Exception:  # noqa: BLE001 — bad blob ignored
                        pass
            if conf or layout or excluded or backup_tags or locked:
                TraceEvent("RecoveryReadSystemState") \
                    .detail("Conf", str(conf)) \
                    .detail("Excluded", sorted(excluded)) \
                    .detail("BackupTags", str(backup_tags)) \
                    .detail("Locked", locked is not None) \
                    .detail("HasLayout", layout is not None).log()
            return (spec_with_conf(spec, conf), layout, excluded,
                    backup_tags, locked, res_bounds)
        return spec, None, set(), {}, None, None

    @staticmethod
    def _wire_gen(g: dict) -> dict:
        """Generation config as roles consume it.  The per-TLog token list
        MUST ride along: recruited TLogs live at recruited token blocks on
        shared worker transports, so a role rebuilding the log-system view
        dials each one at its recorded token (worker.generations_from_config)."""
        return {"epoch": g["epoch"], "begin": g["begin"], "end": g["end"],
                "tlogs": [tuple(a) for a in g["tlogs"]],
                "token": list(g.get("token", [])) or None,
                "replication": g["replication"],
                "dead": list(g.get("dead", [])),
                "satellites": [tuple(a) for a in g.get("satellites", [])],
                "sat_token": list(g.get("sat_token", [])),
                "sat_dead": list(g.get("sat_dead", [])),
                "routers": [list(r) for r in g.get("routers", [])]}

    # --- the controller main loop ---

    async def run(self) -> None:
        """Recover, then watch the txn subsystem; any role failure (or a
        fail-stopped resolver) triggers the next epoch.  Runs until
        cancelled (deposed or machine death)."""
        state: dict | None = None
        while not self._stopped:
            try:
                _, state = await self.cstate.read()
                state = await self.recover_once(state)
            except asyncio.CancelledError:
                raise
            except FdbError as e:
                from ..runtime.errors import CoordinatorsChanged
                if isinstance(e, CoordinatorsChanged):
                    # quorum change (intent marker or retired set): the
                    # host must complete/follow the move, not retry here
                    raise
                TraceEvent("RecoveryFailed", severity=30) \
                    .detail("Error", e.name).detail("Msg", str(e)).log()
                await self._stop_attempt_recruits()
                await asyncio.sleep(self.knobs.RECOVERY_RETRY_DELAY)
                continue
            except Exception as e:  # noqa: BLE001 — a wedged CC is worse
                TraceEvent("RecoveryFailed", severity=40) \
                    .detail("Error", repr(e)[:200]).log()
                await self._stop_attempt_recruits()
                await asyncio.sleep(self.knobs.RECOVERY_RETRY_DELAY)
                continue
            # watch every txn-subsystem address
            watch = [NetworkAddress(*state["sequencer"]["addr"])]
            watch += [NetworkAddress(*g)
                      for g in state["log_cfg"][-1]["tlogs"]]
            watch += [NetworkAddress(*g)
                      for g in state["log_cfg"][-1].get("satellites", [])]
            watch += [NetworkAddress(*r["addr"]) for r in state["resolvers"]]
            watch += [NetworkAddress(*p["addr"])
                      for p in state["commit_proxies"] + state["grv_proxies"]]
            if state.get("ratekeeper"):
                watch.append(NetworkAddress(*state["ratekeeper"]["addr"]))
            waiters = [asyncio.ensure_future(self.fm.wait_for_failure(a))
                       for a in set(watch)]
            self._recovery_requested.clear()
            waiters.append(asyncio.ensure_future(
                self._recovery_requested.wait()))
            # role-ENDPOINT liveness: a supervisor-respawned process
            # answers address pings while its recruited endpoints are
            # gone — the address watch above never fires, yet the epoch
            # cannot commit (every push gets endpoint_not_found)
            waiters.append(asyncio.ensure_future(self._probe_roles(state)))
            waiters.append(asyncio.ensure_future(
                self._watch_region_preference(state)))
            # quorum-change watch: a changeQuorum intent written while
            # we idle must be noticed (the mover may have died right
            # after phase 1; the CC is then the one who completes it)
            waiters.append(asyncio.ensure_future(self._watch_quorum_change()))
            # disk-health poll: feeds worker disk latency
            # into the FailureMonitor's degraded state; never completes,
            # so it can never trigger a recovery by itself
            waiters.append(asyncio.ensure_future(self._watch_disk_health()))
            try:
                done, pending = await asyncio.wait(
                    waiters, return_when=asyncio.FIRST_COMPLETED)
            finally:
                for w in waiters:
                    w.cancel()
                await asyncio.gather(*waiters, return_exceptions=True)
            from ..runtime.errors import CoordinatorsChanged
            for w in done:
                exc = w.exception()
                if isinstance(exc, CoordinatorsChanged):
                    raise exc       # quorum change: the host completes it
                if exc is not None:
                    # a watcher died unexpectedly: recover in place (the
                    # old behavior), never tear the CC down for it
                    TraceEvent("WatcherFailed", severity=30) \
                        .detail("Error", repr(exc)[:200]).log()
            TraceEvent("TxnRoleFailed").detail("Epoch", self.epoch).log()

    async def _watch_quorum_change(self) -> None:
        """Poll for a changeQuorum intent marker or a retired quorum;
        completes (by raising CoordinatorsChanged) when one appears.
        Uses open_database ONLY — it never registers a read generation,
        so the poll cannot invalidate this CC's own cstate writes."""
        from ..runtime.errors import CoordinatorsChanged
        while True:
            await asyncio.sleep(self.knobs.FAILURE_TIMEOUT * 2)
            replies = await asyncio.gather(
                *(c.open_database() for c in self.cstate.coordinators),
                return_exceptions=True)
            for r in replies:
                if not isinstance(r, dict):
                    continue
                if "__moved_to__" in r:
                    e = CoordinatorsChanged()
                    e.moving_to = None      # forward exists: just follow
                    raise e
                if "__moving_to__" in r:
                    # an un-completed intent (the mover died after phase
                    # 1): this CC completes the move
                    e = CoordinatorsChanged()
                    e.moving_to = r["__moving_to__"]
                    e.inner_value = r.get("__value__")
                    raise e

    async def _watch_disk_health(self) -> None:
        """Poll every live worker's disk_health and maintain the
        FailureMonitor's degraded set (gray-failure
        detection).  Per-worker failures are skipped — a machine whose
        health RPC fails is the BINARY monitor's problem; this loop
        only tracks the slow-but-alive case.

        UN-degrading dwells (the
        ``_watch_region_preference`` hysteresis shape): the flag clears
        only after ``CC_DISK_UNDEGRADE_DWELL_S`` of consecutively
        healthy reports — a disk whose decayed latency oscillates
        around the threshold would otherwise thrash recruitment
        ordering and DD destination picking on every poll.  Degrading
        stays immediate (reacting late to a sick disk costs p99).

        When the degraded SET changes, the cluster state republishes
        with a ``degraded`` worker-address list (a seq bump, the live
        shard-move discipline) so CLIENTS can rank degraded replicas
        last for reads too."""
        interval = self.knobs.CC_DISK_HEALTH_INTERVAL
        if interval <= 0:
            await asyncio.Event().wait()    # disabled; park forever
        healthy_since: dict = {}        # addr -> loop time of 1st healthy
        while True:
            await asyncio.sleep(interval)
            now = asyncio.get_running_loop().time()
            for addr, w in self._live_workers():
                try:
                    h = await asyncio.wait_for(
                        w.disk_health(),
                        timeout=self.knobs.FAILURE_TIMEOUT)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — binary monitor's job
                    continue
                bad = bool(h.get("disk_degraded"))
                lat = float(h.get("disk_latency_ms", 0.0))
                if bad:
                    healthy_since.pop(addr, None)
                    self.fm.set_degraded(addr, True, lat)
                elif self.fm.is_degraded(addr):
                    since = healthy_since.setdefault(addr, now)
                    if now - since >= self.knobs.CC_DISK_UNDEGRADE_DWELL_S:
                        healthy_since.pop(addr, None)
                        self.fm.set_degraded(addr, False, lat)
                else:
                    healthy_since.pop(addr, None)
            degraded = sorted((a.ip, a.port)
                              for a in self.fm.degraded_addresses())
            if self.last_state is not None and \
                    degraded != self.last_state.get("degraded", []):
                try:
                    await self.publish_state(
                        lambda s: {**s, "degraded": degraded})
                except Exception:  # noqa: BLE001 — deposed/unreachable:
                    # the next epoch's CC owns the signal
                    pass

    async def _probe_roles(self, state: dict) -> None:
        """Ping each recruited txn role's block-level liveness slot
        (serve_role's base + TOKEN_BLOCK - 1); returning completes the
        run() watch and starts a recovery.  Two consecutive
        endpoint_not_found answers mean the role instance is gone even
        though its process is reachable (crash + supervisor respawn
        between recruitment and now).  Connection-level failures stay
        the FailureMonitor's job."""
        from ..rpc.stubs import TOKEN_BLOCK
        from ..rpc.transport import Endpoint
        targets: list[tuple[tuple, int | None]] = [
            (tuple(state["sequencer"]["addr"]), state["sequencer"]["token"])]
        gen = state["log_cfg"][-1]
        toks = gen.get("token") or [None] * len(gen["tlogs"])
        targets += [(tuple(a), t) for a, t in zip(gen["tlogs"], toks)]
        targets += [(tuple(a), t) for a, t in
                    zip(gen.get("satellites", []),
                        gen.get("sat_token", []))]
        targets += [(tuple(r["addr"]), r["token"])
                    for r in state["resolvers"]]
        targets += [(tuple(p["addr"]), p["token"]) for p in
                    state["commit_proxies"] + state["grv_proxies"]]
        strikes: dict[tuple, int] = {}
        while True:
            await asyncio.sleep(self.knobs.FAILURE_TIMEOUT)
            for addr, tok in targets:
                if tok is None:
                    continue
                ep = Endpoint(NetworkAddress(*addr),
                              tok + TOKEN_BLOCK - 1)
                try:
                    await asyncio.wait_for(
                        self.transport.request(ep, []),
                        timeout=self.knobs.FAILURE_TIMEOUT)
                    strikes[(addr, tok)] = 0
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — classify by code
                    if getattr(e, "code", None) == 1012:
                        n = strikes.get((addr, tok), 0) + 1
                        strikes[(addr, tok)] = n
                        if n >= 2:
                            TraceEvent("RoleEndpointLost", severity=30) \
                                .detail("Addr", str(addr)) \
                                .detail("Token", tok).log()
                            return

    async def _watch_region_preference(self, state: dict) -> None:
        """Automatic failback (REF:fdbserver/ClusterController.actor.cpp
        betterMasterExists, region priority): when a HIGHER-priority
        region than the current primary has live registered workers for
        two consecutive probes, returning completes the run() watch and
        the next recovery re-evaluates primaries — moving the transaction
        subsystem home.  Never fires single-region."""
        regions = state.get("regions")
        cur = state.get("primary_dc")
        if not regions or cur is None:
            await asyncio.Event().wait()    # nothing to prefer; park
        ordered = sorted(regions, key=lambda r: -int(r.get("priority", 0)))
        better = [r["id"] for r in ordered]
        better = better[:better.index(cur)] if cur in better else better
        if not better:
            await asyncio.Event().wait()    # already in the best region
        streak = 0
        while True:
            await asyncio.sleep(self.knobs.FAILURE_TIMEOUT * 4)
            alive = {(self.locality.get(a) or {}).get("dcid")
                     for a, _ in self._live_workers()}
            if any(dc in alive for dc in better):
                streak += 1
                if streak >= 2:     # dwell: a flapping region can't thrash
                    TraceEvent("RegionFailback").detail("From", cur) \
                        .detail("Candidates", better).log()
                    return
            else:
                streak = 0

    async def stop(self) -> None:
        self._stopped = True
        await self.fm.close()
