"""Operational workloads: Rollback, RandomMoveKeys, TagThrottle,
LowLatency, BackupToDBCorrectness.

Reference: REF:fdbserver/workloads/{Rollback,RandomMoveKeys,TagThrottle,
LowLatency,BackupToDBCorrectness}.actor.cpp — each puts one
subsystem (TLog recovery, DD manual moves, Ratekeeper tag throttles, GRV
latency floors, DR switchover) under an invariant while the chaos mix
runs.
"""

from __future__ import annotations

import asyncio

from ..runtime.errors import FdbError
from ..runtime.trace import TraceEvent
from .workload import TestWorkload, register_workload


@register_workload
class RollbackWorkload(TestWorkload):
    """Kill-driven TLog rollback: writes a numbered stream, records every
    ACKED key, then a TLog-hosting machine dies mid-stream.  After the
    forced recovery EVERY acked key must still read back — unacked tail
    writes may be rolled back, acked ones never
    (REF:fdbserver/workloads/Rollback.actor.cpp)."""

    name = "Rollback"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sim = self.opt("sim", None)
        self.n = int(self.opt("writes", 40))
        self.kill_at = int(self.opt("killAt", 20))
        self.acked: list[bytes] = []
        self.rolled = 0

    def _key(self, i: int) -> bytes:
        return b"rollback/%02d/%04d" % (self.ctx.client_id, i)

    async def start(self) -> None:
        for i in range(self.n):
            key = self._key(i)

            async def do(tr, key=key):
                tr.set(key, b"acked")
            try:
                await self.db.run(do)
                self.acked.append(key)
            except FdbError:
                continue        # unknown result: not counted as acked
            if i == self.kill_at and self.ctx.client_id == 0 \
                    and self.sim is not None:
                state = await self.sim.wait_epoch(1)
                tlog_ips = {tuple(a)[0]
                            for a in state["log_cfg"][-1]["tlogs"]}
                victims = [m for m in self.machines_with(tlog_ips)
                           if m.alive]
                if victims:
                    # kill + reboot the TLog machine: the epoch recovery
                    # rolls the log generation; the machine's durable
                    # state (run Rollback with durableStorage) rejoins so
                    # no replica is lost — acked writes must all survive
                    # the rolled-back generation
                    m = victims[int(self.rng.random_int(0, len(victims)))]
                    epoch = state["epoch"]
                    await m.kill()
                    TraceEvent("RollbackKill").detail("IP", m.ip).log()
                    await self.sim.wait_epoch(epoch + 1)
                    await m.reboot()
                    self.rolled += 1

    def machines_with(self, ips):
        return [m for m in self.sim.machines if m.ip in ips]

    async def check(self) -> bool:
        tr = self.db.create_transaction()
        for key in self.acked:
            while True:
                try:
                    v = await tr.get(key)
                    break
                except FdbError as e:
                    await tr.on_error(e)
            assert v == b"acked", f"ACKED write lost after rollback: {key}"
        return True

    def metrics(self):
        return {"acked_writes": len(self.acked),
                "rollback_kills": self.rolled}


@register_workload
class RandomMoveKeysWorkload(TestWorkload):
    """Manual live shard moves at random, THROUGH DataDistribution's own
    journaled relocation machinery, while traffic runs; concurrent
    invariant workloads (Cycle etc.) prove no data loss
    (REF:fdbserver/workloads/RandomMoveKeys.actor.cpp)."""

    name = "RandomMoveKeys"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sim = self.opt("sim", None)
        self.moves = int(self.opt("moves", 3))
        self.between = float(self.opt("secondsBetweenMoves", 2.0))
        self.requested = 0

    async def start(self) -> None:
        if self.ctx.client_id != 0 or self.sim is None:
            return
        for _ in range(self.moves):
            await asyncio.sleep(self.between)
            dd = self.sim.leader_dd()
            if dd is None:
                continue
            state = await self.sim.wait_epoch(1)
            n_shards = len(state.get("shard_teams", [])) or 1
            idx = int(self.rng.random_int(0, n_shards))
            before = dd.live_moves_done
            dd.request_relocation(idx)
            self.requested += 1
            TraceEvent("RandomMoveKeysRequest").detail("Shard", idx).log()
            # wait (bounded) for the move to complete or the DD to churn
            for _ in range(40):
                await asyncio.sleep(0.25)
                dd2 = self.sim.leader_dd()
                if dd2 is None or dd2 is not dd \
                        or dd.live_moves_done > before:
                    break

    async def check(self) -> bool:
        return self.sim is None or self.requested > 0

    def metrics(self):
        return {"moves_requested": self.requested}


@register_workload
class TagThrottleWorkload(TestWorkload):
    """Ratekeeper v2's per-tag throttling under an invariant: a tag
    clamped to a low rate must observe LOWER throughput than untagged
    traffic running beside it, and untagged traffic must not be dragged
    down to the tag's clamp
    (REF:fdbserver/workloads/TagThrottle.actor.cpp)."""

    name = "TagThrottle"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sim = self.opt("sim", None)
        self.seconds = float(self.opt("seconds", 4.0))
        self.rate = float(self.opt("tagRate", 5.0))
        self.tagged_done = 0
        self.untagged_done = 0
        self._stop = False

    async def _loop(self, tag: str | None) -> int:
        done = 0
        tr = self.db.create_transaction()
        if tag is not None:
            tr.throttle_tag = tag
        while not self._stop:
            try:
                k = b"tagthrottle/%s/%02d" % (
                    (tag or "none").encode(), self.ctx.client_id)
                tr.set(k, b"%d" % done)
                await tr.commit()
                tr.reset()
                if tag is not None:
                    tr.throttle_tag = tag
                done += 1
            except FdbError as e:
                try:
                    await tr.on_error(e)
                except FdbError:
                    tr.reset()
        return done

    async def start(self) -> None:
        # clamp the hot tag directly at the ratekeeper (the manual
        # throttle path; auto-detection is Ratekeeper v2's own logic)
        rk = self._find_rk() if self.sim is not None else None
        if rk is not None:
            await rk.set_tag_throttle("hot", self.rate)
        stopper = asyncio.get_running_loop().create_task(self._sleep())
        tagged = asyncio.get_running_loop().create_task(self._loop("hot"))
        untagged = asyncio.get_running_loop().create_task(self._loop(None))
        await stopper
        self.tagged_done = await tagged
        self.untagged_done = await untagged
        if rk is not None:
            await rk.set_tag_throttle("hot", None)

    def _find_rk(self):
        """The live Ratekeeper INSTANCE (it is a recruited role hosted by
        some worker): scan the sim machines' worker role tables."""
        from ..core.ratekeeper import Ratekeeper
        for m in self.sim.machines:
            if not m.alive or m.host is None:
                continue
            for _token, (role, obj) in getattr(m.host.worker, "roles",
                                               {}).items():
                if role == "ratekeeper" and isinstance(obj, Ratekeeper):
                    return obj
        return None

    async def _sleep(self) -> None:
        await asyncio.sleep(self.seconds)
        self._stop = True

    async def check(self) -> bool:
        if self.sim is None or self._find_rk() is None:
            return True
        # the clamped tag must be visibly slower than open traffic
        assert self.untagged_done > self.tagged_done, \
            (f"tag throttle had no effect: tagged {self.tagged_done} "
             f">= untagged {self.untagged_done}")
        return True

    def metrics(self):
        return {"tagged_txns": self.tagged_done,
                "untagged_txns": self.untagged_done}


@register_workload
class LowLatencyWorkload(TestWorkload):
    """Continuous GRV + tiny-commit probes: max observed latency must
    stay under a bound even while the chaos mix churns roles — the
    liveness floor the reference's LowLatency workload enforces
    (REF:fdbserver/workloads/LowLatency.actor.cpp).  Under virtual time
    the bound catches deadlocks and unbounded queueing, not wall-clock
    perf."""

    name = "LowLatency"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.seconds = float(self.opt("seconds", 5.0))
        self.bound = float(self.opt("maxLatency", 20.0))
        self.probes = 0
        self.worst = 0.0

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.seconds
        while loop.time() < deadline:
            t0 = loop.time()
            tr = self.db.create_transaction()
            try:
                await tr.get_read_version()
                tr.set(b"lowlat/%02d" % self.ctx.client_id, b"x")
                await tr.commit()
                self.worst = max(self.worst, loop.time() - t0)
                self.probes += 1
            except FdbError as e:
                try:
                    await tr.on_error(e)
                except FdbError:
                    pass
            tr.reset()
            await asyncio.sleep(0.25)

    async def check(self) -> bool:
        assert self.probes > 0
        assert self.worst <= self.bound, \
            f"latency probe exceeded bound: {self.worst:.2f}s > {self.bound}s"
        return True

    def metrics(self):
        return {"latency_probes": self.probes,
                "worst_latency_s": self.worst}


@register_workload
class BackupToDBCorrectnessWorkload(TestWorkload):
    """DR with a mid-run SWITCHOVER: source streams to a destination
    cluster, roles flip atomically mid-traffic, and at the end the
    destination (now primary) holds a byte-identical copy
    (REF:fdbserver/workloads/BackupToDBCorrectness.actor.cpp — the
    switchover variant; the plain-drain variant is DRUnderAttrition)."""

    name = "BackupToDBCorrectness"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.dr = None
        self._dest_cluster = None
        self.switched = False

    async def setup(self) -> None:
        if self.ctx.client_id != 0:
            return
        from ..backup.dr import DRAgent
        from ..client.database import Database
        from ..core.cluster import Cluster, ClusterConfig
        from ..runtime.knobs import Knobs
        self._dest_cluster = Cluster(ClusterConfig(), Knobs(),
                                     device=self.ctx.device)
        await self._dest_cluster.__aenter__()
        dest = Database(self._dest_cluster)
        self.dr = DRAgent(self.db, dest, name="b2db")
        await self.dr.start()

    async def start(self) -> None:
        if self.dr is None:
            return
        # traffic before the flip
        for i in range(10):
            async def do(tr, i=i):
                tr.set(b"b2db/pre/%04d" % i, b"v%d" % i)
            await self.db.run(do)
        await self.dr.switchover()
        self.switched = True
        TraceEvent("B2DBSwitchover").log()

    async def check(self) -> bool:
        if self.dr is None:
            return True
        assert self.switched
        from ..core.data import SYSTEM_PREFIX
        # after switchover the DESTINATION serves unlocked; every pre-flip
        # row must be there byte-for-byte
        dest_tr = self.dr.dest.create_transaction()
        while True:
            try:
                rows = await dest_tr.get_range(b"b2db/pre/", b"b2db/pre0",
                                               limit=0)
                break
            except FdbError as e:
                await dest_tr.on_error(e)
        assert len(rows) == 10, f"switchover lost rows: {len(rows)}/10"
        for i, (k, v) in enumerate(rows):
            assert v == b"v%d" % i
        await self._dest_cluster.__aexit__(None, None, None)
        return True


@register_workload
class ChangeCoordinatorsWorkload(TestWorkload):
    """changeQuorum mid-chaos: move the coordinator set onto different
    machines while other workloads run; the cluster must keep serving
    and every host must repoint (REF:fdbserver/workloads/
    ChangeConfig.actor.cpp coordinator-change arm)."""

    name = "ChangeCoordinators"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sim = self.opt("sim", None)
        self.after = float(self.opt("secondsBefore", 3.0))
        self.changed = 0
        self.skipped = False

    async def start(self) -> None:
        if self.ctx.client_id != 0 or self.sim is None:
            return
        from ..core.cluster_client import fetch_cluster_state
        from ..core.coordination import change_coordinators
        from ..rpc.stubs import make_coordinator_stubs
        await asyncio.sleep(self.after)
        old_addrs = list(self.sim.coord_addrs)
        # target: rotate one coordinator onto a machine outside the set
        candidates = [m for m in self.sim.machines
                      if m.alive and m.addr not in old_addrs]
        if not candidates:
            # chaos may have every non-coordinator machine down at this
            # instant: a skipped change is not a failed one
            self.skipped = True
            return
        new_m = candidates[int(self.rng.random_int(0, len(candidates)))]
        new_addrs = old_addrs[1:] + [new_m.addr]
        t = self.sim.client_transport()
        old_stubs = make_coordinator_stubs(old_addrs, transport=t)
        new_stubs = make_coordinator_stubs(new_addrs, transport=t)
        await change_coordinators(old_stubs, new_stubs, new_addrs,
                                  self.sim.knobs, mover_id=424242)
        self.sim.coord_addrs = new_addrs
        TraceEvent("ChangeCoordinatorsDone").detail(
            "NewSet", str([f"{a.ip}:{a.port}" for a in new_addrs])).log()
        # the NEW member alone must serve the cluster state (proves the
        # copy landed and the new register answers — a wait through the
        # carried-over members would pass vacuously)
        solo = make_coordinator_stubs([new_m.addr], transport=t)
        while True:
            try:
                st = await fetch_cluster_state(solo)
                if st.get("epoch", 0) >= 1:
                    break
            except Exception:  # noqa: BLE001 — repoint/recovery in flight
                pass
            await asyncio.sleep(0.25)
        self.changed = 1

    async def check(self) -> bool:
        return self.sim is None or self.changed == 1 or self.skipped

    def metrics(self):
        return {"quorum_changes": self.changed}
