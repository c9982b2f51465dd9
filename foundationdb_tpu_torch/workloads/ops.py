"""Operational workloads: backup/DR under chaos, live-move storms,
lock cycling, directory churn, region failover, engine migration.

Reference: REF:fdbserver/workloads/ — BackupCorrectness.actor.cpp,
BackupToDBCorrectness.actor.cpp (DR), RandomMoveKeys.actor.cpp,
LockDatabase*.actor.cpp, Directory test workloads — the operational
machinery must keep its own invariants while attrition/clogging
workloads supply the chaos in the same run.
"""

from __future__ import annotations

import asyncio

from ..runtime.trace import TraceEvent
from .workload import TestWorkload, register_workload


@register_workload
class BackupUnderAttritionWorkload(TestWorkload):
    """Continuous mutation-log backup running through the whole chaotic
    run.  Check: the stream stayed live (pulled past the final commit)
    and a snapshot backup taken at quiescence reads back byte-identical
    to the database (REF:fdbserver/workloads/BackupCorrectness)."""

    name = "BackupUnderAttrition"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.agent = None
        self.snapshots = 0

    async def setup(self) -> None:
        if self.ctx.client_id != 0:
            return
        from ..backup.agent import BackupAgent
        from ..runtime.files import SimFileSystem
        self.agent = BackupAgent(self.db, SimFileSystem(),
                                 "backup-chaos", rows_per_file=50)
        await self.agent.start_continuous()

    async def start(self) -> None:
        if self.agent is None:
            return
        # periodic snapshot backups while the cluster is under fire;
        # transient failures retry next round (the agent's transactions
        # already follow recoveries)
        for _ in range(int(self.opt("snapshots", 3))):
            await asyncio.sleep(float(self.opt("secondsBetween", 3.0)))
            try:
                await self.agent.backup()
                self.snapshots += 1
            except Exception as e:  # noqa: BLE001 — chaos mid-backup
                TraceEvent("BackupChaosSnapshotFailed", severity=30) \
                    .detail("Error", repr(e)[:120]).log()

    async def check(self) -> bool:
        if self.agent is None:
            return True
        from ..core.data import SYSTEM_PREFIX
        await self.agent.stop_continuous()
        manifest = await self.agent.backup()     # final quiescent snapshot
        rows = []
        for name in manifest.range_files:
            _v, page = await self.agent.container.read_snapshot_page(name)
            rows.extend((bytes(k), bytes(v)) for k, v in page)
        tr = self.db.create_transaction()
        while True:
            try:
                live = await tr.get_range(b"", SYSTEM_PREFIX, limit=0)
                break
            except Exception as e:  # noqa: BLE001
                await tr.on_error(e)
        live = [(bytes(k), bytes(v)) for k, v in live]
        assert rows == live, \
            f"backup diverged: {len(rows)} backup rows vs {len(live)} live"
        return True

    def metrics(self):
        return {"snapshots": self.snapshots}


@register_workload
class DRUnderAttritionWorkload(TestWorkload):
    """Cluster-to-cluster DR running through the chaos: the destination
    (a lightweight in-process cluster) must converge to a byte-identical
    copy once the source quiesces
    (REF:fdbserver/workloads/BackupToDBCorrectness)."""

    name = "DRUnderAttrition"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.dr = None
        self._dest_cluster = None

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
        self.dr = DRAgent(self.db, dest)
        await self.dr.start()

    async def check(self) -> bool:
        if self.dr is None:
            return True
        from ..core.data import SYSTEM_PREFIX
        await self.dr.drain()
        src_tr = self.db.create_transaction()
        while True:
            try:
                src_rows = await src_tr.get_range(b"", SYSTEM_PREFIX,
                                                  limit=0)
                break
            except Exception as e:  # noqa: BLE001
                await src_tr.on_error(e)
        dest_tr = self.dr.dest.create_transaction()
        dest_tr.lock_aware = True
        dest_rows = await dest_tr.get_range(b"", SYSTEM_PREFIX, limit=0)
        a = [(bytes(k), bytes(v)) for k, v in src_rows]
        b = [(bytes(k), bytes(v)) for k, v in dest_rows]
        assert a == b, f"DR diverged: {len(a)} src rows vs {len(b)} dest"
        await self.dr.stop()
        await self._dest_cluster.__aexit__(None, None, None)
        return True


@register_workload
class LiveMoveStormWorkload(TestWorkload):
    """Force a storm of live shard splits (fat writes across widening
    prefixes with DD's split threshold low) — every split must happen
    LIVE (epoch unchanged unless other chaos recovers) and the other
    workloads' invariants must hold (REF:RandomMoveKeys intent)."""

    name = "LiveMoveStorm"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sim = self.opt("sim", None)
        self.rows = int(self.opt("rows", 150))
        self.value_bytes = int(self.opt("valueBytes", 60))
        self.splits_seen = 0

    async def start(self) -> None:
        cid = self.ctx.client_id
        for i in range(self.rows):
            key = b"storm%02d%05d" % (cid, i)

            async def do(tr, key=key):
                tr.set(key, b"v" * self.value_bytes)
            await self.db.run(do)
            if i % 10 == 0:
                await asyncio.sleep(0.05)

    async def check(self) -> bool:
        if self.ctx.client_id != 0 or self.sim is None:
            return True
        state = await self.sim.wait_state(
            lambda s: len(s["shard_teams"]) > 2)
        self.splits_seen = len(state["shard_teams"]) - 2
        tr = self.db.create_transaction()
        while True:
            try:
                rows = await tr.get_range(b"storm", b"stoso", limit=0)
                break
            except Exception as e:  # noqa: BLE001
                await tr.on_error(e)
        expect = self.rows * self.ctx.client_count
        assert len(rows) == expect, \
            f"rows lost across the move storm: {len(rows)}/{expect}"
        return True

    def metrics(self):
        return {"splits": self.splits_seen}


@register_workload
class LockCyclingWorkload(TestWorkload):
    """Cycle the database lock: while locked, plain commits must be
    refused and lock-aware ones admitted; after unlock everything flows
    (REF:fdbserver/workloads/LockDatabase.actor.cpp).  Run it with
    lock-tolerant company only — plain-writer workloads in the same spec
    would see database_locked by design."""

    name = "LockCycling"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.rounds = int(self.opt("rounds", 3))
        self.cycles = 0

    async def start(self) -> None:
        if self.ctx.client_id != 0:
            return
        from ..core.management import lock_database, unlock_database
        from ..runtime.errors import DatabaseLocked
        uid = b"lock-cycling"
        for i in range(self.rounds):
            await lock_database(self.db, uid)
            # plain commit refused
            tr = self.db.create_transaction()
            tr.set(b"lockprobe", b"%d" % i)
            try:
                await tr.commit()
                raise AssertionError("commit admitted under lock")
            except DatabaseLocked:
                pass
            # lock-aware commit admitted
            tr = self.db.create_transaction()
            tr.lock_aware = True
            tr.set(b"lockaware", b"%d" % i)
            await tr.commit()
            await unlock_database(self.db, uid)
            # unlocked: plain commit flows again
            async def do(tr, i=i):
                tr.set(b"lockprobe", b"%d" % i)
            await self.db.run(do)
            self.cycles += 1
            await asyncio.sleep(float(self.opt("secondsBetween", 0.5)))

    async def check(self) -> bool:
        if self.ctx.client_id != 0:
            return True
        v = await self.db.get(b"lockaware")
        assert v == b"%d" % (self.rounds - 1)
        return True

    def metrics(self):
        return {"lock_cycles": self.cycles}


@register_workload
class DirectoryOpsWorkload(TestWorkload):
    """Directory-layer churn against a model: create/open/move/remove
    random paths; check the layer's listing matches the model exactly
    (REF:bindings directory tests as a server-side workload)."""

    name = "DirectoryOps"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.ops = int(self.opt("ops", 25))
        self.done = 0

    async def start(self) -> None:
        from ..client.directory import DirectoryLayer
        cid = self.ctx.client_id
        dl = DirectoryLayer()
        root = ("dirops", "c%d" % cid)
        self.model: set[tuple] = set()
        for i in range(self.ops):
            op = self.rng.random_int(0, 3)
            name = "d%d" % self.rng.random_int(0, 6)
            path = root + (name,)

            async def do(tr, op=op, path=path, dl=dl):
                if op == 0:
                    await dl.create_or_open(tr, path)
                    return "add"
                if op == 1 and await dl.exists(tr, path):
                    await dl.remove(tr, path)
                    return "del"
                if op == 2 and await dl.exists(tr, path):
                    dst = path[:-1] + (path[-1] + "m",)
                    if not await dl.exists(tr, dst):
                        await dl.move(tr, path, dst)
                        return "mv"
                return None
            from ..runtime.errors import DatabaseLocked
            while True:
                try:
                    res = await self.db.run(do)
                    break
                except DatabaseLocked:
                    # an operator lock cycle (LockCycling) is in force:
                    # back off like a real app and retry after unlock
                    await asyncio.sleep(0.3)
            if res == "add":
                self.model.add(path)
            elif res == "del":
                self.model.discard(path)
            elif res == "mv":
                self.model.discard(path)
                self.model.add(path[:-1] + (path[-1] + "m",))
            self.done += 1

    async def check(self) -> bool:
        from ..client.directory import DirectoryLayer
        dl = DirectoryLayer()
        root = ("dirops", "c%d" % self.ctx.client_id)

        async def ls(tr):
            if not await dl.exists(tr, root):
                return []
            return await dl.list(tr, root)
        names = sorted(await self.db.run(ls))
        want = sorted(p[-1] for p in self.model)
        assert names == want, f"directory mismatch: {names} != {want}"
        return True

    def metrics(self):
        return {"dir_ops": self.done}


@register_workload
class RegionFailoverWorkload(TestWorkload):
    """Kill the whole primary region mid-run, verify failover to the
    secondary, reboot the region, verify failback — while the other
    workloads in the spec keep their invariants
    (REF:fdbserver/TagPartitionedLogSystem region failover paths)."""

    name = "RegionFailover"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sim = self.opt("sim", None)
        self.dc = str(self.opt("primaryDc", "dc1"))
        self.rounds_done = 0

    async def start(self) -> None:
        if self.ctx.client_id != 0 or self.sim is None:
            return
        await asyncio.sleep(float(self.opt("secondsBefore", 3.0)))
        state0 = await self.sim.wait_state(
            lambda s: s.get("primary_dc") == self.dc)
        victims = await self.sim.kill_dc(self.dc)
        state1 = await self.sim.wait_state(
            lambda s: s["epoch"] > state0["epoch"]
            and s.get("primary_dc") not in (None, self.dc))
        TraceEvent("RegionFailoverWorkload").detail("To",
                                                    state1["primary_dc"]) \
            .log()
        await asyncio.sleep(float(self.opt("secondsFailedOver", 2.0)))
        for m in victims:
            await m.reboot()
        await self.sim.wait_state(
            lambda s: s["epoch"] > state1["epoch"]
            and s.get("primary_dc") == self.dc)
        self.rounds_done = 1

    async def check(self) -> bool:
        return self.ctx.client_id != 0 or self.sim is None \
            or self.rounds_done == 1

    def metrics(self):
        return {"failover_rounds": self.rounds_done}


@register_workload
class EngineMigrationWorkload(TestWorkload):
    """`configure storage_engine=` mid-run: every shard must live-move
    onto the new engine while the other workloads keep committing
    (REF:fdbclient/ManagementAPI changeStorageType)."""

    name = "EngineMigration"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sim = self.opt("sim", None)
        self.engine = str(self.opt("engine", "btree"))
        self.migrated = 0

    async def start(self) -> None:
        if self.ctx.client_id != 0 or self.sim is None:
            return
        from ..core.management import configure
        await asyncio.sleep(float(self.opt("secondsBefore", 2.0)))
        await configure(self.db, storage_engine=self.engine)
        state = await self.sim.wait_state(
            lambda s: s["storage"]
            and all(e.get("engine") == self.engine for e in s["storage"]))
        self.migrated = len(state["storage"])

    async def check(self) -> bool:
        return self.ctx.client_id != 0 or self.sim is None \
            or self.migrated > 0

    def metrics(self):
        return {"migrated_replicas": self.migrated}
