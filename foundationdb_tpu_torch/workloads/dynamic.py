"""Dynamic-behavior workloads: watches and live reconfiguration.

Reference: REF:fdbserver/workloads/Watches.actor.cpp (watch latency +
fire-on-change semantics) and ConfigureDatabase.actor.cpp (random
``configure`` churn mid-run — recoveries under load must preserve every
other workload's invariant).
"""

from __future__ import annotations

import asyncio

from ..runtime.trace import TraceEvent
from .workload import TestWorkload, register_workload


@register_workload
class WatchesWorkload(TestWorkload):
    """Writers bump counters; watchers arm watches and verify each fire
    reflects a real change (the value differs from the watched
    baseline).  A watch that never fires would wedge the run — the
    liveness half of the check."""

    name = "Watches"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.n_keys = int(self.opt("nodeCount", 4))
        self.rounds = int(self.opt("rounds", 4))
        self.prefix = bytes(self.opt("prefix", b"watch/"))
        # under fault injection a watch may fire on a commit a recovery
        # then rolls back (the version was never acked) — the reference
        # explicitly permits spurious fires, so chaos runs set
        # strictFires=False and merely count them
        self.strict = bool(self.opt("strictFires", True))
        self.fires = 0
        self.spurious = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % i

    async def setup(self) -> None:
        async def fill(tr):
            for i in range(self.n_keys):
                tr.set(self._key(i), b"%08d" % 0)
        await self.db.run(fill)

    async def start(self) -> None:
        done = asyncio.Event()

        async def writer() -> None:
            j = 1
            while not done.is_set():
                i = self.rng.random_int(0, self.n_keys - 1)

                async def bump(tr, i=i, j=j):
                    tr.set(self._key(i), b"%08d" % j)
                await self.db.run(bump)
                j += 1
                await asyncio.sleep(0.05)

        wtask = asyncio.ensure_future(writer())
        try:
            fired = 0
            while fired < self.rounds:
                i = self.rng.random_int(0, self.n_keys - 1)
                tr = self.db.create_transaction()
                while True:
                    try:
                        baseline = await tr.get(self._key(i))
                        fut = await tr.watch(self._key(i))
                        await tr.commit()
                        break
                    except BaseException as e:
                        await tr.on_error(e)
                # race the watch against the writer: if the writer dies,
                # no key ever changes again and a bare `await fut` would
                # hang the run instead of surfacing the writer's error
                await asyncio.wait({fut, wtask},
                                   return_when=asyncio.FIRST_COMPLETED)
                if wtask.done() and not done.is_set():
                    fut.cancel()
                    wtask.result()      # re-raise the writer's error
                    raise AssertionError("watch writer exited early")
                try:
                    await fut
                except Exception:   # noqa: BLE001 — storage died: re-arm
                    continue
                fired += 1
                self.fires += 1
                now = await self.db.get(self._key(i))
                if now == baseline:
                    self.spurious += 1
                    assert not self.strict, \
                        f"watch fired without a change on key {i}"
        finally:
            done.set()
            await wtask

    async def check(self) -> bool:
        return self.fires >= self.rounds

    def metrics(self):
        return {"watch_fires": self.fires, "watch_spurious": self.spurious}


@register_workload
class ConfigureDatabaseWorkload(TestWorkload):
    """Random configuration churn: rewrite \\xff/conf/ role counts and
    force a recovery, repeatedly, while other workloads run.  The
    reference's ConfigureDatabase does the same via ``fdbcli
    configure``; surviving it proves recruitment honors the system
    keyspace and recoveries don't lose acked data (the concurrent
    Cycle/Serializability checks enforce that part)."""

    name = "ConfigureDatabase"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sim = self.opt("sim", None)
        self.rounds = int(self.opt("rounds", 3))
        self.between = float(self.opt("secondsBetweenChanges", 2.0))
        self.changes = 0

    async def start(self) -> None:
        if self.ctx.client_id != 0 or self.sim is None:
            return
        from ..core.management import configure
        for _ in range(self.rounds):
            await asyncio.sleep(self.between)
            cfg = {
                "resolvers": self.rng.random_int(1, 2),
                "logs": self.rng.random_int(2, 3),
                "commit_proxies": self.rng.random_int(1, 2),
                "grv_proxies": self.rng.random_int(1, 2),
            }
            await configure(self.db, **cfg)
            await asyncio.sleep(0.5)    # storage applies the conf mutations
            cc = self.sim.leader_cc()
            if cc is None:
                continue        # mid-election; the next round retries
            cc.request_recovery("ConfigureDatabase workload")
            # wait for a published state honoring the new counts (a
            # CONCURRENT recovery — attrition — may land first having
            # read the old conf; the conf persists, so some later epoch
            # must reflect it)
            await self.sim.wait_state(lambda s: (
                len(s["resolvers"]) == cfg["resolvers"]
                and len(s["log_cfg"][-1]["tlogs"]) == cfg["logs"]
                and len(s["commit_proxies"]) == cfg["commit_proxies"]
                and len(s["grv_proxies"]) == cfg["grv_proxies"]))
            self.changes += 1
            TraceEvent("ConfigureRound").detail("Cfg", str(cfg)).log()

    async def check(self) -> bool:
        return self.sim is None or self.changes > 0

    def metrics(self):
        return {"config_changes": self.changes}
