"""Fault-injection workloads: machine attrition and random clogging.

Reference: REF:fdbserver/workloads/MachineAttrition.actor.cpp and
RandomClogging.actor.cpp — run CONCURRENTLY with invariant workloads
(Cycle, Serializability): they supply the chaos, the others prove the
database survived it.  Both need the SimulatedCluster handle, passed via
the ``sim`` option.
"""

from __future__ import annotations

import asyncio

from ..runtime.trace import TraceEvent
from .workload import TestWorkload, register_workload


@register_workload
class MachineAttritionWorkload(TestWorkload):
    """Kill + reboot machines while others do real work.

    Only txn-role machines are eligible (storage re-replication needs
    DataDistribution; the reference's protectedAddresses plays the same
    role for coordinators)."""

    name = "MachineAttrition"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sim = self.opt("sim", None)
        self.kills = int(self.opt("machinesToKill", 2))
        self.between = float(self.opt("secondsBetweenKills", 3.0))
        self.reboot_after = float(self.opt("rebootAfter", 1.5))
        self.killed = 0

    async def start(self) -> None:
        if self.ctx.client_id != 0 or self.sim is None:
            return
        for i in range(self.kills):
            await asyncio.sleep(self.between)
            # re-derive victims from the CURRENT epoch's placement: after a
            # round, the rebooted machine usually hosts nothing until the
            # next recovery recruits on it
            victims = [m for m in await self.sim.txn_only_machines()
                       if m.alive]
            if not victims:
                continue
            m = victims[int(self.rng.random_int(0, len(victims)))]
            epoch_before = (await self.sim.wait_epoch(1))["epoch"]
            await m.kill()
            self.killed += 1
            # the cluster must publish a NEW epoch (recovery ran)
            await self.sim.wait_epoch(epoch_before + 1)
            await asyncio.sleep(self.reboot_after)
            await m.reboot()
            TraceEvent("AttritionRound").detail("Machine", m.ip) \
                .detail("Epoch", epoch_before + 1).log()

    def metrics(self):
        return {"machines_killed": self.killed}


@register_workload
class SwizzleWorkload(TestWorkload):
    """The simulator's swizzle: kill a random SUBSET of txn-role
    machines near-simultaneously, then reboot them in a DIFFERENT
    shuffled order (REF:fdbrpc/sim2.actor.cpp swizzle /
    RebootProcessAndSwitch) — the worst-case correlated failure the
    single-kill attrition workload never produces."""

    name = "Swizzle"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sim = self.opt("sim", None)
        self.rounds = int(self.opt("rounds", 1))
        self.delay = float(self.opt("secondsBefore", 3.0))
        self.swizzled = 0

    async def start(self) -> None:
        if self.ctx.client_id != 0 or self.sim is None:
            return
        for _ in range(self.rounds):
            await asyncio.sleep(self.delay)
            victims = [m for m in await self.sim.txn_only_machines()
                       if m.alive]
            if len(victims) < 2:
                continue
            # a random subset of >= 2, killed in one burst
            k = 2 + int(self.rng.random_int(0, len(victims) - 1))
            picks = list(victims)
            self.rng.shuffle(picks)
            subset = picks[:k]
            epoch_before = (await self.sim.wait_epoch(1))["epoch"]
            for m in subset:
                await m.kill()
                await asyncio.sleep(self.rng.random() * 0.05)
            # reboot in a DIFFERENT shuffled order
            order = list(subset)
            self.rng.shuffle(order)
            await asyncio.sleep(0.5)
            for m in order:
                await m.reboot()
                await asyncio.sleep(self.rng.random() * 0.1)
            # the cluster must recover to a NEW epoch with everyone back
            await self.sim.wait_epoch(epoch_before + 1)
            self.swizzled += len(subset)
            TraceEvent("SwizzleRound").detail("Killed", len(subset)) \
                .detail("Epoch", epoch_before + 1).log()

    def metrics(self):
        return {"machines_swizzled": self.swizzled}


@register_workload
class RandomCloggingWorkload(TestWorkload):
    """Randomly clog and partition (then heal) network links."""

    name = "RandomClogging"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sim = self.opt("sim", None)
        self.duration = float(self.opt("testDuration", 10.0))
        self.clogs = 0

    async def start(self) -> None:
        if self.ctx.client_id != 0 or self.sim is None:
            return
        loop = asyncio.get_running_loop()
        end = loop.time() + self.duration
        machines = self.sim.machines
        while loop.time() < end:
            await asyncio.sleep(0.5 + self.rng.random() * 1.0)
            a = machines[int(self.rng.random_int(0, len(machines)))]
            b = machines[int(self.rng.random_int(0, len(machines)))]
            if a is b:
                continue
            if self.rng.coinflip(0.7):
                self.sim.net.clog_pair(a.addr, b.addr,
                                       0.2 + self.rng.random() * 1.0)
            else:
                self.sim.net.partition(a.addr, b.addr)
                await asyncio.sleep(0.3 + self.rng.random() * 0.7)
                self.sim.net.heal(a.addr, b.addr)
            self.clogs += 1

    def metrics(self):
        return {"clogs": self.clogs}
