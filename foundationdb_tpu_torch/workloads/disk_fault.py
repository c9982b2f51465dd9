"""DiskFaultWorkload — hostile disks in the chaos mix.

Reference: REF:fdbrpc/AsyncFileNonDurable.actor.h + the DiskFailure
workloads (REF:fdbserver/workloads/DiskFailureInjection.actor.cpp) —
FDB's simulation arms per-machine file fault injection so every durable
consumer is continuously tested against IO errors, latency stalls, and
kill-time torn/corrupt writes.  Runs CONCURRENTLY with the invariant
workloads and MachineAttrition: attrition supplies the kills, this
workload makes those kills tear at sector granularity, and Cycle /
ConsistencyCheck prove no acked write was lost.

After ``testDuration`` seconds the LIVE-op injection (errors, stalls)
quiesces so the run's final checks execute on quiet disks; the
kill-time torn/corrupt semantics stay armed — they model the crash
itself, not a transient disturbance.
"""

from __future__ import annotations

import asyncio

from ..runtime.rng import DeterministicRandom
from ..runtime.trace import TraceEvent
from .workload import TestWorkload, register_workload


@register_workload
class DiskFaultWorkload(TestWorkload):
    name = "DiskFault"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.sim = self.opt("sim", None)
        self.duration = float(self.opt("testDuration", 8.0))
        self.io_error_p = float(self.opt("ioErrorP", 0.005))
        self.stall_p = float(self.opt("stallP", 0.02))
        self.stall_max_s = float(self.opt("stallMaxS", 0.03))
        self.torn_p = float(self.opt("tornP", 0.75))
        self.corrupt_p = float(self.opt("corruptP", 0.25))
        self.armed = 0

    async def start(self) -> None:
        if self.ctx.client_id != 0 or self.sim is None:
            return
        for m in self.sim.machines:
            # each machine's profile draws from its OWN derived stream,
            # never the global one — arming order stays deterministic
            # and the per-machine fault sequence is independent of how
            # other machines' ops interleave
            m.fault_profile.arm(
                DeterministicRandom(self.rng.next_u64()),
                io_error_p=self.io_error_p, stall_p=self.stall_p,
                stall_max_s=self.stall_max_s, torn_p=self.torn_p,
                corrupt_p=self.corrupt_p)
            self.armed += 1
        TraceEvent("DiskFaultWorkloadArmed") \
            .detail("Machines", self.armed) \
            .detail("IoErrorP", self.io_error_p) \
            .detail("TornP", self.torn_p).log()
        await asyncio.sleep(self.duration)
        for m in self.sim.machines:
            m.fault_profile.quiesce()
        TraceEvent("DiskFaultWorkloadQuiesced").log()

    def metrics(self):
        if self.sim is None:
            return {}
        totals: dict[str, int] = {}
        for m in self.sim.machines:
            for k, v in m.fault_profile.stats().items():
                totals[k] = totals.get(k, 0) + v
        totals["machines_armed"] = self.armed
        return totals
