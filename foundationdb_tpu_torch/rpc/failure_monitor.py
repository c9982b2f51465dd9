"""FailureMonitor — liveness tracking for remote endpoints.

Reference: REF:fdbrpc/FailureMonitor.actor.cpp (SimpleFailureMonitor /
FailureStatus) — every process tracks, per peer address, whether the peer
is currently believed reachable; actors block on state transitions
(``onStateChanged``, ``onFailedFor``) instead of inventing their own retry
timers.  The cluster controller uses it to decide a role is dead and
trigger recovery; load balancing skips failed replicas.

Detection here is active pinging over the swappable Transport (the
well-known PING token every process answers), which works identically on
the deterministic simulator and on TCP:

- a ping round-trip marks the address available;
- ``FAILURE_TIMEOUT`` seconds without a successful round-trip marks it
  failed (pings are sent every ``PING_INTERVAL``).
"""

from __future__ import annotations

import asyncio
import dataclasses

from ..runtime.knobs import Knobs
from ..runtime.trace import TraceEvent
from .transport import Endpoint, NetworkAddress, Transport, WLTOKEN_PING


@dataclasses.dataclass
class FailureStatus:
    failed: bool
    since: float       # loop time of the last transition


class FailureMonitor:
    """One per process; monitors any address it is asked about.

    Besides the binary alive/dead state, the monitor tracks a DEGRADED
    state (the gray-failure signal of Huang et al. HotOS'17 —
    FDB 7.x's degraded-peer detection): a machine whose disk is
    slow-but-alive answers every ping, so the binary state never flips,
    yet recruiting on it or moving data to it drags cluster p99.
    Degradation is REPORTED into the monitor (the CC polls worker disk
    health) rather than detected by pinging — the signal lives where
    the latency is measured, the policy (recruitment/move
    deprioritization) lives with the consumers."""

    def __init__(self, transport: Transport, knobs: Knobs) -> None:
        self.transport = transport
        self.knobs = knobs
        self._status: dict[NetworkAddress, FailureStatus] = {}
        self._tasks: dict[NetworkAddress, asyncio.Task] = {}
        self._change_waiters: dict[NetworkAddress, list[asyncio.Future]] = {}
        self._degraded: dict[NetworkAddress, float] = {}  # addr -> since
        self._closed = False

    # --- queries (IFailureMonitor surface) ---

    def get_state(self, addr: NetworkAddress) -> FailureStatus:
        self._ensure_monitored(addr)
        return self._status[addr]

    def is_available(self, addr: NetworkAddress) -> bool:
        return not self.get_state(addr).failed

    async def wait_for_failure(self, addr: NetworkAddress) -> None:
        """Resolves when addr is considered failed (onFailedFor analog)."""
        while not self.get_state(addr).failed:
            await self._on_change(addr)

    async def wait_for_recovery(self, addr: NetworkAddress) -> None:
        while self.get_state(addr).failed:
            await self._on_change(addr)

    # --- degraded (gray failure) state ---

    def set_degraded(self, addr: NetworkAddress, degraded: bool,
                     latency_ms: float = 0.0) -> None:
        """Record a disk-health report for ``addr``.  Transitions emit
        a ``DiskDegraded`` trace event either way, so a chaos run's
        degradation timeline reconstructs from the trace alone."""
        was = addr in self._degraded
        if degraded == was:
            return
        if degraded:
            try:
                now = asyncio.get_running_loop().time()
            except RuntimeError:
                now = 0.0
            self._degraded[addr] = now
        else:
            self._degraded.pop(addr, None)
        TraceEvent("DiskDegraded").detail("Address", str(addr)) \
            .detail("Degraded", degraded) \
            .detail("LatencyMs", round(latency_ms, 3)).log()

    def is_degraded(self, addr: NetworkAddress) -> bool:
        return addr in self._degraded

    def degraded_addresses(self) -> list[NetworkAddress]:
        return sorted(self._degraded)

    # --- lifecycle ---

    def stop_monitoring(self, addr: NetworkAddress) -> None:
        t = self._tasks.pop(addr, None)
        if t is not None:
            t.cancel()
        self._status.pop(addr, None)
        # waiters are cancelled, not resolved: "monitoring stopped" is not
        # an answer to "did this address fail", and resolving them would
        # send wait_for_failure loops back through _ensure_monitored,
        # resurrecting the ping task after shutdown
        for fut in self._change_waiters.pop(addr, ()):
            fut.cancel()

    async def close(self) -> None:
        self._closed = True
        tasks = list(self._tasks.values())
        for addr in list(self._status):
            self.stop_monitoring(addr)
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    # --- internals ---

    def _ensure_monitored(self, addr: NetworkAddress) -> None:
        if self._closed:
            raise RuntimeError("FailureMonitor is closed")
        if addr in self._tasks:
            return
        loop = asyncio.get_running_loop()
        # optimistically available until the first timeout elapses — the
        # reference treats unknown endpoints the same way
        self._status[addr] = FailureStatus(False, loop.time())
        self._tasks[addr] = loop.create_task(
            self._ping_loop(addr), name=f"failmon-{addr}")

    async def _on_change(self, addr: NetworkAddress) -> None:
        fut = asyncio.get_running_loop().create_future()
        self._change_waiters.setdefault(addr, []).append(fut)
        await fut

    def _set_failed(self, addr: NetworkAddress, failed: bool) -> None:
        st = self._status.get(addr)
        if st is None or st.failed == failed:
            return
        loop = asyncio.get_running_loop()
        self._status[addr] = FailureStatus(failed, loop.time())
        TraceEvent("FailureDetectionStatus").detail("Address", str(addr)) \
            .detail("Failed", failed).log()
        for fut in self._change_waiters.pop(addr, ()):
            if not fut.done():
                fut.set_result(None)

    async def _ping_loop(self, addr: NetworkAddress) -> None:
        """Ping until cancelled; flip state on timeout/recovery."""
        loop = asyncio.get_running_loop()
        ep = Endpoint(addr, WLTOKEN_PING)
        last_ok = loop.time()
        while True:
            try:
                await asyncio.wait_for(
                    self.transport.request(ep, b"ping"),
                    timeout=self.knobs.FAILURE_TIMEOUT)
                last_ok = loop.time()
                self._set_failed(addr, False)
            except asyncio.CancelledError:
                raise
            except Exception:
                if loop.time() - last_ok >= self.knobs.FAILURE_TIMEOUT:
                    self._set_failed(addr, True)
            await asyncio.sleep(self.knobs.PING_INTERVAL)
