"""Deterministic in-memory network — the Sim2 network model.

Reference: REF:fdbrpc/sim2.actor.cpp — simulated message delivery with
seeded random latency, plus fault injection: clogged links (delayed
delivery), partitions (dropped packets → request timeouts), and process
death.  All scheduling flows through the virtual-time loop, so a seed
reproduces every delivery order exactly.
"""

from __future__ import annotations

import asyncio
from typing import Any

from ..runtime.errors import ConnectionFailed, RequestMaybeDelivered, TimedOut
from ..runtime.knobs import Knobs
from ..runtime.rng import deterministic_random
from .transport import Endpoint, NetworkAddress, Transport


class SimNetwork:
    """The shared medium: address → transport, plus link-level faults.
    One per simulation (pass to every SimTransport)."""

    def __init__(self, knobs: Knobs | None = None) -> None:
        self.knobs = knobs or Knobs()
        self.listeners: dict[NetworkAddress, "SimTransport"] = {}
        self._clogged: dict[tuple[NetworkAddress, NetworkAddress], float] = {}
        self._partitioned: set[tuple[NetworkAddress, NetworkAddress]] = set()
        self._dead: set[NetworkAddress] = set()
        self._dead_ips: set[str] = set()
        self._death_event: asyncio.Event | None = None

    def death_event(self) -> asyncio.Event:
        """Set (and replaced) on every kill — lets an in-flight request
        notice its peer's machine died mid-dispatch, the way a real TCP
        connection would reset."""
        if self._death_event is None:
            self._death_event = asyncio.Event()
        return self._death_event

    def _signal_death(self) -> None:
        if self._death_event is not None:
            self._death_event.set()
            self._death_event = None

    # --- fault injection (RandomClogging / partition workloads use these) ---

    def clog_pair(self, a: NetworkAddress, b: NetworkAddress,
                  seconds: float) -> None:
        until = asyncio.get_running_loop().time() + seconds
        for pair in ((a, b), (b, a)):
            self._clogged[pair] = max(self._clogged.get(pair, 0.0), until)

    def partition(self, a: NetworkAddress, b: NetworkAddress) -> None:
        self._partitioned.add((a, b))
        self._partitioned.add((b, a))

    def heal(self, a: NetworkAddress, b: NetworkAddress) -> None:
        self._partitioned.discard((a, b))
        self._partitioned.discard((b, a))

    def kill(self, addr: NetworkAddress) -> None:
        self._dead.add(addr)
        self._signal_death()

    def reboot(self, addr: NetworkAddress) -> None:
        self._dead.discard(addr)

    def kill_ip(self, ip: str) -> None:
        """Machine kill: every endpoint on this IP goes dark — a process's
        server transport AND its outbound client transports (the machine
        model of REF:fdbrpc/sim2.actor.cpp killProcess)."""
        self._dead_ips.add(ip)
        self._signal_death()

    def reboot_ip(self, ip: str) -> None:
        self._dead_ips.discard(ip)

    def is_dead(self, addr: NetworkAddress) -> bool:
        return addr in self._dead or addr.ip in self._dead_ips

    # --- delivery ---

    def _delay(self, src: NetworkAddress, dst: NetworkAddress) -> float | None:
        """Seconds until delivery, or None if the packet is dropped."""
        if ((src, dst) in self._partitioned or self.is_dead(dst)
                or self.is_dead(src)):
            return None
        rng = deterministic_random()
        d = (self.knobs.SIM_NETWORK_MIN_DELAY +
             rng.random() * (self.knobs.SIM_NETWORK_MAX_DELAY
                             - self.knobs.SIM_NETWORK_MIN_DELAY))
        clog_until = self._clogged.get((src, dst), 0.0)
        now = asyncio.get_running_loop().time()
        if clog_until > now:
            d += clog_until - now
        return d


class SimTransport(Transport):
    def __init__(self, network: SimNetwork, address: NetworkAddress) -> None:
        super().__init__(address)
        self.network = network
        network.listeners[address] = self
        self._tasks: set[asyncio.Task] = set()

    async def request(self, endpoint: Endpoint, payload: Any,
                      timeout: float | None = None) -> Any:
        payload = self.attach_span(payload)   # sampled ctx rides the wire
        loop = asyncio.get_running_loop()
        d1 = self.network._delay(self.address, endpoint.address)
        if d1 is None:
            # like a TCP connect failure: the request was definitely not
            # delivered, so callers may retry freely
            await asyncio.sleep(self.network.knobs.CONNECT_TIMEOUT)
            raise ConnectionFailed()
        await asyncio.sleep(d1)
        peer = self.network.listeners.get(endpoint.address)
        if peer is None or self.network.is_dead(endpoint.address):
            raise ConnectionFailed()
        # dispatch, but notice if either machine dies mid-call: the real
        # network would reset the connection; without this, a handler
        # whose process was killed leaves the caller awaiting forever
        dispatch = asyncio.ensure_future(
            peer.dispatcher.dispatch(endpoint.token, payload))
        while True:
            death = self.network.death_event()
            waiter = asyncio.ensure_future(death.wait())
            done, _ = await asyncio.wait(
                {dispatch, waiter}, return_when=asyncio.FIRST_COMPLETED)
            waiter.cancel()
            if dispatch in done:
                break
            if (self.network.is_dead(endpoint.address)
                    or self.network.is_dead(self.address)):
                dispatch.cancel()
                await asyncio.gather(dispatch, return_exceptions=True)
                await asyncio.sleep(self.network.knobs.CONNECT_TIMEOUT)
                raise RequestMaybeDelivered()
        ok, reply = dispatch.result()
        d2 = self.network._delay(endpoint.address, self.address)
        if d2 is None:
            # executed remotely but the reply was lost: ambiguous outcome
            await asyncio.sleep(self.network.knobs.CONNECT_TIMEOUT)
            raise RequestMaybeDelivered()
        await asyncio.sleep(d2)
        if not ok:
            Transport.raise_remote_error(reply)
        return reply

    def one_way(self, endpoint: Endpoint, payload: Any) -> None:
        payload = self.attach_span(payload)

        async def deliver():
            d = self.network._delay(self.address, endpoint.address)
            if d is None:
                return
            await asyncio.sleep(d)
            peer = self.network.listeners.get(endpoint.address)
            if peer is not None and not self.network.is_dead(endpoint.address):
                await peer.dispatcher.dispatch(endpoint.token, payload)
        t = asyncio.get_running_loop().create_task(deliver(), name="sim-oneway")
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    async def close(self) -> None:
        self.network.listeners.pop(self.address, None)
        for t in list(self._tasks):
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
