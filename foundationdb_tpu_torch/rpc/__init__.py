"""Typed RPC over swappable transports.

Reference: REF:fdbrpc/ — FlowTransport (framed packets, endpoint tokens,
connection management) carrying RequestStream<T>/ReplyPromise<T> typed
endpoints, with the simulator (Sim2) substituting an in-memory network
behind the same interface.  Here:

- wire.py        — self-describing binary codec (ObjectSerializer analog)
- transport.py   — Endpoint/NetworkAddress + the Transport interface
- sim_transport.py — deterministic in-memory network w/ latency, clogs,
                     partitions (Sim2's SimClogging analog)
- tcp_transport.py — real asyncio TCP framing
- stubs.py       — RequestStream server loops + client proxies for roles
- failure_monitor.py — ping-based peer liveness (and the degraded set)
"""

from .transport import Endpoint, NetworkAddress, Transport
from .wire import decode, encode, register_struct
