"""Typed RPC over swappable transports.

Reference: REF:fdbrpc/ — FlowTransport (framed packets, endpoint tokens,
connection management) carrying RequestStream<T>/ReplyPromise<T> typed
endpoints, with the simulator (Sim2) substituting an in-memory network
behind the same interface.  Here:

- wire.py        — self-describing binary codec (ObjectSerializer analog)
- transport.py   — Endpoint/NetworkAddress + the Transport interface

The transports themselves (the simulated network, TCP, the role stubs)
are not ported yet: the port's roles talk in process (ROADMAP A6).
"""

from .transport import Endpoint, NetworkAddress, Transport
from .wire import decode, encode, register_struct
