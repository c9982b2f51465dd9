"""Endpoint addressing + the Transport interface.

Reference: REF:fdbrpc/FlowTransport.actor.h — an Endpoint is
(NetworkAddress, token); a token names a receiver within a process.
Messages are request/reply: each request carries a reply token the
receiving side answers to (ReplyPromise over the wire).  Well-known
tokens (WLTOKEN_*) bootstrap discovery before any endpoint exchange.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
from typing import Any, Awaitable, Callable

from ..runtime import span as _span
from ..runtime.errors import FdbError, error_from_code

# well-known tokens (REF: WLTOKEN_* in FlowTransport.actor.cpp)
WLTOKEN_PING = 1
WLTOKEN_ENDPOINT_NOT_FOUND = 2
WLTOKEN_COORDINATOR = 40     # coordinator role block on shared-process transports
WLTOKEN_FIRST_AVAILABLE = 100


@dataclasses.dataclass(frozen=True, order=True)
class NetworkAddress:
    ip: str
    port: int

    def __str__(self) -> str:
        return f"{self.ip}:{self.port}"

    @staticmethod
    def parse(s: str) -> "NetworkAddress":
        host, port = s.rsplit(":", 1)
        return NetworkAddress(host, int(port))


@dataclasses.dataclass(frozen=True, order=True)
class Endpoint:
    address: NetworkAddress
    token: int


class RequestDispatcher:
    """Token → handler table one process exposes (the receiver side of
    FlowTransport).  Handlers are ``async (payload) -> reply payload``;
    FdbErrors raised by handlers travel back as error replies."""

    def __init__(self) -> None:
        self._handlers: dict[int, Callable[[Any], Awaitable[Any]]] = {}
        self._next_token = itertools.count(WLTOKEN_FIRST_AVAILABLE)

    def register(self, handler: Callable[[Any], Awaitable[Any]],
                 token: int | None = None) -> int:
        t = token if token is not None else next(self._next_token)
        assert t not in self._handlers, f"token {t} in use"
        self._handlers[t] = handler
        return t

    def unregister(self, token: int) -> None:
        self._handlers.pop(token, None)

    async def dispatch(self, token: int, payload: Any) -> tuple[bool, Any]:
        """Returns (ok, reply_or_error_code).  A payload wrapped in a
        SpanEnvelope (a sampled request) re-activates the sender's span
        context around the handler, so role code reads it back with
        ``current_span()`` — the receive half of wire propagation."""
        payload, ctx = _span.detach(payload)
        h = self._handlers.get(token)
        if h is None:
            # endpoint_not_found: the role at this token is gone (stopped,
            # or its process rebooted).  Retryable — clients refresh their
            # cluster view and re-dial the new generation.
            return False, 1012
        tok = _span.activate(ctx) if ctx is not None else None
        try:
            return True, await h(payload)
        except FdbError as e:
            return False, e.code
        finally:
            if tok is not None:
                _span.deactivate(tok)

    @property
    def tokens(self) -> list[int]:
        return sorted(self._handlers)


class Transport:
    """Base transport: request/reply to endpoints.  Implementations:
    SimTransport (deterministic in-memory) and TcpTransport (asyncio)."""

    def __init__(self, address: NetworkAddress) -> None:
        self.address = address
        self.dispatcher = RequestDispatcher()

        # Every process answers pings at the well-known token — the probe
        # surface FailureMonitor uses (REF: FlowTransport's ping endpoint).
        async def _ping(payload: Any) -> Any:
            return payload
        self.dispatcher.register(_ping, token=WLTOKEN_PING)

    async def request(self, endpoint: Endpoint, payload: Any,
                      timeout: float | None = None) -> Any:
        raise NotImplementedError

    def one_way(self, endpoint: Endpoint, payload: Any) -> None:
        """Fire-and-forget send (PacketWriter without reply token)."""
        raise NotImplementedError

    @staticmethod
    def attach_span(payload: Any) -> Any:
        """Envelope hook every transport calls at send time: wraps the
        payload with the active sampled span context (no-op otherwise),
        so cross-role attribution survives the wire."""
        return _span.attach(payload)

    async def close(self) -> None:
        pass

    # helpers
    def endpoint(self, token: int) -> Endpoint:
        return Endpoint(self.address, token)

    @staticmethod
    def raise_remote_error(code: int) -> None:
        raise error_from_code(code)
