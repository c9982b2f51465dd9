"""Real asyncio TCP transport with packet framing (optionally over TLS).

Reference: REF:fdbrpc/FlowTransport.actor.cpp + REF:fdbrpc/TLSConnection —
persistent connections per peer, length-prefixed packets with a checksum,
automatic reconnect.  With a ``TlsConfig`` every listener requires client
certificates and every outbound connection verifies the peer against the
shared CA (mutual TLS, the reference's fdb_tls_* model).
Frame: [u32 len][u32 crc32][u64 token][u64 reply_id][u8 kind][payload].
kind: 0=request, 1=reply-ok, 2=reply-error (payload = varint error code),
3=one-way.

A connection is watched while requests to its peer are pending, as
FlowTransport's connection monitor watches it.  Whenever nothing has been
read from the peer for ``PING_INTERVAL``, the transport pings the peer's
``WLTOKEN_PING`` over the same connection; a ping's reply, like any other
frame read, is a sign of life.  A peer silent for ``2 * FAILURE_TIMEOUT``
loses the connection, and its pending requests fail with
``RequestMaybeDelivered`` (the next request dials anew); a dial that has
not connected within that window, TLS handshake included, fails with
``ConnectionFailed``.  The window is twice the failure monitor's: a
connection is cut only after every process's ``FailureMonitor`` would
have marked the peer failed, and so after the cluster controller would
have started a recovery without it; it is also the bound coordination
puts on its own calls.  A peer that answers its pings keeps its requests
however long they wait (watches, long polls, ``wait_state``, batching).
The ping goes over the same connection because that is the path the
requests wait on: a new connection could reach a listener that accepts
for a process that no longer answers, and would tell nothing of a
connection that gets no reset; it also adds no accepted connection on
the peer.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import ssl as ssl_mod
import struct
import zlib
from typing import Any

from ..runtime.errors import ConnectionFailed, RequestMaybeDelivered
from ..runtime.knobs import Knobs
from ..runtime.trace import Severity, TraceEvent
from .transport import Endpoint, NetworkAddress, Transport, WLTOKEN_PING
from .wire import decode, encode

_HDR = struct.Struct("<IIQQB")


@dataclasses.dataclass
class TlsConfig:
    """Mutual-TLS material (fdb_tls_certificate_file/_key_file/_ca_file)."""
    cert_file: str
    key_file: str
    ca_file: str
    verify_hostname: bool = False    # clusters dial IPs; identity = the CA

    def server_context(self) -> ssl_mod.SSLContext:
        ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_file, self.key_file)
        ctx.load_verify_locations(self.ca_file)
        ctx.verify_mode = ssl_mod.CERT_REQUIRED
        return ctx

    def client_context(self) -> ssl_mod.SSLContext:
        ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_CLIENT)
        ctx.load_cert_chain(self.cert_file, self.key_file)
        ctx.load_verify_locations(self.ca_file)
        ctx.check_hostname = self.verify_hostname
        return ctx


class _Peer:
    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.reader = reader
        self.writer = writer
        # in-flight requests *to this peer*; a peer failure must only fail
        # its own requests, never those pending on other connections
        self.pending: dict[int, asyncio.Future] = {}
        # loop time of the last frame read, or of the watch's start
        self.heard = 0.0
        self.monitor: asyncio.Task | None = None


class TcpTransport(Transport):
    def __init__(self, address: NetworkAddress,
                 tls: TlsConfig | None = None,
                 knobs: Knobs | None = None) -> None:
        super().__init__(address)
        self.tls = tls
        knobs = knobs or Knobs()
        self._ping_every = knobs.PING_INTERVAL
        self._silence = 2 * knobs.FAILURE_TIMEOUT
        self._server: asyncio.AbstractServer | None = None
        self._peers: dict[NetworkAddress, _Peer] = {}
        self._reply_ids = itertools.count(1)
        self._tasks: set[asyncio.Task] = set()
        self._inbound: set[_Peer] = set()     # accepted connections

    async def listen(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connection, self.address.ip, self.address.port,
            ssl=self.tls.server_context() if self.tls else None)

    async def _on_connection(self, reader, writer) -> None:
        peer = _Peer(reader, writer)
        self._inbound.add(peer)
        try:
            await self._read_loop(peer, None)
        finally:
            self._inbound.discard(peer)

    def _spawn(self, coro, name: str) -> asyncio.Task:
        t = asyncio.get_running_loop().create_task(coro, name=name)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)
        return t

    async def _get_peer(self, addr: NetworkAddress) -> _Peer:
        peer = self._peers.get(addr)
        if peer is not None and not peer.writer.is_closing():
            return peer
        try:
            # a dial, the TLS handshake included, has the same window
            reader, writer = await asyncio.wait_for(asyncio.open_connection(
                addr.ip, addr.port,
                ssl=self.tls.client_context() if self.tls else None,
                server_hostname=addr.ip if self.tls
                and self.tls.verify_hostname else None), self._silence)
        except asyncio.TimeoutError:     # before OSError, its base class
            self._timed_out(addr, "dial", self._silence, 0)
            raise ConnectionFailed(f"no connection to {addr} within "
                                   f"{self._silence} s") from None
        except (OSError, ssl_mod.SSLError) as e:
            raise ConnectionFailed(str(e)) from None
        peer = _Peer(reader, writer)
        self._peers[addr] = peer
        self._spawn(self._read_loop(peer, addr), f"tcp-read-{addr}")
        return peer

    @staticmethod
    def _frame(token: int, reply_id: int, kind: int, payload: bytes) -> bytes:
        crc = zlib.crc32(payload)
        return _HDR.pack(len(payload), crc, token, reply_id, kind) + payload

    async def _read_loop(self, peer: _Peer, addr: NetworkAddress | None) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                hdr = await peer.reader.readexactly(_HDR.size)
                ln, crc, token, reply_id, kind = _HDR.unpack(hdr)
                payload = await peer.reader.readexactly(ln)
                peer.heard = loop.time()
                if zlib.crc32(payload) != crc:
                    raise ConnectionError("checksum mismatch")
                if kind == 0:        # request
                    self._spawn(self._serve(peer, token, reply_id, payload),
                                "tcp-serve")
                elif kind == 3:      # one-way
                    self._spawn(self._serve(peer, token, 0, payload),
                                "tcp-oneway-serve")
                else:                # reply (a ping's finds no future)
                    fut = peer.pending.pop(reply_id, None)
                    if fut is not None and not fut.done():
                        if kind == 1:
                            fut.set_result(decode(payload))
                        else:
                            code = decode(payload)
                            fut.set_exception(ConnectionFailed()
                                              if not isinstance(code, int)
                                              else _remote_error(code))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            if addr is not None and self._peers.get(addr) is peer:
                self._peers.pop(addr, None)
            peer.writer.close()
            # fail this peer's requests: they will never be answered and
            # we cannot know whether the peer executed them
            for fut in peer.pending.values():
                if not fut.done():
                    fut.set_exception(RequestMaybeDelivered())
            peer.pending.clear()

    async def _serve(self, peer: _Peer, token: int, reply_id: int,
                     payload: bytes) -> None:
        # any failure (bad payload, handler bug) must still produce an
        # error reply or the caller's future hangs forever
        try:
            ok, reply = await self.dispatcher.dispatch(token, decode(payload))
        except Exception:
            ok, reply = False, 1000  # operation_failed
        if reply_id == 0:
            return
        kind = 1 if ok else 2
        try:
            peer.writer.write(self._frame(token, reply_id, kind, encode(reply)))
            await peer.writer.drain()
        except (ConnectionError, OSError):
            pass

    @staticmethod
    def _timed_out(addr: NetworkAddress, phase: str, silent: float,
                   pending: int) -> None:
        TraceEvent("ConnectionTimeout", Severity.WARN) \
            .detail("PeerAddr", str(addr)).detail("Phase", phase) \
            .detail("SilentSeconds", round(silent, 3)) \
            .detail("Pending", pending).log()

    async def _connection_monitor(self, peer: _Peer,
                                  addr: NetworkAddress) -> None:
        """While requests to ``peer`` are pending: a ping whenever nothing
        has been read from it for ``PING_INTERVAL``, and the connection
        aborted once it has been silent for the window, which fails the
        pending requests through the read loop."""
        loop = asyncio.get_running_loop()
        slept_at = loop.time()
        while peer.pending and not peer.writer.is_closing():
            now = loop.time()
            silent = now - peer.heard
            # a late tick is this process's own stall, not the peer's: no
            # ping went out and its frames may wait unread, so the cut
            # waits a tick
            late = now - slept_at > 2 * self._ping_every
            if silent >= self._silence and not late:
                self._timed_out(addr, "connected", silent, len(peer.pending))
                peer.writer.transport.abort()
                return
            if silent >= self._ping_every:
                peer.writer.write(self._frame(
                    WLTOKEN_PING, next(self._reply_ids), 0, encode(b"ping")))
            slept_at = loop.time()
            await asyncio.sleep(self._ping_every)

    async def request(self, endpoint: Endpoint, payload: Any,
                      timeout: float | None = None) -> Any:
        payload = self.attach_span(payload)   # sampled ctx rides the frame
        peer = await self._get_peer(endpoint.address)
        reply_id = next(self._reply_ids)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        peer.pending[reply_id] = fut
        if peer.monitor is None or peer.monitor.done():
            peer.heard = loop.time()
            peer.monitor = self._spawn(
                self._connection_monitor(peer, endpoint.address),
                f"tcp-monitor-{endpoint.address}")
        try:
            peer.writer.write(self._frame(endpoint.token, reply_id, 0,
                                          encode(payload)))
            await peer.writer.drain()
        except (ConnectionError, OSError):
            peer.pending.pop(reply_id, None)
            raise ConnectionFailed() from None
        try:
            if timeout is not None:
                return await asyncio.wait_for(fut, timeout)
            return await fut
        finally:
            # a request cut by its caller (a timeout, a refresh that has
            # its majority) is forgotten; a late reply finds no future
            peer.pending.pop(reply_id, None)

    def one_way(self, endpoint: Endpoint, payload: Any) -> None:
        payload = self.attach_span(payload)

        async def go():
            try:
                peer = await self._get_peer(endpoint.address)
                peer.writer.write(self._frame(endpoint.token, 0, 3,
                                              encode(payload)))
                await peer.writer.drain()
            except (ConnectionFailed, ConnectionError, OSError):
                pass
        self._spawn(go(), "tcp-oneway")

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            # the server's wait_closed waits for every accepted connection
            # (Python 3.12): close them first, or a server whose clients
            # are still connected never stops
            for peer in list(self._inbound):
                peer.writer.close()
            await self._server.wait_closed()
        for peer in self._peers.values():
            peer.writer.close()
        self._peers.clear()
        for t in list(self._tasks):
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)


def _remote_error(code: int):
    from ..runtime.errors import error_from_code
    return error_from_code(code)
