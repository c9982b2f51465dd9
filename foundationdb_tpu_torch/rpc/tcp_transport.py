"""Real asyncio TCP transport with packet framing (optionally over TLS).

Reference: REF:fdbrpc/FlowTransport.actor.cpp + REF:fdbrpc/TLSConnection —
persistent connections per peer, length-prefixed packets with a checksum,
automatic reconnect.  With a ``TlsConfig`` every listener requires client
certificates and every outbound connection verifies the peer against the
shared CA (mutual TLS, the reference's fdb_tls_* model).
Frame: [u32 len][u32 crc32][u64 token][u64 reply_id][u8 kind][payload].
kind: 0=request, 1=reply-ok, 2=reply-error (payload = varint error code),
3=one-way.
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
from .transport import Endpoint, NetworkAddress, Transport
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


class TcpTransport(Transport):
    def __init__(self, address: NetworkAddress,
                 tls: TlsConfig | None = None) -> None:
        super().__init__(address)
        self.tls = tls
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

    def _spawn(self, coro, name: str) -> None:
        t = asyncio.get_running_loop().create_task(coro, name=name)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    async def _get_peer(self, addr: NetworkAddress) -> _Peer:
        peer = self._peers.get(addr)
        if peer is not None and not peer.writer.is_closing():
            return peer
        try:
            reader, writer = await asyncio.open_connection(
                addr.ip, addr.port,
                ssl=self.tls.client_context() if self.tls else None,
                server_hostname=addr.ip if self.tls
                and self.tls.verify_hostname else None)
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
        try:
            while True:
                hdr = await peer.reader.readexactly(_HDR.size)
                ln, crc, token, reply_id, kind = _HDR.unpack(hdr)
                payload = await peer.reader.readexactly(ln)
                if zlib.crc32(payload) != crc:
                    raise ConnectionError("checksum mismatch")
                if kind == 0:        # request
                    self._spawn(self._serve(peer, token, reply_id, payload),
                                "tcp-serve")
                elif kind == 3:      # one-way
                    self._spawn(self._serve(peer, token, 0, payload),
                                "tcp-oneway-serve")
                else:                # reply
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

    async def request(self, endpoint: Endpoint, payload: Any,
                      timeout: float | None = None) -> Any:
        payload = self.attach_span(payload)   # sampled ctx rides the frame
        peer = await self._get_peer(endpoint.address)
        reply_id = next(self._reply_ids)
        fut = asyncio.get_running_loop().create_future()
        peer.pending[reply_id] = fut
        try:
            peer.writer.write(self._frame(endpoint.token, reply_id, 0,
                                          encode(payload)))
            await peer.writer.drain()
        except (ConnectionError, OSError):
            peer.pending.pop(reply_id, None)
            raise ConnectionFailed() from None
        if timeout is not None:
            return await asyncio.wait_for(fut, timeout)
        return await fut

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
