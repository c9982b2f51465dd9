"""The port's TCP transport against a peer that keeps its connection open
and answers nothing (ROADMAP C5).

``foundationdb_tpu_torch/rpc/tcp_transport.py`` watches a connection
while requests to its peer are pending: it pings the peer's
``WLTOKEN_PING`` over that connection whenever nothing has been read for
``PING_INTERVAL``, and a peer silent for ``2 * FAILURE_TIMEOUT`` (the
window: 2.0 s at the default knobs) loses the connection, its pending
requests failing with ``RequestMaybeDelivered``.

- A silent peer (a listener that accepts and reads but never writes):
  the request fails within the window (no sooner than the window, no
  later than the window and two ping intervals, plus 1 s for a loaded
  host); the pending map is then empty and no task of the transport is
  left.  ``close()`` before the window leaves nothing behind either.
- A peer that answers its pings but holds its reply 5 s: the reply
  comes back, not an error.
- A request held 3x the window by a peer that answers its pings (a
  watch, a long poll): it stays pending.
- A stall of the client's own event loop longer than the window, during
  which no ping went out, on a request to a peer that answers its pings
  and replies later: the reply comes back (the silence was the
  client's, not the peer's).
- A TLS dial to the silent peer (a handshake never answered) fails with
  ``ConnectionFailed`` within the same window.
- The reference's transport on the silent peer is still waiting past
  the window (``..._reference_fault``): a recorded fault of the JAX
  package, which the port repairs alone.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import subprocess
import sys
import threading
import time

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)

from torch_parity import PORT, REF  # noqa: E402


def mod(name: str, path: str):
    return importlib.import_module(f"{name}.{path}")


KNOBS = mod(PORT, "runtime.knobs").Knobs()
WINDOW = 2 * KNOBS.FAILURE_TIMEOUT
LATE = WINDOW + 2 * KNOBS.PING_INTERVAL + 1.0
NA = mod(PORT, "rpc.transport").NetworkAddress
Endpoint = mod(PORT, "rpc.transport").Endpoint
WLTOKEN_PING = mod(PORT, "rpc.transport").WLTOKEN_PING


async def silent_peer():
    """A localhost listener that accepts, reads and never writes: its
    server, its port and the connections it holds."""
    held: list = []

    async def hold(reader, writer):
        held.append(writer)
        while await reader.read(1 << 16):
            pass

    srv = await asyncio.start_server(hold, "127.0.0.1", 0)
    return srv, srv.sockets[0].getsockname()[1], held


async def close_silent(srv, held) -> None:
    srv.close()
    for w in held:
        w.close()
    await srv.wait_closed()


async def answering_peer(delay: float, release: asyncio.Event | None = None):
    """A port transport listening on localhost whose handler replies
    ``["done", payload]`` after ``delay`` seconds (or when ``release`` is
    set), and whose ping handler counts the pings it answers: the
    transport, its port, the handler's token and the ping count."""
    Tcp = mod(PORT, "rpc.tcp_transport").TcpTransport
    t = Tcp(NA("127.0.0.1", 0))
    pings = [0]

    async def ping(payload):
        pings[0] += 1
        return payload

    async def slow(payload):
        if release is not None:
            await release.wait()
        else:
            await asyncio.sleep(delay)
        return ["done", payload]

    t.dispatcher.unregister(WLTOKEN_PING)
    t.dispatcher.register(ping, token=WLTOKEN_PING)
    token = t.dispatcher.register(slow)
    await t.listen()
    return t, t._server.sockets[0].getsockname()[1], token, pings


def leftovers(client) -> tuple:
    """The client transport's pending requests, peers and tasks."""
    return (sum(len(p.pending) for p in client._peers.values()),
            len(client._peers), len(client._tasks))


def test_silent_peer_fails_the_request_within_the_window():
    Tcp = mod(PORT, "rpc.tcp_transport").TcpTransport
    errors = mod(PORT, "runtime.errors")

    async def main():
        srv, port, held = await silent_peer()
        client = Tcp(NA("127.0.0.1", 0))
        try:
            t0 = time.perf_counter()
            with pytest.raises(errors.RequestMaybeDelivered):
                await client.request(Endpoint(NA("127.0.0.1", port), 500),
                                     ["get", b"k"])
            seconds = time.perf_counter() - t0
            await asyncio.sleep(0.05)
            left = leftovers(client)
            others = [x for x in asyncio.all_tasks()
                      if x is not asyncio.current_task()
                      and x.get_name().startswith("tcp-")]
            # a request after the cut dials a new connection
            with pytest.raises(errors.RequestMaybeDelivered):
                await client.request(Endpoint(NA("127.0.0.1", port), 500),
                                     ["get", b"k"])
            connections = len(held)
        finally:
            await client.close()
            await close_silent(srv, held)
        return seconds, left, others, connections
    seconds, left, others, connections = asyncio.run(
        asyncio.wait_for(main(), 3 * LATE))
    assert WINDOW <= seconds < LATE, seconds
    assert left == (0, 0, 0) and others == [], (left, others)
    assert connections == 2


def test_close_leaves_no_task_and_no_pending_request():
    Tcp = mod(PORT, "rpc.tcp_transport").TcpTransport
    errors = mod(PORT, "runtime.errors")

    async def main():
        srv, port, held = await silent_peer()
        client = Tcp(NA("127.0.0.1", 0))
        req = asyncio.ensure_future(client.request(
            Endpoint(NA("127.0.0.1", port), 500), ["get", b"k"]))
        await asyncio.sleep(0.5)
        before = leftovers(client)
        await client.close()
        with pytest.raises(errors.RequestMaybeDelivered):
            await req
        after = leftovers(client)
        await close_silent(srv, held)
        return before, after
    before, after = asyncio.run(asyncio.wait_for(main(), LATE))
    assert before == (1, 1, 2), before      # the read loop and the monitor
    assert after == (0, 0, 0), after


def test_slow_peer_that_answers_pings_returns_its_reply():
    Tcp = mod(PORT, "rpc.tcp_transport").TcpTransport

    async def main():
        server, port, token, pings = await answering_peer(5.0)
        client = Tcp(NA("127.0.0.1", 0))
        try:
            t0 = time.perf_counter()
            got = await client.request(Endpoint(NA("127.0.0.1", port), token),
                                       ["get", b"k"])
            seconds = time.perf_counter() - t0
            await asyncio.sleep(2 * KNOBS.PING_INTERVAL)
            left = leftovers(client)
        finally:
            await client.close()
            await server.close()
        return got, seconds, pings[0], left
    got, seconds, pings, left = asyncio.run(
        asyncio.wait_for(main(), 5.0 + LATE))
    assert got == ["done", ["get", b"k"]]
    assert 5.0 <= seconds < 5.0 + LATE, seconds
    # a ping whenever the connection was quiet for PING_INTERVAL: about
    # one each two intervals while the reply was held
    assert pings >= 5.0 / (4 * KNOBS.PING_INTERVAL), pings
    assert left == (0, 1, 1), left          # the connection stays open


def test_request_held_three_windows_by_an_answering_peer_stays_pending():
    Tcp = mod(PORT, "rpc.tcp_transport").TcpTransport

    async def main():
        release = asyncio.Event()
        server, port, token, pings = await answering_peer(0.0, release)
        client = Tcp(NA("127.0.0.1", 0))
        try:
            req = asyncio.ensure_future(client.request(
                Endpoint(NA("127.0.0.1", port), token), ["watch", b"k"]))
            await asyncio.sleep(3 * WINDOW)
            held = (req.done(), leftovers(client)[0])
            release.set()
            got = await asyncio.wait_for(req, LATE)
        finally:
            await client.close()
            await server.close()
        return held, got, pings[0]
    held, got, pings = asyncio.run(asyncio.wait_for(main(),
                                                    3 * WINDOW + 2 * LATE))
    assert held == (False, 1), held
    assert got == ["done", ["watch", b"k"]]
    assert pings >= 3 * WINDOW / (4 * KNOBS.PING_INTERVAL), pings


class ThreadPeer:
    """``answering_peer`` on an event loop of its own thread, so that it
    answers while the test's loop is stalled."""

    def __init__(self, delay: float) -> None:
        self.delay = delay
        self.ready = threading.Event()
        self.thread = threading.Thread(target=asyncio.run,
                                       args=(self._serve(),), daemon=True)

    async def _serve(self) -> None:
        self.loop = asyncio.get_running_loop()
        self.stop = asyncio.Event()
        t, self.port, self.token, self.pings = await answering_peer(
            self.delay)
        self.ready.set()
        await self.stop.wait()
        await t.close()

    def __enter__(self) -> "ThreadPeer":
        self.thread.start()
        assert self.ready.wait(10)
        return self

    def __exit__(self, *exc) -> None:
        self.loop.call_soon_threadsafe(self.stop.set)
        self.thread.join(10)


def test_own_stall_does_not_cut_a_peer_that_replied():
    Tcp = mod(PORT, "rpc.tcp_transport").TcpTransport

    async def main(peer):
        client = Tcp(NA("127.0.0.1", 0))
        try:
            req = asyncio.ensure_future(client.request(
                Endpoint(NA("127.0.0.1", peer.port), peer.token),
                ["get", b"k"]))
            await asyncio.sleep(0.1)
            # this loop stalls past the window: no ping goes out and
            # nothing is read; the peer, on its own loop, replies 1.5 s
            # after the stall and answers the pings sent after it
            time.sleep(WINDOW + 1.0)
            return await asyncio.wait_for(req, LATE)
        finally:
            await client.close()
    with ThreadPeer(WINDOW + 2.5) as peer:
        got = asyncio.run(asyncio.wait_for(main(peer), 3 * LATE))
    assert got == ["done", ["get", b"k"]]


def make_certs(d) -> tuple:
    """One CA and one leaf certificate signed by it (openssl CLI)."""
    def run(*args):
        subprocess.run(["openssl", *args], check=True, capture_output=True)
    ca_key, ca_crt = d / "ca.key", d / "ca.crt"
    run("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout",
        str(ca_key), "-out", str(ca_crt), "-days", "1", "-subj",
        "/CN=liveness-ca")
    key, csr, crt = d / "node.key", d / "node.csr", d / "node.crt"
    run("req", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
        "-out", str(csr), "-subj", "/CN=liveness-node")
    run("x509", "-req", "-in", str(csr), "-CA", str(ca_crt), "-CAkey",
        str(ca_key), "-CAcreateserial", "-out", str(crt), "-days", "1")
    return str(crt), str(key), str(ca_crt)


def test_tls_dial_to_a_silent_peer_fails_within_the_window(tmp_path):
    tcp = mod(PORT, "rpc.tcp_transport")
    errors = mod(PORT, "runtime.errors")
    tls = tcp.TlsConfig(*make_certs(tmp_path))

    async def main():
        srv, port, held = await silent_peer()
        client = tcp.TcpTransport(NA("127.0.0.1", 0), tls=tls)
        try:
            t0 = time.perf_counter()
            with pytest.raises(errors.ConnectionFailed):
                await client.request(Endpoint(NA("127.0.0.1", port), 500),
                                     ["get", b"k"])
            seconds = time.perf_counter() - t0
            left = leftovers(client)
        finally:
            await client.close()
            await close_silent(srv, held)
        return seconds, left
    seconds, left = asyncio.run(asyncio.wait_for(main(), 2 * LATE))
    assert WINDOW <= seconds < LATE, seconds
    assert left == (0, 0, 0), left


def test_silent_peer_holds_the_request_reference_fault():
    """The reference's transport waits on the silent peer with no end:
    past the port's window (and its two ping intervals and 1 s) the
    request is still pending."""
    Tcp = mod(REF, "rpc.tcp_transport").TcpTransport
    RNA = mod(REF, "rpc.transport").NetworkAddress
    REP = mod(REF, "rpc.transport").Endpoint

    async def main():
        srv, port, held = await silent_peer()
        client = Tcp(RNA("127.0.0.1", 0))
        req = asyncio.ensure_future(client.request(
            REP(RNA("127.0.0.1", port), 500), ["get", b"k"]))
        try:
            await asyncio.sleep(LATE)
            pending = (req.done(), sum(len(p.pending)
                                       for p in client._peers.values()))
        finally:
            req.cancel()
            await asyncio.gather(req, return_exceptions=True)
            await client.close()
            await close_silent(srv, held)
        return pending
    assert asyncio.run(asyncio.wait_for(main(), 2 * LATE)) == (False, 1)
