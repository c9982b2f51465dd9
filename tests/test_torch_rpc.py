"""The port's RPC layer against the JAX package's.

The scenarios of tests/test_rpc.py: the simulated network's request and
reply under clogging, partition and kill; the networked cluster (every
role behind its own simulated address, ``core/cluster_rpc.py``) serving
set/get, a conflict, a cycle workload and a same-seed rerun, each under
one seed on both packages with equal results; and the TCP transport on
localhost, plain and with mutual TLS.  The port's resolvers run the ``cuda`` backend on
``torch.device("cpu")``, so the kernels' plain versions answer; the
reference's run ``numpy``.
"""

from __future__ import annotations

import asyncio
import os
import socket
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import buggify_off, package  # noqa: E402,F401

REF, PORT = "foundationdb_tpu", "foundationdb_tpu_torch"
SHAPE = dict(RESOLVER_BATCH_TXNS=16, RESOLVER_RANGES_PER_TXN=4,
             KEY_ENCODE_BYTES=16, CONFLICT_RING_CAPACITY=1 << 12,
             CONFLICT_WINDOW_SLOTS=256, CONFLICT_DICT_SLOTS=0,
             RESOLVER_GROUP_BUCKET=4, RESOLVER_GROUP_MAX=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes: one CPU thread each
    for torch's ops keeps these tests from starving their neighbours."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the simulated transport


async def request_reply_and_faults(P):
    net = P.sim_transport.SimNetwork(P.Knobs())
    NA, Endpoint = P.transport.NetworkAddress, P.transport.Endpoint
    a = P.sim_transport.SimTransport(net, NA("10.0.0.1", 1))
    b = P.sim_transport.SimTransport(net, NA("10.0.0.2", 1))

    async def double(x):
        return x * 2
    ep = Endpoint(b.address, b.dispatcher.register(double))
    loop = asyncio.get_running_loop()
    out = [await a.request(ep, 21)]
    t0 = loop.time()
    net.clog_pair(a.address, b.address, 0.5)
    out.append(await a.request(ep, 5))
    out.append(loop.time() - t0 >= 0.5)

    async def refused(x):
        try:
            await a.request(ep, x)
            return "answered"
        except P.errors.ConnectionFailed as e:
            return e.code
    net.partition(a.address, b.address)
    out.append(await refused(1))
    net.heal(a.address, b.address)
    out.append(await a.request(ep, 1))
    net.kill(b.address)
    out.append(await refused(1))
    net.reboot(b.address)
    out.append(await a.request(ep, 3))
    return out, loop.time()


def test_sim_request_reply_and_faults():
    ref, port = [package(n).run_simulation(
        request_reply_and_faults(package(n)), seed=1) for n in (REF, PORT)]
    out = port[0]
    assert out[:3] == [42, 10, True] and out[4] == 2 and out[6] == 6
    assert out[3] == out[5] != "answered"
    assert port == ref


# --------------------------------------------------------------------------
# the networked cluster


def netsim(P, body, seed=0, multi=False):
    from importlib import import_module
    ClusterConfig = import_module(f"{P.name}.core.cluster").ClusterConfig
    NetworkedCluster = import_module(
        f"{P.name}.core.cluster_rpc").NetworkedCluster
    config = ClusterConfig(commit_proxies=2, grv_proxies=2, resolvers=2,
                           logs=2, storage_servers=4) if multi \
        else ClusterConfig()
    knobs = P.Knobs().override(
        RESOLVER_CONFLICT_BACKEND="cuda" if P.name == PORT else "numpy",
        **SHAPE)

    async def main():
        async with NetworkedCluster(config, knobs,
                                    **P.device_kw) as cluster:
            return await body(P, P.Database(cluster))
    return P.run_simulation(main(), seed=seed)


def both(body, **kw):
    return [netsim(package(n), body, **kw) for n in (REF, PORT)]


async def set_get(P, db):
    await db.set(b"hello", b"world")
    return await db.get(b"hello"), await db.get_range(b"", b"\xff")


async def conflict(P, db):
    await db.set(b"x", b"0")
    tr1, tr2 = db.create_transaction(), db.create_transaction()
    await tr1.get(b"x")
    await tr2.get(b"x")
    tr1.set(b"x", b"1")
    tr2.set(b"x", b"2")
    v1 = await tr1.commit()
    try:
        await tr2.commit()
        second = "committed"
    except P.errors.NotCommitted as e:
        second = e.code
    return v1, second, await db.get(b"x")


NODES, CLIENTS, PER_CLIENT = 10, 2, 10


async def cycle(P, db):
    """The Cycle workload: NODES keys each naming the next, clients
    rotate three consecutive links a transaction; the links must still
    form one cycle of NODES (REF:fdbserver/workloads/Cycle.actor.cpp)."""
    from importlib import import_module
    rng = import_module(f"{P.name}.runtime.rng").deterministic_random()

    def key(i):
        return b"cycle/%04d" % i

    async def setup(tr):
        for i in range(NODES):
            tr.set(key(i), b"%d" % ((i + 1) % NODES))
    await db.run(setup)
    done = []

    async def client():
        for _ in range(PER_CLIENT):
            r = rng.random_int(0, NODES)

            async def swap(tr, r=r):
                a = int(await tr.get(key(r)))
                b = int(await tr.get(key(a)))
                c = int(await tr.get(key(b)))
                tr.set(key(r), b"%d" % b)
                tr.set(key(b), b"%d" % a)
                tr.set(key(a), b"%d" % c)
            await db.run(swap)
            done.append(r)
    await asyncio.gather(*(client() for _ in range(CLIENTS)))
    rows = await db.get_range(b"cycle/", b"cycle0")
    nxt = {int(k[6:]): int(v) for k, v in rows}
    seen, i = set(), 0
    while i not in seen:
        seen.add(i)
        i = nxt[i]
    return len(done), len(seen), rows


async def counters(P, db):
    async def incr(tr):
        v = await tr.get(b"c")
        n = int.from_bytes(v, "big") if v else 0
        tr.set(b"c", (n + 1).to_bytes(4, "big"))
    for _ in range(3):
        await asyncio.gather(db.run(incr), db.run(incr))
    return await db.get_range(b"", b"\xff")


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_networked_set_get(multi):
    ref, port = both(set_get, multi=multi)
    assert port == (b"world", [(b"hello", b"world")])
    assert port == ref


def test_networked_conflict():
    ref, port = both(conflict, multi=True)
    assert port[1] == 1020 and port[2] == b"1"
    assert port == ref


def test_networked_cycle_workload():
    ref, port = both(cycle, seed=4, multi=True)
    assert port[:2] == (CLIENTS * PER_CLIENT, NODES)
    assert port == ref


def test_networked_determinism():
    ref, port = both(counters, seed=17, multi=True)
    again = netsim(package(PORT), counters, seed=17, multi=True)
    assert port == again == ref
    assert port == [(b"c", (6).to_bytes(4, "big"))]


def test_networked_cluster_default_device_is_the_card(monkeypatch):
    """Without a device the networked cluster's resolvers want the card,
    and without one they raise instead of running on the host."""
    from foundationdb_tpu_torch.core.cluster_rpc import NetworkedCluster
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NetworkedCluster(knobs=Knobs().override(**SHAPE))


# --------------------------------------------------------------------------
# TCP on localhost (a real event loop)


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_tcp_transport_localhost():
    from foundationdb_tpu_torch.rpc.tcp_transport import TcpTransport
    from foundationdb_tpu_torch.rpc.transport import Endpoint, NetworkAddress
    from foundationdb_tpu_torch.runtime.errors import NotCommitted

    async def main():
        pa, pb = free_ports(2)
        a = TcpTransport(NetworkAddress("127.0.0.1", pa))
        b = TcpTransport(NetworkAddress("127.0.0.1", pb))
        await a.listen()
        await b.listen()
        try:
            async def handler(x):
                return {"echo": x, "by": "b"}
            ep = Endpoint(b.address, b.dispatcher.register(handler))
            out = await a.request(ep, [1, b"two", None])
            assert out == {"echo": [1, b"two", None], "by": "b"}

            # errors propagate with their code
            async def failing(x):
                raise NotCommitted()
            with pytest.raises(NotCommitted):
                await a.request(Endpoint(b.address,
                                         b.dispatcher.register(failing)), 0)

            # one-way delivery
            got = asyncio.get_running_loop().create_future()

            async def notify(x):
                if not got.done():
                    got.set_result(x)
            a.one_way(Endpoint(b.address, b.dispatcher.register(notify)),
                      b"ping")
            assert await asyncio.wait_for(got, 5) == b"ping"
        finally:
            await a.close()
            await b.close()
    asyncio.run(main())


def make_certs(d):
    """One CA and one leaf certificate signed by it (openssl CLI)."""
    def run(*args):
        subprocess.run(["openssl", *args], check=True, capture_output=True)
    ca_key, ca_crt = d / "ca.key", d / "ca.crt"
    run("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout",
        str(ca_key), "-out", str(ca_crt), "-days", "1", "-subj",
        "/CN=port-test-ca")
    key, csr, crt = d / "node.key", d / "node.csr", d / "node.crt"
    run("req", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
        "-out", str(csr), "-subj", "/CN=port-node")
    run("x509", "-req", "-in", str(csr), "-CA", str(ca_crt), "-CAkey",
        str(ca_key), "-CAcreateserial", "-out", str(crt), "-days", "1")
    return str(crt), str(key), str(ca_crt)


def test_tcp_transport_mutual_tls(tmp_path):
    """Two transports holding certificates from one CA talk; a peer
    without certificates gets no answer (tests/test_tls.py's claim, at
    the transport)."""
    from foundationdb_tpu_torch.rpc.tcp_transport import TcpTransport, TlsConfig
    from foundationdb_tpu_torch.rpc.transport import Endpoint, NetworkAddress
    from foundationdb_tpu_torch.runtime.errors import FdbError
    tls = TlsConfig(*make_certs(tmp_path))

    async def main():
        pa, pb, pc = free_ports(3)
        a = TcpTransport(NetworkAddress("127.0.0.1", pa), tls=tls)
        b = TcpTransport(NetworkAddress("127.0.0.1", pb), tls=tls)
        stranger = TcpTransport(NetworkAddress("127.0.0.1", pc))
        await b.listen()
        try:
            async def handler(x):
                return x + 1
            ep = Endpoint(b.address, b.dispatcher.register(handler))
            assert await a.request(ep, 41) == 42
            with pytest.raises((FdbError, asyncio.TimeoutError)):
                await asyncio.wait_for(stranger.request(ep, 1), 10)
        finally:
            for t in (a, b, stranger):
                await t.close()
    asyncio.run(main())
