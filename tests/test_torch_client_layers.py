"""The port's client layers against the JAX package's.

(a) the special-key space (``client/special_keys.py`` with
    ``core/management.py``): the in-process scenarios of
    tests/test_special_keys.py through both packages under one seed, each
    logging every read-back, every row, every raised error's class and
    message, and the final keyspace; the logs must be equal.  A read of
    ``\\xff\\xff/error_message`` through the port's Transaction is the
    regression test of the module the port once lacked.  The management
    API's calls (exclude, include, configure, lock, unlock) run the same
    way;
(b) the tuple layer: a numpy-seeded set of nested tuples over every type
    code packs to equal bytes, unpacks back, and sorts in the same order;
(c) subspaces and the directory layer on in-process Clusters: create,
    open, list, move, remove, a partition, and the high-contention
    allocator under 8 contending clients; the prefixes and the final
    keyspace must be equal.

The reference's resolver runs its ``tpu`` backend on JAX's CPU, the
port's its ``cuda`` backend on ``torch.device("cpu")``.
"""

from __future__ import annotations

import asyncio
import importlib
import math
import types
import uuid

import numpy as np
import pytest
import torch

from torch_parity import buggify_off  # noqa: F401  (autouse)

CPU = torch.device("cpu")
# tests/test_torch_cluster.py's small resolver shapes
SHAPE = dict(RESOLVER_BATCH_TXNS=16, RESOLVER_RANGES_PER_TXN=4,
             KEY_ENCODE_BYTES=16, CONFLICT_RING_CAPACITY=1 << 12,
             CONFLICT_WINDOW_SLOTS=256, CONFLICT_DICT_SLOTS=0,
             RESOLVER_GROUP_BUCKET=4, RESOLVER_GROUP_MAX=8)
PACKAGES = ("foundationdb_tpu", "foundationdb_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def package(name: str) -> types.SimpleNamespace:
    def m(path):
        return importlib.import_module(f"{name}.{path}")
    return types.SimpleNamespace(
        name=name, cluster=m("core.cluster"), client=m("client"),
        transaction=m("client.transaction"), errors=m("runtime.errors"),
        knobs=m("runtime.knobs"), simloop=m("runtime.simloop"),
        special_keys=m("client.special_keys"),
        management=m("core.management"), tuple=m("client.tuple"),
        subspace=m("client.subspace"), directory=m("client.directory"))


def knobs(p):
    kind = "cuda" if p.name.endswith("_torch") else "tpu"
    return p.knobs.Knobs().override(RESOLVER_CONFLICT_BACKEND=kind, **SHAPE)


def in_cluster(p, body, seed: int = 0):
    """``body(p, cluster)`` on a fresh in-process Cluster of package
    ``p``, then the final keyspace: user keys and the system ranges the
    layers write."""
    async def main():
        kw = {"device": CPU} if p.name.endswith("_torch") else {}
        async with p.cluster.Cluster(p.cluster.ClusterConfig(), knobs(p),
                                     **kw) as cluster:
            out = await body(p, cluster)
            tr = p.transaction.Transaction(cluster)
            tr.access_system_keys = True
            keyspace = [await tr.get_range(b, e) for b, e in (
                (b"", b"\xff"), (b"\xff/conf/", b"\xff/conf0"),
                (b"\xff/dbLocked", b"\xff/dbLocked\x00"))]
            return out, keyspace
    return p.simloop.run_simulation(main(), seed=seed)


def both(body, seed: int = 0):
    ref, port = (in_cluster(package(n), body, seed) for n in PACKAGES)
    assert port[0] == ref[0], "the scenario's log differs"
    assert port[1] == ref[1], "the final keyspace differs"
    return port


async def attempt(log: list, coro_or_fn):
    """Log a call's result, or the class and message of what it raised."""
    try:
        r = coro_or_fn()
        if asyncio.iscoroutine(r):
            r = await r
        log.append(("ok", r))
    except Exception as e:          # noqa: BLE001 — the class is the datum
        log.append((type(e).__name__, str(e)))


# --------------------------------------------------------------------------
# (a) the special-key space


def _pfx(p):
    return p.special_keys.ExcludedServersModule.prefix


async def sk_exclusion_roundtrip(p, cluster):
    pfx, real = _pfx(p), p.management.EXCLUDED_PREFIX
    log: list = []
    tr = p.transaction.Transaction(cluster)
    tr.special_key_space_enable_writes = True
    tr.set(pfx + b"10.0.0.9:4500", b"1")
    await tr.commit()
    tr.reset()
    log.append(await tr.get_range(pfx, pfx + b"\xff"))
    log.append(await tr.get(pfx + b"10.0.0.9:4500"))
    log.append(await tr.get(real + b"10.0.0.9:4500"))
    tr.reset()
    tr.special_key_space_enable_writes = True
    tr.clear(pfx + b"10.0.0.9:4500")
    await tr.commit()
    tr.reset()
    log.append(await tr.get(pfx + b"10.0.0.9:4500"))
    log.append(await tr.get(real + b"10.0.0.9:4500"))
    return log


async def sk_writes_gated(p, cluster):
    pfx = _pfx(p)
    log: list = []
    tr = p.transaction.Transaction(cluster)
    await attempt(log, lambda: tr.set(pfx + b"10.0.0.1:1", b"1"))
    log.append(await tr.get(b"\xff\xff/error_message"))
    tr.special_key_space_enable_writes = True
    await attempt(log, lambda: tr.set(b"\xff\xff/status/json", b"nope"))
    log.append(await tr.get(b"\xff\xff/error_message"))
    # status json needs a coordinator-backed database: refused before
    # the status module is reached
    await attempt(log, lambda: tr.get(b"\xff\xff/status/json"))
    return log


async def sk_unknown_key(p, cluster):
    log: list = []
    tr = p.transaction.Transaction(cluster)
    await attempt(log, lambda: tr.get(b"\xff\xff/no_such_module"))
    log.append(await tr.get(b"\xff\xff/error_message"))
    log.append(await tr.get(b"\xff\xff/connection_string"))
    return log


async def sk_cross_module_range(p, cluster):
    pfx = _pfx(p)
    tr = p.transaction.Transaction(cluster)
    tr.special_key_space_enable_writes = True
    tr.set(pfx + b"10.0.0.7:1", b"1")
    tr.set(pfx + b"10.0.0.8:2", b"")
    await tr.commit()
    tr.reset()
    rows = await tr.get_range(b"\xff\xff/", b"\xff\xff/z")
    return [rows, await tr.get_range(b"\xff\xff/", b"\xff\xff/z", limit=1),
            await tr.get_range(b"\xff\xff/", b"\xff\xff/z", reverse=True),
            [k for k, _ in rows] == sorted(k for k, _ in rows)]


async def sk_module_dispatch(p, cluster):
    sks = p.special_keys.SpecialKeySpace()
    return [type(sks.module_for(k)).__name__ for k in (
        _pfx(p) + b"1.2.3.4:5", b"\xff\xff/status/json", b"\xff\xff/bogus",
        b"\xff\xff/error_message", b"\xff\xff/worker_interfaces/x")]


SPECIAL = {f.__name__[3:]: f for f in (
    sk_exclusion_roundtrip, sk_writes_gated, sk_unknown_key,
    sk_cross_module_range, sk_module_dispatch)}


@pytest.mark.parametrize("name", list(SPECIAL))
def test_special_keys_match_reference(name):
    log, _ = both(SPECIAL[name])
    if name == "exclusion_roundtrip":
        pfx = _pfx(package("foundationdb_tpu_torch"))
        assert log == [[(pfx + b"10.0.0.9:4500", b"1")], b"1", b"1", None,
                       None]
    elif name == "writes_gated":
        assert [x[0] for x in log[::2]] == ["client_invalid_operation"] * 3
        assert b"SPECIAL_KEY_SPACE_ENABLE_WRITES" in log[1]
        assert b"not writable" in log[3]
    elif name == "unknown_key":
        assert log[0][0] == "client_invalid_operation" and log[2] is None
    elif name == "cross_module_range":
        assert log[3] and len(log[0]) >= 2 and len(log[1]) == 1
    else:
        assert log == ["ExcludedServersModule", "StatusJsonModule",
                       "NoneType", "ErrorMessageModule",
                       "WorkerInterfacesModule"]


def test_error_message_reads_through_the_port():
    """The special-key read that failed while the port had no
    ``client/special_keys.py``: nothing recorded yet reads None, and a
    refused write's reason reads back."""
    p = package("foundationdb_tpu_torch")

    async def body(p, cluster):
        tr = p.transaction.Transaction(cluster)
        first = await tr.get(b"\xff\xff/error_message")
        with pytest.raises(p.errors.ClientInvalidOperation):
            tr.set(_pfx(p) + b"1.1.1.1:1", b"1")
        return first, await tr.get(b"\xff\xff/error_message")
    (first, msg), _ = in_cluster(p, body)
    assert first is None
    assert b"SPECIAL_KEY_SPACE_ENABLE_WRITES" in msg


async def management_calls(p, cluster):
    m = p.management
    db = p.client.Database(cluster)
    log: list = []
    await m.exclude_servers(db, ["10.0.0.1:4500", "10.0.0.2:4500"])
    await m.include_servers(db, ["10.0.0.2:4500"])
    tr = p.transaction.Transaction(cluster)
    rows = await tr.get_range(m.EXCLUDED_PREFIX, m.EXCLUDED_PREFIX + b"\xff")
    log.append(sorted(m.decode_excluded(rows)))
    await m.configure(db, resolvers=2)
    await attempt(log, lambda: m.configure(db, no_such_field=1))
    await m.configure_regions(db, [{"id": "dc1", "priority": 1}])
    await attempt(log, lambda: m.configure_regions(db, [{"priority": 1}]))
    uid, other = b"u" * 16, b"o" * 16
    await m.lock_database(db, uid)
    await attempt(log, lambda: m.lock_database(db, other))
    await attempt(log, lambda: db.set(b"while-locked", b"x"))
    await attempt(log, lambda: m.unlock_database(db, other))
    await m.unlock_database(db, uid)
    await db.set(b"after-unlock", b"y")
    log.append(await db.get(b"after-unlock"))
    return log


def test_management_api_matches_reference():
    log, keyspace = both(management_calls)
    assert log[0] == ["10.0.0.1:4500"]
    assert [x[0] for x in log[1:6]] == [
        "ValueError", "ValueError", "DatabaseLockedByOther",
        "database_locked", "DatabaseLockedByOther"]
    assert log[6] == b"y"
    assert [k for k, _ in keyspace[1]] == [
        b"\xff/conf/excluded/10.0.0.1:4500", b"\xff/conf/regions",
        b"\xff/conf/resolvers"]
    assert keyspace[2] == []            # unlocked at the end


# --------------------------------------------------------------------------
# (b) the tuple layer

_BOUNDARY_INTS = sorted({s * v for n in range(1, 9)
                         for v in ((1 << (8 * n)) - 1, 1 << (8 * (n - 1)),
                                   (1 << (8 * n)) - 2)
                         for s in (1, -1)} | {0})


def tuple_items(p, seed: int = 1, n: int = 400) -> list[tuple]:
    """Seeded tuples of 1-4 items drawn over every type the layer packs,
    a third of them with a nested tuple."""
    g = np.random.default_rng(seed)
    T = p.tuple

    def atom():
        k = int(g.integers(0, 11))
        if k == 0:
            return None
        if k == 1:
            return bytes(g.integers(0, 256, int(g.integers(0, 6)),
                                    dtype=np.uint8)) + b"\x00" * int(
                g.integers(0, 2))
        if k == 2:
            return "".join(chr(int(c)) for c in
                           g.integers(0x20, 0x3000, int(g.integers(0, 5))))
        if k == 3:
            return _BOUNDARY_INTS[int(g.integers(0, len(_BOUNDARY_INTS)))]
        if k == 4:
            return int(g.integers(-1000, 1000))
        if k == 5:
            return float(np.float32(g.normal() * 1e3))
        if k == 6:
            return float(g.choice([g.normal() * 1e30, -0.0, 0.0,
                                   math.inf, -math.inf]))
        if k == 7:
            return bool(g.integers(0, 2))
        if k == 8:
            return uuid.UUID(bytes=bytes(g.integers(0, 256, 16,
                                                    dtype=np.uint8)))
        if k == 9:
            return T.Versionstamp(bytes(g.integers(0, 256, 10,
                                                   dtype=np.uint8)),
                                  int(g.integers(0, 1 << 16)))
        return (atom(), None)

    out = []
    for _ in range(n):
        t = [atom() for _ in range(int(g.integers(1, 5)))]
        if g.random() < 0.33:
            t.append(tuple(atom() for _ in range(int(g.integers(0, 4)))))
        out.append(tuple(t))
    return out


def _plain(x):
    """A value comparable across packages (Versionstamps are per-package
    classes)."""
    if isinstance(x, tuple):
        return tuple(_plain(y) for y in x)
    if hasattr(x, "bytes") and not isinstance(x, (bytes, uuid.UUID)):
        return ("vs", x.bytes)
    if isinstance(x, float) and math.isnan(x):
        return ("nan",)
    return x


def test_tuple_pack_unpack_and_order_match_reference():
    ref, port = (package(n).tuple for n in PACKAGES)
    ts = {n: tuple_items(package(n)) for n in PACKAGES}
    packed = {}
    for name, T in zip(PACKAGES, (ref, port)):
        packed[name] = [T.pack(t) for t in ts[name]]
        back = [T.unpack(b) for b in packed[name]]
        assert [_plain(b) for b in back] == [_plain(t) for t in ts[name]]
    assert packed[PACKAGES[0]] == packed[PACKAGES[1]]
    order = {n: sorted(range(len(packed[n])), key=packed[n].__getitem__)
             for n in PACKAGES}
    assert order[PACKAGES[0]] == order[PACKAGES[1]]
    # the bytes order is the values' order: ints and doubles
    ints = [port.pack((i,)) for i in _BOUNDARY_INTS]
    assert ints == sorted(ints)
    fl = sorted({-math.inf, -1e30, -1.5, -0.0, 0.0, 1e-300, 2.0, math.inf})
    assert [port.pack((f,)) for f in fl] == sorted(port.pack((f,)) for f in fl)
    # a single-precision float (type code 0x20) decodes alike; ints past
    # 8 bytes and unknown types refuse alike
    f32 = bytes([0x20]) + bytes([0xC0, 0x49, 0x0F, 0xDB])
    assert port.unpack(f32) == ref.unpack(f32)
    for bad in ((1 << 64,), (-(1 << 64),), (object(),)):
        for T in (ref, port):
            with pytest.raises((ValueError, TypeError)):
                T.pack(bad)
    assert port.range_of((1, "a")) == ref.range_of((1, "a"))


# --------------------------------------------------------------------------
# (c) subspaces and the directory layer


def test_subspace_matches_reference():
    out = []
    for n in PACKAGES:
        S = package(n).subspace.Subspace
        s = S(("app",), raw_prefix=b"\x15")
        k = s.pack((1, b"x", None))
        out.append([s.key(), k, s.unpack(k), s.range((1,)), s.contains(k),
                    s["users"].key(), s.subspace((2, "y")).key(),
                    S.from_raw(b"raw").pack((3,)), repr(s),
                    s["users"] == S(("app",), raw_prefix=b"\x15")["users"]])
        with pytest.raises(ValueError):
            s.unpack(b"elsewhere")
    assert out[0] == out[1]


def _name(x):
    return x if isinstance(x, str) else x.decode()


async def directory_ops(p, cluster):
    D = p.directory
    db = p.client.Database(cluster)
    dl = D.DirectoryLayer()
    log: list = []

    async def body(tr):
        d = await dl.create_or_open(tr, ("app", "users"))
        d2 = await dl.create_or_open(tr, ("app", "orders"))
        q = await dl.create_or_open(tr, ("a", "b"), layer=b"queue")
        tr.set(d.pack((b"alice",)), b"1")
        tr.set(d2.pack((7,)), b"o")
        tr.set(q.pack((1,)), b"v")
        return d.key(), d2.key(), q.key()
    log.append(await db.run(body))

    async def body2(tr):
        out = [(await dl.open(tr, ("app", "users"))).key(),
               [_name(n) for n in await dl.list(tr, ("app",))]]
        for call in (lambda: dl.create(tr, ("app", "users")),
                     lambda: dl.open(tr, ("app", "nope")),
                     lambda: dl.open(tr, ("a", "b"), layer=b"other"),
                     lambda: dl.move(tr, ("a", "b"), ("a", "b", "in"))):
            await attempt(out, call)
        moved = await dl.move(tr, ("a", "b"), ("c",))
        out += [moved.key(), await dl.exists(tr, ("a", "b")),
                await tr.get((await dl.open(tr, ("c",),
                                            layer=b"queue")).pack((1,)))]
        return out
    log.append(await db.run(body2))

    async def body3(tr):
        removed = await dl.remove(tr, ("app", "users"))
        return [removed, await dl.exists(tr, ("app", "users")),
                await dl.remove(tr, ("app", "users")),
                await tr.get((await dl.open(tr, ("app", "orders")))
                             .pack((7,)))]
    log.append(await db.run(body3))

    async def body4(tr):
        part = await dl.create_or_open(tr, ("tenants", "acme"),
                                       layer=b"partition")
        inner = await part.create_or_open(tr, ("data",))
        tr.set(inner.pack((b"k",)), b"v")
        await part.create_or_open(tr, ("more",))
        out = [type(part).__name__, part._prefix, inner.key()]
        await attempt(out, lambda: part.pack((1,)))
        via = await dl.open(tr, ("tenants", "acme", "data"))
        out += [via.key(), sorted(_name(n) for n in await part.list(tr)),
                sorted(_name(n) for n in
                       await dl.list(tr, ("tenants", "acme")))]
        return out
    log.append(await db.run(body4))

    # the high-contention allocator under 8 contending clients
    space = p.subspace.Subspace((b"hca-test",))
    got: list = []

    async def one():
        async def alloc(tr):
            return await D.HighContentionAllocator(space).allocate(tr)
        for _ in range(3):
            got.append(await db.run(alloc))
    await asyncio.gather(*(one() for _ in range(8)))
    log.append(got)
    return log


def test_directory_layer_matches_reference():
    log, keyspace = both(directory_ops, seed=5)
    created, opened, removed, part, hca = log
    assert len(set(created)) == 3
    assert opened[0] == created[0] and opened[1] == ["orders", "users"]
    assert [x[0] for x in opened[2:6]] == ["DirectoryError"] * 4
    assert opened[6] == created[2] and opened[7] is False \
        and opened[8] == b"v"
    assert removed == [True, False, False, b"o"]
    assert part[0] == "DirectoryPartition" and part[3][0] == "DirectoryError"
    assert part[4] == part[2] and part[5] == part[6] == ["data", "more"]
    assert len(hca) == 24 and len(set(hca)) == 24
    assert any(k.startswith(b"\xfe") for k, _ in keyspace[0])
