"""The port's durable storage against the JAX package's.

(a) the ``lsm`` and ``btree`` engines: one seeded op sequence (sets,
    clears, overwrites, reopens) through the reference's and the port's
    engine, each on its own package's ``SimFileSystem`` under its own
    ``run_simulation``: every ``get`` / ``get_batch`` / ``range`` answer
    and every file's bytes equal after every commit, and after a torn
    commit and ``kill_unsynced`` the recovered state equal too;
(b) a durable ``Cluster.create`` restart: the scenarios of
    tests/test_durability.py (restart after durability, restart after an
    immediate kill) on the memory engine and the lsm/btree cluster
    restarts of tests/test_lsm.py / tests/test_btree.py, through both
    packages under one seed: equal rows read back and an equal final
    keyspace, with the port's read mirror (on the CPU) armed on every
    storage server whose engine has a packed index, and serving a
    restarted memory-engine cluster's batched reads;
(c) the engine registry.
"""

from __future__ import annotations

import importlib
import types

import numpy as np
import pytest
import torch

from torch_parity import buggify_off  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PACKAGES = ("foundationdb_tpu", "foundationdb_tpu_torch")

ENGINES = {
    "lsm": ("LSMKVStore", {"_MEMTABLE_BYTES": 1500, "_BLOCK_BYTES": 200,
                           "_MAX_RUNS": 3}),
    "btree": ("BTreeKVStore", {"_LEAF_BYTES": 256, "_FANOUT": 4,
                               "_COMPACT_MIN": 4096, "_COMPACT_FACTOR": 3}),
}


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
        name=name, files=m("runtime.files"), simloop=m("runtime.simloop"),
        knobs=m("runtime.knobs"), cluster=m("core.cluster"),
        client=m("client"), transaction=m("client.transaction"),
        storage=m("storage"), kv_store=m("storage.kv_store"),
        lsm=m("storage.lsm"), btree=m("storage.btree"))


# --------------------------------------------------------------------------
# (a) the engines


def engine_trace(p, engine: str, monkeypatch, seed: int = 5) -> list:
    cls_name, consts = ENGINES[engine]
    mod = getattr(p, engine)
    for k, v in consts.items():
        monkeypatch.setattr(mod, k, v)
    cls = getattr(mod, cls_name)
    OP_SET, OP_CLEAR = p.kv_store.OP_SET, p.kv_store.OP_CLEAR

    def key(i):
        return b"%04d" % i

    async def main():
        g = np.random.default_rng(seed)
        fs = p.files.SimFileSystem()
        kv = await cls.open(fs, "db/e")
        log = []
        for step in range(48):
            ops = []
            for _ in range(int(g.integers(1, 14))):
                if g.random() < 0.2:
                    a, b = sorted(int(x) for x in g.integers(0, 300, 2))
                    ops.append((OP_CLEAR, key(a), key(b)))
                else:
                    ops.append((OP_SET, key(int(g.integers(0, 300))),
                                bytes([int(g.integers(0, 256))])
                                * int(g.integers(1, 60))))
            await kv.commit(ops, {"durable_version": step})
            probes = sorted({key(int(x)) for x in g.integers(0, 320, 40)})
            a, b = sorted(int(x) for x in g.integers(0, 320, 2))
            log.append((step, kv.get_batch(probes),
                        [kv.get(k) for k in probes[:8]],
                        list(kv.range(key(a), key(b))),
                        list(kv.range(key(a), key(b), reverse=True)),
                        {q: bytes(d) for q, d in fs.disks.items()}))
            if step % 16 == 15:
                await kv.close()
                kv = await cls.open(fs, "db/e")
        # a commit torn by the machine dying before its sync
        if engine == "lsm":
            kv._apply_mem([(OP_SET, b"unsynced", b"lost")])
        else:
            await kv._f.write(kv._end, b"\x00torn-node-bytes")
        fs.kill_unsynced()
        kv2 = await cls.open(fs, "db/e")
        log.append(("recovered", dict(kv2.meta),
                    list(kv2.range(b"", b"\xff\xff")),
                    kv2.get_batch(probes + [b"unsynced"]),
                    {q: bytes(d) for q, d in fs.disks.items()}))
        await kv2.close()
        return log

    return p.simloop.run_simulation(main(), seed=1)


@pytest.mark.parametrize("engine", ["lsm", "btree"])
def test_engine_answers_files_and_recovery_match_reference(engine,
                                                           monkeypatch):
    ref, port = (engine_trace(package(n), engine, monkeypatch)
                 for n in PACKAGES)
    assert len(ref) == len(port) == 49
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a[:-1] == b[:-1], f"answers differ at commit {i}"
        assert a[-1] == b[-1], f"file bytes differ at commit {i}"
    assert ref[-1][2], "nothing survived the kill"
    assert b"unsynced" not in dict(ref[-1][2])


# --------------------------------------------------------------------------
# (b) durable cluster restarts


def durable_knobs(p, engine: str, **over):
    kv = dict(RESOLVER_CONFLICT_BACKEND="cpp", STORAGE_ENGINE=engine,
              STORAGE_VERSION_WINDOW=100_000, STORAGE_DURABILITY_LAG=0.05,
              STORAGE_DEVICE_READ_MIN_BATCH=4)
    kv.update(over)
    return p.knobs.Knobs().override(**kv)


def create(p, cfg, knobs, fs, data_dir):
    kw = {"device": CPU} if p.name.endswith("_torch") else {}
    return p.cluster.Cluster.create(cfg, knobs, fs=fs, data_dir=data_dir,
                                    **kw)


def mirror_counters(cluster) -> list:
    """Each storage server's read-mirror counters (None: no mirror)."""
    return [ss._device_reads.metrics() if ss._device_reads is not None
            else None for ss in cluster.storage_servers]


async def until_durable(cluster, version) -> None:
    """Wait (in simulated time) until every storage server's durable
    version reaches ``version``."""
    import asyncio
    while min(ss.durable_version for ss in cluster.storage_servers) \
            < version:
        await asyncio.sleep(0.05)


async def read_back(p, cluster, keys):
    tr = p.transaction.Transaction(cluster)
    return await tr.get_multi(keys)


def scenario_restart_after_durability(p, engine):
    """tests/test_durability.py::test_cluster_restart_preserves_committed_data,
    with every key read back in one batch after the restart."""
    async def main():
        import asyncio
        fs = p.files.SimFileSystem()
        cfg = p.cluster.ClusterConfig(storage_servers=2, logs=2)
        k = durable_knobs(p, engine)
        keys = [b"key%02d" % i for i in range(20)]
        cluster = await create(p, cfg, k, fs, "c1")
        async with cluster:
            db = p.client.Database(cluster)
            for i, key in enumerate(keys):
                await db.set(key, b"val%d" % i)
            await db.clear_range(b"key00", b"key05")
            await asyncio.sleep(1.0)
        fs.kill_unsynced()
        cluster2 = await create(p, cfg, k, fs, "c1")
        async with cluster2:
            db2 = p.client.Database(cluster2)
            rows = await db2.get_range(b"key", b"kez")
            got = await read_back(p, cluster2, keys + [b"nokey%02d" % i
                                                      for i in range(8)])
            await db2.set(b"after-restart", b"yes")
            after = await db2.get(b"after-restart")
            every = await db2.get_range(b"", b"\xff")
            return rows, got, after, every, mirror_counters(cluster2)
    return p.simloop.run_simulation(main(), seed=3)


def scenario_restart_after_immediate_kill(p, engine):
    """tests/test_durability.py::test_cluster_restart_after_immediate_kill:
    no durability tick, the TLogs' fsyncs alone carry the data."""
    async def main():
        fs = p.files.SimFileSystem()
        cfg = p.cluster.ClusterConfig(storage_servers=2, logs=1)
        k = durable_knobs(p, engine, STORAGE_DURABILITY_LAG=30.0)
        cluster = await create(p, cfg, k, fs, "d")
        async with cluster:
            db = p.client.Database(cluster)
            await db.set(b"x", b"1")
            await db.set(b"y", b"2")
        fs.kill_unsynced()
        cluster2 = await create(p, cfg, k, fs, "d")
        async with cluster2:
            db2 = p.client.Database(cluster2)
            got = [await db2.get(b"x"), await db2.get(b"y")]
            every = await db2.get_range(b"", b"\xff")
            return got, every, mirror_counters(cluster2)
    return p.simloop.run_simulation(main(), seed=6)


def scenario_engine_restart(p, engine):
    """tests/test_lsm.py / tests/test_btree.py's cluster restart resume,
    with the 30 keys also read back in one batch."""
    async def main():
        fs = p.files.SimFileSystem()
        k = durable_knobs(p, engine)
        keys = [b"p%02d" % i for i in range(30)]
        cluster = await create(p, p.cluster.ClusterConfig(), k, fs, "clu")
        async with cluster:
            db = p.client.Database(cluster)
            for i, key in enumerate(keys):
                await db.set(key, b"v%02d" % i)
        cluster2 = await create(p, p.cluster.ClusterConfig(), k, fs, "clu")
        async with cluster2:
            db2 = p.client.Database(cluster2)
            one = [await db2.get(key) for key in keys]
            got = await read_back(p, cluster2, keys)
            rows = await db2.get_range(b"p", b"q", limit=0)
            return one, got, rows, mirror_counters(cluster2)
    return p.simloop.run_simulation(main(), seed=4)


@pytest.mark.parametrize("scenario,engine", [
    (scenario_restart_after_durability, "memory"),
    (scenario_restart_after_durability, "lsm"),
    (scenario_restart_after_immediate_kill, "memory"),
    (scenario_engine_restart, "lsm"),
    (scenario_engine_restart, "btree"),
], ids=["durable-memory", "durable-lsm", "immediate-kill-memory",
        "restart-lsm", "restart-btree"])
def test_durable_cluster_restart_matches_reference(scenario, engine):
    ref, port = (scenario(package(n), engine) for n in PACKAGES)
    # the data first, then the whole result: each storage server's
    # read-mirror counters too
    assert ref[:-1] == port[:-1]
    assert ref == port, (ref[-1], port[-1])
    if scenario is scenario_restart_after_durability:
        rows, got, after, every, mirrors = port
        assert [k for k, _ in rows] == [b"key%02d" % i
                                        for i in range(5, 20)]
        assert got[:20] == [None] * 5 + [b"val%d" % i for i in range(5, 20)]
        assert after == b"yes"
    elif scenario is scenario_restart_after_immediate_kill:
        assert port[0] == [b"1", b"2"]
        mirrors = port[-1]
    else:
        one, got, rows, mirrors = port
        assert one == got == [b"v%02d" % i for i in range(30)]
        assert len(rows) == 30
    armed = [m for m in mirrors if m is not None]
    if engine == "btree":
        assert not armed            # no packed index: the engine serves
    else:
        assert len(armed) == len(mirrors)
        assert all(m["device_read_active"] == 1 for m in armed)


def test_durable_cluster_mirror_serves_on_the_cpu():
    """A restarted durable memory-engine cluster on the port: a batch of
    reads that misses the MVCC window goes through the read mirror (its
    first batch primes the upload), byte for byte what the engine
    answers.  1500 keys: more than the key index's pending overlay
    holds, so the recovered index has a base run to mirror."""
    p = package("foundationdb_tpu_torch")

    async def main():
        fs = p.files.SimFileSystem()
        k = durable_knobs(p, "memory")
        keys = [b"m%04d" % i for i in range(1500)]
        cluster = await create(p, p.cluster.ClusterConfig(), k, fs, "mm")
        async with cluster:
            tr = p.transaction.Transaction(cluster)
            for i, key in enumerate(keys):
                tr.set(key, b"w%04d" % i)
            await until_durable(cluster, await tr.commit())
        cluster2 = await create(p, p.cluster.ClusterConfig(), k, fs, "mm")
        async with cluster2:
            ss = cluster2.storage_servers[0]
            probe = keys[::7] + [b"m9999", b"a", b"z"]
            got = [await read_back(p, cluster2, probe) for _ in range(3)]
            want = ss.engine.get_batch(probe)
            return got, want, ss._device_reads.metrics()
    got, want, m = p.simloop.run_simulation(main(), seed=8)
    assert got[0] == got[1] == got[2]
    assert got[0] == want
    assert m["device_read_batches"] == 2
    assert m["device_read_fallbacks"] == 1      # the cold start


# --------------------------------------------------------------------------
# (c) the registry


def test_engine_registry_serves_every_engine():
    from foundationdb_tpu_torch.storage import ENGINE_NAMES, engine_class
    from foundationdb_tpu_torch.storage.btree import BTreeKVStore
    from foundationdb_tpu_torch.storage.kv_store import MemoryKVStore
    from foundationdb_tpu_torch.storage.lsm import LSMKVStore
    assert ENGINE_NAMES == ("memory", "lsm", "btree")
    assert [engine_class(n) for n in ENGINE_NAMES] == \
        [MemoryKVStore, LSMKVStore, BTreeKVStore]
    with pytest.raises(ValueError):
        engine_class("rocksdb")
