"""The port's in-process commit path against the JAX package's.

Client transaction → GRV / commit proxy → sequencer → resolver → TLog →
storage pull/apply → versioned reads, all in one process under each
package's own SimEventLoop.  The port's resolver runs the ``cuda``
backend on ``torch.device("cpu")`` here, so the kernels' plain versions
answer; the reference runs its ``tpu`` backend on JAX's CPU.

(a) the scenarios of tests/test_pipeline.py through the port, on the
    ``cpp`` and ``cuda`` backends;
(b) one seeded mako-shaped client workload through both packages: equal
    per-transaction outcomes and an equal final keyspace, with the
    endpoint dictionary off and on (and a ``cuda``-marked twin that runs
    the port on the card against the port on the CPU);
(c) same-seed bit-identical traces across two fresh processes;
(d) the durable storage gates, the default device, and the wire registry.

The child half runs as ``python tests/test_torch_cluster.py --child
<trace-path>``: a seeded multi-role sim of the port that prints the
sha256 of its trace.
"""

from __future__ import annotations

import asyncio
import hashlib
import importlib
import os
import struct
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from torch_parity import buggify_off  # noqa: F401  (autouse)

_THIS = os.path.abspath(__file__)
_REPO = os.path.dirname(os.path.dirname(_THIS))
CPU = torch.device("cpu")

# small shapes: 16 txns a batch, 4 ranges, a ring of 1<<12 slots, a
# window of 256
SHAPE = dict(RESOLVER_BATCH_TXNS=16, RESOLVER_RANGES_PER_TXN=4,
             KEY_ENCODE_BYTES=16, CONFLICT_RING_CAPACITY=1 << 12,
             CONFLICT_WINDOW_SLOTS=256, CONFLICT_DICT_SLOTS=0,
             RESOLVER_GROUP_BUCKET=4, RESOLVER_GROUP_MAX=8)
DICT_SLOTS = 8 * 4 * 16 * 64        # 8·R·B·64, the smallest the backend takes


def package(name: str) -> types.SimpleNamespace:
    """The modules of one package that a client workload needs."""
    def m(path):
        return importlib.import_module(f"{name}.{path}")
    return types.SimpleNamespace(
        Cluster=m("core.cluster").Cluster,
        ClusterConfig=m("core.cluster").ClusterConfig,
        Database=m("client").Database,
        run_simulation=m("runtime.simloop").run_simulation,
        errors=m("runtime.errors"),
        Zipf=m("bench.workload").ZipfianGenerator,
        trace=m("runtime.trace"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes: one CPU thread each
    for torch's ops keeps these tests from starving their neighbours."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_knobs(backend: str, **over):
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    shape = SHAPE if backend == "cuda" else {}
    return Knobs().override(RESOLVER_CONFLICT_BACKEND=backend,
                            **dict(shape, **over))


def multi_config(P):
    return P.ClusterConfig(commit_proxies=2, grv_proxies=2, resolvers=2,
                           logs=2, storage_servers=4)


def port_sim(body, backend, config=None, seed=0, **knob_over):
    P = package("foundationdb_tpu_torch")

    async def main():
        async with P.Cluster(config or P.ClusterConfig(),
                             port_knobs(backend, **knob_over),
                             device=CPU) as cluster:
            return await body(P.Database(cluster))
    return P.run_simulation(main(), seed=seed)


# --------------------------------------------------------------------------
# (a) the scenarios of tests/test_pipeline.py


def _errors():
    return importlib.import_module("foundationdb_tpu_torch.runtime.errors")


async def s_set_get(db):
    await db.set(b"hello", b"world")
    assert await db.get(b"hello") == b"world"
    assert await db.get(b"missing") is None


async def s_get_range(db):
    async def fill(tr):
        for i in range(10):
            tr.set(b"k%02d" % i, b"v%d" % i)
    await db.run(fill)
    rows = await db.get_range(b"k00", b"k99")
    assert [k for k, _ in rows] == [b"k%02d" % i for i in range(10)]
    rows = await db.get_range(b"k03", b"k07")
    assert [k for k, _ in rows] == [b"k03", b"k04", b"k05", b"k06"]
    rows = await db.get_range(b"k00", b"k99", limit=3)
    assert [k for k, _ in rows] == [b"k00", b"k01", b"k02"]
    rows = await db.get_range(b"k00", b"k99", limit=3, reverse=True)
    assert [k for k, _ in rows] == [b"k09", b"k08", b"k07"]


async def s_clear_and_clear_range(db):
    async def fill(tr):
        for i in range(10):
            tr.set(b"k%02d" % i, b"v")
    await db.run(fill)
    await db.clear(b"k00")
    await db.clear_range(b"k03", b"k07")
    rows = await db.get_range(b"", b"\xff")
    assert [k for k, _ in rows] == [b"k01", b"k02", b"k07", b"k08", b"k09"]


async def s_ryw_semantics(db):
    await db.set(b"a", b"base")

    async def txn(tr):
        tr.set(b"b", b"new")
        assert await tr.get(b"b") == b"new"
        tr.clear(b"a")
        assert await tr.get(b"a") is None
        tr.set(b"c", b"3")
        rows = await tr.get_range(b"", b"\xff")
        assert [k for k, _ in rows] == [b"b", b"c"]
        tr.add(b"ctr", (5).to_bytes(8, "little"))
        v = await tr.get(b"ctr")
        assert int.from_bytes(v, "little") == 5
    await db.run(txn)
    assert await db.get(b"a") is None
    assert await db.get(b"b") == b"new"


async def s_conflict_detection(db):
    await db.set(b"x", b"0")
    tr1 = db.create_transaction()
    tr2 = db.create_transaction()
    await tr1.get(b"x")
    await tr2.get(b"x")
    tr1.set(b"x", b"1")
    tr2.set(b"x", b"2")
    await tr1.commit()
    with pytest.raises(_errors().NotCommitted):
        await tr2.commit()
    assert await db.get(b"x") == b"1"


async def s_no_conflict_disjoint_keys(db):
    tr1 = db.create_transaction()
    tr2 = db.create_transaction()
    await tr1.get(b"a")
    await tr2.get(b"b")
    tr1.set(b"a", b"1")
    tr2.set(b"b", b"2")
    await tr1.commit()
    await tr2.commit()


async def s_snapshot_read_no_conflict(db):
    await db.set(b"x", b"0")
    tr1 = db.create_transaction()
    tr2 = db.create_transaction()
    await tr1.get(b"x", snapshot=True)
    await tr2.get(b"x")
    tr1.set(b"y", b"1")
    tr2.set(b"x", b"2")
    await tr2.commit()
    await tr1.commit()


async def s_blind_write_no_conflict(db):
    tr1 = db.create_transaction()
    tr2 = db.create_transaction()
    tr1.set(b"x", b"1")
    tr2.set(b"x", b"2")
    await tr1.commit()
    await tr2.commit()


async def s_range_conflict(db):
    tr1 = db.create_transaction()
    tr2 = db.create_transaction()
    await tr1.get_range(b"a", b"m")
    tr1.set(b"out", b"1")
    tr2.set(b"c", b"2")
    await tr2.commit()
    with pytest.raises(_errors().NotCommitted):
        await tr1.commit()


async def s_atomic_ops_across_commits(db):
    for _ in range(3):
        async def add(tr):
            tr.add(b"ctr", (10).to_bytes(8, "little"))
        await db.run(add)
    assert int.from_bytes(await db.get(b"ctr"), "little") == 30

    async def amax(tr):
        tr.max(b"m", (7).to_bytes(8, "little"))
    await db.run(amax)

    async def amax2(tr):
        tr.max(b"m", (3).to_bytes(8, "little"))
    await db.run(amax2)
    assert int.from_bytes(await db.get(b"m"), "little") == 7


async def s_key_selectors(db):
    from foundationdb_tpu_torch.client import KeySelector

    async def fill(tr):
        for k in (b"a", b"c", b"e", b"g"):
            tr.set(k, b"v")
    await db.run(fill)
    tr = db.create_transaction()
    sel = KeySelector
    assert await tr.get_key(sel.first_greater_or_equal(b"c")) == b"c"
    assert await tr.get_key(sel.first_greater_than(b"c")) == b"e"
    assert await tr.get_key(sel.last_less_or_equal(b"c")) == b"c"
    assert await tr.get_key(sel.last_less_than(b"c")) == b"a"
    assert await tr.get_key(sel.first_greater_or_equal(b"b")) == b"c"
    assert await tr.get_key(sel.first_greater_or_equal(b"c") + 2) == b"g"
    rows = await tr.get_range(sel.first_greater_than(b"a"),
                              sel.first_greater_or_equal(b"g"))
    assert [k for k, _ in rows] == [b"c", b"e"]


async def s_versionstamped_key(db):
    async def vs(tr):
        key = b"vs/" + b"\x00" * 10 + struct.pack("<I", 3)
        tr.set_versionstamped_key(key, b"payload")
    await db.run(vs)
    rows = await db.get_range(b"vs/", b"vs0")
    assert len(rows) == 1
    k, v = rows[0]
    assert v == b"payload" and len(k) == 13
    assert struct.unpack(">Q", k[3:11])[0] > 0


async def s_too_old(db):
    await db.set(b"x", b"0")
    await asyncio.sleep(0.01)       # ≈10k versions of virtual time
    await db.set(b"x", b"1")
    tr = db.create_transaction()
    tr.set_read_version(1)          # far below the floor
    tr.set(b"x", b"2")
    tr.add_read_conflict_key(b"x")
    with pytest.raises(_errors().TransactionTooOld):
        await tr.commit()


async def s_watch(db):
    await db.set(b"w", b"0")
    tr = db.create_transaction()
    fut = await tr.watch(b"w")
    await tr.commit()
    assert not fut.done()
    await db.set(b"w", b"1")
    await asyncio.wait_for(fut, 5)


async def s_db_run_retries_conflict(db):
    await db.set(b"ctr", (0).to_bytes(8, "little"))

    async def incr(tr):
        v = await tr.get(b"ctr")
        tr.set(b"ctr", (int.from_bytes(v, "little") + 1).to_bytes(8, "little"))
    await asyncio.gather(*(db.run(incr) for _ in range(10)))
    assert int.from_bytes(await db.get(b"ctr"), "little") == 10


SCENARIOS = {f.__name__[2:]: f for f in (
    s_set_get, s_get_range, s_clear_and_clear_range, s_ryw_semantics,
    s_conflict_detection, s_no_conflict_disjoint_keys,
    s_snapshot_read_no_conflict, s_blind_write_no_conflict,
    s_range_conflict, s_atomic_ops_across_commits, s_key_selectors,
    s_versionstamped_key, s_too_old, s_watch, s_db_run_retries_conflict)}
# the scenarios tests/test_pipeline.py also runs on the multi-role config
MULTI = ("set_get", "get_range")
CASES = [(n, c) for n in SCENARIOS for c in
         (("single", "multi-role") if n in MULTI else ("single",))]


@pytest.mark.parametrize("backend", ["cpp", "cuda"])
@pytest.mark.parametrize("name,config", CASES,
                         ids=[f"{n}-{c}" for n, c in CASES])
def test_pipeline_scenario(name, config, backend):
    P = package("foundationdb_tpu_torch")
    over = dict(MAX_WRITE_TRANSACTION_LIFE_VERSIONS=1000) \
        if name == "too_old" else {}
    port_sim(SCENARIOS[name], backend,
             multi_config(P) if config == "multi-role" else None, **over)


def test_determinism_same_seed_same_result():
    async def body(db):
        from foundationdb_tpu_torch.runtime.rng import deterministic_random

        async def writer():
            rng = deterministic_random()
            for _ in range(5):
                async def go(tr):
                    k = b"k%d" % rng.random_int(0, 20)
                    v = await tr.get(k)
                    tr.set(k, (len(v or b"") + 1).to_bytes(4, "little"))
                await db.run(go)
        await asyncio.gather(*(writer() for _ in range(4)))
        return await db.get_range(b"", b"\xff")

    P = package("foundationdb_tpu_torch")
    r1 = port_sim(body, "cuda", multi_config(P), seed=7)
    r2 = port_sim(body, "cuda", multi_config(P), seed=7)
    assert r1 == r2 and len(r1) > 0


# --------------------------------------------------------------------------
# (b) a seeded mako-shaped client workload through both packages

CLIENTS, PER_CLIENT, N_KEYS = 8, 25, 200


def mako_plan(Zipf, seed: int = 11):
    """Per client, PER_CLIENT transactions of 4 zipf-chosen keys; about
    one in five is a blind write, the rest read-modify-write."""
    zipf = Zipf(N_KEYS, 0.99, seed)
    g = np.random.default_rng(seed)
    return [[([int(k) for k in zipf.sample(4)], bool(g.random() < 0.2))
             for _ in range(PER_CLIENT)] for _ in range(CLIENTS)]


def mako_body(P, plan):
    def key(i):
        return b"mako%012d" % i

    async def body(db):
        out = [[] for _ in plan]

        async def client(cid):
            for i, (ks, blind) in enumerate(plan[cid]):
                tr = db.create_transaction()
                try:
                    if not blind:
                        v = await tr.get(key(ks[0]))
                        await tr.get(key(ks[1]))
                        n = int((v or b"0").split(b":")[0]) + 1
                        tr.set(key(ks[0]), b"%d:%d-%d" % (n, cid, i))
                    tr.set(key(ks[2]), b"0:%d-%d" % (cid, i))
                    if blind:
                        tr.set(key(ks[3]), b"0:%d-%d" % (cid, i))
                    await tr.commit()
                    out[cid].append(tr.get_committed_version())
                except P.errors.FdbError as e:
                    out[cid].append(-e.code)
        await asyncio.gather(*(client(c) for c in range(len(plan))))
        return out, await db.get_range(b"", b"\xff")
    return body


def run_mako(name, knobs, plan, device=None, seed=5):
    P = package(name)

    async def main():
        kw = {} if device is None else {"device": device}
        async with P.Cluster(P.ClusterConfig(), knobs, **kw) as cluster:
            out = await mako_body(P, plan)(P.Database(cluster))
            # the port's backend counts its dictionary groups
            be = cluster.resolvers[0].backend
            return out + (getattr(be, "dict_dispatches", None),
                          getattr(be, "dict_fallbacks", None))
    return P.run_simulation(main(), seed=seed)


def ref_knobs(**over):
    from foundationdb_tpu.runtime.knobs import Knobs
    return Knobs().override(RESOLVER_CONFLICT_BACKEND="tpu",
                            **dict(SHAPE, **over))


def check_outcomes(outcomes, rows):
    flat = [x for c in outcomes for x in c]
    assert len(flat) == CLIENTS * PER_CLIENT
    assert sum(1 for x in flat if x > 0) > CLIENTS * PER_CLIENT // 4
    assert -1020 in flat                    # not_committed: conflicts ran
    assert len(rows) > 10


@pytest.mark.parametrize("dict_slots", [0, DICT_SLOTS])
def test_mako_matches_reference(dict_slots):
    from foundationdb_tpu.bench.workload import ZipfianGenerator
    plan = mako_plan(ZipfianGenerator)
    ref = run_mako("foundationdb_tpu", ref_knobs(
        CONFLICT_DICT_SLOTS=dict_slots), plan)
    port = run_mako("foundationdb_tpu_torch", port_knobs(
        "cuda", CONFLICT_DICT_SLOTS=dict_slots), plan, device=CPU)
    check_outcomes(*port[:2])
    assert port[0] == ref[0], "per-transaction outcomes differ"
    assert port[1] == ref[1], "final keyspace differs"
    # the dictionary branch ran on every group, or never
    assert (port[2] > 0) == bool(dict_slots) and port[3] == 0


@pytest.mark.cuda
def test_mako_on_the_card_matches_the_cpu():
    """The same seeded workload through the port on the card and on the
    CPU: equal outcomes and keyspace, dictionary off and on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from foundationdb_tpu_torch.bench.workload import ZipfianGenerator
    plan = mako_plan(ZipfianGenerator)
    for slots in (0, DICT_SLOTS):
        knobs = port_knobs("cuda", CONFLICT_DICT_SLOTS=slots)
        cpu = run_mako("foundationdb_tpu_torch", knobs, plan, device=CPU)
        card = run_mako("foundationdb_tpu_torch", knobs, plan,
                        device=torch.device("cuda"))
        check_outcomes(*card[:2])
        assert (card[2] > 0) == bool(slots) and card[3] == 0
        assert card == cpu, f"card and CPU differ, dictionary {slots}"


# --------------------------------------------------------------------------
# (c) same-seed traces in fresh processes

_SEED = 4321


def _child(path: str) -> None:
    sys.path.insert(0, _REPO)
    P = package("foundationdb_tpu_torch")
    log = P.trace.TraceLog(path=path, min_severity=P.trace.Severity.DEBUG)
    P.trace.set_trace_log(log)
    knobs = port_knobs("cuda", CLIENT_LATENCY_PROBE_SAMPLE=1.0,
                       RESOLVER_DEVICE_PIPELINE=True, METRICS_EMITTER=True,
                       METRICS_INTERVAL=1.0)
    plan = mako_plan(P.Zipf)[:4]

    async def main():
        async with P.Cluster(multi_config(P), knobs, device=CPU) as cluster:
            out = await mako_body(P, plan)(P.Database(cluster))
            # the async halves (storage apply, verdict readback) drain
            await asyncio.sleep(1.5)
            return out
    P.run_simulation(main(), seed=_SEED)
    log.close()
    with open(path, "rb") as f:
        data = f.read()
    print(hashlib.sha256(data).hexdigest(), data.count(b"\n"),
          data.count(b"ResolverDevice."), data.count(b"Metrics\","))


def _run_child(tmp_path, tag: str) -> tuple[str, int, int, int]:
    path = os.path.join(str(tmp_path), f"trace-{tag}.jsonl")
    p = subprocess.run([sys.executable, _THIS, "--child", path], cwd=_REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, f"child {tag} failed: {p.stderr[-2000:]}"
    d, n, pipe, metrics = p.stdout.strip().splitlines()[-1].split()
    return d, int(n), int(pipe), int(metrics)


def test_same_seed_port_cluster_trace_bit_identical(tmp_path):
    a = _run_child(tmp_path, "a")
    b = _run_child(tmp_path, "b")
    assert a[1] > 100, f"trace suspiciously small ({a[1]} events)"
    assert a[2] > 0, "no ResolverDevice events: the device pipeline did not run"
    assert a[3] > 0, "no *Metrics events: the metrics emitter did not run"
    assert a == b, f"same-seed traces differ: {a} vs {b}"


# --------------------------------------------------------------------------
# (d) boundaries, the default device, the wire registry


def test_cluster_default_device_is_the_card(monkeypatch):
    from foundationdb_tpu_torch.core.cluster import Cluster
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert Knobs().RESOLVER_CONFLICT_BACKEND == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Cluster(knobs=Knobs())
    assert Cluster(knobs=port_knobs("cuda"), device=CPU) \
        .resolvers[0].backend.cs.device == CPU


def test_durable_storage_is_refused(monkeypatch):
    """What the port refuses around durable storage now: an unknown
    engine name.  Every engine is served, an engine-backed server arms
    the read mirror on the device it is given exactly when the knob is
    on, and without a device and without a card it raises instead of
    serving from the host."""
    from foundationdb_tpu_torch.core.data import KeyRange
    from foundationdb_tpu_torch.core.storage_server import StorageServer
    from foundationdb_tpu_torch.core.tlog import TLog
    from foundationdb_tpu_torch.storage import engine_class
    from foundationdb_tpu_torch.storage.btree import BTreeKVStore
    from foundationdb_tpu_torch.storage.kv_store import OP_SET, MemoryKVStore
    from foundationdb_tpu_torch.storage.lsm import LSMKVStore
    assert [engine_class(n) for n in ("memory", "lsm", "btree")] == \
        [MemoryKVStore, LSMKVStore, BTreeKVStore]
    with pytest.raises(ValueError):
        engine_class("rocksdb")
    knobs = port_knobs("cpp")
    assert knobs.STORAGE_DEVICE_READ_SERVE
    engine = MemoryKVStore(None, "t")
    engine._apply([(OP_SET, b"k%04d" % i, b"v") for i in range(100)])
    everything = KeyRange.everything()
    ss = StorageServer(knobs, 0, everything, TLog(knobs), engine=engine,
                       device=CPU)
    assert ss._device_reads is not None and ss._device_reads.active
    assert ss._device_reads._dir._device == CPU
    off = knobs.override(STORAGE_DEVICE_READ_SERVE=False)
    ss = StorageServer(off, 0, everything, TLog(off), engine=engine,
                       device=CPU)
    assert ss._device_reads is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StorageServer(knobs, 0, everything, TLog(knobs), engine=engine)


def test_wire_registry_and_bytes_match_reference():
    from foundationdb_tpu.core import data as rd
    from foundationdb_tpu.rpc import wire as rw
    from foundationdb_tpu_torch.core import data as pd
    from foundationdb_tpu_torch.rpc import wire as pw
    names = {c.__name__: i for c, i in rw._STRUCT_IDS.items()}
    assert names == {c.__name__: i for c, i in pw._STRUCT_IDS.items()}
    assert len(names) == 22
    assert all(c.__module__.startswith("foundationdb_tpu_torch.")
               for c in pw._STRUCT_IDS)
    blobs = []
    for d, w in ((rd, rw), (pd, pw)):
        g = np.random.default_rng(3)
        muts = []
        for _ in range(50):
            k = bytes(g.integers(0, 256, size=int(g.integers(1, 40)),
                                 dtype=np.uint8))
            v = bytes(g.integers(0, 256, size=int(g.integers(0, 60)),
                                 dtype=np.uint8))
            t = int(g.integers(0, 3))
            mt = (d.MutationType.SET_VALUE, d.MutationType.CLEAR_RANGE,
                  d.MutationType.ADD)[t]
            muts.append(d.Mutation(mt, k, k + b"\x00" if t == 1 else v))
        batch = d.as_mutation_batch(muts)
        blobs.append(w.encode(batch))
        assert list(w.decode(blobs[-1])) == list(batch)
    assert blobs[0] == blobs[1] and len(blobs[0]) > 1000
    req = pd.CommitTransactionRequest
    assert pw._STRUCT_IDS[req] == rw._STRUCT_IDS[rd.CommitTransactionRequest]


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        _child(sys.argv[2])
    else:
        raise SystemExit("usage: test_torch_cluster.py --child <path>")
