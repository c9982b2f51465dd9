"""The port's multi-process cluster against the JAX package's.

Coordinators, workers and a cluster controller over each package's own
simulated network, under each package's own SimEventLoop and one seed
(the scenarios of tests/test_recovery.py, tests/test_scrubber.py and
tests/test_data_distribution.py).  The port's resolvers run the ``cuda``
backend on ``torch.device("cpu")``, so the kernels' plain versions
answer; the reference runs its ``numpy`` backend.  Compared: epochs,
the committed keyspace, what each read returned, and the status
document's deterministic fields.  Under the ``cpp`` backend on both
sides, a fresh process of each package writes the same trace.

The child half runs as ``python tests/test_torch_recovery.py --child
<package> <trace-path> <kills>``: one seeded recovery of that package
that prints the sha256 of its trace.  The port's child runs its client
refresh gathered, as ``torch_parity.gathered`` does: a refresh that
returns on a majority of coordinators (ROADMAP C3) moves the
simulator's schedule.
"""

from __future__ import annotations

import ast
import asyncio
import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

_THIS = os.path.abspath(__file__)
_REPO = os.path.dirname(os.path.dirname(_THIS))
sys.path.insert(0, os.path.dirname(_THIS))

from torch_parity import (HostCluster, SimCluster, buggify_off,  # noqa: E402,F401
                          commit_kv, package, read_kv)

REF, PORT = "foundationdb_tpu", "foundationdb_tpu_torch"
# sim-scale resolver shapes (the reference's simulated cluster's): 16
# txns a batch, 4 ranges, a ring of 1<<12 slots
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


def knobs(P, backend: str | None = None, **over):
    """The port on ``cuda`` (its plain versions on the CPU), the
    reference on ``numpy``, unless ``backend`` names one for both."""
    backend = backend or ("cuda" if P.name == PORT else "numpy")
    return P.Knobs().override(RESOLVER_CONFLICT_BACKEND=backend,
                              **dict(SHAPE, **over))


def both(scenario, seed: int = 0, **kw):
    """``scenario(P, knobs)`` under each package's simulator: (ref, port)."""
    out = []
    for name in (REF, PORT):
        P = package(name)
        out.append(P.run_simulation(scenario(P, knobs(P, **kw)), seed=seed))
    return out


# --------------------------------------------------------------------------
# recruitment and recovery


async def recovered_serves(P, k):
    sim = SimCluster(P, k, **P.device_kw)
    cc = sim.make_cc()
    _, prev = await cc.cstate.read()
    state = await cc.recover_once(prev)
    view = await sim.client_view()
    items = {b"k%02d" % i: b"v%02d" % i for i in range(20)}
    version = await commit_kv(P, view, items)
    got = await read_kv(P, view, items)
    await cc.stop()
    return (state["epoch"], sorted(state), version, got,
            state["ratekeeper"]["token"] > sim.base)


def test_recovered_cluster_serves_transactions():
    ref, port = both(recovered_serves)
    assert port[0] == 1 and port[4]
    assert port[3] == {b"k%02d" % i: b"v%02d" % i for i in range(20)}
    assert port == ref


async def kill_role(P, sim, state, role: str) -> int:
    """Kill the machine hosting ``role`` (the resolver, or the second
    TLog: the first shares its worker with a storage replica); returns
    the victim's worker index."""
    if role == "resolver":
        victim = P.transport.NetworkAddress(*state["resolvers"][0]["addr"])
    else:
        victim = P.transport.NetworkAddress(*state["log_cfg"][-1]["tlogs"][1])
    storage_workers = {tuple(s["worker"]) for s in state["storage"]}
    assert (victim.ip, victim.port) not in storage_workers
    sim.net.kill(victim)
    return sim.worker_addrs.index(victim)


def role_kills(roles):
    async def scenario(P, k):
        sim = SimCluster(P, k, **P.device_kw)
        cc = sim.make_cc()
        cc_task = asyncio.get_running_loop().create_task(cc.run())
        stubs = sim.coordinator_stubs()
        state = await sim.wait_epoch(1, stubs)
        view = await sim.client_view()
        items = {b"pre%02d" % i: b"val%02d" % i for i in range(10)}
        await commit_kv(P, view, items)
        out = []
        for n, role in enumerate(roles, start=2):
            victim = await kill_role(P, sim, state, role)
            state = await sim.wait_epoch(n, stubs)
            view = await sim.client_view()
            survived = await read_kv(P, view, items) == items
            more = {b"post%d-%02d" % (n, i): b"v%d" % i for i in range(10)}
            await commit_kv(P, view, more)
            items.update(more)
            out.append((victim, state["epoch"], survived))
        final = await read_kv(P, view, items)
        # resolver role objects still hosted by a live worker
        hosted = sum(1 for w in sim.workers
                     if not sim.net.is_dead(w.transport.address)
                     for role, _ in w.roles.values() if role == "resolver")
        cc_task.cancel()
        await asyncio.gather(cc_task, return_exceptions=True)
        await cc.stop()
        return out, final == items, sorted(final), hosted
    return scenario


@pytest.mark.parametrize("roles", [("resolver",), ("tlog",)],
                         ids=["resolver", "tlog"])
def test_role_kill_triggers_rerecovery(roles):
    """A killed txn role's machine: the controller recovers the next
    epoch, the data committed before the kill reads back and the new
    epoch commits, in both packages alike."""
    ref, port = both(role_kills(roles))
    assert port[0][0][1] >= 2 and port[0][0][2] and port[1]
    assert port[:3] == ref[:3]


def test_two_kills_retire_the_ended_resolvers():
    """The resolver's machine, then the second TLog's: epoch 3, every
    acknowledged write read back, and the same outcome as the reference.
    Only the port stops an ended generation's resolvers on the live
    workers that host them (each holds its conflict history on the
    device), so after two recoveries the live workers host exactly the
    current epoch's one resolver; the reference still hosts the second
    epoch's as well."""
    ref, port = both(role_kills(("resolver", "tlog")))
    assert [e for _, e, _ in port[0]] == [2, 3]
    assert all(ok for _, _, ok in port[0]) and port[1]
    assert port[:3] == ref[:3]
    assert port[3] == 1 and ref[3] == 2


async def refuses_on_data_loss(P, k):
    sim = SimCluster(P, k, **P.device_kw)
    cc = sim.make_cc(P.cluster_controller.ClusterConfigSpec(
        log_replication=1))
    _, prev = await cc.cstate.read()
    state = await cc.recover_once(prev)
    view = await sim.client_view()
    await commit_kv(P, view, {b"a": b"1", b"b": b"2"})
    sim.net.kill(P.transport.NetworkAddress(
        *state["log_cfg"][-1]["tlogs"][0]))
    await asyncio.sleep(k.FAILURE_TIMEOUT * 3)
    _, prev2 = await cc.cstate.read()
    try:
        await cc.recover_once(prev2)
        raised = None
    except P.errors.LogDataLoss as e:
        raised = e.code
    await cc.stop()
    return raised


def test_recovery_refuses_on_data_loss():
    ref, port = both(refuses_on_data_loss)
    assert port is not None and port == ref


async def excluded_worker(P, k):
    from importlib import import_module
    exclude_servers = import_module(f"{P.name}.core.management") \
        .exclude_servers
    sim = SimCluster(P, k, **P.device_kw)
    cc = sim.make_cc()
    _, prev = await cc.cstate.read()
    state = await cc.recover_once(prev)
    view = await sim.client_view()
    await commit_kv(P, view, {b"x": b"1"})
    victim = sim.worker_addrs[3]
    assert [victim.ip, victim.port] == state["resolvers"][0]["addr"]

    class _Db:
        async def run(self, fn):
            tr = P.Transaction(view)
            while True:
                try:
                    await fn(tr)
                    await tr.commit()
                    return
                except P.errors.FdbError as e:
                    await tr.on_error(e)
    await exclude_servers(_Db(), [f"{victim.ip}:{victim.port}"])
    await asyncio.sleep(1.0)
    _, prev2 = await cc.cstate.read()
    state2 = await cc.recover_once(prev2)
    placed = {tuple(state2["sequencer"]["addr"])}
    placed |= {tuple(a) for a in state2["log_cfg"][-1]["tlogs"]}
    placed |= {tuple(r["addr"]) for r in state2["resolvers"]}
    placed |= {tuple(p["addr"]) for p in
               state2["commit_proxies"] + state2["grv_proxies"]}
    placed.add(tuple(state2["ratekeeper"]["addr"]))
    view2 = await sim.client_view()
    got = await read_kv(P, view2, [b"x"])
    await cc.stop()
    return (victim.ip, victim.port) in placed, sorted(placed), got


def test_excluded_worker_gets_no_txn_roles():
    ref, port = both(excluded_worker)
    assert port[0] is False and port[2] == {b"x": b"1"}
    assert port == ref


async def durable_read_back(P, k):
    """Workers with simulated disks: storage runs the memory engine.
    1500 keys loaded (more than the 1024 a memory engine holds pending
    before its index takes a base run), then read back in get_multi
    batches of 512 once they have left the MVCC window."""
    from importlib import import_module
    SimFileSystem = import_module(f"{P.name}.runtime.files").SimFileSystem
    sim = SimCluster(P, k, fs_factory=SimFileSystem, **P.device_kw)
    cc = sim.make_cc()
    _, prev = await cc.cstate.read()
    await cc.recover_once(prev)
    view = await sim.client_view()
    keys = [b"dk%05d" % i for i in range(1500)]
    for c in range(0, len(keys), 250):
        await commit_kv(P, view, {key: key[::-1] for key in keys[c:c + 250]})
    await asyncio.sleep(2.0)
    got = []
    for c in range(0, len(keys), 512):
        got += await P.Transaction(view).get_multi(keys[c:c + 512])
    storage = [o for w in sim.workers for r, o in w.roles.values()
               if r == "storage"]
    mirrors = [s._device_reads.metrics()["device_read_batches"]
               if s._device_reads is not None else None for s in storage]
    await cc.stop()
    return got == [key[::-1] for key in keys], got, mirrors


def test_recruited_storage_arms_the_read_mirror():
    """A storage server recruited onto a worker with a disk gets its
    engine after construction.  The port arms the read mirror then, so
    the read-back is served by it; the reference never arms it on this
    path.  The bytes read back are the same."""
    ref, port = both(durable_read_back, STORAGE_ENGINE="memory",
                     STORAGE_VERSION_WINDOW=100_000,
                     STORAGE_DURABILITY_LAG=0.05)
    assert port[0] and port[1] == ref[1]
    assert ref[2] == [None, None]
    assert all(m is not None for m in port[2]) and sum(port[2]) > 0


# --------------------------------------------------------------------------
# the status document


def deterministic(doc: dict) -> dict:
    """The status document's fields that do not depend on the conflict
    backend or on timing: the cluster's epoch, recovery version,
    availability and degraded roles, each role's identity and
    reachability, the shard layout, and the mutations applied."""
    c = doc["cluster"]
    return {
        "cluster": {k: c[k] for k in ("epoch", "recovery_version",
                                      "database_available",
                                      "degraded_roles")},
        "applied": c["storage_apply"]["mutations_applied"],
        "roles": [{k: v for k, v in r.items()
                   if k in ("role", "addr", "token", "tag", "index",
                            "reachable")} for r in doc["roles"]],
        "shards": doc["shards"],
    }


async def status_health(P, k):
    from importlib import import_module
    cluster_status = import_module(f"{P.name}.core.status").cluster_status
    sim = SimCluster(P, k, **P.device_kw)
    cc = sim.make_cc()
    _, prev = await cc.cstate.read()
    state = await cc.recover_once(prev)
    db = await sim.database()

    async def write(tr):
        tr.set(b"s1", b"x")
    await db.run(write)
    # through the special-key space, as a client reads it
    tr = db.create_transaction()
    doc = json.loads(await tr.get(b"\xff\xff/status/json"))
    ct = sim.client_transport()
    stubs = sim.coordinator_stubs(ct)
    sim.net.kill(P.transport.NetworkAddress(*state["resolvers"][0]["addr"]))
    doc2 = await cluster_status(k, ct, stubs)
    await cc.stop()
    return doc, doc2


def test_status_json_matches_reference():
    """``\\xff\\xff/status/json`` on a coordinator-backed database: every
    recruited role reachable with its metrics; after the resolver's
    machine dies the database is unavailable and the resolver degraded.
    The deterministic fields equal the reference's, and so do the
    resolver device rollup's counts."""
    (ref, ref2), (port, port2) = both(status_health)
    assert port["cluster"]["epoch"] == 1
    assert port["cluster"]["database_available"] is True
    roles = {r["role"] for r in port["roles"]}
    assert roles == {"sequencer", "log", "resolver", "storage",
                     "commit_proxy", "grv_proxy", "ratekeeper"}
    assert all(r["reachable"] for r in port["roles"])
    assert port2["cluster"]["database_available"] is False
    assert any(d["role"] == "resolver"
               for d in port2["cluster"]["degraded_roles"])
    assert deterministic(port) == deterministic(ref)
    assert deterministic(port2) == deterministic(ref2)
    dev = port["cluster"]["resolver_device"]
    assert dev["pipelined_resolvers"] == 1 and dev["dispatches"] > 0
    counts = ("pipelined_resolvers", "enqueued", "dispatches")
    assert {c: dev[c] for c in counts} == \
        {c: ref["cluster"]["resolver_device"][c] for c in counts}


def test_status_reads_the_device_pipeline_names():
    """Every ``device_*`` metric that core/status.py's rollups read is a
    name the port publishes: the resolver's (its DevicePipeline's) for
    the resolver rollup, the read mirror's for the storage one.  A name
    the port lacks would make its rollup silently zero."""
    from foundationdb_tpu_torch.core import status
    from foundationdb_tpu_torch.core.resolver import Resolver
    from foundationdb_tpu_torch.device.read_serve import DeviceReadServer
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.storage.kv_store import OP_SET, MemoryKVStore
    tree = ast.parse(open(status.__file__).read())
    read = {n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "get" and n.args
            and isinstance(n.args[0], ast.Constant)
            and str(n.args[0].value).startswith("device_")}
    mirror = {x for x in read if x.startswith("device_read_")}
    pipeline = read - mirror
    assert {"device_pipeline", "device_dispatches", "device_queue_depth",
            "device_queue_peak", "device_inflight"} <= pipeline

    async def resolver_metrics():
        res = Resolver(Knobs().override(RESOLVER_CONFLICT_BACKEND="cuda",
                                        **SHAPE), device=torch.device("cpu"))
        try:
            return await res.metrics()
        finally:
            await res.close()
    missing = sorted(pipeline - set(asyncio.run(resolver_metrics())))
    assert not missing, f"status reads names the resolver lacks: {missing}"

    kv = MemoryKVStore(None, "t")
    kv._apply([(OP_SET, b"k%05d" % i, b"v") for i in range(10)])
    kv.packed_index._merge()
    srv = DeviceReadServer(kv, Knobs().override(STORAGE_DEVICE_READ_SHARDS=2),
                           device=torch.device("cpu"))
    missing = sorted(mirror - set(srv.metrics()))
    assert not missing, f"status reads names the mirror lacks: {missing}"


# --------------------------------------------------------------------------
# data distribution and the scrubber


def test_split_and_move_layout_helpers():
    from foundationdb_tpu.core import data_distribution as ref
    from foundationdb_tpu_torch.core import data_distribution as port
    for dd in (ref, port):
        layout = {"boundaries": [b"\x80"], "teams": [[0], [1]]}
        l2, nxt = dd.split_layout(layout, 0, b"\x40", 2)
        assert l2 == {"boundaries": [b"\x40", b"\x80"],
                      "teams": [[0], [2], [1]]}
        assert nxt == 3
        l3, nxt = dd.move_layout(l2, 1, nxt)
        assert l3["teams"] == [[0], [3], [1]] and nxt == 4


SCRUB_KNOBS = dict(DD_ENABLED=True, STORAGE_DURABILITY_LAG=0.1,
                   SCRUB_ENABLED=True, SCRUB_PASS_INTERVAL=0.5,
                   SCRUB_WATCHDOG_INTERVAL=0.5, SCRUB_PAGES_PER_SEC=500.0,
                   SCRUB_PAGE_ROWS=8, SCRUB_MAX_PAGES_PER_REQUEST=4)


async def _wait_for(pred, what: str, ceiling_s: float = 180.0):
    for _ in range(int(ceiling_s / 0.25)):
        if pred():
            return
        await asyncio.sleep(0.25)
    raise AssertionError(f"{what} did not happen within {ceiling_s} "
                         "virtual seconds")


def scrub_catch(events: list):
    async def scenario(P, k):
        sim = HostCluster(P, k)
        await sim.start()
        await asyncio.wait_for(sim.wait_epoch(1), 120)
        db = await sim.database()
        keys = [b"row%04d" % i for i in range(40)]
        for key in keys:
            async def body(tr, key=key):
                tr.set(key, b"honest-" + key)
            await db.run(body)
        await _wait_for(lambda: sim.leader_scrubber() is not None,
                        "scrubber recruitment")
        scr = sim.leader_scrubber()
        await _wait_for(lambda: scr.passes_complete >= 1, "the first pass")
        clean = scr.mismatch_rows
        victim = flipped = phantom = None
        for ss in sim.storage_objects():
            for key in keys:
                ghost = key + b"\x00zz"
                if ss.shard.begin <= key < ss.shard.end \
                        and ss.shard.begin <= ghost < ss.shard.end:
                    victim, flipped, phantom = ss, key, ghost
                    break
            if victim is not None:
                break
        victim.corrupt_for_test(flipped, b"BITROT")
        victim.corrupt_for_test(phantom, b"GHOST")
        await _wait_for(lambda: scr.mismatch_rows >= 2, "the detection")
        out = (clean, scr.mismatch_rows, scr.invariant_violations,
               flipped, phantom)
        await sim.stop()
        hits = sorted((e["Key"], e["Severity"],
                       len(str(e["Replicas"]).split(",")),
                       "<missing>" in str(e.get("Values")))
                      for e in events if e.get("Type") == "ScrubMismatch")
        events.clear()
        return out + (hits,)
    return scenario


def test_scrubber_catches_injected_corruption():
    """A flipped value and a phantom row on one replica of a doubly
    replicated team: both caught key-exactly after a clean first pass,
    as in the reference."""
    events: list = []
    out = []
    for name in (REF, PORT):
        P = package(name)
        prev = P.trace.get_trace_log()
        sink = P.trace.TraceLog(min_severity=P.trace.Severity.INFO)
        sink.sink = events.append
        P.trace.set_trace_log(sink)
        try:
            out.append(P.run_simulation(
                scrub_catch(events)(P, knobs(P, **SCRUB_KNOBS)), seed=1701))
        finally:
            P.trace.set_trace_log(prev)
    ref, port = out
    clean, rows, violations, flipped, phantom, hits = port
    assert clean == 0 and rows >= 2 and violations == 0
    assert {h[0] for h in hits} == {flipped.hex(), phantom.hex()}
    assert all(h[1] == 40 and h[2] == 2 for h in hits)
    assert [h[3] for h in hits if h[0] == phantom.hex()] == [True]
    assert port == ref


# --------------------------------------------------------------------------
# same-seed traces of both packages in fresh processes

_SEED = 2718


def _child(name: str, path: str, kills: int) -> None:
    sys.path.insert(0, _REPO)
    P = package(name)
    if name == PORT:
        from foundationdb_tpu_torch.core import coordination
        coordination.MAJORITY_ROUNDS = False
    log = P.trace.TraceLog(path=path, min_severity=P.trace.Severity.DEBUG)
    P.trace.set_trace_log(log)

    async def main():
        k = knobs(P, "cpp", METRICS_INTERVAL=1.0)
        sim = SimCluster(P, k, **P.device_kw)
        cc = sim.make_cc()
        cc_task = asyncio.get_running_loop().create_task(cc.run())
        state = await sim.wait_epoch(1)
        db = await sim.database()

        async def rmw(n):
            for i in range(n):
                async def body(tr, i=i):
                    v = await tr.get(b"c%d" % (i % 3))
                    tr.set(b"c%d" % (i % 3), (v or b"") + b"+")
                    tr.set(b"row%02d" % i, b"v%d" % i)
                await db.run(body)
        await rmw(8)
        for n, role in enumerate(("resolver", "tlog")[:kills], start=2):
            await kill_role(P, sim, state, role)
            state = await sim.wait_epoch(n)
            await rmw(4)
        await asyncio.sleep(3.0)
        tr = db.create_transaction()
        doc = json.loads(await tr.get(b"\xff\xff/status/json"))
        cc_task.cancel()
        await asyncio.gather(cc_task, return_exceptions=True)
        await cc.stop()
        return doc["cluster"]["epoch"]
    epoch = P.run_simulation(main(), seed=_SEED)
    log.close()
    with open(path, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    # through the last recovery's RecoveryComplete
    last = max(i for i, ln in enumerate(lines)
               if b'"Type":"RecoveryComplete"' in ln)
    data = b"".join(lines)
    print(hashlib.sha256(data).hexdigest(), len(lines), epoch,
          hashlib.sha256(b"".join(lines[:last + 1])).hexdigest(), last)


def _run_child(tmp_path, name: str, kills: int) -> tuple:
    path = os.path.join(str(tmp_path), f"trace-{name}-{kills}.jsonl")
    p = subprocess.run([sys.executable, _THIS, "--child", name, path,
                        str(kills)],
                       cwd=_REPO, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, f"child {name} failed: {p.stderr[-2000:]}"
    full, n, epoch, upto, last = p.stdout.strip().splitlines()[-1].split()
    return full, int(n), int(epoch), upto, int(last), path


def test_same_seed_trace_equals_reference_under_cpp(tmp_path):
    """A recovery, eight read-modify-write transactions and a status
    read under the ``cpp`` backend: the port's trace is byte for byte
    the reference's, each in a fresh process."""
    ref = _run_child(tmp_path, REF, 0)
    port = _run_child(tmp_path, PORT, 0)
    assert port[1] > 50, f"trace suspiciously small ({port[1]} events)"
    assert port[2] == 1
    assert port[:5] == ref[:5], f"traces differ: {ref[:5]} vs {port[:5]}"


def test_same_seed_trace_through_a_recovery_under_cpp(tmp_path):
    """The same with the resolver's machine killed after the eighth
    transaction and the second TLog's after four more: through the third
    epoch's RecoveryComplete the port's trace is byte for byte the
    reference's.  Then the port stops the second epoch's resolver on its
    live worker (the reference leaves it running), so the traces part
    after that event.  (The first epoch's resolver died with its
    machine: the second recovery retires nothing.)"""
    ref = _run_child(tmp_path, REF, 2)
    port = _run_child(tmp_path, PORT, 2)
    assert port[2] == ref[2] == 3
    assert port[3:5] == ref[3:5], "traces differ before the recovery ended"
    with open(ref[5], "rb") as a, open(port[5], "rb") as b:
        ra, pb = a.read().splitlines(), b.read().splitlines()
    first = next((i for i, (x, y) in enumerate(zip(ra, pb)) if x != y),
                 min(len(ra), len(pb)))
    assert first > port[4]


# --------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_role_kills_on_the_card_match_the_cpu():
    """The resolver's then the TLog's machine killed, the port's
    resolvers on the card against the port on the CPU: equal outcomes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    P = package(PORT)
    cpu = P.run_simulation(role_kills(("resolver", "tlog"))(P, knobs(P)))
    P.device_kw = {"device": torch.device("cuda")}
    card = P.run_simulation(role_kills(("resolver", "tlog"))(P, knobs(P)))
    assert card == cpu and card[3] == 1


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(sys.argv[2], sys.argv[3], int(sys.argv[4]))
