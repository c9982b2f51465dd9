"""The port's coordination and failure monitor against the JAX package's.

The scenarios of tests/test_coordination.py and
tests/test_failure_monitor.py (the generation register, quorum reads and
writes, leader election with lease failover, the failure monitor over
the simulated network) and the leader-kill failover of
tests/test_recovery.py, each run under one seed on both packages; what
each scenario observed (winners, values, virtual detection times,
epochs) must be equal.
"""

from __future__ import annotations

import asyncio
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (HostCluster, buggify_off,  # noqa: E402,F401
                          commit_kv, package, read_kv)

REF, PORT = "foundationdb_tpu", "foundationdb_tpu_torch"


def both(scenario, seed: int = 0):
    """``scenario(P)`` under each package's simulator: (ref, port)."""
    return [package(n).run_simulation(scenario(package(n)), seed=seed)
            for n in (REF, PORT)]


def sim_coordinators(P, k, n: int = 3):
    """n coordinators on their own simulated machines and a client's
    stubs to them: (network, addresses, stubs)."""
    net = P.sim_transport.SimNetwork(k)
    NA, base = P.transport.NetworkAddress, P.transport.WLTOKEN_FIRST_AVAILABLE
    addrs = [NA("10.0.0.%d" % (i + 1), 4000) for i in range(n)]
    for a in addrs:
        P.stubs.serve_role(P.sim_transport.SimTransport(net, a),
                           "coordinator", P.coordination.Coordinator(k), base)
    ct = P.sim_transport.SimTransport(net, NA("10.0.1.1", 5000))
    return net, addrs, [P.stubs.CoordinatorClient(ct, a, base)
                        for a in addrs]


# --------------------------------------------------------------------------
# the register and the quorum


async def stale_writer(P):
    C = P.coordination
    co = C.Coordinator(P.Knobs())
    out = []
    await co.read((5, 1))
    for gen, val in (((4, 9), b"old"), ((6, 1), b"new"), ((6, 1), b"again")):
        try:
            await co.write(gen, val)
            out.append("ok")
        except C.NotLatestGeneration as e:
            out.append(e.code)
    _, wgen, val = await co.read((7, 2))
    return out, wgen, val


async def contention(P):
    C = P.coordination
    k = P.Knobs()
    coords = [C.Coordinator(k) for _ in range(3)]
    a = C.CoordinatedState(coords, my_id=1)
    b = C.CoordinatedState(coords, my_id=2)
    await a.read()
    await b.read()
    try:
        await a.write(b"from-a")
        lost = False
    except C.NotLatestGeneration:
        lost = True
    await b.write(b"from-b")
    _, seen = await a.read()
    new = await a.read_modify_write(lambda old: old + b"+a")
    return lost, seen, new


async def minority_loss(P):
    C = P.coordination
    net, addrs, stubs = sim_coordinators(P, P.Knobs())
    cs = C.CoordinatedState(stubs, my_id=7)
    out = [await cs.read_modify_write(lambda _: b"state1")]
    net.kill(addrs[0])
    out.append(await cs.read_modify_write(lambda old: old + b"+2"))
    net.kill(addrs[1])
    try:
        await cs.read()
    except C.CoordinatorsUnreachable as e:
        out.append(e.code)
    return out, asyncio.get_running_loop().time()


async def durable_register(P):
    from importlib import import_module
    C = P.coordination
    fs = import_module(f"{P.name}.runtime.files").SimFileSystem()
    k = P.Knobs()
    co = await C.Coordinator.open(k, fs, "coord-0")
    await co.read((3, 1))
    await co.write((4, 1), b"persisted")
    co2 = await C.Coordinator.open(k, fs, "coord-0")
    try:
        await co2.write((2, 9), b"stale")
        refused = False
    except C.NotLatestGeneration:
        refused = True
    return co2.write_gen, co2.value, refused


REGISTER = {"stale_writer": (stale_writer, 0),
            "contention": (contention, 0),
            "minority_loss": (minority_loss, 4),
            "durable_register": (durable_register, 0)}


@pytest.mark.parametrize("name", list(REGISTER))
def test_register_and_quorum_match_reference(name):
    scenario, seed = REGISTER[name]
    ref, port = both(scenario, seed)
    assert port == ref
    if name == "stale_writer":
        assert port[0][1] == "ok" and port[2] == b"new"
    if name == "minority_loss":
        assert port[0][:2] == [b"state1", b"state1+2"] and len(port[0]) == 3


# --------------------------------------------------------------------------
# leader election


async def single_winner_and_failover(P):
    C = P.coordination
    k = P.Knobs().override(LEADER_LEASE_DURATION=2.0)
    coords = [C.Coordinator(k) for _ in range(3)]
    l1 = await C.elect_leader(coords, 11, "addr-11", k)
    l2 = await C.elect_leader(coords, 22, "addr-22", k)
    beats = []
    for _ in range(3):
        await asyncio.sleep(0.5)
        beats.append(all([await c.leader_heartbeat(11) for c in coords]))
    await asyncio.sleep(k.LEADER_LEASE_DURATION + 0.1)
    l3 = await C.elect_leader(coords, 22, "addr-22", k)
    return l1, l2, beats, l3, await coords[0].leader_heartbeat(11)


async def split_grant(P):
    C = P.coordination
    k = P.Knobs().override(LEADER_LEASE_DURATION=5.0)
    coords = [C.Coordinator(k) for _ in range(3)]
    won = await C.elect_leader(coords, 11, "addr-11", k)
    coords[0] = C.Coordinator(k)          # reboot: empty register
    seen = await C.elect_leader(coords, 22, "addr-22", k)
    return won, seen, coords[0]._leader is None


async def nomination_storm(P):
    C = P.coordination
    k = P.Knobs().override(LEADER_LEASE_DURATION=2.0)
    coords = [C.Coordinator(k) for _ in range(5)]
    won = await C.elect_leader(coords, 7, "addr-7", k)
    deposed = False

    async def heartbeat():
        nonlocal deposed
        for _ in range(20):
            await asyncio.sleep(k.LEADER_HEARTBEAT_INTERVAL)
            if sum([await c.leader_heartbeat(7) for c in coords]) < 3:
                deposed = True

    async def rival(cid):
        return [await C.elect_leader(coords, cid, f"addr-{cid}", k)
                for _ in range(5)]

    hb = asyncio.get_running_loop().create_task(heartbeat())
    storms = await asyncio.gather(*(rival(100 + i) for i in range(10)))
    hb.cancel()
    return won, deposed, storms


async def dead_nominee(P):
    C = P.coordination
    k = P.Knobs()
    coords = [C.Coordinator(k) for _ in range(3)]
    for c in coords:
        await c.nominate(1, "addr-dead")
    return await C.elect_leader(coords, 50, "addr-50", k), \
        asyncio.get_running_loop().time()


async def three_candidates(P):
    C = P.coordination
    k = P.Knobs()
    coords = [C.Coordinator(k) for _ in range(5)]
    return await asyncio.gather(*(C.elect_leader(coords, i, f"a{i}", k)
                                  for i in (1, 2, 3)))


def churn(seed):
    """Concurrent candidates against coordinators whose every call is
    delayed by a seeded random time, some past the RPC timeout."""
    async def scenario(P):
        from importlib import import_module
        C = P.coordination
        rng = import_module(f"{P.name}.runtime.rng").DeterministicRandom(seed)

        class Flaky:
            def __init__(self, co):
                self._co = co

            def __getattr__(self, name):
                m = getattr(self._co, name)

                async def call(*a):
                    await asyncio.sleep(rng.random() * 0.8)
                    return await m(*a)
                return call

        k = P.Knobs().override(LEADER_LEASE_DURATION=10.0)
        coords = [C.Coordinator(k) for _ in range(5)]
        winners = await asyncio.gather(
            *(C.elect_leader([Flaky(c) for c in coords], 1 + i,
                             f"a{1 + i}", k) for i in range(4)),
            return_exceptions=True)
        tally: dict = {}
        for c in coords:
            if c._leader is not None:
                lid = c._leader.leader_id
                tally[lid] = tally.get(lid, 0) + 1
        return ([w if not isinstance(w, BaseException) else type(w).__name__
                 for w in winners], sorted(tally.items()))
    return scenario


ELECTION = {"single_winner_and_failover": single_winner_and_failover,
            "split_grant": split_grant, "nomination_storm": nomination_storm,
            "dead_nominee": dead_nominee, "deterministic": three_candidates}


@pytest.mark.parametrize("name", list(ELECTION))
def test_election_matches_reference(name):
    ref, port = both(ELECTION[name], seed=8)
    assert port == ref
    if name == "single_winner_and_failover":
        assert port[0] == port[1] == (11, "addr-11") and all(port[2])
        assert port[3] == (22, "addr-22") and not port[4]
    if name == "split_grant":
        assert port == ((11, "addr-11"), (11, "addr-11"), True)
    if name == "nomination_storm":
        assert not port[1] and all(r == (7, "addr-7")
                                   for rs in port[2] for r in rs)
    if name == "deterministic":
        assert len(set(port)) == 1


@pytest.mark.parametrize("seed", range(10))
def test_election_churn_converges(seed):
    """One winner under churn, holding a majority of leases, on every
    seed, and the same winner and leases as the reference."""
    ref, port = both(churn(seed), seed=seed)
    assert port == ref
    ok = [w for w in port[0] if isinstance(w, tuple)]
    assert ok and len(set(ok)) == 1
    tally = dict(port[1])
    assert tally.get(ok[0][0], 0) >= 3
    assert all(v < 3 for lid, v in tally.items() if lid != ok[0][0])


def partitioned_nominee(seed):
    """The lowest-id candidate nominates everywhere but its confirms
    never arrive; it must stand down so the healthy rival wins."""
    async def scenario(P):
        from importlib import import_module
        C = P.coordination
        rng = import_module(f"{P.name}.runtime.rng").DeterministicRandom(seed)

        class ConfirmPartitioned:
            def __init__(self, co):
                self._co = co

            def __getattr__(self, name):
                m = getattr(self._co, name)
                if name in ("confirm", "withdraw"):
                    async def blackhole(*a):
                        await asyncio.sleep(60.0)
                        raise asyncio.TimeoutError()
                    return blackhole

                async def call(*a):
                    await asyncio.sleep(rng.random() * 0.01)
                    return await m(*a)
                return call

        k = P.Knobs().override(LEADER_LEASE_DURATION=10.0)
        coords = [C.Coordinator(k) for _ in range(3)]
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        done = []

        async def rival():
            w = await C.elect_leader(coords, 2, "a2", k)
            done.append(loop.time() - t0)
            return w

        winners = await asyncio.gather(
            C.elect_leader([ConfirmPartitioned(c) for c in coords], 1, "a1",
                           k), rival(), return_exceptions=True)
        leases = sum(1 for c in coords
                     if c._leader is not None and c._leader.leader_id == 2)
        return ([w if not isinstance(w, BaseException) else type(w).__name__
                 for w in winners], done, leases, k.ELECTION_TIMEOUT)
    return scenario


@pytest.mark.parametrize("seed", range(10))
def test_partitioned_nominee_does_not_park_election(seed):
    ref, port = both(partitioned_nominee(seed), seed=seed)
    assert port == ref
    winners, done, leases, timeout = port
    assert winners[1] == (2, "a2") and done and done[0] < timeout
    assert leases >= 2
    assert winners[0] in ((2, "a2"), "CoordinatorsUnreachable")


async def leader_kill_failover(P):
    """Four ClusterHosts elect a controller, which recovers a cluster;
    the leader's machine dies and a new leader recovers the next epoch
    with the data intact (tests/test_recovery.py's control plane)."""
    k = P.Knobs().override(RESOLVER_BATCH_TXNS=16, RESOLVER_RANGES_PER_TXN=4,
                           CONFLICT_RING_CAPACITY=1 << 12,
                           KEY_ENCODE_BYTES=16, CONFLICT_DICT_SLOTS=0,
                           RESOLVER_GROUP_BUCKET=4,
                           RESOLVER_CONFLICT_BACKEND="cuda"
                           if P.name == PORT else "numpy")
    sim = HostCluster(P, k, n_machines=4,
                      spec=P.cluster_controller.ClusterConfigSpec(
                          min_workers=4, replication=2))
    await sim.start()
    state = await sim.wait_epoch(1)
    db = await sim.database()
    items = {b"e%02d" % i: b"x%02d" % i for i in range(8)}
    await commit_kv(P, db.view, items)
    leader = next(h for h in sim.hosts if h._leading)
    sim.net.kill_ip(leader.address.ip)
    state2 = await sim.wait_epoch(2)
    while not any(h._leading for h in sim.hosts if h is not leader):
        await asyncio.sleep(0.25)
    await db.refresh()
    got = await read_kv(P, db.view, items)
    more = {b"f%02d" % i: b"y%02d" % i for i in range(8)}
    await commit_kv(P, db.view, more)
    got2 = await read_kv(P, db.view, more)
    for h in sim.hosts:
        if h is not leader:
            await h.stop()
    leader._stopped = True
    if leader._task is not None:
        leader._task.cancel()
        await asyncio.gather(leader._task, return_exceptions=True)
    return (state["epoch"], state2["epoch"], leader.id, got == items,
            got2 == more)


def test_leader_kill_failover_matches_reference():
    ref, port = both(leader_kill_failover)
    assert port[:2] == (1, 2) and port[3] and port[4]
    assert port == ref


# --------------------------------------------------------------------------
# the failure monitor

A = ("10.0.0.1", 4000)
B = ("10.0.0.2", 4000)


def monitor(P, k):
    from importlib import import_module
    FailureMonitor = import_module(
        f"{P.name}.rpc.failure_monitor").FailureMonitor
    net = P.sim_transport.SimNetwork(k)
    a, b = (P.transport.NetworkAddress(*x) for x in (A, B))
    ta = P.sim_transport.SimTransport(net, a)
    P.sim_transport.SimTransport(net, b)
    return net, a, b, FailureMonitor(ta, k)


def fm_knobs(P):
    return P.Knobs().override(FAILURE_TIMEOUT=1.0, PING_INTERVAL=0.25)


async def dead_and_recovered(P):
    k = fm_knobs(P)
    net, a, b, fm = monitor(P, k)
    loop = asyncio.get_running_loop()
    seen = [fm.is_available(b)]
    await asyncio.sleep(1.0)
    seen.append(fm.is_available(b))
    net.kill(b)
    t0 = loop.time()
    await fm.wait_for_failure(b)
    detect = loop.time() - t0
    net.reboot(b)
    await fm.wait_for_recovery(b)
    seen.append(fm.is_available(b))
    await fm.close()
    return seen, detect, loop.time()


async def partition_one_side(P):
    k = fm_knobs(P)
    net, a, b, fm = monitor(P, k)
    net.partition(a, b)
    await fm.wait_for_failure(b)
    failed = not fm.is_available(b)
    net.heal(a, b)
    await fm.wait_for_recovery(b)
    await fm.close()
    return failed, asyncio.get_running_loop().time()


async def detection_time(P):
    k = fm_knobs(P)
    net, a, b, fm = monitor(P, k)
    loop = asyncio.get_running_loop()
    await asyncio.sleep(0.6)
    net.kill(b)
    t0 = loop.time()
    await fm.wait_for_failure(b)
    dt = loop.time() - t0
    await fm.close()
    return dt


MONITOR = {"dead_and_recovered": (dead_and_recovered, 1),
           "partition_one_side": (partition_one_side, 2),
           "detection_time": (detection_time, 3)}


@pytest.mark.parametrize("name", list(MONITOR))
def test_failure_monitor_matches_reference(name):
    scenario, seed = MONITOR[name]
    ref, port = both(scenario, seed)
    assert port == ref
    if name == "dead_and_recovered":
        assert port[0] == [True, True, True]
        assert port[1] <= 3 * 1.0 + 1.0
    if name == "partition_one_side":
        assert port[0]
    if name == "detection_time":
        assert port == package(PORT).run_simulation(
            detection_time(package(PORT)), seed=seed)
