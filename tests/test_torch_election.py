"""Leader election with a coordinator that keeps its connection open and
answers nothing (ROADMAP C4).

In phase 25's deployment with the leader's server SIGSTOPped, no new
leader was ever elected.  ``server.py``'s knobs bound each of
``elect_leader``'s calls at 2 s, and each phase of a round waited for
every coordinator, so the nominate phase's replies came back 2 s after
the coordinators recorded the candidacies, which lapse after
NOMINATION_TIMEOUT (1 s): every confirm was refused, round after round.
The port's rounds return once their answers decide them
(``coordination.quorum_round``), and a nomination outlives two of the
per-call bounds (``coordination.nomination_lifetime``).

- Three coordinators over localhost TCP, one of them a listener that
  accepts and never answers: three candidates running the port's
  ``elect_leader`` at ``server.py``'s knobs return the same leader,
  each within one per-call bound.
- The reference's ``elect_leader`` in the same set-up elects nobody:
  every candidate raises CoordinatorsUnreachable
  (``..._reference_fault``, a recorded fault of the JAX package, which
  the port repairs alone).
- Safety over seeded interleavings in the simulator, one coordinator
  silent and one slow, candidates that win, renew and fall silent in
  turn: no two candidates' terms overlap (a term runs from the win until
  the lease lapses as its winner reckons it), and the candidates keep
  electing leaders.
- Phase 25's deployment on the CPU with the leader's server SIGSTOPped
  (``tests/failover_attempts.py --deployment --stop-leader``) commits on
  its first attempt, in under 30 s.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import sys
import time

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)

from test_torch_cluster_refresh import deployment  # noqa: E402
from test_torch_tcp_liveness import close_silent, silent_peer  # noqa: E402
from torch_parity import PORT, REF, package  # noqa: E402


def mod(name: str, path: str):
    return importlib.import_module(f"{name}.{path}")


def server_knobs(name: str):
    """The knobs ``server.py`` runs a server with."""
    return mod(name, "runtime.knobs").Knobs().override(
        LEADER_LEASE_DURATION=8.0, FAILURE_TIMEOUT=2.0)


async def tcp_election(name: str, candidates=(1, 2, 3)) -> tuple:
    """Two coordinators of package ``name`` served over localhost TCP and
    a silent listener as the third; each candidate elects through a
    transport of its own.  Returns each candidate's result (its exception
    in its place) and the seconds each took."""
    k = server_knobs(name)
    NA = mod(name, "rpc.transport").NetworkAddress
    Tcp = mod(name, "rpc.tcp_transport").TcpTransport
    stubs = mod(name, "rpc.stubs")
    C = mod(name, "core.coordination")
    token = mod(name, "rpc.transport").WLTOKEN_COORDINATOR
    servers = []
    for _ in range(2):
        t = Tcp(NA("127.0.0.1", 0))
        stubs.serve_role(t, "coordinator", C.Coordinator(k), token)
        await t.listen()
        servers.append(t)
    srv, silent, held = await silent_peer()
    ports = [t._server.sockets[0].getsockname()[1] for t in servers]
    ports.insert(1, silent)
    clients = [Tcp(NA("127.0.0.1", 0)) for _ in candidates]
    loop = asyncio.get_running_loop()

    async def elect(cid, t):
        coords = [stubs.CoordinatorClient(t, NA("127.0.0.1", p), token)
                  for p in ports]
        t0 = loop.time()
        try:
            got = await C.elect_leader(coords, cid, ["127.0.0.1", cid], k)
        except Exception as e:  # noqa: BLE001 — an outcome
            got = e
        return got, loop.time() - t0

    try:
        return await asyncio.gather(*(elect(cid, t) for cid, t
                                      in zip(candidates, clients)))
    finally:
        for t in clients + servers:
            await t.close()
        await close_silent(srv, held)


def test_election_with_a_silent_coordinator_elects_one_leader():
    """The port: every candidate returns the same leader, each within
    one per-call bound (2 s): no phase waited out the silent
    coordinator.  (With its rounds gathered, the port's transport cuts
    the silent connection after 4 s, which lets a round through.)"""
    k = server_knobs(PORT)
    bound = mod(PORT, "core.coordination").election_rpc_bound(k)
    got = asyncio.run(asyncio.wait_for(tcp_election(PORT), 60))
    assert all(isinstance(r, tuple) for r, _ in got), got
    leaders = {(r[0], tuple(r[1])) for r, _ in got}
    assert len(leaders) == 1, got
    lid, addr = leaders.pop()
    assert lid in (1, 2, 3) and addr == ("127.0.0.1", lid), got
    assert all(s < bound for _, s in got), got


def test_election_with_a_silent_coordinator_reference_fault():
    """The reference in the same set-up: each phase waits out the silent
    coordinator's 2 s bound, every confirm reaches a coordinator after
    the candidacy it confirms has lapsed, and every candidate raises
    CoordinatorsUnreachable at ELECTION_TIMEOUT."""
    k = server_knobs(REF)
    unreachable = mod(REF, "core.coordination").CoordinatorsUnreachable
    got = asyncio.run(asyncio.wait_for(tcp_election(REF), 60))
    assert all(isinstance(r, unreachable) for r, _ in got), got
    assert all(s >= k.ELECTION_TIMEOUT for _, s in got), got


# --------------------------------------------------------------------------
# safety over seeded interleavings


class Faulty:
    """A coordinator as a candidate reaches it: ``silent`` calls never
    answer (nor reach it); ``slow`` ones are delayed on the way there
    and back by up to ``slow`` seconds each.  ``sent(name, args)`` runs
    as each call is made."""

    def __init__(self, co, rng, slow: float, silent: bool, sent) -> None:
        self._co, self._rng, self._slow = co, rng, slow
        self._silent, self._sent = silent, sent

    def __getattr__(self, name):
        m = getattr(self._co, name)

        async def call(*a):
            self._sent(name, a)
            if self._silent:
                await asyncio.Event().wait()
            await asyncio.sleep(self._rng.random() * self._slow)
            r = await m(*a)
            await asyncio.sleep(self._rng.random() * self._slow)
            return r
        return call


def interleaving(seed: int, delays: tuple, candidates: int = 4,
                 seconds: float = 240.0):
    """Coordinators that answer within ``delays`` seconds each way (None:
    silent), against ``server.py``'s 2 s bound, and ``candidates``
    candidates, each of which elects, and on winning renews its lease a
    seeded number of times with ``cluster_host``'s renewal round, then
    falls silent; a candidate that follows another polls again within
    half a second.

    A winner may act as the leader until LEADER_LEASE_DURATION after it
    sent the last round that a majority granted (the confirm that won,
    or a renewal): a coordinator starts a lease no sooner than the
    request arrives.  Returns each term, [candidate, the moment it won,
    the moment its lease lapses as the winner reckons it], in order of
    the wins."""
    async def scenario(P):
        C = P.coordination
        rng = mod(P.name, "runtime.rng").DeterministicRandom(seed)
        k = server_knobs(P.name)
        coords = [C.Coordinator(k) for _ in delays]
        majority = len(coords) // 2 + 1
        loop = asyncio.get_running_loop()
        confirm_sent: dict = {}
        terms: list = []

        def sent(name, args):
            if name == "confirm":
                confirm_sent[args[0]] = loop.time()

        views = [Faulty(c, rng, d or 0.0, d is None, sent)
                 for c, d in zip(coords, delays)]
        end = loop.time() + seconds

        async def renew(cid) -> bool:
            async def hb(c):
                return await asyncio.wait_for(
                    c.leader_heartbeat(cid),
                    timeout=k.LEADER_LEASE_DURATION / 4)
            replies = await C.quorum_round([hb(c) for c in views],
                                           C.tallied(C.granted, majority))
            return sum(1 for r in replies if r is True) >= majority

        async def candidate(cid):
            while loop.time() < end:
                try:
                    lid, _ = await C.elect_leader(views, cid, f"a{cid}", k)
                except C.CoordinatorsUnreachable:
                    continue
                if lid != cid:
                    await asyncio.sleep(rng.random() * 0.5)
                    continue
                # a win by following our own unexpired lease (a poll)
                # reckons from the confirm that granted it
                term = [cid, loop.time(),
                        confirm_sent[cid] + k.LEADER_LEASE_DURATION]
                terms.append(term)
                for _ in range(rng.random_int(0, 5)):
                    await asyncio.sleep(k.LEADER_HEARTBEAT_INTERVAL)
                    t = loop.time()
                    if not await renew(cid):
                        break
                    term[2] = t + k.LEADER_LEASE_DURATION
                # fall silent until the lease has lapsed everywhere
                await asyncio.sleep(k.LEADER_LEASE_DURATION
                                    + 2 * rng.random())

        await asyncio.gather(*(candidate(cid)
                               for cid in range(1, candidates + 1)))
        return terms
    return scenario


# each coordinator's most seconds each way (None: silent): one silent and
# one slow of three; one silent and two slow of five
LAYOUTS = {"three": (0.01, 1.2, None),
           "five": (0.3, 1.2, None, 1.2, 0.3)}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_no_two_leaders_hold_a_majority(layout, seed):
    """No two candidates' terms overlap: a candidate wins only once the
    previous winner's lease has lapsed as that winner reckons it, at a
    majority (which intersects the previous winner's).  And the
    candidates elect leader after leader, each a few seconds after the
    previous lease lapsed, though every round waits on a slow
    coordinator."""
    P = package(PORT)
    terms = P.run_simulation(
        interleaving(seed, LAYOUTS[layout], candidates=5)(P), seed=seed)
    overlaps = [(a, b) for i, a in enumerate(terms) for b in terms[i + 1:]
                if a[0] != b[0] and a[1] < b[2] and b[1] < a[2]]
    assert overlaps == [], overlaps[:3]
    assert len(terms) >= 8 and len({t[0] for t in terms}) >= 2, terms


# --------------------------------------------------------------------------
# the deployment


def test_deployment_with_the_leader_stopped_commits_at_once():
    """Phase 25's first monitor lifetime on the CPU (the port's
    fdbmonitor, three coordinator servers and a worker-only fourth,
    ``device = cpu``) with the elected leader's server SIGSTOPped: its
    lease lapses at the live coordinators, a live server is elected and
    recovers the next epoch, and the first attempt of the set after the
    stop commits, in under 30 s."""
    t = time.perf_counter()
    r = deployment(PORT, "--stop-leader")
    assert r["stop_leader"] and r["monitor_rc"] == 0, r
    assert r["attempts"][0][1] == "committed", r.get("timed_out", r)
    assert r["failover_s"] < 30, r
    assert time.perf_counter() - t < 240
