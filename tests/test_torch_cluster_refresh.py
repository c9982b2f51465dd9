"""The client's refresh of the cluster state (``core/cluster_client.py::
fetch_cluster_state``) when one coordinator holds its request and never
answers (ROADMAP C3).

On the H100, phase 25's first attempt after the leader's SIGKILL hung
for its whole 30 s: the CLI's refresh was waiting on ``open_database``
at the killed leader's coordinator, whose connection stayed open, while
the other two coordinators already published the next epoch.  The
reference gathers every coordinator's reply with no deadline.  The port
returns once a majority (``len // 2 + 1``) has answered with a state,
the newest by ``(epoch, seq)``: a majority intersects the quorum that
wrote the newest state.  It cancels the requests still out.

- The port returns the newest state of the two that answer, within 1 s,
  with no task left pending: coordinators in process, and coordinator
  servers over localhost TCP beside a server that accepts and never
  answers.
- The reference's refresh, and the port's with the repair off
  (``torch_parity.gathered``, the parity tests' seam), wait for the
  silent coordinator: a recorded fault of the reference.
- A retired coordinator's forward (``__moved_to__``), a mid-change
  marker (``__moving_to__``), empty replies and errors give what the
  reference's refresh gives.
- Phase 25's deployment on the CPU with the leader's coordinator held
  silent from the kill on (``tests/failover_attempts.py --deployment
  --hold-leader``) commits on its first attempt.
- The same deployment with a server other than the leader's that holds
  epoch 1's sequencer or a GRV proxy SIGSTOPped (``--stop-roles``: a
  peer that keeps its sockets and answers nothing, ROADMAP C5) commits
  on its first attempt, since the port's TCP transport cuts a request to
  a peer that answers no ping; the reference's first attempt times out
  on that server, a recorded fault of the reference.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import socket
import subprocess
import sys
import time

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)

from torch_parity import PORT, REF, buggify_off, gathered  # noqa: E402,F401


def mod(name: str, path: str):
    return importlib.import_module(f"{name}.{path}")


def state(epoch: int, seq: int, tag: str) -> dict:
    return {"epoch": epoch, "seq": seq, "tag": tag}


def coordinators(name: str, values: list, silent: int) -> list:
    """Package ``name``'s in-process Coordinators holding ``values``, the
    one at index ``silent`` one whose ``open_database`` awaits forever
    (it counts its cancellations in ``cancelled``)."""
    P = mod(name, "core.coordination")
    K = mod(name, "runtime.knobs").Knobs

    class Silent(P.Coordinator):
        cancelled = 0

        async def open_database(self):
            try:
                await asyncio.get_running_loop().create_future()
            except asyncio.CancelledError:
                self.cancelled += 1
                raise

    out = []
    for i, v in enumerate(values):
        c = (Silent if i == silent else P.Coordinator)(K())
        c.value = v
        out.append(c)
    return out


def fetch(name: str):
    return mod(name, "core.cluster_client").fetch_cluster_state


def others(values: list, silent: int) -> list:
    return [v for i, v in enumerate(values) if i != silent]


VALUES = [state(2, 1, "newest"), state(2, 0, "behind"), state(1, 4, "old")]


@pytest.mark.parametrize("silent", [0, 1, 2])
def test_refresh_returns_on_a_majority_with_one_coordinator_silent(silent):
    coords = coordinators(PORT, VALUES, silent)
    want = max(others(VALUES, silent), key=lambda s: (s["epoch"], s["seq"]))

    async def main():
        t = time.perf_counter()
        got = await asyncio.wait_for(fetch(PORT)(coords), 1.0)
        seconds = time.perf_counter() - t
        await asyncio.sleep(0)
        left = [x for x in asyncio.all_tasks()
                if x is not asyncio.current_task()]
        return got, seconds, left
    got, seconds, left = asyncio.run(main())
    assert got == want and seconds < 1.0
    assert left == []
    assert coords[silent].cancelled == 1


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_refresh_over_tcp_returns_past_a_silent_server():
    """Two coordinator servers over localhost TCP and a third address
    that accepts connections and never answers (as the killed leader's
    did on the card): the port's refresh returns the newest state within
    1 s, and its transport forgets the cancelled request."""
    NA = mod(PORT, "rpc.transport").NetworkAddress
    token = mod(PORT, "rpc.transport").WLTOKEN_COORDINATOR
    Tcp = mod(PORT, "rpc.tcp_transport").TcpTransport
    stubs = mod(PORT, "rpc.stubs")
    coords = coordinators(PORT, VALUES, silent=-1)
    held: list = []

    async def hold(reader, writer):
        held.append(writer)
        while await reader.read(1 << 16):
            pass

    async def main():
        ports = free_ports(3)
        servers = []
        for p, c in zip(ports[1:], coords[1:]):
            t = Tcp(NA("127.0.0.1", p))
            stubs.serve_role(t, "coordinator", c, token)
            await t.listen()
            servers.append(t)
        silent = await asyncio.start_server(hold, "127.0.0.1", ports[0])
        client = Tcp(NA("127.0.0.1", 0))
        try:
            cs = [stubs.CoordinatorClient(client, NA("127.0.0.1", p), token)
                  for p in ports]
            t0 = time.perf_counter()
            got = await asyncio.wait_for(fetch(PORT)(cs), 1.0)
            seconds = time.perf_counter() - t0
            pending = {str(a): len(p.pending)
                       for a, p in client._peers.items()}
        finally:
            await client.close()
            for t in servers:
                await t.close()
            silent.close()
            for w in held:
                w.close()
        return got, seconds, pending
    got, seconds, pending = asyncio.run(main())
    assert got == VALUES[1] and seconds < 1.0
    assert len(pending) == 3 and not any(pending.values()), pending


@pytest.mark.parametrize("side", ["reference", "port_gathered"])
def test_silent_coordinator_holds_the_refresh_reference_fault(
        side, monkeypatch):
    """The reference's refresh waits for every coordinator, so one that
    never answers holds it past any deadline; so does the port's with
    its majority return off (the parity tests' ``gathered``)."""
    name = REF if side == "reference" else PORT
    if name == PORT:
        gathered(monkeypatch)
    coords = coordinators(name, VALUES, silent=2)

    async def main():
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(fetch(name)(coords), 1.0)
    asyncio.run(main())
    assert coords[2].cancelled == 1


class Replying:
    """A coordinator whose ``open_database`` gives ``reply`` (raises it,
    for an exception) after ``delay`` seconds."""

    def __init__(self, reply, delay: float = 0.0) -> None:
        self.reply, self.delay = reply, delay

    async def open_database(self):
        await asyncio.sleep(self.delay)
        if isinstance(self.reply, BaseException):
            raise self.reply
        return self.reply


NEW, MID, OLD = state(3, 0, "new"), state(2, 7, "mid"), state(2, 1, "old")
FWD = [["10.0.0.9", 4500], ["10.0.0.10", 4500], ["10.0.0.11", 4500]]


def moving(value) -> dict:
    return {"__moving_to__": FWD, "__value__": value}


# each case: the three coordinators' (reply, delay); a reply "error" is
# a connection failure
REPLIES = {
    "moving_all": [(moving(OLD), 0), (moving(NEW), 0.01), (moving(MID), 0.02)],
    "moving_empty_value": [(moving(None), 0), (MID, 0.01), (NEW, 0.02)],
    "moved_all": [({"__moved_to__": FWD}, 0)] * 3,
    "moved_then_state": [({"__moved_to__": FWD}, 0),
                         ({"__moved_to__": FWD}, 0.01), (OLD, 0.02)],
    "moved_before_majority": [(MID, 0), ({"__moved_to__": FWD}, 0.01),
                              (NEW, 0.02)],
    "moved_and_moving": [({"__moved_to__": FWD}, 0), (moving(MID), 0.01),
                         (moving(NEW), 0.02)],
    "errors_then_state": [("error", 0), ("error", 0.01), (MID, 0.02)],
    "errors_only": [("error", 0), ("error", 0.01), ("error", 0.02)],
    "empty_replies": [(None, 0), ({}, 0.01), (OLD, 0.02)],
    "majority_first": [(NEW, 0), (MID, 0.01), (OLD, 0.5)],
}


def outcome(name: str, case: str) -> tuple:
    """Package ``name``'s refresh over ``REPLIES[case]``: ("state", the
    state) or ("error", its type, its code, its ``moved_to``)."""
    errors = mod(name, "runtime.errors")
    coords = [Replying(errors.ConnectionFailed() if r == "error" else r, d)
              for r, d in REPLIES[case]]
    try:
        return "state", asyncio.run(fetch(name)(coords))
    except errors.FdbError as e:
        return ("error", type(e).__name__, e.code,
                getattr(e, "moved_to", None))


@pytest.mark.parametrize("case", list(REPLIES))
def test_forwards_markers_and_errors_as_the_reference(case, monkeypatch):
    ref = outcome(REF, case)
    port = outcome(PORT, case)
    gathered(monkeypatch)
    assert outcome(PORT, case) == port == ref


def test_majority_first_returns_before_the_slowest_reply():
    """With a majority of states in hand the refresh does not wait for
    the third coordinator's reply (0.5 s later)."""
    t = time.perf_counter()
    assert outcome(PORT, "majority_first") == ("state", NEW)
    assert time.perf_counter() - t < 0.4


def deployment(package: str, *flags: str) -> dict:
    """``tests/failover_attempts.py PACKAGE --deployment FLAGS`` in a
    process of its own, with 240 s: its record."""
    p = subprocess.run(
        [sys.executable, os.path.join(TESTS, "failover_attempts.py"),
         package, "--deployment", *flags], cwd=REPO, capture_output=True,
        text=True, timeout=240,
        env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_deployment_with_the_leader_held_silent_commits_at_once(tmp_path):
    """Phase 25's first monitor lifetime on the CPU (the port's
    fdbmonitor, three coordinator servers and a worker-only fourth,
    ``device = cpu``), the leader's server SIGKILLed with the monitor
    paused, and the CLI's connections to the leader's coordinator (the
    first coordinator's, where the worker-only server leads) held open
    and silent from the kill on: no attempt of the set after the kill
    waits on a coordinator, and a commit lands, as the card's should have
    in ROADMAP C3.  The first attempt commits, unless it waits on
    another request (the repair does not reach those, ROADMAP C5), which
    the failure then names.  The run has 240 s."""
    r = deployment(PORT, "--hold-leader")
    assert r["hold_leader"] and r["held"] in (0, 1, 2), r
    assert r["monitor_rc"] == 0, r
    waits = json.dumps(r.get("timed_out", []))
    assert r["failover_s"] is not None, waits
    assert '"coordinator.' not in waits, waits
    if r["attempts"][0][1] != "committed":
        pytest.fail(f"the first attempt waited on another request: {waits}")


def stopped_roles(r: dict) -> list:
    """The client-facing roles the stopped server held in epoch 1."""
    assert r["stop_roles"] and r["stopped"] != r["leader"], r
    return r["roles"][str(r["stopped"])]


def test_deployment_with_a_role_server_stopped_commits_at_once():
    """The deployment with a server other than the leader's SIGSTOPped,
    one that holds epoch 1's sequencer or a GRV proxy, from the moment
    the CLI has its epoch-1 view (``--stop-roles``): the client's GRV
    awaits that server, directly or through a live proxy, and the
    server answers nothing while its sockets stay open.  The port's
    transport cuts the request after the window of silence, the retry
    reaches the recovered epoch, and the first attempt commits."""
    r = deployment(PORT, "--stop-roles")
    roles = stopped_roles(r)
    assert any(x.startswith(("sequencer", "grv_proxies")) for x in roles), r
    assert r["monitor_rc"] == 0, r
    waits = json.dumps(r.get("timed_out", []))
    assert r["attempts"][0][1] == "committed", waits
    assert r["failover_s"] < 30, r


def test_role_server_stopped_holds_the_client_reference_fault():
    """The reference's client in the same deployment: its GRV awaits the
    stopped server with no end, so the first attempt times out (30 s),
    awaiting an epoch-1 request."""
    r = deployment(REF, "--stop-roles")
    stopped_roles(r)
    assert r["attempts"][0][1] == "timeout", r
    awaiting = r["timed_out"][0]["awaiting"]
    assert awaiting and all(w["epoch"] == 1 for w in awaiting), awaiting
