"""The leader-kill failover of ``tests/test_server.py::
test_tcp_leader_kill_failover``, timed attempt by attempt, for either
package.

Three servers over localhost TCP (``min_workers=2,replication=2``), a
CLI commit, then the elected leader's process SIGKILLed.  At the kill a
``set after failover`` starts, each attempt under
``asyncio.wait_for(..., 30)`` with 0.25 s between attempts (the
discipline of ``chip_smoke.py`` phase 25).  Prints one JSON line:
``{"package": ..., "attempts": [[start s after the kill, outcome, s],
...], "failover_s": ...}``.  With ``--fresh-cli`` the attempts go
through a CLI opened just before the kill, whose first command is the
attempt (phase 25's shape); otherwise through the CLI that made the
first commit (the test's shape).

    python tests/failover_attempts.py foundationdb_tpu [--fresh-cli]
    python tests/failover_attempts.py foundationdb_tpu_torch [--fresh-cli]

The port's servers run ``--device cpu``.  Run on a host with no card,
each package takes 20-60 s.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def run(package: str, tmp: str, fresh_cli: bool = False) -> dict:
    imp = lambda m: importlib.import_module(f"{package}.{m}")  # noqa: E731
    ClusterFile = imp("core.cluster_file").ClusterFile
    NetworkAddress = imp("rpc.transport").NetworkAddress
    ports = free_ports(3)
    cf_path = os.path.join(tmp, "fdb.cluster")
    ClusterFile("failover", "t1", [NetworkAddress("127.0.0.1", p)
                                   for p in ports]).save(cf_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    extra = ["--device", "cpu"] if package.endswith("_torch") else []
    procs = {}
    for p in ports:
        with open(os.path.join(tmp, f"server-{p}.log"), "ab") as log:
            procs[p] = subprocess.Popen(
                [sys.executable, "-m", f"{package}.server", "-C", cf_path,
                 "-l", f"127.0.0.1:{p}", "--spec",
                 "min_workers=2,replication=2", *extra],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    out: dict = {"package": package, "fresh_cli": fresh_cli, "attempts": []}

    async def drive():
        open_cli = imp("cli").open_cli
        CoordinatorClient = imp("rpc.stubs").CoordinatorClient
        TcpTransport = imp("rpc.tcp_transport").TcpTransport
        WLTOKEN_COORDINATOR = imp("rpc.transport").WLTOKEN_COORDINATOR
        Knobs = imp("runtime.knobs").Knobs

        cli = await open_cli(cf_path, Knobs(), timeout=90.0)
        assert await cli.execute("set before failover") == "Committed"
        t = TcpTransport(NetworkAddress("127.0.0.1", 0))
        leader = None
        try:
            for p in ports:
                co = CoordinatorClient(t, NetworkAddress("127.0.0.1", p),
                                       WLTOKEN_COORDINATOR)
                try:
                    led = await asyncio.wait_for(co.read_leader(), 5.0)
                except (Exception, asyncio.TimeoutError):
                    continue
                if led is not None:
                    leader = led[1][1]
                    break
        finally:
            await t.close()
        assert leader in procs, f"no leader found ({leader})"
        out["leader"] = ports.index(leader)
        if fresh_cli:
            await cli.view.transport.close()
            cli = await open_cli(cf_path, Knobs(), timeout=90.0)
        procs[leader].send_signal(signal.SIGKILL)
        tk = time.perf_counter()
        while True:
            ta = time.perf_counter()
            try:
                got = await asyncio.wait_for(
                    cli.execute("set after failover"), 30)
                outcome = "committed" if got == "Committed" else str(got)[:120]
            except asyncio.TimeoutError:
                got = outcome = "timeout"
            except Exception as e:  # noqa: BLE001 — an attempt's outcome
                got, outcome = None, type(e).__name__
            out["attempts"].append([round(ta - tk, 3), outcome,
                                    round(time.perf_counter() - ta, 3)])
            if got == "Committed":
                out["failover_s"] = round(time.perf_counter() - tk, 3)
                break
            if time.perf_counter() - tk > 180:
                out["failover_s"] = None
                break
            await asyncio.sleep(0.25)
        await cli.view.transport.close()

    try:
        asyncio.run(asyncio.wait_for(drive(), 300))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, REPO)
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps(run(argv[0], tmp, "--fresh-cli" in argv)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
