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
first commit (the test's shape).  With ``--deployment`` the cluster
is phase 25's instead (``run_deployment``): the package's fdbmonitor
over three coordinator servers and a worker-only fourth, the monitor
SIGSTOPped from the kill until a commit lands, the attempts through a
fresh CLI.  ``--hold-leader`` adds what the H100 showed in phase 25
(ROADMAP C3): the CLI reaches the leader's coordinator through a relay
(``HeldRelay``) that, from the kill on, holds its connections open and
answers nothing: on the card a refresh's request to the killed
leader's coordinator went unanswered for 22 s.  ``--stop-roles``
SIGSTOPs, instead of killing the leader, a server other than the
leader's that holds epoch 1's sequencer or a GRV proxy (ROADMAP C5): a
peer that keeps its sockets open and answers nothing, which the client's
GRV awaits, directly or through a live proxy.  ``--rolling`` leaves
the monitor running and SIGKILLs the three coordinators' servers in
turn, each restarted at once, empty (``run_rolling``; ROADMAP C6);
``--rolling all`` kills the worker-only server first.  ``--keep DIR``
runs in DIR and keeps the logs.  ``--device cuda`` puts the port's
servers of a ``--deployment`` on the card.

    python tests/failover_attempts.py foundationdb_tpu [--fresh-cli]
    python tests/failover_attempts.py foundationdb_tpu_torch [--fresh-cli]
    python tests/failover_attempts.py PACKAGE --deployment [--stop-leader]
    python tests/failover_attempts.py PACKAGE --deployment --hold-leader
    python tests/failover_attempts.py PACKAGE --deployment --stop-roles
    python tests/failover_attempts.py PACKAGE --deployment --rolling [all]
    python tests/failover_attempts.py foundationdb_tpu_torch --deployment \
        [--rolling [all]] --device cuda

The port's servers run ``--device cpu`` unless ``--device cuda``.  Run
on a host with no card,
each package takes 20-60 s; ``--rolling`` about 40 s, or several
minutes where the client or the read-back hangs.
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


class HeldRelay:
    """A localhost TCP relay in front of one server, for this process's
    client alone: bytes pass both ways until ``hold``; from then on every
    connection, and every one it accepts later, stays open and passes
    nothing.  That is a killed server whose connections outlive it: the
    client's requests there are never answered and never fail."""

    def __init__(self, port: int) -> None:
        self.port = port
        self.held = False
        self.server = None
        self.writers: list = []
        self.tasks: set = set()

    async def start(self) -> int:
        """Listen on a free port; returns it."""
        self.server = await asyncio.start_server(self._accept, "127.0.0.1",
                                                 0)
        return self.server.sockets[0].getsockname()[1]

    def hold(self) -> None:
        self.held = True

    async def _accept(self, reader, writer) -> None:
        self.writers.append(writer)
        upstream = None
        if not self.held:
            try:
                up_reader, upstream = await asyncio.open_connection(
                    "127.0.0.1", self.port)
            except OSError:
                pass
            else:
                self.writers.append(upstream)
                t = asyncio.ensure_future(self._pipe(up_reader, writer))
                self.tasks.add(t)
                t.add_done_callback(self.tasks.discard)
        await self._pipe(reader, upstream)

    async def _pipe(self, reader, writer) -> None:
        """``reader``'s bytes to ``writer`` until ``reader`` ends; once
        held, or with the other side gone, they are dropped, and neither
        side is closed."""
        try:
            while data := await reader.read(1 << 16):
                if writer is not None and not self.held:
                    writer.write(data)
                    await writer.drain()
        except (ConnectionError, OSError):
            pass

    async def close(self) -> None:
        self.server.close()
        for w in self.writers:
            w.close()
        for t in list(self.tasks):
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)


def started(tmp: str) -> dict:
    """Each server's pids, in the order its monitor started them."""
    pids: dict = {}
    with open(os.path.join(tmp, "monitor.err"), errors="replace") as f:
        for ln in f:
            if "started fdbserver." in ln:
                sid = int(ln.split("fdbserver.")[1].split()[0])
                pids.setdefault(sid, []).append(
                    int(ln.split("pid=")[1].split()[0]))
    return pids


def cli_exec(package: str, cf_path: str, script: str, env: dict,
             timeout: float = 120) -> str:
    """One ``python -m <package>.cli --exec`` run: its output, or its
    exit code and the end of its errors."""
    p = subprocess.run([sys.executable, "-m", f"{package}.cli", "-C",
                        cf_path, "--exec", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p.stdout if p.returncode == 0 else \
        f"rc={p.returncode} {p.stderr[-600:]}"


def start_deployment(package: str, tmp: str, device: str = "cpu"
                     ) -> tuple:
    """Phase 25's layout for either package in ``tmp``: the package's
    fdbmonitor over three coordinator servers and a worker-only fourth
    (``min_workers=3,replication=2``, ``restart-delay = 0.5``, the port's
    with ``device = <device>``), each server's log in ``tmp``.  Returns
    (monitor, ports, cluster file, environment, start time)."""
    imp = lambda m: importlib.import_module(f"{package}.{m}")  # noqa: E731
    ClusterFile = imp("core.cluster_file").ClusterFile
    NetworkAddress = imp("rpc.transport").NetworkAddress
    ports = free_ports(4)
    cf_path = os.path.join(tmp, "fdb.cluster")
    ClusterFile("deploy", "t1", [NetworkAddress("127.0.0.1", p)
                                 for p in ports[:3]]).save(cf_path)
    conf = os.path.join(tmp, "fdbmonitor.conf")
    dev = f"device = {device}\n" if package.endswith("_torch") else ""
    with open(conf, "w") as f:
        f.write(f"[general]\ncluster-file = {cf_path}\nrestart-delay = 0.5\n"
                f"{dev}logdir = {tmp}\n" + "".join(
                    f"[fdbserver.{p}]\nlisten = 127.0.0.1:{p}\n"
                    "spec = min_workers=3,replication=2\n" for p in ports))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "monitor.err"), "wb") as ef:
        mon = subprocess.Popen([sys.executable, "-m", f"{package}.monitor",
                                "-C", conf], cwd=REPO, env=env,
                               stdout=subprocess.DEVNULL, stderr=ef)
    return mon, ports, cf_path, env, t0


def first_commit(package: str, cf_path: str, env: dict, mon,
                 t0: float) -> float:
    """Seconds from ``t0`` to the first ``set first 1`` the CLI commits."""
    while "Committed" not in cli_exec(package, cf_path, "set first 1", env):
        if time.perf_counter() - t0 > 300 or mon.poll() is not None:
            raise RuntimeError("no first commit through the CLI")
        time.sleep(0.5)
    return round(time.perf_counter() - t0, 3)


class NoTarget(RuntimeError):
    """``--stop-roles`` found the sequencer and the GRV proxies on the
    leader's server (the controller places them on the live worker with
    the lowest address, and the lowest candidate id, its port, tends to
    win the election)."""


def run_deployment(package: str, tmp: str, stop_leader: bool = False,
                   hold_leader: bool = False, stop_roles: bool = False,
                   device: str = "cpu") -> dict:
    """Phase 25's first lifetime up to its failover, for either package:
    the package's fdbmonitor over three coordinator servers and a
    worker-only fourth (``min_workers=3,replication=2``, the port's with
    ``device = cpu``); the first commit through the CLI, 16 writes, a
    range read and the status document, each a CLI process of its own;
    then a CLI opened here, the elected leader's server SIGKILLed with the
    monitor SIGSTOPped until a commit lands, and the attempts timed as
    ``run`` times them.  An attempt that times out is reported as phase
    25 reports it (``chip_smoke.OutstandingRequests``): the requests it
    was awaiting and the epoch each coordinator published then.  With
    ``stop_leader`` the leader's server is SIGSTOPped instead of killed
    (a process that holds its connections open and answers nothing) and
    SIGKILLed after the attempts, which then give up 120 s after the
    stop.  With ``hold_leader`` the CLI's cluster file names a
    ``HeldRelay`` in front of the leader's coordinator (the first
    coordinator's, where the worker-only server is the leader), held
    from the kill on.  With ``stop_roles`` the server SIGSTOPped is not
    the leader's but one that the CLI's view places epoch 1's sequencer
    on, else a GRV proxy (``stopped``: its index; ``roles``: every
    server's client-facing roles), continued and SIGKILLed after the
    attempts, which give up 30 s after the stop: the reference's first
    attempt times out.  Each timed-out attempt also records the socket
    states a ``chip_smoke.KillWatch`` on the victim saw.  This process's
    client trace goes to ``client.jsonl`` in ``tmp``."""
    import chip_smoke as cs
    imp = lambda m: importlib.import_module(f"{package}.{m}")  # noqa: E731
    ClusterFile = imp("core.cluster_file").ClusterFile
    NetworkAddress = imp("rpc.transport").NetworkAddress
    trace = imp("runtime.trace")
    mon, ports, cf_path, env, t0 = start_deployment(package, tmp, device)
    out: dict = {"package": package, "shape": "deployment",
                 "stop_leader": stop_leader, "hold_leader": hold_leader,
                 "stop_roles": stop_roles, "attempts": []}
    prev = trace.get_trace_log()
    trace.set_trace_log(trace.TraceLog(path=os.path.join(tmp,
                                                         "client.jsonl")))
    try:
        out["first_commit_s"] = first_commit(package, cf_path, env, mon,
                                             t0)
        got = cli_exec(package, cf_path, "; ".join(
            f"set deploy/{i:02d} v{i}" for i in range(16)), env)
        assert got.split() == ["Committed"] * 16, got
        assert len(cli_exec(package, cf_path, "getrange deploy/ deploy0 100",
                            env).splitlines()) == 16
        json.loads(cli_exec(package, cf_path, "status json", env))

        async def failover():
            open_cli = imp("cli").open_cli
            CoordinatorClient = imp("rpc.stubs").CoordinatorClient
            TcpTransport = imp("rpc.tcp_transport").TcpTransport
            WLTOKEN_COORDINATOR = imp("rpc.transport").WLTOKEN_COORDINATOR
            t = TcpTransport(NetworkAddress("127.0.0.1", 0))
            leader = None
            try:
                for p in ports[:3]:
                    co = CoordinatorClient(t, NetworkAddress("127.0.0.1", p),
                                           WLTOKEN_COORDINATOR)
                    try:
                        led = await asyncio.wait_for(co.read_leader(), 5)
                    except (Exception, asyncio.TimeoutError):
                        continue
                    if led is not None:
                        leader = led[1][1]
                        break
            finally:
                await t.close()
            assert leader in ports, f"no leader found ({leader})"
            out["leader"] = ports.index(leader)
            relay, cli_cf = None, cf_path
            if hold_leader:
                # the leader's coordinator; the first one where the
                # worker-only server won the election
                held = leader if leader in ports[:3] else ports[0]
                out["held"] = ports.index(held)
                relay = HeldRelay(held)
                via = await relay.start()
                cli_cf = os.path.join(tmp, "client.cluster")
                ClusterFile("deploy", "t1", [
                    NetworkAddress("127.0.0.1", via if p == held else p)
                    for p in ports[:3]]).save(cli_cf)
            cli = await open_cli(cli_cf, imp("runtime.knobs").Knobs(),
                                 timeout=60)
            waits = cs.OutstandingRequests(
                cli.view.transport, lambda: cli.view,
                imp("rpc.stubs").ROLE_METHODS, WLTOKEN_COORDINATOR)
            target = leader
            if stop_roles:
                roles = {p: waits.roles_at(cli.view.state, p) for p in ports}
                out["roles"] = {ports.index(p): r for p, r in roles.items()}
                held = [p for want in ("sequencer", "grv_proxies")
                        for p in ports if p != leader
                        and any(r.startswith(want) for r in roles[p])]
                if not held:
                    raise NoTarget(f"the leader's server holds the sequencer "
                                   f"and the GRV proxies: {roles}")
                target = held[0]
                out["stopped"] = ports.index(target)
            os.kill(mon.pid, signal.SIGSTOP)
            victim = started(tmp)[target][-1]
            stop = stop_leader or stop_roles
            watch = None
            try:
                if relay is not None:
                    relay.hold()
                os.kill(victim, signal.SIGSTOP if stop else signal.SIGKILL)
                tk = time.perf_counter()
                watch = cs.KillWatch(victim, target, ports)
                while True:
                    ta = time.perf_counter()
                    try:
                        got = await asyncio.wait_for(
                            cli.execute("set after failover"), 30)
                        outcome = "committed" if got == "Committed" \
                            else str(got)[:120]
                    except asyncio.TimeoutError:
                        got = outcome = "timeout"
                        report = waits.report(time.perf_counter())
                        out.setdefault("timed_out", []).append({
                            "attempt": len(out["attempts"]),
                            "awaiting": report,
                            "sockets": watch.at(cs.awaited_ports(report)),
                            "published_epochs": await cs.published_epochs(
                                cli.coordinators),
                            "view_epoch": cli.view.epoch,
                            "killed_server_roles": waits.roles_at(
                                cli.view.state, target),
                            "killed_process": cs.exit_state(victim)})
                    except Exception as e:  # noqa: BLE001 — an outcome
                        got, outcome = None, type(e).__name__
                    out["attempts"].append([round(ta - tk, 3), outcome,
                                            round(time.perf_counter() - ta,
                                                  3)])
                    if got == "Committed":
                        out["failover_s"] = round(time.perf_counter() - tk,
                                                  3)
                        break
                    if time.perf_counter() - tk > (
                            120 if stop_leader else 30 if stop_roles
                            else 240):
                        out["failover_s"] = None
                        break
                    await asyncio.sleep(0.25)
            finally:
                if stop:
                    os.kill(victim, signal.SIGCONT)
                    os.kill(victim, signal.SIGKILL)
                os.kill(mon.pid, signal.SIGCONT)
                if watch is not None:
                    out["kill_watch"] = cs.watch_summary(watch.stop())
            await cli.view.transport.close()
            if relay is not None:
                await relay.close()
        asyncio.run(asyncio.wait_for(failover(), 600))
    finally:
        trace.get_trace_log().close()
        trace.set_trace_log(prev)
        mon.send_signal(signal.SIGCONT)
        mon.send_signal(signal.SIGTERM)
        try:
            mon.wait(60)
        except subprocess.TimeoutExpired:
            mon.kill()
            mon.wait()
    out["monitor_rc"] = mon.returncode
    return out


def run_rolling(package: str, tmp: str, order: str = "coordinators",
                device: str = "cpu") -> dict:
    """A rolling restart of phase 25's deployment (``start_deployment``)
    for either package (``chip_smoke.rolling_kills``): with the monitor
    left running, the
    coordinators' servers SIGKILLed in turn, 0, 1 and then 2, each
    restarted at once, empty; with ``order`` "all" the worker-only
    server first.  After the first commit and 16 writes through the
    CLI, one long-lived client commits after each kill (``kills``: each
    kill's victim, attempts [start s after the kill, outcome, s],
    timed-out attempts' records, ``failover_s``); after the last kill a
    fresh CLI reads back every acknowledged write once each victim has
    restarted (``read_back``, ``chip_smoke.read_back_of``'s record;
    ``chip_smoke.read_back_error`` is its gate); ``recoveries``: the
    epoch of each ``RecoveryComplete``, the foundings and the shards left
    without a replica in the server logs (``chip_smoke.recovery_record``);
    ``stopped``: what the monitor said of each server it stopped on
    SIGTERM."""
    import chip_smoke as cs
    imp = lambda m: importlib.import_module(f"{package}.{m}")  # noqa: E731
    trace = imp("runtime.trace")
    mon, ports, cf_path, env, t0 = start_deployment(package, tmp, device)
    out: dict = {"package": package, "shape": "rolling", "order": order}
    prev = trace.get_trace_log()
    trace.set_trace_log(trace.TraceLog(path=os.path.join(tmp,
                                                         "client.jsonl")))
    try:
        out["first_commit_s"] = first_commit(package, cf_path, env, mon,
                                             t0)
        writes = {f"rolling/w{i:02d}": f"v{i}" for i in range(16)}
        got = cli_exec(package, cf_path, "; ".join(
            f"set {k} {v}" for k, v in writes.items()), env)
        assert got.split() == ["Committed"] * 16, got
        out["acked"] = {"first": "1", **writes}
        victims = ([ports[3]] if order == "all" else []) + ports[:3]

        async def rolling():
            cli = await imp("cli").open_cli(
                cf_path, imp("runtime.knobs").Knobs(), timeout=60)
            waits = cs.OutstandingRequests(
                cli.view.transport, lambda: cli.view,
                imp("rpc.stubs").ROLE_METHODS,
                imp("rpc.transport").WLTOKEN_COORDINATOR)
            try:
                await cs.rolling_kills(cli, waits, victims, ports,
                                       lambda p: started(tmp)[p][-1], out,
                                       "rolling", cs.ROLLING_BUDGET_S)
            finally:
                await cli.view.transport.close()
        asyncio.run(asyncio.wait_for(rolling(), 600))
        for k in out["kills"]:
            k["failover_s"] = k["failover_s"] and round(k["failover_s"], 3)
        # every victim restarted before the read-back and the SIGTERM (a
        # server still starting would die of the signal)
        for p in victims:
            t = time.perf_counter()
            while len(started(tmp).get(p, [])) < 2 or open(os.path.join(
                    tmp, f"fdbserver.{p}.log"), errors="replace").read(
                    ).count('"ServerStarted"') < 2:
                if time.perf_counter() - t > 120:
                    raise RuntimeError(f"server {p} did not restart")
                time.sleep(0.2)
        try:
            got = cli_exec(package, cf_path, "; ".join(
                f"get {k}" for k in sorted(out["acked"])), env,
                cs.ROLLING_READ_S)
        except subprocess.TimeoutExpired:
            got = None
        out["read_back"] = cs.read_back_of(got, out["acked"])
    finally:
        trace.get_trace_log().close()
        trace.set_trace_log(prev)
        mon.send_signal(signal.SIGTERM)
        try:
            mon.wait(60)
        except subprocess.TimeoutExpired:
            mon.kill()
            mon.wait()
        out["recoveries"] = cs.recovery_record(tmp, ports)
        with open(os.path.join(tmp, "monitor.err"), errors="replace") as f:
            out["stopped"] = [ln.split("] ", 1)[-1].strip() for ln in f
                              if "stopped rc=" in ln]
    out["monitor_rc"] = mon.returncode
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, REPO)
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        if "--keep" in argv:
            tmp = argv[argv.index("--keep") + 1]
            os.makedirs(tmp, exist_ok=True)
        if "--rolling" in argv:
            i = argv.index("--rolling") + 1
            order = "all" if argv[i:i + 1] == ["all"] else "coordinators"
            r = run_rolling(argv[0], tmp, order, device)
        elif "--deployment" in argv:
            # --stop-roles needs the roles off the leader's server: a new
            # deployment (new ports) until they are, at most 8
            for i in range(8):
                os.makedirs(os.path.join(tmp, str(i)))
                try:
                    r = run_deployment(argv[0], os.path.join(tmp, str(i)),
                                       "--stop-leader" in argv,
                                       "--hold-leader" in argv,
                                       "--stop-roles" in argv, device)
                except NoTarget:
                    continue
                r["deployments"] = i + 1
                break
            else:
                raise NoTarget("8 deployments, the roles on the leader's "
                               "server in each")
        else:
            r = run(argv[0], tmp, "--fresh-cli" in argv)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
