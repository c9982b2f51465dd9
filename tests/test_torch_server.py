"""The port's deployment: three server processes on localhost TCP.

Spawns three ``python -m foundationdb_tpu_torch.server`` processes from
one cluster file (all three coordinators), each with ``--device cpu`` so
its resolver runs the kernels' plain versions, waits for the election
and the first recovery, then drives set, get, a range read, a clear and
``\\xff\\xff/status/json`` through the port's client over TCP (the twin
of tests/test_server.py's smoke test, with the port's own client in
place of the CLI).  A server asked for the card where there is none
refuses to start.  A ``cuda``-marked twin runs the servers on the card.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from foundationdb_tpu_torch.core.cluster_file import ClusterFile
from foundationdb_tpu_torch.rpc.transport import NetworkAddress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def spawn_server(args: list[str], log_path, env) -> subprocess.Popen:
    """Output to a file, not a pipe: a pipe nobody drains blocks the
    server once it fills and wedges the cluster."""
    with open(log_path, "ab") as log:
        return subprocess.Popen(args, cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def teardown(procs) -> None:
    """SIGTERM every live server, SIGKILL past a shared deadline."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + 10
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def server_cmd(cf_path, port: int, device: str) -> list[str]:
    return [sys.executable, "-m", "foundationdb_tpu_torch.server",
            "-C", str(cf_path), "-l", f"127.0.0.1:{port}",
            "--spec", "min_workers=3", "--device", device]


async def drive(cf_path: str) -> dict:
    """Open the cluster through its coordinators, then set, get, read a
    range, clear, and read the status document."""
    from foundationdb_tpu_torch.core.cluster_client import (
        RefreshingDatabase, open_cluster)
    from foundationdb_tpu_torch.rpc.stubs import make_coordinator_stubs
    from foundationdb_tpu_torch.rpc.tcp_transport import TcpTransport
    from foundationdb_tpu_torch.runtime.errors import FdbError
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    knobs = Knobs()
    cf = ClusterFile.load(cf_path)
    t = TcpTransport(NetworkAddress("127.0.0.1", 0))
    coords = make_coordinator_stubs(cf.coordinators, transport=t)
    deadline = time.time() + 90
    while True:
        try:
            view = await open_cluster(knobs, t, coords)
            break
        except (FdbError, OSError):
            assert time.time() < deadline, "no cluster state published"
            await asyncio.sleep(0.5)
    db = RefreshingDatabase(view, coords)
    try:
        await db.set(b"hello", b"world")
        await db.set(b"hellp", b"worle")
        got = await db.get(b"hello")
        rows = await db.get_range(b"hell", b"hellz")
        await db.clear(b"hello")
        cleared = await db.get(b"hello")
        tr = db.create_transaction()
        doc = json.loads(await tr.get(b"\xff\xff/status/json"))
    finally:
        await t.close()
    return {"got": got, "rows": rows, "cleared": cleared, "doc": doc}


def run_cluster(tmp_path, device: str) -> tuple[dict, list[str], list]:
    ports = free_ports(3)
    cf = ClusterFile("smoke", "t1",
                     [NetworkAddress("127.0.0.1", p) for p in ports])
    cf_path = tmp_path / "fdb.cluster"
    cf.save(str(cf_path))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    logs = [tmp_path / f"server-{p}.log" for p in ports]
    procs = []
    try:
        for p, lg in zip(ports, logs):
            procs.append(spawn_server(server_cmd(cf_path, p, device), lg,
                                      env))
        out = asyncio.run(asyncio.wait_for(drive(str(cf_path)), 120))
    finally:
        teardown(procs)
    return (out, [lg.read_text(errors="replace") for lg in logs],
            [p.returncode for p in procs])


def check(out: dict, logs: list[str], codes: list) -> None:
    assert out["got"] == b"world"
    assert out["rows"] == [(b"hello", b"world"), (b"hellp", b"worle")]
    assert out["cleared"] is None
    c = out["doc"]["cluster"]
    assert c["epoch"] == 1 and c["database_available"] is True
    assert c["resolver_device"]["pipelined_resolvers"] == 1
    assert c["resolver_device"]["dispatches"] > 0
    assert not any("Traceback" in lg for lg in logs), "\n".join(logs)
    # SIGTERM stops each server cleanly, its clients still connected
    assert codes == [0, 0, 0], codes


def test_three_port_servers_serve(tmp_path):
    check(*run_cluster(tmp_path, "cpu"))


def test_server_refuses_without_the_card(tmp_path):
    """``--device cuda`` where no card is visible: the server raises
    before it listens, naming the missing device."""
    ports = free_ports(1)
    cf_path = tmp_path / "fdb.cluster"
    ClusterFile("nocard", "t1", [NetworkAddress("127.0.0.1", ports[0])]) \
        .save(str(cf_path))
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(server_cmd(cf_path, ports[0], "cuda"), cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    with socket.socket() as s:     # nothing was left listening
        assert s.connect_ex(("127.0.0.1", ports[0])) != 0


@pytest.mark.cuda
def test_three_port_servers_serve_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    check(*run_cluster(tmp_path, "cuda"))
