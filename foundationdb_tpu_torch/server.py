"""fdbserver analog — the per-process entry point.

Reference: REF:fdbserver/fdbserver.actor.cpp — one process, one listen
address: serves a coordinator role when its address is named in the
cluster file, and always runs a ClusterHost (worker + election candidate
+ cluster controller when elected).  Three of these on localhost make a
working cluster:

    python -m foundationdb_tpu_torch.server -C fdb.cluster -l 127.0.0.1:4500
    python -m foundationdb_tpu_torch.server -C fdb.cluster -l 127.0.0.1:4501
    python -m foundationdb_tpu_torch.server -C fdb.cluster -l 127.0.0.1:4502

Knobs are settable ``--knob_name=value`` exactly like the reference.
``--device cuda|cpu`` (default ``cuda``) is where this process's
resolvers and storage read mirrors run: with ``cuda`` and no card the
server raises at start-up, before it serves.
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import signal
import sys

import torch

from .core.cluster_controller import ClusterConfigSpec
from .core.cluster_file import ClusterFile
from .core.cluster_host import ClusterHost
from .core.coordination import Coordinator
from .ops.conflict_torch import default_device
from .rpc.stubs import serve_role
from .rpc.tcp_transport import TcpTransport
from .rpc.transport import (NetworkAddress, WLTOKEN_COORDINATOR,
                            WLTOKEN_FIRST_AVAILABLE)
from .runtime.knobs import Knobs
from .runtime.trace import TraceEvent

BASE = WLTOKEN_FIRST_AVAILABLE


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="foundationdb_tpu_torch.server",
        description="Run one cluster process (worker + coordinator when "
                    "named in the cluster file).")
    ap.add_argument("-C", "--cluster-file", required=True)
    ap.add_argument("-l", "--listen", required=True, metavar="IP:PORT")
    ap.add_argument("--spec", default="", help="role counts, e.g. "
                    "logs=2,resolvers=1,storage_servers=2,min_workers=3")
    ap.add_argument("--tls-cert", default="", help="mutual TLS certificate")
    ap.add_argument("--tls-key", default="")
    ap.add_argument("--tls-ca", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the resolvers and the storage read "
                         "mirrors run (default: the CUDA card)")
    args, extra = ap.parse_known_args(argv)
    knob_overrides = {}
    for e in extra:
        if e.startswith("--knob_") and "=" in e:
            name, val = e[len("--knob_"):].split("=", 1)
            knob_overrides[name] = val
        else:
            ap.error(f"unknown argument {e!r}")
    return args, knob_overrides


def parse_spec(text: str) -> ClusterConfigSpec:
    spec = ClusterConfigSpec()
    if text:
        for part in text.split(","):
            name, _, val = part.partition("=")
            if not hasattr(spec, name):
                raise SystemExit(f"unknown spec field {name!r}")
            setattr(spec, name, int(val))
    return spec


async def run_server(cluster_file: str, listen: str, spec: ClusterConfigSpec,
                     knobs: Knobs, ready_event: asyncio.Event | None = None,
                     tls=None, device=None):
    # the card is checked before anything listens: a server that cannot
    # reach it refuses to start instead of serving from the host
    device = default_device(device)
    cf = ClusterFile.load(cluster_file)
    ip, _, port = listen.rpartition(":")
    addr = NetworkAddress(ip, int(port))

    transport = TcpTransport(addr, tls=tls, knobs=knobs)
    await transport.listen()

    # outbound-only client transports: a unique address identity each, no
    # listener (mirrors the reference's ephemeral outbound connections)
    counter = itertools.count(1)

    def client_transport() -> TcpTransport:
        return TcpTransport(
            NetworkAddress(ip, int(port) * 1000 + next(counter)), tls=tls,
            knobs=knobs)

    # EVERY process serves a coordination register (idle unless the
    # connection string names its address) so `coordinators` can move the
    # quorum onto any process — exactly like fdbserver
    coordinator = Coordinator(knobs)
    serve_role(transport, "coordinator", coordinator, WLTOKEN_COORDINATOR)
    if addr in cf.coordinators:
        TraceEvent("CoordinatorStarted").detail("Address", str(addr)).log()

    from .rpc.stubs import make_coordinator_stubs

    def coord_factory(addrs):
        return make_coordinator_stubs(addrs,
                                      transport_factory=client_transport)

    def on_repoint(addrs):
        # persist the new connection string so a restart finds the new set
        ClusterFile.repoint(cluster_file, addrs)

    coord_stubs = coord_factory(cf.coordinators)
    host_id = int(port)           # unique per process on one box
    host = ClusterHost(host_id, knobs, transport, client_transport, BASE,
                       coord_stubs, spec,
                       coordinator_factory=coord_factory,
                       on_repoint=on_repoint, device=device)
    host.start()
    TraceEvent("ServerStarted").detail("Address", str(addr)) \
        .detail("Cluster", cf.cluster_id).detail("Device", str(device)).log()
    if ready_event is not None:
        ready_event.set()

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    await stop.wait()
    await host.stop()
    await transport.close()


def main(argv=None) -> int:
    args, knob_overrides = parse_args(argv if argv is not None else sys.argv[1:])
    # Real-TCP deployments run on wall clocks with real scheduling
    # stalls: a neighbor process's startup burst (the torch import alone
    # costs seconds of CPU) can starve the controller's heartbeat loop past
    # the sim-tuned 2s lease, churning leadership exactly when a crashed
    # server respawns.  Production-grade leases absorb such pauses; the
    # sim keeps the short ones for fast deterministic failover tests.
    # Explicit --knob overrides still win.
    knobs = Knobs().override(LEADER_LEASE_DURATION=8.0,
                             FAILURE_TIMEOUT=2.0)
    knobs = knobs.set_from_strings(knob_overrides)
    spec = parse_spec(args.spec)
    tls = None
    if args.tls_cert:
        from .rpc.tcp_transport import TlsConfig
        tls = TlsConfig(args.tls_cert, args.tls_key, args.tls_ca)
    try:
        asyncio.run(run_server(args.cluster_file, args.listen, spec, knobs,
                               tls=tls, device=torch.device(args.device)))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
