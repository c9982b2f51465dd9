"""fdbcli analog — interactive/one-shot cluster shell.

Reference: REF:fdbcli/fdbcli.actor.cpp — get/set/clear/getrange/status
against a live cluster found through the cluster file.

    python -m foundationdb_tpu_torch.cli -C fdb.cluster --exec "set k v; get k"

A client: it takes no device and never touches the CUDA card (the
servers' ``--device`` says where their resolvers run).
"""

from __future__ import annotations

import argparse
import asyncio
import shlex
import sys

from .client.transaction import Transaction
from .core.cluster_client import RecoveredClusterView, fetch_cluster_state
from .core.cluster_file import ClusterFile
from .rpc.tcp_transport import TcpTransport
from .rpc.transport import NetworkAddress
from .runtime.errors import FdbError
from .runtime.knobs import Knobs


class _CliDatabase:
    """Database facade over the CLI's retry loop (refresh-aware)."""

    def __init__(self, cli: "Cli") -> None:
        self._cli = cli

    @property
    def view(self):
        return self._cli.view

    @property
    def coordinators(self):
        return self._cli.coordinators

    def create_transaction(self):
        from .client.transaction import Transaction
        return Transaction(self._cli.view)

    async def run(self, fn, max_retries=None):
        return await self._cli.run_txn(fn)

    async def get(self, key):
        return await self.run(lambda tr: tr.get(key))

    async def set(self, key, value):
        async def go(tr):
            tr.set(key, value)
        await self.run(go)


class Cli:
    def __init__(self, knobs: Knobs, view: RecoveredClusterView,
                 coordinators: list, coordinator_factory=None,
                 cluster_file_path: str | None = None) -> None:
        self.knobs = knobs
        self.view = view
        self.coordinators = coordinators
        self.coordinator_factory = coordinator_factory
        self.cluster_file_path = cluster_file_path

    async def refresh(self) -> None:
        from .runtime.errors import CoordinatorsChanged
        try:
            self.view.update(await fetch_cluster_state(self.coordinators))
        except CoordinatorsChanged as e:
            # the quorum moved (changeQuorum): follow the forward pointer
            addrs = getattr(e, "moved_to", None)
            if addrs is None or self.coordinator_factory is None:
                raise
            self._repoint(addrs)
            self.view.update(await fetch_cluster_state(self.coordinators))

    def _repoint(self, addrs: list) -> None:
        self.coordinators = self.coordinator_factory(addrs)
        if self.cluster_file_path:
            ClusterFile.repoint(self.cluster_file_path, addrs)

    async def run_txn(self, fn):
        tr = Transaction(self.view)
        refreshed_for: set[int] = set()
        while True:
            try:
                out = await fn(tr)
                await tr.commit()
                return out
            except FdbError as e:
                try:
                    await tr.on_error(e)
                except FdbError:
                    # one refresh per distinct non-retryable code covers
                    # stale-view errors; a repeat of any already-refreshed
                    # code is real (e.g. database_locked) and must
                    # surface, not spin
                    if e.code in refreshed_for:
                        raise
                    refreshed_for.add(e.code)
                # EVERY retry follows recoveries: a retryable error
                # (endpoint_not_found, connection_failed) against a
                # stale view would otherwise loop forever dialing the
                # previous epoch's dead endpoints (the
                # _RefreshingTransaction contract)
                await self.refresh()
                tr = Transaction(self.view)

    async def execute(self, line: str) -> str:
        try:
            return await self._execute(line)
        except FdbError as e:
            return f"ERROR: {e.name} ({e.code})"

    async def _execute(self, line: str) -> str:
        parts = shlex.split(line)
        if not parts:
            return ""
        cmd, *args = parts
        if cmd == "get":
            v = await self.run_txn(lambda tr: tr.get(args[0].encode()))
            return f"`{args[0]}' is `{v.decode(errors='replace')}'" if v is not None \
                else f"`{args[0]}': not found"
        if cmd == "set":
            async def do(tr):
                tr.set(args[0].encode(), args[1].encode())
            await self.run_txn(do)
            return "Committed"
        if cmd == "clear":
            async def do(tr):
                tr.clear(args[0].encode())
            await self.run_txn(do)
            return "Committed"
        if cmd == "getrange":
            begin = args[0].encode()
            end = args[1].encode() if len(args) > 1 else b"\xff"
            limit = int(args[2]) if len(args) > 2 else 25

            async def do(tr):
                return await tr.get_range(begin, end, limit=limit)
            rows = await self.run_txn(do)
            return "\n".join(f"`{k.decode(errors='replace')}' is "
                             f"`{v.decode(errors='replace')}'" for k, v in rows) \
                or "<empty>"
        if cmd == "backup" or cmd == "restore":
            from .backup import BackupAgent
            from .runtime.files import RealFileSystem
            agent = BackupAgent(_CliDatabase(self), RealFileSystem(),
                                args[0] if args else "fdb-backup")
            if cmd == "backup":
                m = await agent.backup()
                return f"Backup complete: {m.rows} rows at version {m.version}"
            to_version = int(args[1]) if len(args) > 1 else None
            m = await agent.restore(to_version=to_version)
            return f"Restore complete: {m.rows} rows (snapshot version {m.version})"
        if cmd == "lock":
            from .core.management import (DatabaseLockedByOther,
                                          lock_database)
            import os as _os
            uid = args[0].encode() if args else _os.urandom(8).hex().encode()
            try:
                await lock_database(_CliDatabase(self), uid)
            except DatabaseLockedByOther:
                return "ERROR: locked under a different uid"
            return f"Database locked (uid {uid.decode()})"
        if cmd == "unlock":
            if not args:
                return "ERROR: unlock <uid>"
            from .core.management import (DatabaseLockedByOther,
                                          unlock_database)
            try:
                await unlock_database(_CliDatabase(self), args[0].encode())
            except DatabaseLockedByOther:
                return "ERROR: locked under a different uid"
            return "Database unlocked"
        if cmd == "dr":
            # fdbdr analog: dr start <dest_cluster_file> | dr status |
            # dr switch | dr abort.  The stream runs for the life of this
            # CLI session (the reference runs a separate dr_agent daemon;
            # here the session hosts it).
            from .backup.dr import DRAgent
            sub = args[0] if args else "status"
            if sub == "start":
                if len(args) < 2:
                    return "ERROR: dr start <dest_cluster_file>"
                cur = getattr(self, "_dr", None)
                if cur is not None and cur._task is not None \
                        and not cur._task.done():
                    return ("ERROR: a DR is already running in this "
                            "session (dr abort/switch first)")
                dest = await open_cli(args[1], self.knobs)
                self._dr = DRAgent(_CliDatabase(self), _CliDatabase(dest))
                v0 = await self._dr.start()
                return f"DR started (snapshot version {v0})"
            dr = getattr(self, "_dr", None)
            if dr is None:
                return "ERROR: no DR running in this session"
            if sub == "status":
                st = await dr.status()
                return (f"running: {st['running']}  applied: "
                        f"{st['applied_through']}  lag: "
                        f"{st['lag_versions']} versions")
            if sub == "switch":
                vd = await dr.switchover()
                return (f"Switchover complete at version {vd}: destination "
                        f"is primary; source locked")
            if sub == "abort":
                await dr.abort()
                return "DR aborted (destination keeps its prefix)"
            return f"ERROR: unknown dr subcommand `{sub}'"
        if cmd in ("exclude", "include"):
            # through the special-key space (REF: fdbcli drives exclusion
            # via \xff\xff/management/excluded/ since 6.3)
            from .client.special_keys import ExcludedServersModule
            prefix = ExcludedServersModule.prefix

            async def do(tr):
                tr.special_key_space_enable_writes = True
                for a in args:
                    if cmd == "exclude":
                        tr.set(prefix + a.encode(), b"1")
                    else:
                        tr.clear(prefix + a.encode())
            await self.run_txn(do)
            return f"Servers {cmd}d (takes effect at the next recovery)"
        if cmd == "configure":
            from .core.system_data import conf_key, validate_conf

            async def do(tr):
                for part in args:
                    name, _, val = part.partition("=")
                    tr.set(conf_key(name), validate_conf(name, val))
            await self.run_txn(do)
            return "Configuration changed (takes effect at the next recovery)"
        if cmd == "coordinators":
            # coordinators ip:port[,ip:port...] — changeQuorum
            # (REF:fdbclient/ManagementAPI.actor.cpp::changeQuorum)
            if not args:
                return "coordinators: " + ",".join(
                    f"{c._address.ip}:{c._address.port}"
                    if hasattr(c, "_address") else repr(c)
                    for c in self.coordinators)
            if self.coordinator_factory is None:
                return "ERROR: this cli session cannot change coordinators"
            from .core.coordination import change_coordinators
            raw = ",".join(args).split(",")
            addrs = []
            for part in raw:
                ip, _, port = part.strip().rpartition(":")
                if not ip or not port.isdigit():
                    return f"ERROR: bad coordinator address `{part}'"
                a = [ip, int(port)]
                if a in addrs:
                    # a duplicate would let one process vote twice,
                    # silently collapsing the advertised fault tolerance
                    return f"ERROR: duplicate coordinator address `{part}'"
                addrs.append(a)
            if len(addrs) % 2 == 0:
                return "ERROR: coordinator count must be odd"
            new_stubs = self.coordinator_factory(addrs)
            # loop-clock mover id: unique enough for generation tie-breaks,
            # deterministic under the simulator
            mover = int(asyncio.get_running_loop().time() * 1e6) & 0xFFFFFF
            await change_coordinators(self.coordinators, new_stubs, addrs,
                                      self.knobs, mover_id=mover)
            self._repoint(addrs)
            return "Coordinators changed"
        if cmd == "status" and args and args[0] == "json":
            import json as _json

            from .core.status import cluster_status
            # refresh first: follows a coordinator change (repoint) the
            # same way the plain `status` command does
            await self.refresh()
            doc = await cluster_status(self.knobs, self.view.transport,
                                       self.coordinators)
            return _json.dumps(doc, indent=2, default=str)
        if cmd == "status":
            await self.refresh()
            st = await fetch_cluster_state(self.coordinators)
            lines = [f"epoch: {st['epoch']}",
                     f"recovery_version: {st['recovery_version']}",
                     f"sequencer: {st['sequencer']['addr']}",
                     f"tlogs: {st['log_cfg'][-1]['tlogs']}",
                     f"resolvers: {[r['addr'] for r in st['resolvers']]}",
                     f"storage: {[s['addr'] for s in st['storage']]}",
                     f"commit_proxies: {[p['addr'] for p in st['commit_proxies']]}",
                     f"grv_proxies: {[p['addr'] for p in st['grv_proxies']]}"]
            return "\n".join(lines)
        return f"ERROR: unknown command `{cmd}'"


async def open_cli(cluster_file: str, knobs: Knobs,
                   timeout: float = 30.0, tls=None) -> Cli:
    cf = ClusterFile.load(cluster_file)
    t = TcpTransport(NetworkAddress("127.0.0.1", 0), tls=tls, knobs=knobs)

    from .rpc.stubs import make_coordinator_stubs

    def coord_factory(addrs):
        return make_coordinator_stubs(addrs, transport=t)

    coords = coord_factory(cf.coordinators)
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        try:
            state = await fetch_cluster_state(coords)
            break
        except (FdbError, OSError):
            if asyncio.get_running_loop().time() > deadline:
                raise
            await asyncio.sleep(0.5)
    return Cli(knobs, RecoveredClusterView(knobs, t, state), coords,
               coordinator_factory=coord_factory,
               cluster_file_path=cluster_file)


async def amain(args) -> int:
    knobs = Knobs()
    tls = None
    if args.tls_cert:
        from .rpc.tcp_transport import TlsConfig
        tls = TlsConfig(args.tls_cert, args.tls_key, args.tls_ca)
    cli = await open_cli(args.cluster_file, knobs, tls=tls)
    if args.exec:
        for line in args.exec.split(";"):
            out = await cli.execute(line.strip())
            if out:
                print(out)
        return 0
    print("fdbtpu cli — commands: get set clear getrange status exit")
    loop = asyncio.get_running_loop()
    while True:
        line = await loop.run_in_executor(None, lambda: input("fdbtpu> "))
        if line.strip() in ("exit", "quit"):
            return 0
        try:
            out = await cli.execute(line)
        except Exception as e:      # noqa: BLE001 — shell keeps going
            out = f"ERROR: {e!r}"
        if out:
            print(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="foundationdb_tpu_torch.cli")
    ap.add_argument("-C", "--cluster-file", required=True)
    ap.add_argument("--exec", default="", help="semicolon-separated commands")
    ap.add_argument("--tls-cert", default="")
    ap.add_argument("--tls-key", default="")
    ap.add_argument("--tls-ca", default="")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    return asyncio.run(amain(args))


if __name__ == "__main__":
    raise SystemExit(main())
