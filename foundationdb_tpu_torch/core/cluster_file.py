"""Cluster file — how clients and servers find the coordinators.

Reference: REF:fdbclient/CoordinationInterface.h (ClusterConnectionString)
+ fdb.cluster format: ``description:id@ip:port[,ip:port]*``.  The
description and id are opaque; the address list names the coordinator
quorum.  Same format here so operational muscle memory transfers.
"""

from __future__ import annotations

import dataclasses
import re

from ..rpc.transport import NetworkAddress

_RX = re.compile(r"^(?P<desc>[A-Za-z0-9_]+):(?P<id>[A-Za-z0-9_]+)@(?P<addrs>.+)$")


@dataclasses.dataclass
class ClusterFile:
    description: str
    cluster_id: str
    coordinators: list[NetworkAddress]

    @classmethod
    def parse(cls, text: str) -> "ClusterFile":
        text = text.strip()
        m = _RX.match(text)
        if not m:
            raise ValueError(f"bad cluster file line: {text!r}")
        addrs = []
        for part in m.group("addrs").split(","):
            ip, _, port = part.strip().rpartition(":")
            addrs.append(NetworkAddress(ip, int(port)))
        if not addrs:
            raise ValueError("cluster file names no coordinators")
        return cls(m.group("desc"), m.group("id"), addrs)

    @classmethod
    def load(cls, path: str) -> "ClusterFile":
        with open(path) as f:
            return cls.parse(f.read())

    def dump(self) -> str:
        addrs = ",".join(f"{a.ip}:{a.port}" for a in self.coordinators)
        return f"{self.description}:{self.cluster_id}@{addrs}\n"

    @classmethod
    def repoint(cls, path: str, addrs: list) -> "ClusterFile":
        """Rewrite the file at ``path`` with a new coordinator set given
        wire-shaped ([ip, port]) or NetworkAddress entries — the ONE home
        of the quorum-change file rewrite (cli + server both use it)."""
        cf = cls.load(path)
        cf.coordinators = [a if isinstance(a, NetworkAddress)
                           else NetworkAddress(a[0], a[1]) for a in addrs]
        cf.save(path)
        return cf

    def save(self, path: str) -> None:
        # atomic replace: several processes rewrite the shared file on a
        # quorum change; a truncate-then-write would expose readers to a
        # partial/empty file
        import os
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.dump())
        os.replace(tmp, path)
