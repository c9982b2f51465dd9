"""Special-key-space — the ``\\xff\\xff`` module registry.

Reference: REF:fdbclient/SpecialKeySpace.actor.cpp — the reference maps
ranges under ``\\xff\\xff`` to SpecialKeyRangeReadImpl/RWImpl modules:
reads are answered by the client (status json, worker interfaces) or
rewritten onto real system keys (management: exclusions), and writes are
gated behind the SPECIAL_KEY_SPACE_ENABLE_WRITES transaction option.
Same architecture here: a sorted registry of prefix-scoped modules, each
with get/get_range and (for management modules) set/clear handlers that
translate onto ``\\xff`` system keys inside the SAME transaction — so a
special-key exclusion commits atomically with the rest of the txn.
"""

from __future__ import annotations

from ..runtime.errors import ClientInvalidOperation

SPECIAL_PREFIX = b"\xff\xff"


class SpecialKeyModule:
    """One registered range: [prefix, prefix+\\xff)."""

    prefix: bytes = b""
    writable: bool = False

    async def get(self, tr, key: bytes) -> bytes | None:
        rows = await self.get_range(tr, key, key + b"\x00", limit=1)
        for k, v in rows:
            if k == key:
                return v
        return None

    async def get_range(self, tr, begin: bytes, end: bytes,
                        limit: int = 0, reverse: bool = False
                        ) -> list[tuple[bytes, bytes]]:
        raise ClientInvalidOperation(
            f"special-key module {self.prefix!r} is not range-readable")

    def set(self, tr, key: bytes, value: bytes) -> None:
        raise ClientInvalidOperation(
            f"special-key range {self.prefix!r} is read-only")

    def clear(self, tr, begin: bytes, end: bytes | None = None) -> None:
        raise ClientInvalidOperation(
            f"special-key range {self.prefix!r} is read-only")


class StatusJsonModule(SpecialKeyModule):
    """\\xff\\xff/status/json — the cluster status document."""

    prefix = b"\xff\xff/status/json"

    async def get(self, tr, key: bytes) -> bytes | None:
        if key != self.prefix:
            return None
        rdb = getattr(tr, "_rdb", None)
        if rdb is None:
            raise ClientInvalidOperation(
                "status json needs a coordinator-backed database")
        import json

        from ..core.status import cluster_status
        doc = await cluster_status(tr._cluster.knobs, tr._cluster.transport,
                                   rdb.coordinators)
        return json.dumps(
            doc, sort_keys=True,
            default=lambda o: (o.hex() if isinstance(o, (bytes, bytearray))
                               else str(o))).encode()

    async def get_range(self, tr, begin, end, limit=0, reverse=False):
        v = await self.get(tr, self.prefix)
        rows = [(self.prefix, v)] if v is not None \
            and begin <= self.prefix < end else []
        return rows


class ConnectionStringModule(SpecialKeyModule):
    """\\xff\\xff/connection_string — the cluster file line."""

    prefix = b"\xff\xff/connection_string"

    async def get(self, tr, key: bytes) -> bytes | None:
        if key != self.prefix:
            return None
        rdb = getattr(tr, "_rdb", None)
        if rdb is None or not getattr(rdb, "connection_string", None):
            return None
        return rdb.connection_string.encode()

    async def get_range(self, tr, begin, end, limit=0, reverse=False):
        v = await self.get(tr, self.prefix)
        return [(self.prefix, v)] if v is not None \
            and begin <= self.prefix < end else []


class ExcludedServersModule(SpecialKeyModule):
    """\\xff\\xff/management/excluded/<ip:port> — rewrites onto the
    ``\\xff/conf/excluded/`` system keys inside the SAME transaction
    (REF:fdbclient/SpecialKeySpace.actor.cpp ExcludeServersRangeImpl):
    a special-key exclusion commits atomically with the txn and takes
    effect at the next recovery, exactly like the management API."""

    prefix = b"\xff\xff/management/excluded/"
    writable = True

    def _real(self, key: bytes) -> bytes:
        from ..core.management import EXCLUDED_PREFIX
        return EXCLUDED_PREFIX + key[len(self.prefix):]

    def _special(self, real_key: bytes) -> bytes:
        from ..core.management import EXCLUDED_PREFIX
        return self.prefix + real_key[len(EXCLUDED_PREFIX):]

    async def get(self, tr, key: bytes) -> bytes | None:
        return await tr.get(self._real(key))

    async def get_range(self, tr, begin, end, limit=0, reverse=False):
        from ..core.management import EXCLUDED_PREFIX
        lo = self._real(begin) if begin > self.prefix else EXCLUDED_PREFIX
        hi = self._real(end) if end.startswith(self.prefix) \
            else EXCLUDED_PREFIX + b"\xff"
        rows = await tr.get_range(lo, hi, limit=limit, reverse=reverse)
        return [(self._special(k), v) for k, v in rows]

    def set(self, tr, key: bytes, value: bytes) -> None:
        tr.set(self._real(key), value or b"1")

    def clear(self, tr, begin: bytes, end: bytes | None = None) -> None:
        if end is None:
            tr.clear(self._real(begin))
        else:
            from ..core.management import EXCLUDED_PREFIX
            lo = self._real(begin) if begin > self.prefix else EXCLUDED_PREFIX
            hi = self._real(end) if end.startswith(self.prefix) \
                else EXCLUDED_PREFIX + b"\xff"
            tr.clear_range(lo, hi)


class WorkerInterfacesModule(SpecialKeyModule):
    """\\xff\\xff/worker_interfaces/<ip:port> — the registered workers'
    addresses from the published cluster state
    (REF:fdbclient/SpecialKeySpace.actor.cpp WorkerInterfacesSpecialKeyImpl)."""

    prefix = b"\xff\xff/worker_interfaces/"

    async def get_range(self, tr, begin, end, limit=0, reverse=False):
        state = getattr(tr._cluster, "state", None) \
            or getattr(tr._cluster, "last_state", None)
        rows: list[tuple[bytes, bytes]] = []
        addrs = set()
        if isinstance(state, dict):
            for section in ("storage", "commit_proxies", "grv_proxies",
                            "resolvers"):
                for ent in state.get(section, []):
                    a = ent.get("addr")
                    if a:
                        addrs.add(f"{a[0]}:{a[1]}")
            for a in state.get("workers", []):
                addrs.add(f"{a[0]}:{a[1]}" if isinstance(a, (list, tuple))
                          else str(a))
        for a in sorted(addrs):
            k = self.prefix + a.encode()
            if begin <= k < end:
                rows.append((k, b""))
        if reverse:
            rows.reverse()
        if limit:
            rows = rows[:limit]
        return rows


class ErrorMessageModule(SpecialKeyModule):
    """\\xff\\xff/error_message — the last special-key error explanation
    recorded on this transaction (REF: SpecialKeySpace's errorMsg)."""

    prefix = b"\xff\xff/error_message"

    async def get(self, tr, key: bytes) -> bytes | None:
        if key != self.prefix:
            return None
        return getattr(tr, "_special_error", None)

    async def get_range(self, tr, begin, end, limit=0, reverse=False):
        v = await self.get(tr, self.prefix)
        return [(self.prefix, v)] if v is not None \
            and begin <= self.prefix < end else []


class SpecialKeySpace:
    """The registry: longest-prefix dispatch over sorted modules."""

    def __init__(self, modules: list[SpecialKeyModule] | None = None) -> None:
        self.modules = sorted(modules if modules is not None
                              else DEFAULT_MODULES(),
                              key=lambda m: m.prefix)

    def module_for(self, key: bytes) -> SpecialKeyModule | None:
        best = None
        for m in self.modules:
            if key.startswith(m.prefix) or key == m.prefix:
                if best is None or len(m.prefix) > len(best.prefix):
                    best = m
        return best

    async def get(self, tr, key: bytes) -> bytes | None:
        m = self.module_for(key)
        if m is None:
            self._err(tr, f"unknown special key {key!r}")
            raise ClientInvalidOperation(f"unknown special key {key!r}")
        return await m.get(tr, key)

    async def get_range(self, tr, begin: bytes, end: bytes,
                        limit: int = 0, reverse: bool = False
                        ) -> list[tuple[bytes, bytes]]:
        """Range reads span modules (the reference's cross-module read):
        each module contributes its rows clipped to [begin, end)."""
        out: list[tuple[bytes, bytes]] = []
        for m in self.modules:      # sorted by prefix = key order
            mend = m.prefix + b"\xff"
            if mend <= begin or m.prefix >= end:
                continue
            # push the REMAINING limit down so a bounded read never
            # materializes (or RPCs for) rows it will throw away; early
            # termination is only valid forward (modules ascend)
            sub_limit = max(0, limit - len(out)) if limit and not reverse \
                else 0
            try:
                rows = await m.get_range(tr, max(begin, m.prefix),
                                         min(end, mend), limit=sub_limit)
            except ClientInvalidOperation:
                # a module that cannot serve THIS client (e.g. status
                # json without coordinators) contributes nothing to a
                # cross-module read; point reads still surface the error
                continue
            out.extend(rows)
            if limit and not reverse and len(out) >= limit:
                break
        out.sort(key=lambda kv: kv[0], reverse=reverse)
        if limit:
            out = out[:limit]
        return out

    def set(self, tr, key: bytes, value: bytes) -> None:
        m = self._writable(tr, key)
        m.set(tr, key, value)

    def clear(self, tr, begin: bytes, end: bytes | None = None) -> None:
        m = self._writable(tr, begin)
        m.clear(tr, begin, end)

    def _writable(self, tr, key: bytes) -> SpecialKeyModule:
        if not getattr(tr, "special_key_space_enable_writes", False):
            self._err(tr, "special-key writes require the "
                          "SPECIAL_KEY_SPACE_ENABLE_WRITES option")
            raise ClientInvalidOperation(
                "special-key writes require the "
                "SPECIAL_KEY_SPACE_ENABLE_WRITES option")
        m = self.module_for(key)
        if m is None or not m.writable:
            self._err(tr, f"special key {key!r} is not writable")
            raise ClientInvalidOperation(
                f"special key {key!r} is not writable")
        return m

    @staticmethod
    def _err(tr, msg: str) -> None:
        tr._special_error = msg.encode()


def DEFAULT_MODULES() -> list[SpecialKeyModule]:
    return [StatusJsonModule(), ConnectionStringModule(),
            ExcludedServersModule(), WorkerInterfacesModule(),
            ErrorMessageModule()]


SPECIAL_KEY_SPACE = SpecialKeySpace()
