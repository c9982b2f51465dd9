"""ManagementAPI — operational mutations through the system keyspace.

Reference: REF:fdbclient/ManagementAPI.actor.cpp — configuration changes,
server exclusion/inclusion and status all ride ordinary transactions over
``\\xff`` keys; the controller materializes them at recovery.

Exclusion semantics v1 (matching the reference's intent): an excluded
address stops being a recruitment target for transaction-subsystem roles
at the next recovery.  Storage replicas already resident there keep
serving until DataDistribution (or an operator move) relocates them —
exclusion never silently drops data.
"""

from __future__ import annotations

from .system_data import CONF_PREFIX, conf_key

EXCLUDED_PREFIX = CONF_PREFIX + b"excluded/"


def excluded_key(addr: str) -> bytes:
    """addr: "ip:port" (a worker's listen address)."""
    return EXCLUDED_PREFIX + addr.encode()


def decode_excluded(rows: list[tuple[bytes, bytes]]) -> set[str]:
    out = set()
    for k, v in rows:
        if k.startswith(EXCLUDED_PREFIX) and v:
            out.add(k[len(EXCLUDED_PREFIX):].decode(errors="replace"))
    return out


async def exclude_servers(db, addrs: list[str]) -> None:
    """Mark addresses excluded (takes effect at the next recovery)."""
    async def do(tr):
        for a in addrs:
            tr.set(excluded_key(a), b"1")
    await db.run(do)


async def include_servers(db, addrs: list[str]) -> None:
    async def do(tr):
        for a in addrs:
            tr.clear(excluded_key(a))
    await db.run(do)


async def configure(db, **fields) -> None:
    """configure(resolvers=2, storage_engine="btree", ...) — the fdbcli
    configure analog.  ``storage_engine`` kicks off a live DataDistribution
    migration of every shard onto the new engine type."""
    from .system_data import validate_conf

    async def do(tr):
        for name, val in fields.items():
            tr.set(conf_key(name), validate_conf(name, val))
    await db.run(do)


async def configure_regions(db, regions: list[dict] | None) -> None:
    """Set (or clear, with None/[]) the multi-region topology: a list of
    {"id": dcid, "priority": int, "satellite": dcid, "satellite_logs": n}.
    Takes effect at the next recovery — the controller re-reads
    ``\\xff/conf/regions`` and recruits region-aware
    (REF:fdbclient/ManagementAPI.actor.cpp changeConfig regions=)."""
    from ..rpc.wire import encode
    from .system_data import REGIONS_KEY
    for r in regions or []:
        if "id" not in r:
            raise ValueError(f"region missing 'id': {r!r}")

    async def do(tr):
        if regions:
            tr.set(REGIONS_KEY, encode([dict(r) for r in regions]))
        else:
            tr.clear(REGIONS_KEY)
    await db.run(do)


# --- database lock (REF:fdbclient/ManagementAPI.actor.cpp lockDatabase) ---

class DatabaseLockedByOther(ValueError):
    """Lock refused: already locked under a different UID."""


async def lock_database(db, uid: bytes) -> None:
    """Lock the database: commit proxies reject every non-lock-aware
    transaction until unlock.  Idempotent under the same UID; refuses if
    locked under a different one."""
    from .system_data import LOCKED_KEY

    async def do(tr):
        tr.lock_aware = True
        cur = await tr.get(LOCKED_KEY)
        if cur is not None and bytes(cur) != uid:
            raise DatabaseLockedByOther(cur)
        tr.set(LOCKED_KEY, uid)
    await db.run(do)


async def unlock_database(db, uid: bytes) -> None:
    """Release the lock.  Refuses under a mismatched UID (someone else's
    lock must not be stomped by a stale script)."""
    from .system_data import LOCKED_KEY

    async def do(tr):
        tr.lock_aware = True
        cur = await tr.get(LOCKED_KEY)
        if cur is not None and bytes(cur) != uid:
            raise DatabaseLockedByOther(cur)
        tr.clear(LOCKED_KEY)
    await db.run(do)
