"""Locality API — where keys physically live.

Reference: REF:bindings/python/fdb/locality.py +
REF:fdbclient/NativeAPI.actor.cpp (getAddressesForKey) and the
boundary-keys reader over ``\\xff/keyServers``.  Applications use these
to colocate computation with data and to partition scans along shard
boundaries.
"""

from __future__ import annotations


def _shard_map(db_or_cluster):
    c = getattr(db_or_cluster, "cluster", db_or_cluster)
    return c.shard_map


async def get_addresses_for_key(tr, key: bytes) -> list[str]:
    """Public addresses of the storage replicas serving ``key`` (the
    fdb_transaction_get_addresses_for_key analog).  Takes no read
    conflict, like the reference.  In-process storages (no transport)
    report as "local"."""
    group = tr._cluster.storage_for_key(key)
    out = []
    for r in getattr(group, "replicas", [group]):
        a = getattr(r, "_address", None)
        out.append(f"{a.ip}:{a.port}" if a is not None else "local")
    return out


async def get_boundary_keys(db, begin: bytes, end: bytes) -> list[bytes]:
    """Shard start keys inside [begin, end): the keys at which the
    serving storage team changes.  Scan ranges split on these boundaries
    never cross a shard (REF: fdb.locality.get_boundary_keys)."""
    sm = _shard_map(db)
    starts = [b""] + list(sm.boundaries)
    return [k for k in starts if begin <= k < end]
