"""Storage engines and versioned structures.

Reference: REF:fdbserver/VersionedMap.h (MVCC in-memory window) and
REF:fdbserver/IKeyValueStore.h (pluggable persistent engines).

The port serves the in-memory engine only so far; the durable engines
(``lsm``, ``btree``) come with the storage read mirror (ROADMAP A4).
"""

from .versioned_map import VersionedMap

# engine name registry (REF:fdbserver/IKeyValueStore.h openKVStore by
# KeyValueStoreType); names are what `configure storage_engine=...` takes
ENGINE_NAMES = ("memory", "lsm", "btree")


def engine_class(name: str):
    if name == "memory":
        from .kv_store import MemoryKVStore
        return MemoryKVStore
    if name in ENGINE_NAMES:
        raise NotImplementedError(
            f"storage engine {name!r} is not ported yet (ROADMAP A4: "
            "durable storage); the port serves 'memory' only")
    raise ValueError(f"unknown storage engine {name!r}")
