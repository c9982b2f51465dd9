"""Storage engines and versioned structures.

Reference: REF:fdbserver/VersionedMap.h (MVCC in-memory window) and
REF:fdbserver/IKeyValueStore.h (pluggable persistent engines).
"""

from .versioned_map import VersionedMap

# engine name registry (REF:fdbserver/IKeyValueStore.h openKVStore by
# KeyValueStoreType); names are what `configure storage_engine=...` takes
ENGINE_NAMES = ("memory", "lsm", "btree")


def engine_class(name: str):
    from .btree import BTreeKVStore
    from .kv_store import MemoryKVStore
    from .lsm import LSMKVStore
    try:
        return {"memory": MemoryKVStore, "lsm": LSMKVStore,
                "btree": BTreeKVStore}[name]
    except KeyError:
        raise ValueError(f"unknown storage engine {name!r}") from None
