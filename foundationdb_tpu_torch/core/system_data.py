"""System keyspace layout + the txnStateStore materialization step.

Reference: REF:fdbclient/SystemData.cpp (``\\xff/conf/...``,
``\\xff/keyServers/...``) + REF:fdbserver/ApplyMetadataMutation.cpp — the
database configures ITSELF through its own keyspace: configuration lives
in ``\\xff`` keys written by ordinary transactions, and recovery
materializes them into the controller's recruitment plan (the
txnStateStore read).

Here system keys are stored in the storage servers like any other data
(the ``\\xff`` range belongs to the last shard), so they inherit
replication, MVCC and recovery for free; the controller reads them back
at recovery time through the latest-version read surface.
"""

from __future__ import annotations

import dataclasses

CONF_PREFIX = b"\xff/conf/"
KEY_SERVERS_PREFIX = b"\xff/keyServers/"
LAYOUT_KEY = KEY_SERVERS_PREFIX + b"layout"
# desired resolver partition boundaries: encode(list[bytes])
# written by DD's heat-driven rebalance; the NEXT epoch's recruitment
# applies it (each partition's conflict window rebuilds from the tlogs,
# exactly as any recovery rebuilds it)
RESOLVER_BOUNDARIES_KEY = KEY_SERVERS_PREFIX + b"resolverBoundaries"
BACKUP_PREFIX = b"\xff/backup/"
# named mutation-log tags (\xff/backup/tags/<name> -> encode(tag)), so a
# file backup and a DR feed can stream concurrently; the bare
# \xff/backup/tag key is the unnamed legacy slot (name "")
BACKUP_TAGS_PREFIX = BACKUP_PREFIX + b"tags/"
# database lock (REF:fdbclient/SystemData.cpp databaseLockedKey): value is
# the locking UID; commit proxies reject non-lock-aware transactions
LOCKED_KEY = b"\xff/dbLocked"
# change feeds (REF:fdbclient/SystemData.cpp changeFeedPrefix): a feed is
# registered by writing \xff/changeFeeds/<id> -> encode({begin, end}) —
# a state transaction, so every commit proxy applies it at the exact
# commit version and the owning proxy injects PRIVATE_FEED_* markers
# into the owning storage tags' streams.  Destroy = clear the key.
# Pop rides its own key (\xff/changeFeedPop/<id> -> encode(version)) so
# popping never disturbs the registration row.
CHANGE_FEED_PREFIX = b"\xff/changeFeeds/"
CHANGE_FEED_POP_PREFIX = b"\xff/changeFeedPop/"


def change_feed_key(feed_id: bytes) -> bytes:
    return CHANGE_FEED_PREFIX + feed_id


def change_feed_pop_key(feed_id: bytes) -> bytes:
    return CHANGE_FEED_POP_PREFIX + feed_id
# multi-region topology (REF:fdbclient/DatabaseConfiguration.cpp regions
# JSON under \xff/conf/regions): wire-encoded list of region dicts
# ({"id", "priority", "satellite", "satellite_logs"}) — the controller
# reads it at recovery and recruits region-aware (see ClusterConfigSpec)
REGIONS_KEY = CONF_PREFIX + b"regions"


def backup_tag_key(name: str) -> bytes:
    """The \\xff key arming mutation-log tag ``name`` ("" = legacy slot)."""
    return (BACKUP_PREFIX + b"tag") if name == "" \
        else BACKUP_TAGS_PREFIX + name.encode()


# feed-native backup progress: each running backup agent
# periodically writes \xff/backup/progress/<name> ->
# encode({snapshot_version, log_through, bytes, at_version, stopped}) so
# ``cluster.backup`` in status can report snapshot/log frontiers, lag vs
# the committed version, and agent liveness without an agent RPC surface
BACKUP_PROGRESS_PREFIX = BACKUP_PREFIX + b"progress/"


def backup_progress_key(name: str) -> bytes:
    return BACKUP_PROGRESS_PREFIX + name.encode()


# layer progress: layer roles are CLIENT-side constructions
# (index maintainers, read-through caches, watch registries in
# foundationdb_tpu/layers/) with no cluster RPC surface, so — exactly
# like backup progress above — each publishes \xff/layers/progress/<name>
# -> encode({kind, frontier, counters...}) and the ``cluster.layers``
# status rollup reads the range back best-effort, computing lag against
# the committed version at read time.
LAYER_PROGRESS_PREFIX = b"\xff/layers/progress/"


def layer_progress_key(name: str) -> bytes:
    return LAYER_PROGRESS_PREFIX + name.encode()


def decode_backup_tags(rows: list[tuple[bytes, bytes]]) -> dict[str, int]:
    """All armed mutation-log tags from a \\xff range read."""
    from ..rpc.wire import decode
    out: dict[str, int] = {}
    for k, v in rows:
        name = None
        if k == BACKUP_PREFIX + b"tag":
            name = ""
        elif k.startswith(BACKUP_TAGS_PREFIX):
            name = k[len(BACKUP_TAGS_PREFIX):].decode(errors="replace")
        if name is None:
            continue
        try:
            out[name] = int(decode(v))
        except Exception:  # noqa: BLE001 — a bad blob disarms that slot
            continue
    return out

# conf keys the controller honors, mapping to ClusterConfigSpec fields
CONF_FIELDS = ("commit_proxies", "grv_proxies", "resolvers", "logs",
               "log_replication")
# string-valued conf keys (REF:fdbclient/DatabaseConfiguration.cpp
# storageServerStoreType): `configure storage_engine=btree` makes
# DataDistribution migrate every shard onto the new engine live
CONF_STR_FIELDS = ("storage_engine",)


def validate_conf(name: str, val) -> bytes:
    """Validate one configure field and return the encoded value — the
    single validator behind ManagementAPI.configure and the CLI."""
    if name in CONF_STR_FIELDS:
        from ..storage import ENGINE_NAMES
        if name == "storage_engine" and val not in ENGINE_NAMES:
            raise ValueError(f"unknown storage engine {val!r}; "
                             f"one of {ENGINE_NAMES}")
        return str(val).encode()
    if name in CONF_FIELDS:
        return str(int(val)).encode()
    raise ValueError(f"unknown configure field {name!r}; one of "
                     f"{CONF_FIELDS + CONF_STR_FIELDS}")


def conf_key(field: str) -> bytes:
    return CONF_PREFIX + field.encode()


def decode_conf(rows: list[tuple[bytes, bytes]]) -> dict[str, int | str]:
    """``\\xff/conf/...`` rows → {field: value}; unknown/garbage ignored."""
    out: dict[str, int | str] = {}
    for k, v in rows:
        if not k.startswith(CONF_PREFIX):
            continue
        name = k[len(CONF_PREFIX):].decode(errors="replace")
        if name in CONF_STR_FIELDS:
            from ..storage import ENGINE_NAMES
            val = v.decode(errors="replace")
            if name != "storage_engine" or val in ENGINE_NAMES:
                out[name] = val
            continue
        if name not in CONF_FIELDS:
            continue
        try:
            out[name] = int(v)
        except ValueError:
            continue
    return out


def normalize_layout(layout: dict) -> dict:
    """Resolve a layout's in-flight moves for recovery (the MoveKeys
    cleanup recovery performs, REF:fdbserver/MoveKeys.actor.cpp):

    - a move still in its dual-tagged phase (``state == "in"``) is rolled
      BACK: the write team reverts to the source team (the sources hold
      every mutation, because writes were replicated to both teams);
    - a flipped move (``state == "flip"``) is rolled FORWARD: the layout's
      teams already name the destination; only the journal entry drops.

    Returns a plain {boundaries, teams} layout with read == write teams
    and no move journal.  Idempotent."""
    boundaries = [bytes(b) for b in layout["boundaries"]]
    teams = [list(t) for t in layout["teams"]]
    for mv in layout.get("moves") or []:
        if mv.get("state") != "in":
            continue
        b, e = bytes(mv["begin"]), bytes(mv["end"])
        import bisect as _b
        idx = _b.bisect_right(boundaries, b)
        lo = boundaries[idx - 1] if idx > 0 else b""
        hi = boundaries[idx] if idx < len(boundaries) else b"\xff\xff\xff"
        if lo == b and hi == e:
            teams[idx] = list(mv["src"])
    return {"boundaries": boundaries, "teams": teams}


def flip_move_dest_entries(layout: dict) -> list[dict]:
    """Storage entries for destinations of flipped-but-unpublished moves.

    A crash between the flip transaction and the controller's state
    publish leaves the destination replicas known only to the layout's
    move journal; recovery merges these entries into the previous state's
    storage list so the destinations rejoin instead of being refetched
    from sources that already dropped the range."""
    out: list[dict] = []
    for mv in layout.get("moves") or []:
        if mv.get("state") == "flip":
            out.extend(dict(d) for d in mv.get("dest_info", []))
    return out


def spec_with_conf(spec, conf: dict[str, int]):
    """Recruitment spec = static defaults overridden by the database's own
    configuration keys (the DatabaseConfiguration::fromKeyValues analog).
    Values are clamped to sane minimums — a bad conf write must not brick
    recovery."""
    kv = {}
    for field in CONF_FIELDS:
        if field in conf:
            kv[field] = max(1, int(conf[field]))
    for field in CONF_STR_FIELDS:
        if field in conf:
            kv[field] = str(conf[field])
    return dataclasses.replace(spec, **kv) if kv else spec
