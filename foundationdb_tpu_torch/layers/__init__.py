"""The layer ecosystem — production layers over the core contract.

Reference: SURVEY §5 (FDB is a substrate; real products are LAYERS built
on the transactional contract) and §2.3 (watches).  Everything here is a
CLIENT-side construction: ordinary transactions, the tuple/subspace
encoding, and ONE shared whole-database change-feed consumption core
(:mod:`.feed_consumer`) — no new server role, no new RPC.  Three layers
ride that core:

- :class:`.index.SecondaryIndex` — keeps a secondary-index subspace
  current, either transactionally (index rows written in the SAME commit
  via a transaction commit hook) or asynchronously (feed-driven, with an
  exposed freshness frontier; reads serve at-or-below the frontier and
  fall back to a primary scan when asked for fresher data);
- :class:`.cache.ReadThroughCache` — an invalidating read-through cache
  of versioned entries, evicted by the feed the moment a newer committed
  mutation lands (the millions-of-users read tier);
- :class:`.watches.WatchRegistry` — a ``watch(key)`` client surface with
  at-least-once fire semantics that survives shard moves and recoveries
  because the underlying cursor does.

All three are audited by :class:`.checker.LayerConsistencyChecker`: the
scrubber discipline (core/scrubber.py) applied to derived state — pin a
version, page the authoritative keyspace via packed range reads,
cross-verify index rows / cache entries / pending watches against it,
and name every divergent key exactly (severity-40 ``LayerMismatch``).
Refusals are never mismatches.

Nothing in this package runs unless a layer object is constructed, so
same-seed sim traces with no layers in the workload are bit-identical
regardless of the ``LAYER_*`` knobs (proven by the determinism suite).
"""

from .cache import ReadThroughCache
from .checker import LayerConsistencyChecker
from .feed_consumer import LayerFeedConsumer
from .index import SecondaryIndex
from .watches import WatchRegistry

__all__ = ["LayerFeedConsumer", "SecondaryIndex", "ReadThroughCache",
           "WatchRegistry", "LayerConsistencyChecker"]
