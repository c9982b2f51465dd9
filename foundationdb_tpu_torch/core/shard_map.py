"""Static shard map: key-range partitions → storage tags.

Reference: the keyServers/serverKeys system-key mapping
(REF:fdbclient/SystemData.cpp) that DataDistribution maintains and the
commit proxy consults to tag mutations.  This first version is a static
even partition; DataDistribution later rewrites it through the same
interface (splits/moves change boundaries, not callers).
"""

from __future__ import annotations

import bisect

from .data import KeyRange
from .tlog import Tag


class ShardMap:
    def __init__(self, boundaries: list[bytes], shard_tags: list[list[Tag]],
                 keyspace_end: bytes = b"\xff\xff\xff"):
        """boundaries: interior split points (sorted); len(shard_tags) ==
        len(boundaries) + 1.  Shard i covers [b[i-1], b[i]).

        ``shard_tags`` are the WRITE teams (the keyServers mapping: every
        listed tag receives the shard's mutations — during a live move
        that is src+dest, REF:fdbserver/MoveKeys.actor.cpp startMoveKeys).
        Read routing (the serverKeys view) is what the published cluster
        state carries: clients keep reading the sources until the move's
        flip is published, so no separate read-team list is needed here.
        """
        assert len(shard_tags) == len(boundaries) + 1
        self.boundaries = boundaries
        self.shard_tags = shard_tags
        self.keyspace_end = keyspace_end

    @staticmethod
    def even(n_shards: int, tags_per_shard: list[list[Tag]] | None = None,
             keyspace_end: bytes = b"\xff\xff\xff") -> "ShardMap":
        """Split [b'', end) into n byte-prefix shards; default tag i per shard."""
        bounds = [bytes([int(256 * i / n_shards)]) for i in range(1, n_shards)]
        tags = tags_per_shard or [[i] for i in range(n_shards)]
        return ShardMap(bounds, tags, keyspace_end)

    def shard_index(self, key: bytes) -> int:
        return bisect.bisect_right(self.boundaries, key)

    def tags_for_key(self, key: bytes) -> list[Tag]:
        return self.shard_tags[self.shard_index(key)]

    def tags_for_range(self, begin: bytes, end: bytes) -> list[Tag]:
        """Tags of shards intersecting half-open [begin, end)."""
        if begin >= end:
            return []
        lo = self.shard_index(begin)
        # last shard containing a key < end: bisect_left keeps a range
        # ending exactly on a shard boundary out of the following shard
        hi = bisect.bisect_left(self.boundaries, end)
        out: list[Tag] = []
        for i in range(lo, hi + 1):
            for t in self.shard_tags[i]:
                if t not in out:
                    out.append(t)
        return out

    def shard_range(self, i: int) -> KeyRange:
        begin = self.boundaries[i - 1] if i > 0 else b""
        end = self.boundaries[i] if i < len(self.boundaries) else self.keyspace_end
        return KeyRange(begin, end)

    def ranges(self) -> list[tuple[KeyRange, list[Tag]]]:
        return [(self.shard_range(i), self.shard_tags[i])
                for i in range(len(self.shard_tags))]

    def all_tags(self) -> list[Tag]:
        out: list[Tag] = []
        for ts in self.shard_tags:
            for t in ts:
                if t not in out:
                    out.append(t)
        return out


def write_team_drops(old: ShardMap, new: ShardMap
                     ) -> list[tuple[Tag, bytes, bytes]]:
    """Ranges each tag stops receiving writes for under the new map.

    Elementary-interval diff over the union of both maps' boundaries: for
    every interval, any tag in the old write team but not the new one gets
    a (tag, begin, end) drop; adjacent intervals per tag are merged.  The
    commit proxy turns these into PRIVATE_DROP_SHARD mutations riding the
    same version as the layout change, so storage servers relinquish
    ownership at an exact point in the version order
    (REF:fdbserver/ApplyMetadataMutation.cpp krmSetPreviouslyEmptyRange /
    private mutation emission)."""
    points = sorted({b"", *old.boundaries, *new.boundaries})
    end_key = min(old.keyspace_end, new.keyspace_end)
    drops: dict[Tag, list[tuple[bytes, bytes]]] = {}
    for i, b in enumerate(points):
        e = points[i + 1] if i + 1 < len(points) else end_key
        if b >= e:
            continue
        old_t = set(old.shard_tags[old.shard_index(b)])
        new_t = set(new.shard_tags[new.shard_index(b)])
        for t in old_t - new_t:
            spans = drops.setdefault(t, [])
            if spans and spans[-1][1] == b:
                spans[-1] = (spans[-1][0], e)
            else:
                spans.append((b, e))
    return [(t, b, e) for t, spans in sorted(drops.items())
            for b, e in spans]
