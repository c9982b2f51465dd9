"""Shard heat tracking — the load half of data distribution.

Reference: REF:fdbserver/StorageMetrics.actor.cpp (byte/bandwidth
sampling per shard) + REF:fdbserver/DataDistributionTracker.actor.cpp
(shardSplitter consults write bandwidth, not just size) +
REF:fdbserver/Ratekeeper.actor.cpp (queue-pressure rate budget).  The
seed tree split shards on ``logical_bytes`` alone and nothing defended
tail latency when zipfian heat concentrated on one shard: TPC-C's
district hotspot and YCSB zipf-0.99 both sat at pathological abort
rates with every read and write funneling through one storage team.

``ShardHeatTracker`` folds the accounting the storage role already
does — ``total_reads`` bumps in ``get``/``get_values``, mutation counts
in ``_apply_batch`` — into exponentially-decayed per-shard read/write
rates plus a weighted reservoir of sampled keys, so a split point
INSIDE the hot shard is computable (the reservoir's weighted midpoint),
not just "this shard is hot".  The tracker is deliberately cheap (a few
float ops per recorded batch, strided key sampling) and deterministic:
its reservoir draws from a PRIVATE seeded RNG, never the simulator's
global stream, so arming it changes no same-seed sim trace.

Consumers (each behind its own knob, defaults preserving pre-heat
behavior):

- ``DataDistributor`` splits/moves shards sustaining
  ``DD_SHARD_HOT_RW_PER_SEC`` (knob ``DD_SHARD_HEAT_SPLITS``);
- ``Ratekeeper`` arms tag-scoped throttles when one shard's write rate
  alone would wedge its storage queue (``RATEKEEPER_HEAT_THROTTLE``);
- ``ReplicaGroup`` spreads snapshot-safe reads across the team
  (``CLIENT_READ_LOAD_BALANCE``).
"""

from __future__ import annotations

import asyncio
import bisect
import math
import random
import time


def _monotonic_now() -> float:
    """Loop time inside a running loop (VIRTUAL under simulation — rates
    stay deterministic for same-seed runs), wall monotonic outside."""
    try:
        return asyncio.get_running_loop().time()
    except RuntimeError:
        return time.monotonic()


_LN2 = math.log(2.0)


class DecayingRate:
    """Exponentially-decayed event counter read back as events/sec.

    Under a steady rate ``r`` the decayed count converges to
    ``r * tau`` (``tau = halflife / ln 2``), so ``rate() = count / tau``
    — a warm-up-biased-low, O(1)-state estimator.  Decay happens lazily
    at observation time; no timers, no tasks."""

    __slots__ = ("_halflife", "_tau", "_count", "_ts")

    def __init__(self, halflife_s: float) -> None:
        self._halflife = max(halflife_s, 1e-6)
        self._tau = self._halflife / _LN2
        self._count = 0.0
        self._ts: float | None = None

    def _decay_to(self, now: float) -> None:
        if self._ts is None:
            self._ts = now
            return
        dt = now - self._ts
        if dt > 0:
            self._count *= 0.5 ** (dt / self._halflife)
            self._ts = now

    def add(self, n: float, now: float) -> None:
        self._decay_to(now)
        self._count += n

    def rate(self, now: float) -> float:
        """Pure read: decays virtually to ``now`` without mutating, so
        out-of-order observations (status vs ratekeeper polls) compose."""
        if self._ts is None:
            return 0.0
        dt = max(0.0, now - self._ts)
        return self._count * 0.5 ** (dt / self._halflife) / self._tau


class HeatReservoir:
    """Weighted reservoir of sampled keys — the "histogram" a split
    point is computed from.  Bounded at ``cap`` entries; a key already
    sampled accumulates weight in place (zipfian hot keys concentrate
    instead of flooding the reservoir), a new key displaces a random
    slot with probability proportional to its weight share.  The RNG is
    private and seeded, so sampling perturbs no global stream."""

    def __init__(self, cap: int = 64, seed: int = 0) -> None:
        self.cap = max(4, cap)
        self._rng = random.Random(0x5EED ^ seed)
        self._keys: list[bytes] = []
        self._weights: list[float] = []
        self._index: dict[bytes, int] = {}
        self.total_weight = 0.0

    def __len__(self) -> int:
        return len(self._keys)

    def decay(self, factor: float) -> None:
        """Age the histogram: scale every resident weight AND the
        admission denominator.  Without this the reservoir reflects
        LIFETIME heat while the trigger rates are decayed — after a
        workload shift, new hot keys could never displace (or outweigh)
        a long-dead hotspot, and the computed split point would target
        traffic that no longer exists."""
        self.total_weight *= factor
        for i in range(len(self._weights)):
            self._weights[i] *= factor

    def offer(self, key: bytes, weight: float = 1.0) -> None:
        self.total_weight += weight
        i = self._index.get(key)
        if i is not None:
            self._weights[i] += weight
            return
        if len(self._keys) < self.cap:
            self._index[key] = len(self._keys)
            self._keys.append(key)
            self._weights.append(weight)
            return
        # bounded: displace a uniformly random slot with probability
        # cap * w / total — heavy keys get in, trickle keys mostly don't
        if self._rng.random() < min(1.0, self.cap * weight
                                    / max(self.total_weight, 1e-9)):
            i = self._rng.randrange(self.cap)
            self._index.pop(self._keys[i], None)
            self._keys[i] = key
            self._weights[i] = weight
            self._index[key] = i

    def samples(self) -> list[tuple[bytes, float]]:
        return sorted(zip(self._keys, self._weights))

    def split_key(self, begin: bytes, end: bytes) -> bytes | None:
        return weighted_split_key(self.samples(), begin, end)


def weighted_split_key(samples: list[tuple[bytes, float]], begin: bytes,
                       end: bytes) -> bytes | None:
    """The heat midpoint of a sorted ``(key, weight)`` sample set: the
    smallest sampled key with at least half the sampled weight strictly
    below it, clamped strictly inside ``(begin, end)``.

    Returns None when the heat cannot be split by a boundary — fewer
    than 4 samples (no signal), or one single key carrying half the
    weight (the histogram "straddles a single key": both halves of any
    split would leave the hot key's full load on one team, so the
    caller should MOVE the shard instead)."""
    inside = [(k, w) for k, w in samples if begin < k < end or k == begin]
    if len(inside) < 4:
        return None
    total = sum(w for _k, w in inside)
    if total <= 0:
        return None
    if max(w for _k, w in inside) * 2 >= total:
        return None                       # concentrated on one key: move
    acc = 0.0
    for k, w in inside:
        if acc * 2 >= total and begin < k < end:
            return k
        acc += w
    return None


def rebalance_resolver_boundaries(samples: list[tuple[bytes, float]],
                                  boundaries: list[bytes], *,
                                  ratio: float = 2.0,
                                  keyspace_end: bytes = b"\xff\xff\xff",
                                  ) -> list[bytes] | None:
    """Partition-count-preserving rebalance of resolver boundaries: given the
    cluster-wide weighted key samples (the storage
    shard-heat reservoirs, concatenated) and the current interior
    boundaries of N resolver partitions, return a NEW boundary list when
    the hottest partition carries at least ``ratio`` x the mean heat:
    the hot partition splits at its heat midpoint and the coldest
    ADJACENT pair merges, so N stays fixed — resolver count is a
    recruitment-spec constant, only the ranges move.  With N == 2 the
    coldest pair is the whole keyspace and the net effect is simply
    moving the single boundary to the hot side's heat midpoint.

    Returns None when the mesh is balanced, the signal is too thin for
    ``weighted_split_key``, or the result would not be a strictly
    increasing interior boundary list distinct from the current one."""
    n = len(boundaries) + 1
    if n < 2 or not samples:
        return None
    samples = sorted(samples)
    heat = [0.0] * n
    for k, w in samples:
        heat[bisect.bisect_right(boundaries, k)] += w
    total = sum(heat)
    if total <= 0:
        return None
    hot = max(range(n), key=lambda i: heat[i])
    if heat[hot] * n < ratio * total:
        return None                               # balanced enough
    begin = boundaries[hot - 1] if hot > 0 else b""
    end = boundaries[hot] if hot < n - 1 else keyspace_end
    split = weighted_split_key(samples, begin, end)
    if split is None:
        return None
    # merge the coldest adjacent pair: drop the interior boundary j
    # between partitions j and j+1 (the split insertion restores N)
    j = min(range(n - 1), key=lambda i: heat[i] + heat[i + 1])
    new = sorted({b for i, b in enumerate(boundaries) if i != j} | {split})
    if len(new) != n - 1 or new == boundaries \
            or new[0] <= b"" or new[-1] >= keyspace_end:
        return None
    return new


class ShardHeatTracker:
    """Per-storage-server read/write heat over the server's shard.

    Folds the role's existing accounting into decayed rates + a key
    reservoir.  All entry points are O(1) amortized: counts always
    land, keys are sampled every ``SHARD_HEAT_KEY_SAMPLE`` recorded
    ops (strided, not random, so the hot path never draws)."""

    def __init__(self, knobs, tag: int, clock=None) -> None:
        hl = getattr(knobs, "SHARD_HEAT_HALFLIFE", 10.0)
        self.tag = tag
        self._clock = clock or _monotonic_now
        self._halflife = max(hl, 1e-6)
        self._reads = DecayingRate(hl)
        self._writes = DecayingRate(hl)
        self._write_bytes = DecayingRate(hl)
        self._reservoir = HeatReservoir(
            getattr(knobs, "SHARD_HEAT_SAMPLES", 64), seed=tag)
        self._reservoir_aged = None     # last reservoir decay timestamp
        self._stride = max(1, getattr(knobs, "SHARD_HEAT_KEY_SAMPLE", 8))
        self._read_tick = 0
        self._write_tick = 0
        self.total_reads = 0
        self.total_writes = 0

    def _age_reservoir(self, now: float) -> None:
        """Halve the reservoir once per elapsed half-life (amortized:
        called from the strided sample points, not per op) so the
        histogram tracks RECENT heat on the same timescale as the
        rates."""
        if self._reservoir_aged is None:
            self._reservoir_aged = now
            return
        halved = int((now - self._reservoir_aged) / self._halflife)
        if halved > 0:
            self._reservoir.decay(0.5 ** min(halved, 60))
            self._reservoir_aged += halved * self._halflife

    # --- read side (get_value / get_values / get_key_values) ---

    def record_reads(self, n: int, key: bytes | None = None) -> None:
        if n <= 0:
            return
        now = self._clock()
        self._reads.add(n, now)
        self.total_reads += n
        if key is not None:
            self._read_tick += n
            if self._read_tick >= self._stride:
                self._age_reservoir(now)
                self._reservoir.offer(bytes(key), float(self._read_tick))
                self._read_tick = 0

    # --- write side (_apply_batch) ---

    def record_write(self, key: bytes, nbytes: int) -> None:
        now = self._clock()
        self._writes.add(1, now)
        self._write_bytes.add(nbytes, now)
        self.total_writes += 1
        self._write_tick += 1
        if self._write_tick >= self._stride:
            self._age_reservoir(now)
            self._reservoir.offer(bytes(key), float(self._write_tick))
            self._write_tick = 0

    def record_write_batch(self, batch) -> None:
        """One packed ``MutationBatch``: count in O(1) off the blob
        length, sample at most two keys (strided across batches)."""
        n = len(batch)
        if not n:
            return
        now = self._clock()
        self._writes.add(n, now)
        self._write_bytes.add(batch.nbytes, now)
        self.total_writes += n
        self._write_tick += n
        if self._write_tick >= self._stride:
            self._age_reservoir(now)
            w = float(self._write_tick)
            self._write_tick = 0
            if n == 1:
                self._reservoir.offer(bytes(batch.param1(0)), w)
            else:
                self._reservoir.offer(bytes(batch.param1(0)), w / 2)
                self._reservoir.offer(bytes(batch.param1(n // 2)), w / 2)

    # --- the shipped sample (shard_metrics RPC payload) ---

    def rates(self) -> tuple[float, float, float]:
        now = self._clock()
        return (self._reads.rate(now), self._writes.rate(now),
                self._write_bytes.rate(now))

    def snapshot(self, begin: bytes, end: bytes) -> dict:
        r, w, wb = self.rates()
        return {
            "tag": self.tag,
            "shard_begin": begin,
            "shard_end": end,
            "reads_per_sec": round(r, 3),
            "writes_per_sec": round(w, 3),
            "write_bytes_per_sec": round(wb, 3),
            "rw_per_sec": round(r + w, 3),
            "total_reads": self.total_reads,
            "total_writes": self.total_writes,
            "samples": self._reservoir.samples(),
            "heat_split_key": self._reservoir.split_key(begin, end),
        }
