#!/usr/bin/env python
"""Perf smokes: guards against the next O(n^2) on the write, read and
commit paths, and against a device path that stops paying.  Seventeen
stages, each a ``*_seconds`` function that runs the workload and returns
(seconds, stats) with its correctness gates asserted in situ, and a
``check_*`` function that prints one line and asserts the budgets and
floors:

- ``apply``: 100k fresh keys through ``StorageServer._apply_batch``
  inside a wall budget.
- ``pipeline``: the in-process commit pipeline (client, GRV and commit
  proxies, sequencer, resolver, TLog, storage apply) under concurrent
  writers, on the exact C++ conflict set.
- ``feed``: the pipeline with a change feed over the written range and
  a live consumer that must see every mutation.
- ``read``: a scalar ``get()`` loop against ``get_multi`` at batch 64
  (byte-identical, >= 3x), then concurrent readers; again on a durable
  lsm cluster whose multiget misses the storage servers' read mirror
  serves (``device/read_serve.py``, kernel ``prefix_search``).
- ``resolve``: the device commit pipeline: the same randomized batches
  through the numpy twin and the ``cuda`` backend under DevicePipeline
  (verdicts bit-identical), then pipelined against the unpipelined
  per-batch loop (>= 2x).
- ``heat``: the shard-heat tracker ranks a zipf-hot shard first, the
  ratekeeper arms a tag throttle, and the clamp sheds tagged admission.
- ``backup``: snapshot plus a whole-db feed tail, restore to a version
  into a fresh cluster, sha256-identical.
- ``scan``: full-table scans on a durable lsm cluster, the packed range
  path against the legacy tuple path (byte-identical, >= 3x).
- ``bigkeys``: a 2M-key columnar key index against its list twin (an
  RSS-per-key ceiling), then the keyspace applied and served.
- ``recover``: a torn-disk power loss under the hostile-disk profile,
  recovery sha256-identical to the acknowledged state.
- ``mvcc``: a 2M-key hot set in the columnar MVCC window against the
  legacy window (RSS ratio, apply+probe pipeline >= 2x).
- ``compact``: sustained lsm ingest, leveled against monolithic
  compaction (write amplification, commit stalls).
- ``observe``: the metrics plane in a seeded simulated cluster (every
  role's cadence, the lag rollup, metrics_tool's reconstruction), and
  its overhead on the apply path.
- ``mesh``: a 2-resolver cluster on a partition-skewed workload, routed
  against broadcast; the hot partition's resolver runs the ``cuda``
  backend, whose fused groups must average >= 1.5 batches.
- ``scrub``: the consistency scrubber's clean pass and key-exact catch
  in a seeded simulated cluster, and its overhead.
- ``devplane``: the sharded read mirror against one directory under
  tail churn, and the verdict-bitmask readback against raw vectors.
- ``layers``: the client layer stack (feed consumer, index, cache,
  watches, checker) in a seeded simulated cluster.

Every stage takes ``device``: ``None`` is the CUDA card (without one the
stage raises; nothing falls back to the CPU), ``torch.device("cpu")``
runs the kernels' plain versions.  The stage hands it to every
``Cluster``, ``SimulatedCluster``, storage server and conflict backend
it builds.  The host stages keep the exact C++ set (``cpp``) for their
resolvers where the reference does, so on the card only the storage
servers' read mirrors and the ``cuda`` backends of ``read``, ``scan``,
``mesh`` and ``devplane`` launch kernels.  The simulated stages
(``observe``, ``scrub``, ``layers``) start from a fresh process's
state (BUGGIFY off, no API version, span and probe counters at zero),
so each gives the same stats after any other stage.

One divergence from the JAX package: its ``devplane`` asserts at least
two (forced) devices and puts one mirror shard on each.  Here the
``DEVPLANE_SHARDS`` shards are prefix tensors on one card
(``bench/device_plane.py``), so the stage asserts the sharded mirror's
shard count, and ``stats["devices"]`` reports the cards it sees.

    python -m foundationdb_tpu_torch.tools.perf_smoke [--stage NAME|all]
        [--device cuda|cpu]

runs one stage or all of them (the default), on the card by default.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import math
import os
import time

import torch

DEFAULT_KEYS = 100_000
DEFAULT_BUDGET_S = 10.0
PIPE_TXNS = 400
PIPE_CLIENTS = 32
PIPE_BUDGET_S = 60.0
FEED_TXNS = 300
FEED_CLIENTS = 16
FEED_BUDGET_S = 60.0
READ_ROWS = 4096
READ_OPS = 1536             # keys probed per side (24 x 64-key batches)
READ_BATCH = 64             # multiget batch size (acceptance: >= 32)
READ_READERS = 8
READ_BUDGET_S = 60.0
READ_SPEEDUP_FLOOR = 3.0    # multiget keys/s vs scalar get()/s
RESOLVE_BATCHES = 96
RESOLVE_TXNS = 16           # per batch (RESOLVER_BATCH_TXNS for the run)
RESOLVE_BUDGET_S = 150.0
RESOLVE_AB_FLOOR = 2.0      # pipelined vs unpipelined txns/s
HEAT_HOT_TXNS = 300         # tagged commits into the hot shard
HEAT_COLD_TXNS = 60         # untagged commits spread over cold shards
HEAT_READS = 600            # zipf-shaped point reads on the hot shard
HEAT_BUDGET_S = 60.0
HEAT_RANK_MARGIN = 3.0      # hot shard rw rate vs the next-hottest
BACKUP_TXNS = 150           # commits per phase (pre-snapshot / post)
BACKUP_CLIENTS = 8
BACKUP_BUDGET_S = 90.0
RECOVER_TXNS = 150          # acked commits before the torn-disk kill
RECOVER_CLIENTS = 8
RECOVER_BUDGET_S = 90.0     # doubles as the hard wedge deadline
SCAN_ROWS = 24_000          # rows loaded through real commits
SCAN_CHUNK = 512            # per-fetch row limit, pinned via the byte budget
SCAN_SWEEPS = 3             # full-table sweeps per side of the A/B
SCAN_BUDGET_S = 90.0        # doubles as the hard wedge deadline
SCAN_SPEEDUP_FLOOR = 3.0    # packed rows/s vs legacy rows/s
BIG_KEYS = 2_000_000        # the 10M-key memory wall, scaled to tier-1 cost
BIG_BUDGET_S = 420.0        # doubles as the hard wedge deadline
BIG_RSS_PER_KEY = 40.0      # columnar index RSS overhead ceiling, B/key
BIG_READ_KEYS = 4096        # point/multiget probes over the big keyspace
BIG_SCAN_ROWS = 200_000     # packed-vs-legacy scan subrange
MVCC_KEYS = 2_000_000       # hot set held in the MVCC window
MVCC_BUDGET_S = 300.0       # doubles as the hard wedge deadline
MVCC_PIPELINE_FLOOR = 2.0   # columnar vs legacy apply+probe pipeline
MVCC_RSS_RATIO_CEIL = 0.5   # columnar window RSS overhead vs legacy
MVCC_PROBE_KEYS = 65_536    # get2_batch probes per side of the A/B
MVCC_PROBE_BATCH = 1024     # probe batch size (the vectorized shape)
MVCC_SCAN_ROWS = 100_000    # byte-identity range sweep
MVCC_SMALL_BATCH = 64       # engine-less point-probe batch (the
#                             recent-hit cache shape)
MVCC_SMALL_PROBE_FLOOR = 0.6  # columnar vs legacy small-batch probe
#                             keys/s — the recent-hit cache must keep
#                             ≤64-key probes from losing to the legacy
#                             dict hit
COMPACT_COMMITS = 3200      # sustained-ingest commits per twin
COMPACT_KEYS_PER = 40       # ops per commit
COMPACT_KEYSPACE = 200_000  # mostly-fresh keyspace: the dataset GROWS,
#                             so each monolithic merge-all rewrites an
#                             ever-larger whole (the 10M-key wall shape)
COMPACT_PROBE_KEYS = 2048   # byte-identity point probes per twin
COMPACT_BUDGET_S = 240.0    # doubles as the hard wedge deadline
COMPACT_WRITE_AMP_CEIL = 0.5  # leveled write amp vs the monolithic twin
COMPACT_STALL_RATIO_CEIL = 0.2  # leveled commit p99 vs monolithic max
COMPACT_STALL_FLOOR_MS = 25.0   # absolute noise floor for that bound
OBSERVE_SIM_SECONDS = 8.0     # virtual seconds the cadence sim records
OBSERVE_INTERVAL_S = 0.5      # METRICS_INTERVAL for the cadence sim
OBSERVE_AB_KEYS = 60_000      # keys per side of the overhead A/B
OBSERVE_AB_RUNS = 3           # alternating runs per side (min-of-N)
OBSERVE_AB_INTERVAL_S = 0.02  # emitter cadence during the A/B (dozens of
#                               emissions inside the measured window)
OBSERVE_OVERHEAD_CEIL = 1.10  # plane-on / plane-off apply wall ratio
OBSERVE_OVERHEAD_SLACK_S = 0.10  # absolute floor under the ratio (noise)
OBSERVE_BUDGET_S = 180.0      # doubles as the hard wedge deadline
MESH_SECONDS = 1.5            # measured window per A/B side (real clock)
MESH_WARMUP_S = 0.8           # per-side warmup before stats reset
MESH_CLIENTS = 96
MESH_RATIO_FLOOR = 1.1        # routed vs broadcast commit txns/s
MESH_HEADER_FRAC_FLOOR = 0.5  # cold partition's header-only send share
MESH_GROUP_MEAN_FLOOR = 1.5   # live-path fusion must actually engage
MESH_BUDGET_S = 240.0         # doubles as the hard wedge deadline
SCRUB_KEYS = 48               # rows the detection sim seeds
SCRUB_SIM_PAGE_ROWS = 8       # small pages so one shard spans many
SCRUB_SIM_MAX_PAGES = 4       # ...and many chunks (the `more` path)
SCRUB_WAIT_S = 120.0          # virtual-clock ceiling per wait phase
SCRUB_AB_SECONDS = 6.0        # virtual seconds per overhead-twin side
SCRUB_AB_KEYS = 64            # rows each overhead twin writes
SCRUB_OVERHEAD_CEIL = 1.60    # scrub-on / scrub-off sim wall ratio
SCRUB_OVERHEAD_SLACK_S = 5.0  # absolute floor under the ratio (the
#                               twins are whole recruited sims; box
#                               noise on a run that short is seconds)
SCRUB_BUDGET_S = 240.0        # doubles as the hard wedge deadline
DEVPLANE_MIRROR_KEYS = 120_000  # base keyspace behind the read mirror
DEVPLANE_ROUNDS = 12          # churn rounds (each bumps the index gen)
DEVPLANE_CHURN_KEYS = 400     # tail-localized inserts per churn round
DEVPLANE_PROBES = 512         # keys per probe batch
DEVPLANE_BATCHES_PER_ROUND = 2  # probe batches between churn rounds
DEVPLANE_SHARDS = 4           # mirror shards (prefix tensors on one card)
DEVPLANE_MIRROR_FLOOR = 1.5   # sharded device-served batches vs twin
DEVPLANE_VERDICT_BATCHES = 48  # proxy batches through the pipeline A/B
DEVPLANE_VERDICT_TXNS = 64    # txns per batch (B for the run)
DEVPLANE_BITMASK_FLOOR = 4.0  # raw readback bytes/txn vs packed
DEVPLANE_BUDGET_S = 240.0     # doubles as the hard wedge deadline
LAYERS_KEYS = 400             # zipf keyspace behind the read-through cache
LAYERS_READS = 3000           # zipf-shaped ops through the cache tier
LAYERS_WRITE_FRACTION = 0.05  # invalidating-writer share of those ops
LAYERS_ZIPF_S = 0.99          # the acceptance skew (zipf-0.99)
LAYERS_HIT_RATE_FLOOR = 0.80  # cache hit rate under that skew
LAYERS_WAIT_S = 120.0         # virtual-clock ceiling per wait phase
LAYERS_BUDGET_S = 240.0       # doubles as the hard wedge deadline


def storage_apply_seconds(n_keys: int = DEFAULT_KEYS,
                          batch: int = 2048,
                          device=None) -> tuple[float, dict]:
    """Seconds to push ``n_keys`` fresh-key SETs through the storage
    server's batched apply path, plus the server's apply metrics."""
    from ..core.data import KeyRange, Mutation
    from ..core.storage_server import StorageServer
    from ..core.tlog import TLog
    from ..ops.conflict_torch import default_device
    from ..runtime.knobs import Knobs

    device = default_device(device)

    async def main() -> tuple[float, dict]:
        knobs = Knobs()
        ss = StorageServer(knobs, 0, KeyRange(b"", b"\xff"), TLog(knobs),
                           device=device)
        # multiplicative-hash ids: distinct keys, random insertion order
        # (sorted arrival would hide a quadratic insert's memmove cost)
        keys = [b"smoke%010d" % ((i * 2654435761) % (1 << 33))
                for i in range(n_keys)]
        value = b"x" * 64
        elapsed = 0.0
        version = 0
        for start in range(0, n_keys, batch):
            version += 1
            muts = [Mutation.set(k, value)
                    for k in keys[start:start + batch]]
            t0 = time.perf_counter()
            ss._apply_batch([(version, muts)])
            elapsed += time.perf_counter() - t0
        metrics = await ss.metrics()
        assert len(ss.vmap) == len(set(keys)), "apply lost keys"
        return elapsed, metrics

    return asyncio.run(main())


def check(n_keys: int = DEFAULT_KEYS, budget_s: float = DEFAULT_BUDGET_S,
          quiet: bool = False, device=None) -> float:
    """Run the smoke; raises AssertionError past the budget."""
    elapsed, metrics = storage_apply_seconds(n_keys, device=device)
    if not quiet:
        print(f"[perf_smoke] {n_keys} fresh keys applied in {elapsed:.3f}s "
              f"({n_keys / elapsed / 1e3:.0f}k keys/s), "
              f"index merges={metrics['index_merges']} "
              f"({metrics['index_merge_ms']:.1f}ms), "
              f"apply max={metrics['apply_batch_max_ms']:.1f}ms")
    assert elapsed < budget_s, (
        f"apply-path throughput regression: {n_keys} fresh keys took "
        f"{elapsed:.1f}s (budget {budget_s:.0f}s) — the last time this "
        f"shape went quadratic it was bisect.insort per key (r5)")
    return elapsed


def commit_pipeline_seconds(n_txns: int = PIPE_TXNS,
                            n_clients: int = PIPE_CLIENTS,
                            deadline_s: float | None = None,
                            device=None) -> tuple[float, dict]:
    """Wall seconds to commit ``n_txns`` write transactions through a
    fresh in-process cluster (proxy → resolver → TLog → storage), plus
    end-of-run stats.  Every commit is awaited at the client boundary,
    and storage must have APPLIED the final version before the clock
    stops — the whole pipeline is inside the measured window.

    ``deadline_s`` bounds the whole run: a WEDGED pipeline (deadlock,
    stalled storage pull — the class this guard exists for) raises
    AssertionError instead of hanging the test runner forever."""
    from ..client.transaction import Transaction
    from ..core.cluster import Cluster, ClusterConfig
    from ..ops.conflict_torch import default_device
    from ..runtime.errors import FdbError
    from ..runtime.knobs import Knobs

    device = default_device(device)
    # the exact C++ conflict set (what the bench's cpp side runs); the
    # numpy twin's padded window rescans dominate the measurement long
    # before the pipeline itself does, so only fall back if the native
    # build is genuinely unavailable
    knobs = Knobs()
    try:
        from ..ops.conflict_cpp import CppConflictSet
        CppConflictSet()
        knobs = knobs.override(RESOLVER_CONFLICT_BACKEND="cpp")
    except Exception:  # noqa: BLE001 — numpy twin, generous budget
        pass

    async def main() -> tuple[float, dict]:
        cluster = Cluster(ClusterConfig(), knobs, device=device)
        cluster.start()
        committed = 0
        retried = 0
        issued = iter(range(n_txns))
        t0 = time.perf_counter()

        async def client(cid: int) -> None:
            nonlocal committed, retried
            tr = Transaction(cluster)
            for i in issued:
                while True:
                    try:
                        tr.set(b"pipe%08d" % i, b"v" * 64)
                        tr.set(b"pipe-b%08d" % i, b"w" * 64)
                        await tr.commit()
                        committed += 1
                        tr.reset()
                        break
                    except FdbError as e:
                        retried += 1
                        await tr.on_error(e)

        async def drive() -> None:
            await asyncio.gather(*(client(c) for c in range(n_clients)))
            # commit versions must be APPLIED on storage (not only logged)
            tip = cluster.sequencer.committed_version
            while min(s.version for s in cluster.storage_servers) < tip:
                await asyncio.sleep(0.01)

        try:
            await asyncio.wait_for(drive(), deadline_s)
        except asyncio.TimeoutError:
            await cluster.stop()
            raise AssertionError(
                f"commit pipeline wedged: {committed}/{n_txns} txns "
                f"committed when the {deadline_s:.0f}s deadline hit — a "
                f"deadlock or stalled storage pull, not just slowness"
            ) from None
        elapsed = time.perf_counter() - t0
        stats = {
            "committed": committed,
            "retried": retried,
            "tps": committed / elapsed if elapsed else 0.0,
            "storage_version": min(s.version
                                   for s in cluster.storage_servers),
            "mutations_applied": sum(
                s.apply_meter.count for s in cluster.storage_servers),
        }
        await cluster.stop()
        return elapsed, stats

    return asyncio.run(main())


def check_pipeline(n_txns: int = PIPE_TXNS, n_clients: int = PIPE_CLIENTS,
                   budget_s: float = PIPE_BUDGET_S,
                   quiet: bool = False, device=None) -> float:
    """Run the commit-pipeline smoke; raises AssertionError past the
    budget (a generous floor: ~1-2s measured, minutes when an O(n²)
    shape lands anywhere on the commit path).  The budget doubles as a
    hard deadline so a wedged pipeline fails instead of hanging CI."""
    elapsed, stats = commit_pipeline_seconds(n_txns, n_clients,
                                             deadline_s=budget_s,
                                             device=device)
    if not quiet:
        print(f"[perf_smoke] commit pipeline: {stats['committed']} txns in "
              f"{elapsed:.3f}s ({stats['tps']:.0f} tps, "
              f"{stats['retried']} retries, "
              f"{stats['mutations_applied']} mutations applied)")
    assert stats["committed"] == n_txns, stats
    assert elapsed < budget_s, (
        f"commit-pipeline throughput regression: {n_txns} txns took "
        f"{elapsed:.1f}s (budget {budget_s:.0f}s) — proxy tagging, TLog "
        f"accounting, or storage apply grew a quadratic shape")
    return elapsed


def feed_tail_seconds(n_txns: int = FEED_TXNS, n_clients: int = FEED_CLIENTS,
                      deadline_s: float | None = None,
                      device=None) -> tuple[float, dict]:
    """Wall seconds for a live consumer to observe EVERY mutation of
    ``n_txns`` write transactions through a change feed armed over the
    written range — the full capture → retain → stream → cursor-merge
    path on top of the commit pipeline.  The clock stops when the
    consumer has drained through the last commit's version, so feed lag
    is inside the measured window."""
    from ..client.database import Database
    from ..client.transaction import Transaction
    from ..core.cluster import Cluster, ClusterConfig
    from ..ops.conflict_torch import default_device
    from ..runtime.errors import FdbError
    from ..runtime.knobs import Knobs

    device = default_device(device)
    knobs = Knobs()
    try:
        from ..ops.conflict_cpp import CppConflictSet
        CppConflictSet()
        knobs = knobs.override(RESOLVER_CONFLICT_BACKEND="cpp")
    except Exception:  # noqa: BLE001 — numpy twin, generous budget
        pass

    async def main() -> tuple[float, dict]:
        cluster = Cluster(ClusterConfig(storage_servers=2), knobs,
                          device=device)
        cluster.start()
        db = Database(cluster)
        await db.create_change_feed(b"smoke-feed", b"feed", b"feee")
        committed = 0
        max_version = 0
        issued = iter(range(n_txns))
        t0 = time.perf_counter()

        async def client(cid: int) -> None:
            nonlocal committed, max_version
            tr = Transaction(cluster)
            for i in issued:
                while True:
                    try:
                        tr.set(b"feed%08d" % i, b"v" * 64)
                        tr.set(b"feed-b%08d" % i, b"w" * 64)
                        max_version = max(max_version, await tr.commit())
                        committed += 1
                        tr.reset()
                        break
                    except FdbError as e:
                        await tr.on_error(e)

        seen = 0

        async def consume(cur) -> None:
            nonlocal seen
            while committed < n_txns or cur.version <= max_version:
                for _v, batch in await cur.next():
                    seen += len(batch)

        async def drive() -> None:
            cur = db.read_change_feed(b"smoke-feed")
            consumer = asyncio.ensure_future(consume(cur))
            await asyncio.gather(*(client(c) for c in range(n_clients)))
            await consumer

        try:
            await asyncio.wait_for(drive(), deadline_s)
        except asyncio.TimeoutError:
            await cluster.stop()
            raise AssertionError(
                f"feed tail wedged: consumer saw {seen} mutations of "
                f"{committed * 2} committed when the {deadline_s:.0f}s "
                f"deadline hit — capture, stream, or heartbeat stalled"
            ) from None
        elapsed = time.perf_counter() - t0
        stats = {
            "committed": committed,
            "mutations_seen": seen,
            "feed_mutations_per_sec": seen / elapsed if elapsed else 0.0,
        }
        await cluster.stop()
        return elapsed, stats

    return asyncio.run(main())


def check_feed(n_txns: int = FEED_TXNS, n_clients: int = FEED_CLIENTS,
               budget_s: float = FEED_BUDGET_S, quiet: bool = False,
               device=None) -> float:
    """Run the feed-tail smoke; raises AssertionError past the budget or
    on an incomplete stream."""
    elapsed, stats = feed_tail_seconds(n_txns, n_clients,
                                       deadline_s=budget_s, device=device)
    if not quiet:
        print(f"[perf_smoke] feed tail: {stats['mutations_seen']} mutations "
              f"streamed in {elapsed:.3f}s "
              f"({stats['feed_mutations_per_sec']:.0f} muts/s)")
    assert stats["committed"] == n_txns, stats
    assert stats["mutations_seen"] == 2 * n_txns, (
        f"feed stream incomplete: {stats['mutations_seen']} of "
        f"{2 * n_txns} committed mutations delivered")
    assert elapsed < budget_s, (
        f"feed-tail throughput regression: {n_txns} txns took "
        f"{elapsed:.1f}s (budget {budget_s:.0f}s) — capture select, "
        f"retention scan, or the stream read grew a quadratic shape")
    return elapsed


def read_path_seconds(n_rows: int = READ_ROWS, n_ops: int = READ_OPS,
                      batch: int = READ_BATCH,
                      n_readers: int = READ_READERS,
                      deadline_s: float | None = None,
                      storage_engine: str | None = None,
                      device=None) -> tuple[float, dict]:
    """Wall seconds for the read-path smoke: ``n_rows`` loaded through
    real commits, one reader measuring a scalar ``get()`` loop vs
    ``get_multi`` at ``batch`` over the SAME keys (byte-identical
    results asserted in situ), then ``n_readers`` concurrent clients
    mixing coalesced point reads with multigets.  Returns (total
    elapsed, stats incl. the batched-vs-scalar speedup).

    ``storage_engine`` (e.g. "lsm"): run on a DURABLE cluster with a
    shrunk MVCC window so the loaded rows age into the engine before the
    measurement — the multiget misses then resolve through the engine's
    sparse index, served by the storage servers' read mirrors on
    ``device`` (``device_read_batches`` in the stats proves it served)."""
    from ..client.transaction import Transaction
    from ..core.cluster import Cluster, ClusterConfig
    from ..ops.conflict_torch import default_device
    from ..runtime.errors import FdbError
    from ..runtime.knobs import Knobs

    device = default_device(device)
    knobs = Knobs()
    if storage_engine:
        knobs = knobs.override(STORAGE_ENGINE=storage_engine,
                               STORAGE_VERSION_WINDOW=1_000,
                               STORAGE_DURABILITY_LAG=0.05,
                               # a 64-key client multiget splits across
                               # the 2 shards: ~32 missing keys per
                               # server-side batch must still clear the
                               # device threshold
                               STORAGE_DEVICE_READ_MIN_BATCH=16)
    try:
        from ..ops.conflict_cpp import CppConflictSet
        CppConflictSet()
        knobs = knobs.override(RESOLVER_CONFLICT_BACKEND="cpp")
    except Exception:  # noqa: BLE001 — numpy twin, generous budget
        pass

    def key(i: int) -> bytes:
        return b"read%08d" % (i % n_rows)

    if storage_engine:
        # small lsm thresholds (the scan-smoke discipline): the load
        # must flush into SORTED RUNS — a pure-memtable engine has no
        # sparse index and the device mirror would sit idle
        from ..storage import lsm as lsm_mod
        saved = (lsm_mod._MEMTABLE_BYTES, lsm_mod._BLOCK_BYTES,
                 lsm_mod._MAX_RUNS)
        lsm_mod._MEMTABLE_BYTES = 8 << 10
        lsm_mod._BLOCK_BYTES = 2 << 10
        lsm_mod._MAX_RUNS = 16
    else:
        saved = None

    async def main() -> tuple[float, dict]:
        if storage_engine:
            from ..runtime.files import SimFileSystem
            cluster = await Cluster.create(
                ClusterConfig(storage_servers=2), knobs,
                fs=SimFileSystem(), data_dir="read-db", device=device)
        else:
            cluster = Cluster(ClusterConfig(storage_servers=2), knobs,
                              device=device)
        cluster.start()
        t_all = time.perf_counter()

        async def loader(lo: int, hi: int) -> None:
            tr = Transaction(cluster)
            for start in range(lo, hi, 256):
                while True:
                    for i in range(start, min(start + 256, hi)):
                        tr.set(key(i), b"v%08d" % i)
                    try:
                        await tr.commit()
                        break
                    except FdbError as e:
                        await tr.on_error(e)
                tr.reset()

        span = (n_rows + 7) // 8
        await asyncio.gather(*(loader(j * span, min((j + 1) * span, n_rows))
                               for j in range(8)))
        if storage_engine:
            # rows must live in the ENGINE before the measurement (the
            # sparse-index probe is the point); proxies keep empty
            # version batches flowing, so the floor advances on its own
            tip = cluster.sequencer.committed_version
            while any(s.durable_version < tip
                      for s in cluster.storage_servers):
                await asyncio.sleep(0.05)
            # the tiny window drove the drain; the measurement must not
            # race the still-advancing floor (versions track the wall
            # clock, so a 1k window is milliseconds wide) — widen it
            # back on the SHARED knobs object every role holds
            knobs.STORAGE_VERSION_WINDOW = Knobs().STORAGE_VERSION_WINDOW

        # --- scalar vs multiget, one reader, identical key stream ---
        tr = Transaction(cluster)
        probe = [key(i * 2654435761) for i in range(n_ops)]
        if storage_engine:
            # warm the device mirror (the resolve stage's warmup
            # discipline): the first batch pays a one-time upload that
            # is not the steady state the A/B measures
            for _ in range(3):
                await tr.get_multi(sorted(set(probe[:batch])),
                                   snapshot=True)
        t0 = time.perf_counter()
        scalar = []
        for k in probe:
            scalar.append(await tr.get(k, snapshot=True))
        t_scalar = time.perf_counter() - t0
        t0 = time.perf_counter()
        batched = []
        for start in range(0, n_ops, batch):
            batched.extend(await tr.get_multi(probe[start:start + batch],
                                              snapshot=True))
        t_multi = time.perf_counter() - t0
        assert batched == scalar, \
            "multiget diverged from the scalar get() loop"
        assert all(v is not None for v in scalar), "load lost rows"

        # --- concurrent readers: coalesced points + multigets ---
        async def reader(rid: int) -> int:
            from ..runtime.errors import FdbError
            tr = Transaction(cluster)
            seen = 0
            for round_ in range(6):
                ks = [key((rid * 131 + round_ * 977 + j * 37) * 2654435761)
                      for j in range(batch)]
                while True:
                    try:
                        got = await tr.get_multi(sorted(set(ks)),
                                                 snapshot=True)
                        pts = await asyncio.gather(
                            *(tr.get(k, snapshot=True) for k in ks[:16]))
                        break
                    except FdbError as e:
                        # a shrunk MVCC window (the lsm pass) can age the
                        # held version out mid-round: standard retry
                        await tr.on_error(e)
                seen += len(got)
                assert all(v is not None for v in pts)
                seen += len(pts)
            return seen

        t0 = time.perf_counter()
        seen = sum(await asyncio.gather(*(reader(r)
                                          for r in range(n_readers))))
        t_conc = time.perf_counter() - t0
        co = getattr(cluster, "_read_coalescer", None)
        devs = [s._device_reads for s in cluster.storage_servers
                if s._device_reads is not None]
        stats = {
            "scalar_reads_per_sec": n_ops / t_scalar if t_scalar else 0.0,
            "multiget_keys_per_sec": n_ops / t_multi if t_multi else 0.0,
            "speedup": (t_scalar / t_multi) if t_multi else 0.0,
            "concurrent_reads": seen,
            "concurrent_s": t_conc,
            "device_read_active": bool(devs),
            "device_read_batches": sum(d.served_batches for d in devs),
            **(co.stats() if co is not None else {}),
        }
        elapsed = time.perf_counter() - t_all
        await cluster.stop()
        return elapsed, stats

    async def bounded():
        return await asyncio.wait_for(main(), deadline_s)

    try:
        return asyncio.run(bounded())
    except asyncio.TimeoutError:
        raise AssertionError(
            f"read smoke wedged: the {deadline_s:.0f}s deadline hit — "
            f"a stalled coalescer flush or batched probe, not just "
            f"slowness") from None
    finally:
        if saved is not None:
            (lsm_mod._MEMTABLE_BYTES, lsm_mod._BLOCK_BYTES,
             lsm_mod._MAX_RUNS) = saved


def check_read(budget_s: float = READ_BUDGET_S, quiet: bool = False,
               device=None) -> float:
    """Run the read-path smoke; raises AssertionError past the budget,
    below the batched-vs-scalar speedup floor, or when the lsm pass's
    read mirror served no batch."""
    elapsed, stats = read_path_seconds(deadline_s=budget_s, device=device)
    if not quiet:
        print(f"[perf_smoke] read path: scalar "
              f"{stats['scalar_reads_per_sec']:.0f} keys/s, multiget "
              f"{stats['multiget_keys_per_sec']:.0f} keys/s "
              f"({stats['speedup']:.1f}x), batches mean="
              f"{stats.get('read_batch_mean')} max="
              f"{stats.get('read_batch_max')}")
    assert elapsed < budget_s, (
        f"read-path throughput regression: the smoke took {elapsed:.1f}s "
        f"(budget {budget_s:.0f}s) — client coalescing, wire packing, or "
        f"the batched vmap/engine probes grew an O(n)-per-key shape")
    assert stats["speedup"] >= READ_SPEEDUP_FLOOR, (
        f"multiget speedup {stats['speedup']:.2f}x under the "
        f"{READ_SPEEDUP_FLOOR:.0f}x floor vs the scalar get() loop at "
        f"batch {READ_BATCH} — the batched read path lost its edge")
    # the same shape on a DURABLE lsm cluster: the multiget misses
    # resolve through the columnar sparse index with the device gather
    # active, and the batched edge must hold there too
    elapsed2, s2 = read_path_seconds(deadline_s=budget_s,
                                     storage_engine="lsm", device=device)
    if not quiet:
        print(f"[perf_smoke] read path (lsm): scalar "
              f"{s2['scalar_reads_per_sec']:.0f} keys/s, multiget "
              f"{s2['multiget_keys_per_sec']:.0f} keys/s "
              f"({s2['speedup']:.1f}x), device batches "
              f"{s2['device_read_batches']} "
              f"(active={s2['device_read_active']})")
    assert elapsed2 < budget_s, (
        f"lsm read pass took {elapsed2:.1f}s (budget {budget_s:.0f}s)")
    assert s2["speedup"] >= READ_SPEEDUP_FLOOR, (
        f"multiget speedup {s2['speedup']:.2f}x under the "
        f"{READ_SPEEDUP_FLOOR:.0f}x floor on the lsm engine — the "
        f"sparse-index/device read path lost the batched edge")
    # the mirror is always there to serve: no quiet way past it
    assert s2["device_read_active"] and s2["device_read_batches"] > 0, (
        "DeviceReadServer never served a batch on the lsm cluster — "
        "the device gather failed to activate over the sparse index")
    return elapsed



def resolve_knobs(batch_txns: int = RESOLVE_TXNS):
    """A ring of 2048 slots at 16 txns x 2 ranges evicts well inside the
    run; the 400-version life window plus the stale snapshots force
    TOO_OLD verdicts through both floor mechanisms."""
    from ..runtime.knobs import Knobs
    return Knobs().override(
        RESOLVER_BATCH_TXNS=batch_txns, RESOLVER_RANGES_PER_TXN=2,
        CONFLICT_RING_CAPACITY=2048, KEY_ENCODE_BYTES=16,
        CONFLICT_WINDOW_SLOTS=64,
        MAX_WRITE_TRANSACTION_LIFE_VERSIONS=400)


def _resolve_workload(n_batches: int, batch_txns: int, ranges: int,
                      seed: int) -> tuple[list, list[int]]:
    """Randomized conflict batches exercising every verdict class: hot
    overlapping point ranges (CONFLICT), fresh keys (COMMITTED), and
    snapshots stale enough to cross the too-old floor — both the
    MAX_WRITE_TRANSACTION_LIFE window floor the pipeline slides between
    dispatches and the ring-EVICTION floor (the capacity forces
    evictions mid-run, the resolve_many per-batch eviction-edge path)."""
    import random

    from ..ops.batch import TxnRequest

    rng = random.Random(seed)
    batches, versions = [], []
    v = 1_000
    for _ in range(n_batches):
        v += rng.randint(1, 30)
        txns = []
        for _ in range(batch_txns):
            def rg():
                k = b"rk%06d" % rng.randint(0, 400)
                return (k, k + b"\x00")
            snap = v - rng.choice([1, 2, 5, 50, 200, 500, 1500])
            txns.append(TxnRequest(
                [rg() for _ in range(rng.randint(1, ranges))],
                [rg() for _ in range(rng.randint(1, ranges))], snap))
        batches.append(txns)
        versions.append(v)
    return batches, versions


def backend(kind: str, knobs, device):
    """The ``kind`` conflict backend at ``knobs``; ``cuda`` on ``device``."""
    from ..ops.backends import make_conflict_backend
    return make_conflict_backend(
        knobs.override(RESOLVER_CONFLICT_BACKEND=kind),
        device=device if kind == "cuda" else None)


async def run_pipe(kind: str, knobs, batches: list, versions: list,
                   device=None) -> tuple[list, float, dict]:
    """Every batch through one DevicePipeline over a fresh ``kind``
    backend: (verdict rows, seconds, the pipeline's metrics)."""
    from ..device.pipeline import DevicePipeline
    pipe = DevicePipeline(backend(kind, knobs, device), knobs)
    t0 = time.perf_counter()
    futs = [pipe.submit(t, v) for t, v in zip(batches, versions)]
    rows = [await f for f in futs]
    elapsed = time.perf_counter() - t0
    await pipe.close()
    return rows, elapsed, pipe.metrics()


async def run_serial(kind: str, knobs, batches: list, versions: list,
                     device=None) -> tuple[list, float]:
    """The unpipelined baseline: one dispatch per batch, verdicts synced
    before the next submit, the serial path's one-batch-lag floor
    schedule."""
    from ..ops.backends import resolve_begin
    be = backend(kind, knobs, device)
    window = knobs.MAX_WRITE_TRANSACTION_LIFE_VERSIONS
    t0 = time.perf_counter()
    rows = []
    last = 0
    for t, v in zip(batches, versions):
        floor = last - window
        if floor > 0:
            be.set_oldest_version(floor)
        last = v
        rows.append(await resolve_begin(be, t, v))
    return rows, time.perf_counter() - t0


def flat(rows: list) -> list[int]:
    return [x for r in rows for x in r]


def resolve_pipeline_seconds(n_batches: int = RESOLVE_BATCHES,
                             batch_txns: int = RESOLVE_TXNS,
                             deadline_s: float | None = None,
                             device=None) -> tuple[float, dict]:
    """The device-commit-pipeline smoke.  Same randomized batches three
    ways:

    - CPU twin (``numpy`` backend) through DevicePipeline — the
      deterministic parity reference;
    - ``cuda`` backend on ``device`` (the card when None) through
      DevicePipeline — verdicts must be BIT-IDENTICAL to the twin,
      too-old floors included;
    - ``cuda`` backend through the unpipelined per-batch sync loop — the
      in-run A/B baseline the pipelined path must beat.

    Grouping is deterministic by construction: every batch is submitted
    before the pump task first runs, so groups are group_max-sized
    chunks in version order and both backends see the identical floor
    schedule (which is what makes bit-parity assertable at TOO_OLD
    boundaries).  Returns (elapsed, stats)."""
    from ..ops.batch import TOO_OLD
    from ..ops.conflict_torch import default_device

    device = default_device(device)
    knobs = resolve_knobs(batch_txns)
    batches, versions = _resolve_workload(n_batches, batch_txns, 2, 1234)
    n_txns = sum(len(b) for b in batches)
    work = (knobs, batches, versions, device)

    async def main() -> tuple[float, dict]:
        t_all = time.perf_counter()
        twin_rows, _, _ = await run_pipe("numpy", *work)
        # warm the allocator and the kernels' first loads (group buckets
        # + K=1) so the measured passes see steady-state dispatch
        await run_pipe("cuda", *work)
        await run_serial("cuda", *work)
        dev_rows, dev_s, metrics = await run_pipe("cuda", *work)
        ser_rows, ser_s = await run_serial("cuda", *work)
        twin, dev = flat(twin_rows), flat(dev_rows)
        assert twin == dev, (
            "device-pipeline verdicts diverged from the conflict_np CPU "
            "twin on %d of %d txns — abort-rate divergence is a "
            "correctness bug, not noise" % (
                sum(1 for a, b in zip(twin, dev) if a != b), len(twin)))
        stats = {
            "device": str(device),
            "n_batches": n_batches,
            "n_txns": n_txns,
            "pipelined_txns_per_sec": n_txns / dev_s if dev_s else 0.0,
            "unpipelined_txns_per_sec": n_txns / ser_s if ser_s else 0.0,
            "speedup": ser_s / dev_s if dev_s else 0.0,
            "too_old_verdicts": sum(1 for x in dev if x == TOO_OLD),
            "serial_matches_pipeline": flat(ser_rows) == dev,
            "dispatches": metrics["device_dispatches"],
            "group_mean": metrics["device_group_mean"],
            "dispatch_us_per_batch": metrics["device_dispatch_us_per_batch"],
            "overlap_ratio": metrics["device_overlap_ratio"],
            "verdicts": dev,
        }
        return time.perf_counter() - t_all, stats

    async def bounded():
        return await asyncio.wait_for(main(), deadline_s)

    try:
        return asyncio.run(bounded())
    except asyncio.TimeoutError:
        raise AssertionError(
            f"resolve smoke wedged: the {deadline_s:.0f}s deadline hit — "
            f"a stuck pump task, a lost readback, or a dispatch that "
            f"never completed, not just slowness") from None


def check_resolve(budget_s: float = RESOLVE_BUDGET_S,
                  quiet: bool = False, device=None) -> float:
    """Run the device-pipeline smoke; raises AssertionError on verdict
    divergence from the CPU twin, below the pipelined-vs-unpipelined
    A/B floor, past the budget, or if the randomized workload failed to
    exercise the too-old boundary at all."""
    elapsed, stats = resolve_pipeline_seconds(deadline_s=budget_s,
                                              device=device)
    if not quiet:
        print(f"[perf_smoke] resolve on {stats['device']}: "
              f"{stats['n_txns']} txns pipelined at "
              f"{stats['pipelined_txns_per_sec']:.0f} txns/s vs "
              f"{stats['unpipelined_txns_per_sec']:.0f} unpipelined "
              f"({stats['speedup']:.1f}x), {stats['dispatches']} dispatches "
              f"(group mean {stats['group_mean']}, "
              f"{stats['dispatch_us_per_batch']:.0f}us/batch), "
              f"{stats['too_old_verdicts']} TOO_OLD verdicts")
    assert stats["too_old_verdicts"] > 0, (
        "the randomized workload produced no TOO_OLD verdicts — the "
        "ring-eviction/life-window boundary went unexercised, so the "
        "parity assertion above proved less than it claims")
    assert elapsed < budget_s, (
        f"resolve smoke took {elapsed:.1f}s (budget {budget_s:.0f}s) — "
        f"encode, dispatch, or readback grew a per-batch stall")
    assert stats["speedup"] >= RESOLVE_AB_FLOOR, (
        f"device pipeline speedup {stats['speedup']:.2f}x under the "
        f"{RESOLVE_AB_FLOOR:.0f}x floor vs the unpipelined per-batch "
        f"sync loop — fusion or overlap regressed on the dispatch path")
    return elapsed



def heat_path_seconds(deadline_s: float | None = None,
                      device=None) -> tuple[float, dict]:
    """The shard-heat smoke: skewed tagged load through the
    full in-process commit pipeline, then three assertions in situ —
    the heat tracker ranks the hot shard first, the ratekeeper's heat
    path arms a tag throttle for the dominant tag, and the armed clamp
    sheds (tagged admission queues, untagged stays fast, both bounded
    by the deadline)."""
    from ..client.transaction import Transaction
    from ..core.cluster import Cluster, ClusterConfig
    from ..ops.conflict_torch import default_device
    from ..runtime.errors import FdbError
    from ..runtime.knobs import Knobs

    device = default_device(device)
    knobs = Knobs().override(
        # fast-converging rates for a seconds-long smoke
        SHARD_HEAT_HALFLIFE=2.0,
        # arm aggressively: >= 10 writes/s on one shard whose write-byte
        # rate would fill a (deliberately tiny) 2KB queue target within
        # 5s — the smoke's hot load clears both by orders of magnitude,
        # and the computed budget bottoms out at RATEKEEPER_MIN_TPS so
        # the shed measurement below is deterministic
        RATEKEEPER_HEAT_THROTTLE=True,
        RATEKEEPER_HOT_SHARD_WRITES_PER_SEC=10.0,
        RATEKEEPER_HEAT_WEDGE_S=5.0,
        TARGET_STORAGE_QUEUE_BYTES=2_000,
        # floor high enough that the clamp arming MID-LOAD (it does —
        # that's the subsystem working) drains the remaining tagged
        # commits in seconds, not minutes, on a loaded CI box
        RATEKEEPER_MIN_TPS=25.0)
    try:
        from ..ops.conflict_cpp import CppConflictSet
        CppConflictSet()
        knobs = knobs.override(RESOLVER_CONFLICT_BACKEND="cpp")
    except Exception:  # noqa: BLE001 — numpy twin, generous budget
        pass

    def hot_key(i: int) -> bytes:
        # zipf-shaped: multiplicative-hash squared index concentrates
        # most probes on a small prefix of the 512-key hot set
        return b"hot%05d" % (((i * 2654435761) % 512) ** 2 % 512)

    async def main() -> tuple[float, dict]:
        cluster = Cluster(ClusterConfig(storage_servers=4), knobs,
                          device=device)
        cluster.start()
        t_all = time.perf_counter()
        issued_hot = iter(range(HEAT_HOT_TXNS))
        issued_cold = iter(range(HEAT_COLD_TXNS))

        async def hot_writer(cid: int) -> None:
            tr = Transaction(cluster)
            tr.throttle_tag = "hot"
            for i in issued_hot:
                while True:
                    try:
                        tr.set(hot_key(i), b"v" * 64)
                        tr.set(hot_key(i + 7), b"w" * 64)
                        await tr.commit()
                        tr.reset()
                        break
                    except FdbError as e:
                        await tr.on_error(e)

        async def cold_writer(cid: int) -> None:
            tr = Transaction(cluster)
            for i in issued_cold:
                while True:
                    try:
                        tr.set(b"\x20cold%06d" % i, b"v" * 64)
                        await tr.commit()
                        tr.reset()
                        break
                    except FdbError as e:
                        await tr.on_error(e)

        async def hot_reader(rid: int) -> None:
            tr = Transaction(cluster)
            await tr.get_read_version()
            for j in range(HEAT_READS // 8):
                await tr.get(hot_key(rid * 131 + j), snapshot=True)

        await asyncio.gather(*(hot_writer(c) for c in range(12)),
                             *(cold_writer(c) for c in range(2)),
                             *(hot_reader(r) for r in range(8)))

        # --- 1. the tracker ranks the hot shard first ---
        sms = [await ss.shard_metrics() for ss in cluster.storage_servers]
        ranked = sorted(sms, key=lambda m: -m["rw_per_sec"])
        hot_sm = ranked[0]
        assert hot_sm["shard_begin"] <= b"hot" < hot_sm["shard_end"], (
            "heat tracker ranked the WRONG shard first: "
            + repr([(m["tag"], m["rw_per_sec"]) for m in ranked]))
        rank_margin = hot_sm["rw_per_sec"] \
            / max(ranked[1]["rw_per_sec"], 1e-9)
        assert rank_margin >= HEAT_RANK_MARGIN, (
            f"hot shard only {rank_margin:.1f}x the next-hottest "
            f"(floor {HEAT_RANK_MARGIN:.0f}x) — the skew signal washed out")
        # and the reservoir computed an interior split point for DD
        assert hot_sm["heat_split_key"] is not None
        assert bytes(hot_sm["heat_split_key"]).startswith(b"hot")

        # --- 2. the heat path armed a tag throttle for the hot tag ---
        rk = cluster.ratekeeper
        await rk._recompute()
        assert "hot" in rk.heat_tag_rates, (
            f"heat throttle never armed: tag_rates={rk.tag_rates} "
            f"reason={rk.limiting_reason} hot_shards={rk.hot_shards}")
        assert rk.heat_throttle_activations >= 1
        budget = rk.tag_rates["hot"]
        # freeze the clamp for the shed measurement: the update loop
        # would re-run _recompute mid-drain and lift it as rates decay
        await rk.stop()

        # --- 3. the armed clamp sheds; untagged work stays fast ---
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        await rk.admit(50)
        untagged_s = loop.time() - t0
        assert untagged_s < 1.0, (
            f"untagged admission took {untagged_s:.2f}s under a TAG "
            f"clamp — cold tenants are paying for the hot one")
        t0 = loop.time()
        # the tag bucket starts full (one budget of tokens): 2.5
        # budgets must drain >= 1.5 budgets from refill ≈ 1.5s
        await rk.admit(int(2.5 * budget), tags={"hot": int(2.5 * budget)})
        tagged_s = loop.time() - t0
        assert tagged_s >= 0.5, (
            f"tagged admission of 2.5x the clamp budget returned in "
            f"{tagged_s:.2f}s — the throttle armed but did not shed")
        stats = {
            "hot_rw_per_sec": hot_sm["rw_per_sec"],
            "rank_margin": rank_margin,
            "heat_rank": [(m["tag"], m["rw_per_sec"]) for m in ranked],
            "armed_budget_tps": budget,
            "heat_throttle_activations": rk.heat_throttle_activations,
            "untagged_admit_s": untagged_s,
            "tagged_admit_s": tagged_s,
        }
        elapsed = time.perf_counter() - t_all
        await cluster.stop()
        return elapsed, stats

    async def bounded():
        return await asyncio.wait_for(main(), deadline_s)

    try:
        return asyncio.run(bounded())
    except asyncio.TimeoutError:
        raise AssertionError(
            f"heat smoke wedged: the {deadline_s:.0f}s deadline hit — "
            f"admission never completed under the armed clamp (the "
            f"standing hard wedge deadline), not just slowness") from None


def check_heat(budget_s: float = HEAT_BUDGET_S, quiet: bool = False,
               device=None) -> float:
    """Run the shard-heat smoke; raises AssertionError when the tracker
    mis-ranks the hot shard, the heat throttle fails to arm or shed, or
    the wedge deadline hits."""
    elapsed, stats = heat_path_seconds(deadline_s=budget_s, device=device)
    if not quiet:
        print(f"[perf_smoke] heat: hot shard {stats['hot_rw_per_sec']:.0f} "
              f"rw/s ({stats['rank_margin']:.1f}x margin), tag budget "
              f"{stats['armed_budget_tps']:.0f} tps, tagged admit "
              f"{stats['tagged_admit_s']:.2f}s vs untagged "
              f"{stats['untagged_admit_s']:.2f}s")
    assert elapsed < budget_s, (
        f"heat smoke took {elapsed:.1f}s (budget {budget_s:.0f}s)")
    return elapsed


def backup_restore_seconds(n_txns: int = BACKUP_TXNS,
                           n_clients: int = BACKUP_CLIENTS,
                           deadline_s: float | None = None,
                           device=None) -> tuple[float, dict]:
    """Wall seconds for the feed-native backup/restore round trip: rows loaded through real commits, a whole-db feed tail +
    packed snapshot, a second write phase (sets + clears), then
    restore-to-version into a FRESH in-process cluster — with the
    restored user keyspace asserted sha256-byte-identical to the source
    at the target version IN SITU (a silently lossy backup is worse
    than a slow one)."""
    from ..backup.agent import BackupAgent
    from ..backup.container import keyspace_digest as digest
    from ..client.database import Database
    from ..client.transaction import Transaction
    from ..core.cluster import Cluster, ClusterConfig
    from ..core.data import SYSTEM_PREFIX
    from ..ops.conflict_torch import default_device
    from ..runtime.errors import FdbError
    from ..runtime.files import SimFileSystem
    from ..runtime.knobs import Knobs

    device = default_device(device)
    knobs = Knobs().override(BACKUP_LOG_FLUSH_INTERVAL=0.1)
    try:
        from ..ops.conflict_cpp import CppConflictSet
        CppConflictSet()
        knobs = knobs.override(RESOLVER_CONFLICT_BACKEND="cpp")
    except Exception:  # noqa: BLE001 — numpy twin, generous budget
        pass

    async def read_all(cluster, at_version=None):
        tr = Transaction(cluster)
        while True:
            try:
                if at_version is not None:
                    tr.set_read_version(at_version)
                return await tr.get_range(b"", SYSTEM_PREFIX, limit=0,
                                          snapshot=True)
            except FdbError as e:
                await tr.on_error(e)

    async def phase(cluster, prefix: bytes, lo: int, hi: int) -> int:
        issued = iter(range(lo, hi))
        tip = 0

        async def client(cid: int) -> None:
            nonlocal tip
            tr = Transaction(cluster)
            for i in issued:
                while True:
                    try:
                        tr.set(prefix + b"%06d" % i, b"v" * 64)
                        if i % 17 == 0 and i > lo:
                            # clears ride the feed too
                            tr.clear(prefix + b"%06d" % (i - 7))
                        tip = max(tip, await tr.commit())
                        tr.reset()
                        break
                    except FdbError as e:
                        await tr.on_error(e)

        await asyncio.gather(*(client(c) for c in range(n_clients)))
        return tip

    async def main() -> tuple[float, dict]:
        fs = SimFileSystem()
        t_all = time.perf_counter()
        src = Cluster(ClusterConfig(storage_servers=2), knobs,
                      device=device)
        src.start()
        db = Database(src)
        await phase(src, b"bk", 0, n_txns)
        agent = BackupAgent(db, fs, "smoke-bk")
        t0 = time.perf_counter()
        await agent.start_continuous()
        snap = await agent.backup()
        t_snap = time.perf_counter() - t0
        vt = await phase(src, b"bk", n_txns, 2 * n_txns)
        # drain the feed tail through the target, then capture truth
        while agent.log_through < vt:
            await asyncio.sleep(0.05)
        expected = await read_all(src, at_version=vt)
        t0 = time.perf_counter()
        await agent.stop_continuous(drain_timeout=30.0)
        t_drain = time.perf_counter() - t0
        await src.stop()

        dst = Cluster(ClusterConfig(storage_servers=2), knobs,
                      device=device)
        dst.start()
        t0 = time.perf_counter()
        agent2 = BackupAgent(Database(dst), fs, "smoke-bk")
        await agent2.restore(to_version=vt)
        t_restore = time.perf_counter() - t0
        got = await read_all(dst)
        await dst.stop()
        assert digest(got) == digest(expected), (
            f"restore-to-version diverged from the source at {vt}: "
            f"{len(got)} restored rows vs {len(expected)} expected — a "
            f"lost or duplicated mutation, not slowness")
        mlog = await agent2.container.load_log_manifest()
        stats = {
            "rows": len(expected),
            "snapshot_rows": snap.rows,
            "snapshot_s": t_snap,
            "log_files": len(mlog["files"]),
            "log_bytes": mlog.get("bytes", 0),
            "drain_s": t_drain,
            "restore_s": t_restore,
            "restore_rows_per_sec":
                len(got) / t_restore if t_restore else 0.0,
            "verified": True,
        }
        return time.perf_counter() - t_all, stats

    async def bounded():
        return await asyncio.wait_for(main(), deadline_s)

    try:
        return asyncio.run(bounded())
    except asyncio.TimeoutError:
        raise AssertionError(
            f"backup smoke wedged: the {deadline_s:.0f}s deadline hit — "
            f"a stalled feed tail, drain, or restore chunk, not just "
            f"slowness") from None


def check_backup(budget_s: float = BACKUP_BUDGET_S,
                 quiet: bool = False, device=None) -> float:
    """Run the backup/restore smoke; raises AssertionError on a
    byte-identity failure, past the budget, or at the wedge deadline."""
    elapsed, stats = backup_restore_seconds(deadline_s=budget_s,
                                            device=device)
    if not quiet:
        print(f"[perf_smoke] backup: {stats['rows']} rows round-tripped "
              f"(snapshot {stats['snapshot_rows']} rows in "
              f"{stats['snapshot_s']:.2f}s, {stats['log_files']} mlog "
              f"files, restore {stats['restore_rows_per_sec']:.0f} "
              f"rows/s), verified={stats['verified']}")
    assert stats["verified"]
    assert elapsed < budget_s, (
        f"backup smoke took {elapsed:.1f}s (budget {budget_s:.0f}s) — "
        f"capture, the .mlog flush path, or the chunked restore grew a "
        f"quadratic shape")
    return elapsed


def recover_path_seconds(n_txns: int = RECOVER_TXNS,
                         n_clients: int = RECOVER_CLIENTS,
                         deadline_s: float | None = None,
                         device=None) -> tuple[float, dict]:
    """Wall seconds for the torn-disk recovery round trip: rows loaded through real acked commits onto a DURABLE in-process
    cluster, then a POWER LOSS with the hostile-disk profile armed —
    every file's unsynced writes tear at sector granularity with bit
    corruption of the surviving sectors — then a fresh Cluster.create
    over the damaged disk, with the recovered user keyspace asserted
    sha256-byte-identical to the pre-kill acked state IN SITU.  A
    recovery that silently drops or resurrects an acked write fails the
    digest, a wedged one hits the deadline."""
    from ..backup.container import keyspace_digest as digest
    from ..client.transaction import Transaction
    from ..core.cluster import Cluster, ClusterConfig
    from ..core.data import SYSTEM_PREFIX
    from ..ops.conflict_torch import default_device
    from ..runtime.errors import FdbError
    from ..runtime.files import DiskFaultProfile, SimFileSystem
    from ..runtime.knobs import Knobs
    from ..runtime.rng import DeterministicRandom

    device = default_device(device)
    # small window + fast ticks: the engines absorb real durability
    # traffic (WAL frames, headers, side files) before the kill, so the
    # tear has committed surfaces to chew on
    knobs = Knobs().override(STORAGE_VERSION_WINDOW=100_000,
                             STORAGE_DURABILITY_LAG=0.05)
    cfg = ClusterConfig(storage_servers=2, logs=2)

    async def read_all(cluster):
        tr = Transaction(cluster)
        while True:
            try:
                return await tr.get_range(b"", SYSTEM_PREFIX, limit=0,
                                          snapshot=True)
            except FdbError as e:
                await tr.on_error(e)

    async def main() -> tuple[float, dict]:
        t_all = time.perf_counter()
        fs = SimFileSystem()
        src = await Cluster.create(cfg, knobs, fs=fs, data_dir="rec",
                                   device=device)
        src.start()
        issued = iter(range(n_txns))

        async def client(cid: int) -> None:
            tr = Transaction(src)
            for i in issued:
                while True:
                    try:
                        tr.set(b"rc%06d" % i, b"v" * 64)
                        if i % 17 == 0 and i > 0:
                            tr.clear(b"rc%06d" % (i - 7))
                        await tr.commit()
                        tr.reset()
                        break
                    except FdbError as e:
                        await tr.on_error(e)

        await asyncio.gather(*(client(c) for c in range(n_clients)))
        # one durability tick lands part of the window in the engines
        # (the rest stays TLog-only — recovery must replay BOTH shapes)
        await asyncio.sleep(0.2)
        expected = await read_all(src)
        await src.stop()
        # power loss with hostile-disk kill semantics: every dirty
        # sector independently persists, drops, or turns to garbage
        prof = DiskFaultProfile()
        prof.arm(DeterministicRandom(0xD15C), torn_p=1.0, corrupt_p=0.3)
        fs.profile = prof
        fs.kill_unsynced()
        t0 = time.perf_counter()
        dst = await Cluster.create(cfg, knobs, fs=fs, data_dir="rec",
                                   device=device)
        dst.start()
        got = await read_all(dst)       # retries until replay catches up
        t_recover = time.perf_counter() - t0
        await dst.stop()
        assert digest(got) == digest(expected), (
            f"post-recovery keyspace diverged from the acked pre-kill "
            f"state: {len(got)} recovered rows vs {len(expected)} "
            f"expected — a torn/corrupt unsynced region leaked into "
            f"committed data, not slowness")
        stats = {
            "rows": len(expected),
            "torn_files": prof.torn_kills,
            "dropped_sectors": prof.dropped_sectors,
            "corrupt_sectors": prof.corrupt_sectors,
            "recover_s": t_recover,
            "verified": True,
        }
        return time.perf_counter() - t_all, stats

    async def bounded():
        return await asyncio.wait_for(main(), deadline_s)

    try:
        return asyncio.run(bounded())
    except asyncio.TimeoutError:
        raise AssertionError(
            f"recover smoke wedged: the {deadline_s:.0f}s deadline hit — "
            f"recovery against a torn disk stopped making progress, not "
            f"just slowness") from None


def check_recover(budget_s: float = RECOVER_BUDGET_S,
                  quiet: bool = False, device=None) -> float:
    """Run the torn-disk recovery smoke; raises AssertionError on a
    byte-identity failure, past the budget, or at the wedge deadline."""
    elapsed, stats = recover_path_seconds(deadline_s=budget_s,
                                          device=device)
    if not quiet:
        print(f"[perf_smoke] recover: {stats['rows']} rows survived a "
              f"torn-disk kill ({stats['torn_files']} files torn, "
              f"{stats['dropped_sectors']} sectors dropped, "
              f"{stats['corrupt_sectors']} corrupted) — recovery "
              f"{stats['recover_s']:.2f}s, verified={stats['verified']}")
    assert stats["verified"]
    assert stats["torn_files"] > 0, (
        "the kill tore no file — the hostile-disk profile did not run, "
        "so this stage proved nothing")
    assert elapsed < budget_s, (
        f"recover smoke took {elapsed:.1f}s (budget {budget_s:.0f}s) — "
        f"recovery replay or the read catch-up grew a quadratic shape")
    return elapsed


def scan_path_seconds(n_rows: int = SCAN_ROWS, chunk: int = SCAN_CHUNK,
                      sweeps: int = SCAN_SWEEPS,
                      deadline_s: float | None = None,
                      device=None) -> tuple[float, dict]:
    """Wall seconds for the columnar range-read smoke: ``n_rows`` loaded through real commits onto a DURABLE lsm cluster,
    the MVCC window shrunk so durability pushes them into sorted-run
    files, then ``sweeps`` full-table scans per side of the in-run A/B
    — CLIENT_PACKED_RANGE_READS off (legacy tuple-list path) vs on
    (packed replies + run-wise merge) — with results asserted
    BYTE-IDENTICAL in situ.  The chunk is pinned at ``chunk`` rows by
    sizing CLIENT_RANGE_CHUNK_BYTES to exactly chunk * row_bytes, so
    both sides pay the identical continuation-cursor schedule.  The
    storage servers' read mirrors run on ``device``."""
    from ..client.transaction import Transaction
    from ..core.cluster import Cluster, ClusterConfig
    from ..ops.conflict_torch import default_device
    from ..runtime.errors import FdbError
    from ..runtime.files import SimFileSystem
    from ..runtime.knobs import Knobs
    from ..storage import lsm as lsm_mod

    device = default_device(device)
    val = b"v" * 64
    row_bytes = 13 + len(val)                   # 1 + len("scan%08d"), exact
    knobs = Knobs().override(
        STORAGE_ENGINE="lsm",
        # push the loaded rows into the engine fast: a 1k-version MVCC
        # window ages out within a couple of 50ms durability ticks
        STORAGE_VERSION_WINDOW=1_000,
        STORAGE_DURABILITY_LAG=0.05,
        CLIENT_RANGE_CHUNK_ROWS=chunk,
        CLIENT_RANGE_CHUNK_BYTES=chunk * row_bytes)
    try:
        from ..ops.conflict_cpp import CppConflictSet
        CppConflictSet()
        knobs = knobs.override(RESOLVER_CONFLICT_BACKEND="cpp")
    except Exception:  # noqa: BLE001 — numpy twin, generous budget
        pass

    def key(i: int) -> bytes:
        # half below / half above the 2-shard split at \x80: the scan
        # fans out across shards like a real full-table sweep
        prefix = b"\x20" if i < n_rows // 2 else b"\xa0"
        return prefix + b"scan%08d" % i

    async def main() -> tuple[float, dict]:
        # small lsm thresholds: the load flushes into SEVERAL sorted-run
        # files (compaction deferred), so the A/B measures the block-run
        # extraction + multi-run merge — the shape a scan-heavy workload
        # sees after sustained write traffic — not a pure-memtable scan
        saved = (lsm_mod._MEMTABLE_BYTES, lsm_mod._BLOCK_BYTES,
                 lsm_mod._MAX_RUNS)
        lsm_mod._MEMTABLE_BYTES = 128 << 10
        lsm_mod._BLOCK_BYTES = 16 << 10
        lsm_mod._MAX_RUNS = 16
        try:
            t_all = time.perf_counter()
            cluster = await Cluster.create(
                ClusterConfig(storage_servers=2), knobs,
                fs=SimFileSystem(), data_dir="scan-db", device=device)
            cluster.start()

            async def loader(idxs: list[int]) -> None:
                tr = Transaction(cluster)
                for start in range(0, len(idxs), 512):
                    while True:
                        for i in idxs[start:start + 512]:
                            tr.set(key(i), val)
                        try:
                            await tr.commit()
                            break
                        except FdbError as e:
                            await tr.on_error(e)
                    tr.reset()

            async def drain_to_engine() -> None:
                # wait for the durability floor to pass the load: rows
                # must live in the ENGINE (sorted runs), not the MVCC
                # overlay — proxies keep empty version batches flowing,
                # so the floor advances without more commits
                tip = cluster.sequencer.committed_version
                while any(s.durable_version < tip
                          for s in cluster.storage_servers):
                    await asyncio.sleep(0.05)

            # THREE sequential waves — striped i % waves so every wave
            # exceeds the memtable threshold on BOTH shards — each
            # drained into the engine before the next: every wave
            # forces >= 1 sorted-run flush per shard DETERMINISTICALLY.
            # On a starved box a single durability tick otherwise
            # carries the whole load as one giant slice and the A/B
            # would measure a 1-run scan.
            waves = 3
            for w in range(waves):
                idxs = list(range(w, n_rows, waves))
                span = (len(idxs) + 7) // 8
                await asyncio.gather(
                    *(loader(idxs[j * span:(j + 1) * span])
                      for j in range(8)))
                await drain_to_engine()
            runs = [len(getattr(s.engine, "_runs", []))
                    for s in cluster.storage_servers]
            assert all(r >= 3 for r in runs), (
                f"load never reached the sorted runs (runs={runs}) — "
                f"the A/B would measure a memtable scan")

            # every range reply crosses the REAL wire codec, exactly as
            # TcpTransport serializes it in production (the in-process
            # shortcut passes tuple lists by reference, which hides the
            # per-row encode/decode the packed columns exist to delete —
            # the A/B must charge both sides their true wire cost)
            from ..rpc.wire import decode, encode
            for g in cluster._replica_groups:
                inner_l = g.get_key_values
                inner_p = g.get_key_values_packed

                async def legacy_wire(b, e, v, limit=0, rev=False, bl=0,
                                      inner=inner_l):
                    args = decode(encode([b, e, v, limit, rev, bl]))
                    return decode(encode(await inner(*args)))

                async def packed_wire(req, inner=inner_p):
                    return decode(encode(await inner(decode(encode(req)))))

                g.get_key_values = legacy_wire
                g.get_key_values_packed = packed_wire

            async def sweep(packed: bool) -> tuple[list, float]:
                cluster.knobs = base_knobs.override(
                    CLIENT_PACKED_RANGE_READS=packed)
                tr = Transaction(cluster)
                t0 = time.perf_counter()
                rows = await tr.get_range(b"\x20", b"\xa1", snapshot=True)
                assert len(rows) == n_rows, len(rows)
                return rows, time.perf_counter() - t0

            # interleaved A/B, best-of-N per side: host-load noise on a
            # shared CI box must not flip the ratio assertion
            base_knobs = cluster.knobs
            await sweep(False)          # warm caches on both paths
            await sweep(True)
            # GC hygiene: deep in a tier-1 run the process carries
            # hundreds of earlier tests' garbage, and a gen2 pass
            # landing inside one ~40ms timed sweep skews the min-of-N
            # past the ratio floor — collect NOW, then keep automatic
            # collection out of the timed region (the sweeps allocate
            # a few MB; re-enabled right after)
            import gc
            gc.collect()
            gc.disable()
            try:
                legacy_s = packed_s = float("inf")
                legacy_rows = packed_rows = None
                for _ in range(sweeps):
                    rows, t = await sweep(False)
                    legacy_rows, legacy_s = rows, min(legacy_s, t)
                    rows, t = await sweep(True)
                    packed_rows, packed_s = rows, min(packed_s, t)
            finally:
                gc.enable()
            assert packed_rows == legacy_rows, (
                "packed scan diverged from the legacy tuple path — a "
                "wrong row is worse than a slow one")
            stats = {
                "rows": n_rows,
                "engine_runs": runs,
                "legacy_rows_per_sec":
                    n_rows / legacy_s if legacy_s else 0.0,
                "packed_rows_per_sec":
                    n_rows / packed_s if packed_s else 0.0,
                "speedup": legacy_s / packed_s if packed_s else 0.0,
                "chunk": chunk,
            }
            elapsed = time.perf_counter() - t_all
            await cluster.stop()
            return elapsed, stats
        finally:
            (lsm_mod._MEMTABLE_BYTES, lsm_mod._BLOCK_BYTES,
             lsm_mod._MAX_RUNS) = saved

    async def bounded():
        return await asyncio.wait_for(main(), deadline_s)

    try:
        return asyncio.run(bounded())
    except asyncio.TimeoutError:
        raise AssertionError(
            f"scan smoke wedged: the {deadline_s:.0f}s deadline hit — a "
            f"stalled continuation cursor or an engine merge that never "
            f"terminated, not just slowness") from None


def check_scan(budget_s: float = SCAN_BUDGET_S, quiet: bool = False,
               device=None) -> float:
    """Run the columnar range-read smoke; raises AssertionError on a
    byte-identity failure, below the packed-vs-legacy rows/s floor,
    past the budget, or at the wedge deadline."""
    elapsed, stats = scan_path_seconds(deadline_s=budget_s, device=device)
    if not quiet:
        print(f"[perf_smoke] scan: {stats['rows']} rows x {SCAN_SWEEPS} "
              f"sweeps, legacy {stats['legacy_rows_per_sec']:.0f} rows/s "
              f"vs packed {stats['packed_rows_per_sec']:.0f} rows/s "
              f"({stats['speedup']:.1f}x) at chunk {stats['chunk']}, "
              f"engine runs={stats['engine_runs']}")
    assert elapsed < budget_s, (
        f"scan smoke took {elapsed:.1f}s (budget {budget_s:.0f}s) — the "
        f"range path grew a per-row or per-chunk quadratic shape")
    assert stats["speedup"] >= SCAN_SPEEDUP_FLOOR, (
        f"packed scan speedup {stats['speedup']:.2f}x under the "
        f"{SCAN_SPEEDUP_FLOOR:.0f}x floor vs the legacy tuple-list path "
        f"at chunk {SCAN_CHUNK} — the columnar range path lost its edge")
    return elapsed


def _rss_bytes() -> int | None:
    """Current resident set size (Linux /proc; None when unavailable —
    the RSS assertions then skip rather than fake a number).  glibc's
    free heap is trimmed first: repeated multi-MB blob alloc/free
    cycles raise its dynamic mmap threshold, and without the trim the
    retained-but-free heap (pure allocator slop) would swamp the
    per-key delta this measures."""
    try:
        import ctypes
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except Exception:   # noqa: BLE001 — non-glibc: slack rides the number
        pass
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:   # noqa: BLE001 — non-Linux host
        return None


def bigkeys_key_fn(n_keys: int):
    """The bigkeys keyspace: a hash-permuted arrival order over n_keys
    distinct keys.  i -> key must be a BIJECTION, which needs the
    multiplier coprime to n_keys — the base constant is divisible by 3,
    so a key count divisible by 3 would silently collapse the keyspace
    to n/3 distinct keys; bump to the next coprime odd instead (a no-op
    for the default 2M counts)."""
    mul = 1_315_423_911
    while n_keys > 1 and math.gcd(mul, n_keys) != 1:
        mul += 2

    def key(i: int) -> bytes:
        return b"big%012d" % ((i * mul) % n_keys)

    return key


async def apply_bigkeys(ss, n_keys: int, key, value=b"v%08d"
                        ) -> tuple[int, float]:
    """Apply ``n_keys`` fresh keys through real packed commit batches
    (the TLog-pull apply shape) onto ``ss``; returns (final version,
    apply seconds)."""
    from ..core.data import MutationBatchBuilder
    t0 = time.perf_counter()
    version = 0
    for start in range(0, n_keys, 4096):
        version += 1
        mb = MutationBatchBuilder()
        for i in range(start, min(start + 4096, n_keys)):
            mb.add(0, key(i), value % i)
        ss._apply_batch([(version, mb.finish())])
        if (start // 4096) % 16 == 0:
            await asyncio.sleep(0)
    return version, time.perf_counter() - t0


async def packed_scan(ss, begin: bytes, end: bytes, version: int,
                      chunk: int = 4096) -> list:
    """Full packed chunked-continuation scan of [begin, end) — the
    client continuation discipline at the storage boundary."""
    from ..core.data import GetRangeRequest
    rows: list = []
    b = begin
    while True:
        rep = await ss.get_key_values_packed(
            GetRangeRequest(b, end, version, chunk))
        assert rep.status == 0, rep.status
        rows.extend(rep.rows())
        if not rep.more or not len(rep):
            break
        b = rows[-1][0] + b"\x00"
    return rows


def bigkeys_seconds(n_keys: int = BIG_KEYS,
                    deadline_s: float | None = None,
                    device=None) -> tuple[float, dict]:
    """The memory-wall smoke: a ≥2M-key keyspace built and
    served at tier-1 cost.

    Part 1 — the columnar index A/B: the SAME 2M-key insertion stream
    (hash-permuted arrival order, chunked ``add_many`` — the apply
    path's shape) builds a columnar ``PackedKeyIndex`` and the legacy
    list-mode twin, RSS measured around each.  The columnar index must
    hold ≤ ``BIG_RSS_PER_KEY`` bytes/key of overhead beyond the raw key
    bytes (one int64 bound per key + blob slack; the list path pays
    ~30-50B of PyObject header + pointer per key — asserted ≥2× the
    columnar overhead), and spot-checked range queries must agree.

    Part 2 — the keyspace SERVED: the 2M keys applied through real
    packed commit batches on a storage server (the TLog-pull apply
    shape), then point reads (scalar vs multiget) and a
    ``BIG_SCAN_ROWS`` packed-vs-legacy chunked scan, all byte-identical
    — the columnar index is what locates every range row.  The whole
    run sits under the standing hard wedge deadline.

    The work is the host's: the storage server has no engine, so no
    read mirror.  ``device`` is resolved before the first RSS sample,
    and no measured window touches the card, so the deltas exclude its
    context."""
    import gc

    from ..ops.conflict_torch import default_device
    from ..storage.key_index import PackedKeyIndex

    device = default_device(device)
    key = bigkeys_key_fn(n_keys)
    klen = len(key(0))
    raw_bytes = klen * n_keys

    async def main() -> tuple[float, dict]:
        t_all = time.perf_counter()
        chunk = 65536
        overhead: dict[bool, float | None] = {}
        build_s: dict[bool, float] = {}
        indexes: dict[bool, PackedKeyIndex] = {}
        for mode in (True, False):      # columnar first, then the twin
            gc.collect()
            r0 = _rss_bytes()
            t0 = time.perf_counter()
            idx = PackedKeyIndex(columnar=mode)
            for start in range(0, n_keys, chunk):
                idx.add_many([key(i) for i in
                              range(start, min(start + chunk, n_keys))])
                await asyncio.sleep(0)      # keep the wedge deadline armed
            if idx.pending_run():
                idx._merge()                # measure the settled base run
            build_s[mode] = time.perf_counter() - t0
            gc.collect()
            r1 = _rss_bytes()
            overhead[mode] = ((r1 - r0 - raw_bytes) / n_keys
                              if r0 is not None and r1 is not None else None)
            indexes[mode] = idx
        col, lst = indexes[True], indexes[False]
        assert len(col) == len(lst) == n_keys, "index lost keys"
        ranges = [(b"big%012d" % (j * 971), b"big%012d" % (j * 971 + 40))
                  for j in range(0, 2000, 13)]
        assert col.ranges_keys(ranges) == lst.ranges_keys(ranges), \
            "columnar index diverged from the list twin on range queries"
        del lst
        indexes.clear()
        gc.collect()

        # --- part 2: the keyspace applied through real commit batches ---
        from ..core.data import GetValuesRequest, KeyRange
        from ..core.storage_server import StorageServer
        from ..core.tlog import TLog
        from ..runtime.knobs import Knobs

        knobs = Knobs().override(STORAGE_VERSION_WINDOW=1 << 60)
        ss = StorageServer(knobs, 0, KeyRange(b"", b"\xff"), TLog(knobs),
                           device=device)
        version, apply_s = await apply_bigkeys(ss, n_keys, key)
        assert len(ss.vmap) == n_keys, "apply lost keys"

        # point reads: scalar vs multiget, byte-identical
        probes = sorted({key((i * 2654435761) % n_keys)
                         for i in range(BIG_READ_KEYS)})
        t0 = time.perf_counter()
        scalar = [await ss.get_value(k, version) for k in probes]
        scalar_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        multi: list = []
        for s in range(0, len(probes), 64):
            part = probes[s:s + 64]
            rep = await ss.get_values(
                GetValuesRequest.from_keys(part, version))
            multi.extend(rep.unpack(i)[1] for i in range(len(part)))
        multi_s = time.perf_counter() - t0
        assert multi == scalar, "multiget diverged from scalar gets"
        assert all(v is not None for v in scalar), "probe lost rows"

        # scan: packed chunked continuation vs the legacy row path
        b0 = b"big%012d" % 0
        e0 = b"big%012d" % BIG_SCAN_ROWS
        t0 = time.perf_counter()
        packed_rows = await packed_scan(ss, b0, e0, version)
        packed_s = time.perf_counter() - t0
        legacy_rows: list = []
        b = b0
        while True:
            rows, more = await ss.get_key_values(b, e0, version, 4096)
            legacy_rows.extend(rows)
            if not more or not rows:
                break
            b = rows[-1][0] + b"\x00"
        assert packed_rows == legacy_rows, \
            "packed scan diverged from the legacy path at 2M keys"
        assert len(packed_rows) == BIG_SCAN_ROWS, len(packed_rows)

        stats = {
            "keys": n_keys,
            "columnar_overhead_b_per_key":
                round(overhead[True], 2) if overhead[True] is not None
                else None,
            "list_overhead_b_per_key":
                round(overhead[False], 2) if overhead[False] is not None
                else None,
            "columnar_build_s": round(build_s[True], 2),
            "list_build_s": round(build_s[False], 2),
            "index_base_bytes": col.stats()["base_bytes"],
            "apply_keys_per_sec": round(n_keys / apply_s, 1),
            "scalar_reads_per_sec":
                round(len(probes) / scalar_s, 1) if scalar_s else 0.0,
            "multiget_keys_per_sec":
                round(len(probes) / multi_s, 1) if multi_s else 0.0,
            "scan_rows_per_sec":
                round(BIG_SCAN_ROWS / packed_s, 1) if packed_s else 0.0,
        }
        return time.perf_counter() - t_all, stats

    async def bounded():
        return await asyncio.wait_for(main(), deadline_s)

    try:
        return asyncio.run(bounded())
    except asyncio.TimeoutError:
        raise AssertionError(
            f"bigkeys smoke wedged: the {deadline_s:.0f}s deadline hit — "
            f"an index merge, apply slice, or scan continuation that "
            f"stopped making progress, not just slowness") from None


def check_bigkeys(n_keys: int = BIG_KEYS, budget_s: float = BIG_BUDGET_S,
                  quiet: bool = False, device=None) -> float:
    """Run the memory-wall smoke; raises AssertionError past the RSS
    ceiling, on columnar-vs-legacy divergence, past the budget, or at
    the wedge deadline."""
    elapsed, stats = bigkeys_seconds(n_keys, deadline_s=budget_s,
                                     device=device)
    if not quiet:
        print(f"[perf_smoke] bigkeys: {stats['keys']} keys — columnar "
              f"{stats['columnar_overhead_b_per_key']} B/key overhead vs "
              f"list {stats['list_overhead_b_per_key']} B/key (builds "
              f"{stats['columnar_build_s']}s/{stats['list_build_s']}s), "
              f"apply {stats['apply_keys_per_sec']:.0f} keys/s, multiget "
              f"{stats['multiget_keys_per_sec']:.0f} keys/s, scan "
              f"{stats['scan_rows_per_sec']:.0f} rows/s")
    assert elapsed < budget_s, (
        f"bigkeys smoke took {elapsed:.1f}s (budget {budget_s:.0f}s) — "
        f"the columnar index or the big-keyspace read path grew a "
        f"quadratic shape")
    co = stats["columnar_overhead_b_per_key"]
    lo = stats["list_overhead_b_per_key"]
    if co is not None:
        assert co <= BIG_RSS_PER_KEY, (
            f"columnar index RSS overhead {co:.1f} B/key exceeds the "
            f"{BIG_RSS_PER_KEY:.0f} B/key ceiling over raw key bytes — "
            f"the memory wall is back")
        if n_keys >= 1_000_000:
            # the ratio needs the full scale: below ~1M keys the deltas
            # sit inside the allocator's noise floor
            assert lo >= 2 * co, (
                f"list-mode overhead {lo:.1f} B/key is under 2x the "
                f"columnar {co:.1f} B/key — either the columnar run "
                f"regressed toward per-object storage or the "
                f"measurement is broken")
    return elapsed


def mvcc_seconds(n_keys: int = MVCC_KEYS,
                 deadline_s: float | None = None,
                 device=None) -> tuple[float, dict]:
    """The MVCC-window memory-wall smoke: a 2M-key hot set
    HELD IN THE WINDOW (the engine-less forget shape — nothing ever
    drops to an engine), built and probed under both window
    implementations in one process.

    Per side of the A/B: the same hash-permuted keyspace applied
    through real packed ``MutationBatch`` batches (``apply_packed`` —
    the TLog-pull fast path) with the engine-less compaction floor
    ticking behind the applied tip (so columnar seals, tiered merges
    and folds all run), RSS measured around the build, then
    ``get2_batch`` probes at the batched-read shape.  Asserted in situ:
    byte-identical probe results AND a range sweep, the columnar window
    at <= ``MVCC_RSS_RATIO_CEIL`` of the legacy window's RSS overhead,
    and the combined apply+probe pipeline at >=
    ``MVCC_PIPELINE_FLOOR``x legacy.  The budget doubles as the hard
    wedge deadline.  The work is the host's (``device`` is resolved
    before the first RSS sample, as in ``bigkeys_seconds``)."""
    import gc

    from ..core.data import MutationBatchBuilder
    from ..ops.conflict_torch import default_device
    from ..storage.versioned_map import VersionedMap

    default_device(device)
    key = bigkeys_key_fn(n_keys)
    raw_bytes = (len(key(0)) + 9) * n_keys      # key + b"v%08d" value

    async def main() -> tuple[float, dict]:
        t_all = time.perf_counter()
        overhead: dict[bool, float | None] = {}
        apply_s: dict[bool, float] = {}
        probe_s: dict[bool, float] = {}
        probe_results: dict[bool, list] = {}
        small_s: dict[bool, float] = {}
        small_results: dict[bool, list] = {}
        sweep: dict[bool, tuple] = {}
        stats_c: dict = {}
        probes = sorted({key((i * 2654435761) % n_keys)
                         for i in range(MVCC_PROBE_KEYS)})
        for mode in (True, False):      # columnar first, then the twin
            gc.collect()
            r0 = _rss_bytes()
            vm = VersionedMap(columnar=mode)
            apply_s[mode] = 0.0
            version = 0
            for start in range(0, n_keys, 4096):
                version += 1000
                # batch assembly is untimed: both sides pay the same
                # builder cost, and leaving it in the measurement only
                # dilutes the window-vs-window ratio toward 1
                mb = MutationBatchBuilder()
                for i in range(start, min(start + 4096, n_keys)):
                    mb.add(0, key(i), b"v%08d" % i)
                batch = mb.finish()
                t0 = time.perf_counter()
                vm.apply_packed(version, batch)
                if (start // 4096) % 64 == 63:
                    # the engine-less floor trails the tip (forget
                    # consumers tick every pull iteration)
                    vm.forget_before(version - 500)
                    apply_s[mode] += time.perf_counter() - t0
                    await asyncio.sleep(0)  # keep the wedge deadline armed
                else:
                    apply_s[mode] += time.perf_counter() - t0
            t0 = time.perf_counter()
            vm.forget_before(version)
            apply_s[mode] += time.perf_counter() - t0
            gc.collect()
            r1 = _rss_bytes()
            overhead[mode] = ((r1 - r0 - raw_bytes) / n_keys
                              if r0 is not None and r1 is not None
                              else None)
            t0 = time.perf_counter()
            got: list = []
            for s in range(0, len(probes), MVCC_PROBE_BATCH):
                got.extend(vm.get2_batch(probes[s:s + MVCC_PROBE_BATCH],
                                         version))
            probe_s[mode] = time.perf_counter() - t0
            probe_results[mode] = got
            # small-batch point probes: ≤64-key engine-less batches against the
            # multi-segment window — one warm pass (populates the
            # columnar recent-hit cache, a cost the steady state
            # amortizes away), then the timed repeats both sides pay
            # identically
            small = [probes[s:s + MVCC_SMALL_BATCH]
                     for s in range(0, MVCC_PROBE_KEYS // 4,
                                    MVCC_SMALL_BATCH)]
            sgot: list = []
            for b in small:
                sgot.extend(vm.get2_batch(b, version))
            small_results[mode] = sgot
            t0 = time.perf_counter()
            for _ in range(2):
                for b in small:
                    vm.get2_batch(b, version)
            small_s[mode] = time.perf_counter() - t0
            sweep[mode] = vm.range_rows(b"big%012d" % 0,
                                        b"big%012d" % MVCC_SCAN_ROWS,
                                        version)
            if mode:
                stats_c = vm.index_stats()
            del vm
            await asyncio.sleep(0)
        assert probe_results[True] == probe_results[False], (
            "columnar window probe results diverged from the legacy "
            "twin — the A/B is not serving byte-identical data")
        assert all(r[0] for r in probe_results[True]), "probe lost rows"
        assert small_results[True] == small_results[False], (
            "small-batch probe results diverged from the legacy twin — "
            "the recent-hit cache is serving stale entries")
        assert sweep[True] == sweep[False], (
            "columnar range sweep diverged from the legacy twin")
        assert len(sweep[True][0]) == MVCC_SCAN_ROWS
        pipeline_c = apply_s[True] + probe_s[True]
        pipeline_l = apply_s[False] + probe_s[False]
        stats = {
            "keys": n_keys,
            "columnar_window_b_per_key":
                round(overhead[True], 2) if overhead[True] is not None
                else None,
            "legacy_window_b_per_key":
                round(overhead[False], 2) if overhead[False] is not None
                else None,
            "columnar_apply_keys_per_sec":
                round(n_keys / apply_s[True], 1),
            "legacy_apply_keys_per_sec":
                round(n_keys / apply_s[False], 1),
            "columnar_probe_keys_per_sec":
                round(len(probes) / probe_s[True], 1),
            "legacy_probe_keys_per_sec":
                round(len(probes) / probe_s[False], 1),
            "small_probe_ratio": round(small_s[False]
                                       / max(1e-9, small_s[True]), 2),
            "pipeline_ratio": round(pipeline_l / pipeline_c, 2),
            "segments": stats_c.get("segments"),
            "seals": stats_c.get("seals"),
            "folds": stats_c.get("folds"),
            "resident_bytes_per_key":
                round(stats_c.get("resident_bytes", 0) / n_keys, 1),
        }
        return time.perf_counter() - t_all, stats

    async def bounded():
        return await asyncio.wait_for(main(), deadline_s)

    try:
        return asyncio.run(bounded())
    except asyncio.TimeoutError:
        raise AssertionError(
            f"mvcc smoke wedged: the {deadline_s:.0f}s deadline hit — a "
            f"seal, segment merge, fold, or probe that stopped making "
            f"progress, not just slowness") from None


def check_mvcc(n_keys: int = MVCC_KEYS, budget_s: float = MVCC_BUDGET_S,
               quiet: bool = False, device=None) -> float:
    """Run the MVCC-window smoke; raises AssertionError on divergence
    from the legacy twin, past the RSS ratio ceiling, under the
    pipeline floor, past the budget, or at the wedge deadline."""
    elapsed, stats = mvcc_seconds(n_keys, deadline_s=budget_s,
                                  device=device)
    if not quiet:
        print(f"[perf_smoke] mvcc: {stats['keys']} keys — window "
              f"{stats['columnar_window_b_per_key']} B/key vs legacy "
              f"{stats['legacy_window_b_per_key']} B/key, apply "
              f"{stats['columnar_apply_keys_per_sec']:.0f} vs "
              f"{stats['legacy_apply_keys_per_sec']:.0f} keys/s, probe "
              f"{stats['columnar_probe_keys_per_sec']:.0f} vs "
              f"{stats['legacy_probe_keys_per_sec']:.0f} keys/s, "
              f"pipeline {stats['pipeline_ratio']:.2f}x, small-batch "
              f"probe {stats['small_probe_ratio']:.2f}x, "
              f"{stats['segments']} segments / {stats['seals']} seals / "
              f"{stats['folds']} folds")
    assert elapsed < budget_s, (
        f"mvcc smoke took {elapsed:.1f}s (budget {budget_s:.0f}s) — the "
        f"columnar window grew a quadratic seal/merge/probe shape")
    co = stats["columnar_window_b_per_key"]
    lo = stats["legacy_window_b_per_key"]
    if co is not None and n_keys >= 1_000_000:
        # the ratio needs the full scale: below ~1M keys the deltas sit
        # inside the allocator's noise floor (the bigkeys discipline)
        assert co <= MVCC_RSS_RATIO_CEIL * lo, (
            f"columnar window RSS overhead {co:.1f} B/key exceeds "
            f"{MVCC_RSS_RATIO_CEIL:.0%} of the legacy window's "
            f"{lo:.1f} B/key — the MVCC memory wall is back")
    assert stats["pipeline_ratio"] >= MVCC_PIPELINE_FLOOR, (
        f"columnar apply+probe pipeline only "
        f"{stats['pipeline_ratio']:.2f}x the legacy window (floor "
        f"{MVCC_PIPELINE_FLOOR:.0f}x) — the direct-seal apply path or "
        f"the vectorized batched probe lost its edge")
    assert stats["small_probe_ratio"] >= MVCC_SMALL_PROBE_FLOOR, (
        f"columnar small-batch ({MVCC_SMALL_BATCH}-key) point probes "
        f"only {stats['small_probe_ratio']:.2f}x the legacy dict hit "
        f"(floor {MVCC_SMALL_PROBE_FLOOR:.1f}x) — the recent-hit cache "
        f"lost its edge")
    return elapsed



def _lsm_compact_geometry(lsm_mod):
    """Small lsm geometry for the compaction A/B: small enough that
    dozens of flushes and many compaction cycles run in seconds, large
    enough that a monolithic merge-all visibly rewrites the keyspace.
    Returns the saved constants for restore."""
    saved = (lsm_mod._MEMTABLE_BYTES, lsm_mod._BLOCK_BYTES,
             lsm_mod._MAX_RUNS)
    lsm_mod._MEMTABLE_BYTES = 24 << 10
    lsm_mod._BLOCK_BYTES = 4 << 10
    lsm_mod._MAX_RUNS = 4
    return saved


async def lsm_ingest_side(leveled: bool, commits: list,
                          probes: list[bytes],
                          probe_every: int = 0) -> dict:
    """One side of the compaction A/B: ingest the prepared commit
    batches into a fresh lsm store (leveled background compaction vs
    the monolithic inline twin), drain, snapshot the serving surface.
    ``probe_every`` > 0 interleaves a timed get_batch every N commits —
    the read-latency-DURING-compaction sample."""
    from ..runtime.files import SimFileSystem
    from ..runtime.knobs import Knobs
    from ..storage.lsm import LSMKVStore

    knobs = Knobs().override(LSM_LEVELED_COMPACTION=leveled,
                             LSM_COMPACT_SLICE_BYTES=32 << 10,
                             LSM_LEVEL_FANOUT=8)
    fs = SimFileSystem()
    kv = await LSMKVStore.open(fs, "db/lsm", knobs=knobs)
    commit_s: list[float] = []
    probe_s: list[float] = []
    t_all = time.perf_counter()
    for i, batch in enumerate(commits):
        t0 = time.perf_counter()
        await kv.commit(batch, {"durable_version": i + 1})
        commit_s.append(time.perf_counter() - t0)
        if probe_every and i % probe_every == probe_every - 1:
            t0 = time.perf_counter()
            kv.get_batch(probes)
            probe_s.append(time.perf_counter() - t0)
    if leveled:
        await kv.wait_compaction_idle()
    ingest_wall = time.perf_counter() - t_all
    got = kv.get_batch(probes)
    rows_sha = hashlib.sha256()
    n_rows = 0
    for run in kv.range_runs(b"", b"\xff\xff"):
        for k, v in run:
            rows_sha.update(bytes(k))
            rows_sha.update(bytes(v))
            n_rows += 1
    m = kv.metrics()
    await kv.close()
    commit_s.sort()
    p99 = commit_s[int(len(commit_s) * 0.99)] if commit_s else 0.0
    probe_s.sort()
    return {
        "ingest_wall_s": ingest_wall,
        "commit_p99_ms": round(p99 * 1e3, 3),
        "commit_max_ms": round(commit_s[-1] * 1e3, 3) if commit_s else 0,
        "read_p99_ms": (round(probe_s[int(len(probe_s) * 0.99)] * 1e3, 3)
                        if probe_s else None),
        "write_amp": m["lsm_write_amp"],
        "compactions": m["lsm_compactions"],
        "runs": m["lsm_runs"],
        "levels": m["lsm_levels"],
        "stall_max_ms": m["lsm_compact_stall_ms"],
        "got": got,
        "rows_sha": rows_sha.hexdigest(),
        "n_rows": n_rows,
    }


def lsm_compact_commits(n_commits: int, keys_per: int,
                        keyspace: int) -> tuple[list, list[bytes]]:
    """The seeded sustained-ingest op stream both twins replay: uniform
    random writes over a keyspace large enough that the live dataset
    GROWS through the run — every flush run spans the keyspace (the
    overlap-heavy shape) and each monolithic merge-all rewrites the
    ever-larger whole — plus a trickle of narrow range clears
    (tombstones crossing levels), and the sorted probe list."""
    import random
    rng = random.Random(20240814)
    commits = []
    for _ in range(n_commits):
        batch = []
        for _ in range(keys_per):
            if rng.random() < 0.02:
                lo = rng.randrange(keyspace)
                hi = min(keyspace, lo + rng.randrange(1, 4))
                batch.append((1, b"ck%08d" % lo, b"ck%08d" % hi))
            else:
                batch.append((0, b"ck%08d" % rng.randrange(keyspace),
                              bytes([rng.randrange(256)])
                              * rng.randrange(16, 72)))
        commits.append(batch)
    probes = sorted({b"ck%08d" % rng.randrange(keyspace)
                     for _ in range(COMPACT_PROBE_KEYS)})
    return commits, probes



def compact_seconds(n_commits: int = COMPACT_COMMITS,
                    deadline_s: float | None = None,
                    device=None) -> tuple[float, dict]:
    """The lsm compaction smoke: sustained multi-flush ingest run on
    BOTH compaction disciplines in one process — leveled background
    (knob default) vs monolithic merge-all (the verbatim twin).  The
    stores have no read mirror, so the work is the host's.  Asserted in situ: byte-identical serving
    (batched points + full range sha), leveled write amplification at
    ≤ ``COMPACT_WRITE_AMP_CEIL`` of the monolithic twin's, and the
    leveled commit-path p99 at ≤ ``COMPACT_STALL_RATIO_CEIL`` of the
    monolithic twin's worst commit (no commit ever awaits a
    full-keyspace merge).  The budget doubles as the wedge deadline —
    a compactor that stops draining debt hangs wait_compaction_idle
    and trips it."""
    from ..ops.conflict_torch import default_device
    from ..storage import lsm as lsm_mod

    default_device(device)
    commits, probes = lsm_compact_commits(n_commits, COMPACT_KEYS_PER,
                                          COMPACT_KEYSPACE)

    async def main() -> tuple[float, dict]:
        t_all = time.perf_counter()
        lev = await lsm_ingest_side(True, commits, probes)
        mono = await lsm_ingest_side(False, commits, probes)
        assert lev["got"] == mono["got"], (
            "leveled point serving diverged from the monolithic twin")
        assert (lev["rows_sha"], lev["n_rows"]) == \
            (mono["rows_sha"], mono["n_rows"]), (
            "leveled range serving diverged from the monolithic twin")
        assert lev["compactions"] > 0, (
            "the leveled compactor never ran — this smoke proved "
            "nothing")
        stats = {
            "commits": len(commits),
            "keys_per_commit": COMPACT_KEYS_PER,
            "leveled_ingest_keys_per_sec":
                round(len(commits) * COMPACT_KEYS_PER
                      / lev["ingest_wall_s"], 1),
            "monolithic_ingest_keys_per_sec":
                round(len(commits) * COMPACT_KEYS_PER
                      / mono["ingest_wall_s"], 1),
            "leveled_write_amp": lev["write_amp"],
            "monolithic_write_amp": mono["write_amp"],
            "write_amp_ratio": round(lev["write_amp"]
                                     / max(1e-9, mono["write_amp"]), 3),
            "leveled_commit_p99_ms": lev["commit_p99_ms"],
            "leveled_commit_max_ms": lev["commit_max_ms"],
            "monolithic_commit_max_ms": mono["commit_max_ms"],
            "leveled_compactions": lev["compactions"],
            "leveled_levels": lev["levels"],
            "leveled_stall_max_ms": lev["stall_max_ms"],
            "monolithic_stall_max_ms": mono["stall_max_ms"],
        }
        return time.perf_counter() - t_all, stats

    saved = _lsm_compact_geometry(lsm_mod)
    try:
        async def bounded():
            return await asyncio.wait_for(main(), deadline_s)
        return asyncio.run(bounded())
    except asyncio.TimeoutError:
        raise AssertionError(
            f"compact smoke wedged: the {deadline_s:.0f}s deadline hit "
            f"— a compaction that stopped draining debt (the background "
            f"task died or the debt score stopped converging), not just "
            f"slowness") from None
    finally:
        (lsm_mod._MEMTABLE_BYTES, lsm_mod._BLOCK_BYTES,
         lsm_mod._MAX_RUNS) = saved


def check_compact(budget_s: float = COMPACT_BUDGET_S,
                  quiet: bool = False, device=None) -> float:
    """Run the compaction smoke; raises AssertionError on serving
    divergence, write amplification past the ceiling, a commit stall
    past the bound, the budget, or the wedge deadline."""
    elapsed, stats = compact_seconds(deadline_s=budget_s, device=device)
    if not quiet:
        print(f"[perf_smoke] compact: {stats['commits']} commits x "
              f"{stats['keys_per_commit']} keys — write amp "
              f"{stats['leveled_write_amp']} vs "
              f"{stats['monolithic_write_amp']} "
              f"({stats['write_amp_ratio']:.2f}x), commit p99 "
              f"{stats['leveled_commit_p99_ms']:.1f}ms / max "
              f"{stats['leveled_commit_max_ms']:.1f}ms vs monolithic "
              f"max {stats['monolithic_commit_max_ms']:.1f}ms, "
              f"{stats['leveled_compactions']} compactions, levels "
              f"{stats['leveled_levels']}")
    assert elapsed < budget_s, (
        f"compact smoke took {elapsed:.1f}s (budget {budget_s:.0f}s) — "
        f"a compaction discipline grew a quadratic shape")
    assert stats["write_amp_ratio"] <= COMPACT_WRITE_AMP_CEIL, (
        f"leveled write amplification {stats['leveled_write_amp']} is "
        f"{stats['write_amp_ratio']:.2f}x the monolithic twin's "
        f"{stats['monolithic_write_amp']} (ceiling "
        f"{COMPACT_WRITE_AMP_CEIL:.0%}) — the O(overlap) slice "
        f"selection lost its edge over merge-all")
    stall_ceil = max(COMPACT_STALL_FLOOR_MS,
                     COMPACT_STALL_RATIO_CEIL
                     * stats["monolithic_commit_max_ms"])
    assert stats["leveled_commit_p99_ms"] <= stall_ceil, (
        f"leveled commit p99 {stats['leveled_commit_p99_ms']:.1f}ms "
        f"exceeds {stall_ceil:.1f}ms (the "
        f"{COMPACT_STALL_RATIO_CEIL:.0%}-of-monolithic-max bound) — a "
        f"commit is awaiting a merge again")
    return elapsed


def _fresh_sim_state() -> None:
    """The process-wide state a simulation reads, as a fresh process has
    it: BUGGIFY off, no client API version selected, the span rollup
    and ids and the transactions' class-wide probe ids at zero (the
    trace's ids and every role's status metrics read them).  Without
    it a simulated stage's stats depend on what ran before it."""
    from ..client.multiversion import _reset_api_version_for_tests
    from ..client.transaction import Transaction
    from ..runtime import span
    from ..runtime.buggify import enable_buggify
    enable_buggify(False)
    _reset_api_version_for_tests()
    span.reset_totals()
    Transaction._probe_counter = 0


def observe_seconds(deadline_s: float | None = None,
                    device=None) -> tuple[float, dict]:
    """The metrics-plane smoke, two halves:

    1. **Cadence + lag + audit under the seeded sim**: a 5-machine
       recruited cluster with METRICS_INTERVAL pinned small — every
       wired role kind (grv/commit proxies, resolver, tlog, storage,
       sequencer, ratekeeper, DD, CC, worker) must emit periodic
       ``*Metrics`` events on the virtual-clock cadence; the
       ``cluster.lag`` rollup served by the real status path must be
       sane under load; ``metrics_tool`` must reconstruct the
       durability-lag series and the epoch-1 RecoveryState audit from
       the recorded events alone.
    2. **Overhead A/B on the real loop**: the batched apply pipeline
       with the registry emitter ON at a deliberately hot cadence vs
       OFF — plane-on wall time must hold within
       ``OBSERVE_OVERHEAD_CEIL`` of plane-off (min-of-N per side, an
       absolute slack floor under the ratio for box noise).

    The simulated cluster's resolvers and read mirrors run on
    ``device``."""
    from ..core.cluster_controller import ClusterConfigSpec
    from ..core.data import KeyRange, Mutation
    from ..core.status import cluster_status
    from ..core.storage_server import StorageServer
    from ..core.tlog import TLog
    from ..ops.conflict_torch import default_device
    from ..runtime.knobs import Knobs
    from ..runtime.metrics import MetricsRegistry
    from ..runtime.simloop import run_simulation
    from ..runtime.trace import (Severity, TraceLog, get_trace_log,
                                 set_trace_log)
    from ..sim.cluster_sim import SimulatedCluster
    from . import metrics_tool

    device = default_device(device)
    _fresh_sim_state()
    t_all = time.perf_counter()
    stats: dict = {}

    # ---- half 1: cadence + lag + recovery audit (virtual time) ----
    events: list[dict] = []
    sink = TraceLog(min_severity=Severity.INFO)
    sink.sink = events.append
    prev_log = get_trace_log()
    set_trace_log(sink)
    status_doc: dict = {}

    async def sim_main() -> None:
        knobs = Knobs().override(METRICS_INTERVAL=OBSERVE_INTERVAL_S,
                                 METRICS_EMITTER=True,
                                 DD_ENABLED=True,
                                 STORAGE_DURABILITY_LAG=0.1)
        sim = SimulatedCluster(knobs, n_machines=5, durable_storage=True,
                               spec=ClusterConfigSpec(min_workers=5,
                                                      replication=2),
                               device=device)
        await sim.start()
        await asyncio.wait_for(sim.wait_epoch(1), 120)
        db = await sim.database()
        for i in range(8):
            async def body(tr, i=i):
                tr.set(b"obs%04d" % i, b"v" * 64)
            await db.run(body)
        # let the plane record several intervals of the loaded cluster
        await asyncio.sleep(OBSERVE_SIM_SECONDS)
        nonlocal status_doc
        t = sim.client_transport()
        status_doc = await asyncio.wait_for(
            cluster_status(knobs, t, sim.coordinator_stubs(t)), 60)
        await sim.stop()

    try:
        run_simulation(sim_main(), seed=20250804)
    finally:
        set_trace_log(prev_log)

    expected = ("ProxyCommitMetrics", "GrvProxyMetrics", "ResolverMetrics",
                "TLogMetrics", "StorageMetrics", "SequencerMetrics",
                "RatekeeperMetrics", "WorkerMetrics",
                "ClusterControllerMetrics", "DataDistributionMetrics")
    series = metrics_tool.extract_series(events)
    cadences: dict[str, float] = {}
    for kind in expected:
        rows = [v for k, v in series.items()
                if k == kind or k.startswith(kind + "/")]
        n = sum(len(r) for r in rows)
        assert rows and n >= 2, (
            f"role kind {kind} emitted {n} *Metrics events — the "
            f"registry never carried it, the plane has a hole")
        # cadence: per-series emission gaps ride the virtual clock, so
        # the emitter's sleep(interval) shows up as near-exact gaps
        gaps = [b.get("Time", 0.0) - a.get("Time", 0.0)
                for r in rows for a, b in zip(r, r[1:])]
        if gaps:
            mean = sum(gaps) / len(gaps)
            cadences[kind] = round(mean, 3)
            assert 0.4 * OBSERVE_INTERVAL_S <= mean <= 3 * OBSERVE_INTERVAL_S, (
                f"{kind} emission cadence {mean:.3f}s is off the "
                f"{OBSERVE_INTERVAL_S}s interval — the emitter is not "
                f"driving this source on the sim clock")
    stats["sim_metrics_events"] = sum(len(r) for r in series.values())
    stats["cadence_mean_s"] = cadences

    lag = status_doc["cluster"]["lag"]
    assert lag["committed_version"] and lag["committed_version"] > 0, lag
    assert lag["worst_durability_lag_versions"] >= 0, lag
    assert 0.0 <= lag["window_occupancy"] <= 2.0, lag
    assert lag["frontier_skew_versions"] >= 0, lag
    assert "slow_tasks" in status_doc["cluster"]
    stats["cluster_lag"] = {k: lag[k] for k in
                            ("worst_durability_lag_versions",
                             "window_occupancy", "frontier_skew_versions",
                             "committed_minus_applied")}

    # the tool chain over the recorded events: the durability-lag
    # series reconstructs per tag, and epoch 1's audit is complete
    ls = metrics_tool.lag_series(events)
    assert ls["storage"] and all(len(v) >= 2 for v in ls["storage"].values()), (
        "metrics_tool could not reconstruct a storage lag series from "
        "the recorded events")
    recs = metrics_tool.recovery_report(events)
    assert recs and recs[0]["epoch"] == 1 and recs[0]["completed"], recs
    assert recs[0]["recovery_version"] is not None
    stats["lag_series_tags"] = len(ls["storage"])
    stats["recovery_steps"] = len(recs[0]["steps"])

    # ---- half 2: plane-on vs plane-off apply overhead (real loop) ----
    def apply_side(emitter: bool) -> float:
        async def run_once() -> float:
            knobs = Knobs().override(METRICS_INTERVAL=OBSERVE_AB_INTERVAL_S,
                                     METRICS_EMITTER=emitter)
            ss = StorageServer(knobs, 0, KeyRange(b"", b"\xff"), TLog(knobs),
                           device=device)
            reg = MetricsRegistry()
            reg.add_role(ss)
            if emitter:
                reg.start_emitter(OBSERVE_AB_INTERVAL_S)
            keys = [b"obs%010d" % ((i * 2654435761) % (1 << 33))
                    for i in range(OBSERVE_AB_KEYS)]
            value = b"x" * 64
            version = 0
            t0 = time.perf_counter()
            for start in range(0, OBSERVE_AB_KEYS, 2048):
                version += 1
                ss._apply_batch([(version, [Mutation.set(k, value) for k
                                            in keys[start:start + 2048]])])
                # the yield the emitter interleaves on — the plane's
                # whole overhead story happens between these batches
                await asyncio.sleep(0)
            elapsed = time.perf_counter() - t0
            await reg.stop_emitter()
            if emitter:
                assert reg.emissions > 0, (
                    "the emitter never fired inside the measured window "
                    "— the overhead A/B proved nothing")
            return elapsed

        return asyncio.run(run_once())

    # swallow the A/B's *Metrics spam (a file-less TraceLog writes to
    # stderr); alternating sides per round so box drift hits both
    drop = TraceLog()
    drop.sink = lambda ev: None
    set_trace_log(drop)
    try:
        on_times, off_times = [], []
        for _ in range(OBSERVE_AB_RUNS):
            on_times.append(apply_side(True))
            off_times.append(apply_side(False))
    finally:
        set_trace_log(prev_log)
    on_s, off_s = min(on_times), min(off_times)
    stats["apply_on_s"] = round(on_s, 3)
    stats["apply_off_s"] = round(off_s, 3)
    stats["overhead_ratio"] = round(on_s / max(off_s, 1e-9), 3)
    assert on_s <= off_s * OBSERVE_OVERHEAD_CEIL + OBSERVE_OVERHEAD_SLACK_S, (
        f"metrics plane overhead: apply with the emitter ON took "
        f"{on_s:.3f}s vs {off_s:.3f}s off "
        f"({stats['overhead_ratio']:.2f}x, ceiling "
        f"{OBSERVE_OVERHEAD_CEIL:.2f}x) — a gauge grew a scan or the "
        f"emitter stopped being O(sources) per tick")

    elapsed = time.perf_counter() - t_all
    if deadline_s is not None and elapsed > deadline_s:
        raise AssertionError(
            f"observe smoke overran its {deadline_s:.0f}s deadline "
            f"({elapsed:.1f}s)")
    return elapsed, stats


def check_observe(budget_s: float = OBSERVE_BUDGET_S,
                  quiet: bool = False, device=None) -> float:
    """Run the observability smoke; raises AssertionError on a missing
    role series, an off-cadence emitter, an insane lag rollup, a
    tool-chain reconstruction failure, or plane overhead past the
    ceiling."""
    elapsed, stats = observe_seconds(deadline_s=budget_s, device=device)
    if not quiet:
        print(f"[perf_smoke] observe: {stats['sim_metrics_events']} "
              f"*Metrics events across "
              f"{len(stats['cadence_mean_s'])} role kinds, "
              f"{stats['lag_series_tags']} lag series, "
              f"{stats['recovery_steps']} audit steps; overhead "
              f"{stats['apply_on_s']:.3f}s on vs "
              f"{stats['apply_off_s']:.3f}s off "
              f"({stats['overhead_ratio']:.2f}x)")
    assert elapsed < budget_s, (
        f"observe smoke took {elapsed:.1f}s (budget {budget_s:.0f}s)")
    return elapsed


def mesh_seconds(deadline_s: float | None = None,
                 device=None) -> tuple[float, dict]:
    """The routed-mesh A/B: 2-resolver clusters on the REAL commit path
    end to end, partition-skewed workload (every key in the bottom
    partition's range).  Routed mode sends the hot partition sparse
    sub-batches and the cold partition header-only version advances;
    broadcast mode (the verbatim twin) makes both resolvers scan every
    batch.  Asserts the throughput ratio, the fast-path share on the cold
    partition (every routed run), and live-path group fusion (every
    routed run).  The resolvers run the ``cuda`` backend on ``device``.

    The ratio pools ten routed/broadcast pairs (each side one cluster
    at the stage's window, warmup and clients; committed txns over
    measured seconds, summed per mode), in alternating order so drift
    over the stage reaches both modes alike.  One pair's ratio
    spreads widely about the mean (on an H100, 0.89-1.68 about 1.18 in
    56 pairs), so the pool, not one pair, holds the mean to the floor.
    One routed run before them is not measured: the process's one-time
    costs on the resolvers' device path (the kernels' first launches,
    the allocators' growth) land there instead of on the first measured
    side."""
    from ..bench.multi_resolver import _mesh_cluster_run
    from ..ops.conflict_torch import default_device
    from ..runtime.trace import TraceLog, get_trace_log, set_trace_log

    device = default_device(device)
    t_all = time.perf_counter()

    def side(routing: bool) -> dict:
        return asyncio.run(_mesh_cluster_run(
            2, routing, seconds=MESH_SECONDS, warmup_s=MESH_WARMUP_S,
            n_clients=MESH_CLIENTS, skewed=True, device=device))

    # the clusters trace eagerly; a file-less TraceLog spams stderr
    drop = TraceLog()
    drop.sink = lambda ev: None
    prev_log = get_trace_log()
    set_trace_log(drop)
    pairs = 10
    runs: dict[bool, list[dict]] = {True: [], False: []}
    try:
        side(True)
        for i in range(pairs):
            for routing in ((True, False) if i % 2 == 0 else (False, True)):
                runs[routing].append(side(routing))
    finally:
        set_trace_log(prev_log)

    def pooled(rs: list[dict]) -> float:
        return sum(r["committed"] for r in rs) / max(
            sum(r["elapsed_s"] for r in rs), 1e-9)

    routed_tps, bcast_tps = pooled(runs[True]), pooled(runs[False])
    ratio = routed_tps / max(bcast_tps, 1e-9)
    parts = [r["partitions"] for r in runs[True]]
    stats = {"routed_tps": round(routed_tps, 1),
             "broadcast_tps": round(bcast_tps, 1),
             "ratio": round(ratio, 2),
             "cold_header_frac": min(p[1]["header_only_frac"]
                                     for p in parts),
             "cold_skipped": min(p[1]["skipped_batches"] for p in parts),
             "hot_group_mean": min(p[0]["group_mean"] for p in parts)}
    assert ratio >= MESH_RATIO_FLOOR, (
        f"routed mesh {routed_tps:.0f} txns/s vs broadcast "
        f"{bcast_tps:.0f} ({ratio:.2f}x, floor "
        f"{MESH_RATIO_FLOOR}x, {pairs} pairs pooled: routed "
        f"{[r['txns_per_sec'] for r in runs[True]]}, broadcast "
        f"{[r['txns_per_sec'] for r in runs[False]]}) — routing stopped "
        f"paying on the skewed workload")
    assert stats["cold_header_frac"] > MESH_HEADER_FRAC_FLOOR, (
        f"cold partition answered only {stats['cold_header_frac']:.0%} of "
        f"its sends header-only in a routed run (floor "
        f"{MESH_HEADER_FRAC_FLOOR:.0%}) — the empty-clip fast path is not "
        f"firing")
    assert stats["cold_skipped"] > 0, \
        "the cold partition never took the fast path in a routed run"
    assert stats["hot_group_mean"] >= MESH_GROUP_MEAN_FLOOR, (
        f"hot partition fused group mean {stats['hot_group_mean']} in a "
        f"routed run (floor {MESH_GROUP_MEAN_FLOOR}) — group fusion is "
        f"not engaging on the live commit path again")

    elapsed = time.perf_counter() - t_all
    if deadline_s is not None and elapsed > deadline_s:
        raise AssertionError(
            f"mesh smoke overran its {deadline_s:.0f}s deadline "
            f"({elapsed:.1f}s)")
    return elapsed, stats


def check_mesh(budget_s: float = MESH_BUDGET_S, quiet: bool = False,
               device=None) -> float:
    """Run the routed-mesh smoke; raises AssertionError when routing
    stops beating broadcast, the fast path stops firing, or live-path
    fusion disengages."""
    elapsed, stats = mesh_seconds(deadline_s=budget_s, device=device)
    if not quiet:
        print(f"[perf_smoke] mesh: routed {stats['routed_tps']:.0f} vs "
              f"broadcast {stats['broadcast_tps']:.0f} txns/s "
              f"({stats['ratio']:.2f}x); cold partition "
              f"{stats['cold_header_frac']:.0%} header-only "
              f"({stats['cold_skipped']} skipped), hot group mean "
              f"{stats['hot_group_mean']}")
    assert elapsed < budget_s, (
        f"mesh smoke took {elapsed:.1f}s (budget {budget_s:.0f}s)")
    return elapsed


def scrub_seconds(deadline_s: float | None = None,
                  device=None) -> tuple[float, dict]:
    """The consistency-scrub smoke, two halves:

    1. **Detection under the seeded sim**: a recruited double-replicated
       cluster with the scrub plane ON and the pass cadence pinned hot.
       The first full pass must complete CLEAN (zero mismatches on an
       honest cluster — the false-positive guard), the watchdog must
       have checked invariants with zero violations, and then a single
       row corrupted on ONE replica via ``corrupt_for_test`` must be
       caught within one pass as a key-exact ``ScrubMismatch`` — and
       the catch must be visible through the status rollup
       (``cluster.scrub``) and ``metrics_tool.scrub_report`` alike.
    2. **Overhead A/B on twin sims**: the identical seeded
       write-then-idle sim run scrub-on vs scrub-off; scrub-on wall
       time must hold within ``SCRUB_OVERHEAD_CEIL`` of scrub-off (an
       absolute slack floor under the ratio for box noise).

    Every simulated cluster's resolvers and read mirrors run on
    ``device``."""
    from ..core.cluster_controller import ClusterConfigSpec
    from ..core.status import cluster_status
    from ..ops.conflict_torch import default_device
    from ..runtime.knobs import Knobs
    from ..runtime.simloop import run_simulation
    from ..runtime.trace import (Severity, TraceLog, get_trace_log,
                                 set_trace_log)
    from ..sim.cluster_sim import SimulatedCluster
    from . import metrics_tool

    device = default_device(device)
    _fresh_sim_state()
    t_all = time.perf_counter()
    stats: dict = {}

    # ---- half 1: clean pass, then key-exact catch (virtual time) ----
    events: list[dict] = []
    sink = TraceLog(min_severity=Severity.INFO)
    sink.sink = events.append
    prev_log = get_trace_log()
    set_trace_log(sink)
    status_doc: dict = {}
    bad_key = b""

    scrub_knobs = dict(SCRUB_ENABLED=True,
                       SCRUB_PASS_INTERVAL=0.5,
                       SCRUB_WATCHDOG_INTERVAL=0.5,
                       SCRUB_PAGES_PER_SEC=500.0,
                       SCRUB_PAGE_ROWS=SCRUB_SIM_PAGE_ROWS,
                       SCRUB_MAX_PAGES_PER_REQUEST=SCRUB_SIM_MAX_PAGES)

    async def sim_main() -> None:
        knobs = Knobs().override(METRICS_INTERVAL=1.0,
                                 METRICS_EMITTER=True,
                                 DD_ENABLED=True,
                                 STORAGE_DURABILITY_LAG=0.1,
                                 **scrub_knobs)
        sim = SimulatedCluster(knobs, n_machines=5, durable_storage=True,
                               spec=ClusterConfigSpec(min_workers=5,
                                                      replication=2),
                               device=device)
        await sim.start()
        await asyncio.wait_for(sim.wait_epoch(1), 120)
        db = await sim.database()
        keys = [b"scrub%04d" % i for i in range(SCRUB_KEYS)]
        for k in keys:
            async def body(tr, k=k):
                tr.set(k, b"good-" + k)
            await db.run(body)

        async def wait_for(pred, what: str):
            for _ in range(int(SCRUB_WAIT_S / 0.25)):
                if pred():
                    return
                await asyncio.sleep(0.25)
            raise AssertionError(
                f"scrub smoke: {what} did not happen within "
                f"{SCRUB_WAIT_S:.0f} virtual seconds")

        # the scrubber is CC-recruited after the first published state;
        # wait for it, then for the first CLEAN full pass
        await wait_for(lambda: sim.leader_scrubber() is not None,
                       "scrubber recruitment")
        scr = sim.leader_scrubber()
        await wait_for(lambda: scr.passes_complete >= 1,
                       "the first full scrub pass")
        assert scr.mismatch_rows == 0 and scr.mismatch_pages == 0, (
            f"FALSE POSITIVE: the scrubber reported "
            f"{scr.mismatch_rows} divergent rows on an honest cluster")
        assert not [e for e in events
                    if e.get("Type") == "ScrubMismatch"], (
            "FALSE POSITIVE: a ScrubMismatch event on an honest cluster")
        stats["clean_pass_pages"] = scr.last_pass_pages
        stats["clean_pass_version"] = scr.last_pass_version

        # bit-rot exactly one row on exactly one replica: pick a hosted
        # (storage, key) pair so the divergence is real on that team
        nonlocal bad_key
        victim = None
        for ss in sim.storage_objects():
            for k in keys:
                if ss.shard.begin <= k < ss.shard.end:
                    victim, bad_key = ss, k
                    break
            if victim is not None:
                break
        assert victim is not None, \
            "no storage object hosts any seeded key — sim shape changed"
        victim.corrupt_for_test(bad_key, b"BITROT-" + bad_key)
        pass_at_corrupt = scr.passes_complete
        await wait_for(lambda: scr.mismatch_rows > 0,
                       "detection of the injected corruption")
        stats["passes_to_detect"] = scr.passes_complete + 1 - pass_at_corrupt
        assert scr.invariant_checks > 0 and scr.invariant_violations == 0, (
            f"watchdog: {scr.invariant_checks} checks, "
            f"{scr.invariant_violations} violations on a healthy frontier")
        # one more pass END so the scrub_stats publish carries the catch
        settled = scr.passes_complete
        await wait_for(lambda: scr.passes_complete > settled,
                       "the post-detection publish pass")

        nonlocal status_doc
        t = sim.client_transport()
        status_doc = await asyncio.wait_for(
            cluster_status(knobs, t, sim.coordinator_stubs(t)), 60)
        await sim.stop()

    try:
        run_simulation(sim_main(), seed=20250806)
    finally:
        set_trace_log(prev_log)

    # the catch is key-exact in the raw trace: exact key hex, pinned
    # version, and BOTH replica addresses named
    hits = [e for e in events if e.get("Type") == "ScrubMismatch"]
    assert hits, "corruption was counted but no ScrubMismatch was traced"
    exact = [e for e in hits if e.get("Key") == bad_key.hex()]
    assert exact, (
        f"ScrubMismatch named keys {[e.get('Key') for e in hits]}, not "
        f"the corrupted {bad_key.hex()!r} — triage is not key-exact")
    ev = exact[0]
    assert ev.get("Version", 0) > 0 and ev.get("Severity") == 40, ev
    assert len(str(ev.get("Replicas", "")).split(",")) == 2, (
        f"mismatch named {ev.get('Replicas')!r}, not both replicas")
    stats["mismatch_events"] = len(hits)

    scrub = status_doc["cluster"]["scrub"]
    assert scrub["enabled"] and scrub["passes_complete"] >= 2, scrub
    assert scrub["mismatch_rows"] >= 1 and scrub["last_pass_version"] > 0, \
        scrub
    assert scrub["pages_per_sec"] > 0 and scrub["invariant_checks"] > 0, \
        scrub
    assert scrub["invariant_violations"] == 0, scrub
    stats["status_scrub"] = {k: scrub[k] for k in
                             ("passes_complete", "pages_scrubbed",
                              "mismatch_rows", "pages_per_sec",
                              "invariant_checks")}

    # the tool chain over the recorded events agrees with status
    rep = metrics_tool.scrub_report(events)
    assert rep["summary"]["passes_complete"] >= 2, rep["summary"]
    assert any(m["key"] == bad_key.hex() for m in rep["mismatches"]), (
        "metrics_tool scrub view lost the key-exact mismatch")
    assert not rep["violations"], rep["violations"]
    assert rep["progress_samples"] >= 2, (
        "no ScrubMetrics progress series — the scrubber never joined "
        "the worker's metrics registry")

    # ---- half 2: scrub-on vs scrub-off twin-sim overhead (wall) ----
    def twin(scrub_on: bool) -> float:
        async def side() -> None:
            kn = dict(scrub_knobs) if scrub_on else {"SCRUB_ENABLED": False}
            knobs = Knobs().override(DD_ENABLED=True,
                                     STORAGE_DURABILITY_LAG=0.1, **kn)
            sim = SimulatedCluster(knobs, n_machines=5,
                                   durable_storage=True,
                                   spec=ClusterConfigSpec(min_workers=5,
                                                          replication=2),
                                   device=device)
            await sim.start()
            await asyncio.wait_for(sim.wait_epoch(1), 120)
            db = await sim.database()
            for i in range(SCRUB_AB_KEYS):
                async def body(tr, i=i):
                    tr.set(b"ab%04d" % i, b"v" * 64)
                await db.run(body)
            await asyncio.sleep(SCRUB_AB_SECONDS)
            if scrub_on:
                scr = sim.leader_scrubber()
                assert scr is not None and scr.passes_complete >= 1, (
                    "the scrub-on twin never completed a pass — the "
                    "overhead A/B proved nothing")
            await sim.stop()

        t0 = time.perf_counter()
        run_simulation(side(), seed=20250807)
        return time.perf_counter() - t0

    drop = TraceLog()
    drop.sink = lambda ev: None
    set_trace_log(drop)
    try:
        on_s = twin(True)
        off_s = twin(False)
    finally:
        set_trace_log(prev_log)
    stats["sim_on_s"] = round(on_s, 3)
    stats["sim_off_s"] = round(off_s, 3)
    stats["overhead_ratio"] = round(on_s / max(off_s, 1e-9), 3)
    assert on_s <= off_s * SCRUB_OVERHEAD_CEIL + SCRUB_OVERHEAD_SLACK_S, (
        f"scrub overhead: the scrub-on twin took {on_s:.3f}s vs "
        f"{off_s:.3f}s off ({stats['overhead_ratio']:.2f}x, ceiling "
        f"{SCRUB_OVERHEAD_CEIL:.2f}x) — the audit plane stopped being "
        f"a background whisper")

    elapsed = time.perf_counter() - t_all
    if deadline_s is not None and elapsed > deadline_s:
        raise AssertionError(
            f"scrub smoke overran its {deadline_s:.0f}s deadline "
            f"({elapsed:.1f}s)")
    return elapsed, stats


def check_scrub(budget_s: float = SCRUB_BUDGET_S,
                quiet: bool = False, device=None) -> float:
    """Run the consistency-scrub smoke; raises AssertionError on a
    false positive, a missed or key-inexact catch, a watchdog
    violation on a healthy cluster, a broken consumer surface, or
    scrub overhead past the ceiling."""
    elapsed, stats = scrub_seconds(deadline_s=budget_s, device=device)
    if not quiet:
        print(f"[perf_smoke] scrub: clean pass of "
              f"{stats['clean_pass_pages']} pages, injected row caught "
              f"in {stats['passes_to_detect']} pass(es) "
              f"({stats['mismatch_events']} ScrubMismatch events); "
              f"status {stats['status_scrub']}; overhead "
              f"{stats['sim_on_s']:.1f}s on vs "
              f"{stats['sim_off_s']:.1f}s off "
              f"({stats['overhead_ratio']:.2f}x)")
    assert elapsed < budget_s, (
        f"scrub smoke took {elapsed:.1f}s (budget {budget_s:.0f}s)")
    return elapsed


def devplane_seconds(deadline_s: float | None = None,
                     device=None) -> tuple[float, dict]:
    """The sharded device plane, two in-run A/Bs on ``device``, each side
    run by ``bench/device_plane.py``:

    1. **Sharded read mirror vs the single-directory twin** under a
       churn workload: every round inserts a tail-localized key span
       (bumping the packed index gen) and then probes batched reads.
       The twin mirror goes stale on EVERY round — its first post-churn
       batch falls back to the engine and pays a full re-upload — while
       the sharded mirror partial-refreshes only the touched tail shard
       and serves the same batch off the device inline.  The gate is
       device-SERVED batches (deterministic, not wall noise): sharded
       must serve >= DEVPLANE_MIRROR_FLOOR x the twin's count, with
       >= 2 shards (``DEVPLANE_SHARDS`` prefix tensors on the one card),
       with results byte-identical to the engine on both sides.

    2. **Verdict-bitmask readback vs the raw-vector twin**: the same
       mostly-clean proxy batches through DevicePipeline on the ``cuda``
       backend with RESOLVER_VERDICT_BITMASK on vs off.  Packed
       readback syncs a 4-byte group summary per clean dispatch (the
       two bit planes only when a dispatch carries an abort), so
       readback bytes/txn must drop >= DEVPLANE_BITMASK_FLOOR x with
       verdicts asserted bit-identical — and the workload must carry
       real aborts or the parity proves nothing."""
    from ..bench import device_plane as dp
    from ..ops.conflict_torch import default_device

    device = default_device(device)
    t_all = time.perf_counter()
    stats: dict = {}
    # the cards the run sees (the shards share one of them)
    stats["devices"] = (torch.cuda.device_count() if device.type == "cuda"
                        else 0)

    # ---- half 1: sharded mirror vs single-directory twin ----
    def mirror_side(shards: int) -> tuple[float, int, "DeviceReadServer"]:
        seconds, _, srv = dp.mirror_side(
            shards, device, n_keys=DEVPLANE_MIRROR_KEYS,
            rounds=DEVPLANE_ROUNDS, churn_keys=DEVPLANE_CHURN_KEYS,
            probes=DEVPLANE_PROBES, per_round=DEVPLANE_BATCHES_PER_ROUND)
        return seconds, srv.served_batches, srv

    twin_s, twin_served, twin_srv = mirror_side(0)
    shard_s, shard_served, shard_srv = mirror_side(DEVPLANE_SHARDS)
    total = DEVPLANE_ROUNDS * DEVPLANE_BATCHES_PER_ROUND
    stats["twin_served"] = twin_served
    stats["sharded_served"] = shard_served
    stats["twin_s"] = round(twin_s, 3)
    stats["sharded_s"] = round(shard_s, 3)
    m = shard_srv.metrics()
    stats["shards"] = m.get("device_read_shards", 0)
    assert stats["shards"] >= 2, (
        f"devplane smoke needs >= 2 mirror shards, got {stats['shards']} "
        f"— the sharded directory did not arm")
    stats["shard_refreshes"] = m["device_read_shard_refreshes"]
    stats["full_splits"] = m["device_read_full_splits"]
    served_ratio = shard_served / max(twin_served, 1)
    stats["served_ratio"] = round(served_ratio, 2)
    assert shard_served == total, (
        f"sharded mirror served only {shard_served}/{total} batches off "
        f"the device — partial refresh stopped keeping churned rounds "
        f"on the device path")
    assert served_ratio >= DEVPLANE_MIRROR_FLOOR, (
        f"sharded mirror served {shard_served} device batches vs the "
        f"twin's {twin_served} ({served_ratio:.2f}x, floor "
        f"{DEVPLANE_MIRROR_FLOOR}x) — sharding stopped paying under "
        f"churn")
    assert m["device_read_full_splits"] == 1, (
        f"{m['device_read_full_splits']} full re-splits — the change "
        f"log stopped carrying partial refreshes")
    assert m["device_read_shard_refreshes"] < 1 + DEVPLANE_SHARDS \
        + DEVPLANE_ROUNDS * DEVPLANE_SHARDS // 2, (
        f"{m['device_read_shard_refreshes']} shard re-uploads across "
        f"{DEVPLANE_ROUNDS} tail-churn rounds — refreshes stopped "
        f"being localized")

    # ---- half 2: verdict-bitmask readback vs the raw-vector twin ----
    batches, versions = dp._proxy_batches(DEVPLANE_VERDICT_BATCHES,
                                          DEVPLANE_VERDICT_TXNS)
    base = dp._base_knobs(DEVPLANE_VERDICT_TXNS)

    def verdict_side(knobs) -> tuple[list, float]:
        rows, _, bpt = dp._pipeline_pass(knobs, batches, versions, device)
        return rows, bpt

    raw, raw_bpt = verdict_side(
        base.override(RESOLVER_VERDICT_BITMASK=False))
    packed, packed_bpt = verdict_side(
        base.override(RESOLVER_VERDICT_BITMASK=True))
    assert raw == packed, (
        "verdict-bitmask readback is NOT bit-identical to the "
        "raw-vector twin — the reduction changed verdict semantics")
    aborts = sum(1 for x in raw if x != 0)
    assert aborts > 0, (
        "no aborts in the devplane verdict workload — the bitmask "
        "parity proved nothing about the set-bit planes")
    bitmask_ratio = raw_bpt / max(packed_bpt, 1e-9)
    stats["raw_bytes_per_txn"] = round(raw_bpt, 2)
    stats["packed_bytes_per_txn"] = round(packed_bpt, 3)
    stats["bitmask_ratio"] = round(bitmask_ratio, 1)
    stats["aborts"] = aborts
    assert bitmask_ratio >= DEVPLANE_BITMASK_FLOOR, (
        f"verdict readback {raw_bpt:.1f} B/txn raw vs {packed_bpt:.2f} "
        f"packed ({bitmask_ratio:.1f}x, floor {DEVPLANE_BITMASK_FLOOR}x)"
        f" — the bitmask reduction stopped paying")

    elapsed = time.perf_counter() - t_all
    if deadline_s is not None and elapsed > deadline_s:
        raise AssertionError(
            f"devplane smoke overran its {deadline_s:.0f}s deadline "
            f"({elapsed:.1f}s)")
    return elapsed, stats


def check_devplane(budget_s: float = DEVPLANE_BUDGET_S,
                   quiet: bool = False, device=None) -> float:
    """Run the device-plane smoke; raises AssertionError when the
    sharded mirror stops out-serving the single-directory twin under
    churn, when partial refresh degrades to full re-splits, or when the
    verdict-bitmask readback stops cutting bytes/txn (or stops being
    bit-identical)."""
    elapsed, stats = devplane_seconds(deadline_s=budget_s, device=device)
    if not quiet:
        print(f"[perf_smoke] devplane: sharded mirror served "
              f"{stats['sharded_served']} device batches vs twin "
              f"{stats['twin_served']} ({stats['served_ratio']:.1f}x, "
              f"{stats['shard_refreshes']} shard refreshes / "
              f"{stats['full_splits']} full split over {stats['shards']} "
              f"shards on {stats['devices']} cards); verdict readback {stats['raw_bytes_per_txn']} "
              f"-> {stats['packed_bytes_per_txn']} B/txn "
              f"({stats['bitmask_ratio']:.0f}x, {stats['aborts']} aborts)")
    assert elapsed < budget_s, (
        f"devplane smoke took {elapsed:.1f}s (budget {budget_s:.0f}s)")
    return elapsed


def layers_seconds(deadline_s: float | None = None,
                   device=None) -> tuple[float, dict]:
    """The layer-ecosystem smoke, one seeded recruited sim (its
    resolvers and read mirrors on ``device``):

    - the full client-side layer stack on ONE whole-db feed — consumer,
      async :class:`SecondaryIndex`, :class:`ReadThroughCache`,
      :class:`WatchRegistry` — with every layer role registered on a
      live :class:`MetricsRegistry` emitter so ``Layer*Metrics`` land
      on the virtual-clock cadence;
    - a zipf-``LAYERS_ZIPF_S`` read tier (``LAYERS_READS`` ops,
      ``LAYERS_WRITE_FRACTION`` invalidating writers) through the cache
      must hold ``LAYERS_HIT_RATE_FLOOR``, with sampled reads re-proved
      against authoritative reads pinned at the cache's claimed
      valid-through version (zero stale);
    - a watch registered before its key's next commit must fire with
      the commit's version;
    - the consistency checker must reach a real verdict (refusals
      retried away) with ZERO divergences on the honest stack; then one
      index row rotted OUTSIDE the maintenance path must be caught
      key-exactly on the very next pass;
    - the catch and the progress series must be visible through the
      ``cluster.layers`` status rollup and ``metrics_tool``'s layers
      view alike."""
    import random

    from ..client.subspace import Subspace
    from ..core.cluster_controller import ClusterConfigSpec
    from ..core.status import cluster_status
    from ..layers import (LayerConsistencyChecker, LayerFeedConsumer,
                          ReadThroughCache, SecondaryIndex, WatchRegistry)
    from ..ops.conflict_torch import default_device
    from ..runtime.knobs import Knobs
    from ..runtime.metrics import MetricsRegistry
    from ..runtime.simloop import run_simulation
    from ..runtime.trace import (Severity, TraceLog, get_trace_log,
                                 set_trace_log)
    from ..sim.cluster_sim import SimulatedCluster
    from ..workloads.layers import zipf_cdf, zipf_pick
    from . import metrics_tool

    device = default_device(device)
    _fresh_sim_state()
    t_all = time.perf_counter()
    stats: dict = {}
    events: list[dict] = []
    sink = TraceLog(min_severity=Severity.INFO)
    sink.sink = events.append
    prev_log = get_trace_log()
    set_trace_log(sink)
    status_doc: dict = {}
    canary_key = b""

    async def sim_main() -> None:
        knobs = Knobs().override(METRICS_INTERVAL=1.0,
                                 METRICS_EMITTER=True,
                                 DD_ENABLED=True,
                                 STORAGE_DURABILITY_LAG=0.1,
                                 LAYER_FEED_POLL_INTERVAL=0.05,
                                 LAYER_PROGRESS_INTERVAL=0.5)
        sim = SimulatedCluster(knobs, n_machines=5, durable_storage=True,
                               spec=ClusterConfigSpec(min_workers=5,
                                                      replication=2),
                               device=device)
        await sim.start()
        await asyncio.wait_for(sim.wait_epoch(1), 120)
        db = await sim.database()

        async def wait_for(pred, what: str):
            for _ in range(int(LAYERS_WAIT_S / 0.25)):
                if pred():
                    return
                await asyncio.sleep(0.25)
            raise AssertionError(
                f"layers smoke: {what} did not happen within "
                f"{LAYERS_WAIT_S:.0f} virtual seconds")

        # the stack: one feed, four layer roles, all on the emitter
        consumer = LayerFeedConsumer(db, name="smoke")
        index = SecondaryIndex(db, Subspace(raw_prefix=b"idx/"),
                               primary_begin=b"tier/",
                               primary_end=b"tier0",
                               mode="async", consumer=consumer)
        cache = ReadThroughCache(db, consumer, capacity=LAYERS_KEYS)
        watches = WatchRegistry(db, consumer)
        checker = LayerConsistencyChecker(db, index=index, cache=cache,
                                          watches=watches)
        registry = MetricsRegistry()
        for role in (consumer, index, cache, watches, checker):
            registry.add_role(role, default_id="smoke")
        registry.start_emitter(0.5)
        await consumer.start()
        await index.start_async()

        keys = [b"tier/%08d" % i for i in range(LAYERS_KEYS)]
        BATCH = 100
        for start in range(0, LAYERS_KEYS, BATCH):
            async def fill(tr, start=start):
                for i in range(start, min(start + BATCH, LAYERS_KEYS)):
                    tr.set(keys[i], b"v0-%08d" % i)
            await db.run(fill)

        # a watch armed BEFORE its key's next commit fires with it
        fut = await watches.watch(keys[7])
        async def bump(tr):
            tr.set(keys[7], b"v1-watched")
        await db.run(bump)
        fired_at = await asyncio.wait_for(fut, LAYERS_WAIT_S)
        assert fired_at > 0, "the watch resolved without a version"

        # the zipf read tier, with a sampled inline staleness proof
        rng = random.Random(20250807)
        cdf = zipf_cdf(LAYERS_KEYS, LAYERS_ZIPF_S)
        stale = reads = writes = 0
        for n in range(LAYERS_READS):
            key = keys[zipf_pick(cdf, rng.random())]
            if rng.random() < LAYERS_WRITE_FRACTION:
                writes += 1
                async def body(tr, key=key, n=n):
                    tr.set(key, b"v%d" % n)
                await db.run(body)
            else:
                reads += 1
                value, valid_through = await cache.get_versioned(key)
                if n % 16 == 0:
                    tr = db.create_transaction()
                    try:
                        tr.set_read_version(valid_through)
                        if await tr.get(key, snapshot=True) != value:
                            stale += 1
                    finally:
                        tr.reset()
        assert stale == 0, (
            f"{stale} cached reads diverged from the authoritative "
            f"value at their claimed valid-through version")
        stats["reads"] = reads
        stats["writes"] = writes
        stats["hit_rate"] = round(cache.hit_rate, 4)
        assert cache.hit_rate >= LAYERS_HIT_RATE_FLOOR, (
            f"cache hit rate {cache.hit_rate:.3f} under "
            f"zipf-{LAYERS_ZIPF_S} fell below the "
            f"{LAYERS_HIT_RATE_FLOOR:.2f} floor")

        # an honest stack must yield a real verdict with zero
        # divergences — refusals are retried away, never counted
        tr = db.create_transaction()
        tip = await tr.get_read_version()
        tr.reset()
        await consumer.wait_frontier(tip, timeout=LAYERS_WAIT_S)

        async def settled_check(kinds):
            """A checker pass with a verdict on each of ``kinds``: a pass
            whose checkpoint moved under its reads is refused, and
            retried (up to 40 times, 0.5 s apart)."""
            for _ in range(40):
                verdict = await checker.check()
                if not any(verdict[k]["refused"] for k in kinds):
                    break
                await asyncio.sleep(0.5)
            return verdict

        verdict = await settled_check(("index", "cache", "watches"))
        assert verdict["divergences"] == 0, (
            f"FALSE POSITIVE: the checker reported divergences on an "
            f"honest layer stack: {verdict}")
        assert not verdict["index"]["refused"], (
            "the async index never reached a stable checkpoint")
        stats["clean_rows_checked"] = verdict["rows_checked"]

        # rot one index row behind the maintainer's back (a direct
        # write into the index subspace — outside the primary range, so
        # the feed applier never sees it) and demand a key-exact catch
        nonlocal canary_key
        canary_key = index.row_key(b"ROT!", b"tier/no-such-pkey")
        async def rot(tr):
            tr.set(canary_key, b"")
        await db.run(rot)
        caught = await settled_check(("index",))
        assert caught["index"]["divergences"] == 1, (
            f"the rotted index row went uncaught: {caught}")
        stats["passes"] = checker.passes

        # one emitter tick + one progress publish so the consumer
        # surfaces carry the catch
        await asyncio.sleep(1.5)
        nonlocal status_doc
        t = sim.client_transport()
        status_doc = await asyncio.wait_for(
            cluster_status(knobs, t, sim.coordinator_stubs(t)), 60)
        await registry.stop_emitter()
        await consumer.stop(destroy=True)
        await sim.stop()

    try:
        run_simulation(sim_main(), seed=20250807)
    finally:
        set_trace_log(prev_log)

    # the catch is key-exact in the raw trace, and it is the ONLY one
    hits = [e for e in events if e.get("Type") == "LayerMismatch"]
    assert [e.get("Key") for e in hits] == [canary_key.hex()], (
        f"LayerMismatch named {[e.get('Key') for e in hits]}, not "
        f"exactly the rotted {canary_key.hex()!r}")
    assert hits[0].get("Layer") == "index" and \
        hits[0].get("Severity") == 40, hits[0]

    # the status rollup serves the feed's published progress
    layers = status_doc["cluster"]["layers"]
    assert layers["active"] >= 1, layers
    smoke = [c for c in layers["consumers"] if c["name"] == "smoke"]
    assert smoke and smoke[0]["frontier"] > 0, layers
    assert smoke[0]["entries_delivered"] > 0, layers
    assert not smoke[0]["destroyed"], layers
    stats["status_frontier"] = smoke[0]["frontier"]
    stats["status_lag"] = smoke[0]["lag_versions"]

    # the tool chain over the recorded events agrees
    rep = metrics_tool.layers_report(events)
    assert rep["summary"]["divergences"] == 1, rep["summary"]
    assert any(m["key"] == canary_key.hex() for m in rep["mismatches"]), (
        "metrics_tool layers view lost the key-exact mismatch")
    assert rep["summary"]["cache_hit_rate"] >= LAYERS_HIT_RATE_FLOOR, \
        rep["summary"]
    assert rep["summary"]["checker_passes"] >= 2, rep["summary"]
    assert rep["summary"]["feed_frontier"] > 0, rep["summary"]
    assert rep["progress_samples"] >= 2, (
        "no Layer*Metrics progress series — the layer roles never "
        "joined the metrics emitter")
    stats["progress_samples"] = rep["progress_samples"]

    elapsed = time.perf_counter() - t_all
    if deadline_s is not None and elapsed > deadline_s:
        raise AssertionError(
            f"layers smoke overran its {deadline_s:.0f}s deadline "
            f"({elapsed:.1f}s)")
    return elapsed, stats


def check_layers(budget_s: float = LAYERS_BUDGET_S,
                 quiet: bool = False, device=None) -> float:
    """Run the layer-ecosystem smoke; raises AssertionError on a stale
    cached read, a hit rate under the zipf floor, a checker false
    positive, a missed or key-inexact canary catch, or a broken
    consumer surface (status rollup / metrics_tool / trace)."""
    elapsed, stats = layers_seconds(deadline_s=budget_s, device=device)
    if not quiet:
        print(f"[perf_smoke] layers: hit rate {stats['hit_rate']:.3f} "
              f"over {stats['reads']} zipf reads "
              f"({stats['writes']} invalidating writes, 0 stale); "
              f"checker clean over {stats['clean_rows_checked']} rows, "
              f"rotted row caught key-exactly "
              f"({stats['passes']} passes); status frontier "
              f"{stats['status_frontier']} (lag {stats['status_lag']}), "
              f"{stats['progress_samples']} progress samples")
    assert elapsed < budget_s, (
        f"layers smoke took {elapsed:.1f}s (budget {budget_s:.0f}s)")
    return elapsed



STAGES = ("apply", "pipeline", "feed", "read", "resolve", "heat", "backup",
          "scan", "bigkeys", "recover", "mvcc", "compact", "observe",
          "mesh", "scrub", "devplane", "layers")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="foundationdb_tpu_torch.tools.perf_smoke")
    ap.add_argument("-n", "--keys", type=int, default=DEFAULT_KEYS)
    ap.add_argument("--budget", type=float, default=DEFAULT_BUDGET_S)
    ap.add_argument("--stage", choices=STAGES + ("all",), default="all")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where every stage's devices run: the CUDA card "
                    "(the default) or the CPU (the kernels' plain versions)")
    ap.add_argument("--txns", type=int, default=PIPE_TXNS)
    ap.add_argument("--pipe-budget", type=float, default=PIPE_BUDGET_S)
    ap.add_argument("--feed-budget", type=float, default=FEED_BUDGET_S)
    ap.add_argument("--read-budget", type=float, default=READ_BUDGET_S)
    ap.add_argument("--resolve-budget", type=float,
                    default=RESOLVE_BUDGET_S)
    ap.add_argument("--heat-budget", type=float, default=HEAT_BUDGET_S)
    ap.add_argument("--backup-budget", type=float, default=BACKUP_BUDGET_S)
    ap.add_argument("--scan-budget", type=float, default=SCAN_BUDGET_S)
    ap.add_argument("--big-keys", type=int, default=BIG_KEYS)
    ap.add_argument("--big-budget", type=float, default=BIG_BUDGET_S)
    ap.add_argument("--recover-budget", type=float,
                    default=RECOVER_BUDGET_S)
    ap.add_argument("--mvcc-keys", type=int, default=MVCC_KEYS)
    ap.add_argument("--mvcc-budget", type=float, default=MVCC_BUDGET_S)
    ap.add_argument("--compact-budget", type=float,
                    default=COMPACT_BUDGET_S)
    ap.add_argument("--observe-budget", type=float,
                    default=OBSERVE_BUDGET_S)
    ap.add_argument("--mesh-budget", type=float, default=MESH_BUDGET_S)
    ap.add_argument("--scrub-budget", type=float, default=SCRUB_BUDGET_S)
    ap.add_argument("--devplane-budget", type=float,
                    default=DEVPLANE_BUDGET_S)
    ap.add_argument("--layers-budget", type=float,
                    default=LAYERS_BUDGET_S)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from ..ops import kernels
        kernels.build_missing()     # no measured loop holds an nvcc run
    runs = {
        "apply": lambda: check(args.keys, args.budget, device=dev),
        "pipeline": lambda: check_pipeline(args.txns,
                                           budget_s=args.pipe_budget,
                                           device=dev),
        "feed": lambda: check_feed(budget_s=args.feed_budget, device=dev),
        "read": lambda: check_read(budget_s=args.read_budget, device=dev),
        "resolve": lambda: check_resolve(budget_s=args.resolve_budget,
                                         device=dev),
        "heat": lambda: check_heat(budget_s=args.heat_budget, device=dev),
        "backup": lambda: check_backup(budget_s=args.backup_budget,
                                       device=dev),
        "scan": lambda: check_scan(budget_s=args.scan_budget, device=dev),
        "bigkeys": lambda: check_bigkeys(args.big_keys,
                                         budget_s=args.big_budget,
                                         device=dev),
        "recover": lambda: check_recover(budget_s=args.recover_budget,
                                         device=dev),
        "mvcc": lambda: check_mvcc(args.mvcc_keys,
                                   budget_s=args.mvcc_budget, device=dev),
        "compact": lambda: check_compact(budget_s=args.compact_budget,
                                         device=dev),
        "observe": lambda: check_observe(budget_s=args.observe_budget,
                                         device=dev),
        "mesh": lambda: check_mesh(budget_s=args.mesh_budget, device=dev),
        "scrub": lambda: check_scrub(budget_s=args.scrub_budget,
                                     device=dev),
        "devplane": lambda: check_devplane(budget_s=args.devplane_budget,
                                           device=dev),
        "layers": lambda: check_layers(budget_s=args.layers_budget,
                                       device=dev),
    }
    for name in STAGES:
        if args.stage in (name, "all"):
            before = _launches()
            t0 = time.perf_counter()
            runs[name]()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            print(f"[perf_smoke] stage {name}: "
                  f"{time.perf_counter() - t0:.3f} s, launches "
                  f"{_launched_since(before)}", flush=True)
    return 0


def _launches() -> dict:
    from ..ops import kernels
    return {k: v.launches for k, v in kernels.KERNELS.items()}


def _launched_since(before: dict) -> dict:
    return {k: n - before[k] for k, n in _launches().items()}


if __name__ == "__main__":
    raise SystemExit(main())
