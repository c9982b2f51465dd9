#!/usr/bin/env python
"""Perf smoke of the device commit pipeline (the ``resolve`` stage).

The same randomized conflict batches (hot overlapping point ranges,
fresh keys, and snapshots stale enough to cross the too-old floor, at a
ring small enough to evict mid-run) go through the deterministic CPU
twin (``conflict_np``) and the ``cuda`` backend, both driven by
``device/pipeline.py``'s DevicePipeline under identical grouping; their
verdicts must be bit-identical.  Then an in-run A/B: pipelined dispatch
against the unpipelined per-batch sync loop, which the pipelined path
must beat by ``RESOLVE_AB_FLOOR``.

    python -m foundationdb_tpu_torch.tools.perf_smoke [--device cpu]

runs the ``cuda`` backend on the CUDA card (the default; without a card
it raises) or, with ``--device cpu``, its plain versions on the CPU.

The workload helpers of the ``bigkeys`` and ``compact`` stages
(``bigkeys_key_fn``, ``apply_bigkeys``, ``packed_scan``,
``lsm_compact_commits``, ``lsm_ingest_side``) are here too: the north
star's ``bigkeys`` and ``lsm_ingest`` stages
(``bench/north_star.py``) measure the same shapes.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import math
import time

import torch

RESOLVE_BATCHES = 96
RESOLVE_TXNS = 16           # per batch (RESOLVER_BATCH_TXNS for the run)
RESOLVE_BUDGET_S = 150.0
RESOLVE_AB_FLOOR = 2.0      # pipelined vs unpipelined txns/s
COMPACT_KEYS_PER = 40       # ops per commit of the sustained ingest
COMPACT_PROBE_KEYS = 2048   # byte-identity point probes per twin


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
                  device=None) -> float:
    """Run the device-pipeline smoke; raises AssertionError on verdict
    divergence from the CPU twin, below the pipelined-vs-unpipelined
    A/B floor, past the budget, or if the randomized workload failed to
    exercise the too-old boundary at all."""
    elapsed, stats = resolve_pipeline_seconds(deadline_s=budget_s,
                                              device=device)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="foundationdb_tpu_torch.tools.perf_smoke")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the cuda backend runs: the CUDA card (the "
                    "default) or the CPU (its plain versions)")
    args = ap.parse_args(argv)
    elapsed = check_resolve(device=torch.device(args.device))
    print(f"[perf_smoke] resolve: {elapsed:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
