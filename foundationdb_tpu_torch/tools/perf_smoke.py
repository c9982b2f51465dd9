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
"""

from __future__ import annotations

import argparse
import asyncio
import time

import torch

RESOLVE_BATCHES = 96
RESOLVE_TXNS = 16           # per batch (RESOLVER_BATCH_TXNS for the run)
RESOLVE_BUDGET_S = 150.0
RESOLVE_AB_FLOOR = 2.0      # pipelined vs unpipelined txns/s


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
