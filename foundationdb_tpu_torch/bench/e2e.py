"""End-to-end mako: client-boundary TPS through GRV → commit.

Reference: REF:bindings/c/test/mako/mako.c — concurrent client loops run
read-write transactions (zipfian hot keys) against a live cluster and
report committed TPS plus commit-latency percentiles measured at the
client boundary, i.e. including GRV batching, proxy batching, resolution
(the RESOLVER_CONFLICT_BACKEND under test) and log pushes.

``OPERATING_POINT`` is the device operating point of the JAX package's
``bench.py::tpu_e2e_knobs``: shallow concurrent batches fused by the
resolver's group dispatcher.  ``chip_smoke.py`` runs it there
for the ``cuda`` and ``cpp`` backends on the card.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from ..client.transaction import Transaction
from ..core.cluster import Cluster, ClusterConfig
from ..runtime.errors import FdbError
from ..runtime.knobs import Knobs
from .workload import ZipfianGenerator

# COMMIT_BATCH 5ms pinned to one 64-txn chunk, group bucket pinned to one
# shape, ring sized so 5s of writes never wedge the too-old floor, window
# sized past snapshot staleness; the endpoint dictionary at its default
OPERATING_POINT = dict(
    COMMIT_BATCH_INTERVAL=0.005, GRV_BATCH_INTERVAL=0.003,
    RESOLVER_BATCH_TXNS=64, COMMIT_BATCH_COUNT_LIMIT=64,
    CONFLICT_RING_CAPACITY=1 << 17, CONFLICT_WINDOW_SLOTS=8192,
    KEY_ENCODE_BYTES=32, RESOLVER_GROUP_BUCKET=8)


async def run_e2e(knobs: Knobs, duration_s: float = 3.0, n_clients: int = 64,
                  n_keys: int = 100_000, reads: int = 2, writes: int = 2,
                  theta: float = 0.99, device=None, seed: int = 7,
                  warmup_s: float = 2.0) -> dict:
    """Run the mako loop against a fresh in-process cluster; returns
    client-boundary stats.  ``knobs.RESOLVER_CONFLICT_BACKEND`` selects
    the conflict backend; ``device`` (a ``torch.device``) is where the
    ``cuda`` backend runs: the card by default, ``torch.device("cpu")``
    for the kernels' plain versions.  A warmup phase (uncounted) absorbs kernel compiles and cache warming."""
    cluster = Cluster(ClusterConfig(), knobs, device=device)
    cluster.start()
    zipf = ZipfianGenerator(n_keys, theta, seed)
    prefix = b"mako"
    width = 32 - len(prefix)

    def key(i: int) -> bytes:
        return prefix + str(int(i)).zfill(width).encode()

    committed = 0
    conflicts = 0
    abort_codes: dict[int, int] = {}
    measuring = False
    latencies: list[float] = []
    read_lat: list[float] = []      # client-side stage split
    commit_lat: list[float] = []
    stop_at = time.perf_counter() + warmup_s + duration_s

    async def client(cid: int) -> None:
        nonlocal committed, conflicts
        tr = Transaction(cluster)
        while time.perf_counter() < stop_at:
            ks = zipf.sample(reads + writes)
            t0 = time.perf_counter()
            started_measuring = measuring
            try:
                for i in range(reads):
                    await tr.get(key(ks[i]))
                t_read = time.perf_counter()
                for i in range(writes):
                    tr.set(key(ks[reads + i]), b"v%016d" % cid)
                await tr.commit()
                if measuring:
                    committed += 1
                    if started_measuring:
                        # a txn started in warmup may carry a compile
                        # stall; its latency is not a measured sample
                        now = time.perf_counter()
                        latencies.append(now - t0)
                        read_lat.append(t_read - t0)
                        commit_lat.append(now - t_read)
            except FdbError as e:
                if measuring:
                    conflicts += 1
                    abort_codes[e.code] = abort_codes.get(e.code, 0) + 1
                try:
                    await tr.on_error(e)
                    continue
                except FdbError:
                    pass
            tr.reset()

    async def phase_timer() -> float:
        nonlocal measuring
        await asyncio.sleep(warmup_s)
        measuring = True
        # drop warmup samples (compile stalls) from the stage breakdown
        for role in (cluster.grv_proxies + cluster.commit_proxies
                     + cluster.resolvers):
            role.stages.reset()
        for r in cluster.resolvers:
            r.group_sizes.clear()
            if r._pipeline is not None:
                r._pipeline.reset_stats()
        return time.perf_counter()

    timer = asyncio.ensure_future(phase_timer())
    await asyncio.gather(*(client(i) for i in range(n_clients)))
    t0 = await timer
    elapsed = time.perf_counter() - t0
    # commit-path stage breakdown: where a committed
    # txn's milliseconds actually go, per role
    from ..runtime.latency_probe import merge_summaries
    gsizes = [s for r in cluster.resolvers for s in r.group_sizes]
    stages = {
        "grv": merge_summaries([p.stages.summary()
                                for p in cluster.grv_proxies]),
        "proxy": merge_summaries([p.stages.summary()
                                  for p in cluster.commit_proxies]),
        "resolver": merge_summaries([r.stages.summary()
                                     for r in cluster.resolvers]),
        "fused_group_size_mean":
            round(sum(gsizes) / len(gsizes), 2) if gsizes else None,
        "fused_dispatches": len(gsizes),
    }
    # device commit pipeline shape: depth, fusion width,
    # per-batch dispatch cost and transfer/kernel overlap — why the
    # resolver sync number moved, not just that it did
    piped = [(r, r._pipeline.metrics()) for r in cluster.resolvers
             if r._pipeline is not None]
    pipes = [p for _r, p in piped]
    if pipes:
        stages["resolver_device"] = {
            "pipeline_depth": pipes[0]["device_pipeline_depth"],
            "dispatches": sum(p["device_dispatches"] for p in pipes),
            "group_mean": round(
                sum(p["device_batches_dispatched"] for p in pipes)
                / max(1, sum(p["device_dispatches"] for p in pipes)), 2),
            "dispatch_us_per_batch": round(
                sum(p["device_dispatch_us_per_batch"] for p in pipes)
                / len(pipes), 1),
            "overlap_ratio": round(
                sum(p["device_overlap_ratio"] for p in pipes)
                / len(pipes), 3),
            "queue_peak": max(p["device_queue_peak"] for p in pipes),
            "inflight_peak": max(p["device_inflight_peak"] for p in pipes),
            # routed-mesh shape: under routed resolution the
            # partitions diverge — the hot partition does the fusing
            # while a cold one answers header-only version advances —
            # so the aggregate above hides exactly what the mesh A/B
            # needs to see.  One entry per recruited resolver partition,
            # in key-range order.
            "partitions": [{
                "dispatches": p["device_dispatches"],
                "group_mean": round(
                    p["device_batches_dispatched"]
                    / max(1, p["device_dispatches"]), 2),
                "dispatch_us_per_batch": p["device_dispatch_us_per_batch"],
                "overlap_ratio": p["device_overlap_ratio"],
                "queue_peak": p["device_queue_peak"],
                "inflight_peak": p["device_inflight_peak"],
                "resolved_batches": r.total_batches,
                "skipped_batches": r.total_header_batches,
            } for r, p in piped],
        }
    await cluster.stop()

    from .stats import latency_ms
    stages["client"] = {
        "read_phase": latency_ms(read_lat, (50, 99)),
        "commit_phase": latency_ms(commit_lat, (50, 99)),
    }
    return {
        "tps": committed / elapsed,
        "committed": committed,
        "aborts": conflicts,
        "abort_rate": conflicts / max(1, committed + conflicts),
        # per-cause split (1020 true conflict / 1007 too old / other) +
        # the batching window that widens the OCC contention window
        "abort_codes": {str(c): n for c, n in sorted(abort_codes.items())},
        "commit_batch_interval_s": knobs.COMMIT_BATCH_INTERVAL,
        **latency_ms(latencies, (50, 95, 99)),
        "elapsed_s": elapsed,
        "n_clients": n_clients,
        "stages": stages,
    }


def main() -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cpp",
                    choices=("cpp", "numpy", "cuda"))
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--keys", type=int, default=100_000)
    args = ap.parse_args()

    knobs = Knobs().override(RESOLVER_CONFLICT_BACKEND=args.backend)
    device = None
    warmup = 1.0
    if args.backend == "cuda":
        import torch
        knobs = knobs.override(**OPERATING_POINT)
        device = torch.device("cuda")
        warmup = 10.0       # kernel builds land in the warmup window
    out = asyncio.run(run_e2e(knobs, args.seconds, args.clients, args.keys,
                              device=device, warmup_s=warmup))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
