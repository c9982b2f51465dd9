"""Multi-resolver conflict-detection scaling (the reference's BASELINE
config 5) on one CUDA card.

``run_scaling`` measures the key-range-partitioned resolve step
(parallel/sharded.py) at partition counts S ∈ {1, 2, 4, 8}: every
partition is the leading dimension of the state on the one card and
costs four kernel launches a batch (K3, K1, and K2 for each of its
two planes).  It reports txns/s per S
plus the ratio to S = 1, and the launches it counted.
``_mesh_cluster_run`` measures the routed resolver mesh of the live
commit path (``Cluster(ClusterConfig(resolvers=K))``).

``run_live_scaling`` runs that mesh at 1, 2 and 4 resolvers with
routing on, plus the broadcast twin at 4.  ``chip_smoke.py`` phase 11
drives the sweep and the mesh on the card.

Run: ``python -m foundationdb_tpu_torch.bench.multi_resolver
[--device cpu] [--live-only]`` prints one JSON line,
``{"metric": "multi_resolver_scaling (config 5)", "results": ...}``.
"""

from __future__ import annotations

import json
import time

import numpy as np


def scaling_batches(batches: int, B: int, R: int, width: int):
    """The mako stream of the scaling run: (encoded batches, versions)."""
    from ..ops.batch import encode_batch
    from .workload import MakoWorkload
    wl = MakoWorkload(n_keys=200_000, key_width=width, seed=11)
    raw, versions = wl.make_batches(batches, B)
    return [encode_batch(txns, B, R, width) for txns in raw], versions


def drive(step, state, ebs, versions):
    """Run the step over every batch, reading each batch's verdicts back
    as the resolver would: -> (state', [verdicts [B] int8 numpy])."""
    out = []
    for eb, ver in zip(ebs, versions):
        state, v = step(state, eb.read_begin, eb.read_end, eb.write_begin,
                        eb.write_end, eb.read_snapshot, ver)
        out.append(v.cpu().numpy())
    return state, out


def scaling_start(S: int, ebs, versions, width: int, history_slots: int,
                  device):
    """(step, state) for S partitions after the warm-up step (the first
    batch at a version far below the stream's)."""
    from ..parallel.sharded import (init_sharded_state,
                                    make_sharded_resolve_step)
    B, R = ebs[0].read_begin.shape[:2]
    step = make_sharded_resolve_step(S, width, window=0, device=device)
    # the point of resolver sharding: each partition's ring holds only
    # ITS key range's writes, so per-partition history (and scan work)
    # shrinks as 1/S for a fixed workload.  history_slots models the
    # MVCC window's retained writes at high throughput
    # (MAX_WRITE_TRANSACTION_LIFE_VERSIONS worth of commits).
    cap = max(B * R, history_slots // S)
    cap = ((cap + B * R - 1) // (B * R)) * (B * R)
    state = init_sharded_state(S, cap, width, device=device)
    state, _ = drive(step, state, ebs[:1], [versions[0] - 10**7])
    return step, state


def run_scaling(batches: int = 40, B: int = 64, R: int = 2,
                width: int = 16, shards=(1, 2, 4, 8),
                history_slots: int = 256_000, device=None) -> dict:
    """txns/s of the sharded step per S on ``device`` (the CUDA card by
    default), with the hand-kernel launches of each measured loop."""
    from ..ops import kernels
    from ..ops.conflict_torch import default_device
    dev = default_device(device)
    ebs, versions = scaling_batches(batches, B, R, width)
    out: dict[str, dict] = {}
    for S in shards:
        step, state = scaling_start(S, ebs, versions, width, history_slots,
                                    dev)
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        state, _ = drive(step, state, ebs, versions)
        dt = time.perf_counter() - t0
        out[str(S)] = {"txns_per_sec": round(batches * B / dt, 1),
                       "elapsed_s": round(dt, 3),
                       "launches": kernels.launch_counts(before)}
    base = out.get("1", {}).get("txns_per_sec")
    if base:
        for S, d in out.items():
            d["speedup_vs_1"] = round(d["txns_per_sec"] / base, 2)
    return out


def profile_scaling(S: int, batches: int = 64, B: int = 64, R: int = 2,
                    width: int = 16, history_slots: int = 256_000,
                    device=None) -> dict:
    """One S of ``run_scaling`` under torch.profiler (host and CUDA
    activity): wall seconds, the card's busy time (the union of its
    kernels' intervals) and idle share, device kernels a batch, and the
    ops that take the most device and host time."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops.conflict_torch import default_device
    from .profile_resolver import _device_events, busy_us
    dev = default_device(device)
    ebs, versions = scaling_batches(batches, B, R, width)
    step, state = scaling_start(S, ebs, versions, width, history_slots, dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drive(step, state, ebs, versions)
    wall = time.perf_counter() - t0
    kern = _device_events(prof)
    busy = busy_us(kern) / 1e6

    def top(attr: str, n: int) -> list:
        rows = sorted(prof.key_averages(), key=lambda e: getattr(e, attr),
                      reverse=True)[:n]
        return [(e.key, e.count, round(getattr(e, attr), 1)) for e in rows]

    return {"S": S, "batches": batches, "wall_s": wall, "busy_s": busy,
            "idle_share": 1 - busy / wall,
            "kernels_per_batch": len(kern) / batches,
            "top_device_us": top("self_device_time_total", 6),
            "top_host_us": top("self_cpu_time_total", 10)}


async def _mesh_cluster_run(resolvers: int, routing: bool,
                            seconds: float = 2.5, warmup_s: float = 1.0,
                            n_clients: int = 96, seed: int = 13,
                            device=None, skewed: bool = False) -> dict:
    """One live-cluster mesh measurement: the REAL recruited commit path
    (proxy → routed/broadcast resolver mesh → TLog → storage) under a
    range-partitioned workload — every txn's keys live in one partition
    band, so routing sends each resolver a sparse sub-batch and the other
    partitions header-only version advances.  Returns aggregate commit
    txns/s plus the routing stats (header-only
    fraction per partition, fused group mean, device overlap).
    ``skewed`` puts every key in the bottom partition's range (the
    perf smoke's mesh stage).  The resolvers run the ``cuda`` backend on
    ``device`` (the card by default)."""
    import asyncio
    import random
    import time

    from ..client.transaction import Transaction
    from ..core.cluster import Cluster, ClusterConfig
    from ..runtime.errors import FdbError
    from ..runtime.knobs import Knobs

    # the reference's sim-scale resolver shapes (cluster_sim.py's
    # rationale), kept so the two packages measure one configuration.
    # The batch count limit matches RESOLVER_BATCH_TXNS so one client
    # burst spans several chained batches and the device pipeline has
    # something to fuse.
    knobs = Knobs().override(
        RESOLVER_CONFLICT_BACKEND="cuda",
        RESOLVER_BATCH_TXNS=16, RESOLVER_RANGES_PER_TXN=4,
        CONFLICT_RING_CAPACITY=1 << 14, KEY_ENCODE_BYTES=16,
        COMMIT_BATCH_COUNT_LIMIT=16, COMMIT_BATCH_INTERVAL=0.001,
        # window-bound rings on EVERY shard count: with the 5M default the
        # bench never evicts, so every ring — including the 1-resolver
        # baseline's — saturates at capacity and per-dispatch scan cost
        # stops depending on the partition count.  A ring cap above the
        # window's steady-state occupancy plus a sub-second write life
        # keeps occupancy ∝ (writes/s)/R, which is the quantity routed
        # partitioning actually divides (scan = batches/R × occupancy/R).
        MAX_WRITE_TRANSACTION_LIFE_VERSIONS=800_000,
        CLIENT_LATENCY_PROBE_SAMPLE=0.0, METRICS_EMITTER=False,
        RESOLVER_MESH_ROUTING=routing)
    cluster = Cluster(ClusterConfig(resolvers=resolvers,
                                    storage_servers=2), knobs, device=device)
    cluster.start()
    rng = random.Random(seed)
    committed = 0
    measuring = False
    stop_at = time.perf_counter() + warmup_s + seconds

    def key(band: int, i: int) -> bytes:
        # first byte places the key in a partition band; ShardMap.even's
        # boundaries are byte-prefix splits, so bands 0..239 spread
        # uniformly over every resolver partition
        return bytes([band]) + b"mesh" + str(i).zfill(10).encode()

    async def client(cid: int) -> None:
        nonlocal committed
        tr = Transaction(cluster)
        while time.perf_counter() < stop_at:
            # range-partitioned ingest: the fleet stripes across bands in
            # a shared rotation (one band per ~5ms window), so each commit
            # batch's txns land in ONE partition — the other partitions
            # see header-only version advances.  This is the bulk-load /
            # region-at-a-time shape routed meshes are built for.
            if skewed:
                # partition-SKEWED shape: every key lands in the bottom
                # partition's range, so the other partitions receive
                # nothing but header-only version advances — the
                # empty-clip fast path's best case
                band = 0x10 + (int(time.perf_counter() * 200) * 7) % 0x60
            else:
                band = (int(time.perf_counter() * 200) * 7) % 240
            base = rng.randrange(50_000)
            try:
                for j in range(3):
                    tr.set(key(band, base + j), b"v%08d" % cid)
                await tr.commit()
                if measuring:
                    committed += 1
            except FdbError as e:
                try:
                    await tr.on_error(e)
                    continue
                except FdbError:
                    pass
            tr.reset()

    async def timer() -> float:
        nonlocal measuring
        await asyncio.sleep(warmup_s)
        measuring = True
        for r in cluster.resolvers:
            r.group_sizes.clear()
            if r._pipeline is not None:
                r._pipeline.reset_stats()
        for p in cluster.commit_proxies:
            for st in p.route_stats:
                st.update(sends=0, header_only=0, txns_routed=0)
        return time.perf_counter()

    t = asyncio.ensure_future(timer())
    await asyncio.gather(*(client(i) for i in range(n_clients)))
    t0 = await t
    elapsed = time.perf_counter() - t0

    route = [dict(st) for p in cluster.commit_proxies
             for st in p.route_stats]
    partitions = []
    for i, r in enumerate(cluster.resolvers):
        pm = r._pipeline.metrics() if r._pipeline is not None else {}
        st = route[i] if i < len(route) else {}
        partitions.append({
            "header_only_frac": round(
                st.get("header_only", 0) / max(1, st.get("sends", 0)), 3),
            "txns_routed": st.get("txns_routed", 0),
            "resolved_batches": r.total_batches,
            "skipped_batches": r.total_header_batches,
            "group_mean": pm.get("device_group_mean", 0.0),
            "overlap_ratio": pm.get("device_overlap_ratio", 0.0),
        })
    await cluster.stop()
    return {
        "txns_per_sec": round(committed / max(elapsed, 1e-9), 1),
        "committed": committed,
        "elapsed_s": round(elapsed, 3),
        "routing": routing,
        "partitions": partitions,
    }


def run_live_scaling(shards=(1, 2, 4), seconds: float = 2.0,
                     device=None) -> dict:
    """The live-cluster mesh A/B: aggregate commit txns/s of the real
    commit path at 1/2/4 resolvers with routing ON, plus the broadcast
    twin at the widest count — the number the synthetic sharded step
    above cannot measure (it has no proxy, no version chain and no
    device pipeline in the loop)."""
    import asyncio

    out: dict[str, dict] = {}
    for S in shards:
        out[str(S)] = asyncio.run(_mesh_cluster_run(S, True, seconds,
                                                    device=device))
    widest = max(shards)
    out[f"{widest}_broadcast"] = asyncio.run(
        _mesh_cluster_run(widest, False, seconds, device=device))
    base = out.get("1", {}).get("txns_per_sec")
    if base:
        for S, d in out.items():
            d["speedup_vs_1"] = round(d["txns_per_sec"] / base, 2)
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    from .stats import print_launches
    ap = argparse.ArgumentParser(
        prog="foundationdb_tpu_torch.bench.multi_resolver")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the partitions and the resolvers run: the "
                    "CUDA card (the default) or the CPU (the plain "
                    "versions)")
    ap.add_argument("--live-only", action="store_true",
                    help="skip the synthetic sharded-step sweep")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        from ..ops import kernels
        kernels.build_missing()     # no measured loop holds an nvcc run
    results: dict = {} if args.live_only else run_scaling(device=device)
    results["live_mesh"] = run_live_scaling(device=device)
    print(json.dumps({"metric": "multi_resolver_scaling (config 5)",
                      "results": results}))
    print_launches()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
