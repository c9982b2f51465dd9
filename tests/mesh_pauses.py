"""The perf smoke's mesh A/B, routed and broadcast sides in turn, with
what each side lost to the collector and to the host: how steady the
routed/broadcast ratio is, and why it moves.

    python tests/mesh_pauses.py ROUNDS [--device cuda|cpu] [--after-read]
        [--arms asis,collect,freeze]

Each round runs a pair of sides (routed, then broadcast) at the stage's
sizes (``MESH_SECONDS``, ``MESH_WARMUP_S``, ``MESH_CLIENTS``, the
skewed workload) under every arm: ``asis`` with nothing between sides,
``collect`` after a full collection before each side, ``freeze`` after
a full collection and ``gc.freeze()`` (undone after the side), so the
side's collections scan only what the side made.  ``--after-read``
runs the read stage (``perf_smoke.check_read``) first, as
``chip_smoke.py`` phase 30 does, and prints the threads it left alive.

One JSON line a side: its txns/s; the collector's pauses by generation
(seconds, count); the event loop's longest gap; the process's CPU
seconds, each resolver's dispatch seconds (the host's part of a group
resolve: encode, upload, launches) and the loop's seconds waiting in
its selector (idle), each over the side's wall seconds.  Then one line
a pair with its ratio, and one an arm with its ratios and how many fell
under ``MESH_RATIO_FLOOR``.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import selectors
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    import torch

    from foundationdb_tpu_torch.bench.multi_resolver import \
        _mesh_cluster_run
    from foundationdb_tpu_torch.device import pipeline as pl
    from foundationdb_tpu_torch.ops import kernels as K
    from foundationdb_tpu_torch.runtime.trace import (TraceLog,
                                                      set_trace_log)
    from foundationdb_tpu_torch.tools import perf_smoke as ps

    ap = argparse.ArgumentParser()
    ap.add_argument("rounds", type=int)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--after-read", action="store_true")
    ap.add_argument("--arms", default="asis,collect")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if args.device == "cuda":
        K.build_missing()
    drop = TraceLog()
    drop.sink = lambda ev: None
    set_trace_log(drop)

    pauses: list = []
    started: dict = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        else:
            pauses.append((info["generation"],
                           time.perf_counter() - started["t"]))

    gc.callbacks.append(on_gc)
    if args.after_read:
        t0 = time.perf_counter()
        ps.check_read(device=dev, quiet=True)
        print(json.dumps({"read_stage_s": round(time.perf_counter() - t0, 3),
                          "objects": len(gc.get_objects()),
                          "threads": [t.name for t in threading.enumerate()],
                          "torch_threads": torch.get_num_threads()}),
              flush=True)

    plain_begin = pl.resolve_group_begin
    dispatch: dict = {}

    def timed_begin(backend, batches, versions):
        t0 = time.perf_counter()
        try:
            return plain_begin(backend, batches, versions)
        finally:
            dispatch[id(backend)] = dispatch.get(id(backend), 0.0) + \
                time.perf_counter() - t0

    pl.resolve_group_begin = timed_begin
    plain_select = selectors.EpollSelector.select
    idle = {"s": 0.0}

    def timed_select(self, timeout=None):
        t0 = time.perf_counter()
        try:
            return plain_select(self, timeout)
        finally:
            idle["s"] += time.perf_counter() - t0

    selectors.EpollSelector.select = timed_select

    async def side(routing: bool) -> dict:
        gap = {"max": 0.0}
        done = asyncio.Event()

        async def ticker():
            last = time.perf_counter()
            while not done.is_set():
                await asyncio.sleep(0.001)
                now = time.perf_counter()
                gap["max"] = max(gap["max"], now - last)
                last = now

        tick = asyncio.ensure_future(ticker())
        r = await _mesh_cluster_run(
            2, routing, seconds=ps.MESH_SECONDS, warmup_s=ps.MESH_WARMUP_S,
            n_clients=ps.MESH_CLIENTS, skewed=True, device=dev)
        done.set()
        await tick
        r["max_loop_gap_s"] = gap["max"]
        return r

    arms = args.arms.split(",")
    ratios: dict = {a: [] for a in arms}
    for i in range(args.rounds):
        for arm in arms:
            tps = {}
            for routing in (True, False):
                if arm in ("collect", "freeze"):
                    gc.collect()
                if arm == "freeze":
                    gc.freeze()
                del pauses[:]
                dispatch.clear()
                idle["s"] = 0.0
                objects = len(gc.get_objects())
                w0, c0 = time.perf_counter(), time.process_time()
                r = asyncio.run(side(routing))
                gc.unfreeze()
                wall = time.perf_counter() - w0
                cpu = time.process_time() - c0
                by_gen = {g: [round(sum(p for k, p in pauses if k == g), 4),
                              sum(1 for k, _ in pauses if k == g)]
                          for g in (0, 1, 2)}
                name = "routed" if routing else "broadcast"
                tps[name] = r["txns_per_sec"]
                print(json.dumps({
                    "round": i, "arm": arm, "side": name,
                    "txns_per_sec": r["txns_per_sec"],
                    "elapsed_s": r["elapsed_s"], "side_wall_s": round(wall, 3),
                    "cpu_over_wall": round(cpu / wall, 3),
                    "objects_before": objects, "gc_s_n_by_gen": by_gen,
                    "max_loop_gap_s": round(r["max_loop_gap_s"], 4),
                    "hot_group_mean": r["partitions"][0]["group_mean"],
                    "hot_batches": r["partitions"][0]["resolved_batches"],
                    "dispatch_share": sorted(
                        (round(v / wall, 4) for v in dispatch.values()),
                        reverse=True),
                    "idle_share": round(idle["s"] / wall, 4)}),
                    flush=True)
            ratio = tps["routed"] / max(tps["broadcast"], 1e-9)
            ratios[arm].append(round(ratio, 3))
            print(json.dumps({"round": i, "arm": arm,
                              "ratio": round(ratio, 3)}), flush=True)
    for arm in arms:
        print(json.dumps({
            "arm": arm, "ratios": ratios[arm],
            "under_floor": sum(r < ps.MESH_RATIO_FLOOR for r in ratios[arm]),
            "floor": ps.MESH_RATIO_FLOOR}), flush=True)
    if args.device == "cuda":
        torch.cuda.synchronize()
        os._exit(0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
