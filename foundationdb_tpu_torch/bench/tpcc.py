"""TPC-C NewOrder (record-layer-style subset) — BASELINE.md config 4.

Reference: config 4 runs TPC-C NewOrder through the record layer on the
reference cluster, with the district hotspot driving contention.  This
bench implements the NewOrder transaction shape directly on the tuple
layer: read warehouse + district, RMW the district's next_o_id (the
hotspot — every NewOrder in a district conflicts on it), read item +
stock rows, write order/new-order/order-line rows and stock updates.
Reports NewOrders/min (tpmC-style) and abort rate.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from ..client import tuple as tup
from ..client.transaction import Transaction
from ..core.cluster import Cluster, ClusterConfig
from ..runtime.errors import FdbError
from ..runtime.knobs import Knobs
from ..runtime.rng import DeterministicRandom


def _k(*parts) -> bytes:
    return tup.pack(parts)


async def run_tpcc_neworder(knobs: Knobs, n_warehouses: int = 2,
                            districts_per_wh: int = 10, n_items: int = 1000,
                            duration_s: float = 3.0, n_clients: int = 32,
                            hot_district_frac: float = 0.5, device=None,
                            seed: int = 23, warmup_s: float = 2.0,
                            district_tag: str | None = None) -> dict:
    """Load a small TPC-C schema, then run concurrent NewOrder loops.
    ``hot_district_frac`` of transactions target district (1,1) — the
    hotspot the baseline calls for.

    ``district_tag``: tag every
    hot-district NewOrder with a GRV throttle tag.  The district
    hotspot is WRITE-CONTENTION on a single key (next_o_id) — heat
    splits cannot help it (same key, same resolver conflict); only
    admission can, and the ratekeeper's heat clamp needs a dominant tag
    to shed.  The reply then carries the ratekeeper's
    heat-throttle activation count so the bench can record the clamp's
    abort-rate effect."""
    cluster = Cluster(ClusterConfig(), knobs, device=device)
    cluster.start()
    rng = DeterministicRandom(seed)

    # --- load ---
    tr = Transaction(cluster)
    for w in range(1, n_warehouses + 1):
        tr.set(_k("wh", w), tup.pack((f"warehouse-{w}", 0.1)))
        for d in range(1, districts_per_wh + 1):
            tr.set(_k("dist", w, d), tup.pack((3000, 0.05)))  # next_o_id, tax
    for i in range(1, n_items + 1):
        tr.set(_k("item", i), tup.pack((f"item-{i}", i * 7 % 100 + 1)))
        for w in range(1, n_warehouses + 1):
            tr.set(_k("stock", w, i), tup.pack((50,)))
    while True:
        try:
            await tr.commit()
            break
        except FdbError as e:
            await tr.on_error(e)

    done = 0
    aborts = 0
    abort_codes: dict[int, int] = {}
    measuring = False
    latencies: list[float] = []
    stop_at = time.perf_counter() + warmup_s + duration_s

    async def client(cid: int) -> None:
        nonlocal done, aborts
        lr = DeterministicRandom(seed * 1000 + cid)
        tr = Transaction(cluster)
        while time.perf_counter() < stop_at:
            if lr.coinflip(hot_district_frac):
                w, d = 1, 1                             # the hotspot
            else:
                w = lr.random_int(1, n_warehouses)
                d = lr.random_int(1, districts_per_wh)
            # the hot tenant self-identifies at GRV admission; cold
            # districts ride the untagged default lane
            tr.throttle_tag = district_tag if (w, d) == (1, 1) else None
            n_lines = lr.random_int(5, 15)
            items = [lr.random_int(1, n_items) for _ in range(n_lines)]
            t0 = time.perf_counter()
            started_measuring = measuring
            try:
                await tr.get(_k("wh", w))
                draw = await tr.get(_k("dist", w, d))
                next_o_id, tax = tup.unpack(draw)
                tr.set(_k("dist", w, d), tup.pack((next_o_id + 1, tax)))
                for it in items:
                    await tr.get(_k("item", it))
                    sraw = await tr.get(_k("stock", w, it))
                    (qty,) = tup.unpack(sraw)
                    qty = qty - 1 if qty > 10 else qty + 91
                    tr.set(_k("stock", w, it), tup.pack((qty,)))
                tr.set(_k("order", w, d, next_o_id),
                       tup.pack((cid, n_lines)))
                tr.set(_k("neworder", w, d, next_o_id), b"")
                for ln, it in enumerate(items):
                    tr.set(_k("orderline", w, d, next_o_id, ln),
                           tup.pack((it, 1)))
                await tr.commit()
                if measuring:
                    done += 1
                    if started_measuring:
                        # warmup-started txns may carry compile stalls;
                        # their latency is not a measured sample (same
                        # policy as bench/e2e.py)
                        latencies.append(time.perf_counter() - t0)
            except FdbError as e:
                if measuring:
                    aborts += 1
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
        return time.perf_counter()

    timer = asyncio.ensure_future(phase_timer())
    await asyncio.gather(*(client(i) for i in range(n_clients)))
    t0 = await timer
    elapsed = time.perf_counter() - t0
    rk = getattr(cluster, "ratekeeper", None)
    heat_activations = getattr(rk, "heat_throttle_activations", 0)
    heat_tags = sorted(getattr(rk, "heat_tag_rates", {}) or {})
    await cluster.stop()
    abort_rate = aborts / max(1, done + aborts)
    # livelock detection: when nearly every NewOrder aborts, "tpmC" is an
    # artifact of the few survivors, not a throughput measurement — report
    # the livelock as such rather than a number (one NewOrder in 8.5 s is
    # not a measurement)
    livelock = (done + aborts) >= 10 and abort_rate >= 0.9

    from .stats import latency_ms
    return {
        "tpmC": None if livelock else done / elapsed * 60.0,
        "livelock": livelock,
        "new_orders": done,
        "aborts": aborts,
        "abort_rate": abort_rate,
        "abort_codes": {str(c): n for c, n in sorted(abort_codes.items())},
        **latency_ms(latencies, (50, 99)),
        "elapsed_s": elapsed,
        "n_clients": n_clients,
        "district_tag": district_tag,
        "heat_throttle_activations": heat_activations,
        "heat_throttled_tags": heat_tags,
    }


def main() -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cpp", choices=("cpp", "numpy", "cuda"))
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--clients", type=int, default=32)
    args = ap.parse_args()
    knobs = Knobs().override(RESOLVER_CONFLICT_BACKEND=args.backend)
    device = None
    warmup = 1.0
    if args.backend == "cuda":
        import torch
        device = torch.device("cuda")   # no card: the backend raises
        warmup = 10.0       # kernel builds land in the warmup window
    out = asyncio.run(run_tpcc_neworder(knobs, duration_s=args.seconds,
                                        n_clients=args.clients,
                                        device=device, warmup_s=warmup))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
