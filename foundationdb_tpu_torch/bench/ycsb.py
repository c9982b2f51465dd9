"""YCSB workload F (read-modify-write) — BASELINE.md config 3.

Reference: the reference's config-3 baseline runs YCSB-F through the Java
binding (REF:bindings/java/ + YCSB's FoundationDB adapter).  No JVM
exists in this image, so the adapter here drives the same workload shape
through the native client: zipfian record selection, each op reading a
row and writing back a mutated field, ops/sec + p99 at the client
boundary.  Row format mirrors YCSB: key "user<hash>" → one packed
field blob.
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


def _ycsb_key(i: int) -> bytes:
    # YCSB hashes the sequential id; a fixed-width decimal keeps keys
    # ordered and the zipf hotset contiguous-free like YCSB's FNV hash
    return b"user%019d" % ((i * 0x5DEECE66D + 0xB) % (1 << 62))


async def run_ycsb_f(knobs: Knobs, n_rows: int = 100_000,
                     duration_s: float = 3.0, n_clients: int = 64,
                     field_len: int = 100, theta: float = 0.99,
                     device=None, seed: int = 11,
                     warmup_s: float = 2.0) -> dict:
    """Load n_rows, then hammer read-modify-write; returns ops/sec + p99."""
    cluster = Cluster(ClusterConfig(), knobs, device=device)
    cluster.start()
    zipf = ZipfianGenerator(n_rows, theta, seed)

    # --- load phase (uncounted): concurrent batched inserts (1M rows =
    # 2000 x 500-row txns; 16 loaders keep the commit pipeline full) ---
    async def loader(lo: int, hi: int) -> None:
        tr = Transaction(cluster)
        for start in range(lo, hi, 500):
            while True:
                # (re)stage the batch EVERY attempt: on_error resets the
                # transaction, wiping buffered writes — staging outside
                # the retry loop silently committed an empty txn after
                # any failure and dropped 500 rows from the dataset
                for i in range(start, min(start + 500, hi)):
                    tr.set(_ycsb_key(i), b"\x00" * field_len)
                try:
                    await tr.commit()
                    break
                except FdbError as e:
                    await tr.on_error(e)
            tr.reset()

    n_loaders = 16
    span = (n_rows + n_loaders - 1) // n_loaders
    await asyncio.gather(*(loader(j * span, min((j + 1) * span, n_rows))
                           for j in range(n_loaders)))

    ops = 0
    aborts = 0
    abort_codes: dict[int, int] = {}
    measuring = False
    latencies: list[float] = []
    stop_at = time.perf_counter() + warmup_s + duration_s

    async def client(cid: int) -> None:
        nonlocal ops, aborts
        tr = Transaction(cluster)
        while time.perf_counter() < stop_at:
            k = _ycsb_key(int(zipf.sample(1)[0]))
            t0 = time.perf_counter()
            started_measuring = measuring
            try:
                row = await tr.get(k)
                mutated = (row or b"")[:-8] + b"%08d" % (cid % 10**8)
                tr.set(k, mutated)
                await tr.commit()
                if measuring:
                    ops += 1
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
    await cluster.stop()
    from .stats import latency_ms
    return {
        "ops_per_sec": ops / elapsed,
        "ops": ops,
        "aborts": aborts,
        "abort_rate": aborts / max(1, ops + aborts),
        # per-cause split (error code -> count): 1020 = true conflict,
        # 1007 = too old
        "abort_codes": {str(c): n for c, n in sorted(abort_codes.items())},
        **latency_ms(latencies, (50, 99)),
        "elapsed_s": elapsed,
        "n_rows": n_rows,
        "n_clients": n_clients,
    }


def main() -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cpp", choices=("cpp", "numpy", "cuda"))
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--clients", type=int, default=64)
    args = ap.parse_args()
    knobs = Knobs().override(RESOLVER_CONFLICT_BACKEND=args.backend)
    device = None
    warmup = 1.0
    if args.backend == "cuda":
        import torch
        device = torch.device("cuda")   # no card: the backend raises
        warmup = 10.0       # kernel builds land in the warmup window
    out = asyncio.run(run_ycsb_f(knobs, args.rows, args.seconds, args.clients,
                                 device=device, warmup_s=warmup))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
