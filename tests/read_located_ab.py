"""A/B of the lsm engine's located batch read (``get_batch_located``,
the host half of a read-mirror batch) inside the perf smoke's ``read``
stage on a durable lsm cluster: the block rows bisected by key (the
port's) against the whole block's keys converted to a list first (the
JAX package's), alternating sides run by run in one process.

    python tests/read_located_ab.py RUNS [--device cuda|cpu]

Prints each run's multiget-against-scalar speedup, multiget keys/s and
scalar reads/s per side, then each side's medians as one JSON line.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def list_per_block(self, keys, pos):
    """``get_batch_located`` as the JAX package writes it."""
    _merged, blockmax = self._sparse._ensure()
    out = [None] * len(keys)
    mem = self._mem
    runs = self._runs
    bkeys_cache = {}
    for i, k in enumerate(keys):
        if k in mem:
            out[i] = mem[k]
            continue
        row = blockmax[pos[i]]
        for r_i in range(len(runs)):
            b = int(row[r_i])
            if b < 0:
                continue
            ck = (r_i, b)
            bkeys = bkeys_cache.get(ck)
            blk = runs[r_i]._block(b)
            if bkeys is None:
                bkeys = [bytes(e[0]) for e in blk]
                bkeys_cache[ck] = bkeys
            j = bisect.bisect_left(bkeys, k)
            if j < len(bkeys) and bkeys[j] == k:
                v = blk[j][1]
                out[i] = bytes(v) if v is not None else None
                break
    return out


def main(argv=None) -> int:
    import torch

    from foundationdb_tpu_torch.runtime.trace import (TraceLog,
                                                      set_trace_log)
    from foundationdb_tpu_torch.storage import lsm
    from foundationdb_tpu_torch.tools import perf_smoke as ps

    ap = argparse.ArgumentParser()
    ap.add_argument("runs", type=int)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    drop = TraceLog()
    drop.sink = lambda ev: None
    set_trace_log(drop)
    sides = {"bisect": lsm.LSMKVStore.get_batch_located,
             "list": list_per_block}
    got: dict = {s: [] for s in sides}
    try:
        for i in range(args.runs):
            order = ("list", "bisect") if i % 2 == 0 else ("bisect", "list")
            for side in order:
                lsm.LSMKVStore.get_batch_located = sides[side]
                _, st = ps.read_path_seconds(
                    storage_engine="lsm", device=torch.device(args.device))
                row = [round(st["speedup"], 3),
                       round(st["multiget_keys_per_sec"], 1),
                       round(st["scalar_reads_per_sec"], 1)]
                got[side].append(row)
                print(json.dumps({"i": i, "side": side, "speedup": row[0],
                                  "multiget_keys_per_sec": row[1],
                                  "scalar_reads_per_sec": row[2]}),
                      flush=True)
    finally:
        lsm.LSMKVStore.get_batch_located = sides["bisect"]
    print(json.dumps({s: {"speedup_median": statistics.median(
        r[0] for r in v), "multiget_median": statistics.median(
        r[1] for r in v), "scalar_median": statistics.median(
        r[2] for r in v)} for s, v in got.items()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
