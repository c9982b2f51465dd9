"""cProfile of one side of the perf smoke's mesh A/B on the card: the
stage's 2-resolver cluster, its skewed workload and windows, routed or
broadcast.  Prints the side's txns/s, the functions with the most
internal time, and who called ``torch.cuda.is_available``.

    python tests/profile_mesh_side.py routed|broadcast [--device cuda|cpu]
        [--top N] [--warm N] [--seconds S]

``--top`` sets how many functions each listing shows (by internal
time, then by cumulative time).  ``--warm N`` runs N pairs of sides (routed
then broadcast) unprofiled first, so the card's and the imports'
one-time costs stay out of the profile, and prints each one's txns/s; ``--seconds`` sets the measured window (the
stage's ``MESH_SECONDS`` by default).
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import io
import os
import pstats
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    import torch

    from foundationdb_tpu_torch.bench.multi_resolver import \
        _mesh_cluster_run
    from foundationdb_tpu_torch.ops import kernels as K
    from foundationdb_tpu_torch.runtime.trace import (TraceLog,
                                                      set_trace_log)
    from foundationdb_tpu_torch.tools import perf_smoke as ps

    ap = argparse.ArgumentParser()
    ap.add_argument("side", choices=("routed", "broadcast"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--warm", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=ps.MESH_SECONDS)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        K.build_missing()
    drop = TraceLog()
    drop.sink = lambda ev: None
    set_trace_log(drop)

    def side(routing: bool, seconds: float) -> dict:
        return asyncio.run(_mesh_cluster_run(
            2, routing, seconds=seconds, warmup_s=ps.MESH_WARMUP_S,
            n_clients=ps.MESH_CLIENTS, skewed=True,
            device=torch.device(args.device)))

    for i in range(args.warm):
        for routing in (True, False):
            w = side(routing, ps.MESH_SECONDS)
            print(f"warm {i} {'routed' if routing else 'broadcast'}: "
                  f"{w['txns_per_sec']} txns/s", flush=True)
    prof = cProfile.Profile()
    prof.enable()
    r = side(args.side == "routed", args.seconds)
    prof.disable()
    print(f"{args.side}: {r['txns_per_sec']} txns/s, partitions "
          f"{r['partitions']}")
    out = io.StringIO()
    st = pstats.Stats(prof, stream=out)
    st.sort_stats("tottime").print_stats(args.top)
    st.sort_stats("cumulative").print_stats(args.top)
    st.print_callers("is_available|getDeviceCount")
    print(out.getvalue(), flush=True)
    if args.device == "cuda":
        # the card's work is done; skip the interpreter's teardown of
        # the pinned readback buffers and the device
        torch.cuda.synchronize()
        os._exit(0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
