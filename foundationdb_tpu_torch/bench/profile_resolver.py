"""Where the resolver's time goes on the card, for the mako stream.

    python -m foundationdb_tpu_torch.bench.profile_resolver

Runs the port's Resolver at the reference's device operating point (the
knobs of chip_smoke.py's phase 4) three times over the same 1024 seeded
mako batches, all submitted concurrently:

1. plain: wall time, txns/s and the device pipeline's own counters;
2. under ``torch.profiler``: device time by kernel name, the device's
   busy time (the union of its kernel intervals) and idle share of the
   wall time;
3. under ``cProfile``: the host functions with the most own time.

Prints one line per finding and a JSON summary last.  Needs a CUDA card.
"""

from __future__ import annotations

import asyncio
import cProfile
import json
import pstats
import sys
import time

BATCHES = 1024


def knobs():
    from ..runtime.knobs import Knobs
    return Knobs().override(
        RESOLVER_CONFLICT_BACKEND="cuda", RESOLVER_BATCH_TXNS=64,
        RESOLVER_RANGES_PER_TXN=8, KEY_ENCODE_BYTES=32,
        CONFLICT_RING_CAPACITY=1 << 17, CONFLICT_WINDOW_SLOTS=8192,
        CONFLICT_DICT_SLOTS=0, RESOLVER_GROUP_BUCKET=8)


def run(batches, versions):
    import torch

    from ..core.resolver import ResolveBatchRequest, Resolver

    async def main():
        res = Resolver(knobs())
        prev = [0] + versions[:-1]
        reqs = [ResolveBatchRequest(p, v, t)
                for p, v, t in zip(prev, versions, batches)]
        t0 = time.perf_counter()
        await asyncio.gather(*(res.resolve(r) for r in reqs))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        m = res._pipeline.metrics()
        await res.close()
        return dt, m

    return asyncio.run(main())


def busy_us(events) -> float:
    """Union length of the device kernel intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from .workload import MakoWorkload
    batches, versions = MakoWorkload(n_keys=1_000_000, seed=42) \
        .make_batches(BATCHES, 64)
    n = BATCHES * 64
    run(batches[:64], versions[:64])                  # warm-up
    dt, m = run(batches, versions)
    out = {"device": torch.cuda.get_device_name(0), "batches": BATCHES,
           "wall_s": dt, "txns_per_s": n / dt,
           "dispatches": m["device_dispatches"],
           "group_mean": m["device_group_mean"],
           "dispatch_us_per_batch": m["device_dispatch_us_per_batch"],
           "overlap_ratio": m["device_overlap_ratio"]}
    print(f"plain: {dt:.3f} s, {n / dt:.1f} txns/s, {m}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pdt, _ = run(batches, versions)
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kern:
        r = by_name.setdefault(e.name, [0, 0.0])
        r[0] += 1
        r[1] += e.time_range.end - e.time_range.start
    busy = busy_us(kern)
    out.update(profiled_wall_s=pdt, device_busy_s=busy / 1e6,
               device_idle_share=1 - busy / 1e6 / pdt,
               device_kernel_launches=len(kern))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    out["top_device"] = [{"name": k[:80], "count": c, "us": round(us, 1)}
                         for k, (c, us) in top]
    print(f"profiled: wall {pdt:.3f} s, device busy {busy / 1e6:.4f} s, "
          f"idle share {out['device_idle_share']:.4f}, "
          f"{len(kern)} device kernels")
    for k, (c, us) in top:
        print(f"  device {us / 1e3:10.3f} ms  {c:7d}x  {k[:100]}")

    pr = cProfile.Profile()
    pr.enable()
    cdt, _ = run(batches, versions)
    pr.disable()
    st = pstats.Stats(pr)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:15]
    out["top_host"] = []
    print(f"cProfile: wall {cdt:.3f} s")
    for (f, line, fn), (cc, nc, tt, ct, _) in rows:
        where = f"{'/'.join(f.rsplit('/', 2)[-2:])}:{line}:{fn}"
        out["top_host"].append({"fn": where, "calls": nc,
                                "tottime_s": round(tt, 4),
                                "cumtime_s": round(ct, 4)})
        print(f"  host {tt:8.3f} s own {ct:8.3f} s cum {nc:8d}x  {where}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
