"""Where the resolver's time goes on the card, for the mako stream.

    python -m foundationdb_tpu_torch.bench.profile_resolver

Runs the port's Resolver at the reference's device operating point (the
knobs of chip_smoke.py's phase 4) over the same 1024 seeded mako batches,
all submitted concurrently, with the endpoint dictionary off
(CONFLICT_DICT_SLOTS=0, the lanes path) and on (1<<21, its default):

1. plain, off/on/on/off: wall time, txns/s, the device pipeline's own
   counters (host µs per batch in encode+dispatch), host-to-device bytes
   per batch, and the groups that took the dictionary;
2. under ``torch.profiler``, each mode: device time by kernel name, the
   device's busy time (the union of its kernel intervals) and idle share
   of the wall time, and device kernels per batch;
3. under ``cProfile``, each mode: the host functions with the most own
   time, and ``resolve_many_core``'s cumulative host time per batch;
4. the dictionary's indexing ops for one group of 64 batches (the
   pipeline's group) under torch.profiler, cold and warm
   (``profile_fused.b6_device_us``);

then drives the conflict set's fused group dispatch directly
(``resolve_many_packed`` on lanes already on the card):

5. the device kernels the fused loop issues per batch: the profiler's
   count for a group of 16 batches less that for a group of 8, over 8
   (what a group costs once cancels), by kernel name;
6. host µs per batch in ``resolve_many_core``: 4 groups of 64 batches
   (the pipeline's group size) enqueued back to back, timed on the host
   clock, then one sync (few enough that the card keeps up and the
   launch queue never fills).

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


MODES = {"dict_off": 0, "dict_on": 1 << 21}


def knobs(dict_slots: int = 0):
    from ..runtime.knobs import Knobs
    return Knobs().override(
        RESOLVER_CONFLICT_BACKEND="cuda", RESOLVER_BATCH_TXNS=64,
        RESOLVER_RANGES_PER_TXN=8, KEY_ENCODE_BYTES=32,
        CONFLICT_RING_CAPACITY=1 << 17, CONFLICT_WINDOW_SLOTS=8192,
        CONFLICT_DICT_SLOTS=dict_slots, RESOLVER_GROUP_BUCKET=8)


def run(batches, versions, dict_slots: int = 0):
    """(seconds, pipeline metrics + host-to-device bytes and dictionary
    dispatches) of one Resolver over the batches."""
    import torch

    from ..core.resolver import ResolveBatchRequest, Resolver

    async def main():
        res = Resolver(knobs(dict_slots))
        prev = [0] + versions[:-1]
        reqs = [ResolveBatchRequest(p, v, t)
                for p, v, t in zip(prev, versions, batches)]
        t0 = time.perf_counter()
        await asyncio.gather(*(res.resolve(r) for r in reqs))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        m = res._pipeline.metrics()
        m["h2d_bytes"] = res.backend.cs.h2d_bytes
        m["dict_dispatches"] = res.backend.dict_dispatches
        m["dict_fallbacks"] = res.backend.dict_fallbacks
        await res.close()
        return dt, m

    return asyncio.run(main())


def _device_events(prof):
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def fused_loop(batches, versions) -> dict:
    """Steps 4 and 5 on a fresh TorchConflictSet at the operating point."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops.batch import encode_batch
    from ..ops.conflict_torch import TorchConflictSet, resolve_many_packed

    kn = knobs()
    B, R, W = (kn.RESOLVER_BATCH_TXNS, kn.RESOLVER_RANGES_PER_TXN,
               kn.KEY_ENCODE_BYTES)
    cs = TorchConflictSet(kn.CONFLICT_RING_CAPACITY, W,
                          window=kn.CONFLICT_WINDOW_SLOTS)
    ebs = [encode_batch(t, B, R, W) for t in batches]
    pos = 0

    def group(k):
        """The next k batches, uploaded: (lanes, snaps, versions)."""
        nonlocal pos
        e, v = ebs[pos:pos + k], versions[pos:pos + k]
        pos += k
        cs._ensure_state(B, R)
        lanes, snaps = cs._upload(e, k)
        return lanes, snaps, v

    def run(g):
        lanes, snaps, v = g
        cs.state, verdicts = resolve_many_packed(
            cs.state, lanes, snaps, v, shape=(len(v), B, R, W // 4 + 1),
            width=W, window=cs.window, points=True)
        return verdicts

    for _ in range(4):                                  # warm-up
        run(group(8))
    torch.cuda.synchronize()
    counts = {}
    for k in (8, 16):
        g = group(k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(g)
            torch.cuda.synchronize()
        by = {}
        for e in _device_events(prof):
            by[e.name[:60]] = by.get(e.name[:60], 0) + 1
        counts[k] = by
    per_batch = {n: (counts[16].get(n, 0) - counts[8].get(n, 0)) / 8
                 for n in set(counts[8]) | set(counts[16])}
    per_batch = {n: c for n, c in per_batch.items() if c}
    groups = [group(64) for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in groups:
        run(g)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"fused_loop_kernels_per_batch": sum(per_batch.values()),
            "fused_loop_kernels_by_name": per_batch,
            "group_kernels_k8": sum(counts[8].values()),
            "resolve_many_core_host_us_per_batch": host_s / (4 * 64) * 1e6}


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


def profiled(batches, versions, dict_slots: int, tag: str) -> dict:
    """Steps 2 and 3 for one mode."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pdt, _ = run(batches, versions, dict_slots)
    kern = _device_events(prof)
    by_name: dict[str, list] = {}
    for e in kern:
        r = by_name.setdefault(e.name, [0, 0.0])
        r[0] += 1
        r[1] += e.time_range.end - e.time_range.start
    busy = busy_us(kern)
    out.update(profiled_wall_s=pdt, device_busy_s=busy / 1e6,
               device_idle_share=1 - busy / 1e6 / pdt,
               device_kernel_launches=len(kern),
               device_kernels_per_batch=len(kern) / BATCHES)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    out["top_device"] = [{"name": k[:80], "count": c, "us": round(us, 1)}
                         for k, (c, us) in top]
    print(f"{tag} profiled: wall {pdt:.3f} s, device busy "
          f"{busy / 1e6:.4f} s, idle share {out['device_idle_share']:.4f}, "
          f"{len(kern)} device kernels")
    for k, (c, us) in top:
        print(f"  device {us / 1e3:10.3f} ms  {c:7d}x  {k[:100]}")

    pr = cProfile.Profile()
    pr.enable()
    cdt, _ = run(batches, versions, dict_slots)
    pr.disable()
    st = pstats.Stats(pr)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:15]
    out["top_host"] = []
    print(f"{tag} cProfile: wall {cdt:.3f} s")
    for (f, line, fn), (cc, nc, tt, ct, _) in rows:
        where = f"{'/'.join(f.rsplit('/', 2)[-2:])}:{line}:{fn}"
        out["top_host"].append({"fn": where, "calls": nc,
                                "tottime_s": round(tt, 4),
                                "cumtime_s": round(ct, 4)})
        print(f"  host {tt:8.3f} s own {ct:8.3f} s cum {nc:8d}x  {where}")
    core = [v for (f, _, fn), v in st.stats.items()
            if fn == "resolve_many_core" and "conflict_torch" in f]
    if core:
        out["resolve_many_core_cprofile_us_per_batch"] = \
            core[0][3] / BATCHES * 1e6
        print(f"  resolve_many_core: {core[0][3]:.3f} s cumulative, "
              f"{core[0][3] / BATCHES * 1e6:.1f} us per batch")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from ..ops.batch import wire_from_txns
    from .profile_fused import b6_device_us
    from .workload import MakoWorkload
    batches, versions = MakoWorkload(n_keys=1_000_000, seed=42) \
        .make_batches(BATCHES, 64)
    n = BATCHES * 64
    out = {"device": torch.cuda.get_device_name(0), "batches": BATCHES}
    for slots in MODES.values():
        run(batches[:64], versions[:64], slots)            # warm-up
    for tag in ("dict_off", "dict_on", "dict_on", "dict_off"):
        dt, m = run(batches, versions, MODES[tag])
        r = {"wall_s": dt, "txns_per_s": n / dt,
             "dispatches": m["device_dispatches"],
             "group_mean": m["device_group_mean"],
             "dispatch_us_per_batch": m["device_dispatch_us_per_batch"],
             "overlap_ratio": m["device_overlap_ratio"],
             "h2d_bytes_per_batch": m["h2d_bytes"] / BATCHES,
             "dict_dispatches": m["dict_dispatches"],
             "dict_fallbacks": m["dict_fallbacks"]}
        out.setdefault(tag, {}).setdefault("plain", []).append(r)
        print(f"{tag} plain: {dt:.3f} s, {n / dt:.1f} txns/s, {r}")
    for tag, slots in MODES.items():
        out[tag].update(profiled(batches, versions, slots, tag))
    wires = [wire_from_txns(b) for b in batches[-64:]]
    out["dict_on"]["b6"] = b6_device_us(wires, versions[-64:], (64, 64, 8))
    print(f"dictionary ops of one group of 64: {out['dict_on']['b6']}")

    out.update(fused_loop(batches[:4 * 8 + 24 + 256],
                          versions[:4 * 8 + 24 + 256]))
    print(f"fused loop: {out['fused_loop_kernels_per_batch']} device "
          f"kernels per batch {out['fused_loop_kernels_by_name']}; "
          f"{out['group_kernels_k8']} for a group of 8; host "
          f"{out['resolve_many_core_host_us_per_batch']:.1f} us per batch "
          "in resolve_many_core")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
