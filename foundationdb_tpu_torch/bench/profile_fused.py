"""The wire path on the card: the fused single upload against the
multi-upload ids path and the lanes path.

    python -m foundationdb_tpu_torch.bench.profile_fused [--batches N]

At bench.py's configuration of the reference (B=64, R=2, 32-byte keys,
ring 1<<16, window 1024, dictionary 1<<21; mako batches of 64 txns, zipf
0.99 over 1M keys, 2 point reads + 2 point writes a txn; groups of 256
with 8 in flight) it runs, in turns, passes of

- ``fused``: ``resolve_group_wire_begin`` with one native call and one
  upload per group (``DictEncoder.encode_group_fused``);
- ``ids``: the same groups through ``ids_group_wire_begin``, four
  uploads per group (``encode_group_wire`` + ``resolve_group_submit_ids``);
- ``lanes``: the dictionary off, so the wire batches are deserialized
  and take the lanes path;
- ``cpp``: the port's exact C++ set consuming the wire form
  (``CppConflictSet.resolve_wire``), the verdicts every path must equal;

each path on its own backend, warmed by one pass and reset
(``reset_ring(0)``, the dictionary kept) before every measured pass, as
bench.py does.  Then it times the dictionary's indexing ops of one group
(the scatter of the updates, the gathers into [K, B, R, L]) under
torch.profiler, cold (U > 0) and warm (U = 0).  Prints one line per
finding and a JSON summary last.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

GROUP, INFLIGHT = 256, 8
PATHS = ("fused", "ids", "lanes", "cpp")


def wire_knobs(**over):
    """bench.py's resolver configuration (its ``run``), on the port."""
    from ..runtime.knobs import Knobs
    kv = dict(RESOLVER_CONFLICT_BACKEND="cuda", RESOLVER_BATCH_TXNS=64,
              RESOLVER_RANGES_PER_TXN=2, CONFLICT_RING_CAPACITY=1 << 16,
              KEY_ENCODE_BYTES=32, CONFLICT_WINDOW_SLOTS=1024,
              CONFLICT_DICT_SLOTS=1 << 21)
    kv.update(over)
    return Knobs().override(**kv)


def make_backend(path: str, device=None):
    """A fresh backend for ``path``: the C++ set, the dictionary off
    (``lanes``), or on (``fused`` and ``ids``)."""
    from ..ops.backends import make_conflict_backend
    kind = "cpp" if path == "cpp" else "cuda"
    slots = 0 if path == "lanes" else 1 << 21
    return make_conflict_backend(wire_knobs(RESOLVER_CONFLICT_BACKEND=kind,
                                            CONFLICT_DICT_SLOTS=slots),
                                 device=device)


def ids_group_wire_begin(backend, wires, versions):
    """The multi-upload twin of the backend's fused wire path, on a
    dictionary backend: per sub-group of up to the largest bucket,
    ``DictEncoder.encode_group_wire`` and ``resolve_group_submit_ids``
    (ids, update slots, update lanes and snapshots as four uploads).
    Same awaitable contract as ``resolve_group_wire_begin``."""
    import numpy as np

    from ..ops.backends import _DeviceSyncWorker
    from ..ops.conflict_torch import GROUP_BUCKETS, UPD_BUCKETS
    d, cs = backend._dict, backend.cs
    max_k = GROUP_BUCKETS[-1]
    pending = []                        # (counts, verdict handle)
    for start in range(0, len(wires), max_k):
        sub = wires[start:start + max_k]
        subv = versions[start:start + max_k]
        K = backend._k_bucket(len(sub))
        backend.dict_dispatches += 1
        enc = d.encode_group_wire(sub, backend.B, backend.R, K)
        if enc is None:
            cs.apply_dict_updates(d.upd_slots, d.upd_lanes, d.n_upd)
            raise ValueError("update buffer overflow on wire path")
        ids, snaps, counts, compact = enc
        n_upd = d.n_upd
        if n_upd > UPD_BUCKETS[-1]:
            # cold-start burst past the largest transfer bucket: ship the
            # updates chunked, then dispatch with none attached
            cs.apply_dict_updates(d.upd_slots, d.upd_lanes, n_upd)
            n_upd = 0
        pending.append((counts, cs.resolve_group_submit_ids(
            ids, snaps, (K, backend.B, backend.R), subv, d.upd_slots,
            d.upd_lanes, n_upd, compact)))

    async def finish():
        out = []
        for counts, v in pending:
            host = await _DeviceSyncWorker.shared().run(np.asarray, v)
            out.extend(host[k][:cnt].tolist() for k, cnt in enumerate(counts))
        return out

    return finish()


def begin_of(path: str):
    """The group entry point ``path`` drives."""
    if path == "ids":
        return ids_group_wire_begin
    from ..ops.backends import resolve_group_wire_begin
    return resolve_group_wire_begin


def measure_grouped(backend, wires, versions, group: int = GROUP,
                    inflight: int = INFLIGHT, begin=None):
    """Serialized wire batches fused into groups, a bounded number of
    groups in flight (each a dispatch whose verdicts read back
    overlapped): the reference's bench.py ``measure_grouped``, through
    ``begin`` (default ``resolve_group_wire_begin``).
    Returns (seconds, one verdict list per batch)."""
    begin = begin_of("fused") if begin is None else begin

    async def run():
        out = [None] * ((len(wires) + group - 1) // group)
        pending: list[tuple[int, object]] = []
        for gi, start in enumerate(range(0, len(wires), group)):
            if len(pending) >= inflight:
                i, p = pending.pop(0)
                out[i] = await p
            pending.append((gi, begin(
                backend, wires[start:start + group],
                versions[start:start + group])))
        for i, p in pending:
            out[i] = await p
        return [v for grp in out for v in grp]

    t0 = time.perf_counter()
    verdicts = asyncio.run(run())
    return time.perf_counter() - t0, verdicts


def measured_pass(backend, wires, versions, begin=None) -> dict:
    """One pass through ``begin`` (see measure_grouped) from empty
    history (a reset ring, the dictionary kept warm; for the C++ set, a
    fresh one): seconds, flat verdicts, host-to-device bytes, dictionary
    dispatches."""
    if hasattr(backend, "reset_ring"):
        backend.reset_ring(0)
    else:
        backend = type(backend)()
    cs = getattr(backend, "cs", None)
    h2d0 = getattr(cs, "h2d_bytes", 0)
    d0 = getattr(backend, "dict_dispatches", 0)
    dt, per_batch = measure_grouped(backend, wires, versions, begin=begin)
    verdicts = [x for vs in per_batch for x in vs]
    return {"s": dt, "verdicts": verdicts,
            "h2d_bytes": getattr(cs, "h2d_bytes", 0) - h2d0,
            "dict_dispatches": getattr(backend, "dict_dispatches", 0) - d0}


def b6_device_us(wires, versions, shape, width: int = 32,
                 slots: int = 1 << 21, device=None) -> dict:
    """Device time (torch.profiler, summed kernel time) and kernel count
    of the dictionary's indexing ops for one group of wires at ``shape``
    (K, B, R): the scatter of its updates, then the gathers into
    [K, B, R, L] rows, on the fused buffer the native group encoder
    writes, with a dictionary of its own.  Cold: the group's endpoints
    are new (U > 0); warm: the same group again (U = 0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops import conflict_torch as tct
    from ..ops.batch import DictEncoder
    from ..ops.kernels import SENTINEL_MAPPED
    K, B, R = shape
    L = width // 4 + 1
    dev = torch.device("cuda") if device is None else device
    d = DictEncoder(slots, width, 4 * R * B * K)
    dct = torch.full((slots, L), SENTINEL_MAPPED, dtype=torch.int32,
                     device=dev)
    out = {}
    for name in ("cold", "warm"):
        fused, _, compact, off_pi, n_upd = d.encode_group_fused(
            wires[:K], B, R, K, versions[:K])
        U = next((u for u in tct.FUSED_UPD_BUCKETS if u >= n_upd), None)
        if U is None:
            out[name] = {"n_upd": n_upd, "skipped": "past the last bucket"}
            # ship them, so the warm group finds them resident
            tct.dict_update_step(
                dct, torch.from_numpy(d.upd_slots[:n_upd].view("int32"))
                .to(dev), torch.from_numpy(
                    d.upd_lanes[:, :n_upd].copy().view("int32")).to(dev))
            continue
        total = d.pack_updates_into(fused, off_pi, K, B, U)
        buf = torch.from_numpy(fused[:total].view("int32")).to(dev)
        _, _, off_upd = tct.fused_offsets(shape, compact)

        def step():
            if U:
                tct.dict_update_step(
                    dct, buf[off_upd:off_upd + U],
                    buf[off_upd + U:off_upd + U + L * U].view(L, U))
            return tct._dict_rows(dct, buf, (K, B, R, L), width, compact)

        step()                              # warm-up (allocator)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        out[name] = {"U": U, "n_upd": n_upd, "compact": compact,
                     "kernels": len(kern),
                     "device_us": sum(e.time_range.end - e.time_range.start
                                      for e in kern)}
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from ..ops.batch import wire_from_txns
    from .workload import MakoWorkload
    batches, versions = MakoWorkload(n_keys=1_000_000, seed=42) \
        .make_batches(args.batches, 64)
    wires = [wire_from_txns(b) for b in batches]
    n_txns = args.batches * 64
    backends = {p: make_backend(p) for p in PATHS}
    for p, be in backends.items():                     # warm passes
        measured_pass(be, wires, versions, begin_of(p))
    passes: dict[str, list] = {p: [] for p in PATHS}
    want = None
    for rnd in range(args.rounds):
        order = PATHS if rnd % 2 == 0 else PATHS[::-1]
        for p in order:
            r = measured_pass(backends[p], wires, versions, begin_of(p))
            if want is None and p == "cpp":
                want = r["verdicts"]
            passes[p].append(r)
    out = {"device": torch.cuda.get_device_name(0), "batches": args.batches,
           "group": GROUP, "inflight": INFLIGHT}
    ok = True
    for p in PATHS:
        rs = passes[p]
        same = all(r["verdicts"] == want for r in rs)
        ok &= same
        best = min(r["s"] for r in rs)
        out[p] = {"txns_per_s": [n_txns / r["s"] for r in rs],
                  "best_txns_per_s": n_txns / best,
                  "h2d_bytes_per_batch": rs[0]["h2d_bytes"] / args.batches,
                  "dict_dispatches": rs[0]["dict_dispatches"],
                  "verdicts_equal_cpp": same}
        print(f"{p:>5}: best {n_txns / best:.1f} txns/s, passes "
              f"{[round(n_txns / r['s'], 1) for r in rs]}, h2d "
              f"{rs[0]['h2d_bytes'] / args.batches:.1f} B/batch, dict "
              f"dispatches {rs[0]['dict_dispatches']}, verdicts equal to "
              f"cpp: {same}")
    out["b6"] = b6_device_us(wires[-GROUP:], versions[-GROUP:],
                             (GROUP, 64, 2))
    print(f"dictionary ops of one group of {GROUP}: {out['b6']}")
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
