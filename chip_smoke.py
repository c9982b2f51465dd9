#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

    python3 chip_smoke.py

from the repository root.  It drives foundationdb_tpu_torch's resolver,
commit and storage paths on the card and exits non-zero on any failure:

1. the card's name and power limit (nvidia-smi);
2. builds the hand kernels from csrc/*.cu (one nvcc per source, in
   parallel) and prints the build time;
3. holds each kernel against its plain PyTorch version on the same
   seeded inputs at the resolver's shapes, tolerance 0 (integers), and
   times both with CUDA events: K1 (a batch's whole verdict step) at
   B = 64 and 100 under both rules, writing into a hot-buffer view; K2
   on the hot-buffer view; K3 under both rules on the resolver's own
   cold ring + hot buffer, with the inputs deciding the window (fast_ok)
   and the full side, and on a lone ring; B8 (the read mirror's prefix
   search) at N = 2**24 and 2**24 - 3 prefixes and 512 and 4096
   probes, and on mirrors of 100001, 1 and 0 prefixes, with the
   torch.searchsorted pair beside it;
4. the port's Resolver at the reference's device operating point
   (B=64, R=8, 32-byte keys, ring 1<<17, window 8192, group bucket 8,
   pipeline and verdict bitmask on), the dictionary off, answers 2048
   concurrently submitted mako batches (zipf 0.99, 2 point reads + 2
   point writes a txn); every verdict must equal the port's exact C++
   conflict set;
5. random ranges (the interval rule): at the same size with ~10% of
   snapshots older than the window (the full-ring fallback), and at a
   ring of 1<<13 with a window of 1024 (eviction raises the floor, so
   TOO_OLD appears); verdicts and ring state must be bit-identical to the
   port's plain path on the CPU;
6. RESOLVER_RING_INPLACE=True on the mako stream: verdicts and ring
   state identical to phase 4;
7. the endpoint dictionary (CONFLICT_DICT_SLOTS=1<<21, its default) on
   phase 4's mako run: verdicts equal to the exact C++ set and to phase
   4's, ring state equal to phase 4's, every group through the
   dictionary;
8. the dictionary at its smallest size (8*R*B*64 slots) under 288
   batches of random ranges, 90% of them over a wide key space (the
   interval rule, 4-segment ids; more distinct endpoints than slots, so
   it evicts), at phase 5's small ring, in groups of 16: verdicts, ring
   and dictionary contents bit-identical to the port's plain path on the
   CPU;
9. the wire path at the reference bench.py's configuration (B=64, R=2,
   ring 1<<16, window 1024, dictionary 1<<21; 4096 mako batches in
   groups of 256, 8 in flight; one warm pass, then ``reset_ring(0)``
   and the measured pass): the fused single-upload path, the ids path
   and the lanes path, each with verdicts equal to the C++ set's
   ``resolve_wire``, and txns/s for each and for the C++ set;
10. the in-process commit path end to end: mako clients (100000 keys,
   zipf 0.99, 2 reads + 2 writes a txn, 512 clients, 2 s warm-up then
   8 s measured) through the port's Cluster at the reference's device
   operating point (bench.e2e.OPERATING_POINT), on the ``cuda`` backend
   and then the ``cpp`` backend: txns/s, latency percentiles, abort
   rate and codes, the commit path's stage breakdown, the resolver's
   fusion, and the K1/K3 launches (equal, and nonzero on cuda); then a
   shorter cuda pass under torch.profiler for the card's idle share;
   10b. every ResolveBatchRequest of the cuda run, recorded by wrapping
   Resolver.resolve here, replayed in version order through a fresh
   ``cpp`` Resolver: every verdict must be equal;
   10c. serializability at the client: 64 clients for 3 s each read a
   zipf-chosen counter of 1000 and write it back incremented; the
   counters' sum read back must equal the acknowledged commits;
11. the multi-resolver (bench.multi_resolver): the sharded step at S = 1,
   2, 4, 8 partitions (B=64, R=2, width 16, mako over 200000 keys, 256000
   history slots split S ways, window 0), its first 32 batches against
   the CPU plain path (verdicts and every partition's ring), 512 timed
   batches with K3 = K1 = S x batches launches (K2 twice that), B9's device time
   under the profiler, a profiled pass at S = 1 and 8; the dryrun's partition-contained stream at S = 8 against the
   exact C++ set as one resolver; the live routed mesh at 1 and 4
   resolvers on the cuda backend;
12. durable storage: for the memory, lsm and btree engines, mako's
   100000 keys loaded through a durable Cluster.create on a real file
   system, made durable, the cluster re-created from disk and every key
   read back in get_multi batches of 512, byte for byte; the memory and
   lsm engines' read mirror must serve the read-back (B8 launches), with
   no fallback but its cold start, and every B8 call of the read-back
   must equal the plain version on its own mirror and probes;
13. bench.device_plane's A/Bs: the sharded read mirror against one
   directory, every served batch equal to the engine's and every B8
   call equal to the plain version on its own tensors; the verdict
   bitmask against the raw vectors and the in-place ring against the
   rebuild, each pair's verdicts equal;
14. YCSB workload F (bench.ycsb, BASELINE.md config 3): 1000000 rows of
   one 100-byte field under 23-byte keys, zipf 0.99 read-modify-write,
   256 clients, 2 s warm-up then 8 s measured, on the ``cuda`` backend at
   the operating point and then the ``cpp`` backend with its backend knob
   alone: ops/s, latency, abort rate and codes (only 1007 and 1020), the
   load's time, K1 = K3 launches (nonzero on cuda); every row read back
   before the cluster stops (Cluster.stop wrapped here); every resolve of
   the cuda run replayed through a ``cpp`` Resolver, every verdict equal;
15. TPC-C NewOrder (bench.tpcc, BASELINE.md config 4): 2 warehouses, 10
   districts, 1000 items, half the NewOrders on district (1, 1), 128
   clients, the same knobs, windows and checks, and TPC-C's consistency
   condition 1 in every district read before the cluster stops; tpmC
   where neither backend livelocks;
16. the abort-parity gate (bench.abort_parity at parity_knobs(): R = 8,
   24-txn batches, a ring of 1 << 13, 60 batches, seed 7) on the card and
   on the CPU plain path: equal reports and equal encoded verdicts for
   every batch, no safety violation, 1440 txns audited;
17. bench.tpu_probe as its own process: its status file reads ok with
   this card's name;
18. the multi-role cluster on the card through two recoveries: 3
   coordinators, 6 workers (each with a simulated disk, so storage runs
   the memory engine and its read mirror arms on the card) and a
   cluster controller over the port's SimNetwork under run_simulation,
   at the device operating point: epoch 1; 4096 mako keys loaded and
   16 mako clients of 40 transactions; every key read back in get_multi
   batches of 512 (the mirror serves, B8); the resolver's machine then
   the second TLog's killed (their processes stopped), each followed by
   the next epoch and another mako round; every acknowledged write read
   back; ``\xff\xff/status/json``.  Every resolve is recorded by wrapping
   Resolver.resolve and each resolver generation replayed through a
   fresh cpp Resolver (0 mismatches); no reply after a role stopped;
   every prefix_search call equal to the plain version; K3 = K1 > 0;
   the status shows epoch 3 and a pipelined resolver that dispatched;
   only the current epoch's resolver is hosted, and the card's allocated
   memory after each epoch stays within one ring's bytes;
19. three ``python3 -m foundationdb_tpu_torch.server --device cuda``
   processes over localhost TCP (a cluster file of three coordinators,
   ``--spec min_workers=3``, logs to files): a client here opens the
   cluster through the coordinators, commits 64 x 50 transactions, reads
   every one back, reads and clears the range, reads the status (epoch
   1, a pipelined resolver that dispatched); txns/s, the client's
   p50/p99 and the time from spawn to the first commit; every server
   alive until SIGTERM, stopped cleanly by it, no traceback in any log;
20. one JSON line with each kernel's launches (the resolver kernels' in
   phase 6's run, prefix_search's in phase 12's), max error, times and
   bound (K1 also its latency bound: B chain steps at the step time
   measured in phase 3; B8 its latency bound: one probe's search chain
   at N = 2**24 measured in phase 3); the last line is the result.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
# int32 ALU rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (H100 SXM)
INT32_OPS_PER_S = 132 * 64 * 1.98e9

MAKO_BATCHES = 2048
WIRE_BATCHES = 4096
SCALING_BATCHES = 512
DURABLE_KEYS = 100_000
B, R, WIDTH = 64, 8, 32
E2E_CLIENTS, E2E_WARMUP_S, E2E_SECONDS = 512, 2.0, 8.0
# BASELINE.md configs 3 and 4 at the reference bench.py's device client
# counts (its _TPU_CLIENTS)
YCSB_ROWS, YCSB_FIELD, YCSB_CLIENTS = 1_000_000, 100, 256
TPCC_CLIENTS = 128
# phase 18: more keys than a memory engine holds pending before its key
# index takes a base run (1024), so the read mirror serves
CLUSTER_KEYS = 4096
CARD = ""          # nvidia-smi's name and power limit, set by main


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*a) -> None:
    print(*a, flush=True)


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def time_cuda(fn, reps: int = 20, rounds: int = 5) -> tuple[float, float]:
    """(device ms, call ms) of one call of ``fn``, each the median over
    ``rounds`` of the mean over ``reps`` back-to-back calls, from CUDA
    events after a warm-up call.  Device ms: the calls are queued behind
    a spin kernel long enough to cover their host-side launch cost, so
    the events time the device work alone.  Call ms: the same calls
    without the spin, so a call's launch cost on the host counts too."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int((2 * host_s + 1e-3) * 2e9)   # cycles, at <= 2 GHz
    dev, call = [], []
    for _ in range(rounds):
        for out, pre in ((dev, True), (call, False)):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if pre:
                torch.cuda._sleep(spin)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / reps)
    return float(np.median(dev)), float(np.median(call))


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def _rand_keys(g, n: int, maxlen: int, alphabet: int = 3) -> list[bytes]:
    lens = g.integers(1, maxlen + 1, size=n)
    body = g.integers(0, alphabet, size=(n, maxlen)).astype(np.uint8)
    return [body[i, :lens[i]].tobytes() for i in range(n)]


def _ranges(g, kc, n: int, points: bool, wide: float = 0.1,
            alphabet: int = 3):
    """n encoded ranges [n, L] (begin, end), u32, of random keys (some
    longer than WIDTH, so the truncation rules are exercised): points,
    or intervals of which a share ``wide`` spans between two random keys
    and the rest are narrow [k, k+"\\x01")."""
    a = _rand_keys(g, n, WIDTH + 8, alphabet)
    if points:
        b = [k + b"\x00" for k in a]
    else:
        c = _rand_keys(g, n, WIDTH + 8, alphabet)
        wide = g.random(n) < wide
        b = [max(x, y) + b"\x00" if w else x + b"\x01"
             for x, y, w in zip(a, c, wide)]
        a = [min(x, y) if w else x for x, y, w in zip(a, c, wide)]
    return kc.encode_keys(a, WIDTH), kc.encode_keys(b, WIDTH)


def _lanes_needed(a, b, L):
    """For row pairs a, b [..., L] (int32 mapped lanes): the lanes a
    lexicographic compare reads (up to and including the first unequal
    one, all L when equal) and whether a < b there."""
    import torch
    a, b = torch.broadcast_tensors(a, b)
    ne = a != b
    first = torch.where(ne.any(-1), ne.to(torch.int8).argmax(-1),
                        torch.full(ne.shape[:-1], L - 1, device=a.device))
    lt = torch.gather(a, -1, first[..., None])[..., 0] < \
        torch.gather(b, -1, first[..., None])[..., 0]
    return first + 1, lt & ne.any(-1)


def _live(rows, points: bool):
    """[B, R] bool: rows up to each txn's last live one (the rule of
    csrc/lanes.cuh: a point row is dead with a sentinel length lane, an
    interval row with an all-sentinel begin)."""
    import torch

    from foundationdb_tpu_torch.ops.kernels import SENTINEL_MAPPED
    dead = rows[..., -1] == SENTINEL_MAPPED if points \
        else (rows == SENTINEL_MAPPED).all(-1)
    R = rows.shape[1]
    idx = torch.arange(1, R + 1, device=rows.device)
    n = torch.where(~dead, idx, 0).max(dim=1).values
    return idx[None, :] <= n[:, None]


def k1_ops(rb, re, wb, we, hit, snap, floor, points: bool) -> int:
    """Lane compares the K1 step needs on these inputs: pairs of a live
    read of txn i and a live write of txn j < i, i able to commit and
    not already hit, j able to commit, at the lanes each compare reads
    (both halves of the interval rule where the first holds)."""
    import torch
    ok = (snap >= 0) & (snap >= floor)
    row = ok & (hit == 0)
    B, R, L = rb.shape
    lower = torch.ones((B, B), dtype=torch.bool, device=rb.device).tril(-1)
    need = (row[:, None] & ok[None, :] & lower)[:, None, :, None] \
        & _live(rb, points)[:, :, None, None] \
        & _live(wb, points)[None, None, :, :]
    a, b = rb[:, :, None, None, :], wb[None, None, :, :, :]
    if points:
        lanes, _ = _lanes_needed(a[..., :-1], b[..., :-1], L - 1)
        lanes = lanes + (a[..., :-1] == b[..., :-1]).all(-1).to(lanes.dtype)
    else:
        l1, lt1 = _lanes_needed(a, we[None, None, :, :, :], L)
        l2, _ = _lanes_needed(b, re[:, :, None, None, :], L)
        lanes = l1 + lt1.to(l1.dtype) * l2
    return int((lanes * need).sum())


def _history(g, kc, dev, points: bool, C: int, W: int, S: int, Kg: int,
             k: int):
    """The resolver's own layout: a cold ring of C slots (versions rising
    through [0, 10000), the oldest sixteenth never written) and the hot
    buffer of a group of Kg batches of S slots [edge | cold's W newest |
    Kg slabs] with batches 0..k-1 written at versions 10001.. and the
    rest sentinel, as resolve_many_core builds it.  Returns device
    segments (hb, he, hver): cold, hot, batch k's window, and its edge."""
    import torch

    from foundationdb_tpu_torch.ops.conflict_torch import map_lanes
    cb, ce = _ranges(g, kc, C, points, 0.0, 6)
    cv = np.sort(g.integers(0, 10_000, size=C))
    cv[:C // 16] = -1
    T = Kg * S
    tb, te = _ranges(g, kc, T, points, 0.0, 6)
    tb[k * S:] = 0xFFFFFFFF
    te[k * S:] = 0xFFFFFFFF
    tv = np.repeat(np.arange(10_001, 10_001 + Kg), S).astype(np.int64)
    tv[k * S:] = -1
    hot = (np.concatenate([cb[C - W - 1:], tb]),
           np.concatenate([ce[C - W - 1:], te]),
           np.concatenate([cv[C - W - 1:], tv]))

    def seg(b, e, v):
        return (torch.from_numpy(map_lanes(b.T.copy())).to(dev),
                torch.from_numpy(map_lanes(e.T.copy())).to(dev),
                torch.from_numpy(v).to(dev))

    cold, hot = seg(cb, ce, cv), seg(*hot)
    off = k * S
    win = tuple(x[..., off + 1:off + 1 + W] for x in hot)
    return cold, hot, win, hot[2][off:off + 1]


def prefix_cases(seed: int, N: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """B8's inputs: (prefixes u64 [N] sorted, probes u64 [n]).  Prefixes
    span the whole u64 range (half of them at or above 2**63, where the
    sign flip matters) with wide equal-prefix runs (keys sharing their
    first 8 bytes, up to 2048 wide, N >> 13 of them); probes are a mix of present
    prefixes (run values among them), random values, 0 and 2**64 - 1
    (below and above every prefix when the extremes are absent)."""
    g = np.random.default_rng(seed)
    pfx = np.sort(g.integers(1, 2**64 - 1, size=N, dtype=np.uint64))
    for i in g.integers(0, max(N, 1), size=min(N, max(1, N >> 13), 64)):
        pfx[i:i + int(g.integers(2, min(2048, (N >> 4) + 2) + 1))] = pfx[i]
    return pfx, prefix_probes(g, pfx, n)


def prefix_probes(g, pfx: np.ndarray, n: int) -> np.ndarray:
    """n probes u64 for the sorted prefixes ``pfx``: half present
    prefixes, the rest random, with 0 and 2**64 - 1 among them."""
    kind = g.random(n)
    probes = g.integers(0, 2**64 - 1, size=n, dtype=np.uint64, endpoint=True)
    if len(pfx):
        hit = pfx[g.integers(0, len(pfx), size=n)]
        probes = np.where(kind < 0.5, hit, probes)
    probes[kind > 0.97] = 0
    probes[kind < 0.03] = np.uint64(2**64 - 1)
    return probes


def kernel_phase(dev, report: dict) -> None:
    import torch

    from foundationdb_tpu_torch.ops import keycode as kc
    from foundationdb_tpu_torch.ops import kernels as K
    from foundationdb_tpu_torch.ops.conflict_torch import map_lanes

    g = np.random.default_rng(1234)
    L = kc.nlanes(WIDTH)
    C, W = 1 << 17, 8192
    S = B * R

    def note(name, err, ms=None, plain_ms=None, bound_ms=None, bound_by=None,
             lib_ms=None, **extra):
        r = report.setdefault(name, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if ms is not None:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=lib_ms, **extra)

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
        return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"

    def rows(n, points, wide=0.1, alphabet=3):
        rb_, re_ = _ranges(g, kc, n * R, points, wide, alphabet)
        rb_, re_ = rb_.reshape(n, R, L), re_.reshape(n, R, L)
        pad = g.random((n, R)) < 0.5        # sentinel rows
        rb_[pad] = 0xFFFFFFFF
        re_[pad] = 0xFFFFFFFF
        return [torch.from_numpy(map_lanes(x)).to(dev) for x in (rb_, re_)]

    def one(v):
        return torch.tensor([v], dtype=torch.int64, device=dev)

    # K1: the batch's verdict step at B = 64 (the main path) and B = 100,
    # both rules, writing its slab into a hot-buffer view
    floor = one(100)
    for points in (True, False):
        for Bk in (64, 100):
            Sk = Bk * R
            rb, re = rows(Bk, points)
            wb, we = rows(Bk, points)
            hit = torch.from_numpy((g.random(Bk) < 0.1).astype(np.int32)) \
                .to(dev)
            kind = g.random(Bk)
            snap = torch.from_numpy(np.where(kind < 0.1, -1, np.where(
                kind < 0.2, 50, 200)).astype(np.int64)).to(dev)
            hot = torch.full((L, 1 + W + 8 * Sk), 7, dtype=torch.int32,
                             device=dev)
            hoe = hot.clone()
            hv = torch.full((1 + W + 8 * Sk,), 7, dtype=torch.int64,
                            device=dev)
            dst = slice(1 + W + 3 * Sk, 1 + W + 4 * Sk)
            ver = one(12345)
            args = (rb, re, wb, we, hit, snap, floor, WIDTH, points)
            verd = torch.empty(Bk, dtype=torch.int8, device=dev)
            comm = torch.empty(Bk, dtype=torch.bool, device=dev)
            slab = (hot[:, dst], hoe[:, dst], hv[dst])

            def k1():
                K.commit_chain(*args, verd, comm, slab=slab, version_t=ver)

            k1()
            v, c, sb, se = K.commit_chain_plain(*args)
            outside = torch.ones(hot.shape[1], dtype=torch.bool, device=dev)
            outside[dst] = False
            errs = [(verd.long() - v.long()).abs().max(),
                    (comm.long() - c.long()).abs().max(),
                    (hot[:, dst].long() - sb.long()).abs().max(),
                    (hoe[:, dst].long() - se.long()).abs().max(),
                    (hv[dst] - 12345).abs().max(),
                    (hot[:, outside] != 7).sum() + (hv[outside] != 7).sum()]
            err = int(max(int(e) for e in errs))
            ms, call = time_cuda(k1)
            pms, _ = time_cuda(lambda: K.commit_chain_plain(*args),
                               reps=2, rounds=3)
            k = 2 if points else 3          # row planes the kernel reads
            nbytes = 4 * k * Bk * R * L + 12 * Bk + 2 * Bk + \
                2 * 4 * L * Sk + 8 * Sk + 16
            ops = k1_ops(rb, re, wb, we, hit, snap, floor, points)
            bms, by = bound(nbytes, ops)
            verdict_counts = torch.bincount(verd.long(), minlength=3).tolist()
            say(f"kernel commit_chain B={Bk} points={points}: max_abs_err="
                f"{err} verdicts(committed, conflict, too_old)="
                f"{verdict_counts} ms={ms:.6f} call_ms={call:.6f} "
                f"plain_ms={pms:.6f} bound_ms={bms:.8f} ({by}; {nbytes} "
                f"bytes, {ops} lane compares)")
            if err:
                say(f"kernel commit_chain MISMATCH B={Bk} points={points}")
            note("commit_chain", err)
            if Bk == B and points:
                line_k1 = (ms, pms, bms, by)
    # K1's real limit: B dependent chain steps.  One step's time, measured:
    # every txn invalid (no matrix work, no slab), one range a txn, B = 32
    # against B = 96 (the prologue and epilogue are one pass of 512
    # threads either way)
    t_b = {}
    for Bk in (32, 96):
        rb, re = (x[:, :1].contiguous() for x in rows(Bk, True))
        sn = torch.full((Bk,), -1, dtype=torch.int64, device=dev)
        h = torch.zeros(Bk, dtype=torch.int32, device=dev)
        verd = torch.empty(Bk, dtype=torch.int8, device=dev)
        comm = torch.empty(Bk, dtype=torch.bool, device=dev)
        t_b[Bk], _ = time_cuda(lambda: K.commit_chain(
            rb, re, rb, re, h, sn, floor, WIDTH, True, verd, comm))
    step_ms = (t_b[96] - t_b[32]) / (96 - 32)
    lat_ms = B * step_ms
    say(f"kernel commit_chain chain step: {step_ms * 1e6:.3f} ns "
        f"(B=32 {t_b[32]:.6f} ms, B=96 {t_b[96]:.6f} ms, all invalid); "
        f"latency bound at B={B}: {lat_ms:.8f} ms")
    ms, pms, bms, by = line_k1
    note("commit_chain", 0, ms, pms, bms, by, None,
         latency_bound_ms=lat_ms, chain_step_ms=step_ms)

    # K2: the ring append at L = 9, C = 1 << 17, on the resolver's own
    # slab layout: the K slabs of a fused group, a view into the hot
    # staging buffer [L, 1 + W + K*B*R] from column 1 + W (not 16-byte
    # aligned, odd row stride).  The mako run fuses groups of
    # RESOLVER_GROUP_MAX = 64 batches, so S = 64*B*R is its shape.
    buf = torch.from_numpy(g.integers(-2**31, 2**31, size=(L, C),
                                      dtype=np.int64).astype(np.int32)).to(dev)
    out = torch.empty_like(buf)
    out2 = torch.empty_like(buf)
    for Kg in (1, 8, 64):
        Sg = Kg * S
        hot = torch.from_numpy(g.integers(-2**31, 2**31, size=(L, 1 + W + Sg),
                                          dtype=np.int64).astype(np.int32)
                               ).to(dev)
        slab = hot[:, 1 + W:]
        K.ring_append(buf, slab, out)
        K.ring_append_plain(buf, slab, out2)
        err = int((out.to(torch.int64) - out2.to(torch.int64)).abs().max())
        ms, call = time_cuda(lambda: K.ring_append(buf, slab, out))
        pms, _ = time_cuda(lambda: K.ring_append_plain(buf, slab, out2))
        lib, _ = time_cuda(lambda: torch.cat([buf[:, Sg:], slab], dim=1))
        bms = 2 * L * C * 4 / HBM_BYTES_PER_S * 1e3
        say(f"kernel ring_append L={L} C={C} S={Sg} (hot-buffer view, row "
            f"stride {slab.stride(0)}): max_abs_err={err} "
            f"ms={ms:.6f} call_ms={call:.6f} plain_ms={pms:.6f} "
            f"torch.cat_ms={lib:.6f} "
            f"bound_ms={bms:.6f} (bytes)")
        note("ring_append", err)
        if Kg == 64:
            note("ring_append", err, ms, pms, bms, "bytes", lib)

    # K3: the history check on the path's own layout (cold ring 1 << 17,
    # the hot buffer of a group of 8, batch 4's window of 8192 slots),
    # both rules, with fast_ok decided true (the window) and false (the
    # cold ring + the hot buffer) by the snapshots
    floor = one(200)
    for points in (True, False):
        cold, hot, win, edge = _history(g, kc, dev, points, C, W, S, 8, 4)
        rb, re = rows(B, points, 0.01, 6)
        e = int(edge)
        top = int(hot[2].max())
        for fast in (True, False):
            sn = np.where(g.random(B) < 0.6, top - 2,
                          g.integers(e, top + 1, size=B)).astype(np.int64)
            sn[g.random(B) < 0.1] = -1
            sn[:2] = 150                 # too old
            if not fast:
                sn[2] = 5_000            # valid, below the edge
            sn = torch.from_numpy(sn).to(dev)
            args = (rb, re, sn, WIDTH, points)
            kw = dict(window=win, edge=edge, floor=floor)
            hit = torch.zeros(B, dtype=torch.int32, device=dev)
            K.hist_check(*args, hit, [cold, hot], **kw)
            want = K.hist_check_select_plain(*args, [cold, hot], **kw)
            err = int((hit - want.to(torch.int32)).abs().max())
            ok = bool(K.fast_path_ok(sn, edge, floor))
            if ok != fast:
                fail(f"hist_check inputs: fast_ok={ok}, meant {fast}")
            ms, call = time_cuda(
                lambda: K.hist_check(*args, hit, [cold, hot], **kw))
            pms, _ = time_cuda(lambda: K.hist_check_select_plain(
                *args, [cold, hot], **kw), reps=2, rounds=3)
            side = [win] if fast else [cold, hot]
            k = 1 if points else 2
            slots = sum(s[2].shape[0] for s in side)
            newer = sum((s[2][None, :] > sn[:, None]).sum(1) for s in side)
            live = _live(rb, points).sum(1)
            ops = int((live * newer).sum())
            nbytes = slots * (8 + 4 * k * L) + 4 * k * B * R * L + 12 * B + 16
            bms, by = bound(nbytes, ops)
            say(f"kernel hist_check points={points} "
                f"{'window' if fast else 'full'} ({slots} slots): "
                f"max_abs_err={err} hits={int(hit.sum())}/{B} ms={ms:.6f} "
                f"call_ms={call:.6f} plain_ms={pms:.6f} bound_ms={bms:.8f} "
                f"({by}; {nbytes} bytes, {ops} lane compares)")
            if err:
                say(f"kernel hist_check MISMATCH points={points} fast={fast}")
            note("hist_check", err)
            if points and fast:
                note("hist_check", err, ms, pms, bms, by, None)
        # one segment, no window (resolve_core without a window)
        hit = torch.zeros(B, dtype=torch.int32, device=dev)
        K.hist_check(rb, re, sn, WIDTH, points, hit, [cold])
        want = K.hist_check_plain(rb, re, *cold, sn, WIDTH, points)
        note("hist_check", int((hit - want.to(torch.int32)).abs().max()))
    torch.cuda.synchronize()
    prefix_search_phase(dev, note)


def prefix_search_phase(dev, note) -> None:
    """B8 at the read mirror's shapes: N = 2**24 prefixes (128 MiB, one
    storage server's ~16.8M keys) and N = 2**24 - 3 (odd lengths in the
    left search's halving), n = 512 (a get_multi batch) and 4096 probes,
    32 seeded probe sets each, every set against the plain version
    (tolerance 0), timed over the 32 in turn so the deep search levels
    are not all in L2; a mirror of 100001 prefixes (phase 12's size), an
    empty and a one-prefix mirror.  The latency bound is the search's
    chain measured directly: one probe a launch (a new one each launch)
    at N = 2**24 less the same launch at N = 1."""
    import itertools
    import math

    import torch

    from foundationdb_tpu_torch.device.read_serve import map_prefixes
    from foundationdb_tpu_torch.ops import kernels as K

    def up(a):
        return torch.from_numpy(map_prefixes(a)).to(dev)

    def check(t, q) -> int:
        lo, hi = K.prefix_search(t, q)
        return band_err(t, q, lo, hi)

    for Ns in (0, 1, 100_001):
        pfx, probes = prefix_cases(7 + Ns, Ns, 512)
        err = check(up(pfx), up(probes))
        say(f"kernel prefix_search N={Ns} n=512: max_abs_err={err}")
        note("prefix_search", err)
    N = 1 << 24
    g = np.random.default_rng(2424)
    pfx, probes = prefix_cases(24, N, 4096)
    t = up(pfx)
    depth = math.ceil(math.log2(N))
    # the search's dependent chain: one probe a launch, N = 2^24 against
    # N = 1 (one load, no search level)
    pool = up(prefix_probes(g, pfx, 4096))
    lo1 = torch.empty(1, dtype=torch.int64, device=dev)
    hi1 = torch.empty_like(lo1)
    per = {}
    for name, tt in (("2^24", t), ("1", t[:1])):
        it = itertools.cycle(range(4096))
        per[name], _ = time_cuda(lambda: K.prefix_search(
            tt, pool[(i := next(it)):i + 1], lo1, hi1))
    chain_ms = per["2^24"] - per["1"]
    say(f"kernel prefix_search chain: {chain_ms:.6f} ms = {depth} levels x "
        f"{chain_ms / depth * 1e6:.3f} ns (one probe: N=2^24 "
        f"{per['2^24']:.6f} ms, N=1 {per['1']:.6f} ms)")
    for n in (512, 4096):
        sets = [up(probes[:n])] + [up(prefix_probes(g, pfx, n))
                                   for _ in range(31)]
        err = max(check(t, q) for q in sets)
        err_odd = max(check(t[:N - 3], q) for q in sets)
        lo, hi = K.prefix_search_plain(t, sets[0])
        band = int((hi - lo).max())
        out = (torch.empty(n, dtype=torch.int64, device=dev),
               torch.empty(n, dtype=torch.int64, device=dev))
        it = itertools.cycle(range(32))
        ms, call = time_cuda(lambda: K.prefix_search(t, sets[next(it)],
                                                     *out))
        pms, _ = time_cuda(lambda: K.prefix_search_plain(t, sets[next(it)]))

        def library():
            q = sets[next(it)]
            torch.searchsorted(t, q, side="left")
            torch.searchsorted(t, q, side="right")
        lib, _ = time_cuda(library)
        # what this run's data needs: each probe's left search loads
        # depth + 1 prefixes, its right search 1 + 2 ceil(log2(w + 1))
        # for a band w wide; a load is a compare, a select and an add,
        # counted at the int32 rate
        w = (hi - lo).cpu().numpy()
        loads = n * (depth + 2) + int(
            2 * np.ceil(np.log2(w + 1)).sum())
        nbytes = n * (8 + 16) + loads * 8
        ops = 3 * loads
        bms, by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                      (ops / INT32_OPS_PER_S * 1e3, "operations"))
        say(f"kernel prefix_search N=2^24 n={n}: max_abs_err={err} "
            f"(N=2^24-3: {err_odd}; 32 probe sets, widest band {band}) "
            f"ms={ms:.6f} call_ms={call:.6f} plain_ms={pms:.6f} "
            f"torch.searchsorted_pair_ms={lib:.6f} bound_ms={bms:.8f} "
            f"({by}; {nbytes} bytes, {ops} operations) "
            f"latency_bound_ms={chain_ms:.6f}")
        note("prefix_search", max(err, err_odd))
        if n == 512:
            note("prefix_search", err, ms, pms, bms, by, lib,
                 latency_bound_ms=chain_ms, level_ms=chain_ms / depth)


def held_to_plain():
    """Records every prefix_search call the path makes, by wrapping the
    kernels module's wrapper (the read mirror calls it through the
    module).  Returns (calls, restore).  Each call's tensors are its own
    (a lookup allocates its probes and outputs anew, a refresh replaces
    a mirror's tensor), so references suffice and the path's timing
    keeps no extra device work."""
    from foundationdb_tpu_torch.ops import kernels as K
    real, calls = K.prefix_search, []

    def recorded(pfx, probes, lo=None, hi=None):
        lo, hi = real(pfx, probes, lo, hi)
        calls.append((pfx, probes, lo, hi))
        return lo, hi

    def restore():
        K.prefix_search = real
    K.prefix_search = recorded
    return calls, restore


def plain_err(calls) -> tuple[int, list]:
    """Each recorded call's bands against the plain version on the same
    device tensors: (max abs error, the distinct mirror lengths)."""
    err = max((band_err(*c) for c in calls), default=0)
    return err, sorted({int(c[0].shape[0]) for c in calls})


def band_err(pfx, probes, lo, hi) -> int:
    """prefix_search's bands (lo, hi) against the plain version's."""
    from foundationdb_tpu_torch.ops import kernels as K
    if not probes.numel():
        return 0
    plo, phi = K.prefix_search_plain(pfx, probes)
    return int(max((lo - plo).abs().max(), (hi - phi).abs().max()))


# --------------------------------------------------------------------------
# resolver phases


def smoke_knobs(**over):
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    kv = dict(
        RESOLVER_CONFLICT_BACKEND="cuda", RESOLVER_BATCH_TXNS=B,
        RESOLVER_RANGES_PER_TXN=R, KEY_ENCODE_BYTES=WIDTH,
        CONFLICT_RING_CAPACITY=1 << 17, CONFLICT_WINDOW_SLOTS=8192,
        CONFLICT_DICT_SLOTS=0, RESOLVER_GROUP_BUCKET=8,
        RESOLVER_DEVICE_PIPELINE=True, RESOLVER_VERDICT_BITMASK=True,
        MAX_WRITE_TRANSACTION_LIFE_VERSIONS=5_000_000)
    kv.update(over)
    return Knobs().override(**kv)


def run_resolver(knobs, batches, versions, device=None, want_dict=False):
    """All batches submitted concurrently to one Resolver; returns
    (replies, seconds, pipeline metrics with the backend's dictionary
    counters, final ring state as numpy).  With ``want_dict`` the
    metrics carry the dictionary's contents too."""
    from foundationdb_tpu_torch.core.resolver import (ResolveBatchRequest,
                                                      Resolver)
    from foundationdb_tpu_torch.ops.conflict_torch import state_to_numpy

    async def main():
        res = Resolver(knobs, device=device)
        prev = [0] + versions[:-1]
        reqs = [ResolveBatchRequest(p, v, t)
                for p, v, t in zip(prev, versions, batches)]
        t0 = time.perf_counter()
        replies = await asyncio.gather(*(res.resolve(r) for r in reqs))
        dt = time.perf_counter() - t0
        m = res._pipeline.metrics()
        be = res.backend
        m.update(dict_dispatches=be.dict_dispatches,
                 dict_fallbacks=be.dict_fallbacks, h2d_bytes=be.cs.h2d_bytes)
        if want_dict:
            m["dict"] = be.cs.dict_to_numpy()
        await res.close()
        return replies, dt, m, state_to_numpy(be.cs.state)

    return asyncio.run(main())


def range_batches(n: int, seed: int, old_lag: tuple[int, int],
                  span: int = 200_000, hot: float = 1.0):
    """n batches of random ranges over 32-byte-or-shorter keys, begins
    drawn from the first 200000 keys with probability ``hot``, else from
    ``span`` keys; ~10% of snapshots lag ``old_lag`` batches, the rest
    1-5 batches."""
    from foundationdb_tpu_torch.ops.batch import TxnRequest
    g = np.random.default_rng(seed)

    def key(i):
        return b"range/%012d" % i

    batches, versions = [], []
    v = 1_000_000
    for _ in range(n):
        v += 1000
        txns = []
        for _ in range(B):
            rr, wr = [], []
            for dst in (rr, wr):
                for _ in range(int(g.integers(1, R + 1))):
                    a = int(g.integers(0, 200_000 if g.random() < hot
                                       else span))
                    dst.append((key(a), key(a + int(g.integers(1, 300)))))
            lag = int(g.integers(*old_lag)) if g.random() < 0.1 \
                else int(g.integers(1, 6))
            txns.append(TxnRequest(rr, wr, max(0, v - 1000 * lag)))
        batches.append(txns)
        versions.append(v)
    return batches, versions


def flat(replies):
    return [x for r in replies for x in r.verdicts]


def same_state(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3])) \
        and a[3] == b[3]


# --------------------------------------------------------------------------
# phase 10: the commit path end to end


def e2e_knobs(kind: str):
    from foundationdb_tpu_torch.bench.e2e import OPERATING_POINT
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    return Knobs().override(RESOLVER_CONFLICT_BACKEND=kind,
                            **OPERATING_POINT)


@contextlib.contextmanager
def wrapped(cls, name: str, make):
    """``cls.name`` replaced by ``make(original)`` inside the block."""
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def recording_resolves(record: list | None):
    """Every (ResolveBatchRequest, reply) a Resolver answers appended to
    ``record``, by wrapping Resolver.resolve (nothing with None)."""
    from foundationdb_tpu_torch.core.resolver import Resolver
    if record is None:
        return contextlib.nullcontext()

    def make(orig):
        async def recording(self, req):
            reply = await orig(self, req)
            record.append((req, reply))
            return reply
        return recording
    return wrapped(Resolver, "resolve", make)


def e2e_run(kind: str, dev, record: list | None = None,
            warmup_s: float = E2E_WARMUP_S, seconds: float = E2E_SECONDS):
    """bench.e2e.run_e2e at the operating point.  With ``record``, every
    (ResolveBatchRequest, reply) the cluster's resolver answers is
    appended to it, by wrapping Resolver.resolve for the run."""
    from foundationdb_tpu_torch.bench.e2e import run_e2e
    with recording_resolves(record):
        return asyncio.run(run_e2e(e2e_knobs(kind), duration_s=seconds,
                                   n_clients=E2E_CLIENTS, device=dev,
                                   warmup_s=warmup_s))


def e2e_report(kind: str, r: dict, got: dict) -> None:
    st = r["stages"]
    dv = st.get("resolver_device", {})
    say(f"e2e {kind}: {r['committed']} committed in {r['elapsed_s']:.3f} s "
        f"= {r['tps']:.1f} txns/s, {r['n_clients']} clients; latency p50 "
        f"{r['p50_ms']:.3f} ms p95 {r['p95_ms']:.3f} p99 {r['p99_ms']:.3f}; "
        f"abort rate {r['abort_rate']:.6f} codes {r['abort_codes']}; "
        f"resolver group_mean {dv.get('group_mean')} dispatch_us_per_batch "
        f"{dv.get('dispatch_us_per_batch')} fused groups "
        f"{st['fused_dispatches']}; launches={got}")
    for role in ("grv", "proxy", "resolver"):
        say(f"e2e {kind} stages {role}: {json.dumps(st[role])}")
    say(f"e2e {kind} client phases: {json.dumps(st['client'])}")
    commit = st["client"]["commit_phase"]["p50_ms"]
    res = st["proxy"].get("resolve", {}).get("p50_ms")
    if commit and res is not None:
        say(f"e2e {kind}: the proxy's resolve stage p50 {res} ms is "
            f"{res / commit:.4f} of the client's commit-phase p50 "
            f"{commit:.3f} ms")
    stages = {f"{role}.{k}": v["mean_ms"] for role in ("grv", "proxy")
              for k, v in st[role].items()}
    lead = max(stages, key=stages.get)
    say(f"e2e {kind}: the largest stage mean is {lead} ({stages[lead]} ms)")


def idle_share(run) -> dict:
    """``run()`` under torch.profiler (CUDA activity): the union of the
    device kernels' intervals over the run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from foundationdb_tpu_torch.bench.profile_resolver import (_device_events,
                                                               busy_us)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = run()
    wall = time.perf_counter() - t0
    kern = _device_events(prof)
    busy = busy_us(kern) / 1e6
    return {"wall_s": wall, "busy_s": busy, "idle_share": 1 - busy / wall,
            "kernels": len(kern), "report": r}


def replay_cpp(record: list) -> tuple[int, int]:
    """The recorded requests, in version order, through a fresh Resolver
    with the cpp backend at the same knobs: (verdicts compared,
    mismatches)."""
    from foundationdb_tpu_torch.core.resolver import Resolver

    async def main():
        res = Resolver(e2e_knobs("cpp"))
        n = bad = 0
        for req, reply in sorted(record, key=lambda x: x[0].version):
            got = (await res.resolve(req)).verdicts
            n += len(got)
            bad += sum(1 for a, b in zip(got, reply.verdicts) if a != b) \
                + abs(len(got) - len(reply.verdicts))
        await res.close()
        return n, bad
    return asyncio.run(main())


def counter_run(dev, clients: int = 64, seconds: float = 3.0,
                keys: int = 1000) -> dict:
    """Clients read a zipf-chosen counter and write it back incremented
    (a read and a set, not an atomic op) on the cuda backend; then one
    fresh transaction reads every counter back."""
    from foundationdb_tpu_torch.bench.workload import ZipfianGenerator
    from foundationdb_tpu_torch.client.transaction import Transaction
    from foundationdb_tpu_torch.core.cluster import Cluster, ClusterConfig
    from foundationdb_tpu_torch.runtime.errors import FdbError

    async def main():
        cluster = Cluster(ClusterConfig(), e2e_knobs("cuda"), device=dev)
        cluster.start()
        zipf = ZipfianGenerator(keys, 0.99, 3)
        acked = 0
        codes: dict[int, int] = {}
        stop = time.perf_counter() + seconds

        async def client():
            nonlocal acked
            tr = Transaction(cluster)
            while time.perf_counter() < stop:
                k = b"ctr/%06d" % int(zipf.sample(1)[0])
                try:
                    v = await tr.get(k)
                    tr.set(k, b"%d" % (int(v or b"0") + 1))
                    await tr.commit()
                    acked += 1
                except FdbError as e:
                    codes[e.code] = codes.get(e.code, 0) + 1
                tr.reset()

        await asyncio.gather(*(client() for _ in range(clients)))
        rows = await Transaction(cluster).get_range(b"ctr/", b"ctr0")
        await cluster.stop()
        return {"clients": clients, "seconds": seconds, "acked": acked,
                "sum": sum(int(v) for _, v in rows), "keys": len(rows),
                "codes": dict(sorted(codes.items()))}
    return asyncio.run(main())


# --------------------------------------------------------------------------
# phase 11: the multi-resolver


def multi_resolver_phase(dev, batches: int = SCALING_BATCHES,
                         check_batches: int = 32,
                         history_slots: int = 256_000,
                         mesh_seconds: tuple = (1.0, 2.5)) -> list:
    """bench.multi_resolver at the reference's run_scaling configuration
    (S in 1, 2, 4, 8; B=64, R=2, width 16, mako over 200000 keys,
    history_slots split S ways, window 0): the first ``check_batches``
    of each S on the card against the CPU plain path (verdicts and every
    partition's ring), then the timed run, then the dryrun's
    partition-contained stream at S = 8 against the exact C++ set as one
    resolver, then the live routed mesh at 1 and 4 resolvers on the
    card.  Returns the launch counts of every run."""
    import torch

    from foundationdb_tpu_torch.bench import multi_resolver as mr
    from foundationdb_tpu_torch.ops import kernels as K
    from foundationdb_tpu_torch.parallel.sharded import (
        init_sharded_state, make_sharded_resolve_step,
        sharded_state_to_numpy)
    cpu = torch.device("cpu")
    ebs, vs = mr.scaling_batches(batches, 64, 2, 16)
    for S in (1, 2, 4, 8):
        t0 = time.perf_counter()
        outs = []
        for d in (dev, cpu):
            step, st = mr.scaling_start(S, ebs, vs, 16, history_slots, d)
            st, v = mr.drive(step, st, ebs[:check_batches],
                             vs[:check_batches])
            outs.append((sharded_state_to_numpy(st), np.concatenate(v)))
        (sa, va), (sb, vb) = outs
        eq_v = np.array_equal(va, vb)
        eq_s = all(np.array_equal(x, y) for x, y in zip(sa, sb))
        say(f"multi-resolver S={S}: first {check_batches} batches, "
            f"verdicts (committed, conflict, too_old)="
            f"{np.bincount(va, minlength=3).tolist()} equal to the CPU "
            f"plain path={eq_v}, rings equal={eq_s} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not (eq_v and eq_s):
            fail(f"multi-resolver S={S} differs from the CPU plain path")
    res = mr.run_scaling(batches=batches, history_slots=history_slots,
                         device=dev)
    gots = []
    for S, r in res.items():
        got = r["launches"]
        gots.append(got)
        say(f"multi-resolver S={S}: {batches} batches x 64 txns in "
            f"{r['elapsed_s']} s = {r['txns_per_sec']} txns/s, "
            f"speedup_vs_1 {r['speedup_vs_1']}, launches={got}")
        if not got["hist_check"] == got["commit_chain"] \
                == got["ring_append"] // 2 == int(S) * batches:
            fail(f"multi-resolver S={S}: K3 and K1 launches must each be "
                 f"S x batches = {int(S) * batches}, K2's twice that (one "
                 f"a plane): {got}")
    say(f"multi-resolver txns/s: "
        f"{json.dumps({S: r['txns_per_sec'] for S, r in res.items()})}")
    # B9 alone, at the step's shapes: the write mask over [S, B, R, L]
    # and the verdicts' max over [S, B].  Device time: the sum of its
    # kernels' times under torch.profiler (a span of CUDA events over
    # ~15 tiny launches would time the gaps between them); bound: bytes
    # (the writes, the bounds and the verdicts read once, the masked
    # writes and the verdict written once) over the HBM rate
    from torch.profiler import ProfilerActivity, profile

    from foundationdb_tpu_torch.bench.profile_resolver import _device_events
    from foundationdb_tpu_torch.ops.conflict_torch import map_lanes
    from foundationdb_tpu_torch.parallel import sharded as sh
    eb = ebs[0]
    wb, we = (torch.from_numpy(map_lanes(x).copy()).to(dev)
              for x in (eb.write_begin, eb.write_end))
    Bb, Rb, Lb = wb.shape
    for S in (1, 8):
        lo, hi = (torch.from_numpy(map_lanes(x).copy()).to(dev) for x in (
            sh.make_partition_boundaries(S, 16)[:-1],
            sh.make_partition_boundaries(S, 16)[1:]))
        vs8 = torch.randint(0, 3, (S, Bb), dtype=torch.int8, device=dev)

        def b9():
            sh._mask_writes_to_partitions(wb, we, lo, hi, 16)
            vs8.amax(dim=0)
        b9()
        sync(dev)
        reps = 50
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                b9()
            sync(dev)
        kern = _device_events(prof)
        ms = sum(e.time_range.end - e.time_range.start
                 for e in kern) / reps / 1e3
        _, span = time_cuda(b9)
        nbytes = 2 * 4 * Bb * Rb * Lb * (1 + S) + 2 * 4 * S * Lb \
            + S * Bb + Bb
        say(f"B9 write mask + verdict max S={S} (B={Bb}, R={Rb}, L={Lb}): "
            + (f"device ms={ms:.6f} (sum of {len(kern) / reps:.1f} kernels "
               "a call, profiler)" if kern else "device ms not measured "
               "(the profiler saw no device kernel)")
            + f", call_ms={span:.6f} (CUDA events), "
            f"bound_ms={nbytes / HBM_BYTES_PER_S * 1e3:.8f} "
            f"(bytes; {nbytes} bytes)")
    for S in (1, 8):
        pr = mr.profile_scaling(S, 64, history_slots=history_slots,
                                device=dev)
        say(f"multi-resolver S={S} profiled (64 batches): wall "
            f"{pr['wall_s']:.3f} s, device busy {pr['busy_s']:.6f} s, idle "
            f"share {pr['idle_share']:.6f}, {pr['kernels_per_batch']:.1f} "
            f"device kernels a batch; top device us "
            f"{json.dumps(pr['top_device_us'])}; top host us "
            f"{json.dumps(pr['top_host_us'])}")

    # __graft_entry__.dryrun_multichip's partition-contained generator at
    # S = 8 against the exact C++ set run as one resolver
    from foundationdb_tpu_torch.ops.batch import TxnRequest, encode_batch
    from foundationdb_tpu_torch.ops.conflict_cpp import CppConflictSet
    S, Bd, Rd, Wd = 8, 8, 2, 16
    step = make_sharded_resolve_step(S, Wd, device=dev)
    st = init_sharded_state(S, Bd * Rd * 64, Wd, device=dev)
    cpp = CppConflictSet()
    g = np.random.default_rng(7)
    version, n, bad, codes = 1000, 0, 0, np.zeros(3, np.int64)
    K.reset_launches()
    for _ in range(48):
        txns = []
        for _ in range(Bd):
            part = int(g.integers(0, S))
            lo = bytes([(256 * part) // S, int(g.integers(0, 5))])
            txns.append(TxnRequest([(lo, lo + b"\x01")], [(lo, lo + b"\x01")],
                                   version - int(g.integers(0, 160))))
        version += 100 + int(g.integers(0, 50))
        eb = encode_batch(txns, Bd, Rd, Wd)
        st, v = step(st, eb.read_begin, eb.read_end, eb.write_begin,
                     eb.write_end, eb.read_snapshot, version)
        want = np.asarray(cpp.resolve(txns, version))
        got = v.cpu().numpy()
        bad += int((got != want).sum())
        n += len(want)
        codes += np.bincount(want, minlength=3)
    got_d = {k: v.launches for k, v in K.KERNELS.items()}
    gots.append(got_d)
    say(f"multi-resolver S=8 partition-contained stream: {n} verdicts "
        f"(committed, conflict, too_old)={codes.tolist()} against the C++ "
        f"set as one resolver, mismatches={bad}, launches={got_d}")
    if bad or codes[1] == 0:
        fail("the partition-contained stream differs from the one-resolver "
             "C++ set, or had no conflict")

    for k in (1, 4):
        K.reset_launches()
        r = asyncio.run(mr._mesh_cluster_run(
            k, True, seconds=mesh_seconds[1], warmup_s=mesh_seconds[0],
            device=dev))
        sync(dev)
        got = {k_: v.launches for k_, v in K.KERNELS.items()}
        gots.append(got)
        say(f"multi-resolver live mesh, {k} resolver(s), routing on, cuda: "
            f"{r['committed']} committed in {r['elapsed_s']} s = "
            f"{r['txns_per_sec']} txns/s; partitions "
            f"{json.dumps(r['partitions'])}; launches={got}")
        if r["committed"] == 0 or got["commit_chain"] == 0:
            fail(f"the live mesh at {k} resolvers committed nothing or "
                 f"launched no kernel: {got}")
    return gots


# --------------------------------------------------------------------------
# phase 12: durable storage and the read mirror


def _durable_knobs(engine: str):
    # the reference's durability tests' window: versions become durable
    # 0.1 s of versions behind the tip, checked every 50 ms
    return e2e_knobs("cuda").override(
        STORAGE_ENGINE=engine, STORAGE_VERSION_WINDOW=100_000,
        STORAGE_DURABILITY_LAG=0.05)


def durable_phase(dev, n_keys: int = DURABLE_KEYS,
                  engines=("memory", "lsm", "btree"),
                  root: str | None = None) -> dict:
    """For each engine: load mako's n_keys keys (32 bytes) and values,
    256 a transaction from 32 concurrent loaders, through a durable
    Cluster.create on a real file system, wait until
    every storage server's durable version passes the last commit, stop,
    re-create the cluster from the same directory and read every key
    back in get_multi batches of 512.  Returns per engine the rates, the
    mirror's counters and the launches of the read-back."""
    from foundationdb_tpu_torch.client.transaction import Transaction
    from foundationdb_tpu_torch.core.cluster import Cluster, ClusterConfig
    from foundationdb_tpu_torch.ops import kernels as K
    from foundationdb_tpu_torch.runtime.errors import FdbError
    from foundationdb_tpu_torch.runtime.files import RealFileSystem

    prefix = b"mako"
    keys = [prefix + str(i).zfill(32 - len(prefix)).encode()
            for i in range(n_keys)]
    values = [b"v%016d" % i for i in range(n_keys)]
    out = {}
    for engine in engines:
        knobs = _durable_knobs(engine)
        with tempfile.TemporaryDirectory(dir=root) as tmp:
            fs = RealFileSystem(tmp)

            async def load():
                cluster = await Cluster.create(ClusterConfig(), knobs, fs=fs,
                                               data_dir="db", device=dev)
                cluster.start()
                chunks = list(range(0, n_keys, 256))
                last = 0

                async def loader(w):
                    nonlocal last
                    tr = Transaction(cluster)
                    for c in chunks[w::32]:
                        while True:
                            try:
                                for i in range(c, min(c + 256, n_keys)):
                                    tr.set(keys[i], values[i])
                                last = max(last, await tr.commit())
                                break
                            except FdbError as e:
                                await tr.on_error(e)
                        tr.reset()

                await asyncio.gather(*(loader(w) for w in range(32)))
                deadline = time.perf_counter() + 120
                tick = Transaction(cluster)
                while min(ss.durable_version
                          for ss in cluster.storage_servers) < last:
                    if time.perf_counter() > deadline:
                        fail(f"{engine}: the load did not become durable")
                    tick.set(b"\xfe-tick", b"%d" % last)
                    await tick.commit()
                    tick.reset()
                    await asyncio.sleep(0.05)
                await cluster.stop()
                return last

            t0 = time.perf_counter()
            last = asyncio.run(load())
            load_s = time.perf_counter() - t0

            async def read():
                cluster = await Cluster.create(ClusterConfig(), knobs, fs=fs,
                                               data_dir="db", device=dev)
                cluster.start()
                K.reset_launches()
                bad = 0
                calls, restore = held_to_plain()
                t1 = time.perf_counter()
                try:
                    for c in range(0, n_keys, 512):
                        got = await Transaction(cluster).get_multi(
                            keys[c:c + 512])
                        bad += sum(1 for a, b in zip(got, values[c:c + 512])
                                   if a != b)
                finally:
                    restore()
                read_s = time.perf_counter() - t1
                mirrors = [ss._device_reads.metrics()
                           if ss._device_reads is not None else None
                           for ss in cluster.storage_servers]
                got = {k: v.launches for k, v in K.KERNELS.items()}
                await cluster.stop()
                return bad, read_s, mirrors, got, calls

            bad, read_s, mirrors, got, calls = asyncio.run(read())
            err, lens = plain_err(calls)
        out[engine] = dict(load_s=load_s, read_s=read_s, mirrors=mirrors,
                           launches=got, plain_err=err)
        say(f"durable {engine}: loaded {n_keys} keys in {load_s:.3f} s "
            f"({n_keys / load_s:.1f} keys/s, last commit {last}), "
            f"re-created from disk, read back in {read_s:.3f} s = "
            f"{n_keys / read_s:.1f} keys/s in get_multi batches of 512; "
            f"mismatched values={bad}; mirrors={json.dumps(mirrors)}; "
            f"launches={got}; every prefix_search of the read-back "
            f"({len(calls)} on mirrors of {lens} prefixes) against its "
            f"plain version: max_abs_err={err}")
        if bad:
            fail(f"durable {engine}: {bad} values read back differ")
        if err or len(calls) != got["prefix_search"]:
            fail(f"durable {engine}: prefix_search differs from its plain "
                 f"version on the read-back's own mirrors and probes")
        armed = [m for m in mirrors if m is not None]
        if engine == "btree":
            if armed or got["prefix_search"]:
                fail("durable btree: a mirror armed without a packed index")
            continue
        if not armed or any(
                m["device_read_batches"] == 0
                or m["device_read_fallbacks"] != m["device_read_uploads"]
                for m in armed) or got["prefix_search"] == 0:
            fail(f"durable {engine}: the read mirror did not serve the "
                 "read-back, or fell back for more than its cold-start "
                 f"and stale batches: {mirrors}, {got}")
    return out


# --------------------------------------------------------------------------
# phase 13: bench.device_plane's three A/Bs


def device_plane_phase(dev) -> tuple[int, list]:
    """bench.device_plane on the card: the sharded mirror against one
    directory at the reference's constants (120000 keys, 12 rounds of
    400-key churn, 512 probes, 2 batches a round, 4 shards), every
    device-served batch held equal to engine.get_batch by the bench and
    every prefix_search call against its plain version on the same
    tensors; then the verdict bitmask against the raw vectors and the
    in-place ring against the rebuild, each pair's verdicts equal.
    Returns prefix_search's max error and each A/B's launches."""
    from foundationdb_tpu_torch.bench import device_plane as dp
    from foundationdb_tpu_torch.ops import kernels as K

    def launches():
        sync(dev)
        return {k: v.launches for k, v in K.KERNELS.items()}
    K.reset_launches()
    calls, restore = held_to_plain()
    try:
        r = dp.run_mirror(dev)
    finally:
        restore()
    got = launches()
    err, lens = plain_err(calls)
    say(f"mirror A/B: {json.dumps(r)} launches={got}; every prefix_search "
        f"({len(calls)} on mirrors of {lens} prefixes) against its plain "
        f"version: max_abs_err={err}")
    if r["devplane_mirror_sharded_batches"] == 0 or got["prefix_search"] \
            == 0 or len(calls) != got["prefix_search"] or err:
        fail(f"the mirror A/B served nothing off the card, or prefix_search "
             f"differs from its plain version: {r}, {got}")
    gots = []
    for name, run, flag in (
            ("verdict bitmask", dp.run_verdict_bitmask,
             "devplane_verdict_parity"),
            ("ring in place", dp.run_ring_inplace, "devplane_ring_parity")):
        K.reset_launches()
        r = run(dev)
        gots.append(launches())
        say(f"{name} A/B: {json.dumps(r)} launches={gots[-1]}")
        if not r[flag] or gots[-1]["commit_chain"] == 0:
            fail(f"the {name} A/B's two sides differ, or it launched no "
                 f"kernel: {r}, {gots[-1]}")
    return err, gots


# --------------------------------------------------------------------------
# phases 14 and 15: YCSB workload F and TPC-C NewOrder, cuda and cpp


def bench_knobs(kind: str):
    """The reference bench.py's run_configs34_phase knobs: cuda at the
    device operating point, cpp with the backend knob alone."""
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    if kind == "cuda":
        return e2e_knobs(kind)
    return Knobs().override(RESOLVER_CONFLICT_BACKEND=kind)


async def ycsb_readback(cluster) -> dict:
    """Every ``user`` row, in reads of 20000 rows a transaction."""
    from foundationdb_tpu_torch.client.transaction import Transaction
    t0 = time.perf_counter()
    keys, short, begin = [], 0, b"user"
    while True:
        rows = await Transaction(cluster).get_range(begin, b"user\xff",
                                                    limit=20_000)
        keys += [k for k, _ in rows]
        short += sum(1 for _, v in rows if len(v) != YCSB_FIELD)
        if len(rows) < 20_000:
            break
        begin = rows[-1][0] + b"\x00"
    return {"keys": keys, "bad_values": short,
            "seconds": time.perf_counter() - t0}


async def tpcc_consistency(cluster, warehouses: int = 2,
                           districts: int = 10) -> dict:
    """TPC-C consistency condition 1 (clause 3.3.2.2) over NewOrder's
    rows: in every district the order ids and the new-order ids are
    exactly [3000, next_o_id), and each order has its n_lines
    order-line rows."""
    from foundationdb_tpu_torch.client import tuple as tup
    from foundationdb_tpu_torch.client.transaction import Transaction
    bad, orders, lines = [], 0, 0
    for w in range(1, warehouses + 1):
        for d in range(1, districts + 1):
            tr = Transaction(cluster)
            next_o_id, _ = tup.unpack(await tr.get(tup.pack(("dist", w, d))))
            want = list(range(3000, next_o_id))
            got = {}
            for table in ("order", "neworder", "orderline"):
                got[table] = [(tup.unpack(k), v) for k, v in await
                              tr.get_range(*tup.range_of((table, w, d)))]
            o_ids = [k[3] for k, _ in got["order"]]
            no_ids = [k[3] for k, _ in got["neworder"]]
            per_order: dict[int, int] = {}
            for k, _ in got["orderline"]:
                per_order[k[3]] = per_order.get(k[3], 0) + 1
            n_lines = {k[3]: tup.unpack(v)[1] for k, v in got["order"]}
            if o_ids != want or no_ids != want or per_order != n_lines:
                bad.append((w, d, next_o_id, len(o_ids), len(no_ids)))
            orders += len(o_ids)
            lines += len(got["orderline"])
    return {"districts": warehouses * districts, "orders": orders,
            "order_lines": lines, "bad": bad}


def bench_run(which: str, kind: str, dev, record: list | None = None):
    """bench.ycsb.run_ycsb_f (BASELINE config 3: YCSB_ROWS rows of one
    100-byte field, zipf 0.99, YCSB_CLIENTS clients) or
    bench.tpcc.run_tpcc_neworder (config 4: 2 warehouses, 10 districts,
    1000 items, half the NewOrders on district (1, 1), TPCC_CLIENTS
    clients) on ``kind``, E2E_WARMUP_S of warm-up, E2E_SECONDS measured.
    Cluster.stop is wrapped so the keyspace is read back (the YCSB rows,
    or TPC-C's condition 1) before the cluster stops; with ``record``,
    every resolve is recorded.  Returns (report, read-back, load s)."""
    from foundationdb_tpu_torch.bench import tpcc, ycsb
    from foundationdb_tpu_torch.core.cluster import Cluster
    knobs = bench_knobs(kind)
    device = dev if kind == "cuda" else None
    if which == "ycsb":
        run = ycsb.run_ycsb_f(knobs, n_rows=YCSB_ROWS,
                              duration_s=E2E_SECONDS, n_clients=YCSB_CLIENTS,
                              field_len=YCSB_FIELD, device=device,
                              warmup_s=E2E_WARMUP_S)
        reader = ycsb_readback
    else:
        run = tpcc.run_tpcc_neworder(knobs, duration_s=E2E_SECONDS,
                                     n_clients=TPCC_CLIENTS, device=device,
                                     warmup_s=E2E_WARMUP_S)
        reader = tpcc_consistency
    seen: dict = {}

    def stop(orig):
        async def reading_back(self):
            seen["read"] = await reader(self)
            await orig(self)
        return reading_back

    def start(orig):
        def starting(self):
            seen["start"] = time.perf_counter()
            orig(self)
        return starting

    class FirstSample(ycsb.ZipfianGenerator):
        # the clients' first draw ends YCSB's load phase
        def sample(self, n):
            seen.setdefault("loaded", time.perf_counter())
            return super().sample(n)

    gc.collect()
    with recording_resolves(record), wrapped(Cluster, "stop", stop), \
            wrapped(Cluster, "start", start), \
            wrapped(ycsb, "ZipfianGenerator", lambda _: FirstSample):
        rep = asyncio.run(run)
    load = seen.get("loaded", seen["start"]) - seen["start"]
    return rep, seen["read"], load


def bench_phase(which: str, dev, count_run) -> list:
    """Phase 14 (ycsb) or 15 (tpcc): cuda then cpp in one process, then
    the cuda run's resolves replayed through a cpp Resolver.  Returns
    the two runs' launch counts."""
    from foundationdb_tpu_torch.bench.ycsb import _ycsb_key
    record: list = []
    reps, gots = {}, []
    for kind in ("cuda", "cpp"):
        (rep, read, load), got = count_run(lambda: bench_run(
            which, kind, dev, record if kind == "cuda" else None))
        reps[kind] = rep
        gots.append(got)
        say(f"{which} {kind}: {json.dumps(rep)}; "
            + (f"load {load:.3f} s; " if which == "ycsb" else "")
            + f"launches={got}")
        if which == "ycsb":
            keys = read.pop("keys")
            want = sorted(_ycsb_key(i) for i in range(YCSB_ROWS))
            say(f"{which} {kind} read-back before stop: {len(keys)} rows "
                f"({YCSB_ROWS} loaded), {read['bad_values']} not "
                f"{YCSB_FIELD} bytes, {read['seconds']:.3f} s")
            if keys != want or read["bad_values"]:
                fail(f"ycsb {kind}: the keyspace read back is not the "
                     f"{YCSB_ROWS} rows of {YCSB_FIELD} bytes loaded")
            if rep["ops"] == 0 or set(rep["abort_codes"]) - {"1007",
                                                              "1020"}:
                fail(f"ycsb {kind}: nothing committed, or an abort that is "
                     f"neither 1007 nor 1020: {rep['abort_codes']}")
        else:
            say(f"{which} {kind} consistency condition 1 before stop: "
                f"{json.dumps(read)}")
            if read["bad"] or rep["new_orders"] == 0 or read["orders"] == 0:
                fail(f"tpcc {kind}: consistency condition 1 fails in "
                     f"{read['bad']}, or no NewOrder committed")
        if got["hist_check"] != got["commit_chain"] or \
                (kind == "cuda") != (got["commit_chain"] > 0):
            fail(f"the {which} {kind} run launched {got}")
    n_cmp, mism = replay_cpp(record)
    say(f"{which} replay: {len(record)} resolve batches, {n_cmp} verdicts "
        f"of the cuda run against a cpp Resolver, mismatches={mism}")
    if mism or n_cmp == 0:
        fail(f"the {which} cuda run's verdicts differ from the cpp replay")
    if which == "ycsb":
        say(f"ycsb ops/s: cuda {reps['cuda']['ops_per_sec']:.1f} cpp "
            f"{reps['cpp']['ops_per_sec']:.1f}")
        return gots
    live = not (reps["cuda"]["livelock"] or reps["cpp"]["livelock"])
    say("tpcc tpmC: " + (f"cuda {reps['cuda']['tpmC']:.1f} cpp "
                         f"{reps['cpp']['tpmC']:.1f}" if live else
                         "livelock on a backend, no tpmC"))
    # the card's idle share over a shorter cuda pass (TPC-C's load is one
    # transaction, so the pass is nearly all NewOrders)
    from foundationdb_tpu_torch.bench.tpcc import run_tpcc_neworder
    idle = idle_share(lambda: asyncio.run(run_tpcc_neworder(
        bench_knobs("cuda"), duration_s=2.0, n_clients=TPCC_CLIENTS,
        device=dev, warmup_s=1.0)))
    say(f"tpcc cuda profiled pass (1 s warm-up, 2 s measured): wall "
        f"{idle['wall_s']:.3f} s, device busy {idle['busy_s']:.6f} s, idle "
        f"share {idle['idle_share']:.6f}, {idle['kernels']} device kernels, "
        f"{idle['report']['new_orders']} NewOrders")
    return gots


# --------------------------------------------------------------------------
# phase 16: the abort-parity gate on the card; phase 17: the probe


def parity_phase(dev, count_run) -> dict:
    """bench.abort_parity at parity_knobs() (R = 8, 24-txn batches, a
    ring of 1 << 13), 60 batches, seed 7, on the card and on the CPU
    plain path: equal reports, and every batch's encoded verdicts equal
    (recorded by wrapping the encoded backend's resolve).  Returns the
    card run's launches."""
    import torch

    from foundationdb_tpu_torch.bench import abort_parity as ap
    from foundationdb_tpu_torch.ops.backends import EncodedConflictBackend
    runs = []
    for d in (dev, torch.device("cpu")):
        verdicts: list = []

        def make(orig):
            def recording(self, txns, v):
                r = orig(self, txns, v)
                verdicts.append((v, [int(x) for x in r]))
                return r
            return recording
        t0 = time.perf_counter()
        with wrapped(EncodedConflictBackend, "resolve", make):
            rep, got = count_run(lambda: ap.run_parity(
                ap.parity_knobs(), "cuda", n_batches=60, batch_size=24,
                seed=7, device=d))
        runs.append((rep, verdicts, got))
        say(f"abort parity on {d.type}: {json.dumps(rep)} launches={got} "
            f"({time.perf_counter() - t0:.3f} s)")
    (card, vc, got), (cpu, vp, got_cpu) = runs
    say(f"abort parity: {len(vc)} encoded batches, verdicts equal to the "
        f"CPU plain path={vc == vp}, report equal={card == cpu}; abort "
        f"rate exact {card['abort_rate_exact']} encoded "
        f"{card['abort_rate_encoded']} (delta {card['abort_rel_delta']}); "
        f"widening aborts: coalescing {card['widening_aborts_coalescing']} "
        f"encoding {card['widening_aborts_encoding']} too_old "
        f"{card['widening_aborts_too_old']}")
    if card != cpu or vc != vp or card["safety_violations"] \
            or card["txns_audited"] != 1440:
        fail("the abort-parity gate on the card differs from the CPU plain "
             "path, or is unsafe, or did not audit 1440 txns")
    if got["commit_chain"] == 0 or any(got_cpu.values()):
        fail(f"the parity run launched {got} on the card, {got_cpu} on the "
             "CPU")
    return got


def probe_phase() -> None:
    """bench.tpu_probe as its own process: the status file must read ok
    with this card's name."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "probe.json")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "foundationdb_tpu_torch.bench.tpu_probe",
             "--out", out], cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        st = json.load(open(out)) if os.path.exists(out) else {}
    say(f"probe: rc {p.returncode}, {json.dumps(st)} "
        f"({time.perf_counter() - t0:.3f} s)")
    if p.returncode or st.get("state") != "ok" or \
            st.get("device") != torch.cuda.get_device_name(0):
        fail(f"the probe did not read ok on this card: {st} {p.stderr}")


# --------------------------------------------------------------------------
# phase 18: the multi-role cluster on the card, through two recoveries


def cluster_knobs(kind: str):
    """The device operating point with memory-engine storage whose
    versions leave the MVCC window 0.1 s of versions behind the tip."""
    return e2e_knobs(kind).override(
        STORAGE_ENGINE="memory", STORAGE_VERSION_WINDOW=100_000,
        STORAGE_DURABILITY_LAG=0.05)


class SimCluster:
    """3 coordinators, 6 workers and a cluster controller over the port's
    SimNetwork (the shape of the reference's recovery tests); each worker
    has its own simulated disk, so storage runs the memory engine and its
    read mirror arms on ``dev``."""

    def __init__(self, knobs, dev, n_workers: int = 6, n_coord: int = 3):
        from foundationdb_tpu_torch.core.coordination import Coordinator
        from foundationdb_tpu_torch.core.worker import Worker
        from foundationdb_tpu_torch.rpc.sim_transport import (SimNetwork,
                                                              SimTransport)
        from foundationdb_tpu_torch.rpc.stubs import serve_role
        from foundationdb_tpu_torch.rpc.transport import (
            WLTOKEN_FIRST_AVAILABLE, NetworkAddress)
        from foundationdb_tpu_torch.runtime.files import SimFileSystem
        self.knobs, self.base = knobs, WLTOKEN_FIRST_AVAILABLE
        self.net = SimNetwork(knobs)
        self._port = 6000
        self.coord_addrs = [NetworkAddress(f"10.0.0.{i + 1}", 4000)
                            for i in range(n_coord)]
        for a in self.coord_addrs:
            serve_role(SimTransport(self.net, a), "coordinator",
                       Coordinator(knobs), self.base)
        self.worker_addrs = [NetworkAddress(f"10.0.2.{i + 1}", 5000)
                             for i in range(n_workers)]
        self.workers = [Worker(i, knobs, SimTransport(self.net, a),
                               self.client_transport, self.base,
                               fs=SimFileSystem(), device=dev)
                        for i, a in enumerate(self.worker_addrs)]

    def client_transport(self):
        from foundationdb_tpu_torch.rpc.sim_transport import SimTransport
        from foundationdb_tpu_torch.rpc.transport import NetworkAddress
        self._port += 1
        return SimTransport(self.net, NetworkAddress(
            f"10.0.9.{self._port % 250}", self._port))

    def coordinator_stubs(self, t=None):
        from foundationdb_tpu_torch.rpc.stubs import CoordinatorClient
        t = t or self.client_transport()
        return [CoordinatorClient(t, a, self.base) for a in self.coord_addrs]

    def make_cc(self):
        from foundationdb_tpu_torch.core.cluster_controller import (
            ClusterConfigSpec, ClusterController)
        from foundationdb_tpu_torch.core.coordination import CoordinatedState
        from foundationdb_tpu_torch.rpc.stubs import WorkerClient
        ct = self.client_transport()
        registry = {a: WorkerClient(ct, a, self.base)
                    for a in self.worker_addrs}
        return ClusterController(
            self.knobs, ct, CoordinatedState(self.coordinator_stubs(ct),
                                             my_id=999),
            registry, ClusterConfigSpec(), self.base)

    async def wait_epoch(self, n: int) -> dict:
        from foundationdb_tpu_torch.core.cluster_client import \
            fetch_cluster_state
        from foundationdb_tpu_torch.runtime.errors import FdbError
        stubs = self.coordinator_stubs()
        while True:
            try:
                state = await fetch_cluster_state(stubs)
                if state.get("epoch", 0) >= n:
                    return state
            except FdbError:
                pass
            await asyncio.sleep(0.2)

    async def kill(self, addr) -> None:
        """The machine dies: its network goes dark and its process (the
        worker and every role it hosts) stops."""
        self.net.kill(addr)
        await self.workers[self.worker_addrs.index(addr)].shutdown()

    def roles(self, name: str) -> list:
        return [obj for a, w in zip(self.worker_addrs, self.workers)
                if not self.net.is_dead(a)
                for role, obj in w.roles.values() if role == name]


def generations(record: list, stopped: set):
    """Wraps Resolver.__init__, resolve and stop: every reply is recorded
    as (generation, its first version, request, reply, answered after
    the role stopped); ``stopped`` collects the stopped generations."""
    import itertools

    from foundationdb_tpu_torch.core.resolver import Resolver
    ids = itertools.count()

    def init(orig):
        def initing(self, *a, **kw):
            orig(self, *a, **kw)
            self._smoke_gen = (next(ids), self.version)
        return initing

    def resolve(orig):
        async def recording(self, req):
            reply = await orig(self, req)
            record.append((*self._smoke_gen, req, reply,
                           self._smoke_gen[0] in stopped))
            return reply
        return recording

    def stop(orig):
        async def stopping(self):
            stopped.add(self._smoke_gen[0])
            await orig(self)
        return stopping
    stack = contextlib.ExitStack()
    for name, make in (("__init__", init), ("resolve", resolve),
                       ("stop", stop)):
        stack.enter_context(wrapped(Resolver, name, make))
    return stack


def replay_generations(record: list) -> tuple[int, int]:
    """Each generation's recorded requests, in version order, through a
    fresh cpp Resolver that begins at the generation's first version:
    (verdicts compared, mismatches)."""
    from foundationdb_tpu_torch.core.resolver import Resolver

    async def main():
        n = bad = 0
        for gen in sorted({r[0] for r in record}):
            rows = sorted((r for r in record if r[0] == gen),
                          key=lambda r: r[2].version)
            res = Resolver(cluster_knobs("cpp"), epoch_begin_version=rows[0][1])
            for _, _, req, reply, _ in rows:
                got = (await res.resolve(req)).verdicts
                n += len(got)
                bad += sum(1 for a, b in zip(got, reply.verdicts) if a != b) \
                    + abs(len(got) - len(reply.verdicts))
            await res.close()
        return n, bad
    return asyncio.run(main())


def cluster_phase(dev, n_keys: int = CLUSTER_KEYS, clients: int = 16,
                  txns: int = 40) -> dict:
    """Phase 18 under the port's run_simulation, every role on ``dev``:
    recover epoch 1; load ``n_keys`` mako keys, run ``clients`` mako
    clients of ``txns`` transactions (2 zipf reads, 2 writes); read every
    key back in get_multi batches of 512 once the load has left the MVCC
    window (the read mirror serves); kill the resolver's machine, then the
    second TLog's, each followed by the next epoch and another mako
    round; read every key back again and read ``\\xff\\xff/status/json``.
    Returns what the checks need."""
    import torch

    from foundationdb_tpu_torch.bench.workload import ZipfianGenerator
    from foundationdb_tpu_torch.client.transaction import Transaction
    from foundationdb_tpu_torch.core.cluster_client import (
        RefreshingDatabase, open_cluster)
    from foundationdb_tpu_torch.rpc.transport import NetworkAddress
    from foundationdb_tpu_torch.runtime.errors import FdbError
    from foundationdb_tpu_torch.runtime.simloop import run_simulation

    def key(i: int) -> bytes:
        return b"mako" + str(int(i)).zfill(28).encode()
    knobs = cluster_knobs("cuda")
    acked: dict[bytes, tuple[int, bytes]] = {}
    unknown: set[bytes] = set()
    out: dict = {"epochs": [], "memory": [], "reads": [], "codes": {}}

    def allocated() -> int:
        if dev.type != "cuda":
            return 0
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    async def main():
        sim = SimCluster(knobs, dev)
        cc = sim.make_cc()
        cc_task = asyncio.get_running_loop().create_task(cc.run())
        state = await sim.wait_epoch(1)
        out["epochs"].append((1, state["recovery_version"]))
        ct = sim.client_transport()
        stubs = sim.coordinator_stubs(ct)
        db = RefreshingDatabase(await open_cluster(knobs, ct, stubs), stubs)
        zipf = ZipfianGenerator(n_keys, 0.99, 7)

        async def run(writes: dict) -> None:
            tr = db.create_transaction()
            while True:
                try:
                    for k, v in writes.items():
                        tr.set(k, v)
                    v = await tr.commit()
                    for k, val in writes.items():
                        if v > acked.get(k, (-1, b""))[0]:
                            acked[k] = (v, val)
                    return
                except FdbError as e:
                    out["codes"][e.code] = out["codes"].get(e.code, 0) + 1
                    if e.code == 1021:      # commit_unknown_result
                        unknown.update(writes)
                        return
                    await tr.on_error(e)

        for c in range(0, n_keys, 256):
            await run({key(i): b"load-%d" % i
                       for i in range(c, min(c + 256, n_keys))})

        async def mako(rnd: int) -> None:
            async def client(cid):
                for i in range(txns):
                    ks = [int(x) for x in zipf.sample(4)]
                    tr = db.create_transaction()
                    try:
                        await tr.get(key(ks[0]))
                        await tr.get(key(ks[1]))
                        val = b"%d:%d-%d" % (rnd, cid, i)
                        tr.set(key(ks[2]), val)
                        tr.set(key(ks[3]), val)
                        v = await tr.commit()
                        for k in (key(ks[2]), key(ks[3])):
                            if v > acked[k][0]:
                                acked[k] = (v, val)
                    except FdbError as e:
                        out["codes"][e.code] = out["codes"].get(e.code, 0) + 1
                        if e.code == 1021:
                            unknown.update((key(ks[2]), key(ks[3])))
            await asyncio.gather(*(client(c) for c in range(clients)))

        async def read_back() -> tuple[int, int]:
            await asyncio.sleep(2.0)        # out of the MVCC window
            keys = [key(i) for i in range(n_keys)]
            bad = 0
            for c in range(0, n_keys, 512):
                while True:
                    try:
                        got = await Transaction(db.view).get_multi(
                            keys[c:c + 512])
                        break
                    except FdbError as e:
                        await db.refresh()
                        await asyncio.sleep(0.1)
                bad += sum(1 for k, g in zip(keys[c:c + 512], got)
                           if k not in unknown and g != acked[k][1])
            return len(keys) - len(unknown & set(keys)), bad

        await mako(0)
        out["reads"].append(await read_back())
        out["memory"].append(allocated())
        for n, role in ((2, "resolver"), (3, "tlog")):
            victim = NetworkAddress(*(state["resolvers"][0]["addr"]
                                      if role == "resolver" else
                                      state["log_cfg"][-1]["tlogs"][1]))
            if (victim.ip, victim.port) in {tuple(s["worker"])
                                            for s in state["storage"]}:
                fail(f"the {role}'s machine hosts a storage replica")
            await sim.kill(victim)
            state = await sim.wait_epoch(n)
            out["epochs"].append((n, state["recovery_version"]))
            await db.refresh()
            await mako(n)
            out["memory"].append(allocated())
        out["reads"].append(await read_back())
        tr = db.create_transaction()
        while True:
            try:
                out["status"] = json.loads(
                    await tr.get(b"\xff\xff/status/json"))
                break
            except FdbError as e:
                await tr.on_error(e)
        resolvers = sim.roles("resolver")
        out["resolvers"] = len(resolvers)
        cs = resolvers[0].backend.cs
        out["ring_bytes"] = sum(t.numel() * t.element_size()
                                for t in cs.state if torch.is_tensor(t))
        out["mirrors"] = [ss._device_reads.metrics()
                          for ss in sim.roles("storage")
                          if ss._device_reads is not None]
        out["acked"], out["unknown"] = len(acked), len(unknown)
        cc_task.cancel()
        await asyncio.gather(cc_task, return_exceptions=True)
        await cc.stop()
        for w in sim.workers:
            await w.shutdown()

    record: list = []
    stopped: set = set()
    calls, restore = held_to_plain()
    t0 = time.perf_counter()
    try:
        with generations(record, stopped):
            run_simulation(main(), seed=18)
    finally:
        restore()
    out["seconds"] = time.perf_counter() - t0
    out["record"], out["stopped"] = record, stopped
    out["prefix_calls"] = calls
    return out


def check_cluster_phase(r: dict, got: dict, on_card: bool) -> None:
    """Phase 18's checks (the launch counts only on the card)."""
    err, lens = plain_err(r["prefix_calls"])
    n_cmp, mism = replay_generations(r["record"])
    gens = sorted({x[0] for x in r["record"]})
    late = sum(1 for x in r["record"] if x[4])
    doc = r["status"]["cluster"]
    dv, mem = doc["resolver_device"], r["memory"]
    say(f"cluster: epochs {r['epochs']} in {r['seconds']:.3f} s; "
        f"acknowledged keys {r['acked']}, unknown results {r['unknown']}, "
        f"aborts by code {r['codes']}; read-backs (keys, mismatches) "
        f"{r['reads']}; {len(r['record'])} resolves over {len(gens)} "
        f"resolver generations ({len(r['stopped'])} stopped), replayed "
        f"through a fresh cpp Resolver each: {n_cmp} verdicts, "
        f"mismatches={mism}; replies after their role stopped {late}; "
        f"launches={got}")
    say(f"cluster: {len(r['prefix_calls'])} prefix_search calls on mirrors "
        f"of {lens} prefixes against the plain version: max_abs_err={err}; "
        f"mirrors {json.dumps(r['mirrors'])}")
    say(f"cluster status: epoch {doc['epoch']}, available "
        f"{doc['database_available']}, resolver_device {json.dumps(dv)}, "
        f"device_reads {json.dumps(doc['device_reads'])}")
    say(f"cluster device memory: {mem} bytes allocated after epochs 1, 2, "
        f"3 (one ring is {r['ring_bytes']} bytes); live resolvers "
        f"{r['resolvers']}")
    if mism or n_cmp == 0 or len(gens) < 3:
        fail("a resolver generation's verdicts differ from the cpp replay, "
             "or fewer than three generations resolved")
    if err or any(bad for _, bad in r["reads"]) or r["unknown"]:
        fail("prefix_search differs from its plain version, or an "
             "acknowledged write did not read back")
    if late:
        fail("a resolver answered after its role stopped")
    if doc["epoch"] < 3 or dv["pipelined_resolvers"] < 1 \
            or dv["dispatches"] <= 0 or r["resolvers"] != 1:
        fail("the status document does not show epoch 3 and a pipelined "
             "resolver that dispatched, or the ended generations' "
             "resolvers are still hosted")
    if on_card:
        if got["hist_check"] != got["commit_chain"] or \
                got["commit_chain"] == 0 or got["prefix_search"] == 0 \
                or len(r["prefix_calls"]) != got["prefix_search"]:
            fail(f"the cluster launched {got}")
        if max(mem) - min(mem) > r["ring_bytes"]:
            fail(f"device memory grew across recoveries: {mem}")


# --------------------------------------------------------------------------
# phase 19: three server processes over TCP


def tcp_phase(dev_name: str, clients: int = 64, txns: int = 50,
              root: str | None = None) -> dict:
    """Three ``python3 -m foundationdb_tpu_torch.server`` processes on
    free localhost ports, all coordinators, ``--spec min_workers=3
    --device <dev_name>``; a client here opens the cluster through the
    coordinators over TcpTransport, commits ``clients`` x ``txns``
    transactions (each reads one earlier key and writes its own), reads
    every one back, reads and clears the range, and reads the status
    document.  The servers are stopped with SIGTERM, then SIGKILL past a
    deadline."""
    import signal
    import socket

    from foundationdb_tpu_torch.core.cluster_client import (
        RefreshingDatabase, open_cluster)
    from foundationdb_tpu_torch.core.cluster_file import ClusterFile
    from foundationdb_tpu_torch.rpc.stubs import make_coordinator_stubs
    from foundationdb_tpu_torch.rpc.tcp_transport import TcpTransport
    from foundationdb_tpu_torch.rpc.transport import NetworkAddress
    from foundationdb_tpu_torch.runtime.errors import FdbError
    from foundationdb_tpu_torch.runtime.knobs import Knobs

    socks = [socket.socket() for _ in range(3)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    repo = os.path.dirname(os.path.abspath(__file__))
    out: dict = {"codes": {}}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        cf_path = os.path.join(tmp, "fdb.cluster")
        ClusterFile("smoke", "t1", [NetworkAddress("127.0.0.1", p)
                                    for p in ports]).save(cf_path)
        logs = [os.path.join(tmp, f"server-{p}.log") for p in ports]
        env = dict(os.environ, PYTHONPATH=repo)
        procs = []
        t_spawn = time.perf_counter()
        try:
            for p, lg in zip(ports, logs):
                with open(lg, "ab") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "foundationdb_tpu_torch.server",
                         "-C", cf_path, "-l", f"127.0.0.1:{p}",
                         "--spec", "min_workers=3", "--device", dev_name],
                        cwd=repo, env=env, stdout=f, stderr=subprocess.STDOUT))

            async def drive():
                knobs = Knobs()
                t = TcpTransport(NetworkAddress("127.0.0.1", 0))
                coords = make_coordinator_stubs(
                    ClusterFile.load(cf_path).coordinators, transport=t)
                deadline = time.perf_counter() + 180
                while True:
                    if any(p.poll() is not None for p in procs):
                        fail("a server exited before the cluster "
                             "recovered: " + " | ".join(
                                 open(lg, errors="replace").read()[-800:]
                                 for lg in logs))
                    try:
                        view = await open_cluster(knobs, t, coords)
                        break
                    except (FdbError, OSError):
                        if time.perf_counter() > deadline:
                            fail("no cluster state within 180 s")
                        await asyncio.sleep(0.25)
                db = RefreshingDatabase(view, coords)
                await db.set(b"tcp-first", b"1")
                out["recovery_s"] = time.perf_counter() - t_spawn
                lat: list[float] = []
                acked: dict[bytes, bytes] = {}

                async def client(cid):
                    for i in range(txns):
                        k = b"tcp/%04d/%04d" % (cid, i)
                        v = b"v%d-%d" % (cid, i)
                        tr = db.create_transaction()
                        t1 = time.perf_counter()
                        while True:
                            try:
                                if i:
                                    await tr.get(b"tcp/%04d/%04d"
                                                 % (cid, i - 1))
                                tr.set(k, v)
                                await tr.commit()
                                lat.append(time.perf_counter() - t1)
                                acked[k] = v
                                break
                            except FdbError as e:
                                out["codes"][e.code] = \
                                    out["codes"].get(e.code, 0) + 1
                                await tr.on_error(e)
                t1 = time.perf_counter()
                await asyncio.gather(*(client(c) for c in range(clients)))
                out["commit_s"] = time.perf_counter() - t1
                keys = sorted(acked)
                bad = 0
                for c in range(0, len(keys), 512):
                    got = await db.create_transaction().get_multi(
                        keys[c:c + 512])
                    bad += sum(1 for k, g in zip(keys[c:c + 512], got)
                               if g != acked[k])
                rows = await db.get_range(b"tcp/", b"tcp0", limit=0)
                await db.clear_range(b"tcp/", b"tcp0")
                left = await db.get_range(b"tcp/", b"tcp0")
                tr = db.create_transaction()
                doc = json.loads(await tr.get(b"\xff\xff/status/json"))
                await t.close()
                lat.sort()
                out.update(committed=len(lat), bad=bad,
                           range_rows=len(rows),
                           range_equal=rows == [(k, acked[k]) for k in keys],
                           left=len(left), status=doc["cluster"],
                           p50_ms=lat[len(lat) // 2] * 1e3,
                           p99_ms=lat[int(len(lat) * 0.99)] * 1e3)
            asyncio.run(asyncio.wait_for(drive(), 600))
            out["alive"] = [p.poll() is None for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            deadline = time.time() + 15
            for p in procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        out["exit_codes"] = [p.returncode for p in procs]
        out["tracebacks"] = [lg for lg in logs
                             if "Traceback" in open(lg, errors="replace")
                             .read()]
        out["log_tails"] = [open(lg, errors="replace").read()[-1500:]
                            for lg in out["tracebacks"]]
    return out


def check_tcp_phase(r: dict, card: str) -> None:
    c = r["status"]
    dv = c["resolver_device"]
    say(f"tcp: {r['committed']} transactions committed in "
        f"{r['commit_s']:.3f} s = {r['committed'] / r['commit_s']:.1f} "
        f"txns/s, client latency p50 {r['p50_ms']:.3f} ms p99 "
        f"{r['p99_ms']:.3f} ms, retries by code {r['codes']} ({card})")
    say(f"tcp: time to the first recovery (spawn to the first commit) "
        f"{r['recovery_s']:.3f} s ({card})")
    say(f"tcp: read back {r['committed']} keys with {r['bad']} mismatches; "
        f"range read {r['range_rows']} rows (equal {r['range_equal']}), "
        f"{r['left']} left after the clear; status epoch {c['epoch']}, "
        f"available {c['database_available']}, resolver_device "
        f"{json.dumps(dv)}; servers alive before teardown {r['alive']}, "
        f"exit codes {r['exit_codes']}, logs with a traceback "
        f"{len(r['tracebacks'])}")
    for tail in r["log_tails"]:
        say(f"tcp server log tail: {tail}")
    if r["bad"] or not r["range_equal"] or r["left"] or r["committed"] == 0:
        fail("the TCP cluster lost an acknowledged write or a clear")
    if c["epoch"] != 1 or dv["pipelined_resolvers"] != 1 \
            or dv["dispatches"] <= 0:
        fail("the TCP cluster's status shows no pipelined resolver in "
             "epoch 1 that dispatched")
    if not all(r["alive"]) or r["tracebacks"] or any(r["exit_codes"]):
        fail("a server died, logged a traceback or did not stop cleanly "
             "on SIGTERM")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from foundationdb_tpu_torch.ops import kernels as K
    except ImportError as e:
        fail(f"the port package is missing ({e}); run from the repo root")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    say(smi.stdout.strip())
    global CARD
    CARD = smi.stdout.strip()
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 2. build
    say(f"kernel build: {K.build():.3f} s ({len(K.KERNELS)} sources, "
        "parallel nvcc)")

    # 3. kernels vs plain
    report: dict = {}
    kernel_phase(dev, report)
    bad = {k: v["max_abs_err"] for k, v in report.items() if v["max_abs_err"]}
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    say("kernels: all equal to their plain versions (tolerance 0)")

    def count_run(fn):
        K.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v.launches for k, v in K.KERNELS.items()}

    # 4. resolver, mako
    from foundationdb_tpu_torch.bench.workload import MakoWorkload
    from foundationdb_tpu_torch.ops.conflict_cpp import CppConflictSet
    wl = MakoWorkload(n_keys=1_000_000, key_width=WIDTH, seed=42)
    mb, mv = wl.make_batches(MAKO_BATCHES, B)
    knobs = smoke_knobs()
    run_resolver(knobs, mb, mv)                 # warm-up (allocators)
    (rep4, dt4, m4, st4), got4 = count_run(
        lambda: run_resolver(knobs, mb, mv))
    n_txns = MAKO_BATCHES * B
    cpp = CppConflictSet()
    ref = [x for t, v in zip(mb, mv) for x in cpp.resolve(t, v)]
    v4 = flat(rep4)
    mism = sum(1 for a, b in zip(v4, ref) if a != b)
    from foundationdb_tpu_torch.core.resolver import pack_abort_words
    words_ok = all(r.abort_words == pack_abort_words(r.verdicts)
                   for r in rep4)
    say(f"resolver mako: {MAKO_BATCHES} batches x {B} txns in {dt4:.3f} s "
        f"= {n_txns / dt4:.1f} txns/s; dispatches={m4['device_dispatches']} "
        f"group_mean={m4['device_group_mean']} "
        f"aborts={sum(1 for x in v4 if x)} mismatches_vs_cpp={mism} "
        f"readback_bytes_per_txn="
        f"{m4['device_readback_bytes'] / max(1, m4['device_readback_txns']):.4f}"
        f" launches={got4}")
    if len(v4) != len(ref) or mism or not words_ok:
        fail("mako verdicts differ from the exact C++ conflict set")
    if got4["commit_chain"] == 0 or got4["hist_check"] == 0:
        fail(f"mako run did not launch the kernels: {got4}")

    # 5. resolver, ranges: full-ring fallback at the operating point
    rb5, rv5 = range_batches(32, 7, (17, 200))
    (rep5, dt5, _, st5), got5 = count_run(
        lambda: run_resolver(knobs, rb5, rv5))
    rep5c, dt5c, _, st5c = run_resolver(knobs, rb5, rv5,
                                        device=torch.device("cpu"))
    v5, v5c = flat(rep5), flat(rep5c)
    say(f"resolver ranges (ring 1<<17, window 8192): 32 batches, aborts="
        f"{sum(1 for x in v5 if x == 1)} too_old="
        f"{sum(1 for x in v5 if x == 2)}; card {dt5:.3f} s, cpu plain "
        f"{dt5c:.3f} s; verdicts equal={v5 == v5c} ring equal="
        f"{same_state(st5, st5c)} launches={got5}")
    if v5 != v5c or not same_state(st5, st5c):
        fail("range verdicts or ring state differ from the CPU plain path")
    if got5["commit_chain"] == 0 or got5["hist_check"] == 0:
        fail(f"range run did not launch the kernels: {got5}")
    # ... and with a small ring that wraps and evicts
    small = smoke_knobs(CONFLICT_RING_CAPACITY=1 << 13,
                        CONFLICT_WINDOW_SLOTS=1024)
    rb6, rv6 = range_batches(64, 8, (17, 40))
    (rep6, dt6, _, st6), got6 = count_run(
        lambda: run_resolver(small, rb6, rv6))
    rep6c, _, _, st6c = run_resolver(small, rb6, rv6,
                                     device=torch.device("cpu"))
    v6, v6c = flat(rep6), flat(rep6c)
    too_old = sum(1 for x in v6 if x == 2)
    say(f"resolver ranges (ring 1<<13, window 1024): 64 batches, aborts="
        f"{sum(1 for x in v6 if x == 1)} too_old={too_old}; verdicts equal="
        f"{v6 == v6c} ring equal={same_state(st6, st6c)} floor={st6[3]} "
        f"launches={got6}")
    if v6 != v6c or not same_state(st6, st6c) or too_old == 0:
        fail("small-ring verdicts or ring state differ from the CPU plain "
             "path, or eviction produced no TOO_OLD")
    if got6["commit_chain"] == 0 or got6["hist_check"] == 0:
        fail(f"small-ring run did not launch the kernels: {got6}")

    # 6. RESOLVER_RING_INPLACE on the mako stream
    inplace = smoke_knobs(RESOLVER_RING_INPLACE=True)
    (rep7, dt7, m7, st7), got7 = count_run(
        lambda: run_resolver(inplace, mb, mv))
    say(f"resolver mako ring_inplace: {dt7:.3f} s = {n_txns / dt7:.1f} "
        f"txns/s; dispatches={m7['device_dispatches']} verdicts equal="
        f"{flat(rep7) == v4} ring equal={same_state(st7, st4)} "
        f"launches={got7}")
    if flat(rep7) != v4 or not same_state(st7, st4):
        fail("RESOLVER_RING_INPLACE changed verdicts or ring state")
    if min(got7[k] for k in ("commit_chain", "ring_append",
                             "hist_check")) == 0:
        fail("the ring-inplace mako run did not launch every resolver "
             f"kernel: {got7}")

    # 7. the endpoint dictionary on the mako stream
    dkn = smoke_knobs(CONFLICT_DICT_SLOTS=1 << 21)
    (rep8, dt8, m8, st8), got8 = count_run(
        lambda: run_resolver(dkn, mb, mv))
    v8 = flat(rep8)
    mism8 = sum(1 for a, b in zip(v8, ref) if a != b)
    say(f"resolver mako dictionary 1<<21: {dt8:.3f} s = {n_txns / dt8:.1f} "
        f"txns/s (lanes {n_txns / dt4:.1f}); dispatches="
        f"{m8['device_dispatches']} dictionary groups={m8['dict_dispatches']}"
        f" fallbacks={m8['dict_fallbacks']} h2d bytes per batch "
        f"{m8['h2d_bytes'] / MAKO_BATCHES:.1f} (lanes "
        f"{m4['h2d_bytes'] / MAKO_BATCHES:.1f}) host us per batch "
        f"{m8['device_dispatch_us_per_batch']:.1f} (lanes "
        f"{m4['device_dispatch_us_per_batch']:.1f}) mismatches_vs_cpp={mism8}"
        f" verdicts equal={v8 == v4} ring equal={same_state(st8, st4)} "
        f"launches={got8}")
    if len(v8) != len(ref) or mism8 or v8 != v4 or not same_state(st8, st4):
        fail("the dictionary changed mako verdicts or ring state")
    if m8["dict_dispatches"] == 0 or m8["dict_fallbacks"] \
            or m4["dict_dispatches"]:
        fail("the dictionary run did not take the dictionary branch "
             f"every group: {m8['dict_dispatches']} groups, "
             f"{m8['dict_fallbacks']} fallbacks")
    # B6, the dictionary's scatter and gather, for one group of 64 mako
    # batches (B=64, R=8): device time, and the bound from the bytes the
    # ops must move
    from foundationdb_tpu_torch.bench import profile_fused as pf
    from foundationdb_tpu_torch.ops.batch import wire_from_txns
    b6 = pf.b6_device_us([wire_from_txns(t) for t in mb[:64]], mv[:64],
                         (64, B, R), WIDTH)
    for name, r in b6.items():
        if "skipped" in r:
            fail(f"B6 {name} group: {r}")
        say(f"B6 dictionary ops, group of 64 (B={B}, R={R}), {name}: "
            f"{r['kernels']} kernels, {r['device_us']:.3f} us, {r['U']} "
            f"update slots ({r['n_upd']} real), {r['bytes']} bytes, "
            f"bound_ms={r['bytes'] / HBM_BYTES_PER_S * 1e3:.8f} (bytes)")

    # 8. the smallest dictionary under range streams that make it evict.
    # Nearly every endpoint is new, 1152 a batch: groups of 16 batches
    # keep a group's updates under the ids path's 32768 (a larger group
    # would take the lanes fallback)
    slots = 8 * R * B * 64
    ekn = smoke_knobs(CONFLICT_RING_CAPACITY=1 << 13,
                      CONFLICT_WINDOW_SLOTS=1024, CONFLICT_DICT_SLOTS=slots,
                      RESOLVER_GROUP_MAX=16)
    rb9, rv9 = range_batches(288, 9, (17, 40), span=1 << 40, hot=0.1)
    keys9 = {k for b in rb9 for t in b
             for rr in (t.read_ranges, t.write_ranges) for r in rr for k in r}
    (rep9, dt9, m9, st9), got9 = count_run(
        lambda: run_resolver(ekn, rb9, rv9, want_dict=True))
    t9 = time.perf_counter()
    rep9c, _, m9c, st9c = run_resolver(ekn, rb9, rv9, device=torch.device(
        "cpu"), want_dict=True)
    dt9c = time.perf_counter() - t9
    v9, v9c = flat(rep9), flat(rep9c)
    dict_eq = np.array_equal(m9["dict"], m9c["dict"])
    say(f"resolver ranges, dictionary {slots} slots, {len(keys9)} distinct "
        f"endpoints (ring 1<<13, window 1024): 288 batches, aborts="
        f"{sum(1 for x in v9 if x == 1)} too_old="
        f"{sum(1 for x in v9 if x == 2)}; card {dt9:.3f} s, cpu plain "
        f"{dt9c:.3f} s; dictionary groups={m9['dict_dispatches']} "
        f"fallbacks={m9['dict_fallbacks']}; verdicts equal={v9 == v9c} ring "
        f"equal={same_state(st9, st9c)} dictionary equal={dict_eq} "
        f"launches={got9}")
    if v9 != v9c or not same_state(st9, st9c) or not dict_eq:
        fail("dictionary range verdicts, ring or dictionary differ from the "
             "CPU plain path")
    if len(keys9) < slots or m9["dict_dispatches"] == 0 \
            or m9["dict_fallbacks"] or 1 not in v9:
        fail("the eviction run did not evict, did not take the dictionary "
             "every group, or had no conflict")

    # 9. the wire path at the reference bench.py's configuration
    wb, wv = MakoWorkload(n_keys=1_000_000, key_width=WIDTH, seed=42) \
        .make_batches(WIRE_BATCHES, B)
    wires = [wire_from_txns(t) for t in wb]
    wn = WIRE_BATCHES * B
    cpp_w = CppConflictSet()
    t0 = time.perf_counter()
    want = [x for w, v in zip(wires, wv) for x in cpp_w.resolve_wire(w, v)]
    rates = {"cpp": wn / (time.perf_counter() - t0)}
    gots = []
    for path in ("fused", "ids", "lanes"):
        be, begin = pf.make_backend(path), pf.begin_of(path)
        pf.measured_pass(be, wires, wv, begin)          # warm pass
        r, got = count_run(lambda: pf.measured_pass(be, wires, wv, begin))
        gots.append(got)
        rates[path] = wn / r["s"]
        mism = sum(1 for a, b in zip(r["verdicts"], want) if a != b)
        say(f"wire {path}: {WIRE_BATCHES} batches x {B} txns in "
            f"{r['s']:.3f} s = {rates[path]:.1f} txns/s; h2d bytes per "
            f"batch {r['h2d_bytes'] / WIRE_BATCHES:.1f}; dictionary groups "
            f"{r['dict_dispatches']}; mismatches_vs_cpp_resolve_wire={mism} "
            f"launches={got}")
        if len(r["verdicts"]) != len(want) or mism:
            fail(f"wire path {path} differs from CppConflictSet.resolve_wire")
        if (path != "lanes") != (r["dict_dispatches"] > 0) \
                or got["hist_check"] == 0:
            fail(f"wire path {path} did not take its branch: {r}, {got}")
    say(f"wire txns/s: {json.dumps(rates)}")

    # 10. the commit path end to end, cuda then cpp.  The earlier phases'
    # batches, replies and backends go first: a full collection of their
    # millions of objects stalls the event loop for most of a second.
    # The roles' trace events go to a temporary file, as the reference
    # bench routes them
    del (mb, mv, ref, v4, rep4, rep5, rep5c, rep6, rep6c, rep7, rep8, v8,
         rb5, rv5, rb6, rv6, rb9, rv9, keys9, rep9, rep9c, v9, v9c, wb, wv,
         wires, want, r, be)
    gc.collect()
    from foundationdb_tpu_torch.runtime.trace import TraceLog, set_trace_log
    trace_dir = tempfile.TemporaryDirectory()
    set_trace_log(TraceLog(path=os.path.join(trace_dir.name, "e2e.jsonl")))
    record: list = []
    e2e = {}
    for kind in ("cuda", "cpp"):
        e2e[kind], got = count_run(lambda: e2e_run(
            kind, dev, record if kind == "cuda" else None))
        e2e_report(kind, e2e[kind], got)
        if e2e[kind]["committed"] == 0:
            fail(f"no transaction committed on the {kind} backend")
        if got["hist_check"] != got["commit_chain"] or \
                (kind == "cuda") != (got["commit_chain"] > 0):
            fail(f"the {kind} commit path launched {got}")
        if kind == "cuda":
            got10 = got
    say(f"e2e txns/s: cuda {e2e['cuda']['tps']:.1f} cpp "
        f"{e2e['cpp']['tps']:.1f}")
    idle = idle_share(lambda: e2e_run("cuda", dev, warmup_s=1.0,
                                      seconds=2.0))
    say(f"e2e cuda profiled pass (1 s warm-up, 2 s measured): wall "
        f"{idle['wall_s']:.3f} s, device busy {idle['busy_s']:.6f} s, idle "
        f"share {idle['idle_share']:.6f}, {idle['kernels']} device kernels, "
        f"{idle['report']['tps']:.1f} txns/s")

    # 10b. the cuda run's verdicts against a cpp replay of its requests
    t0 = time.perf_counter()
    n_cmp, mism10 = replay_cpp(record)
    say(f"e2e replay: {len(record)} resolve batches, {n_cmp} verdicts "
        f"compared against a cpp Resolver, mismatches={mism10} "
        f"({time.perf_counter() - t0:.3f} s)")
    if mism10 or n_cmp == 0:
        fail("the cuda commit path's verdicts differ from the cpp replay")

    # 10c. serializability at the client
    ctr, got10c = count_run(lambda: counter_run(dev))
    say(f"e2e counters: {ctr['clients']} clients, {ctr['seconds']} s, "
        f"acknowledged commits {ctr['acked']}, counter sum {ctr['sum']} "
        f"over {ctr['keys']} keys, aborts by code {ctr['codes']}, "
        f"launches={got10c}")
    if ctr["acked"] == 0 or ctr["sum"] != ctr["acked"] or \
            set(ctr["codes"]) - {1007, 1020}:
        fail("the counters' sum differs from the acknowledged commits "
             "(a lost update), or a commit's outcome was unknown")

    # 11. the multi-resolver; 12. durable storage; 13. the device-plane
    # A/Bs.  prefix_search's error adds the path's own calls (12, 13)
    gots11 = multi_resolver_phase(dev)
    durable = durable_phase(dev)
    got12 = {k: sum(d["launches"][k] for d in durable.values())
             for k in K.KERNELS}
    err13, gots13 = device_plane_phase(dev)
    report["prefix_search"]["max_abs_err"] = max(
        report["prefix_search"]["max_abs_err"], err13,
        *(d["plain_err"] for d in durable.values()))

    # 14. YCSB-F; 15. TPC-C NewOrder; 16. the abort-parity gate; 17. the
    # probe
    gots14 = bench_phase("ycsb", dev, count_run)
    gots15 = bench_phase("tpcc", dev, count_run)
    set_trace_log(TraceLog())
    trace_dir.cleanup()
    got16 = parity_phase(dev, count_run)
    probe_phase()

    # 18. the multi-role cluster through two recoveries; 19. three server
    # processes over TCP.  The trace events of phase 18's roles and of
    # phase 19's client go to a temporary file
    trace_dir = tempfile.TemporaryDirectory()
    set_trace_log(TraceLog(path=os.path.join(trace_dir.name, "sim.jsonl")))
    t0 = time.perf_counter()
    r18, got18 = count_run(lambda: cluster_phase(dev))
    check_cluster_phase(r18, got18, True)
    del r18
    say(f"phase 18: {time.perf_counter() - t0:.1f} s ({CARD})")
    t0 = time.perf_counter()
    check_tcp_phase(tcp_phase("cuda"), CARD)
    say(f"phase 19: {time.perf_counter() - t0:.1f} s ({CARD})")
    set_trace_log(TraceLog())
    trace_dir.cleanup()

    for got in (got4, got5, got6, got7, got8, got9, *gots, got10, got10c,
                *gots11, got12, *gots13, *gots14, *gots15, got16, got18):
        if got["hist_check"] != got["commit_chain"]:
            fail(f"a resolved batch is one K3 and one K1 launch: {got}")

    # 20. the kernels line, then the result.  The resolver kernels'
    # launches are those of the mako run with RESOLVER_RING_INPLACE (phase
    # 6), the one run that takes all three; prefix_search's are those of
    # the durable read-back (phase 12, every engine); each phase printed
    # its own counts above.
    launches = dict(got7, prefix_search=got12["prefix_search"])
    meta = {
        "commit_chain": ("foundationdb_tpu_torch/csrc/commit_chain.cu",
                         "foundationdb_tpu/ops/conflict_jax.py:221"),
        "ring_append": ("foundationdb_tpu_torch/csrc/ring_append.cu",
                        "foundationdb_tpu/ops/conflict_jax.py:277"),
        "hist_check": ("foundationdb_tpu_torch/csrc/hist_check.cu",
                       "foundationdb_tpu/ops/conflict_jax.py:150"),
        "prefix_search": ("foundationdb_tpu_torch/csrc/prefix_search.cu",
                          "foundationdb_tpu/device/read_serve.py:113"),
    }
    line = []
    for name, (src, repl) in meta.items():
        r = report[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     **{k: r[k] for k in ("latency_bound_ms", "chain_step_ms",
                                          "level_ms") if k in r}})
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": line}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
