#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

    python3 chip_smoke.py

from the repository root.  It drives foundationdb_tpu_torch's resolver
path on the card and exits non-zero on any failure:

1. the card's name and power limit (nvidia-smi);
2. builds the hand kernels from csrc/*.cu (one nvcc per source, in
   parallel) and prints the build time;
3. holds each kernel against its plain PyTorch version on the same
   seeded inputs at the resolver's shapes, tolerance 0 (integers), and
   times both with CUDA events: K1 (a batch's whole verdict step) at
   B = 64 and 100 under both rules, writing into a hot-buffer view; K2
   on the hot-buffer view; K3 under both rules on the resolver's own
   cold ring + hot buffer, with the inputs deciding the window (fast_ok)
   and the full side, and on a lone ring;
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
10. one JSON line with each kernel's launches in phase 6's run, max
   error, times and bound (K1 also its latency bound: B chain steps at
   the step time measured in phase 3); the last line is the result.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
# int32 ALU rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (H100 SXM)
INT32_OPS_PER_S = 132 * 64 * 1.98e9

MAKO_BATCHES = 2048
WIRE_BATCHES = 4096
B, R, WIDTH = 64, 8, 32


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*a) -> None:
    print(*a, flush=True)


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
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 2. build
    say(f"kernel build: {K.build():.3f} s (3 sources, parallel nvcc)")

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
    if min(got7.values()) == 0:
        fail(f"the ring-inplace mako run did not launch every kernel: {got7}")

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
    from foundationdb_tpu_torch.bench import profile_fused as pf
    from foundationdb_tpu_torch.ops.batch import wire_from_txns
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

    for got in (got4, got5, got6, got7, got8, got9, *gots):
        if got["hist_check"] != got["commit_chain"]:
            fail(f"a resolved batch is one K3 and one K1 launch: {got}")

    # 10. the kernels line, then the result.  Its launches are those of the
    # mako run with RESOLVER_RING_INPLACE (phase 6), the one run that
    # takes all three kernels; each phase printed its own counts above.
    meta = {
        "commit_chain": ("foundationdb_tpu_torch/csrc/commit_chain.cu",
                         "foundationdb_tpu/ops/conflict_jax.py:221"),
        "ring_append": ("foundationdb_tpu_torch/csrc/ring_append.cu",
                        "foundationdb_tpu/ops/conflict_jax.py:277"),
        "hist_check": ("foundationdb_tpu_torch/csrc/hist_check.cu",
                       "foundationdb_tpu/ops/conflict_jax.py:150"),
    }
    line = []
    for name, (src, repl) in meta.items():
        r = report[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": got7[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     **{k: r[k] for k in ("latency_bound_ms", "chain_step_ms")
                        if k in r}})
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": line}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
