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
   times both with CUDA events;
4. the port's Resolver at the reference's device operating point
   (B=64, R=8, 32-byte keys, ring 1<<17, window 8192, group bucket 8,
   pipeline and verdict bitmask on) answers 2048 concurrently submitted
   mako batches (zipf 0.99, 2 point reads + 2 point writes a txn); every
   verdict must equal the port's exact C++ conflict set;
5. random ranges (the interval rule): at the same size with ~10% of
   snapshots older than the window (the full-ring fallback), and at a
   ring of 1<<13 with a window of 1024 (eviction raises the floor, so
   TOO_OLD appears); verdicts and ring state must be bit-identical to the
   port's plain path on the CPU;
6. RESOLVER_RING_INPLACE=True on the mako stream: verdicts and ring
   state identical to phase 4;
7. one JSON line with each kernel's launches in phase 6's run, max
   error, times and bound; the last line is the result.

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


def _ranges(g, kc, n: int, points: bool):
    """n encoded ranges [n, L] (begin, end), u32, of random keys (some
    longer than WIDTH, so the truncation rules are exercised): points,
    or intervals of which 90% are narrow [k, k+"\\x01") and 10% wide."""
    a = _rand_keys(g, n, WIDTH + 8)
    if points:
        b = [k + b"\x00" for k in a]
    else:
        c = _rand_keys(g, n, WIDTH + 8)
        wide = g.random(n) < 0.1
        b = [max(x, y) + b"\x00" if w else x + b"\x01"
             for x, y, w in zip(a, c, wide)]
        a = [min(x, y) if w else x for x, y, w in zip(a, c, wide)]
    return kc.encode_keys(a, WIDTH), kc.encode_keys(b, WIDTH)


def kernel_phase(dev, report: dict) -> None:
    import torch

    from foundationdb_tpu_torch.ops import keycode as kc
    from foundationdb_tpu_torch.ops import kernels as K
    from foundationdb_tpu_torch.ops.conflict_torch import map_lanes

    g = np.random.default_rng(1234)
    L = kc.nlanes(WIDTH)

    def note(name, err, ms, plain_ms, bound_ms, bound_by, lib_ms=None,
             line=False):
        r = report.setdefault(name, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if line:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=lib_ms)

    # K1: the commit chain at B = 64 (the main path) and B = 100
    for Bk in (64, 100):
        nw = (Bk + 31) // 32
        bits = g.random((Bk, nw * 32)) < 0.05
        bits[:, Bk:] = False
        words = (bits.reshape(Bk, nw, 32).astype(np.uint64)
                 << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
        packed = torch.from_numpy(words.view(np.int32)).to(dev)
        flags = torch.from_numpy(
            (g.random((Bk, 2)) < [0.1, 0.9]).astype(np.int32)).to(dev)
        got = K.commit_chain(packed, flags)
        want = K.commit_chain_plain(packed, flags)
        err = int((got - want).abs().max())
        ms, call = time_cuda(lambda: K.commit_chain(packed, flags))
        pms, _ = time_cuda(lambda: K.commit_chain_plain(packed, flags),
                           reps=2, rounds=3)
        nbytes = 4 * (Bk * nw + 2 * Bk + Bk)
        ops = Bk * (2 * nw + 4)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        say(f"kernel commit_chain B={Bk}: max_abs_err={err} ms={ms:.6f} "
            f"call_ms={call:.6f} plain_ms={pms:.6f} bound_ms={bound:.8f} "
            f"(operations; the real limit is {Bk} dependent steps)")
        note("commit_chain", err, ms, pms, bound, "operations", None,
             line=Bk == B)

    # K2: the ring append at L = 9, C = 1 << 17, on the resolver's own
    # slab layout: the K slabs of a fused group, a view into the hot
    # staging buffer [L, 1 + W + K*B*R] from column 1 + W (not 16-byte
    # aligned, odd row stride).  The mako run fuses groups of
    # RESOLVER_GROUP_MAX = 64 batches, so S = 64*B*R is its shape.
    C, W = 1 << 17, 8192
    buf = torch.from_numpy(g.integers(-2**31, 2**31, size=(L, C),
                                      dtype=np.int64).astype(np.int32)).to(dev)
    out = torch.empty_like(buf)
    out2 = torch.empty_like(buf)
    for Kg in (1, 8, 64):
        S = Kg * B * R
        hot = torch.from_numpy(g.integers(-2**31, 2**31, size=(L, 1 + W + S),
                                          dtype=np.int64).astype(np.int32)
                               ).to(dev)
        slab = hot[:, 1 + W:]
        K.ring_append(buf, slab, out)
        K.ring_append_plain(buf, slab, out2)
        err = int((out.to(torch.int64) - out2.to(torch.int64)).abs().max())
        ms, call = time_cuda(lambda: K.ring_append(buf, slab, out))
        pms, _ = time_cuda(lambda: K.ring_append_plain(buf, slab, out2))
        lib, _ = time_cuda(lambda: torch.cat([buf[:, S:], slab], dim=1))
        bound = 2 * L * C * 4 / HBM_BYTES_PER_S * 1e3
        say(f"kernel ring_append L={L} C={C} S={S} (hot-buffer view, row "
            f"stride {slab.stride(0)}): max_abs_err={err} "
            f"ms={ms:.6f} call_ms={call:.6f} plain_ms={pms:.6f} "
            f"torch.cat_ms={lib:.6f} "
            f"bound_ms={bound:.6f} (bytes)")
        note("ring_append", err, ms, pms, bound, "bytes", lib,
             line=Kg == 64)

    # K3: the history check, both rules x both predicate values, at the
    # 8192-slot window and the full 1 << 17 ring
    for points in (True, False):
        for N in (8192, 1 << 17):
            hb, he = _ranges(g, kc, N, points)
            rb, re = _ranges(g, kc, B * R, points)
            rb = rb.reshape(B, R, L)
            re = re.reshape(B, R, L)
            pad = g.random((B, R)) < 0.5        # sentinel read rows
            rb[pad] = 0xFFFFFFFF
            re[pad] = 0xFFFFFFFF
            hv = np.sort(g.integers(0, 10_000, size=N))
            hv[:N // 16] = -1
            sn = g.integers(0, 10_000, size=B)
            sn[g.random(B) < 0.6] = 9_995       # few newer slots: misses
            sn[g.random(B) < 0.1] = -1
            t = [torch.from_numpy(x).to(dev) for x in (
                map_lanes(rb), map_lanes(re), map_lanes(hb.T.copy()),
                map_lanes(he.T.copy()), hv, sn)]
            newer = int((t[4][None, :] > t[5][:, None]).sum())
            for pv in (1, 0):
                pred = torch.tensor([pv], dtype=torch.int32, device=dev)
                for ex in (1, 0):
                    hit = torch.zeros(B, dtype=torch.int32, device=dev)
                    K.hist_check(*t, WIDTH, points, hit, pred, ex)
                    want = K.hist_check_plain(*t, WIDTH, points) \
                        .to(torch.int32) * int(pv == ex)
                    err = int((hit - want).abs().max())
                    note("hist_check", err, 0, 0, 0, "")
                    if err:
                        say(f"kernel hist_check MISMATCH points={points} "
                            f"N={N} pred={pv} expected={ex}")
            hit = torch.zeros(B, dtype=torch.int32, device=dev)
            on = torch.tensor([1], dtype=torch.int32, device=dev)
            ms, call = time_cuda(
                lambda: K.hist_check(*t, WIDTH, points, hit, on, 1))
            skip_ms, _ = time_cuda(
                lambda: K.hist_check(*t, WIDTH, points, hit, on, 0))
            pms, _ = time_cuda(lambda: K.hist_check_plain(*t, WIDTH, points),
                               reps=2, rounds=3)
            k = 1 if points else 2
            nbytes = 4 * k * (B * R * L + L * N) + 8 * N + 8 * B + 4 * B
            ops = B * N + R * newer
            bound = max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S > ops / INT32_OPS_PER_S \
                else "operations"
            say(f"kernel hist_check points={points} N={N}: hits="
                f"{int(K.hist_check_plain(*t, WIDTH, points).sum())}/{B} "
                f"ms={ms:.6f} call_ms={call:.6f} skipped_ms={skip_ms:.6f} "
                f"plain_ms={pms:.6f} "
                f"bound_ms={bound:.8f} ({by})")
            note("hist_check", 0, ms, pms, bound, by, None,
                 line=points and N == 8192)
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


def run_resolver(knobs, batches, versions, device=None):
    """All batches submitted concurrently to one Resolver; returns
    (replies, seconds, pipeline metrics, final ring state as numpy)."""
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
        await res.close()
        return replies, dt, m, state_to_numpy(res.backend.cs.state)

    return asyncio.run(main())


def range_batches(n: int, seed: int, old_lag: tuple[int, int]):
    """n batches of random ranges over 32-byte-or-shorter keys; ~10% of
    snapshots lag ``old_lag`` batches, the rest 1-5 batches."""
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
                    a = int(g.integers(0, 200_000))
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

    # 7. the kernels line, then the result.  Its launches are those of the
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
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": line}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
