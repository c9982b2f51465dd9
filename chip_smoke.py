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
   and the full side, and on a lone ring; K1 and K3 again at the
   simulator's shapes (B = 16, R = 4, 16-byte keys, a lone ring of
   1 << 12 slots), as phases 23-24 launch them; B8 (the read mirror's prefix
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
   port's plain path on the CPU (replayed while phase 29's device stages
   hold the card);
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
   CPU (replayed as phase 5's are);
9. the wire path at the reference bench.py's configuration (B=64, R=2,
   ring 1<<16, window 1024, dictionary 1<<21; 4096 mako batches in
   groups of 256, 8 in flight; one warm pass, then ``reset_ring(0)``
   and the measured pass): the fused single-upload path, the ids path
   and the lanes path, each with verdicts equal to the C++ set's
   ``resolve_wire``, and txns/s for each and for the C++ set;
10. the in-process commit path end to end: mako clients (100000 keys,
   zipf 0.99, 2 reads + 2 writes a txn, 512 clients, 2 s warm-up then
   4 s measured) through the port's Cluster at the reference's device
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
   history slots split S ways, window 0), its first 8 batches against
   the CPU plain path (verdicts and every partition's ring), 128 timed
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
14. YCSB workload F (bench.ycsb, BASELINE.md config 3): 200000 rows of
   one 100-byte field under 23-byte keys, zipf 0.99 read-modify-write,
   256 clients, 2 s warm-up then 4 s measured, on the ``cuda`` backend at
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
20. two regions on the card (the layout of tests/test_regions.py: 6
   machines in dc1, sat1 and dc2 with simulated disks, primary dc1 with
   a satellite log, remote dc2, 2 logs, replication 1) through
   ``sim.SimulatedCluster(device=...)`` at the device operating point:
   4096 mako keys and a mako round; one log router per remote tag, each
   in dc2, each frontier past its recruitment; dc2's read mirrors
   against their engines; dc1 killed while two writers run; the epoch
   whose TLogs are all in dc2; another mako round; every acknowledged
   write read back from the promoted region (dc2's mirrors serve, every
   prefix_search call equal to the plain version); each resolver
   generation equal to a cpp replay; K3 = K1 > 0; the card's allocated
   memory after each epoch within one ring's bytes;
21. backup and point-in-time restore: phase 12's durable cluster
   (memory engine, a real file system) with mako's 100000 keys;
   ``Database.start_backup``; 64 mako clients for 3 s, every
   acknowledged write kept with its commit version; ``stop_backup``;
   restores into fresh durable clusters on the card, to the end and to
   the middle of the write window: each keyspace equal, byte for byte
   and by ``keyspace_digest``, to the rows expected at its version, and
   read back through its mirror; the restores' fat transactions (decided
   by the exact sidecar) and slim ones counted, their resolves equal to
   a cpp replay;
22. DR between two 4-machine SimulatedClusters sharing the card: a
   DRAgent through a LogRouter over the source's network while 16 mako
   clients write the source; the destination locked during DR, the
   source after the switchover; every source row at the switchover
   version equal on the destination; both clusters' resolver
   generations equal to cpp replays; two live resolvers; then on the
   promoted destination a transactional SecondaryIndex, a
   LayerFeedConsumer with a WatchRegistry and a LayerConsistencyChecker
   over 16 clients: 0 divergences, and the watch fires on its first
   write;
23. the seeded chaos run (sim/run_one.simulate: 7 machines,
   replication 2, the 24-workload chaos mix) at the simulator's own
   resolver shapes (16 txns of 4 ranges, 16-byte keys, a ring of
   1 << 12), every resolver and read mirror on the card: seeds 0 and 17
   with two kills under BUGGIFY, seed 101 with one kill and no BUGGIFY,
   seed 0 on a durable cluster under hostile disks; each run's
   invariants hold, its results equal the same seed's on the CPU (the
   plain versions), seed 0's trace file hashes the same on both and on
   the card twice, K3 = K1 > 0, every prefix_search call equals the
   plain version, and the card's allocated memory after the run is
   within one ring's bytes of before;
24. the spec files (sim/spec.run_spec at seed 0): cycle_restart.toml (a
   durable cluster power-killed and restarted under a bumped protocol,
   the snapshot read back through a new and the multi-version client),
   backup_dr_chaos.toml (backup and DR under attrition; every live
   resolver during DR, the destination cluster's too, a cuda backend on
   the card), region_chaos.toml and engine_migration_chaos.toml; each
   spec's checks pass and its results equal the CPU run's;
25. the operator's deployment (tests/test_monitor.py's layout): the
   port's fdbmonitor over three coordinator servers and one worker-only
   server, each ``device = cuda``, replication 2, in two lifetimes of
   one kill each; the port's fdbcli (``--exec``) writes, reads and shows
   ``resolver_device`` dispatches in ``status json``; the elected
   leader's server SIGKILLed (the monitor paused) and the seconds until
   a commit succeeds again, then restarted; the reference's
   bindings/c/test_c_smoke.c built against the port's header and
   libfdbtpu_c.so prints ``C ABI SMOKE OK``; tests/test_bindings.py's
   operation sequence through the port's Python binding over the C ABI
   equal to the native client's; every acknowledged write read back
   (an attempt of the failover that times out prints the requests it
   was awaiting, by endpoint, role and method and the epoch of the view
   that sent each, and the epoch each coordinator published then); in
   the second lifetime the worker-only server SIGKILLed, restarted by
   the monitor, and the writes read back; the servers hold the card and
   no CLI or C ABI client does (``/proc/<pid>/fd``; nvidia-smi's pids
   are not this machine's there); SIGTERM to each monitor stops every
   server with exit code 0;
26. the seed farm (tools/seed_farm.py) over run_one's chaos mix on the
   card at --jobs 1 (seeds 0-1), 4 (seeds 0-7) and 8 (seeds 0-15), and
   on the CPU at --jobs 2 (seeds 0-15, beside phase 29's device stages):
   every seed's result on the card equal to the CPU's, equal
   failure buckets, K1 = K3 > 0 in each seed's process, seeds per minute
   and each child's peak allocated bytes; the port's trace_tool and
   metrics_tool over phase 23's seed-0 traces from the card and the CPU
   give equal summaries;
27. the perf smoke's resolve stage (tools/perf_smoke.py) with the cuda
   backend on the card: verdicts equal to the numpy twin's, TOO_OLD
   verdicts, K1 = K3 > 0; then the stage again with every K3 and K1 call
   held to its plain version on its own tensors (its window of 64 slots
   and ring of 2048 are shapes phase 3 does not cover); the pipelined
   and unpipelined txns/s beside the reference's 2x floor;
28. a compact summary (each kernel's times, launches, bounds and library
   time, B6's and B9's, each new phase's one-line result), then one JSON
   line with each kernel's launches (the resolver kernels' in phase 6's
   run, prefix_search's in phase 12's, and phases 20-24's and 27's in
   ``launches_by_phase``, with 29's, 30's and 31's), max error, times and
   bound (K1 also its
   latency bound: B chain steps at the step time measured in phase 3;
   B8 its latency bound: one probe's search chain at N = 2**24 measured
   in phase 3; K1 and K3 their times at the simulator's shapes); the
   last line is the result;
29. (started after phase 17; phases 14, 15, 18-25, 32 and 33 run beside its
   host stages) the north star in full as its own process on the card:
   ``python3 -m foundationdb_tpu_torch.bench.north_star`` (the resolver
   at BASELINE config 2, 4096 batches x 64 txns over 1M 32-byte keys,
   cuda against cpp; the commit path end to end; YCSB-F and TPC-C; the
   multi-resolver and the device plane in their own processes; the host
   stages; the abort-parity gate).  Its device stages hold the card
   alone but for phase 31's six short children, with phase 26's CPU
   twin and phases 5 and 8's CPU plain replays beside them on the
   host.  Once
   its host stages (host-bound, one or two cores; the card serves their
   storage servers' reads and the abort-parity gate) are past
   ``read_point`` (one read version held for 5 s of reads against a 5 s
   MVCC window, which a contended host pushes out of it), this process
   runs beside the rest ``--quick`` (one JSON line, exit 0) and
   phases 14, 15, 18-25, 32 and 33, and waits for its end before phase
   26: the seconds of those phases, 14's and 15's rates and the north star's
   host-stage numbers of this run are taken under that contention.
   Gates: exit 0, no stage error or timeout, ``backend_used`` cuda,
   every verdict gate true with 0 mismatches against cpp, 0 dictionary
   fallbacks and 0 abort-parity safety violations, every kernel launched
   (the north star's launches, its subprocesses' included, in
   ``launches_by_phase["29"]``); printed: its value, ``vs_baseline``,
   the cpp baseline and each stage's seconds;
30. (after phase 17, alone, before phase 29 starts, in a process of
   its own) the perf smoke's stages whose paths launch a kernel
   (tools/perf_smoke.py) through
   their ``check_*`` at the reference's sizes, gates, budgets and
   floors on the card: ``read`` (its lsm half's storage servers' read
   mirrors must serve batches, B8), ``mesh`` (two resolvers on the live
   commit path, the cuda backend; hot group mean >= 1.5, K1 = K3 > 0),
   ``devplane`` (the sharded mirror's served-batch floor and the bitmask
   readback floor, verdicts equal, aborts), and ``recover``,
   ``observe``, ``scrub`` and ``layers`` (their resolvers on the cuda
   backend, K1 = K3 > 0); every B8, K3 and K1 call recorded during the
   stage (the mesh's routed side in one rerun, its ratio being a
   wall-clock gate), each held to its plain version at tolerance 0;
   the launches in ``launches_by_phase["30"]``;
31. (after phases 5 and 8's CPU plain replays, beside phase 29's
   device stages, while this process waits for its ``read_point``) the
   simulator's device modes: tests/
   test_sim_determinism.py's child (a seeded 5-machine simulated
   cluster with the device pipeline on), its imports re-rooted at the
   port, in its ``default``, ``mesh_on`` (two resolvers, routed) and
   ``devplane`` (verdict bitmask off, K2's in-place ring on, a 4-shard
   read mirror) modes, each once on the card and once on the CPU, each
   in a fresh process, all six at once: each mode's two traces hash to
   the digest tests/test_torch_sim_determinism.py holds the port's
   CPU run to (``SIM_DIGESTS``), every K1, K3, K2 and B8 call equals
   its plain version (tolerance 0) with one record for each launch,
   K1 = K3 > 0, and the devplane mode launches K2; the launches in
   ``launches_by_phase["31"]``;
32. (after phase 25, beside the north star) a fresh deployment as phase
   25 builds it, the elected leader's server SIGSTOPped (the monitor
   paused), a process that keeps its sockets open and answers nothing
   (ROADMAP C4): each attempt of a commit printed as phase 25 prints
   them, the first must commit; then SIGCONT and SIGKILL, the monitor
   restarts the server, every acknowledged write reads back, no
   connection to a live server was cut for silence, and SIGTERM stops
   every server with exit code 0;
33. (in a process of its own, started before phase 23 and collected
   after phase 32, so that it runs beside them; the smoke's time limit
   left no room for it in sequence) a fresh deployment as phase 25
   builds it, the monitor left running, and the three coordinators'
   servers SIGKILLed in turn, each restarted at once, empty (ROADMAP
   C6): each attempt of a long-lived client's commit after each kill
   printed, the first must commit; then a fresh CLI reads back every
   acknowledged write; the server logs found one database; SIGTERM
   stops every server with exit code 0.  A shard whose replicas were on
   two servers killed in turn has none left (ROADMAP C2): a first
   attempt or a read-back that waits on it passes only where the server
   logs show it (``rolling_errors``).

Each phase's closing line goes to stderr too, after the seconds since
the start; a wait on a child process (the north star, the farm, phase
30's process) gives up and fails 30 s before the smoke's 1200 s limit.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import gc
import json
import os
import re
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
# phases 10, 11, 14 and 15 run at a smaller depth, so that the smoke
# with the north star (phase 29, which runs their paths in full) stays
# inside its time limit: 4 s measured for 8 (10, 14, 15), 128 scaling
# batches for 512 and 8 checked for 32 (11), 200000 YCSB rows for
# 1000000 (14)
SCALING_BATCHES = 128
DURABLE_KEYS = 100_000
B, R, WIDTH = 64, 8, 32
E2E_CLIENTS, E2E_WARMUP_S, E2E_SECONDS = 512, 2.0, 4.0
# BASELINE.md configs 3 and 4 at the reference bench.py's device client
# counts (its _TPU_CLIENTS)
YCSB_ROWS, YCSB_FIELD, YCSB_CLIENTS = 200_000, 100, 256
TPCC_CLIENTS = 128
# phase 18: more keys than a memory engine holds pending before its key
# index takes a base run (1024), so the read mirror serves
CLUSTER_KEYS = 4096
# phases 23-24: the simulator's own resolver shapes (sim/cluster_sim.py:
# 16 txns of 4 ranges, 16-byte keys, a ring of 1 << 12 slots, which
# leaves no room for a window); the chaos runs (seed, kills, BUGGIFY,
# fault profile): the reference test's passing seeds, a run without
# BUGGIFY, and a durable cluster under hostile disks; the spec files
SIM_B, SIM_R, SIM_WIDTH, SIM_RING = 16, 4, 16, 1 << 12
CHAOS_RUNS = [(0, 2, True, None), (17, 2, True, None),
              (101, 1, False, None), (0, 2, True, "disk")]
SPECS = ["cycle_restart.toml", "backup_dr_chaos.toml", "region_chaos.toml",
         "engine_migration_chaos.toml"]
# phase 31: three modes of tests/test_sim_determinism.py's child (a
# seeded 5-machine simulated cluster), its imports re-rooted at the port,
# and the SHA-256 of each mode's trace on the port, which
# tests/test_torch_sim_determinism.py holds the port's CPU run to
SIM_CHILD = os.path.join("tests", "test_sim_determinism.py")
SIM_MODES = ("default", "mesh_on", "devplane")
SIM_DIGESTS = {
    "default":
        "bbe9c3d06c371618a133e728633511b06bb5151c9c5ab94d436f193668e303be",
    "mesh_on":
        "c4df7ec1e1179123fa6bdf6768ed77e9d8c141c753256a279509a5c8d69e434f",
    "devplane":
        "bbe9c3d06c371618a133e728633511b06bb5151c9c5ab94d436f193668e303be",
}
CARD = ""          # nvidia-smi's name and power limit, set by main
# the compact per-kernel and per-phase summary printed before the kernels
# line, so that it stays in the tail of a long output
SUMMARY: list[str] = []


_LAP = [0.0]
# the run's start, and the time past which a wait on a child process
# (the north star, the seed farm) gives up and fails: 30 s before the
# smoke's 1200 s limit, so that a run that cannot end in time says where
# it stood instead of being stopped
_START = [0.0]
DEADLINE_S = 1170.0


def phase_done(line: str) -> None:
    """Print a phase's closing line; on stderr too, after the seconds
    since the start, so that the end of stderr shows how far a run got."""
    say(line)
    print(f"[{time.perf_counter() - _START[0]:.1f} s] {line}",
          file=sys.stderr, flush=True)


def left(cap: float) -> float:
    """Seconds a wait may take: ``cap``, or less, to the deadline."""
    return max(1.0, min(cap, _START[0] + DEADLINE_S - time.perf_counter()))


def lap(phases: str) -> None:
    """Print the seconds since the last lap: phases 1-17's times."""
    now = time.perf_counter()
    phase_done(f"phase {phases}: {now - _LAP[0]:.1f} s ({CARD})")
    _LAP[0] = now


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
            alphabet: int = 3, width: int = WIDTH):
    """n encoded ranges [n, L] (begin, end), u32, of random keys (some
    longer than ``width``, so the truncation rules are exercised):
    points, or intervals of which a share ``wide`` spans between two
    random keys and the rest are narrow [k, k+"\\x01")."""
    a = _rand_keys(g, n, width + 8, alphabet)
    if points:
        b = [k + b"\x00" for k in a]
    else:
        c = _rand_keys(g, n, width + 8, alphabet)
        wide = g.random(n) < wide
        b = [max(x, y) + b"\x00" if w else x + b"\x01"
             for x, y, w in zip(a, c, wide)]
        a = [min(x, y) if w else x for x, y, w in zip(a, c, wide)]
    return kc.encode_keys(a, width), kc.encode_keys(b, width)


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
                     bound_by=bound_by, library_ms=lib_ms)
        r.update(extra)

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
    sim_shapes_kernels(dev, note, bound)
    torch.cuda.synchronize()
    prefix_search_phase(dev, note)


def sim_shapes_kernels(dev, note, bound) -> None:
    """K1 and K3 at the simulator's resolver shapes, as phases 23 and 24
    launch them (sim/cluster_sim.py: 16 txns of 4 ranges, 16-byte keys so
    L = 5 lanes, a ring of 1 << 12 slots and so no window; every batch
    takes resolve_core's single-batch path): K1 writing its slab into
    fresh [L, B*R] planes and, for a padding batch, with no slab; K3 over
    the one ring segment.  Both rules, tolerance 0, with times and
    bounds beside the operating point's."""
    import torch

    from foundationdb_tpu_torch.ops import keycode as kc
    from foundationdb_tpu_torch.ops import kernels as K
    from foundationdb_tpu_torch.ops.conflict_torch import map_lanes

    g = np.random.default_rng(1616)
    Bs, Rs, Ws, C = SIM_B, SIM_R, SIM_WIDTH, SIM_RING
    L = kc.nlanes(Ws)

    def rows(points, wide=0.1, alphabet=3):
        rb_, re_ = _ranges(g, kc, Bs * Rs, points, wide, alphabet, Ws)
        rb_, re_ = rb_.reshape(Bs, Rs, L), re_.reshape(Bs, Rs, L)
        pad = g.random((Bs, Rs)) < 0.5
        rb_[pad] = 0xFFFFFFFF
        re_[pad] = 0xFFFFFFFF
        return [torch.from_numpy(map_lanes(x)).to(dev) for x in (rb_, re_)]

    def snaps(lo, hi):
        kind = g.random(Bs)
        s = np.where(kind < 0.1, -1, g.integers(lo, hi, size=Bs))
        return torch.from_numpy(s.astype(np.int64)).to(dev)

    floor = torch.tensor([100], dtype=torch.int64, device=dev)
    for points in (True, False):
        # K1
        rb, re = rows(points)
        wb, we = rows(points)
        hit = torch.from_numpy((g.random(Bs) < 0.1).astype(np.int32)).to(dev)
        snap = snaps(50, 200)
        args = (rb, re, wb, we, hit, snap, floor, Ws, points)
        verd = torch.empty(Bs, dtype=torch.int8, device=dev)
        comm = torch.empty(Bs, dtype=torch.bool, device=dev)
        sb = torch.full((L, Bs * Rs), 7, dtype=torch.int32, device=dev)
        se = torch.full_like(sb, 7)
        v, c, pb, pe = K.commit_chain_plain(*args)
        K.commit_chain(*args, verd, comm, slab=(sb, se, None))
        err = max(int((verd.long() - v.long()).abs().max()),
                  int((comm.long() - c.long()).abs().max()),
                  int((sb.long() - pb.long()).abs().max()),
                  int((se.long() - pe.long()).abs().max()))
        verd.fill_(9)
        K.commit_chain(*args, verd, comm)           # a padding batch
        err = max(err, int((verd.long() - v.long()).abs().max()))
        ms, call = time_cuda(lambda: K.commit_chain(
            *args, verd, comm, slab=(sb, se, None)))
        pms, _ = time_cuda(lambda: K.commit_chain_plain(*args), reps=2,
                           rounds=3)
        k = 2 if points else 3
        nbytes = 4 * k * Bs * Rs * L + 12 * Bs + 2 * Bs + 2 * 4 * L * Bs * Rs
        ops = k1_ops(rb, re, wb, we, hit, snap, floor, points)
        bms, by = bound(nbytes, ops)
        say(f"kernel commit_chain sim shapes B={Bs} R={Rs} L={L} "
            f"points={points}: max_abs_err={err} verdicts(committed, "
            f"conflict, too_old)={torch.bincount(v.long(), minlength=3).tolist()}"
            f" ms={ms:.6f} call_ms={call:.6f} plain_ms={pms:.6f} "
            f"bound_ms={bms:.8f} ({by}; {nbytes} bytes, {ops} lane compares)")
        note("commit_chain", err)
        if points:
            note("commit_chain", err, sim_shapes=dict(
                ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by))
        # K3: the ring of C slots (versions rising through [0, 10000), the
        # oldest sixteenth never written), the reads' snapshots across it
        hb, he = _ranges(g, kc, C, points, 0.0, 6, Ws)
        hv = np.sort(g.integers(0, 10_000, size=C))
        hv[:C // 16] = -1
        ring = (torch.from_numpy(map_lanes(hb.T.copy())).to(dev),
                torch.from_numpy(map_lanes(he.T.copy())).to(dev),
                torch.from_numpy(hv).to(dev))
        rb, re = rows(points, 0.01, 6)
        sn = snaps(0, 10_000)
        hit = torch.zeros(Bs, dtype=torch.int32, device=dev)
        K.hist_check(rb, re, sn, Ws, points, hit, [ring])
        want = K.hist_check_plain(rb, re, *ring, sn, Ws, points)
        err = int((hit - want.to(torch.int32)).abs().max())
        ms, call = time_cuda(
            lambda: K.hist_check(rb, re, sn, Ws, points, hit, [ring]))
        pms, _ = time_cuda(lambda: K.hist_check_plain(
            rb, re, *ring, sn, Ws, points), reps=2, rounds=3)
        k = 1 if points else 2
        newer = (ring[2][None, :] > sn[:, None]).sum(1)
        ops = int((_live(rb, points).sum(1) * newer).sum())
        nbytes = C * (8 + 4 * k * L) + 4 * k * Bs * Rs * L + 12 * Bs
        bms, by = bound(nbytes, ops)
        say(f"kernel hist_check sim shapes B={Bs} R={Rs} L={L} ring={C} "
            f"points={points}: max_abs_err={err} hits={int(want.sum())}/{Bs}"
            f" ms={ms:.6f} call_ms={call:.6f} plain_ms={pms:.6f} "
            f"bound_ms={bms:.8f} ({by}; {nbytes} bytes, {ops} lane compares)")
        note("hist_check", err)
        if points:
            note("hist_check", err, sim_shapes=dict(
                ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by))


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


# phases 5 and 8's replays on the port's plain path on the CPU, run while
# the north star's device stages hold the card (phase 29): each the
# batches' arguments, so that they are made anew there, and the card's
# verdicts, ring state and dictionary
PLAIN_REPLAYS: list[dict] = []
PLAIN_THREADS = 3       # torch CPU threads, beside the north star's


def defer_plain(label: str, knobs, args: tuple, kw: dict, verdicts: list,
                state, dictionary=None) -> None:
    PLAIN_REPLAYS.append(dict(label=label, knobs=knobs, args=args, kw=kw,
                              verdicts=bytes(verdicts), state=state,
                              dict=dictionary))


def plain_replays() -> None:
    """Each deferred run again on the CPU plain path: verdicts, ring
    state and dictionary bit-identical to the card's."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(PLAIN_THREADS)
    try:
        for p in PLAIN_REPLAYS:
            rb, rv = range_batches(*p["args"], **p["kw"])
            rep, dt, m, st = run_resolver(
                p["knobs"], rb, rv, device=torch.device("cpu"),
                want_dict=p["dict"] is not None)
            eq = {"verdicts": bytes(flat(rep)) == p["verdicts"],
                  "ring": same_state(st, p["state"])}
            if p["dict"] is not None:
                eq["dictionary"] = np.array_equal(m["dict"], p["dict"])
            say(f"{p['label']}: cpu plain {dt:.3f} s ({PLAIN_THREADS} "
                f"threads, beside the north star's device stages); equal "
                f"to the card's {eq}")
            if not all(eq.values()):
                fail(f"{p['label']}: the card's verdicts, ring or dictionary "
                     f"differ from the CPU plain path: {eq}")
    finally:
        torch.set_num_threads(threads)
    PLAIN_REPLAYS.clear()


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
                         check_batches: int = 8,
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
        SUMMARY.append(
            f"B9 S={S} (B={Bb}, R={Rb}, L={Lb}): ms "
            + (f"{ms:.6f} ({len(kern) / reps:.1f} torch kernels a call)"
               if kern else "not measured")
            + f", call_ms {span:.6f}, launches one mask + one max a step "
            f"({batches} steps a run), bound_ms "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.8f} (bytes), plain_ms = ms "
            f"(torch ops), library_ms null")
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
# mako clients, read-backs and device accounting for phases 18-22


def mako_key(i: int) -> bytes:
    """The mako keys of phases 18-22: 32 bytes."""
    return b"mako" + str(int(i)).zfill(28).encode()


class Mako:
    """Mako clients over one database: each transaction reads two zipf
    keys and writes two.  Every acknowledged write is kept in
    ``history`` as (commit version, versionstamp, key, value) and the
    newest per key in ``acked`` (transactions of one commit batch share
    a version; the versionstamp orders them as the batch applied them);
    a write whose outcome is unknown (commit_unknown_result,
    or a transaction cut by its timeout) leaves its value in ``maybe``;
    aborts are counted by code in ``codes``."""

    def __init__(self, db, n_keys: int, seed: int = 7):
        from foundationdb_tpu_torch.bench.workload import ZipfianGenerator
        self.db, self.n_keys = db, n_keys
        self.zipf = ZipfianGenerator(n_keys, 0.99, seed)
        self.acked: dict[bytes, tuple[bytes, bytes]] = {}
        self.maybe: dict[bytes, set] = {}
        self.codes: dict = {}
        self.history: list[tuple[int, bytes, bytes, bytes]] = []

    def _ack(self, tr, writes: dict) -> None:
        version, stamp = tr.get_committed_version(), tr.get_versionstamp()
        for k, val in writes.items():
            self.history.append((version, stamp, k, val))
            if stamp > self.acked.get(k, (b"", b""))[0]:
                self.acked[k] = (stamp, val)

    def _failed(self, code, writes: dict) -> None:
        self.codes[code] = self.codes.get(code, 0) + 1
        if code in (1021, "timeout"):       # the write may have landed
            for k, v in writes.items():
                self.maybe.setdefault(k, set()).add(v)

    async def _run(self, writes: dict, reads=()) -> bool:
        """One attempt: ``reads``, then ``writes``, committed; True if
        acknowledged."""
        from foundationdb_tpu_torch.runtime.errors import FdbError
        tr = self.db.create_transaction()
        try:
            for k in reads:
                await tr.get(k)
            for k, v in writes.items():
                tr.set(k, v)
            await tr.commit()
            self._ack(tr, writes)
            return True
        except FdbError as e:
            self._failed(e.code, writes)
            try:
                await tr.on_error(e)        # backoff; a new view after a
            except FdbError:                # recovery
                pass
            return False

    async def load(self, loaders: int = 1) -> None:
        """Every key at ``load-<i>``, 256 a transaction, each retried
        until it is acknowledged, from ``loaders`` concurrent loaders."""
        starts = list(range(0, self.n_keys, 256))

        async def loader(w):
            for c in starts[w::loaders]:
                writes = {mako_key(i): b"load-%d" % i for i in
                          range(c, min(c + 256, self.n_keys))}
                while not await self._run(writes):
                    pass
        await asyncio.gather(*(loader(w) for w in range(loaders)))

    async def client(self, tag: bytes, cid: int, txns: int | None = None,
                     until=None, timeout: float | None = None) -> None:
        """``txns`` transactions, or until ``until()`` is true; with
        ``timeout``, each is cut after that many seconds."""
        i = 0
        while (i < txns) if txns is not None else not until():
            ks = [mako_key(x) for x in self.zipf.sample(4)]
            val = b"%s:%d-%d" % (tag, cid, i)
            i += 1
            writes = {ks[2]: val, ks[3]: val}
            if timeout is None:
                await self._run(writes, ks[:2])
                continue
            try:
                await asyncio.wait_for(self._run(writes, ks[:2]), timeout)
            except asyncio.TimeoutError:
                self._failed("timeout", writes)

    async def round(self, tag: bytes, clients: int, txns: int) -> None:
        await asyncio.gather(*(self.client(tag, c, txns)
                               for c in range(clients)))

    def expected(self, keys, at: int | None = None) -> dict:
        """Each key's value at version ``at`` (the newest with None):
        its load value, or the newest acknowledged write at or below."""
        want = {k: b"load-%d" % i for i, k in enumerate(keys)}
        newest: dict[bytes, bytes] = {}
        for v, stamp, k, val in self.history:
            if (at is None or v <= at) and stamp > newest.get(k, b""):
                newest[k], want[k] = stamp, val
        return want


async def read_multi(db, keys: list, want: dict,
                     maybe: dict | None = None) -> int:
    """Every key read in ``get_multi`` batches of 512 through
    ``db`` (a RefreshingDatabase, refreshed on an error, or a cluster):
    the number of values that are neither ``want``'s nor one of the
    key's ``maybe`` values (writes whose outcome was unknown)."""
    maybe = maybe or {}
    from foundationdb_tpu_torch.client.transaction import Transaction
    from foundationdb_tpu_torch.runtime.errors import FdbError
    bad = 0
    for c in range(0, len(keys), 512):
        while True:
            try:
                got = await Transaction(getattr(db, "view", db)).get_multi(
                    keys[c:c + 512])
                break
            except FdbError:
                if hasattr(db, "refresh"):
                    await db.refresh()
                await asyncio.sleep(0.1)
        bad += sum(1 for k, g in zip(keys[c:c + 512], got)
                   if g != want.get(k) and g not in maybe.get(k, ()))
    return bad


async def read_pages(db, begin: bytes, end: bytes) -> list:
    """Every row of [begin, end), 10000 rows a transaction, each at its
    own read version (for a database no one writes, so no read falls
    outside the MVCC window)."""
    rows: list = []
    while True:
        got = await db.run(lambda tr, b=begin: tr.get_range(b, end,
                                                            limit=10_000))
        rows += [(bytes(k), bytes(v)) for k, v in got]
        if len(got) < 10_000:
            return rows
        begin = bytes(got[-1][0]) + b"\x00"


def launches(since: dict | None = None) -> dict:
    """Each kernel's launch count, less ``since``'s."""
    from foundationdb_tpu_torch.ops import kernels as K
    return {k: v.launches - (since or {}).get(k, 0)
            for k, v in K.KERNELS.items()}


def device_allocated(dev) -> int:
    """Bytes the caching allocator holds for live tensors on ``dev``,
    after a collection (0 off the card)."""
    import torch
    if dev.type != "cuda":
        return 0
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def ring_bytes(resolver) -> int:
    import torch
    return sum(t.numel() * t.element_size()
               for t in resolver.backend.cs.state if torch.is_tensor(t))


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
    from foundationdb_tpu_torch.core.cluster_client import (
        RefreshingDatabase, open_cluster)
    from foundationdb_tpu_torch.rpc.transport import NetworkAddress
    from foundationdb_tpu_torch.runtime.errors import FdbError
    from foundationdb_tpu_torch.runtime.simloop import run_simulation

    knobs = cluster_knobs("cuda")
    keys = [mako_key(i) for i in range(n_keys)]
    out: dict = {"epochs": [], "memory": [], "reads": []}

    async def main():
        sim = SimCluster(knobs, dev)
        cc = sim.make_cc()
        cc_task = asyncio.get_running_loop().create_task(cc.run())
        state = await sim.wait_epoch(1)
        out["epochs"].append((1, state["recovery_version"]))
        ct = sim.client_transport()
        stubs = sim.coordinator_stubs(ct)
        db = RefreshingDatabase(await open_cluster(knobs, ct, stubs), stubs)
        mk = Mako(db, n_keys)
        await mk.load()

        async def read_back() -> tuple[int, int]:
            await asyncio.sleep(2.0)        # out of the MVCC window
            return n_keys, await read_multi(db, keys, mk.expected(keys),
                                            mk.maybe)

        await mk.round(b"0", clients, txns)
        out["reads"].append(await read_back())
        out["memory"].append(device_allocated(dev))
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
            await mk.round(b"%d" % n, clients, txns)
            out["memory"].append(device_allocated(dev))
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
        out["ring_bytes"] = ring_bytes(resolvers[0])
        out["mirrors"] = [ss._device_reads.metrics()
                          for ss in sim.roles("storage")
                          if ss._device_reads is not None]
        out["acked"], out["unknown"] = len(mk.acked), len(mk.maybe)
        out["codes"] = mk.codes
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


# --------------------------------------------------------------------------
# phases 20-22: the consumers of the commit stream on the card


def sim_cluster(dev, knobs, **kw):
    """The port's SimulatedCluster with every role on ``dev``, at
    ``knobs``' resolver shapes (the device operating point: B = 64,
    R = 8, a ring of 1 << 17).  Its constructor overrides the resolver's
    shapes with the simulator's (16 txns of 4 ranges, a ring of
    1 << 12); each machine's host reads ``sim.knobs`` when it starts, so
    ``knobs`` go back after construction and before ``start()``."""
    from foundationdb_tpu_torch.sim import SimulatedCluster
    sim = SimulatedCluster(knobs, device=dev, **kw)
    sim.knobs = knobs
    return sim


def live_roles(sim, name: str) -> list:
    """(machine index, role object) for every ``name`` role a live
    machine of ``sim`` hosts."""
    return [(m.index, obj) for m in sim.machines
            if m.alive and m.host is not None
            for role, obj in m.host.worker.roles.values() if role == name]


# the two-region layout of the reference's region tests
# (tests/test_regions.py:23-31): the first three machines, the
# coordinators, span all three datacenters
DCIDS = ["dc1", "sat1", "dc2", "dc1", "dc2", "dc2"]
REGIONS = [{"id": "dc1", "priority": 1, "satellite": "sat1",
            "satellite_logs": 1},
           {"id": "dc2", "priority": 0}]


def regions_phase(dev, n_keys: int = CLUSTER_KEYS, clients: int = 16,
                  txns: int = 40) -> dict:
    """Phase 20 under the port's run_simulation, every role on ``dev``:
    the two-region cluster (primary dc1 with a satellite log in sat1,
    remote dc2; 2 logs, replication 1), each machine with a simulated
    disk so every storage server's read mirror arms; ``n_keys`` mako
    keys and a mako round; the log routers; dc2's mirrors against their
    engines; dc1 killed while two writers run; the epoch whose TLogs are
    all in dc2; another mako round; every acknowledged write read back
    from the promoted region in get_multi batches of 512."""
    from foundationdb_tpu_torch.core.cluster_controller import \
        ClusterConfigSpec
    from foundationdb_tpu_torch.runtime.simloop import run_simulation

    out: dict = {"memory": []}

    def dc_of(addr) -> str:
        return DCIDS[int(addr[0].split(".")[-1]) - 1]

    def mirrors(sim) -> dict:
        by_dc: dict = {}
        for i, ss in live_roles(sim, "storage"):
            if ss._device_reads is not None:
                by_dc.setdefault(DCIDS[i], []).append(
                    ss._device_reads.metrics())
        return by_dc

    async def main():
        sim = sim_cluster(dev, cluster_knobs("cuda"), n_machines=6,
                          dcids=DCIDS,
                          durable_storage=True,
                          spec=ClusterConfigSpec(
                              min_workers=6, logs=2, replication=1,
                              regions=[dict(r) for r in REGIONS]))
        await sim.start()
        state = await sim.wait_epoch(1)
        gen = state["log_cfg"][-1]
        out["epoch1"] = {
            "tlogs": [dc_of(a) for a in gen["tlogs"]],
            "satellites": [dc_of(a) for a in gen["satellites"]],
            "routers": sorted((r[0], dc_of(r[1:3])) for r in
                              gen.get("routers", [])),
            "remote_tags": sorted(s["tag"] for s in state["storage"]
                                  if s["dcid"] == "dc2")}
        db = await sim.database()
        mk = Mako(db, n_keys)
        await mk.load()
        await mk.round(b"r0", clients, txns)
        await asyncio.sleep(2.0)            # out of the MVCC window
        keys = [mako_key(i) for i in range(n_keys)]
        out["reads"] = [(n_keys, await read_multi(db, keys,
                                                  mk.expected(keys),
                                                  mk.maybe))]
        out["memory"].append(device_allocated(dev))
        out["routers"] = [(DCIDS[i], r.tag, r.metrics())
                          for i, r in live_roles(sim, "log_router")]
        # dc2's mirrors before the promotion, each against its engine
        remote = [ss for i, ss in live_roles(sim, "storage")
                  if DCIDS[i] == "dc2" and ss._device_reads is not None]
        served = differ = 0
        for ss in remote:
            for c in range(0, n_keys, 512):
                got = ss._device_reads.get_batch(keys[c:c + 512])
                if got is not None:
                    served += 1
                    differ += sum(1 for a, b in zip(
                        got, ss.engine.get_batch(keys[c:c + 512])) if a != b)
        out["remote_before"] = (len(remote), served, differ)
        out["mirrors_before"] = mirrors(sim)

        stop = asyncio.Event()
        writers = [asyncio.ensure_future(mk.client(
            b"w", w, until=stop.is_set, timeout=30.0)) for w in range(2)]
        await asyncio.sleep(2.0)
        pre_kill = len(mk.history)
        await sim.kill_dc("dc1")
        state2 = await sim.wait_state(
            lambda s: s["epoch"] > state["epoch"]
            and all(dc_of(a) == "dc2" for a in s["log_cfg"][-1]["tlogs"]))
        await db.refresh()
        # writes land after the failover: the new epoch is published
        # before it accepts commits (its storage rejoins first), so the
        # writers run 2 s and then until one of theirs commits, at most
        # 60 s more (virtual)
        promoted = len(mk.history)
        await asyncio.sleep(2.0)
        for _ in range(240):
            if len(mk.history) > promoted:
                break
            await asyncio.sleep(0.25)
        stop.set()
        await asyncio.gather(*writers)
        out["writes"] = (pre_kill, len(mk.history))
        await mk.round(b"r2", clients, txns)
        out["memory"].append(device_allocated(dev))
        out["epoch2"] = {"epoch": state2["epoch"],
                         "tlogs": [dc_of(a) for a in
                                   state2["log_cfg"][-1]["tlogs"]],
                         "primary_dc": state2.get("primary_dc")}
        await asyncio.sleep(2.0)
        db2 = await sim.database()
        out["reads"].append((n_keys, await read_multi(
            db2, keys, mk.expected(keys), mk.maybe)))
        out["mirrors_after"] = mirrors(sim)
        resolvers = live_roles(sim, "resolver")
        out["resolvers"] = [(DCIDS[i], ring_bytes(r)) for i, r in resolvers]
        out["acked"], out["unknown"] = len(mk.acked), len(mk.maybe)
        out["codes"] = mk.codes
        await sim.stop()

    record: list = []
    stopped: set = set()
    calls, restore = held_to_plain()
    t0 = time.perf_counter()
    try:
        with generations(record, stopped):
            run_simulation(main(), seed=20)
    finally:
        restore()
    out["seconds"] = time.perf_counter() - t0
    out["record"], out["stopped"] = record, stopped
    out["prefix_calls"] = calls
    return out


def check_regions_phase(r: dict, got: dict, on_card: bool) -> int:
    """Phase 20's checks (the launch counts and memory only on the
    card); returns prefix_search's largest error against its plain
    version."""
    err, lens = plain_err(r["prefix_calls"])
    n_cmp, mism = replay_generations(r["record"])
    gens = sorted({x[0] for x in r["record"]})
    late = sum(1 for x in r["record"] if x[4])
    e1, e2 = r["epoch1"], r["epoch2"]
    served_after = sum(m["device_read_batches"]
                       for m in r["mirrors_after"].get("dc2", []))
    say(f"regions: epoch 1 TLogs in {e1['tlogs']}, satellites in "
        f"{e1['satellites']}, log routers (tag, dc) {e1['routers']} for the "
        f"remote tags {e1['remote_tags']}; router frontiers "
        f"{[(dc, t, m['end'], max(m['pops'].values())) for dc, t, m in r['routers']]}"
        f"; dc1 killed with {r['writes'][0]} writes acknowledged, "
        f"{r['writes'][1]} after the failover; epoch {e2['epoch']} TLogs in "
        f"{e2['tlogs']} (primary {e2['primary_dc']}) in {r['seconds']:.3f} s")
    say(f"regions: acknowledged keys {r['acked']}, unknown results "
        f"{r['unknown']}, aborts by code {r['codes']}; read-backs (keys, "
        f"mismatches) {r['reads']}; dc2's mirrors before the promotion "
        f"(servers, batches served, differences from the engine) "
        f"{r['remote_before']}; {len(r['record'])} resolves over "
        f"{len(gens)} resolver generations ({len(r['stopped'])} stopped), "
        f"replayed through a fresh cpp Resolver each: {n_cmp} verdicts, "
        f"mismatches={mism}; replies after their role stopped {late}; "
        f"launches={got}")
    say(f"regions: {len(r['prefix_calls'])} prefix_search calls on mirrors "
        f"of {lens} prefixes against the plain version: max_abs_err={err}; "
        f"mirrors before {json.dumps(r['mirrors_before'])}; after "
        f"{json.dumps(r['mirrors_after'])}")
    say(f"regions device memory: {r['memory']} bytes allocated after epochs "
        f"1 and 2; live resolvers (dc, ring bytes) {r['resolvers']}")
    if e1["tlogs"] != ["dc1"] * len(e1["tlogs"]) or \
            e1["satellites"] != ["sat1"] * len(e1["satellites"]) or \
            not e1["satellites"] or \
            [t for t, _ in e1["routers"]] != e1["remote_tags"] or \
            any(dc != "dc2" for _, dc in e1["routers"]) or \
            not e1["remote_tags"]:
        fail("the two-region recovery did not recruit its TLogs in dc1, a "
             "satellite in sat1 and one log router in dc2 per remote tag")
    if len(r["routers"]) != len(e1["remote_tags"]) or any(
            m["end"] <= 1 or max(m["pops"].values()) <= 1
            for _, _, m in r["routers"]):
        fail("a log router's frontier did not move past its recruitment")
    if e2["tlogs"] != ["dc2"] * len(e2["tlogs"]) or r["writes"][1] <= \
            r["writes"][0]:
        fail("the failover did not promote dc2, or nothing committed "
             "after it")
    if mism or n_cmp == 0 or len(gens) < 2 or late:
        fail("a resolver generation's verdicts differ from the cpp replay, "
             "fewer than two generations resolved, or a resolver answered "
             "after its role stopped")
    if err or any(bad for _, bad in r["reads"]) or r["remote_before"][2]:
        fail("prefix_search differs from its plain version, a remote "
             "mirror from its engine, or an acknowledged write did not "
             "read back")
    if on_card:
        if got["hist_check"] != got["commit_chain"] or \
                got["commit_chain"] == 0 or got["prefix_search"] == 0 \
                or len(r["prefix_calls"]) != got["prefix_search"]:
            fail(f"the two-region cluster launched {got}")
        if r["remote_before"][1] == 0 or served_after == 0:
            fail("dc2's read mirrors served nothing before or after the "
                 f"promotion: {r['remote_before']}, {r['mirrors_after']}")
        if max(r["memory"]) - min(r["memory"]) > \
                max(b for _, b in r["resolvers"]):
            fail(f"device memory grew across the failover: {r['memory']}")
    return err


# phase 12's durable cluster, with the backup's mako traffic
BACKUP_CLIENTS, BACKUP_SECONDS = 64, 3.0


def backup_phase(dev, n_keys: int = DURABLE_KEYS,
                 clients: int = BACKUP_CLIENTS,
                 seconds: float = BACKUP_SECONDS,
                 root: str | None = None) -> dict:
    """Phase 21: phase 12's durable in-process cluster (memory engine, a
    real file system, every role on ``dev``) loaded with mako's
    ``n_keys`` keys; ``Database.start_backup`` into a container on the
    same file system; ``clients`` mako clients for ``seconds`` with
    every acknowledged write kept with its commit version;
    ``stop_backup``; then two restores, each into a fresh durable
    cluster on ``dev``: to the end, and to a version in the middle of
    the write window.  Each restored keyspace is read whole and by
    get_multi batches of 512 (the restored cluster's mirror serves).
    Every resolve of the restores is recorded for a cpp replay."""
    from foundationdb_tpu_torch.backup.container import keyspace_digest
    from foundationdb_tpu_torch.client.database import Database
    from foundationdb_tpu_torch.core.cluster import Cluster, ClusterConfig
    from foundationdb_tpu_torch.runtime.files import RealFileSystem

    from foundationdb_tpu_torch.runtime.knobs import Knobs

    # the restored clusters keep phase 12's 0.1 s MVCC window, so their
    # rows reach the engine (and its mirror) 2 s after the restore; the
    # source keeps the default 5 s, since the backup's snapshot reads
    # the whole keyspace at one version
    knobs = _durable_knobs("memory")
    src_knobs = knobs.override(
        STORAGE_VERSION_WINDOW=Knobs().STORAGE_VERSION_WINDOW)
    keys = [mako_key(i) for i in range(n_keys)]
    out: dict = {"restores": {}, "n_keys": n_keys, "clients": clients,
                 "seconds": seconds}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        fs = RealFileSystem(tmp)

        async def source():
            cluster = await Cluster.create(ClusterConfig(), src_knobs,
                                           fs=fs, data_dir="src", device=dev)
            cluster.start()
            db = Database(cluster)
            mk = Mako(db, n_keys)
            t0 = time.perf_counter()
            await mk.load(loaders=32)
            out["load_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            agent = await db.start_backup(fs, "backup")
            out["snapshot_s"] = time.perf_counter() - t0
            out["snapshot_version"] = agent.last_snapshot_version
            first = len(mk.history)
            end = time.perf_counter() + seconds
            await asyncio.gather(*(mk.client(b"b", c, until=lambda:
                                             time.perf_counter() > end)
                                   for c in range(clients)))
            out["frontier"] = await db.stop_backup("backup")
            await cluster.stop()
            window = sorted(v for v, _, _, _ in mk.history[first:])
            out["writes"] = len(window)
            out["codes"], out["unknown"] = mk.codes, len(mk.maybe)
            return mk, window

        mk, window = asyncio.run(source())
        mid = window[len(window) // 2]
        out["mid"], out["last"] = mid, window[-1]
        for name, to in (("end", None), ("mid", mid)):
            want = mk.expected(keys, at=to)
            record: list = []

            async def restore():
                cluster = await Cluster.create(
                    ClusterConfig(), knobs, fs=fs, data_dir=f"dst-{name}",
                    device=dev)
                cluster.start()
                db = Database(cluster)
                before = launches()
                t0 = time.perf_counter()
                await db.restore(fs, "backup", to_version=to)
                r = {"restore_s": time.perf_counter() - t0,
                     "launches": launches(before)}
                rows = await read_pages(db, b"", b"\xff")
                r["rows"] = len(rows)
                r["equal"] = dict(rows) == want
                r["digest"] = keyspace_digest(rows)
                await asyncio.sleep(2.0)    # out of the MVCC window
                before = launches()
                calls, undo = held_to_plain()
                t0 = time.perf_counter()
                try:
                    r["read_bad"] = await read_multi(cluster, keys, want)
                finally:
                    undo()
                r["read_s"] = time.perf_counter() - t0
                r["read_launches"] = launches(before)
                r["prefix_calls"] = calls
                r["mirrors"] = [ss._device_reads.metrics()
                                if ss._device_reads is not None else None
                                for ss in cluster.storage_servers]
                await cluster.stop()
                return r

            with generations(record, set()):
                r = asyncio.run(restore())
            r["want_digest"] = keyspace_digest(sorted(want.items()))
            reqs = [x[2] for x in record]
            r["fat"] = sum(1 for req in reqs for t in req.txns
                           if len(t.read_ranges) > R
                           or len(t.write_ranges) > R)
            r["slim"] = sum(len(req.txns) for req in reqs) - r["fat"]
            r["resolves"] = len(record)
            r["replay"] = replay_generations(record)
            out["restores"][name] = r
    return out


def check_backup_phase(r: dict, on_card: bool) -> int:
    """Phase 21's checks (the launch counts only on the card); returns
    prefix_search's largest error against its plain version."""
    say(f"backup: {r['n_keys']} keys loaded in {r['load_s']:.3f} s; "
        f"start_backup's snapshot at version {r['snapshot_version']} in "
        f"{r['snapshot_s']:.3f} s; {r['clients']} mako clients for "
        f"{r['seconds']} s: {r['writes']} acknowledged writes, aborts by "
        f"code {r['codes']}, unknown results {r['unknown']}; stop_backup "
        f"drained through {r['frontier']} (last write {r['last']}); the "
        f"middle of the write window is version {r['mid']}")
    for name, x in r["restores"].items():
        err, lens = plain_err(x["prefix_calls"])
        x["plain_err"] = err
        say(f"restore to {name}: {x['rows']} rows in {x['restore_s']:.3f} "
            f"s through {x['resolves']} resolves ({x['fat']} fat txns "
            f"decided by the exact sidecar, {x['slim']} slim by K3/K1; "
            f"launches {x['launches']}); equal to the expected rows "
            f"{x['equal']}, digest {x['digest']} (expected "
            f"{x['want_digest']}); cpp replay (verdicts, mismatches) "
            f"{x['replay']}; read back by get_multi in {x['read_s']:.3f} s, "
            f"mismatches {x['read_bad']}, launches {x['read_launches']}, "
            f"{len(x['prefix_calls'])} prefix_search calls on mirrors of "
            f"{lens} prefixes against the plain version: max_abs_err={err}"
            f"; mirrors {json.dumps(x['mirrors'])}")
        if not x["equal"] or x["digest"] != x["want_digest"] or \
                x["read_bad"] or x["rows"] != r["n_keys"]:
            fail(f"the restore to {name} differs from the rows expected at "
                 "its version")
        if x["replay"][1] or x["replay"][0] == 0 or err:
            fail(f"the restore to {name}'s verdicts differ from a cpp "
                 "replay, or prefix_search from its plain version")
        if on_card:
            got, rd = x["launches"], x["read_launches"]
            if got["hist_check"] != got["commit_chain"] or \
                    got["commit_chain"] == 0 or rd["prefix_search"] == 0 \
                    or len(x["prefix_calls"]) != rd["prefix_search"]:
                fail(f"the restore to {name} launched {got}, its "
                     f"read-back {rd}")
    if r["unknown"] or r["writes"] == 0 or r["frontier"] < r["last"]:
        fail("a write's outcome was unknown, nothing was written during "
             "the backup, or stop_backup drained short of the last write")
    ends = r["restores"]
    if on_card and ends["mid"]["want_digest"] == ends["end"]["want_digest"]:
        fail("the write window's middle and end hold the same rows, so "
             "the point-in-time restore was not put to the test")
    return max(x["plain_err"] for x in r["restores"].values())


def dr_phase(dev, n_keys: int = CLUSTER_KEYS, clients: int = 16,
             txns: int = 40) -> dict:
    """Phase 22 under the port's run_simulation: a source and a
    destination SimulatedCluster of 4 machines each, every role of both
    on ``dev``; ``n_keys`` mako keys on the source; a DRAgent pulling
    the DR tag through a LogRouter served over the source's simulated
    network while ``clients`` mako clients write the source; the
    switchover; then, on the promoted destination, a transactional
    SecondaryIndex, a LayerFeedConsumer with a WatchRegistry, and a
    LayerConsistencyChecker over ``clients`` mako-shaped clients writing
    through the index."""
    from foundationdb_tpu_torch.backup.dr import DR_TAG, DRAgent
    from foundationdb_tpu_torch.backup.stream import commit_tag
    from foundationdb_tpu_torch.client.subspace import Subspace
    from foundationdb_tpu_torch.core.cluster_controller import \
        ClusterConfigSpec
    from foundationdb_tpu_torch.core.data import SYSTEM_PREFIX
    from foundationdb_tpu_torch.core.log_router import (LogRouter,
                                                        RouterStream)
    from foundationdb_tpu_torch.layers import (LayerConsistencyChecker,
                                               LayerFeedConsumer,
                                               SecondaryIndex, WatchRegistry)
    from foundationdb_tpu_torch.rpc.sim_transport import SimTransport
    from foundationdb_tpu_torch.rpc.stubs import LogRouterClient, serve_role
    from foundationdb_tpu_torch.rpc.transport import (WLTOKEN_FIRST_AVAILABLE,
                                                      NetworkAddress)
    from foundationdb_tpu_torch.rpc.wire import encode
    from foundationdb_tpu_torch.runtime.errors import DatabaseLocked, FdbError
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.runtime.simloop import run_simulation

    out: dict = {"memory": [], "n_keys": n_keys}
    # the DR agent's first copy reads the source at one version page by
    # page, so the MVCC window stays the default (5 s of versions), not
    # phase 18's 0.1 s
    knobs = cluster_knobs("cuda").override(STORAGE_VERSION_WINDOW=Knobs()
                                           .STORAGE_VERSION_WINDOW)

    async def read_all(db, at=None) -> dict:
        tr = db.create_transaction()
        tr.lock_aware = True
        while True:
            try:
                if at is not None:
                    tr.set_read_version(at)
                return dict(await tr.get_range(b"", SYSTEM_PREFIX, limit=0,
                                               snapshot=True))
            except FdbError as e:
                await tr.on_error(e)

    async def locked(db) -> bool:
        tr = db.create_transaction()
        tr.set(b"smoke-probe", b"x")
        try:
            await tr.commit()
            return False
        except DatabaseLocked:
            return True

    async def main():
        sims = [sim_cluster(dev, knobs, n_machines=4,
                            spec=ClusterConfigSpec(min_workers=4))
                for _ in range(2)]
        for s in sims:
            await s.start()
        for s in sims:
            await s.wait_epoch(1)
        src_sim, dest_sim = sims
        src, dest = await src_sim.database(), await dest_sim.database()
        mk = Mako(src, n_keys)
        await mk.load()

        va = await commit_tag(src, "dr", encode(DR_TAG))
        router = LogRouter(src, DR_TAG, va + 1, ["dr-agent"])
        router.start()
        raddr = NetworkAddress("10.1.0.99", 4500)
        serve_role(SimTransport(src_sim.net, raddr), "log_router", router,
                   WLTOKEN_FIRST_AVAILABLE)
        rclient = LogRouterClient(
            SimTransport(src_sim.net, NetworkAddress("10.1.0.98", 4501)),
            raddr, WLTOKEN_FIRST_AVAILABLE)
        dr = DRAgent(src, dest, stream_factory=lambda _db, _tag, begin:
                     RouterStream(rclient, "dr-agent", begin))
        await dr.start()
        out["memory"].append(device_allocated(dev))
        out["dest_locked_during"] = await locked(dest)
        await mk.round(b"d", clients, txns)
        out["router"] = router.metrics()
        vd = await dr.switchover()
        expected = await read_all(src, at=vd)
        got = await read_all(dest)
        got.pop(b"\xff/dr/applied", None)
        out["switchover"] = (vd, len(expected), got == expected,
                             sum(1 for k in expected if got.get(k) !=
                                 expected[k]) + len(set(got) - set(expected)))
        out["source_locked_after"] = await locked(src)
        out["dest_locked_after"] = await locked(dest)
        await router.stop()
        resolvers = live_roles(src_sim, "resolver") + \
            live_roles(dest_sim, "resolver")
        out["resolvers"] = [ring_bytes(r) for _, r in resolvers]
        out["memory"].append(device_allocated(dev))
        out["acked"], out["unknown"] = len(mk.acked), len(mk.maybe)
        out["codes"] = mk.codes

        # the layers on the promoted destination
        consumer = LayerFeedConsumer(dest, name="smoke")
        watches = WatchRegistry(dest, consumer)
        index = SecondaryIndex(dest, Subspace(raw_prefix=b"idx/"),
                               primary_begin=b"lay/", primary_end=b"lay0",
                               mode="transactional",
                               extractor=lambda k, v: [v[:6]])
        checker = LayerConsistencyChecker(dest, index=index,
                                          watches=watches)
        await consumer.start()
        watched = b"lay/%08d" % 0
        fut = await watches.watch(watched)
        fired_before = fut.done()
        zipf = mk.zipf
        writes = [0]

        async def layer_client(cid):
            for i in range(txns):
                ks = [b"lay/%08d" % int(x) for x in zipf.sample(2)]
                val = b"b%02d-%d" % ((cid + i) % 17, i)

                async def body(tr, ks=ks, val=val):
                    await tr.get(ks[0])
                    tr.set(ks[0], val)
                    tr.set(ks[1], val)
                await index.run(body)
                writes[0] += 1
        await asyncio.gather(*(layer_client(c) for c in range(clients)))

        async def touch(tr):
            tr.set(watched, b"b99-watched")
        await index.run(touch)
        tr = dest.create_transaction()
        tip = await tr.get_read_version()
        tr.reset()
        await consumer.wait_frontier(tip, timeout=120)
        await asyncio.sleep(0.5)
        out["watch"] = (fired_before, fut.done())
        verdict = None
        for _ in range(20):
            verdict = await checker.check()
            if not verdict["index"]["refused"]:
                break
            await asyncio.sleep(0.5)
        out["verdict"] = verdict
        out["layer_writes"] = writes[0]
        out["index_stats"] = index.stats()
        await consumer.stop(destroy=True)
        for s in sims:
            await s.stop()

    record: list = []
    stopped: set = set()
    t0 = time.perf_counter()
    with generations(record, stopped):
        run_simulation(main(), seed=22)
    out["seconds"] = time.perf_counter() - t0
    out["record"], out["stopped"] = record, stopped
    return out


def check_dr_phase(r: dict, got: dict, on_card: bool) -> None:
    """Phase 22's checks (the launch counts and memory only on the
    card)."""
    n_cmp, mism = replay_generations(r["record"])
    gens = sorted({x[0] for x in r["record"]})
    late = sum(1 for x in r["record"] if x[4])
    vd, n_rows, equal, differ = r["switchover"]
    v = r["verdict"]
    say(f"dr: destination locked during DR {r['dest_locked_during']}; "
        f"router {json.dumps(r['router'])}; switchover at version {vd}: "
        f"{n_rows} source rows, destination equal {equal} ({differ} "
        f"differ); source locked after {r['source_locked_after']}, "
        f"destination writable {not r['dest_locked_after']}; acknowledged "
        f"keys {r['acked']}, unknown results {r['unknown']}, aborts by "
        f"code {r['codes']}; {len(r['record'])} resolves over {len(gens)} "
        f"resolver generations, replayed through a fresh cpp Resolver "
        f"each: {n_cmp} verdicts, mismatches={mism}; replies after their "
        f"role stopped {late}; launches={got}; {r['seconds']:.3f} s")
    say(f"dr layers on the promoted destination: {r['layer_writes']} index "
        f"transactions, index {json.dumps(r['index_stats'])}; checker "
        f"divergences {v['divergences']} (index {json.dumps(v['index'])}, "
        f"watches {json.dumps(v['watches'])}); watch fired before its "
        f"first write {r['watch'][0]}, after it {r['watch'][1]}")
    say(f"dr device memory: {r['memory']} bytes allocated with both "
        f"clusters up and after the switchover; live resolvers' ring bytes "
        f"{r['resolvers']}")
    if not r["dest_locked_during"] or not r["source_locked_after"] or \
            r["dest_locked_after"]:
        fail("the destination was not locked during DR, the source not "
             "after the switchover, or the destination stayed locked")
    if not equal or differ or n_rows < r["n_keys"] or r["unknown"]:
        fail("the destination differs from the source at the switchover "
             "version")
    if mism or n_cmp == 0 or len(gens) < 2 or late:
        fail("a resolver generation's verdicts differ from the cpp replay, "
             "or a resolver answered after its role stopped")
    if v is None or v["divergences"] or v["index"]["refused"] or \
            r["watch"] != (False, True) or r["layer_writes"] == 0:
        fail(f"the layers diverged, the checker refused, or the watch did "
             f"not fire on its first write: {v}, {r['watch']}")
    if len(r["resolvers"]) != 2:
        fail(f"{len(r['resolvers'])} live resolvers for two clusters")
    if on_card:
        if got["hist_check"] != got["commit_chain"] or \
                got["commit_chain"] == 0:
            fail(f"the two clusters launched {got}")
        if max(r["memory"]) - min(r["memory"]) > max(r["resolvers"]):
            fail(f"device memory grew across the switchover: {r['memory']}")


# --------------------------------------------------------------------------
# phase 23: the seeded chaos run on the card; phase 24: the spec files


def sim_run(main, dev, seed: int, trace_path: str) -> dict:
    """``main()`` (a coroutine of the port's simulation entry points)
    under the port's run_simulation at ``seed``, from a fresh process's
    state: BUGGIFY off, no client API version selected, the span rollup,
    span ids and the transactions' class-wide probe ids at zero (the
    trace's span and trace ids and every role's status metrics read
    them), every trace event to ``trace_path``.  Returns its
    result, seconds, Resolver.resolve calls, kernel launches, every
    prefix_search call's error against the plain version, the card's
    allocated bytes before and after (after a collection), the highest
    epoch a recovery reached, and the trace file's SHA-256; BUGGIFY is
    off again after it."""
    import hashlib

    from foundationdb_tpu_torch.client.multiversion import \
        _reset_api_version_for_tests
    from foundationdb_tpu_torch.client.transaction import Transaction
    from foundationdb_tpu_torch.core.resolver import Resolver
    from foundationdb_tpu_torch.ops import kernels as K
    from foundationdb_tpu_torch.runtime import span
    from foundationdb_tpu_torch.runtime.buggify import enable_buggify
    from foundationdb_tpu_torch.runtime.simloop import run_simulation
    from foundationdb_tpu_torch.runtime.trace import (TraceLog,
                                                      get_trace_log,
                                                      set_trace_log)
    enable_buggify(False)
    _reset_api_version_for_tests()
    span.reset_totals()
    Transaction._probe_counter = 0
    resolves = [0]

    def counting(orig):
        async def resolve(self, req):
            resolves[0] += 1
            return await orig(self, req)
        return resolve

    before = device_allocated(dev)
    prev, log = get_trace_log(), TraceLog(path=trace_path)
    set_trace_log(log)
    K.reset_launches()
    calls, restore = held_to_plain()
    t0 = time.perf_counter()
    try:
        with wrapped(Resolver, "resolve", counting):
            result = run_simulation(main(), seed=seed)
        sync(dev)
    finally:
        seconds = time.perf_counter() - t0
        restore()
        enable_buggify(False)
        log.close()
        set_trace_log(prev)
    out = {"result": result, "seconds": seconds, "resolves": resolves[0],
           "launches": {k: v.launches for k, v in K.KERNELS.items()},
           "prefix_calls": len(calls), "prefix_err": plain_err(calls)[0]}
    del calls
    out["memory"] = (before, device_allocated(dev))
    with open(trace_path, "rb") as f:
        blob = f.read()
    out["sha256"] = hashlib.sha256(blob).hexdigest()
    out["epoch"] = max((e.get("Epoch", 0) for e in map(
        json.loads, blob.splitlines()) if e["Type"] == "RecoveryState"),
        default=0)
    return out


def sim_ring_bytes() -> int:
    """One resolver ring's bytes at the simulator's shapes: begin and
    end lanes [L, C] int32 and versions [C] int64."""
    L = SIM_WIDTH // 4 + 1
    return 2 * L * SIM_RING * 4 + SIM_RING * 8


def chaos_phase(dev, tmp: str) -> dict:
    """Phase 23: sim/run_one.simulate for each of CHAOS_RUNS with every
    resolver and read mirror on ``dev``, then the same run on the CPU
    (the kernels' plain versions); then seed 0 on ``dev`` again."""
    import torch

    from foundationdb_tpu_torch.sim.run_one import simulate

    def go(i, d, where):
        seed, kills, bug, faults = CHAOS_RUNS[i]
        return sim_run(lambda: simulate(seed, kills, bug, faults=faults,
                                        device=d), d, seed,
                       os.path.join(tmp, f"chaos{i}-{where}.jsonl"))
    runs = [(go(i, dev, "card"), go(i, torch.device("cpu"), "cpu"))
            for i in range(len(CHAOS_RUNS))]
    return {"runs": runs, "again": go(0, dev, "again")}


def check_chaos_phase(r: dict) -> dict:
    """Phase 23's gates; returns the launches of all its card runs."""
    ring = sim_ring_bytes()
    total = {}
    for (seed, kills, bug, faults), (card, cpu) in zip(CHAOS_RUNS,
                                                       r["runs"]):
        got, res = card["launches"], card["result"]
        grew = card["memory"][1] - card["memory"][0]
        say(f"chaos seed {seed} kills={kills} buggify={bug} "
            f"faults={faults}: card {card['seconds']:.3f} s, cpu "
            f"{cpu['seconds']:.3f} s; epochs reached {card['epoch']}, "
            f"machines killed {res['MachineAttrition']['machines_killed']},"
            f" resolves {card['resolves']} (cpu {cpu['resolves']}); "
            f"launches K1 {got['commit_chain']} K3 {got['hist_check']} K2 "
            f"{got['ring_append']} B8 {got['prefix_search']} ({card['prefix_calls']} "
            f"calls, max_abs_err {card['prefix_err']}); results equal to "
            f"the cpu run {res == cpu['result']}; trace sha256 card "
            f"{card['sha256'][:16]} cpu {cpu['sha256'][:16]}; device memory "
            f"{card['memory'][0]} -> {card['memory'][1]} bytes (one ring "
            f"{ring}) ({CARD})")
        if res != cpu["result"]:
            fail(f"chaos seed {seed}: the card's results differ from the "
                 f"CPU's: {res} against {cpu['result']}")
        if got["hist_check"] != got["commit_chain"] \
                or got["commit_chain"] == 0:
            fail(f"chaos seed {seed} launched {got}")
        if card["prefix_err"] or got["prefix_search"] != card["prefix_calls"]:
            fail(f"chaos seed {seed}: prefix_search differs from its plain "
                 f"version, or a launch went unrecorded")
        if grew > ring:
            fail(f"chaos seed {seed}: the card holds {grew} more bytes "
                 f"after the run than before (one ring is {ring})")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    card, cpu = r["runs"][0]
    again = r["again"]
    say(f"chaos seed 0 on the card twice: results equal "
        f"{again['result'] == card['result']}, traces equal "
        f"{again['sha256'] == card['sha256']}; card and cpu traces equal "
        f"{card['sha256'] == cpu['sha256']} ({card['sha256']})")
    if card["sha256"] != cpu["sha256"]:
        fail("chaos seed 0: the card's trace differs from the CPU's")
    if again["result"] != card["result"] or again["sha256"] != card["sha256"]:
        fail("chaos seed 0 twice on the card gave different runs")
    return total


def dr_resolvers(seen: list):
    """Wraps DRUnderAttrition's check: before it drains, every live
    resolver of the source's machines and of the destination cluster is
    appended to ``seen`` as (conflict set class, device)."""
    from foundationdb_tpu_torch.workloads.ops import DRUnderAttritionWorkload

    def make(orig):
        async def checking(self):
            if self.dr is not None:
                sim = self.ctx.options["sim"]
                live = [obj for _, obj in live_roles(sim, "resolver")] \
                    + list(self._dest_cluster.resolvers)
                seen.append([(type(x.backend.cs).__name__,
                              str(x.backend.cs.device)) for x in live])
            return await orig(self)
        return checking
    return wrapped(DRUnderAttritionWorkload, "check", make)


def specs_phase(dev, tmp: str) -> list:
    """Phase 24: sim/spec.run_spec for each of SPECS at seed 0, on
    ``dev`` and then on the CPU, with DR's live resolvers collected."""
    import torch

    from foundationdb_tpu_torch.sim.spec import load_spec, run_spec
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "specs")
    out = []
    for name in SPECS:
        spec = load_spec(os.path.join(root, name))
        pair = []
        for d, where in ((dev, "card"), (torch.device("cpu"), "cpu")):
            seen: list = []
            with dr_resolvers(seen):
                r = sim_run(lambda d=d: run_spec(spec, seed=0, device=d), d,
                            0, os.path.join(tmp, f"{name}-{where}.jsonl"))
            r["dr_resolvers"] = seen
            pair.append(r)
        out.append((name, *pair))
    return out


def check_specs_phase(r: list) -> dict:
    """Phase 24's gates; returns the launches of all its card runs."""
    total = {}
    for name, card, cpu in r:
        got, res = card["launches"], card["result"]
        say(f"spec {name} seed 0: card {card['seconds']:.3f} s, cpu "
            f"{cpu['seconds']:.3f} s; epochs reached {card['epoch']}, "
            f"resolves {card['resolves']}; launches K1 "
            f"{got['commit_chain']} K3 {got['hist_check']} K2 "
            f"{got['ring_append']} B8 {got['prefix_search']} "
            f"({card['prefix_calls']} calls, max_abs_err "
            f"{card['prefix_err']}); results equal to the cpu run "
            f"{res == cpu['result']}; results {json.dumps(res)[:600]} "
            f"({CARD})")
        if res != cpu["result"]:
            fail(f"spec {name}: the card's results differ from the CPU's")
        if got["hist_check"] != got["commit_chain"] \
                or got["commit_chain"] == 0:
            fail(f"spec {name} launched {got}")
        if card["prefix_err"] or got["prefix_search"] != card["prefix_calls"]:
            fail(f"spec {name}: prefix_search differs from its plain "
                 "version, or a launch went unrecorded")
        if name == "cycle_restart.toml":
            rs = res["restart"]
            say(f"spec {name}: restart rows {rs['rows']}, protocol "
                f"{rs['old_protocol']} -> {rs['new_protocol']}, multi-version "
                f"client switched {rs.get('mv_client_switched')}")
            if rs["rows"] <= 0 or not rs.get("mv_client_switched"):
                fail(f"spec {name}: the restart read back {rs}")
        if name == "backup_dr_chaos.toml":
            live = card["dr_resolvers"]
            n = sum(len(x) for x in live)
            say(f"spec {name}: live resolvers during DR (source and "
                f"destination) {n}: {live}; on the cpu run "
                f"{cpu['dr_resolvers']}")
            if not live or n < 2 or any(
                    cls != "TorchConflictSet" or not dv.startswith("cuda")
                    for x in live for cls, dv in x):
                fail(f"spec {name}: a live resolver during DR is not a cuda "
                     f"backend on the card: {live}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    return total


# --------------------------------------------------------------------------
# phase 25: the operator's deployment (fdbmonitor, fdbcli, the C ABI)


def _free_ports(n: int) -> list[int]:
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class GpuHolders:
    """Samples, every ``every`` seconds on a thread of its own, which
    processes hold the NVIDIA device files open (``/proc/<pid>/fd``
    links to ``/dev/nvidia*``, the device files a CUDA context holds
    open), and how many compute apps ``nvidia-smi
    --query-compute-apps=pid`` lists (its pids are not this machine's
    when the card's processes run in a pid namespace)."""

    def __init__(self, every: float = 0.05) -> None:
        import threading
        self.pids: set[int] = set()
        self.samples = 0
        self.smi_apps_max = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(every,),
                                        daemon=True)
        self._thread.start()

    @staticmethod
    def holds(pid: str) -> bool:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            return False
        for fd in fds:
            try:
                if os.readlink(f"/proc/{pid}/fd/{fd}").startswith(
                        "/dev/nvidia"):
                    return True
            except OSError:
                pass
        return False

    def _run(self, every: float) -> None:
        n = 0
        while not self._stop.is_set():
            self.pids |= {int(p) for p in os.listdir("/proc")
                          if p.isdigit() and self.holds(p)}
            self.samples += 1
            if n % 20 == 0:
                r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                                    "--format=csv,noheader"],
                                   capture_output=True, text=True, timeout=30)
                self.smi_apps_max = max(self.smi_apps_max,
                                        len(r.stdout.split()))
            n += 1
            self._stop.wait(every)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=60)


# tests/test_bindings.py's operation sequence (its ops, check, check2,
# extended, check3 and check4 transactions), as data: each transaction a
# list of (op, args...) whose observations are compared
BINDING_SEQUENCE = [
    [("set", b"bt1", b"v1"), ("set", b"bt2", b"v2"), ("get", b"bt1")],
    [("get", b"bt1"), ("get", b"bt2"), ("get", b"btmissing"),
     ("clear", b"bt1")],
    [("get", b"bt1"), ("get", b"bt2")],
    [("option", "lock_aware")]
    + [("set", b"rng%02d" % i, b"x%d" % i) for i in range(5)]
    + [("add", b"ctr", (7).to_bytes(8, "little"))],
    [("range", b"rng", b"rng\xff", 0, False),
     ("range", b"rng", b"rng\xff", 2, True), ("get", b"ctr"),
     ("add", b"ctr", (5).to_bytes(8, "little"))],
    [("get", b"ctr"), ("grv",), ("option", "no_such_option")],
]
BINDING_EXPECTED = [
    ["v1"], ["v1", "v2", None], [None, "v2"], [0],
    [[[f"rng{i:02d}", f"x{i}"] for i in range(5)],
     [["rng04", "x4"], ["rng03", "x3"]], (7).to_bytes(8, "little").hex()],
    [(12).to_bytes(8, "little").hex(), True, 2007],
]


def _shown(x, prefix: bytes):
    """An observation as JSON data: a value's bytes as text where they
    are printable, else hex; a key without the run's prefix."""
    if isinstance(x, (bytes, bytearray)):
        x = bytes(x)
        if x.startswith(prefix):
            x = x[len(prefix):]
        return x.decode() if x.isascii() and x.isalnum() else x.hex()
    if isinstance(x, (list, tuple)):
        return [_shown(v, prefix) for v in x]
    return x


def binding_observations_c(db, prefix: bytes) -> list:
    """BINDING_SEQUENCE through the Python binding over the C ABI
    (``fdbtpu.open``'s database), its keys under ``prefix``."""
    import fdbtpu
    out = []
    for ops in BINDING_SEQUENCE:
        def txn(tr, ops=ops):
            seen = []
            for op, *a in ops:
                k = prefix + a[0] if a and isinstance(a[0], bytes) else None
                if op == "set":
                    tr.set(k, a[1])
                elif op == "clear":
                    tr.clear(k)
                elif op == "get":
                    seen.append(tr.get(k))
                elif op == "add":
                    tr.add(k, a[1])
                elif op == "range":
                    seen.append(tr.get_range(k, prefix + a[1], limit=a[2],
                                             reverse=a[3]))
                elif op == "grv":
                    seen.append(tr.get_read_version() > 0)
                else:
                    try:
                        tr.set_option(a[0])
                        seen.append(0)
                    except fdbtpu.FdbtpuError as e:
                        seen.append(e.code)
            return seen
        out.append(_shown(db.run(txn), prefix))
    return out


async def binding_observations_native(cli, prefix: bytes) -> list:
    """BINDING_SEQUENCE through the port's native client (the CLI's retry
    loop over TCP), its keys under ``prefix``; an option is what the C
    ABI's host does with it."""
    from foundationdb_tpu_torch.core.data import MutationType
    out = []
    for ops in BINDING_SEQUENCE:
        async def txn(tr, ops=ops):
            seen = []
            for op, *a in ops:
                k = prefix + a[0] if a and isinstance(a[0], bytes) else None
                if op == "set":
                    tr.set(k, a[1])
                elif op == "clear":
                    tr.clear(k)
                elif op == "get":
                    seen.append(await tr.get(k))
                elif op == "add":
                    tr.atomic_op(MutationType.ADD, k, a[1])
                elif op == "range":
                    seen.append(await tr.get_range(
                        k, prefix + a[1], limit=a[2], reverse=a[3]))
                elif op == "grv":
                    seen.append(await tr.get_read_version() > 0)
                elif a[0] == "lock_aware":
                    tr.lock_aware = True
                    seen.append(0)
                else:
                    seen.append(2007)       # invalid_option
            return seen
        out.append(_shown(await cli.run_txn(txn), prefix))
    return out


# the client-facing roles of a published cluster state, by its key
STATE_ROLES = {"grv_proxies": "grv_proxy", "commit_proxies": "commit_proxy",
               "storage": "storage", "resolvers": "resolver",
               "sequencer": "sequencer", "ratekeeper": "ratekeeper"}


class OutstandingRequests:
    """Wraps a client transport's ``request``: every request is kept
    from its send to its end (a reply, an error, or a cancellation, as
    when an attempt's ``wait_for`` cuts it), with the cluster state the
    client's view held when it was sent, so that a timed-out attempt
    names what it was awaiting (``report``).  ``view_fn`` returns the
    client's current view."""

    def __init__(self, transport, view_fn, role_methods: dict,
                 coordinator_token: int) -> None:
        self.requests: list = []    # [endpoint, epoch, state, sent, ended]
        self.role_methods = role_methods
        self.coordinator_token = coordinator_token
        real = transport.request

        async def request(endpoint, payload, timeout=None):
            view, now = view_fn(), time.perf_counter()
            self.requests = [r for r in self.requests
                             if r[4] is None or r[4] > now - 60]
            rec = [endpoint, view.epoch, view.state, now, None]
            self.requests.append(rec)
            try:
                return await real(endpoint, payload, timeout)
            finally:
                rec[4] = time.perf_counter()
        transport.request = request

    def role(self, ep, state: dict) -> str:
        """The role and method an endpoint names in a published state."""
        addr = (ep.address.ip, ep.address.port)
        for key, role in STATE_ROLES.items():
            v = state.get(key)
            for j, x in enumerate(v if isinstance(v, list) else [v]):
                if isinstance(x, dict) and "token" in x \
                        and tuple(x.get("addr", ())) == addr \
                        and 0 <= ep.token - x["token"] < len(
                            self.role_methods[role]):
                    name = self.role_methods[role][ep.token - x["token"]][0]
                    return f"{key}[{j}].{name}"
        i = ep.token - self.coordinator_token
        if 0 <= i < len(self.role_methods["coordinator"]):
            return f"coordinator.{self.role_methods['coordinator'][i][0]}"
        return "unknown"

    @staticmethod
    def roles_at(state: dict, port: int) -> list:
        """The client-facing roles a published state places on the
        localhost server at ``port``."""
        return [f"{key}[{j}]" for key in STATE_ROLES
                for j, x in enumerate(state.get(key) if isinstance(
                    state.get(key), list) else [state.get(key)])
                if isinstance(x, dict)
                and tuple(x.get("addr", ())) == ("127.0.0.1", port)]

    def report(self, at: float) -> list:
        """Each request outstanding at ``at`` (unanswered then, or cut at
        it): its endpoint, the role and method it names, the epoch of the
        view that sent it, and the seconds it had waited."""
        return [{"endpoint": f"{ep.address}/{ep.token}",
                 "role": self.role(ep, state), "epoch": epoch,
                 "waited_s": round(at - sent, 3)}
                for ep, epoch, state, sent, ended in self.requests
                if sent <= at and (ended is None or ended >= at - 0.1)]


def exit_state(pid: int) -> str:
    """A killed process as /proc shows it: "gone", or its state letter
    (Z once its exit has closed its files) and the sockets it still
    holds open."""
    st, _, socks = process_files(pid)
    return st if st == "gone" else f"{st}, {socks} sockets"


TCP_STATES = {1: "ESTABLISHED", 2: "SYN_SENT", 3: "SYN_RECV", 4: "FIN_WAIT1",
              5: "FIN_WAIT2", 6: "TIME_WAIT", 7: "CLOSE", 8: "CLOSE_WAIT",
              9: "LAST_ACK", 10: "LISTEN", 11: "CLOSING"}


def tcp_sockets() -> list:
    """``/proc/net/tcp``'s sockets: (local port, remote port, state,
    inode) each."""
    out = []
    with open("/proc/net/tcp") as f:
        next(f)
        for ln in f:
            p = ln.split()
            out.append((int(p[1].rsplit(":", 1)[1], 16),
                        int(p[2].rsplit(":", 1)[1], 16),
                        TCP_STATES.get(int(p[3], 16), p[3]), int(p[9])))
    return out


def socket_inodes() -> set:
    """The inodes of the sockets this process holds open."""
    out = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            link = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        if link.startswith("socket:["):
            out.add(int(link[8:-1]))
    return out


def process_files(pid: int) -> list:
    """[state letter, open files, sockets] of process ``pid``, or
    ["gone", 0, 0]."""
    try:
        with open(f"/proc/{pid}/status") as f:
            st = "".join(ln.split()[1] for ln in f
                         if ln.startswith("State:"))
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return ["gone", 0, 0]
    socks = 0
    for fd in fds:
        try:
            socks += os.readlink(f"/proc/{pid}/fd/{fd}").startswith(
                "socket:")
        except OSError:
            pass
    return [st, len(fds), socks]


def _count(states) -> dict:
    return dict(sorted(collections.Counter(states).items()))


class KillWatch:
    """From a killed server's SIGKILL on, every ``every`` seconds on a
    thread of its own, reading ``/proc`` only: the killed process's
    state, open files and sockets (``proc``); whether ``/proc/net/tcp``
    still has a LISTEN entry for its port (``listen``); the states of
    every socket of the machine's network namespace connected to that
    port (``to_port``: the other processes' connections, a live proxy's
    to the killed sequencer among them) and of those at it
    (``at_port``: the killed side's own); and the states of this
    process's sockets (matched by inode) to each of ``ports``
    (``mine``).  ``rows`` keeps the first sample and every one in which
    anything but its time changed, with its seconds since the kill."""

    def __init__(self, pid: int, port: int, ports, every: float = 0.1,
                 extra=None) -> None:
        import threading
        self.pid, self.port, self.ports = pid, port, set(ports)
        self.extra = extra            # () -> a value kept in each row
        self.t0 = time.perf_counter()
        self.rows: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(every,),
                                        daemon=True)
        self._thread.start()

    def sample(self, ports=None) -> dict:
        mine = socket_inodes()
        table = tcp_sockets()
        row = {"proc": process_files(self.pid),
               "listen": any(lp == self.port and st == "LISTEN"
                             for lp, _, st, _ in table),
               "to_port": _count(st for _, rp, st, _ in table
                                 if rp == self.port),
               "at_port": _count(st for lp, _, st, _ in table
                                 if lp == self.port and st != "LISTEN"),
               "mine": {str(p): sorted(st for _, rp, st, ino in table
                                       if rp == p and ino in mine)
                        for p in sorted(ports or self.ports)}}
        if self.extra is not None:
            row["extra"] = self.extra()
        return row

    def _run(self, every: float) -> None:
        last = None
        while not self._stop.is_set():
            row = self.sample()
            if row != last:
                self.rows.append(
                    {"t": round(time.perf_counter() - self.t0, 2), **row})
                last = row
            self._stop.wait(every)

    def stop(self) -> list:
        self._stop.set()
        self._thread.join()
        return self.rows

    def at(self, ports) -> dict:
        """A sample now, for a timed-out attempt, with this process's
        sockets to each of ``ports`` (the awaited requests' addresses);
        and the first 80 change rows."""
        return {"t": round(time.perf_counter() - self.t0, 2),
                **self.sample(set(ports)), "changes": self.rows[:80]}


def watch_summary(rows: list) -> dict:
    """When, in seconds after the kill, a ``KillWatch`` first saw the
    killed process a zombie (the paused monitor does not reap it) and
    holding no sockets; its port's listener gone; no socket left at its
    port; and no ESTABLISHED socket left to it (None: not within the
    watch)."""
    def first(pred):
        return next((r["t"] for r in rows if pred(r)), None)
    return {"zombie_s": first(lambda r: r["proc"][0].startswith("Z")),
            "no_sockets_s": first(lambda r: r["proc"][2] == 0),
            "listen_gone_s": first(lambda r: not r["listen"]),
            "at_port_empty_s": first(lambda r: not r["at_port"]),
            "to_port_established_gone_s": first(
                lambda r: "ESTABLISHED" not in r["to_port"]),
            "rows": len(rows)}


def connection_timeouts(tmp: str) -> list:
    """The ``ConnectionTimeout`` events (a TCP connection cut after its
    peer's silence, ``rpc/tcp_transport.py``) in a deployment's server
    logs and in ``client.jsonl`` under ``tmp``: [file, peer, phase
    ("dial" or "connected"), silent s, pending requests] each."""
    out = []
    for root, _, files in os.walk(tmp):
        for name in sorted(files):
            if not (name.startswith("fdbserver.") or name == "client.jsonl"):
                continue
            with open(os.path.join(root, name), errors="replace") as f:
                for ln in f:
                    if '"ConnectionTimeout"' not in ln:
                        continue
                    try:
                        ev = json.loads(ln)
                    except ValueError:
                        continue
                    out.append([os.path.relpath(os.path.join(root, name),
                                                tmp), ev.get("PeerAddr"),
                                ev.get("Phase"), ev.get("SilentSeconds"),
                                ev.get("Pending")])
    return out


def awaited_ports(report: list) -> list:
    """The ports of the endpoints an ``OutstandingRequests.report``
    names."""
    return sorted({int(r["endpoint"].split("/")[0].rsplit(":", 1)[1])
                   for r in report})


async def published_epochs(coordinators) -> list:
    """The epoch each coordinator publishes now, asked one by one: None
    for one that does not answer within 5 s (the client's own refresh
    returns on a majority, so it does not show which one is silent)."""
    async def one(c):
        try:
            r = await asyncio.wait_for(c.open_database(), 5)
        except Exception:  # noqa: BLE001 — no answer is the answer
            return None
        return (r or {}).get("epoch")
    return list(await asyncio.gather(*(one(c) for c in coordinators)))


class Deployment:
    """One ``python3 -m foundationdb_tpu_torch.monitor`` over a fresh conf
    in ``tmp``: tests/test_monitor.py's layout, three coordinator servers
    and one worker-only server, each ``device = <dev_name>``,
    min_workers=3, replication=2; and the CLI (``python3 -m
    foundationdb_tpu_torch.cli --exec``) against it.  Every client
    process's pid goes to ``client_pids``."""

    def __init__(self, dev_name: str, tmp: str, client_pids: list) -> None:
        from foundationdb_tpu_torch.core.cluster_file import ClusterFile
        from foundationdb_tpu_torch.rpc.transport import NetworkAddress
        os.makedirs(tmp)
        self.tmp, self.client_pids = tmp, client_pids
        self.repo = os.path.dirname(os.path.abspath(__file__))
        self.env = dict(os.environ, PYTHONPATH=self.repo)
        self.ports = _free_ports(4)
        self.cf_path = os.path.join(tmp, "fdb.cluster")
        ClusterFile("deploy", "t1", [NetworkAddress("127.0.0.1", p)
                                     for p in self.ports[:3]]).save(
                                         self.cf_path)
        conf = os.path.join(tmp, "fdbmonitor.conf")
        with open(conf, "w") as f:
            f.write(f"[general]\ncluster-file = {self.cf_path}\n"
                    f"restart-delay = 0.5\ndevice = {dev_name}\n"
                    f"logdir = {tmp}\n" + "".join(
                        f"[fdbserver.{p}]\nlisten = 127.0.0.1:{p}\n"
                        "spec = min_workers=3,replication=2\n"
                        for p in self.ports))
        self.mon_err = os.path.join(tmp, "monitor.err")
        self.t0 = time.perf_counter()
        with open(self.mon_err, "wb") as ef:
            self.mon = subprocess.Popen(
                [sys.executable, "-m", "foundationdb_tpu_torch.monitor", "-C",
                 conf], cwd=self.repo, env=self.env,
                stdout=subprocess.DEVNULL, stderr=ef)

    def _read(self, name: str) -> str:
        with open(os.path.join(self.tmp, name), errors="replace") as f:
            return f.read()

    def started(self) -> dict:
        """Each server's pids in the order the monitor started them."""
        pids: dict = {}
        for ln in self._read("monitor.err").splitlines():
            if "started fdbserver." in ln:
                sid = ln.split("fdbserver.")[1].split()[0]
                pids.setdefault(int(sid), []).append(
                    int(ln.split("pid=")[1].split()[0]))
        return pids

    def cli(self, script: str, timeout: float = 120) -> str:
        p = subprocess.Popen(
            [sys.executable, "-m", "foundationdb_tpu_torch.cli", "-C",
             self.cf_path, "--exec", script], cwd=self.repo, env=self.env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.client_pids.append(p.pid)
        try:
            so, se = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        return so if p.returncode == 0 else f"rc={p.returncode} {se[-600:]}"

    def read_back(self, keys: list) -> dict:
        """Each key's ``get`` through one CLI run (split on newlines only:
        a value's bytes may hold a form feed)."""
        got = self.cli("; ".join(f"get {k.decode()}" for k in keys))
        return dict(zip(keys, got.rstrip("\n").split("\n")))

    def until(self, script: str, want: str, budget: float) -> float:
        """Seconds until the CLI's ``script`` prints ``want``."""
        t = time.perf_counter()
        while True:
            got = self.cli(script)
            if want in got:
                return time.perf_counter() - t
            if self.mon.poll() is not None:
                fail(f"the monitor exited: {self._read('monitor.err')[-2000:]}")
            if time.perf_counter() - t > budget:
                fail(f"`{script}' never gave `{want}' within {budget} s: "
                     f"{got[-1500:]}")
            time.sleep(0.5)

    def up_after(self, sid: int, n: int, budget: float) -> float:
        """Seconds until server ``sid`` has started ``n`` times and its
        latest process is up (its SIGTERM handler set)."""
        t = time.perf_counter()
        while len(self.started().get(sid, [])) < n or self._read(
                f"fdbserver.{sid}.log").count('"ServerStarted"') < n:
            if time.perf_counter() - t > budget:
                fail(f"server {sid} did not start a {n}th time")
            time.sleep(0.2)
        return time.perf_counter() - t

    def stop(self) -> dict:
        """SIGTERM to the monitor (resumed first, if paused); what it and
        its servers said about stopping, and each server log that holds
        a traceback with its first one (``tracebacks``)."""
        import signal
        alive = self.mon.poll() is None
        self.mon.send_signal(signal.SIGCONT)
        self.mon.send_signal(signal.SIGTERM)
        try:
            self.mon.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.mon.kill()
            self.mon.wait()
        log = self._read("monitor.err")
        logs = {f: self._read(f) for f in sorted(os.listdir(self.tmp))
                if f.startswith("fdbserver.")}
        return {"alive": alive, "rc": self.mon.returncode, "log": log,
                "servers": self.started(),
                "stopped": [ln for ln in log.splitlines()
                            if "stopped rc=" in ln],
                "tracebacks": {
                    f: t[t.rfind("\n", 0, max(t.index("Traceback") - 1, 0))
                         + 1:][:3000]
                    for f, t in logs.items() if "Traceback" in t}}


async def elected_leader(d: Deployment) -> int:
    """The port of the server the coordinators name as the leader."""
    from foundationdb_tpu_torch.rpc.stubs import CoordinatorClient
    from foundationdb_tpu_torch.rpc.tcp_transport import TcpTransport
    from foundationdb_tpu_torch.rpc.transport import (NetworkAddress,
                                                      WLTOKEN_COORDINATOR)
    t = TcpTransport(NetworkAddress("127.0.0.1", 0))
    leader = None
    try:
        for p in d.ports[:3]:
            co = CoordinatorClient(t, NetworkAddress("127.0.0.1", p),
                                   WLTOKEN_COORDINATOR)
            try:
                led = await asyncio.wait_for(co.read_leader(), 5)
            except (Exception, asyncio.TimeoutError):
                continue
            if led is not None:
                leader = led[1][1]
                break
    finally:
        await t.close()
    if leader not in d.ports:
        fail(f"no elected leader among the servers: {leader}")
    return leader


async def attempt(cli_, waits, script: str, tk: float, victim_port: int,
                  victim: int, attempts: list, timed_out: list, label: str,
                  watch=None):
    """One ``script`` through ``cli_`` under 30 s, ``tk`` the time of the
    signal to server ``victim_port``'s process ``victim``: appends [start
    s after the signal, outcome, s] to ``attempts`` and prints it; a
    timed-out attempt also appends to ``timed_out`` what it was awaiting
    (``waits``), each coordinator's published epoch, the client's view's
    epoch, the roles that view places on the victim, the victim's state,
    and with a ``KillWatch`` its sockets.  Returns the CLI's output, or
    "timeout"; raises what the CLI raised."""
    ta = time.perf_counter()
    try:
        got = await asyncio.wait_for(cli_.execute(script), 30)
        outcome = "committed" if got == "Committed" else str(got)[:120]
    except asyncio.TimeoutError:
        got = outcome = "timeout"
        report = waits.report(time.perf_counter())
        rec = {"attempt": len(attempts), "awaiting": report}
        if watch is not None:
            rec["sockets"] = watch.at(awaited_ports(report))
        rec.update({
            "published_epochs": await published_epochs(cli_.coordinators),
            "view_epoch": cli_.view.epoch,
            "killed_server_roles": waits.roles_at(cli_.view.state,
                                                  victim_port),
            "killed_process": exit_state(victim)})
        timed_out.append(rec)
        say(f"{label}: attempt {len(attempts)} timed out: "
            f"{json.dumps(rec)}")
    except Exception as e:
        outcome = type(e).__name__
        raise
    finally:
        attempts.append([round(ta - tk, 3), outcome,
                         round(time.perf_counter() - ta, 3)])
        say(f"{label}: attempt {len(attempts) - 1} [start s after the "
            f"signal, outcome, s] {json.dumps(attempts[-1])}")
    return got


async def attempts_after(d: Deployment, cli_, waits, victim_port: int,
                         sig: int, out: dict, label: str,
                         budget: float) -> None:
    """Signal ``sig`` (SIGKILL or SIGSTOP) to server ``victim_port``'s
    process with the monitor paused, then ``set after failover`` through
    ``cli_`` until it commits, each attempt under 30 s and 0.25 s after
    the last (``attempt``), each printed: ``out``'s
    ``failover_attempts``, ``timed_out``, ``failover_s`` and
    ``kill_watch``.  Fails after ``budget`` s without a commit.  A
    stopped server gets SIGCONT and SIGKILL after the attempts; then the
    monitor resumes."""
    import signal
    # the monitor paused while the survivors recover: a server restarted
    # at once comes back an empty TLog and storage host (ROADMAP C2);
    # phase 33 restarts the coordinators' servers at once
    os.kill(d.mon.pid, signal.SIGSTOP)
    attempts = out.setdefault("failover_attempts", [])
    watch = victim = None
    try:
        victim = d.started()[victim_port][-1]
        os.kill(victim, sig)
        tk = time.perf_counter()
        watch = KillWatch(victim, victim_port, d.ports)
        while True:
            got = await attempt(cli_, waits, "set after failover", tk,
                                victim_port, victim, attempts,
                                out.setdefault("timed_out", []), label,
                                watch)
            if got == "Committed":
                out["failover_s"] = time.perf_counter() - tk
                break
            if time.perf_counter() - tk > budget:
                say(f"{label}: failover attempts [start s after the "
                    f"signal, outcome, s]: {json.dumps(attempts)}")
                fail(f"{label}: no commit within {budget} s of the "
                     f"signal to the leader's server: {got}")
            await asyncio.sleep(0.25)
    finally:
        if sig == signal.SIGSTOP and victim is not None:
            os.kill(victim, signal.SIGCONT)
            os.kill(victim, signal.SIGKILL)
        os.kill(d.mon.pid, signal.SIGCONT)
        if watch is not None:
            out["kill_watch"] = watch_summary(watch.stop())


def deployment_phase(dev_name: str, root: str | None = None) -> dict:
    """Phase 25, the operator's deployment, in two fdbmonitor lifetimes
    (``Deployment``), each with at most one server killed: replication 2
    outlives one lost process, and a server the monitor restarts comes
    back as an empty coordinator, TLog and storage host (ROADMAP C).

    The first: the first commit through the CLI (timed from the
    monitor's spawn), 16 writes, a range read and the status document;
    SIGKILL of the elected leader's server with the monitor paused, the
    seconds until a commit succeeds again (the port's open_cli in this
    process, as fdbcli runs it), then the monitor resumed, which restarts
    the server; the reference's bindings/c/test_c_smoke.c built against
    the port's header and library; tests/test_bindings.py's operation
    sequence through the port's Python binding over the C ABI and through
    the native client; every acknowledged write read back through the
    CLI; SIGTERM.  The second: a commit, then SIGKILL of the worker-only
    server, which the monitor restarts, and the writes read back through
    the CLI (tests/test_monitor.py's contract after the restart); SIGTERM.
    With ``cuda`` the processes holding the card are sampled throughout."""
    import signal
    import site
    import sysconfig

    from foundationdb_tpu_torch.cli import open_cli
    from foundationdb_tpu_torch.native.build import build
    from foundationdb_tpu_torch.rpc.stubs import ROLE_METHODS
    from foundationdb_tpu_torch.rpc.transport import WLTOKEN_COORDINATOR
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.runtime.trace import (TraceLog,
                                                      get_trace_log,
                                                      set_trace_log)

    out: dict = {"client_pids": [], "acked": {}}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        # this process's client trace events (the failover's and the
        # native sequence's) go to a file of the phase's own
        prev_log = get_trace_log()
        set_trace_log(TraceLog(path=os.path.join(tmp, "client.jsonl")))
        apps = GpuHolders() if dev_name == "cuda" else None
        try:
            d = Deployment(dev_name, os.path.join(tmp, "main"),
                           out["client_pids"])
            try:
                d.until("set first 1", "Committed", 300)
                out["first_commit_s"] = time.perf_counter() - d.t0
                out["acked"][b"first"] = b"1"
                writes = {b"deploy/%02d" % i: b"v%d" % i for i in range(16)}
                got = d.cli("; ".join(f"set {k.decode()} {v.decode()}"
                                      for k, v in writes.items()))
                if got.split() != ["Committed"] * 16:
                    fail(f"the CLI's writes: {got}")
                out["acked"].update(writes)
                out["range"] = d.cli("getrange deploy/ deploy0 100") \
                    .splitlines()
                out["status"] = json.loads(d.cli("status json"))["cluster"]

                async def failover():
                    cli_ = await open_cli(d.cf_path, Knobs(), timeout=60)
                    # what a timed-out attempt was still awaiting
                    waits = OutstandingRequests(
                        cli_.view.transport, lambda: cli_.view,
                        ROLE_METHODS, WLTOKEN_COORDINATOR)
                    out["leader"] = await elected_leader(d)
                    await attempts_after(d, cli_, waits, out["leader"],
                                         signal.SIGKILL, out, "deployment",
                                         240)
                    out["acked"][b"after"] = b"failover"
                    out["native"] = await binding_observations_native(
                        cli_, b"n/")
                    await cli_.view.transport.close()
                asyncio.run(asyncio.wait_for(failover(), 600))
                # the monitor resumed: it restarts the leader's server
                out["leader_restart_s"] = d.up_after(out["leader"], 2, 120)

                # the C ABI: the reference's C program against the port's
                # header and library; its interpreter finds torch and the
                # repo through PYTHONPATH
                lib = build("fdbtpu_c")
                exe = os.path.join(tmp, "c_smoke")
                inc = sysconfig.get_paths()["include"]
                libdir = sysconfig.get_config_var("LIBDIR")
                cc = subprocess.run(
                    ["g++", "-o", exe,
                     os.path.join(d.repo, "bindings", "c", "test_c_smoke.c"),
                     "-I", os.path.join(d.repo, "foundationdb_tpu_torch",
                                        "bindings", "c"), "-I", inc, lib,
                     f"-L{libdir}",
                     "-lpython" + sysconfig.get_config_var("LDVERSION"),
                     f"-Wl,-rpath,{os.path.dirname(lib)}",
                     f"-Wl,-rpath,{libdir}"], capture_output=True, text=True)
                if cc.returncode != 0:
                    fail(f"compiling test_c_smoke.c: {cc.stderr}")
                cenv = dict(d.env, PYTHONPATH=os.pathsep.join(
                    [d.repo, *site.getsitepackages()]))
                tc = time.perf_counter()
                p = subprocess.Popen([exe, d.cf_path], env=cenv,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                out["client_pids"].append(p.pid)
                so, se = p.communicate(timeout=300)
                out["c_smoke_s"] = time.perf_counter() - tc
                out["c_smoke"] = (p.returncode, so.strip(), se[-1500:])
                out["acked"][b"c-key"] = None     # the C program clears it
                # the Python binding over the C ABI, a process of its own
                pybind = os.path.join(d.repo, "foundationdb_tpu_torch",
                                      "bindings", "python")
                script = (
                    "import json, sys\n"
                    f"sys.path[:0] = [{d.repo!r}, {pybind!r}]\n"
                    "import chip_smoke as cs, fdbtpu\n"
                    f"db = fdbtpu.open({d.cf_path!r})\n"
                    "print(json.dumps(cs.binding_observations_c(db, b'c/')))\n")
                tb = time.perf_counter()
                p = subprocess.Popen([sys.executable, "-c", script],
                                     cwd=d.repo, env=cenv,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                out["client_pids"].append(p.pid)
                so, se = p.communicate(timeout=300)
                out["binding_s"] = time.perf_counter() - tb
                if p.returncode != 0:
                    fail(f"the Python binding over the C ABI: {se[-2000:]}")
                out["binding"] = json.loads(so.strip().splitlines()[-1])
                for pre in (b"c/", b"n/"):
                    out["acked"].update({
                        pre + b"bt1": None, pre + b"bt2": b"v2",
                        pre + b"ctr": (12).to_bytes(8, "little")})
                    out["acked"].update({pre + b"rng%02d" % i: b"x%d" % i
                                         for i in range(5)})
                out["read_back"] = d.read_back(sorted(out["acked"]))
            finally:
                out["main"] = d.stop()

            # the second lifetime: the worker-only server killed, the
            # monitor restarts it, and the cluster serves reads again
            d = Deployment(dev_name, os.path.join(tmp, "supervision"),
                           out["client_pids"])
            try:
                d.until("set sup/first 1", "Committed", 300)
                sup = {b"sup/%02d" % i: b"s%d" % i for i in range(8)}
                got = d.cli("; ".join(f"set {k.decode()} {v.decode()}"
                                      for k, v in sup.items()))
                if got.split() != ["Committed"] * 8:
                    fail(f"the CLI's writes: {got}")
                sup[b"sup/first"] = b"1"
                out["sup_acked"] = sup
                victim = out["sup_victim"] = d.ports[3]
                os.kill(d.started()[victim][-1], signal.SIGKILL)
                t1 = time.perf_counter()
                while len(d.started().get(victim, [])) < 2:
                    if time.perf_counter() - t1 > 60:
                        fail("the monitor never restarted the killed server")
                    time.sleep(0.2)
                out["respawn_s"] = time.perf_counter() - t1
                d.until("get sup/05", "`sup/05' is `s5'", 180)
                out["serve_after_restart_s"] = time.perf_counter() - t1
                # the restarted server up (its SIGTERM handler set)
                d.up_after(victim, 2, 240)
                out["sup_read_back"] = d.read_back(sorted(sup))
            finally:
                out["supervision"] = d.stop()
        finally:
            out["connection_timeouts"] = connection_timeouts(tmp)
            get_trace_log().close()
            set_trace_log(prev_log)
            if apps is not None:
                apps.stop()
                out["gpu_pids"], out["gpu_samples"] = apps.pids, apps.samples
                out["smi_apps_max"] = apps.smi_apps_max
    return out


def check_deployment_phase(r: dict, card: str) -> str:
    """Phase 25's gates; returns its one-line result."""
    dv = r["status"]["resolver_device"]
    rc, so, se = r["c_smoke"]

    def shown(k, v):
        return (f"`{k.decode()}': not found" if v is None else
                f"`{k.decode()}' is `{v.decode()}'")
    bad_back = {k: v for acked, back in ((r["acked"], r["read_back"]),
                                         (r["sup_acked"], r["sup_read_back"]))
                for k, v in back.items() if v != shown(k, acked[k])}
    lives = (r["main"], r["supervision"])
    servers = {p for life in lives for pids in life["servers"].values()
               for p in pids}
    say(f"deployment: spawn to the first commit through the CLI "
        f"{r['first_commit_s']:.3f} s; leader {r['leader']} killed with the "
        f"monitor paused, a commit succeeded again after "
        f"{r['failover_s']:.3f} s, the monitor resumed and restarted it in "
        f"{r['leader_restart_s']:.3f} s; worker-only server killed, "
        f"restarted by the monitor in {r['respawn_s']:.3f} s, serving reads "
        f"through the CLI again {r['serve_after_restart_s']:.3f} s after the "
        f"kill ({card})")
    say(f"deployment: failover attempts [start s after the kill, outcome, "
        f"s]: {json.dumps(r['failover_attempts'])}, the first commit "
        f"{r['failover_s']:.3f} s after the SIGKILL; timed-out attempts "
        f"(the requests each was awaiting: endpoint, role and method, the "
        f"sending view's epoch; each coordinator's published epoch then; "
        f"the roles the view placed on the killed server; the killed "
        f"process's state) "
        f"{json.dumps(r.get('timed_out', []))}")
    say(f"deployment: connections cut after their peer's silence "
        f"(ConnectionTimeout: file, peer, phase, silent s, pending; the "
        f"killed leader 127.0.0.1:{r['leader']}, the killed worker-only "
        f"127.0.0.1:{r['sup_victim']}): "
        f"{json.dumps(r['connection_timeouts'])}")
    if "kill_watch" in r:
        say(f"deployment: from the leader's SIGKILL, seconds until the "
            f"killed process was first seen a zombie, holding no "
            f"sockets; its listener gone; no socket at its port; no "
            f"ESTABLISHED socket to it: {json.dumps(r['kill_watch'])}")
    say(f"deployment: status epoch {r['status']['epoch']}, available "
        f"{r['status']['database_available']}, resolver_device "
        f"{json.dumps(dv)}; C smoke rc {rc} `{so}' in {r['c_smoke_s']:.3f} s; "
        f"Python over the C ABI {r['binding_s']:.3f} s, observations equal "
        f"to the native client's {r['binding'] == r['native']}; "
        f"{len(r['read_back']) + len(r['sup_read_back'])} acknowledged keys "
        f"read back, {len(bad_back)} wrong; monitors rc "
        f"{[life['rc'] for life in lives]}, "
        f"{[life['stopped'] for life in lives]}; server logs with a "
        f"traceback {[life['tracebacks'] for life in lives]}")
    if "gpu_pids" in r:
        listed = sorted(r["gpu_pids"] & servers)
        clients = sorted(r["gpu_pids"] & set(r["client_pids"]))
        say(f"deployment: processes holding the card's device files over "
            f"{r['gpu_samples']} samples: servers {listed} of "
            f"{sorted(servers)}; client processes (the CLI's, the C "
            f"program's, the binding's) {clients} of {r['client_pids']}; "
            f"others {sorted(r['gpu_pids'] - servers)}; nvidia-smi listed "
            f"at most {r['smi_apps_max']} compute apps")
        if not listed or clients:
            fail("no server held the card, or a CLI or C ABI client did")
    if rc != 0 or "C ABI SMOKE OK" not in so:
        fail(f"the C smoke program against the port's library: {se}")
    if r["binding"] != r["native"] or r["binding"] != BINDING_EXPECTED:
        fail(f"the Python binding over the C ABI {r['binding']} against the "
             f"native client {r['native']} (expected {BINDING_EXPECTED})")
    if bad_back or len(r["range"]) != 16:
        fail(f"an acknowledged write did not read back: {bad_back}, range "
             f"{r['range']}")
    if dv["pipelined_resolvers"] < 1 or dv["dispatches"] <= 0 \
            or not r["status"]["database_available"]:
        fail("the CLI's status shows no pipelined resolver that dispatched")
    for life in lives:
        if life["rc"] != 0 or len(life["stopped"]) != 4 or any(
                not ln.endswith("rc=0") for ln in life["stopped"]) \
                or life["tracebacks"] or not life["alive"]:
            fail("the monitor or a server did not stop cleanly on SIGTERM: "
                 f"{life['log'][-3000:]}")
    return (f"phase 25: first commit {r['first_commit_s']:.3f} s, failover "
            f"{r['failover_s']:.3f} s, restarts {r['leader_restart_s']:.3f} "
            f"and {r['respawn_s']:.3f} s, C smoke {r['c_smoke_s']:.3f} s, "
            f"binding {r['binding_s']:.3f} s, resolver dispatches "
            f"{dv['dispatches']}, every server stopped rc=0 ({card})")


# --------------------------------------------------------------------------
# phase 32: the elected leader's server stopped (ROADMAP C4)


def stopped_leader_phase(dev_name: str, root: str | None = None) -> dict:
    """Phase 32, a fresh deployment as phase 25 builds it
    (``Deployment``: the port's fdbmonitor over three coordinator
    servers and a worker-only fourth, each ``device = <dev_name>``): the
    first commit through the CLI and 16 writes; then the elected
    leader's server SIGSTOPped with the monitor paused, a process that
    keeps its sockets open and answers nothing, and the set after the
    stop attempted as phase 25 attempts it (``attempts_after``); the
    stopped server then gets SIGCONT and SIGKILL, and the monitor,
    resumed, restarts it; every acknowledged write read back through the
    CLI; SIGTERM."""
    import signal

    from foundationdb_tpu_torch.cli import open_cli
    from foundationdb_tpu_torch.rpc.stubs import ROLE_METHODS
    from foundationdb_tpu_torch.rpc.transport import WLTOKEN_COORDINATOR
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.runtime.trace import (TraceLog,
                                                      get_trace_log,
                                                      set_trace_log)

    out: dict = {"client_pids": []}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        prev_log = get_trace_log()
        set_trace_log(TraceLog(path=os.path.join(tmp, "client.jsonl")))
        try:
            d = Deployment(dev_name, os.path.join(tmp, "stop"),
                           out["client_pids"])
            try:
                d.until("set first 1", "Committed", 300)
                out["first_commit_s"] = time.perf_counter() - d.t0
                writes = {b"stop/%02d" % i: b"v%d" % i for i in range(16)}
                got = d.cli("; ".join(f"set {k.decode()} {v.decode()}"
                                      for k, v in writes.items()))
                if got.split() != ["Committed"] * 16:
                    fail(f"the CLI's writes: {got}")
                out["acked"] = {b"first": b"1", **writes}

                async def failover():
                    cli_ = await open_cli(d.cf_path, Knobs(), timeout=60)
                    waits = OutstandingRequests(
                        cli_.view.transport, lambda: cli_.view,
                        ROLE_METHODS, WLTOKEN_COORDINATOR)
                    out["leader"] = await elected_leader(d)
                    await attempts_after(d, cli_, waits, out["leader"],
                                         signal.SIGSTOP, out,
                                         "stopped leader", 120)
                    await cli_.view.transport.close()
                asyncio.run(asyncio.wait_for(failover(), 300))
                out["acked"][b"after"] = b"failover"
                # the monitor resumed: it restarts the killed server
                out["leader_restart_s"] = d.up_after(out["leader"], 2, 120)
                out["read_back"] = d.read_back(sorted(out["acked"]))
            finally:
                out["life"] = d.stop()
        finally:
            out["connection_timeouts"] = connection_timeouts(tmp)
            get_trace_log().close()
            set_trace_log(prev_log)
    return out


def check_stopped_leader_phase(r: dict, card: str) -> str:
    """Phase 32's gates: the first attempt after the SIGSTOP commits,
    every acknowledged write reads back, connections are cut only to
    the stopped server's address, and every server stops rc=0 on
    SIGTERM; returns its one-line result."""
    bad_back = {k: v for k, v in r["read_back"].items()
                if v != f"`{k.decode()}' is `{r['acked'][k].decode()}'"}
    life = r["life"]
    stopped = f"127.0.0.1:{r['leader']}"
    cut_elsewhere = [c for c in r["connection_timeouts"] if c[1] != stopped]
    say(f"stopped leader: spawn to the first commit through the CLI "
        f"{r['first_commit_s']:.3f} s; leader {r['leader']} SIGSTOPped with "
        f"the monitor paused; failover attempts [start s after the stop, "
        f"outcome, s]: {json.dumps(r['failover_attempts'])}, the first "
        f"commit {r['failover_s']:.3f} s after the SIGSTOP; the server "
        f"then SIGKILLed and restarted by the monitor in "
        f"{r['leader_restart_s']:.3f} s ({card})")
    say(f"stopped leader: timed-out attempts "
        f"{json.dumps(r.get('timed_out', []))}; connections cut after "
        f"their peer's silence (file, peer, phase, silent s, pending; the "
        f"stopped server {stopped}): {json.dumps(r['connection_timeouts'])}")
    say(f"stopped leader: {len(r['read_back'])} acknowledged keys read "
        f"back, {len(bad_back)} wrong; monitor rc {life['rc']}, "
        f"{life['stopped']}; server logs with a traceback "
        f"{life['tracebacks']}")
    if r["failover_attempts"][0][1] != "committed":
        fail(f"phase 32: the first attempt after the leader's SIGSTOP did "
             f"not commit: {json.dumps(r['failover_attempts'])}")
    if bad_back:
        fail(f"phase 32: an acknowledged write did not read back: "
             f"{bad_back}")
    if cut_elsewhere:
        fail(f"phase 32: a connection to a live server was cut: "
             f"{cut_elsewhere}")
    if life["rc"] != 0 or len(life["stopped"]) != 4 or any(
            not ln.endswith("rc=0") for ln in life["stopped"]) \
            or life["tracebacks"] or not life["alive"]:
        fail("phase 32: the monitor or a server did not stop cleanly on "
             f"SIGTERM: {life['log'][-3000:]}")
    return (f"phase 32: first commit {r['first_commit_s']:.3f} s, the "
            f"first attempt after the leader's SIGSTOP committed "
            f"{r['failover_s']:.3f} s after it, restart "
            f"{r['leader_restart_s']:.3f} s, {len(r['read_back'])} keys read "
            f"back, every server stopped rc=0 ({card})")


# --------------------------------------------------------------------------
# phase 33: a rolling restart of the coordinators' servers (ROADMAP C6)

# seconds from a kill's last attempt to the next kill
ROLLING_GAP_S = 5.0
# seconds of attempts after a kill before the next kill: one attempt of
# 30 s, or more if they end sooner
ROLLING_BUDGET_S = 30.0
# seconds the fresh CLI's read-back of every acknowledged write may take
ROLLING_READ_S = 30.0


RECOVERY_EVENTS = ('"RecoveryComplete"', '"RecoveryState"',
                   '"RecoveryFailed"', '"StorageMoveRecruited"',
                   '"FetchKeysComplete"')


def recovery_record(tmp: str, ports: list, replication: int = 2) -> dict:
    """What a deployment's server logs (``fdbserver.<port>.log`` under
    ``tmp``, each appended to by every process the monitor started for
    that server) say of its recoveries, in the order of their times:
    ``recovery_complete``, [server index, epoch] of each
    ``RecoveryComplete``; ``foundings``, the founding at boot and one
    more for each ``RecoveryState`` step ``locking_cstate`` with
    ``PrevEpoch`` 0 after the first ``accepting_commits`` (a recovery
    that read the coordinated state as empty, and so began a new, empty
    database), each of those in ``refounded`` as [server index, epoch];
    ``unfetched``, [tag, begin, end] (the keys as Python literals) of
    each storage tag whose last ``StorageMoveRecruited`` (a recovery's
    new replica of a shard, filled from a replica of the last
    generation) no ``FetchKeysComplete`` followed: its source was a
    replica that a restart had emptied, and where it was the shard's
    last, a read in the shard waits for good (ROADMAP C2;
    ``unfetched_holds``);
    ``no_source``, [server index, time] of the first recovery attempt
    that failed on a shard with no live replica to fill a new one from,
    after which none completed (C2: every later attempt fails alike), or
    None;
    ``unserved``, [begin, end] of each shard of the boot layout (the
    controller's even split, teams of ``replication`` tags in order)
    none of whose tags the last completed recovery made active: each
    replica it still counts sat on a server that was down at that
    recovery, and a server restarts without its storage, so a read in
    the shard waits for good (C2; ``unfetched_holds``)."""
    events = []
    for i, port in enumerate(ports):
        path = os.path.join(tmp, f"fdbserver.{port}.log")
        if not os.path.exists(path):
            continue
        with open(path, errors="replace") as f:
            for ln in f:
                if not any(e in ln for e in RECOVERY_EVENTS):
                    continue
                try:
                    ev = json.loads(ln)
                except ValueError:
                    continue
                events.append((ev.get("Time", 0.0), i, ev))
    events.sort(key=lambda e: e[:2])
    complete, refounded, accepting = [], [], False
    no_source = None
    moved: dict = {}
    boot, active = None, {}
    for t, i, ev in events:
        kind = ev.get("Type")
        if kind == "RecoveryFailed":
            if ev.get("Msg") == "no live source for moved shard" \
                    and no_source is None:
                no_source = [i, t]
        elif kind == "RecoveryComplete":
            complete.append([i, ev.get("Epoch")])
            no_source = None
        elif kind == "StorageMoveRecruited":
            moved[ev.get("Tag")] = [ev.get("Begin"), ev.get("End")]
        elif kind == "FetchKeysComplete":
            moved[ev.get("Tag")] = None
        elif ev.get("Step") == "writing_cstate" and boot is None:
            boot = ev.get("StorageTags")
        elif ev.get("Step") == "accepting_commits":
            accepting = True
            active[ev.get("Epoch")] = set(ev.get("ActiveTags", ()))
        elif ev.get("Step") == "locking_cstate" and accepting \
                and ev.get("PrevEpoch") == 0:
            refounded.append([i, ev.get("Epoch")])
    return {"recovery_complete": complete, "foundings": 1 + len(refounded),
            "refounded": refounded,
            "unfetched": sorted([t, *r] for t, r in moved.items() if r),
            "no_source": no_source,
            "unserved": unserved_shards(boot, active.get(
                complete[-1][1] if complete else None), replication)}


def unserved_shards(boot: list | None, active: set | None,
                    replication: int) -> list:
    """[begin, end] (Python literals) of each shard of the boot layout
    (``boot``, the first generation's storage tags, split as the
    controller splits them: ``ShardMap.even`` over teams of
    ``replication`` consecutive tags) with no tag in ``active``."""
    from foundationdb_tpu_torch.core.shard_map import ShardMap
    if not boot or active is None:
        return []
    teams = [boot[i:i + replication] for i in range(0, len(boot),
                                                    replication)]
    m = ShardMap.even(len(teams), teams)
    edges = [b"", *m.boundaries, m.keyspace_end]
    return [[repr(edges[s]), repr(edges[s + 1])]
            for s, team in enumerate(teams) if not active & set(team)]


def rolling_errors(r: dict) -> list:
    """The gates of a rolling restart's record (``rolling_kills``, its
    read-back, ``recovery_record``, the monitor's ``stopped`` lines and
    exit code): one founding; the first attempt after each kill commits,
    unless by the end of its attempts recoveries had begun to fail for
    good on a shard with no replica left (``no_source``, ROADMAP C2);
    every acknowledged write reads back (``read_back_error``); every
    server stops rc=0 on SIGTERM.  Returns the failures, each a line."""
    rec, errs = r["recoveries"], []
    stuck = rec["no_source"]
    if rec["foundings"] != 1:
        errs.append(f"a recovery founded a second, empty database: "
                    f"{rec['refounded']}")
    for i, k in enumerate(r["kills"]):
        last = k["attempts"][-1]
        if k["attempts"][0][1] != "committed" and not (
                stuck and stuck[1] <= k["killed_at"] + last[0] + last[2]):
            errs.append(f"the first attempt after kill {i} did not "
                        f"commit: {k['attempts']}")
    err = read_back_error(r["read_back"], rec, r["acked"])
    if err is not None:
        errs.append(err)
    if r["monitor_rc"] != 0 or len(r["stopped"]) != 4 or not all(
            ln.endswith("rc=0") for ln in r["stopped"]):
        errs.append(f"the monitor or a server did not stop cleanly on "
                    f"SIGTERM: rc {r['monitor_rc']}, {r['stopped']}")
    return errs


def read_back_of(got: str | None, acked: dict) -> dict:
    """The record of a fresh CLI's ``get`` of each of ``acked``'s keys in
    sorted order (``acked``: key to value, as text), from what it printed
    (``got``: its output, or "rc=N ..." where it exited with an error;
    None where it did not end within ROLLING_READ_S): ``{"wrong": {key:
    what the CLI printed}}``, ``{"failed": the end of its output}`` or
    ``{"hung": s}``."""
    if got is None:
        return {"hung": ROLLING_READ_S}
    lines = got.rstrip("\n").split("\n")
    if got.startswith("rc=") or len(lines) != len(acked):
        return {"failed": got[-400:]}
    return {"wrong": {k: g for k, g in zip(sorted(acked), lines)
                      if g != f"`{k}' is `{acked[k]}'"}}


def read_back_error(rb: dict, rec: dict, acked: dict) -> str | None:
    """Why a rolling restart's read-back of its acknowledged writes
    (``acked``; ``rb``, ``read_back_of``'s record) fails its gate, or
    None.  A wrong or missing value always fails.  The signs of a shard left
    without a replica (ROADMAP C2, not a fault of the coordinated state)
    excuse the rest: a CLI that failed on ``no storage team for key``
    (the shard's every replica dropped from its team), and one that hung
    where the recovery record shows a new replica of an acknowledged
    key's shard that never filled (``unfetched``), a shard of one whose
    every replica the last generation counts was lost to a restart
    (``unserved``), or a recovery that could not proceed for want of a
    source (``no_source``)."""
    if "failed" in rb:
        return None if "no storage team for key" in rb["failed"] \
            else f"the read-back failed: {rb['failed']}"
    if "hung" not in rb:
        return f"acknowledged writes read back wrong: {rb['wrong']}" \
            if rb["wrong"] else None
    if rec["no_source"] or any(unfetched_holds(rec, k.encode())
                               for k in acked):
        return None
    return (f"the read-back hung {rb['hung']} s, and the server logs "
            f"show no shard left without a replica: {rec}")


def unfetched_holds(rec: dict, key: bytes) -> bool:
    """Whether ``key`` lies in a shard whose new replica
    ``recovery_record`` found never filled (``unfetched``), or in one
    whose every replica the last generation counts was lost to a restart
    (``unserved``)."""
    import ast
    return any(ast.literal_eval(b) <= key < ast.literal_eval(e)
               for *_, b, e in rec["unfetched"] + rec["unserved"])


async def rolling_kills(cli_, waits, victims: list, ports: list, pid_of,
                        out: dict, label: str, budget: float) -> None:
    """A rolling restart under a running monitor, through one long-lived
    client ``cli_``: after its commit of ``rolling/start``, each server of
    ``victims`` (ports) in turn is SIGKILLed (its process
    ``pid_of(port)``), ROLLING_GAP_S after the last attempt that followed
    the previous kill; the monitor restarts it at once, an empty
    coordinator, TLog and storage host.  After each kill ``set
    rolling/<i> after<i>`` goes through ``cli_`` until it commits or
    ``budget`` s have passed (``attempt``, 0.25 s apart).  ``out["kills"]``:
    each kill's victim (its index in ``ports``), ``killed_at`` (the
    monotonic clock, the servers' trace times), attempts, timed-out
    attempts' records and ``failover_s`` (None: no commit within the
    budget); ``out["acked"]``: each key the client committed, with its
    value."""
    import signal
    acked = out.setdefault("acked", {})
    got = await asyncio.wait_for(cli_.execute("set rolling/start 1"), 60)
    if got != "Committed":
        raise RuntimeError(f"{label}: the client's first commit: {got}")
    acked["rolling/start"] = "1"
    kills = out.setdefault("kills", [])
    last = time.perf_counter()
    for i, port in enumerate(victims):
        await asyncio.sleep(max(0.0, last + ROLLING_GAP_S
                                - time.perf_counter()))
        victim = pid_of(port)
        os.kill(victim, signal.SIGKILL)
        tk = time.perf_counter()
        k = {"victim": ports.index(port), "killed_at": time.monotonic(),
             "attempts": [], "timed_out": [], "failover_s": None}
        kills.append(k)
        key, value = f"rolling/{i}", f"after{i}"
        while True:
            try:
                got = await attempt(cli_, waits, f"set {key} {value}", tk,
                                    port, victim, k["attempts"],
                                    k["timed_out"], f"{label}, kill {i}")
            except Exception:  # noqa: BLE001 — recorded as its outcome
                got = None
            if got == "Committed":
                k["failover_s"] = time.perf_counter() - tk
                acked[key] = value
                break
            if time.perf_counter() - tk > budget:
                break
            await asyncio.sleep(0.25)
        last = time.perf_counter()


def rolling_phase(dev_name: str, keep: str | None = None) -> dict:
    """Phase 33, a fresh deployment as phase 25 builds it
    (``Deployment``): the first commit through the CLI and 16 writes;
    then, with the monitor running, the three coordinators' servers
    SIGKILLed in turn, each restarted at once, empty (``rolling_kills``,
    through one long-lived client); every acknowledged write read back
    through a fresh CLI; what the server logs say of the recoveries
    (``recovery_record``); SIGTERM.  With ``keep`` the run's files
    (the server logs among them) stay in a new directory there."""
    from foundationdb_tpu_torch.cli import open_cli
    from foundationdb_tpu_torch.rpc.stubs import ROLE_METHODS
    from foundationdb_tpu_torch.rpc.transport import WLTOKEN_COORDINATOR
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.runtime.trace import (TraceLog,
                                                      get_trace_log,
                                                      set_trace_log)

    out: dict = {"client_pids": []}
    t_phase = time.perf_counter()
    with (contextlib.nullcontext(tempfile.mkdtemp(dir=keep)) if keep
          else tempfile.TemporaryDirectory()) as tmp:
        prev_log = get_trace_log()
        set_trace_log(TraceLog(path=os.path.join(tmp, "client.jsonl")))
        try:
            d = Deployment(dev_name, os.path.join(tmp, "rolling"),
                           out["client_pids"])
            try:
                d.until("set first 1", "Committed", 300)
                out["first_commit_s"] = time.perf_counter() - d.t0
                writes = {f"rolling/w{i:02d}": f"v{i}" for i in range(16)}
                got = d.cli("; ".join(f"set {k} {v}"
                                      for k, v in writes.items()))
                if got.split() != ["Committed"] * 16:
                    fail(f"the CLI's writes: {got}")
                out["acked"] = {"first": "1", **writes}

                async def rolling():
                    cli_ = await open_cli(d.cf_path, Knobs(), timeout=60)
                    waits = OutstandingRequests(
                        cli_.view.transport, lambda: cli_.view,
                        ROLE_METHODS, WLTOKEN_COORDINATOR)
                    try:
                        await rolling_kills(
                            cli_, waits, d.ports[:3], d.ports,
                            lambda p: d.started()[p][-1], out,
                            "rolling restart", left(ROLLING_BUDGET_S))
                    finally:
                        await cli_.view.transport.close()
                t = time.perf_counter()
                try:
                    asyncio.run(asyncio.wait_for(rolling(), left(600)))
                except (RuntimeError, asyncio.TimeoutError) as e:
                    fail(f"phase 33: {e!r}")
                out["kills_s"] = time.perf_counter() - t
                # every server restarted before the read-back and the
                # SIGTERM (one in its start-up would die of the signal)
                for p in d.ports[:3]:
                    d.up_after(p, 2, 120)
                got = d.cli("; ".join(f"get {k}"
                                      for k in sorted(out["acked"])),
                            timeout=ROLLING_READ_S)
                # rc -9: killed at its timeout
                out["read_back"] = read_back_of(
                    None if got.startswith("rc=-9 ") else got, out["acked"])
            finally:
                out["life"] = d.stop()
                out["recoveries"] = recovery_record(d.tmp, d.ports)
        finally:
            get_trace_log().close()
            set_trace_log(prev_log)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def rolling_child(dev_name: str, path: str, start: str) -> None:
    """Phase 33 in a process of its own (``rolling_start``): its record
    as JSON in ``path``; ``start`` is the smoke's start on the shared
    monotonic clock, from which its waits count."""
    _START[0] = float(start)
    r = rolling_phase(dev_name)
    with open(path, "w") as f:
        json.dump(r, f)


def rolling_start(tmp: str) -> dict:
    """Start phase 33 on the card in a process of its own
    (``rolling_child``, its process group killed if this process exits
    first), so that it runs beside phases 23 and 24."""
    import atexit
    import signal
    repo = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(tmp, "rolling.json")
    with open(path + ".out", "w") as out, open(path + ".err", "w") as err:
        p = subprocess.Popen(
            [sys.executable, os.path.join(repo, "chip_smoke.py"),
             "--rolling", "cuda", path, repr(_START[0])], cwd=repo,
            env=dict(os.environ, PYTHONPATH=repo), stdout=out, stderr=err,
            start_new_session=True)

    def stop(p=p):
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    atexit.register(stop)
    return {"p": p, "path": path, "stop": stop}


def rolling_finish(h: dict) -> dict:
    """Wait for phase 33's process (``rolling_start``) and print what it
    printed; returns its record."""
    try:
        h["p"].wait(timeout=left(300))
    except subprocess.TimeoutExpired:
        h["stop"]()
        fail("phase 33: still running at the smoke's deadline")
    with open(h["path"] + ".out") as f:
        for ln in f.read().splitlines():
            say(ln)
    if h["p"].returncode != 0:
        with open(h["path"] + ".err") as f:
            fail(f"phase 33: rc {h['p'].returncode}: {f.read()[-3000:]}")
    with open(h["path"]) as f:
        return json.load(f)


def check_rolling_phase(r: dict, card: str) -> str:
    """Phase 33's gates (``rolling_errors``): one founding; the first
    attempt after each kill commits; every acknowledged write reads back
    through a fresh CLI; every server stops rc=0 on SIGTERM and no
    server log holds a traceback.  A shard left without a replica
    (ROADMAP C2) excuses a first attempt and a read-back that wait on
    it.  Returns its one-line result."""
    life, rec, rb = r["life"], r["recoveries"], r["read_back"]
    for i, k in enumerate(r["kills"]):
        fo = k["failover_s"]
        say(f"rolling restart: kill {i}, server {k['victim']}: attempts "
            f"[start s after the SIGKILL, outcome, s] "
            f"{json.dumps(k['attempts'])}, failover "
            f"{'none' if fo is None else f'{fo:.3f} s'}; timed-out "
            f"attempts {json.dumps(k['timed_out'])}")
    say(f"rolling restart: RecoveryComplete [server, epoch] "
        f"{json.dumps(rec['recovery_complete'])}; foundings "
        f"{rec['foundings']} (later ones {json.dumps(rec['refounded'])}); "
        f"new replicas never filled [tag, begin, end] "
        f"{json.dumps(rec['unfetched'])}; recoveries stuck without a "
        f"source since [server, time] {json.dumps(rec['no_source'])}; "
        f"read-back of "
        f"{len(r['acked'])} acknowledged keys {json.dumps(rb)}; monitor "
        f"rc {life['rc']}, {life['stopped']}; server logs with a "
        f"traceback {life['tracebacks']} ({card})")
    errs = rolling_errors(dict(r, stopped=life["stopped"],
                               monitor_rc=life["rc"]))
    if life["tracebacks"] or not life["alive"]:
        errs.append(f"the monitor had exited, or a server log holds a "
                    f"traceback: {life['log'][-3000:]}")
    if errs:
        fail(f"phase 33: {'; '.join(errs)}")
    back = f"{len(r['acked'])} keys read back" if "wrong" in rb \
        else f"read-back {next(iter(rb))} (a shard without a replica: C2)"
    firsts = [k["attempts"][0][1] for k in r["kills"]]
    fos = [k["failover_s"] and round(k["failover_s"], 3) for k in r["kills"]]
    return (f"phase 33: first commit {r['first_commit_s']:.3f} s, three "
            f"coordinators' servers killed in turn in {r['kills_s']:.3f} s, "
            f"first attempts {firsts} (failovers {fos} s), epochs completed "
            f"{[e for _, e in rec['recovery_complete']]}, one founding, "
            f"{back}, every server stopped rc=0 ({card})")


# --------------------------------------------------------------------------
# phase 26: the seed farm on the card


# the smoke's time limit sets the depths: the card runs seeds 0..15 at
# --jobs 8, 0..7 at --jobs 4 and 0..1 at --jobs 1; the CPU twin runs
# seeds 0..15 at --jobs 2 beside the north star's device stages
FARM_SEEDS = 16             # seeds 0..15 of run_one's default chaos mix
FARM_SEEDS_ONE_JOB = 2
FARM_SEEDS_FOUR_JOBS = 8
FARM_TWIN_JOBS = 2
HOST_FIELDS = ("elapsed", "device_peak_bytes", "kernel_launches", "stderr")


def farm_start(path: str, dev_name: str, jobs: int, seeds: int) -> dict:
    """Start ``python3 -m foundationdb_tpu_torch.tools.seed_farm`` on
    ``dev_name`` at ``--jobs`` over seeds 0..``seeds``-1, each seed's
    result kept in ``path``, as a process group of its own (killed if
    this process exits first); a CPU farm's children keep one torch
    thread each."""
    import atexit
    import signal
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    if dev_name == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    h = {"device": dev_name, "jobs": jobs, "path": path,
         "t0": time.perf_counter()}
    # files, not pipes: nothing reads a farm's output until its end
    with open(path + ".out", "w") as out, open(path + ".err", "w") as err:
        h["p"] = subprocess.Popen(
            [sys.executable, "-m", "foundationdb_tpu_torch.tools.seed_farm",
             "--device", dev_name, "--jobs", str(jobs), "--seeds",
             str(seeds), "--out", path], cwd=repo, env=env, stdout=out,
            stderr=err, start_new_session=True)

    def stop(p=h["p"]):
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    atexit.register(stop)
    h["stop"] = stop
    return h


def farm_finish(h: dict) -> dict:
    """Wait for a farm (killed at the run's deadline): its summary, each
    seed's result and its wall seconds."""
    try:
        rc = h["p"].wait(timeout=left(900))
    except subprocess.TimeoutExpired:
        h["stop"]()
        fail(f"seed farm --device {h['device']} --jobs {h['jobs']}: still "
             f"running at the smoke's deadline")
    with open(h["path"] + ".out") as f:
        out = f.read()
    with open(h["path"] + ".err", errors="replace") as f:
        err = f.read()
    if rc not in (0, 1) or "{" not in out:
        fail(f"seed farm --device {h['device']} --jobs {h['jobs']}: rc {rc} "
             f"{err[-2000:]}")
    return {"device": h["device"], "jobs": h["jobs"],
            "summary": json.loads(out[out.index("{"):]),
            "seeds": [json.loads(ln) for ln in open(h["path"])],
            "wall_s": time.perf_counter() - h["t0"]}


def farm_phase(tmp: str, twin: dict, dev_name: str = "cuda",
               seeds: int = FARM_SEEDS,
               seeds_one_job: int = FARM_SEEDS_ONE_JOB,
               seeds_four_jobs: int = FARM_SEEDS_FOUR_JOBS) -> list:
    """Phase 26: the seed farm on ``dev_name`` at --jobs 1 (the first
    ``seeds_one_job`` seeds), 4 (the first ``seeds_four_jobs``) and 8,
    one after another, then the CPU twin started earlier (``twin``,
    ``farm_start``) last."""
    runs = []
    for jobs, n in ((1, seeds_one_job), (4, seeds_four_jobs), (8, seeds)):
        runs.append(farm_finish(farm_start(
            os.path.join(tmp, f"farm-{len(runs)}.jsonl"), dev_name, jobs,
            n)))
    return runs + [farm_finish(twin)]


def tools_phase(card_trace: str, cpu_trace: str) -> dict:
    """The port's trace_tool and metrics_tool command lines (``--json``)
    over one chaos seed's trace from the card and the same seed's from
    the CPU (phase 23's seed 0)."""
    import contextlib
    import io

    from foundationdb_tpu_torch.tools import metrics_tool, trace_tool
    out = {}
    for where, path in (("card", card_trace), ("cpu", cpu_trace)):
        rep = {}
        for name, main_, argv in (
                ("trace", trace_tool.main, [path, "--json"]),
                ("metrics", metrics_tool.main, ["summary", path, "--json"]),
                ("recovery", metrics_tool.main, ["recovery", path, "--json"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main_(argv)
            if rc != 0:
                fail(f"{name} tool over {path}: rc {rc}")
            rep[name] = json.loads(buf.getvalue())
        out[where] = rep
    return out


def _no_host_clock(x):
    """A tool's report without the fields taken on the host's clock."""
    if isinstance(x, dict):
        return {k: _no_host_clock(v) for k, v in x.items()
                if not k.endswith(("_ms", "_us", "_s", "_seconds"))}
    if isinstance(x, list):
        return [_no_host_clock(v) for v in x]
    return x


def check_farm_phase(runs: list, tools: dict, card: str) -> str:
    """Phase 26's gates; returns its one-line result."""
    cpu = {r["seed"]: r for r in runs[-1]["seeds"]}

    def outcome(r):
        return {k: v for k, v in r.items() if k not in HOST_FIELDS}
    rates = {}
    for i, run in enumerate(runs):
        dev_, jobs, s = run["device"], run["jobs"], run["summary"]
        rates[f"{dev_}/{jobs}"] = s["seeds_per_minute"]
        say(f"seed farm --device {dev_} --jobs {jobs}: {s['seeds']} seeds, "
            f"{s['ok']} ok, {s['seeds_per_minute']:.4f} seeds/min "
            f"({s['elapsed_s']} s); failure buckets "
            f"{json.dumps(s['failure_buckets'])} ({card})")
        if i == len(runs) - 1:
            continue
        peaks = [r.get("device_peak_bytes") for r in run["seeds"]]
        k1 = [r.get("kernel_launches", {}).get("commit_chain", 0)
              for r in run["seeds"]]
        k3 = [r.get("kernel_launches", {}).get("hist_check", 0)
              for r in run["seeds"]]
        say(f"seed farm --device {dev_} --jobs {jobs}: each child's peak "
            f"allocated bytes {peaks}; K1 launches {k1}")
        diff = [r["seed"] for r in run["seeds"]
                if outcome(r) != outcome(cpu[r["seed"]])]
        if diff:
            fail(f"seed farm --jobs {jobs}: seeds {diff} differ between the "
                 f"card and the CPU: {[run['seeds'][s] for s in diff][:1]}")
        if dev_ == "cuda" and any(r["ok"] and (k != m or not k) for r, k, m
                                  in zip(run["seeds"], k1, k3)):
            fail(f"a seed on the card launched K1 {k1} and K3 {k3}")
        cpu_buckets = {}
        for r in cpu.values():
            if not r["ok"] and r["seed"] < s["seeds"]:
                cpu_buckets.setdefault(r["error"][:120], []).append(r["seed"])
        if s["failure_buckets"] != {k: sorted(v)
                                    for k, v in cpu_buckets.items()}:
            fail(f"the card's failure buckets {s['failure_buckets']} differ "
                 f"from the CPU's {cpu_buckets}")
    both = [(r["seed"], r["error"][:120]) for r in cpu.values()
            if not r["ok"]]
    say(f"seed farm: seeds failing on the card and the CPU alike (seed, "
        f"bucket): {both}")
    if runs[-1]["summary"]["ok"] == 0:
        fail("no seed passed on the CPU")
    c, p = tools["card"], tools["cpu"]
    eq = {k: _no_host_clock(c[k]) == _no_host_clock(p[k]) for k in c}
    say(f"trace tools over chaos seed 0's trace, card against cpu: "
        f"summaries equal without the clock fields {eq}, with them "
        f"{c == p}; trace_tool "
        f"{json.dumps(c['trace'])[:300]}; metrics_tool summary "
        f"{json.dumps(c['metrics'])[:300]}")
    if not all(eq.values()):
        fail("the trace tools' summaries of the card's and the CPU's traces "
             "differ")
    return (f"phase 26: seeds/min {json.dumps(rates)}, card results equal "
            f"to the CPU's, trace summaries equal ({card})")


# --------------------------------------------------------------------------
# phase 27: the resolve stage of the perf smoke


def _cloned(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_cloned(v) for v in x)
    if isinstance(x, dict):
        return {k: _cloned(v) for k, v in x.items()}
    return x


def held_to_plain_resolver():
    """Records every K3 (hist_check) and K1 (commit_chain) call the
    resolver makes: the fused group's two launches a batch
    (``GroupLaunches.run``) and the single-batch core's wrapper calls.
    Each record keeps copies, taken on the stream in order, of the
    call's inputs before it and of its outputs after it, for
    ``resolver_calls_err``.  Returns (calls, restore)."""
    import inspect

    from foundationdb_tpu_torch.ops import conflict_torch as CT
    from foundationdb_tpu_torch.ops import kernels as K
    calls: list = []
    real_run, real_h, real_c = K.GroupLaunches.run, CT.hist_check, \
        CT.commit_chain
    sig_h, sig_c = inspect.signature(real_h), inspect.signature(real_c)
    K1_OUT = ("verdicts", "committed", "slab")

    def k1_record(c: dict, version, version_t):
        calls.append(("commit_chain",
                      _cloned({k: v for k, v in c.items() if k not in K1_OUT
                               and k not in ("version", "version_t")}),
                      _cloned({k: c.get(k) for k in K1_OUT}),
                      version if version_t is None else version_t.clone()))

    def run(self, k, version, version_t):
        h, c = self.views(k)
        hin = _cloned(h)
        real_run(self, k, version, version_t)
        calls.append(("hist_check", hin, h["hit"].clone()))
        k1_record(c, version, version_t)

    def hist_check(*a, **kw):
        b = sig_h.bind(*a, **kw)
        b.apply_defaults()
        hin = _cloned(dict(b.arguments))
        out = real_h(*a, **kw)
        calls.append(("hist_check", hin, b.arguments["hit"].clone()))
        return out

    def commit_chain(*a, **kw):
        b = sig_c.bind(*a, **kw)
        b.apply_defaults()
        out = real_c(*a, **kw)
        k1_record(dict(b.arguments), b.arguments["version"],
                  b.arguments["version_t"])
        return out

    def restore():
        K.GroupLaunches.run = real_run
        CT.hist_check, CT.commit_chain = real_h, real_c
    K.GroupLaunches.run = run
    CT.hist_check, CT.commit_chain = hist_check, commit_chain
    return calls, restore


def resolver_calls_err(calls) -> dict:
    """Each recorded K3 and K1 call against its plain version on the
    recorded tensors: {kernel: (calls, max abs error)}."""
    import torch

    from foundationdb_tpu_torch.ops import kernels as K
    out = {"hist_check": [0, 0], "commit_chain": [0, 0]}
    for name, a, got, *rest in calls:
        if name == "hist_check":
            want = a["hit"] | K.hist_check_select_plain(
                a["rb"], a["re"], a["snap"], a["width"], a["points"],
                a["full"], a.get("window"), a.get("edge"),
                a.get("floor")).to(torch.int32)
            err = int((want - got).abs().max())
        else:
            v, c, sb, se = K.commit_chain_plain(
                a["rb"], a["re"], a["wb"], a["we"], a["hit"], a["snap"],
                a["floor"], a["width"], a["points"])
            errs = [(v.to(torch.int32) - got["verdicts"].to(torch.int32))
                    .abs().max(),
                    (c.to(torch.int32) - got["committed"].to(torch.int32))
                    .abs().max()]
            if got["slab"] is not None:
                slab_b, slab_e, slab_v = got["slab"]
                errs += [(sb - slab_b).abs().max(), (se - slab_e).abs().max()]
                if slab_v is not None:
                    version = rest[0]
                    errs.append((slab_v - (version if isinstance(
                        version, int) else version.reshape(()))).abs().max())
            err = int(max(int(e) for e in errs))
        out[name][0] += 1
        out[name][1] = max(out[name][1], err)
    return out


def resolve_stage_phase(dev) -> dict:
    """Phase 27: the port's perf_smoke resolve stage with its ``cuda``
    backend on ``dev``, at the reference's shapes (96 batches of 16 txns
    of up to 2 point ranges, 16-byte keys, a ring of 2048 slots, a window
    of 64): timed, with its launches counted; then the same stage again
    with every K3 and K1 call recorded and held to its plain version."""
    from foundationdb_tpu_torch.ops import kernels as K
    from foundationdb_tpu_torch.tools import perf_smoke as ps
    K.reset_launches()
    elapsed, stats = ps.resolve_pipeline_seconds(
        device=dev, deadline_s=ps.RESOLVE_BUDGET_S)
    sync(dev)
    got = {k: v.launches for k, v in K.KERNELS.items()}
    calls, restore = held_to_plain_resolver()
    K.reset_launches()
    try:
        _, again = ps.resolve_pipeline_seconds(
            device=dev, deadline_s=ps.RESOLVE_BUDGET_S)
        sync(dev)
    finally:
        restore()
    got_again = {k: v.launches for k, v in K.KERNELS.items()}
    return {"elapsed_s": elapsed, "stats": stats, "launches": got,
            "launches_again": got_again,
            "again_equal": again["verdicts"] == stats["verdicts"],
            "errors": resolver_calls_err(calls),
            "floor": ps.RESOLVE_AB_FLOOR}


def check_resolve_stage(r: dict, card: str = "") -> str:
    """Phase 27's gates; returns its one-line result."""
    s, got, err = r["stats"], r["launches"], r["errors"]
    say(f"resolve stage on {s['device']}: {s['n_txns']} txns, verdicts equal "
        f"to the numpy twin, {s['too_old_verdicts']} TOO_OLD; pipelined "
        f"{s['pipelined_txns_per_sec']:.3f} txns/s, unpipelined "
        f"{s['unpipelined_txns_per_sec']:.3f} txns/s, speedup "
        f"{s['speedup']:.4f} (the reference's floor {r['floor']}); "
        f"{s['dispatches']} dispatches, group mean {s['group_mean']}, "
        f"{s['dispatch_us_per_batch']:.1f} host us a batch; "
        f"{r['elapsed_s']:.3f} s; launches {got}; the recorded rerun's "
        f"launches {r['launches_again']}, verdicts equal "
        f"{r['again_equal']}, calls held to the plain versions (calls, "
        f"max_abs_err) {err} ({card})")
    if s["too_old_verdicts"] <= 0:
        fail("the resolve stage produced no TOO_OLD verdict")
    if got["commit_chain"] != got["hist_check"] or got["commit_chain"] == 0:
        fail(f"the resolve stage launched {got}")
    if not r["again_equal"] or any(
            err[k][0] != r["launches_again"][k] or err[k][1]
            for k in err):
        fail("a K3 or K1 call of the resolve stage differs from its plain "
             "version, or a launch went unrecorded")
    return (f"phase 27: pipelined {s['pipelined_txns_per_sec']:.3f} txns/s, "
            f"unpipelined {s['unpipelined_txns_per_sec']:.3f}, speedup "
            f"{s['speedup']:.4f} against the floor {r['floor']}; K1 = K3 = "
            f"{got['commit_chain']}; {err['commit_chain'][0]} K1 and "
            f"{err['hist_check'][0]} K3 calls equal to plain ({card})")


# --------------------------------------------------------------------------
# phase 31: the simulator's device modes, each in a fresh process


def sim_child_source(root: str) -> str:
    """``SIM_CHILD`` (the reference's same-seed trace test, whose child
    half runs a seeded 5-machine simulated cluster and prints the SHA-256
    of its trace) with every import re-rooted at the port, its
    repository at ``root``, and its simulated cluster on the module's
    ``_DEVICE``: the CPU unless a caller sets it before ``_child``."""
    with open(os.path.join(root, SIM_CHILD)) as f:
        src = re.sub(r"\bfoundationdb_tpu\b", "foundationdb_tpu_torch",
                     f.read())
    for old, new in (
            ("_REPO = os.path.dirname(os.path.dirname(_THIS))",
             f"_REPO = {root!r}"),
            ("_N_MACHINES = 5\n", "_N_MACHINES = 5\n_DEVICE = \"cpu\"\n"),
            ("durable_storage=durable,",
             "durable_storage=durable, device=_DEVICE,")):
        if src.count(old) != 1:
            fail(f"{SIM_CHILD} no longer has one {old!r}")
        src = src.replace(old, new)
    return src


def held_to_plain_ring():
    """Records every ring_append (K2) call the path makes, by wrapping
    the kernels module's wrapper (the conflict set calls it through the
    module): copies of its inputs before it and of its output after it.
    Returns (calls, restore)."""
    from foundationdb_tpu_torch.ops import kernels as K
    real, calls = K.ring_append, []

    def recorded(buf, slab, out):
        args = (buf.clone(), slab.clone())
        real(buf, slab, out)
        calls.append((*args, out.clone()))
        return out

    def restore():
        K.ring_append = real
    K.ring_append = recorded
    return calls, restore


def ring_err(calls) -> int:
    """Each recorded K2 call against the plain version on its own
    inputs: the max abs error."""
    import torch

    from foundationdb_tpu_torch.ops import kernels as K
    return max((int((K.ring_append_plain(buf, slab, torch.empty_like(buf))
                     - out).abs().max()) for buf, slab, out in calls),
               default=0)


def sim_mode_child(mode: str, trace_path: str, dev_name: str) -> None:
    """The body of one phase-31 process: ``SIM_CHILD``'s child for
    ``mode`` through the port on ``dev_name``, with every K1, K3, K2 and
    B8 call recorded and held to its plain version.  The child prints its
    own line (the trace's SHA-256 and event counts); then one JSON line:
    seconds, launches, and each kernel's (calls, max abs error)."""
    import types

    import torch

    from foundationdb_tpu_torch.ops import kernels as K
    root = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device(dev_name)
    if dev.type == "cuda":
        K.build_missing()
    mod = types.ModuleType("sim_determinism_child")
    mod.__file__ = os.path.join(root, SIM_CHILD)
    exec(compile(sim_child_source(root), mod.__file__, "exec"),
         mod.__dict__)
    mod._DEVICE = dev
    resolver, restore_r = held_to_plain_resolver()
    ring, restore_k2 = held_to_plain_ring()
    b8, restore_b8 = held_to_plain()
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        mod._child(trace_path, mode)
        sync(dev)
    finally:
        restore_b8()
        restore_k2()
        restore_r()
    seconds = time.perf_counter() - t0
    errs = resolver_calls_err(resolver)
    errs["ring_append"] = [len(ring), ring_err(ring)]
    errs["prefix_search"] = [len(b8), plain_err(b8)[0]]
    print(json.dumps({"mode": mode, "device": dev_name, "seconds": seconds,
                      "launches": {k: v.launches
                                   for k, v in K.KERNELS.items()},
                      "calls": errs}), flush=True)


def sim_modes_phase(tmp: str) -> dict:
    """Phase 31: each of SIM_MODES once on the card and once on the CPU,
    each in a fresh process of its own (``sim_mode_child``), all six at
    once; returns {mode: {"cuda": result, "cpu": result}}, each result
    the child's JSON line with its trace digest and event counts."""
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for mode in SIM_MODES:
        for dev_name in ("cuda", "cpu"):
            procs[mode, dev_name] = subprocess.Popen(
                [sys.executable, os.path.join(repo, "chip_smoke.py"),
                 "--sim-mode", mode,
                 os.path.join(tmp, f"{mode}-{dev_name}.jsonl"), dev_name],
                cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=dict(os.environ, PYTHONPATH=repo,
                                    OMP_NUM_THREADS="1"))
    out: dict = {}
    for (mode, dev_name), p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=left(120))
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            fail(f"phase 31: {mode} on {dev_name} still running")
        lines = stdout.strip().splitlines()
        if p.returncode != 0 or len(lines) < 2:
            fail(f"phase 31: {mode} on {dev_name}: rc {p.returncode}: "
                 f"{stderr[-3000:]}")
        r = json.loads(lines[-1])
        (r["sha256"], *counts) = lines[-2].split()
        r["events"] = [int(c) for c in counts]
        out.setdefault(mode, {})[dev_name] = r
    return out


def check_sim_modes_phase(r: dict, card: str = "") -> tuple[dict, str]:
    """Phase 31's gates: for each mode the card's trace and the CPU's
    hash to SIM_DIGESTS[mode], every recorded kernel call equals its
    plain version (tolerance 0) and the card's calls are its launches,
    K1 = K3 > 0 on the card, and the devplane mode launches K2.
    Returns (the card runs' launches, the one-line result)."""
    total: dict = {}
    for mode in SIM_MODES:
        card_r, cpu_r = r[mode]["cuda"], r[mode]["cpu"]
        got, calls = card_r["launches"], card_r["calls"]
        say(f"sim mode {mode}: card {card_r['seconds']:.3f} s, cpu "
            f"{cpu_r['seconds']:.3f} s; trace sha256 card "
            f"{card_r['sha256']} cpu {cpu_r['sha256']} (expected "
            f"{SIM_DIGESTS[mode]}); events {card_r['events']} (cpu "
            f"{cpu_r['events']}); launches {got}; calls held to plain "
            f"(calls, max_abs_err) {calls}; cpu calls {cpu_r['calls']} "
            f"({card})")
        if not card_r["sha256"] == cpu_r["sha256"] == SIM_DIGESTS[mode]:
            fail(f"phase 31: the {mode} traces differ: card "
                 f"{card_r['sha256']}, cpu {cpu_r['sha256']}, expected "
                 f"{SIM_DIGESTS[mode]}")
        if any(e for _, e in calls.values()) or any(
                got[k] != calls[k][0] for k in calls):
            fail(f"phase 31: a kernel call of {mode} differs from its plain "
                 f"version, or a launch went unrecorded: {calls}, {got}")
        if {k: v[0] for k, v in calls.items()} != \
                {k: v[0] for k, v in cpu_r["calls"].items()}:
            fail(f"phase 31: {mode} called the kernels {calls} times on the "
                 f"card and {cpu_r['calls']} on the CPU")
        if got["commit_chain"] != got["hist_check"] \
                or got["commit_chain"] == 0:
            fail(f"phase 31: {mode} launched {got}")
        if mode == "devplane" and got["ring_append"] == 0:
            fail("phase 31: the devplane mode (RESOLVER_RING_INPLACE) "
                 "launched no ring_append")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    slowest = max(x["seconds"] for m in r.values() for x in m.values())
    return total, (
        f"phase 31: {', '.join(SIM_MODES)} on the card and the CPU, traces "
        f"equal to the held digests; launches {total} (K2 "
        f"{r['devplane']['cuda']['launches']['ring_append']} in devplane), "
        f"every call equal to plain; slowest child's simulation "
        f"{slowest:.3f} s ({card})")


# --------------------------------------------------------------------------
# phase 30: the perf smoke's device stages


PERF_SMOKE_STAGES = ("read", "mesh", "devplane", "recover", "observe",
                     "scrub", "layers")


def perf_smoke_phase(dev) -> dict:
    """Phase 30: the port's perf-smoke stages whose paths launch a kernel,
    each through its ``check_*`` at the reference's sizes, gates, budget
    and floors, with ``dev`` for every device: ``read`` (the in-memory
    cluster, then the durable lsm cluster whose storage servers' read
    mirrors serve the multiget misses: B8), ``mesh`` (two resolvers on
    the live commit path, the cuda backend: K3 and K1), ``devplane``
    (the sharded mirror, B8, and the verdict-bitmask A/B, K3 and K1),
    and the stages whose clusters' resolvers run the port's default
    ``cuda`` backend (K3 and K1): ``recover``, ``observe``, ``scrub`` and
    ``layers``.
    Each stage's launches are counted, its printed lines and the stats
    of each of its ``*_seconds`` runs kept, and every B8 call
    (references to its own tensors) and every K3 and K1 call (copies,
    as ``held_to_plain_resolver`` takes them) recorded
    during its run and held to the plain version.  The mesh's run is
    not recorded (its routed/broadcast ratio is a wall-clock gate that
    copies on the stream would tilt): its routed side runs once more,
    recorded.  The mesh's ratio pools ten alternating routed/broadcast
    pairs after one unmeasured routed run (``perf_smoke.mesh_seconds``);
    each side's window, warmup and clients and the floor are the
    reference's."""
    import io

    from foundationdb_tpu_torch.bench.multi_resolver import \
        _mesh_cluster_run
    from foundationdb_tpu_torch.ops import kernels as K
    from foundationdb_tpu_torch.runtime.trace import (TraceLog,
                                                      get_trace_log,
                                                      set_trace_log)
    from foundationdb_tpu_torch.tools import perf_smoke as ps

    def counted() -> dict:
        sync(dev)
        return {k: v.launches for k, v in K.KERNELS.items()}

    def keeping(stats: list):
        def make(run):
            def kept(*a, **kw):
                elapsed, st = run(*a, **kw)
                stats.append(st)
                return elapsed, st
            return kept
        return make

    out: dict = {}
    for name, check, fn, recorded in (
            ("read", ps.check_read, "read_path_seconds", True),
            ("mesh", ps.check_mesh, "mesh_seconds", False),
            ("devplane", ps.check_devplane, "devplane_seconds", True),
            ("recover", ps.check_recover, "recover_path_seconds", True),
            ("observe", ps.check_observe, "observe_seconds", True),
            ("scrub", ps.check_scrub, "scrub_seconds", True),
            ("layers", ps.check_layers, "layers_seconds", True)):
        K.reset_launches()
        b8, restore_b8 = held_to_plain()
        calls, restore = held_to_plain_resolver() if recorded \
            else ([], lambda: None)
        buf, stats = io.StringIO(), []
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf), \
                    wrapped(ps, fn, keeping(stats)):
                check(device=dev)
        except AssertionError as e:
            fail(f"phase 30: the {name} stage failed its gate: {e}")
        finally:
            restore()
            restore_b8()
        r = {"seconds": time.perf_counter() - t0, "launches": counted(),
             "lines": buf.getvalue().strip().splitlines(), "stats": stats}
        if not recorded:
            K.reset_launches()
            calls, restore = held_to_plain_resolver()
            drop, prev = TraceLog(), get_trace_log()
            drop.sink = lambda ev: None
            set_trace_log(drop)
            try:
                rerun = asyncio.run(_mesh_cluster_run(
                    2, True, seconds=ps.MESH_SECONDS,
                    warmup_s=ps.MESH_WARMUP_S, n_clients=ps.MESH_CLIENTS,
                    skewed=True, device=dev))
            finally:
                restore()
                set_trace_log(prev)
            r["launches_recorded"] = counted()
            r["rerun_group_mean"] = rerun["partitions"][0]["group_mean"]
        else:
            r["launches_recorded"] = r["launches"]
        r["resolver_errors"] = resolver_calls_err(calls)
        r["prefix_calls"] = len(b8)
        r["prefix_err"] = plain_err(b8)[0]
        del calls, b8
        out[name] = r
    out["floors"] = {"group_mean": ps.MESH_GROUP_MEAN_FLOOR,
                     "mirror": ps.DEVPLANE_MIRROR_FLOOR,
                     "bitmask": ps.DEVPLANE_BITMASK_FLOOR}
    return out


def perf_smoke_phase_process(trace_path: str) -> dict:
    """``perf_smoke_phase`` on the card in a process of its own, as the
    perf smoke runs, its roles' trace events to ``trace_path``; returns
    its result.  The stages' wall-clock gates (the read and mesh A/Bs,
    the metrics plane's and the scrubber's overhead) then measure the
    stage, not the heap and the collector's load that phases 1-17 leave
    in this process."""
    repo = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import json, sys, torch\n"
        "import chip_smoke as cs\n"
        "from foundationdb_tpu_torch.ops import kernels as K\n"
        "from foundationdb_tpu_torch.runtime.trace import (TraceLog,\n"
        "                                                  set_trace_log)\n"
        "K.build_missing()\n"
        "set_trace_log(TraceLog(path=sys.argv[1]))\n"
        "r = cs.perf_smoke_phase(torch.device('cuda'))\n"
        "print(json.dumps(r), flush=True)\n")
    try:
        p = subprocess.run([sys.executable, "-c", code, trace_path],
                           cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                           capture_output=True, text=True, timeout=left(300))
    except subprocess.TimeoutExpired as e:
        fail(f"phase 30's process: still running after {e.timeout:.0f} s: "
             f"{str(e.stderr)[-3000:]}")
    if p.returncode != 0 or not p.stdout.strip():
        fail(f"phase 30's process: rc {p.returncode}: {p.stderr[-3000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def check_perf_smoke_phase(r: dict, card: str = "") -> str:
    """Phase 30's gates (beside those each ``check_*`` asserted): the
    read stage's lsm half served batches off the card, the mesh's hot
    group mean at its floor with K1 = K3 > 0, the devplane's verdict
    A/B launched K1 = K3 > 0, every other stage K1 = K3 > 0, and every
    recorded B8, K3 and K1 call equal to its plain version, one record
    for each launch; returns the one-line result."""
    for name in PERF_SMOKE_STAGES:
        s = r[name]
        for ln in s["lines"]:
            say(f"phase 30 {name}: {ln}")
        say(f"phase 30 {name}: {s['seconds']:.3f} s, launches "
            f"{s['launches']}; recorded run's launches "
            f"{s['launches_recorded']}: prefix_search calls "
            f"{s['prefix_calls']} max_abs_err {s['prefix_err']}, K3/K1 "
            f"(calls, max_abs_err) {s['resolver_errors']} ({card})")
        got, rec, err = s["launches"], s["launches_recorded"], \
            s["resolver_errors"]
        if got["hist_check"] != got["commit_chain"] or \
                rec["hist_check"] != rec["commit_chain"]:
            fail(f"phase 30 {name}: a batch is one K3 and one K1 launch: "
                 f"{got}, {rec}")
        if s["prefix_err"] or s["prefix_calls"] != rec["prefix_search"]:
            fail(f"phase 30 {name}: a prefix_search call differs from its "
                 f"plain version, or a launch went unrecorded")
        if any(err[k][1] or err[k][0] != rec[k] for k in err):
            fail(f"phase 30 {name}: a K3 or K1 call differs from its plain "
                 f"version, or a launch went unrecorded: {err}, {rec}")
    read_mem, read_lsm = r["read"]["stats"]
    read_batches = read_lsm["device_read_batches"]
    if read_batches <= 0 or r["read"]["launches"]["prefix_search"] <= 0:
        fail(f"phase 30 read: the lsm half's mirror served {read_batches} "
             f"batches")
    group_mean = r["mesh"]["stats"][0]["hot_group_mean"]
    mesh = r["mesh"]["launches"]
    if group_mean < r["floors"]["group_mean"] or mesh["commit_chain"] <= 0:
        fail(f"phase 30 mesh: hot group mean {group_mean}, launches {mesh}")
    d = r["devplane"]["stats"][0]
    dp = r["devplane"]["launches"]
    if d["served_ratio"] < r["floors"]["mirror"] or \
            d["bitmask_ratio"] < r["floors"]["bitmask"] or \
            d["aborts"] <= 0 or dp["commit_chain"] <= 0 or \
            dp["prefix_search"] <= 0:
        fail(f"phase 30 devplane: {d}, launches {dp}")
    for name in ("recover", "observe", "scrub", "layers"):
        if r[name]["launches"]["commit_chain"] <= 0:
            fail(f"phase 30 {name}: its resolvers launched nothing: "
                 f"{r[name]['launches']}")
    total = {k: sum(r[n]["launches"][k] for n in PERF_SMOKE_STAGES)
             for k in r["read"]["launches"]}
    r["total_launches"] = total
    secs = {n: round(r[n]["seconds"], 3) for n in PERF_SMOKE_STAGES}
    return (f"phase 30: read multiget {read_mem['speedup']:.2f}x / lsm "
            f"{read_lsm['speedup']:.2f}x with {read_batches} mirror "
            f"batches; mesh routed/broadcast "
            f"{r['mesh']['stats'][0]['ratio']}x, hot group mean "
            f"{group_mean} (floor {r['floors']['group_mean']}); devplane "
            f"served {d['served_ratio']}x, bitmask {d['bitmask_ratio']}x, "
            f"{d['aborts']} aborts; seconds {json.dumps(secs)}; launches "
            f"{json.dumps(total)}; every recorded B8, K3 and K1 call equal "
            f"to plain ({card})")


# --------------------------------------------------------------------------
# phase 29: the north star (bench/north_star.py)


NORTH_STAR_TIMEOUT_S = 1200


def north_star_start(tmp: str, args=()) -> dict:
    """Start ``python3 -m foundationdb_tpu_torch.bench.north_star [args]``
    as its own process group on the card, stdout and stderr
    (the roles' trace events included) in files under ``tmp``; the
    process group is killed if this one exits first."""
    import atexit
    import signal
    repo = os.path.dirname(os.path.abspath(__file__))
    name = "north_star" + "".join(args).replace("-", "_")
    h = {"err_path": os.path.join(tmp, name + ".err"),
         "out_path": os.path.join(tmp, name + ".out"),
         "t0": time.perf_counter()}
    with open(h["err_path"], "w") as err, open(h["out_path"], "w") as out:
        h["p"] = subprocess.Popen(
            [sys.executable, "-m", "foundationdb_tpu_torch.bench.north_star",
             *args], cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
            stdout=out, stderr=err, start_new_session=True)

    def stop(p=h["p"]):
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    atexit.register(stop)
    h["stop"] = stop
    return h


def north_star_wait(h: dict, marker: str,
                    timeout: float = NORTH_STAR_TIMEOUT_S) -> bool:
    """Wait until a line of the north star's stderr starts with ``marker``
    (True), or it exits or ``timeout`` seconds pass (False)."""
    deadline = time.perf_counter() + left(timeout)
    buf = ""
    with open(h["err_path"], errors="replace") as f:
        while time.perf_counter() < deadline:
            chunk = f.read()
            if chunk:
                *lines, buf = (buf + chunk).split("\n")
                if any(ln.startswith(marker) for ln in lines):
                    return True
            elif h["p"].poll() is not None:
                return False
            else:
                time.sleep(0.5)
    return False


def north_star_finish(h: dict, timeout: float = NORTH_STAR_TIMEOUT_S
                      ) -> dict:
    """Wait for the north star (killed past ``timeout`` seconds from its
    start): rc, the JSON line, each stage's seconds, the dictionary's
    counts, the kernels' launches and the wall seconds."""
    try:
        h["p"].wait(timeout=left(h["t0"] + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        h["stop"]()
    from foundationdb_tpu_torch.bench.stats import LAUNCHES
    wall = time.perf_counter() - h["t0"]
    with open(h["out_path"]) as f:
        stdout = f.read()
    r = {"rc": h["p"].returncode, "wall_s": wall, "stages": {}, "dict": {},
         "launches": None, "stdout_lines": stdout.strip().splitlines(),
         "notes": []}
    with open(h["err_path"], errors="replace") as f:
        for ln in f:
            ln = ln.rstrip("\n")
            if ln.startswith("[bench] stage ") and ln.endswith(" s") \
                    and ": " in ln:
                name, secs = ln[len("[bench] stage "):-2].split(": ")
                r["stages"][name] = float(secs)
            elif ln.startswith("[cuda] dict_"):
                r["dict"] = {k: int(v) for k, v in
                             (kv.split("=") for kv in ln[7:].split())}
            elif ln.startswith(LAUNCHES):
                r["launches"] = json.loads(ln[len(LAUNCHES):])
            elif ln.startswith(("FATAL", "[bench] no CUDA", "Traceback",
                                "[bench] stage ", "[bench] kernel build")):
                r["notes"].append(ln[:300])
    try:
        r["line"] = json.loads(r["stdout_lines"][-1])
    except (IndexError, ValueError):
        r["line"] = None
    return r


def north_star_run(tmp: str, args=(), timeout: float = NORTH_STAR_TIMEOUT_S
                   ) -> dict:
    """The north star from start to end (``north_star_finish``'s
    result)."""
    return north_star_finish(north_star_start(tmp, args), timeout)


def check_north_star(r: dict, quick: dict, card: str) -> tuple[dict, str]:
    """Phase 29's gates; returns the kernels' launches and a summary
    line."""
    line = r["line"]
    say(f"north star: rc {r['rc']}, {r['wall_s']:.1f} s; stage seconds "
        f"{json.dumps(r['stages'])}; dictionary {json.dumps(r['dict'])}; "
        f"launches {json.dumps(r['launches'])}; notes {r['notes'][:8]}")
    if line is None:
        fail(f"the north star printed no JSON line: {r['stdout_lines'][-3:]}")
    keys = ("value", "vs_baseline", "baseline_cpp_commits_per_sec",
            "serial_commits_per_sec_cuda", "serial_commits_per_sec_cpp",
            "abort_rate", "verdict_mismatches", "grouped_pass_elapsed_s_cuda",
            "grouped_pass_elapsed_s_cpp", "e2e_tps_cuda", "e2e_tps_cpp",
            "ycsb_ops_per_sec_cuda", "ycsb_ops_per_sec_cpp",
            "tpcc_tpmC_cuda", "tpcc_tpmC_cpp",
            "abort_parity_safety_violations")
    say(f"north star: {json.dumps({k: line.get(k) for k in keys})} "
        f"(card idle share: not measured, no stage of the north star gives "
        f"one; "
        f"{card})")
    say(f"north star line: {json.dumps(line)[:20000]}")
    errors = sorted(k for k in line if k == "error" or k.endswith("_error"))
    gates = {
        "rc": r["rc"] == 0,
        "no stage error": not errors,
        "no stage timeout": not line.get("stages_timed_out"),
        "backend_used cuda": line.get("backend_used") == "cuda",
        "verdict parity": line.get("verdict_parity") is True
        and line.get("verdict_mismatches") == 0,
        "pipelined verdicts": line.get("pipelined_verdicts_match") is True,
        "grouped verdicts": line.get("grouped_verdicts_match") is True,
        "device pipeline verdicts":
            line.get("device_pipeline_verdicts_match") is True,
        "abort parity": line.get("abort_parity_safety_violations") == 0,
        "dictionary": r["dict"].get("dict_dispatches", 0) > 0
        and r["dict"].get("dict_fallbacks") == 0,
        "every kernel launched": bool(r["launches"])
        and all(r["launches"].get(k, 0) > 0
                for k in ("commit_chain", "ring_append", "hist_check",
                          "prefix_search")),
        "--quick": quick["rc"] == 0 and len(quick["stdout_lines"]) == 1
        and quick["line"] is not None
        and quick["line"].get("verdict_parity") is True,
    }
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        fail(f"the north star failed {bad}: errors "
             f"{ {k: line[k] for k in errors} }, timed out "
             f"{line.get('stages_timed_out')}, quick rc {quick['rc']}")
    say(f"north star --quick: rc 0, {quick['wall_s']:.1f} s, value "
        f"{quick['line'].get('value')}, vs_baseline "
        f"{quick['line'].get('vs_baseline')}")
    return r["launches"], (
        f"north star (phase 29): value {line['value']} commits/s, "
        f"vs_baseline {line['vs_baseline']}, cpp "
        f"{line['baseline_cpp_commits_per_sec']}, abort_rate "
        f"{line['abort_rate']}, {r['wall_s']:.1f} s, stage seconds "
        f"{json.dumps(r['stages'])} ({card})")


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
    t_start = _LAP[0] = _START[0] = time.perf_counter()

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
    lap("1-3")

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
    v5 = flat(rep5)
    say(f"resolver ranges (ring 1<<17, window 8192): 32 batches, aborts="
        f"{sum(1 for x in v5 if x == 1)} too_old="
        f"{sum(1 for x in v5 if x == 2)}; card {dt5:.3f} s; "
        f"launches={got5}")
    defer_plain("resolver ranges (ring 1<<17, window 8192)", knobs,
                (32, 7, (17, 200)), {}, v5, st5)
    if got5["commit_chain"] == 0 or got5["hist_check"] == 0:
        fail(f"range run did not launch the kernels: {got5}")
    # ... and with a small ring that wraps and evicts
    small = smoke_knobs(CONFLICT_RING_CAPACITY=1 << 13,
                        CONFLICT_WINDOW_SLOTS=1024)
    rb6, rv6 = range_batches(64, 8, (17, 40))
    (rep6, dt6, _, st6), got6 = count_run(
        lambda: run_resolver(small, rb6, rv6))
    v6 = flat(rep6)
    too_old = sum(1 for x in v6 if x == 2)
    say(f"resolver ranges (ring 1<<13, window 1024): 64 batches, aborts="
        f"{sum(1 for x in v6 if x == 1)} too_old={too_old}; floor="
        f"{st6[3]} launches={got6}")
    defer_plain("resolver ranges (ring 1<<13, window 1024)", small,
                (64, 8, (17, 40)), {}, v6, st6)
    if too_old == 0:
        fail("eviction produced no TOO_OLD")
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
        SUMMARY.append(
            f"B6 {name} (group of 64, B={B}, R={R}): ms "
            f"{r['device_us'] / 1e3:.7f}, launches {r['kernels']} torch "
            f"kernels a group, bound_ms "
            f"{r['bytes'] / HBM_BYTES_PER_S * 1e3:.8f} (bytes), plain_ms = "
            f"ms (torch ops), library_ms null")

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
    v9 = flat(rep9)
    say(f"resolver ranges, dictionary {slots} slots, {len(keys9)} distinct "
        f"endpoints (ring 1<<13, window 1024): 288 batches, aborts="
        f"{sum(1 for x in v9 if x == 1)} too_old="
        f"{sum(1 for x in v9 if x == 2)}; card {dt9:.3f} s; dictionary "
        f"groups={m9['dict_dispatches']} fallbacks={m9['dict_fallbacks']}; "
        f"launches={got9}")
    defer_plain(f"resolver ranges, dictionary {slots} slots", ekn,
                (288, 9, (17, 40)), {"span": 1 << 40, "hot": 0.1}, v9, st9,
                m9["dict"])
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
    lap("4-9")

    # 10. the commit path end to end, cuda then cpp.  The earlier phases'
    # batches, replies and backends go first: a full collection of their
    # millions of objects stalls the event loop for most of a second.
    # The roles' trace events go to a temporary file, as the reference
    # bench routes them
    del (mb, mv, ref, v4, rep4, rep5, rep6, rep7, rep8, v8, v5, v6,
         rb5, rv5, rb6, rv6, rb9, rv9, keys9, rep9, v9, m9, wb, wv,
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
    lap("10")

    # 11. the multi-resolver; 12. durable storage; 13. the device-plane
    # A/Bs.  prefix_search's error adds the path's own calls (12, 13)
    gots11 = multi_resolver_phase(dev)
    lap("11")
    durable = durable_phase(dev)
    got12 = {k: sum(d["launches"][k] for d in durable.values())
             for k in K.KERNELS}
    lap("12")
    err13, gots13 = device_plane_phase(dev)
    lap("13")
    report["prefix_search"]["max_abs_err"] = max(
        report["prefix_search"]["max_abs_err"], err13,
        *(d["plain_err"] for d in durable.values()))

    # 16. the abort-parity gate; 17. the probe
    set_trace_log(TraceLog())
    trace_dir.cleanup()
    got16 = parity_phase(dev, count_run)
    lap("16")
    probe_phase()
    lap("17")

    # 30. the perf smoke's stages that launch kernels, alone, in a
    # process of their own; their roles' trace events to a file
    with tempfile.TemporaryDirectory() as tmp:
        r30 = perf_smoke_phase_process(os.path.join(tmp, "perf_smoke.jsonl"))
    SUMMARY.append(check_perf_smoke_phase(r30, CARD))
    got30 = r30["total_launches"]
    gots30 = [r30[n]["launches"] for n in PERF_SMOKE_STAGES]
    del r30
    lap("30")

    # 29. the north star in full as its own process, this process's
    # tensors released first.  Its device stages hold the card alone
    # but for phase 31's six short children; beside them on the host run
    # phase 26's CPU twin (two farm children of one thread each), phases
    # 5 and 8's CPU plain replays (three threads), then phase 31.  Its
    # host stages (after its device-plane stage) are host-bound; once
    # read_point, whose one read version must outlive 5 s of reads
    # inside a 5 s MVCC window, has ended, --quick and phases 14, 15,
    # 18-25, 32 and 33 run beside them: the smoke as a whole does not fit
    # its time limit in sequence.  The north star ends before phase 26's
    # card passes
    gc.collect()
    torch.cuda.empty_cache()
    ns_tmp = tempfile.TemporaryDirectory()
    ns = north_star_start(ns_tmp.name)
    farm_tmp = tempfile.TemporaryDirectory()
    twin = farm_start(os.path.join(farm_tmp.name, "farm-cpu.jsonl"), "cpu",
                      FARM_TWIN_JOBS, FARM_SEEDS)
    t0 = time.perf_counter()
    plain_replays()
    phase_done(f"phases 5 and 8's CPU plain replays: "
               f"{time.perf_counter() - t0:.1f} s ({CARD})")
    # 31. the simulator's device modes, each in a fresh process, while
    # the north star's device stages run: this process waits for its
    # read_point in any case
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        got31, line31 = check_sim_modes_phase(sim_modes_phase(tmp), CARD)
    SUMMARY.append(line31)
    phase_done(f"phase 31: {time.perf_counter() - t0:.1f} s ({CARD})")
    reached = north_star_wait(ns, "[bench] stage read_point:")
    if not reached and ns["p"].poll() is None:
        ns["stop"]()
        with open(ns["err_path"], errors="replace") as f:
            fail(f"the north star had not passed read_point at the "
                 f"smoke's deadline: {f.read()[-3000:]}")
    lap(f"29 (the north star past read_point: {reached})")
    q29 = north_star_run(ns_tmp.name, ("--quick",), timeout=300)
    lap("29 --quick")

    # 14. YCSB-F; 15. TPC-C NewOrder; 18. the multi-role cluster through
    # two recoveries; 19. three server processes over TCP.  Their roles'
    # trace events and phase 19's client's go to a temporary file
    trace_dir = tempfile.TemporaryDirectory()
    set_trace_log(TraceLog(path=os.path.join(trace_dir.name, "sim.jsonl")))
    gots14 = bench_phase("ycsb", dev, count_run)
    lap("14")
    gots15 = bench_phase("tpcc", dev, count_run)
    lap("15")
    t0 = time.perf_counter()
    r18, got18 = count_run(lambda: cluster_phase(dev))
    check_cluster_phase(r18, got18, True)
    del r18
    phase_done(f"phase 18: {time.perf_counter() - t0:.1f} s ({CARD})")
    t0 = time.perf_counter()
    check_tcp_phase(tcp_phase("cuda"), CARD)
    phase_done(f"phase 19: {time.perf_counter() - t0:.1f} s ({CARD})")

    # 20. two regions and the primary region's loss; 21. backup and
    # point-in-time restore; 22. DR between two clusters on the card, and
    # the layers on the promoted destination.  Their roles' trace events
    # go to the same temporary file
    t0 = time.perf_counter()
    r20, got20 = count_run(lambda: regions_phase(dev))
    err20 = check_regions_phase(r20, got20, True)
    del r20
    phase_done(f"phase 20: {time.perf_counter() - t0:.1f} s ({CARD})")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        r21, got21 = count_run(lambda: backup_phase(dev, root=tmp))
    err21 = check_backup_phase(r21, True)
    del r21
    phase_done(f"phase 21: launches {got21}; "
               f"{time.perf_counter() - t0:.1f} s ({CARD})")
    t0 = time.perf_counter()
    r22, got22 = count_run(lambda: dr_phase(dev))
    check_dr_phase(r22, got22, True)
    del r22
    phase_done(f"phase 22: {time.perf_counter() - t0:.1f} s ({CARD})")
    set_trace_log(TraceLog())
    trace_dir.cleanup()

    # 23. the seeded chaos run on the card; 24. the spec files; both at
    # the simulator's own shapes, each run with a trace file of its own.
    # 33. beside them, in a process of its own: a fresh deployment whose
    # coordinators' servers are killed in turn and restarted at once
    with tempfile.TemporaryDirectory() as tmp:
        h33 = rolling_start(tmp)
        t0 = time.perf_counter()
        got23 = check_chaos_phase(chaos_phase(dev, tmp))
        phase_done(f"phase 23: {time.perf_counter() - t0:.1f} s ({CARD})")
        t0 = time.perf_counter()
        got24 = check_specs_phase(specs_phase(dev, tmp))
        phase_done(f"phase 24: {time.perf_counter() - t0:.1f} s ({CARD})")

        # 25. the operator's deployment: fdbmonitor, fdbcli and the C ABI
        # against --device cuda servers
        t0 = time.perf_counter()
        SUMMARY.append(check_deployment_phase(deployment_phase("cuda"),
                                              CARD))
        phase_done(f"phase 25: {time.perf_counter() - t0:.1f} s ({CARD})")
        # 32. a fresh deployment with the elected leader's server
        # SIGSTOPped, beside the north star as phase 25 runs
        t0 = time.perf_counter()
        SUMMARY.append(check_stopped_leader_phase(
            stopped_leader_phase("cuda"), CARD))
        phase_done(f"phase 32: {time.perf_counter() - t0:.1f} s ({CARD})")
        # 33's end (started before 23)
        t0 = time.perf_counter()
        r33 = rolling_finish(h33)
        SUMMARY.append(check_rolling_phase(r33, CARD))
        phase_done(f"phase 33: {r33['seconds']:.1f} s beside phases "
                   f"23-32, waited {time.perf_counter() - t0:.1f} s for "
                   f"its end ({CARD})")
        # the north star's end, before phase 26 takes the host
        t0 = time.perf_counter()
        r29 = north_star_finish(ns)
        ns_tmp.cleanup()
        got29, line29 = check_north_star(r29, q29, CARD)
        SUMMARY.append(line29)
        phase_done(f"phase 29: waited {time.perf_counter() - t0:.1f} s "
                   f"for the north star's end ({CARD})")

        # 26. the seed farm on the card and the trace tools over phase
        # 23's seed-0 traces; 27. the resolve stage of the perf smoke
        t0 = time.perf_counter()
        SUMMARY.append(check_farm_phase(
            farm_phase(farm_tmp.name, twin), tools_phase(
                os.path.join(tmp, "chaos0-card.jsonl"),
                os.path.join(tmp, "chaos0-cpu.jsonl")), CARD))
        phase_done(f"phase 26: {time.perf_counter() - t0:.1f} s ({CARD})")
    farm_tmp.cleanup()
    t0 = time.perf_counter()
    r27 = resolve_stage_phase(dev)
    SUMMARY.append(check_resolve_stage(r27, CARD))
    got27 = r27["launches"]
    phase_done(f"phase 27: {time.perf_counter() - t0:.1f} s ({CARD})")

    report["prefix_search"]["max_abs_err"] = max(
        report["prefix_search"]["max_abs_err"], err20, err21)

    for got in (got4, got5, got6, got7, got8, got9, *gots, got10, got10c,
                *gots11, got12, *gots13, *gots14, *gots15, got16, got18,
                got20, got21, got22, got23, got24, got27, got29, got30,
                *gots30, got31):
        if got["hist_check"] != got["commit_chain"]:
            fail(f"a resolved batch is one K3 and one K1 launch: {got}")

    # 28. the compact summary, the kernels line, then the result.  The
    # resolver kernels' launches are those of the mako run with
    # RESOLVER_RING_INPLACE (phase 6), the one run that takes all three;
    # prefix_search's are those of the durable read-back (phase 12, every
    # engine); each phase printed its own counts above, and phases 20-24's,
    # 27's, 29's (the north star's process and its bench subprocesses),
    # 30's and 31's (its card processes) stand in each row too (phases 25
    # and 26 launch in their server and seed processes: the status
    # document's dispatches and each seed's launches show them).
    counts = dict(got7, prefix_search=got12["prefix_search"])
    by_phase = {"20": got20, "21": got21, "22": got22, "23": got23,
                "24": got24, "27": got27, "29": got29, "30": got30,
                "31": got31}
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
                     "replaces": repl, "launches": counts[name],
                     "launches_by_phase": {p: g[name]
                                           for p, g in by_phase.items()},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     **{k: r[k] for k in ("latency_bound_ms", "chain_step_ms",
                                          "level_ms", "sim_shapes")
                        if k in r}})
    for k in line:
        say(f"summary {k['name']}: ms {k['ms']}, launches {k['launches']} "
            f"(by phase {json.dumps(k['launches_by_phase'])}), bound_ms "
            f"{k['bound_ms']} ({k['bound_by']}"
            + (f"; latency {k['latency_bound_ms']}"
               if "latency_bound_ms" in k else "")
            + f"), plain_ms {k['plain_ms']}, library_ms {k['library_ms']}, "
            f"max_abs_err {k['max_abs_err']}")
    for ln in SUMMARY:
        say(f"summary {ln}")
    say(f"total {time.perf_counter() - t_start:.1f} s ({CARD})")
    say(json.dumps({"kernels": line}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sim-mode"] and len(sys.argv) == 5:
        sim_mode_child(*sys.argv[2:])
    elif sys.argv[1:2] == ["--rolling"] and len(sys.argv) == 5:
        rolling_child(*sys.argv[2:])
    else:
        main()
