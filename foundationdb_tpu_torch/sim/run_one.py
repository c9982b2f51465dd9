"""One simulation run: the analog of ``fdbserver -r simulation -s <seed>``.

Boots a SimulatedCluster, runs Cycle + Serializability concurrently with
MachineAttrition + RandomClogging under BUGGIFY, checks invariants, exits
0 on success.  A seed farm fans these out, one seed a process.

    python -m foundationdb_tpu_torch.sim.run_one --seed N [--device cpu]

runs every resolver and storage read mirror on the CUDA card unless
``--device cpu`` asks for the kernels' plain versions; without a card
the default fails like any other run (exit 1, ``"ok": false``).  On the
card the last line also gives ``device_peak_bytes``, the most device
memory the run allocated at once, and ``kernel_launches``, the hand
kernels' launch counts.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

import torch

from ..core.cluster_controller import ClusterConfigSpec
from ..runtime.buggify import enable_buggify
from ..runtime.knobs import Knobs
from ..ops.conflict_torch import default_device
from ..runtime.simloop import run_simulation
from ..workloads.workload import run_workloads_on
from .cluster_sim import SimulatedCluster


async def simulate(seed: int, kills: int, buggify: bool,
                   faults: str | None = None, device=None) -> dict:
    """The chaos mix at ``seed`` on a 7-machine cluster whose resolvers
    and read mirrors run on ``device`` (the CUDA card when None)."""
    knobs = Knobs().override(BUGGIFY_ENABLED=buggify, DD_ENABLED=True)
    durable = False
    if faults == "disk":
        # hostile-disk profile: every machine's fault profile armed
        # from boot AND durable storage so torn/corrupt kills bite every
        # durable surface (engines, WALs, TLog queues, spill side files)
        # — the seed farm's `--faults disk` profile.  The MVCC window
        # stays at its default: tightening it (200k versions) trips an
        # ambiguous-commit resurrection under the durable chaos mix
        # (seed 3 reproduces with zero injection).
        knobs = knobs.override(SIM_DISK_FAULTS=True)
        durable = True
    enable_buggify(buggify)
    sim = SimulatedCluster(knobs, n_machines=7, durable_storage=durable,
                           spec=ClusterConfigSpec(min_workers=7,
                                                  replication=2),
                           device=device)
    await sim.start()
    await sim.wait_epoch(1)
    db = await sim.database()
    specs = [
        {"testName": "Cycle", "nodeCount": 12, "transactionsPerClient": 30},
        {"testName": "Serializability", "numOps": 40},
        {"testName": "AtomicOps", "addsPerClient": 15},
        {"testName": "ConflictRange", "nodeCount": 8, "opsPerClient": 15},
        {"testName": "Increment", "incrementsPerClient": 10},
        {"testName": "VersionStamp", "stampsPerClient": 8},
        {"testName": "Watches", "rounds": 3, "strictFires": False},
        {"testName": "ApiCorrectness", "keyCount": 16,
         "transactionsPerClient": 10, "opsPerTransaction": 6},
        {"testName": "Sideband", "messages": 8},
        {"testName": "BankTransfer", "accounts": 8,
         "transfersPerClient": 8, "scanEvery": 4},
        # API-contract fuzzers + operational invariants
        {"testName": "WriteDuringRead", "rounds": 4, "opsPerRound": 15},
        {"testName": "FuzzApiCorrectness", "calls": 50},
        {"testName": "SelectorCorrectness", "keys": 12, "probes": 25},
        {"testName": "Storefront", "orders": 10},
        {"testName": "SpecialKeySpaceCorrectness", "rounds": 2},
        # change-feed completeness under the whole chaos mix:
        # exactly-once, exact-version, in-order delivery while machines
        # die, ranges move and BUGGIFY fires
        {"testName": "ChangeFeed", "transactionsPerClient": 10,
         "popAfter": 6},
        {"testName": "LowLatency", "seconds": 6.0, "maxLatency": 30.0},
        # DD live moves run in the default mix (the API fuzzer's
        # endpoint validation and mutation scoping keep its clear_range
        # off other workloads' keys)
        {"testName": "RandomMoveKeys", "sim": sim, "moves": 1,
         "secondsBetweenMoves": 3.0},
        {"testName": "ConfigureDatabase", "sim": sim, "rounds": 2,
         "secondsBetweenChanges": 2.5},
        {"testName": "MachineAttrition", "sim": sim, "machinesToKill": kills},
        {"testName": "Swizzle", "sim": sim, "rounds": 1,
         "secondsBefore": 6.0},
        {"testName": "RandomClogging", "sim": sim, "testDuration": 8.0},
        # hostile disks ride the default chaos mix: live-op IO errors +
        # stalls for the first stretch, kill-time torn/corrupt writes for
        # every attrition/swizzle kill — so durable code faces torn and
        # corrupt disks by default (the coordinator state files in this
        # mix; every engine/WAL/side-file too under --faults disk)
        {"testName": "DiskFault", "sim": sim, "testDuration": 10.0},
        {"testName": "ConsistencyCheck"},
    ]
    results = await run_workloads_on(db, specs, client_count=2,
                                     device=device)
    await sim.stop()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kills", type=int, default=2)
    ap.add_argument("--no-buggify", action="store_true")
    ap.add_argument("--faults", choices=("disk",),
                    help="arm a fault profile: 'disk' = hostile disks "
                    "from boot on a DURABLE cluster (torn/corrupt/"
                    "erroring/slow)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the resolvers and read mirrors run: the "
                    "CUDA card (the default; the run fails without one) "
                    "or the CPU (the kernels' plain versions)")
    ap.add_argument("--spec", help="run a TOML test spec (tests/specs/*) "
                    "instead of the built-in chaos mix")
    args = ap.parse_args(argv)
    try:
        device = default_device(torch.device(args.device))
        if args.spec:
            from .spec import load_spec, run_spec
            results = run_simulation(
                run_spec(load_spec(args.spec), seed=args.seed,
                         buggify_override=False if args.no_buggify
                         else None, device=device),
                seed=args.seed)
        else:
            results = run_simulation(
                simulate(args.seed, args.kills, not args.no_buggify,
                         faults=args.faults, device=device),
                seed=args.seed)
    except BaseException as e:  # noqa: BLE001 — the signature IS the output
        print(json.dumps({"seed": args.seed, "ok": False,
                          "error": f"{type(e).__name__}: {e}"[:300]}))
        return 1
    out = {"seed": args.seed, "ok": True, "results": results}
    if device.type == "cuda":
        # the most device memory this run held at once (a seed farm's
        # children share one card), and the hand kernels it launched
        from ..ops.kernels import KERNELS
        out["device_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        out["kernel_launches"] = {k: v.launches for k, v in KERNELS.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
