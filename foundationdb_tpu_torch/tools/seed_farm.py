#!/usr/bin/env python
"""Seed farm: fan out simulation seeds, bucket the failures.

Reference: the correctness farm / TestHarness
(REF:contrib/TestHarness2, SURVEY.md §4) — run the simulation at many
seeds in parallel; any failure prints its seed (replayable with
``python -m foundationdb_tpu_torch.sim.run_one --seed N``) and failures
are bucketed by error signature.

    python -m foundationdb_tpu_torch.tools.seed_farm --seeds 100 --jobs 8
    python -m foundationdb_tpu_torch.tools.seed_farm --device cpu ...

``--device`` (``cuda``, the default, or ``cpu``) goes to every child:
with ``cuda`` each child's resolvers and read mirrors run on the card.
The farm then checks for the card and builds the hand kernels once,
before it fans out, so that the children load them instead of each
running ``nvcc``; without a card it exits at once.  A child that fails
on the card is that seed's failure, with its stderr: it is never run
again on the CPU.  ``--out FILE`` writes each seed's result (the child's
last line, with its seconds) as one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_seed(seed: int, timeout: float, spec: str | None = None,
             faults: str | None = None, device: str = "cuda") -> dict:
    env = dict(os.environ, PYTHONPATH=REPO)
    # each child is one of --jobs processes sharing the host's cores: one
    # thread for torch's CPU ops each, unless the caller says otherwise
    env.setdefault("OMP_NUM_THREADS", "1")
    t0 = time.time()
    cmd = [sys.executable, "-m", "foundationdb_tpu_torch.sim.run_one",
           "--seed", str(seed), "--device", device]
    if spec:
        # children run with cwd=REPO; a caller-relative path must not
        # silently resolve against the wrong directory
        cmd += ["--spec", os.path.abspath(spec)]
    if faults:
        cmd += ["--faults", faults]
    try:
        p = subprocess.run(
            cmd, cwd=REPO, env=env, capture_output=True, text=True,
            timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"seed": seed, "ok": False, "error": "TIMEOUT",
                "elapsed": time.time() - t0}
    line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else "{}"
    try:
        out = json.loads(line)
    except ValueError:
        out = {"seed": seed, "ok": False,
               "error": f"no-json rc={p.returncode}: {p.stderr[-200:]}"}
    if not out.get("ok"):
        out["stderr"] = p.stderr[-2000:]
    out["elapsed"] = time.time() - t0
    return out


def prepare_device(device: str) -> None:
    """For ``cuda``: fail unless a card is visible, then build every hand
    kernel into the package's build directory (a no-op when they are
    current), so the children only load them."""
    if device != "cuda":
        return
    import torch

    from ..ops import kernels
    from ..ops.conflict_torch import default_device
    default_device(torch.device("cuda"))
    if not all(k.built() for k in kernels.KERNELS.values()):
        kernels.build()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="foundationdb_tpu_torch.tools.seed_farm")
    ap.add_argument("--seeds", type=int, default=50)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 4)
    ap.add_argument("--timeout", type=float, default=180.0)
    ap.add_argument("--spec", help="run a TOML spec (tests/specs/*) at "
                    "every seed instead of the default chaos mix")
    ap.add_argument("--faults", choices=("disk",),
                    help="fault profile forwarded to every child: "
                    "'disk' = hostile disks from boot on a durable "
                    "cluster")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where every child's resolvers and read mirrors "
                    "run: the CUDA card (the default) or the CPU")
    ap.add_argument("--out", help="write each seed's result to this file, "
                    "one JSON line a seed, in seed order")
    args = ap.parse_args(argv)
    prepare_device(args.device)

    buckets: dict[str, list[int]] = collections.defaultdict(list)
    results: dict[int, dict] = {}
    ok = 0
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as ex:
        futs = {ex.submit(run_seed, s, args.timeout, args.spec,
                          args.faults, args.device): s
                for s in range(args.start, args.start + args.seeds)}
        for fut in concurrent.futures.as_completed(futs):
            r = fut.result()
            results[futs[fut]] = r
            if r.get("ok"):
                ok += 1
            else:
                buckets[r.get("error", "?")[:120]].append(r["seed"])
            done = ok + sum(len(v) for v in buckets.values())
            print(f"\r[{done}/{args.seeds}] ok={ok} "
                  f"failed={done - ok}", end="", file=sys.stderr, flush=True)
    print(file=sys.stderr)
    elapsed = time.time() - t0
    if args.out:
        with open(args.out, "w") as f:
            for s in sorted(results):
                f.write(json.dumps(results[s]) + "\n")

    print(json.dumps({
        "seeds": args.seeds,
        "ok": ok,
        "failed": args.seeds - ok,
        "device": args.device,
        "elapsed_s": round(elapsed, 1),
        "seeds_per_minute": args.seeds * 60.0 / elapsed if elapsed else 0.0,
        "failure_buckets": {k: sorted(v) for k, v in buckets.items()},
    }, indent=2))
    return 0 if ok == args.seeds else 1


if __name__ == "__main__":
    raise SystemExit(main())
