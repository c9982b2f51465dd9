"""Run one cell of the benchmark once:

    python -m kvbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as the last line of
standard output and each number compared beside its limit as the last
lines of standard error.  Exits with another code than 0, and prints no
result, without as many CUDA cards as the cell asks for, or when JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# the top-level names that may not be loaded once the window has closed
BANNED = ("jax", "jaxlib", "flax", "foundationdb_tpu")


def loaded_banned() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(BANNED))


def _cache_dirs(root) -> None:
    """Fixed build and kernel caches inside the checkout (the port's nvcc
    and g++ builds already go to ``foundationdb_tpu_torch/_build``)."""
    base = root / ".kvbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out[0] if out else "unknown"


def _quarters(run) -> list[int]:
    """Groups handed in during each quarter of the window: a rate that
    drifts within the window shows here."""
    if not run.groups:
        return []
    t0 = run.groups[0].t_sub
    q = run.window_s / 4
    out = [0, 0, 0, 0]
    for g in run.groups:
        out[min(3, int((g.t_sub - t0) / q))] += 1
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m kvbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse(argv)
    from . import harness, spec
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    _cache_dirs(spec.ROOT)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"kvbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.run(bench, cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start)
    from foundationdb_tpu_torch.ops import kernels
    bad = loaded_banned()
    if bad:
        print(f"kvbench: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"kvbench: card {_card()}; samples "
          f"{json.dumps(harness.samples(run))}; counters "
          f"{json.dumps(vars(run.counters))}; groups a quarter of the "
          f"window {json.dumps(_quarters(run))}; launches "
          f"{json.dumps(kernels.launch_counts())}", file=sys.stderr)
    print(json.dumps(run.result), flush=True)
    harness.print_checks(run)
    return 0
