"""The control of ``correct``, and the program's own readings, on the
card: several seeds of one cell in one process.

    python -m kvbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 5 --key-bytes 24 [--key-bytes 32 ...]

For each key width, each seed runs the cell's set-up and a window of
``--seconds`` at the cell's own load with the program's
KEY_ENCODE_BYTES set to that width, and prints one JSON line: the
numbers ``correct`` compares.  At the configuration's width these are
sound runs (their largest reading is the lower one); a narrower key
encoding is the program's own lower-precision path, which breaks the
exactness the configuration states once keys are longer than it.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kvbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--key-bytes", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    import torch

    from . import harness, spec
    if not torch.cuda.is_available():
        print("kvbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    for width in args.key_bytes:
        for seed in (int(s) for s in args.seeds.split(",")):
            run = harness.run(bench, cell, seed, args.seconds, False,
                              torch.device("cuda", 0), time.perf_counter(),
                              knobs={"KEY_ENCODE_BYTES": width})
            print(json.dumps({"workload": args.workload, "key_bytes": width,
                              "seed": seed, "correct": run.result["correct"],
                              "checks": {k: run.checks[k]
                                         for k in harness.LIMITS},
                              "batches": run.checks["batches_compared"],
                              "committed": run.checks["committed"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
