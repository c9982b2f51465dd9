"""One perf-smoke stage of the port run several times in one process,
each run's printed line and outcome kept: how often the stage's
wall-clock gates hold on this machine.

    python tests/stage_repeats.py STAGE RUNS [--device cuda|cpu]
        [--first STAGE]

``STAGE`` is a name of ``perf_smoke.STAGES``.  ``--first`` runs another
stage once before the repeats, unmeasured, as ``chip_smoke.py`` phase
30 runs ``read`` before ``mesh``.  One JSON line a run
(``{"stage": ..., "i": ..., "ok": ..., "seconds": ..., "lines": [...],
"error": ...}``), then ``{"stage": ..., "runs": N, "fails": F}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    import torch

    from foundationdb_tpu_torch.runtime.trace import (TraceLog,
                                                      set_trace_log)
    from foundationdb_tpu_torch.tools import perf_smoke as ps

    ap = argparse.ArgumentParser()
    ap.add_argument("stage", choices=ps.STAGES)
    ap.add_argument("runs", type=int)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--first", choices=ps.STAGES)
    args = ap.parse_args(argv)
    drop = TraceLog()
    drop.sink = lambda ev: None
    set_trace_log(drop)
    if args.device == "cuda":
        from foundationdb_tpu_torch.ops import kernels as K
        K.build_missing()

    def stage_check(name: str):
        return ps.check if name == "apply" else getattr(ps,
                                                        f"check_{name}")

    if args.first:
        with contextlib.redirect_stdout(io.StringIO()):
            stage_check(args.first)(device=torch.device(args.device))
    check = stage_check(args.stage)
    fails = 0
    for i in range(args.runs):
        buf = io.StringIO()
        t0 = time.perf_counter()
        error = None
        try:
            with contextlib.redirect_stdout(buf):
                check(device=torch.device(args.device))
        except AssertionError as e:
            fails += 1
            error = str(e)[:300]
        print(json.dumps({"stage": args.stage, "i": i, "ok": error is None,
                          "seconds": round(time.perf_counter() - t0, 3),
                          "lines": buf.getvalue().strip().splitlines(),
                          "error": error}), flush=True)
    print(json.dumps({"stage": args.stage, "runs": args.runs,
                      "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
