"""The port's perf-smoke ``recover`` stage run many times, each run's
outcome printed: a torn-disk kill, recovery, and the recovered keyspace
against the acknowledged one.  A failing run names the rows that
differ.

    python tests/recover_runs.py RUNS DEVICE [DEVICE ...] [--unmasked]

(``DEVICE`` is ``cuda`` or ``cpu``).  One JSON line a run, then one a
device: ``{"dev": ..., "runs": N, "fails": F}``.  ``--unmasked`` runs
the storage servers without their repair of a clear's stale engine
rows (``StorageServer._mask_engine_rows`` a no-op), as the JAX package
behaves.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    import torch

    from foundationdb_tpu_torch.backup import container
    from foundationdb_tpu_torch.runtime.trace import (TraceLog,
                                                      set_trace_log)
    from foundationdb_tpu_torch.tools import perf_smoke as ps

    argv = sys.argv[1:] if argv is None else argv
    if "--unmasked" in argv:
        from foundationdb_tpu_torch.core.storage_server import StorageServer
        StorageServer._mask_engine_rows = lambda self, version, ranges: None
    runs = int(argv[0])
    devices = [a for a in argv[1:] if not a.startswith("--")]
    seen: list = []
    real = container.keyspace_digest

    def recording(rows):
        # the stage digests the recovered keyspace, then the acked one
        seen.append({bytes(k): bytes(v) for k, v in rows})
        return real(rows)
    container.keyspace_digest = recording
    drop = TraceLog()
    drop.sink = lambda ev: None
    set_trace_log(drop)
    for d in devices:
        fails = 0
        for i in range(runs):
            seen.clear()
            t0 = time.perf_counter()
            try:
                _, st = ps.recover_path_seconds(
                    deadline_s=ps.RECOVER_BUDGET_S, device=torch.device(d))
                out = {"dev": d, "i": i, "ok": True,
                       "s": round(time.perf_counter() - t0, 3),
                       **{k: st[k] for k in ("rows", "torn_files",
                                             "dropped_sectors",
                                             "corrupt_sectors")}}
            except AssertionError as e:
                fails += 1
                got, want = seen[0], seen[1]
                out = {"dev": d, "i": i, "ok": False, "error": str(e)[:200],
                       "extra": sorted(k.decode() for k in set(got)
                                       - set(want)),
                       "missing": sorted(k.decode() for k in set(want)
                                         - set(got)),
                       "changed": sorted(k.decode() for k in set(got)
                                         & set(want) if got[k] != want[k])}
            print(json.dumps(out), flush=True)
        print(json.dumps({"dev": d, "runs": runs, "fails": fails,
                          "unmasked": "--unmasked" in argv}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
