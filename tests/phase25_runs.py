"""``chip_smoke.py`` phase 25 (the operator's deployment: fdbmonitor,
three coordinator servers and a worker-only fourth, the CLI, the
leader's SIGKILL with the monitor paused, the C ABI) run on its own,
once for each mode named, each run's failover attempts printed.

    python tests/phase25_runs.py majority,gathered,stop,... [DEVICE] [--hangs N]
        [--keep DIR]

A mode sets the client's cluster-state refresh for the run:
``majority`` is the port as it is (``core/cluster_client.py``
returns once a majority of coordinators has answered), ``gathered``
waits for every coordinator, as the JAX package does.  ``stop`` runs
phase 32 instead, the port as it is: a fresh deployment whose elected
leader's server is SIGSTOPped; ``rolling`` runs phase 33: a fresh
deployment whose coordinators' servers are SIGKILLed in turn, the
monitor running (its attempts are each kill's, in order).  ``DEVICE`` is
the servers' ``--device`` (``cuda``, the default, or ``cpu``).  One JSON
line a run: the attempts ([start s after the kill, outcome, s]), the
seconds from the kill to the first commit, what each timed-out attempt
was awaiting (with the socket states ``chip_smoke.KillWatch`` saw),
when the killed process and its sockets went (``kill_watch``), the
connections the transports cut after their peer's silence
(``connection_timeouts``), and phase 25's line.  With ``--hangs N``
the loop ends after the Nth run whose first attempt did not commit.
With ``--keep DIR`` each ``rolling`` run's files, its server logs
among them, stay in a directory of their own in DIR.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    import chip_smoke as cs
    from foundationdb_tpu_torch.core import coordination

    argv = sys.argv[1:] if argv is None else list(argv)
    hangs = None
    if "--hangs" in argv:
        i = argv.index("--hangs")
        hangs = int(argv[i + 1])
        del argv[i:i + 2]
    keep = None
    if "--keep" in argv:
        i = argv.index("--keep")
        keep = argv[i + 1]
        os.makedirs(keep, exist_ok=True)
        del argv[i:i + 2]
    modes = argv[0].split(",")
    dev = argv[1] if len(argv) > 1 else "cuda"
    card = "cpu"
    if dev == "cuda":
        from foundationdb_tpu_torch.ops import kernels as K
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print(f"{card}; kernels built in {K.build():.3f} s", flush=True)
    cs.CARD = card
    cs._START[0] = time.perf_counter()
    hung = 0
    for i, mode in enumerate(modes):
        coordination.MAJORITY_ROUNDS = mode != "gathered"
        t = time.perf_counter()
        try:
            if mode == "stop":
                r = cs.stopped_leader_phase(dev)
                line = cs.check_stopped_leader_phase(r, card)
            elif mode == "rolling":
                r = cs.rolling_phase(dev, keep)
                r.update(failover_attempts=[k["attempts"]
                                            for k in r["kills"]],
                         failover_s=[k["failover_s"] for k in r["kills"]],
                         timed_out=[k["timed_out"] for k in r["kills"]],
                         connection_timeouts=[])
                line = cs.check_rolling_phase(r, card)
            else:
                r = cs.deployment_phase(dev)
                line = cs.check_deployment_phase(r, card)
            rec = {"run": i, "mode": mode, "ok": True,
                   "attempts": r["failover_attempts"],
                   "failover_s": r["failover_s"],
                   "timed_out": r.get("timed_out", []),
                   "kill_watch": r.get("kill_watch"),
                   "connection_timeouts": r["connection_timeouts"],
                   "line": line}
        except SystemExit:
            rec = {"run": i, "mode": mode, "ok": False}
        rec["seconds"] = time.perf_counter() - t
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        hung += not rec["ok"] or rec["attempts"][0][1] != "committed" \
            if mode != "rolling" else not rec["ok"]
        if hangs is not None and hung >= hangs:
            break
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
