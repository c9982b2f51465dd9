"""A rolling restart of the coordinators' servers under fdbmonitor
(ROADMAP C6).

Phase 25's deployment on the CPU (the port's fdbmonitor over three
coordinator servers and a worker-only fourth, ``device = cpu``), the
monitor left running, and the coordinators' servers SIGKILLed in turn,
0, 1 and then 2, each 5 s after the commit that followed the previous
kill: ``tests/failover_attempts.py PACKAGE --deployment --rolling``.
Each server comes back at once as an empty coordinator, TLog and
storage host.  Before the repair, two empty coordinators could settle a
recovery's read of the coordinated state while the third still held the
latest epoch, and the recovery founded a second, empty database
(``tests/test_torch_coordination.py::
test_read_after_coordinators_restart_empty`` holds the read itself);
and a restarted leader's first write of the coordinated state, doomed
by a promise it had not read above, landed at an empty coordinator,
where a long-lived client could take it for the cluster state and wait
on roles that never served.  Here the whole deployment, held by
``chip_smoke.rolling_errors`` as phase 33 holds it on the card: one
founding; the first attempt after each kill commits; every acknowledged
write read back through a fresh CLI after the last kill; every server
stopped with exit code 0 on SIGTERM.  A shard whose two replicas were
on two servers restarted in turn has no replica left (ROADMAP C2):
the server logs show it, and a wait on that shard is not held against
the repair.  About 40 s.
"""

from __future__ import annotations

import os
import sys
import time

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
sys.path.insert(0, os.path.dirname(TESTS))

import chip_smoke as cs  # noqa: E402
from test_torch_cluster_refresh import deployment  # noqa: E402
from torch_parity import PORT  # noqa: E402


def test_rolling_restart_of_the_coordinators_founds_one_database():
    t = time.perf_counter()
    r = deployment(PORT, "--rolling")
    assert r["order"] == "coordinators", r
    assert [k["victim"] for k in r["kills"]] == [0, 1, 2], r
    assert cs.rolling_errors(r) == [], r
    assert time.perf_counter() - t < 240


# the recoveries of an H100 run of phase 33 whose read-back hung: the
# shard [b'', b'\x80') had its replicas (tags 0 and 1) on the second and
# third coordinators' servers; the third's recovery kept tag 1 while its
# server was down, the second's dropped tag 0, and the last generation
# served the shard from no replica at all
_UNSERVED_RUN = [
    (0, 343.427, {"Type": "RecoveryState", "Step": "writing_cstate",
                  "Epoch": 1, "StorageTags": [0, 1, 2, 3]}),
    (2, 343.431, {"Type": "RecoveryComplete", "Epoch": 1}),
    (2, 343.435, {"Type": "RecoveryState", "Step": "accepting_commits",
                  "Epoch": 1, "ActiveTags": [0, 1, 2, 3]}),
    (2, 370.106, {"Type": "RecoveryComplete", "Epoch": 3}),
    (2, 370.107, {"Type": "RecoveryState", "Step": "accepting_commits",
                  "Epoch": 3, "ActiveTags": [1, 2]}),
    (1, 386.053, {"Type": "StorageMoveRecruited", "Tag": 3,
                  "Begin": "b'\\x80'", "End": "b'\\xff\\xff\\xff'"}),
    (1, 386.057, {"Type": "FetchKeysComplete", "Tag": 3}),
    (1, 386.067, {"Type": "RecoveryComplete", "Epoch": 4}),
    (1, 386.068, {"Type": "RecoveryState", "Step": "accepting_commits",
                  "Epoch": 4, "ActiveTags": [2, 3]}),
]


def _record(tmp_path, events) -> dict:
    import json
    ports = [1001, 1002, 1003, 1004]
    for i, t, ev in events:
        with open(tmp_path / f"fdbserver.{ports[i]}.log", "a") as f:
            f.write(json.dumps({"Time": t, "Severity": 10, **ev}) + "\n")
    return cs.recovery_record(str(tmp_path), ports)


@pytest.mark.parametrize("served", [False, True])
def test_read_back_wait_on_a_shard_the_last_generation_left_unserved(
        tmp_path, served):
    """A shard none of whose replicas the last completed recovery made
    active (every one it counts sat on a server that was down, and comes
    back empty) excuses a hung read-back of its keys (ROADMAP C2), and
    only of its keys: with one of its tags active, the same hang fails
    the gate."""
    events = list(_UNSERVED_RUN)
    if served:
        events[-1] = (1, 386.068, {"Type": "RecoveryState",
                                   "Step": "accepting_commits", "Epoch": 4,
                                   "ActiveTags": [1, 2, 3]})
    rec = _record(tmp_path, events)
    assert rec["recovery_complete"] == [[2, 1], [2, 3], [1, 4]]
    assert rec["unfetched"] == [] and rec["no_source"] is None
    assert rec["unserved"] == ([] if served else [["b''", "b'\\x80'"]])
    hung = {"hung": cs.ROLLING_READ_S}
    err = cs.read_back_error(hung, rec, {"first": "1", "rolling/w00": "v0"})
    assert (err is None) is not served
    assert cs.read_back_error(hung, rec, {"\xff": "x"}) is not None
