"""The port's oracle-checked workloads against the JAX package's:
Serializability and ConflictRange, the cases of tests/test_workloads.py
that hold the resolver's verdicts to an exhaustive model of the history.

test_serializability_oracle runs on both packages under each of its
seeds, the port's cluster on ``torch.device("cpu")`` (the ``cuda``
backend's plain versions), with its own assertions, and what the two
showed is held equal exactly (``torch_parity.hold_to_reference``).

The reference's three ConflictRange cases take 40 to 95 s each on a
CPU and run at full size in their own file.  Here the same spec (6
keys, 4 clients, the same seeds and cluster) goes through both
packages' ``run_workloads`` at 6 operations a client instead of 20 and
25, and what they showed is held equal; each keeps its reference
test's claim at that size: every operation commits in the end, and
seed 11 sees real conflicts.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          assert_same, buggify_off, hold_to_reference,
                          one_torch_thread, results_of, run_workload_specs)

FILE = "test_workloads.py"
OPS, CLIENTS = 6, 4


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_serializability_oracle(seed, monkeypatch):
    ref = hold_to_reference(FILE, "test_serializability_oracle", monkeypatch,
                            args={"seed": seed})
    assert results_of(ref, "run_workloads")[0]["Serializability"][
        "committed"] > 0


@pytest.mark.parametrize("seed", [0, 1, 11],
                         ids=["workload[0]", "workload[1]", "sees_conflicts"])
def test_conflict_range_at_fewer_operations(seed, monkeypatch):
    specs = [{"testName": "ConflictRange", "nodeCount": 6,
              "opsPerClient": OPS}]
    ref = run_workload_specs(REF, monkeypatch, specs, seed, CLIENTS)
    assert_same(ref, run_workload_specs(PORT, monkeypatch, specs, seed,
                                        CLIENTS))
    res = results_of(ref, "run_workloads")[0]["ConflictRange"]
    assert res["commits"] == OPS * CLIENTS
    if seed == 11:
        assert res["conflicts"] > 0
