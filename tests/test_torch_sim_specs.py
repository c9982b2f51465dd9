"""The port's spec runner (``sim/spec.py``) against the JAX package's:
the cases of tests/test_ops_workloads.py and tests/test_restarting.py.

Each runs a spec file of tests/specs/ (or, for the restart without a
protocol bump, a spec written in the test) through ``run_spec`` on both
packages under its own seed, with its own assertions: as written against
the reference, and with its imports pointed at the port, whose simulated
cluster, and the DR destination cluster that ``DRUnderAttrition``
builds, run on ``torch.device("cpu")`` (the kernels' plain versions).
Every one of these clusters recovers (machine attrition, region
failover, engine migration, a whole-cluster power loss), so the port
runs twice: as it is, making the assertions, and without the resolver
retire, held to the reference exactly: the spec's results (each phase's
workload metrics and the restart's continuity), every read, read version
and commit version, every cluster state waited for, every result of the
backup and DR agents, and the bytes of every simulated disk
(``torch_parity.hold_to_reference``).

backup_dr_chaos.toml is tests/test_torch_sim_backup_dr.py's.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (api_version_reset,  # noqa: E402,F401
                          buggify_off, hold_to_reference, one_torch_thread,
                          results_of)

OPS = ["test_livemove_storm_spec", "test_lock_directory_spec",
       "test_region_chaos_spec", "test_engine_migration_spec",
       "test_api_correctness_chaos_spec"]


@pytest.mark.parametrize("test", OPS, ids=[t[5:-5] for t in OPS])
def test_ops_spec_matches_reference(test, monkeypatch):
    hold_to_reference("test_ops_workloads.py", test, monkeypatch,
                      recovers=True)


RESTARTING = ["test_cycle_restart_upgrade_spec", "test_chaos_spec_runs",
              "test_restart_without_protocol_bump"]


@pytest.mark.parametrize("test", RESTARTING, ids=[t[5:] for t in RESTARTING])
def test_restarting_spec_matches_reference(test, monkeypatch):
    ref = hold_to_reference("test_restarting.py", test, monkeypatch,
                            recovers=True)
    res = results_of(ref, "run_spec")[0]
    if test != "test_chaos_spec_runs":
        assert res["restart"]["rows"] > 0
