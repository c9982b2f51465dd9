"""The port's API-contract and operational workloads against the JAX
package's: the cases of tests/test_workloads_r5.py.

WriteDuringRead, FuzzApiCorrectness, SelectorCorrectness, Storefront,
SpecialKeySpaceCorrectness and LowLatency on the in-process cluster, and
BackupToDBCorrectness (a DR switchover into a second in-process cluster
that the workload builds on the context's device), Rollback,
RandomMoveKeys and TagThrottle on the simulated cluster.  Each scenario
runs on both packages under its own seed, the port's clusters on
``torch.device("cpu")``, with its own assertions, and what the two
showed is held equal exactly: every workload's metrics and every read,
read version and commit version (``torch_parity.hold_to_reference``).
A scenario whose cluster recovers also runs the port without the
resolver retire for the comparison.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          assert_same, buggify_off, hold_to_reference,
                          one_torch_thread, run_reference_test)

FILE = "test_workloads_r5.py"

CASES = ["test_write_during_read_and_fuzz",
         "test_selector_storefront_specialkeys", "test_lowlatency",
         "test_backup_to_db_switchover_sim", "test_rollback_workload_sim",
         "test_random_move_keys_sim", "test_tag_throttle_sim"]

# the scenarios whose simulated cluster recovers (a TLog machine killed)
RECOVERS = {"test_rollback_workload_sim"}


@pytest.mark.parametrize("test", CASES, ids=[t[5:] for t in CASES])
def test_scenario_matches_reference(test, monkeypatch):
    hold_to_reference(FILE, test, monkeypatch, recovers=test in RECOVERS)


@pytest.mark.cuda
def test_dr_switchover_on_the_card_matches_reference(monkeypatch):
    """The DR switchover with the port's resolvers on the card, the
    destination cluster's too: what it showed, with the client's refresh
    gathered (``torch_parity.gathered``), equals the reference's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = "test_backup_to_db_switchover_sim"
    ref = run_reference_test(FILE, t, REF, monkeypatch)
    card = run_reference_test(FILE, t, PORT, monkeypatch,
                              device=torch.device("cuda"), majority=False)
    assert_same(ref, card)
