"""The port's simulation workloads against the JAX package's: the cases
of tests/test_workloads.py beyond cycle (tests/test_torch_workloads.py)
and the oracle-checked ones (tests/test_torch_workloads_oracle.py).

Each scenario runs on both packages under its own seed, the port's
clusters on ``torch.device("cpu")``, with its own assertions, and what
the two showed is held equal exactly: every workload's metrics and
every read, read version and commit version
(``torch_parity.hold_to_reference``).

The reference's test_readwrite takes over 20 s on a CPU and runs at
full size in its own file; here its spec goes through both packages'
``run_workloads`` with fewer transactions, and what they showed is held
equal.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          assert_same, buggify_off, hold_to_reference,
                          one_torch_thread, results_of, run_reference_test,
                          run_workload_specs)

FILE = "test_workloads.py"

CASES = ["test_mixed_workloads_concurrent", "test_workload_determinism",
         "test_watches_workload", "test_histogram_percentiles",
         "test_increment_and_versionstamp_workloads",
         "test_api_correctness_workload", "test_sideband_workload",
         "test_bank_transfer_workload"]


@pytest.mark.parametrize("test", CASES, ids=[t[5:] for t in CASES])
def test_scenario_matches_reference(test, monkeypatch):
    hold_to_reference(FILE, test, monkeypatch)


def test_configure_database_workload_with_cycle(monkeypatch):
    """Role-count changes force recoveries mid-run on the simulated
    cluster, so the port also runs without the resolver retire for the
    comparison."""
    hold_to_reference(FILE, "test_configure_database_workload_with_cycle",
                      monkeypatch, recovers=True)


def test_readwrite_at_fewer_operations(monkeypatch):
    """The reference's test_readwrite (30 transactions a client) at 10:
    the same spec, seed and cluster through both packages."""
    specs = [{"testName": "ReadWrite", "nodeCount": 200,
              "transactionsPerClient": 10}]
    ref = run_workload_specs(REF, monkeypatch, specs, 9, 2)
    assert_same(ref, run_workload_specs(PORT, monkeypatch, specs, 9, 2))
    assert results_of(ref, "run_workloads")[0]["ReadWrite"][
        "transactions"] == 20


@pytest.mark.cuda
def test_api_correctness_on_the_card_matches_reference(monkeypatch):
    """The API-correctness case with the port's resolvers on the card:
    what it showed equals the reference's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t = "test_api_correctness_workload"
    ref = run_reference_test(FILE, t, REF, monkeypatch)
    card = run_reference_test(FILE, t, PORT, monkeypatch,
                              device=torch.device("cuda"))
    assert_same(ref, card)
