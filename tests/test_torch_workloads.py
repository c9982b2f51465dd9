"""The port's simulation workloads against the JAX package's: the
cycle and serializability cases of tests/test_workloads.py.

Each scenario of the reference's own test runs twice under its own seed
and parameters: as written against the reference (``numpy`` backend),
and with its imports pointed at the port, whose in-process cluster runs
the ``cuda`` backend on ``torch.device("cpu")`` so the kernels' plain
versions answer.  Both runs make the reference's own assertions.  Then
what each showed is held equal, exactly: every workload's metrics (the
results of ``run_workloads`` and ``run_workloads_on``), and every read,
read version and commit version its transactions returned
(``torch_parity.hold_to_reference``).  The remaining cases of the file
are in tests/test_torch_workloads_api.py.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          buggify_off, hold_to_reference, one_torch_thread,
                          results_of, run_reference_test, assert_same)

FILE = "test_workloads.py"


def _config(which: str):
    """The parameter ``config`` of the reference's test_cycle, built by
    the scenario's own module (each package's ClusterConfig)."""
    return lambda mod: None if which == "single" else mod.multi()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("config", ["single", "multi"])
def test_cycle(seed, config, monkeypatch):
    def args(mod):
        return {"seed": seed, "config": _config(config)(mod)}
    ref = hold_to_reference(FILE, "test_cycle", monkeypatch, args=args)
    assert results_of(ref, "run_workloads")[0]["Cycle"]["transactions"] == 45


@pytest.mark.parametrize("backend", ["numpy", "cpp", "cuda"])
def test_cycle_all_backends(backend, monkeypatch):
    """The reference's backends as written; the port's ``cuda`` backend
    (its plain versions here) is held to the reference's exact ``numpy``
    twin."""
    ref = "numpy" if backend == "cuda" else backend
    hold_to_reference(FILE, "test_cycle_all_backends", monkeypatch,
                      args={"backend": ref}, port_args={"backend": backend})


@pytest.mark.cuda
def test_cycle_on_the_card_matches_reference(monkeypatch):
    """The multi-resolver cycle case with the port's resolvers on the
    card: what it showed equals the reference's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = {"backend": "numpy"}
    ref = run_reference_test(FILE, "test_cycle_all_backends", REF,
                             monkeypatch, args=args)
    card = run_reference_test(FILE, "test_cycle_all_backends", PORT,
                              monkeypatch, device=torch.device("cuda"),
                              args={"backend": "cuda"})
    assert_same(ref, card)
