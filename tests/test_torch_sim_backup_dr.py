"""The port's backup and DR under attrition against the JAX package's:
tests/test_ops_workloads.py::test_backup_dr_chaos_spec.

backup_dr_chaos.toml runs BackupUnderAttrition, DRUnderAttrition, Cycle,
MachineAttrition (2 kills) and ConsistencyCheck on a 7-machine simulated
cluster under BUGGIFY.  DRUnderAttrition builds its destination as a
second, in-process cluster at ``Knobs()`` (the default operating point,
B = 64, R = 8), which in the port runs on the workload context's device:
here ``torch.device("cpu")``, the kernels' plain versions.  The scenario
runs on both packages with its own assertions, the port as it is and
without the resolver retire (the cluster recovers), and what the
reference and the port without the retire showed is held equal exactly
(``torch_parity.hold_to_reference``): the spec's results, every
transaction's reads and versions, every result of the backup and DR
agents, and the bytes of every simulated disk.  The reference's run
takes about a minute on a CPU, the port's about 12 s, so this case has a
file of its own.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          assert_same, buggify_off, hold_to_reference,
                          one_torch_thread, results_of, run_reference_test)

FILE, TEST = "test_ops_workloads.py", "test_backup_dr_chaos_spec"


def destinations(mp) -> list:
    """Every DR destination cluster the port's DRUnderAttrition builds,
    collected as its setup makes it."""
    from foundationdb_tpu_torch.workloads import ops
    made: list = []
    setup = ops.DRUnderAttritionWorkload.setup

    async def collecting(self):
        await setup(self)
        if self._dest_cluster is not None:
            made.append(self._dest_cluster)
    mp.setattr(ops.DRUnderAttritionWorkload, "setup", collecting)
    return made


def test_backup_dr_chaos_spec_matches_reference(monkeypatch):
    """The spec on both packages; the port's DR destination resolvers on
    the CPU, and the card never touched."""
    made = destinations(monkeypatch)
    ref = hold_to_reference(FILE, TEST, monkeypatch, recovers=True)
    phase1 = results_of(ref, "run_spec")[0]["phase1"]
    assert phase1["BackupUnderAttrition"]["snapshots"] >= 1
    assert len(made) == 2               # the port's two runs
    for dest in made:
        assert [r.backend.cs.device for r in dest.resolvers] == \
            [torch.device("cpu")]
    assert not torch.cuda.is_initialized()


@pytest.mark.cuda
def test_backup_dr_chaos_spec_on_the_card_matches_reference(monkeypatch):
    """The spec with every resolver and read mirror on the card, the DR
    destination's too: the assertions as it is, and without the retire
    and with the client's refresh gathered, what it showed equals the
    reference's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    made = destinations(monkeypatch)
    cuda = torch.device("cuda")
    ref = run_reference_test(FILE, TEST, REF, monkeypatch)
    run_reference_test(FILE, TEST, PORT, monkeypatch, device=cuda)
    card = run_reference_test(FILE, TEST, PORT, monkeypatch, device=cuda,
                              retire=False, majority=False)
    assert_same(ref, card)
    assert all(r.backend.cs.device.type == "cuda"
               for dest in made for r in dest.resolvers)
