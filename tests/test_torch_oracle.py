"""The port's brute-force conflict oracle (``ops/oracle.py``) against the
JAX package's, on the cases of tests/test_conflict_np.py.

That file drives the numpy twin and the oracle through seeded random
batches (``run_trace``) and through hand-built boundary cases.  Here its
source runs against each package (``torch_parity.reference_module``):
the port's oracle must give the reference oracle's verdicts, batch for
batch, on every seed and at both key lengths, and the cases that assert
on the oracle make their own assertions against the port's.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import PORT, REF, reference_module  # noqa: E402

FILE = "test_conflict_np.py"


@pytest.fixture(scope="module")
def mods():
    return {name: reference_module(FILE, name) for name in (REF, PORT)}


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("long_keys", [False, True], ids=["short", "long"])
def test_oracle_trace_matches_reference(seed, long_keys, mods):
    """``run_trace``'s verdicts, twin and oracle, equal on both packages;
    with keys of at most W bytes the port's oracle equals its twin."""
    maxlen = mods[REF].W * (3 if long_keys else 1)
    ref_twin, ref_oracle = mods[REF].run_trace(seed, maxlen=maxlen)
    twin, oracle = mods[PORT].run_trace(seed, maxlen=maxlen)
    assert oracle == ref_oracle
    assert twin == ref_twin
    if not long_keys:
        assert twin == oracle


@pytest.mark.parametrize("test", ["test_too_old_at_floor_boundary",
                                  "test_aborted_txn_writes_not_recorded"])
def test_oracle_case_on_the_port(test, mods):
    getattr(mods[PORT], test)()
