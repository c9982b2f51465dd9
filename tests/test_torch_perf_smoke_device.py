"""The perf smoke's device stages on the port, held to the reference's:
``read`` (the read mirror over an lsm engine's sparse index), ``mesh``
(the routed resolver mesh on the live commit path) and ``devplane``
(the sharded mirror and the verdict bitmask).

Each test runs both packages' ``*_seconds`` from the same seeds
(``torch_parity.stage_stats``): the reference's on the CPU, the port's
with ``device=torch.device("cpu")``, where its kernels' plain versions
answer.  The stats that do not depend on the clock are held equal; no
test asserts a wall-clock floor, ratio or budget.  The mesh's workload
is driven by the wall clock (its bands rotate every 5 ms), so its test
holds the parts beneath the stage's throughput ratio: both packages'
cold partitions answer header-only, their hot partitions' groups fuse,
and the stats carry the same keys.

The last test runs ``chip_smoke.py`` phase 30's gates on a card and
skips without one.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          buggify_off, held_equal, one_torch_thread,
                          perf_smoke, stage_stats)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("engine", [None, "lsm"])
def test_read_stage_matches_reference(engine, monkeypatch):
    """Rows read back by the concurrent readers, and the read mirror's
    served batches: none on the in-memory cluster, the same count on
    the durable lsm cluster, where the port's mirror always arms."""
    ref, port = (stage_stats(p, "read_path_seconds", monkeypatch,
                             storage_engine=engine) for p in (REF, PORT))
    got = held_equal(ref, port, ("concurrent_reads", "device_read_active",
                                 "device_read_batches"))
    assert got["concurrent_reads"] > 0
    if engine:
        assert got["device_read_active"] and got["device_read_batches"] > 0
    else:
        assert not got["device_read_active"]


def test_devplane_stage_matches_reference(monkeypatch):
    """Served batches of the twin and the sharded mirror, refreshes and
    full splits, readback bytes per txn on each side of the bitmask
    A/B, and the aborts."""
    ref, port = (stage_stats(p, "devplane_seconds", monkeypatch)
                 for p in (REF, PORT))
    held_equal(ref, port, ("twin_served", "sharded_served",
                           "shard_refreshes", "full_splits", "served_ratio",
                           "raw_bytes_per_txn", "packed_bytes_per_txn",
                           "bitmask_ratio", "aborts"))
    assert port["shards"] == perf_smoke(PORT).DEVPLANE_SHARDS
    assert port["devices"] == 0      # the CPU: no card seen


def test_mesh_stage_beneath_its_ratio(monkeypatch):
    """The stage's gates but its routed/broadcast throughput ratio (a
    wall-clock number, zeroed here for both): the cold partition's
    header-only share and skipped batches, and the hot partition's
    fused group mean."""
    out = {}
    for p in (REF, PORT):
        out[p] = stage_stats(p, "mesh_seconds", monkeypatch,
                             constants={"MESH_RATIO_FLOOR": 0.0})
    assert set(out[REF]) == set(out[PORT])
    floors = perf_smoke(PORT)
    for s in out.values():
        assert s["cold_header_frac"] > floors.MESH_HEADER_FRAC_FLOOR
        assert s["cold_skipped"] > 0
        assert s["hot_group_mean"] >= floors.MESH_GROUP_MEAN_FLOOR


def test_device_stages_need_the_card_by_default():
    """No fallback hides the card: asked for the card without one, each
    device stage raises before it does any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ps = perf_smoke(PORT)
    for fn in (ps.read_path_seconds, ps.mesh_seconds, ps.devplane_seconds):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


@pytest.mark.cuda
def test_perf_smoke_phase_on_the_card():
    """``chip_smoke.py`` phase 30's gates: the read stage's lsm mirror
    served batches, the mesh's hot group mean at its floor with K1 = K3
    > 0, the devplane floors, K1 = K3 > 0 in recover, observe, scrub and
    layers, and every B8, K3 and K1 call equal to its plain version on
    its own tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    from foundationdb_tpu_torch.ops import kernels as K
    K.build()
    cs.check_perf_smoke_phase(cs.perf_smoke_phase(torch.device("cuda")))
