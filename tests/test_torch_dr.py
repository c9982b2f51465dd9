"""The port's DR, log routers, regions and tag stream against the JAX
package's.

Each scenario of the reference's own tests (tests/test_dr.py,
test_log_router.py, test_regions.py and test_tag_stream_safety.py) runs
twice under its own seed: as written against the reference (``numpy``
backend), and with its imports pointed at the port, whose simulated
clusters run the ``cuda`` backend on ``torch.device("cpu")`` so the
kernels' plain versions answer.  Both runs make the reference's own
assertions.  Then what each showed is held equal, exactly: every read,
read version and commit version (so the switchover and drain versions),
every cluster state waited for (the epochs and the recruited layout:
TLogs, satellites, routers, storage teams by datacenter), every result
of the DR agent, the tag stream and the log router (its frontier and
pops), and the bytes of every simulated disk.
"""

from __future__ import annotations

import asyncio
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          assert_same, buggify_off, hold_to_reference,
                          one_torch_thread, reference_cases,
                          run_reference_test)

CASES = {
    "test_dr.py": [
        "test_dr_replicates_sets_clears_atomics",
        "test_dr_switchover_is_loss_free_and_locks_source",
        "test_dr_survives_source_recovery",
        "test_database_lock_semantics",
        "test_lock_survives_recovery",
        "test_dest_locked_during_dr",
        "test_backup_and_dr_tags_coexist"],
    "test_log_router.py": [
        "test_router_fans_out_one_pull_to_two_consumers",
        "test_router_lagging_consumer_pins_router_not_primary",
        "test_dr_through_router_over_rpc",
        "test_router_survives_source_recovery"],
    "test_regions.py": [
        "test_region_aware_recruitment",
        "test_primary_region_loss_no_acked_data_lost",
        "test_dd_split_preserves_region_placement",
        "test_region_failback_when_primary_returns",
        "test_satellite_survives_in_old_generation_peek"],
    "test_tag_stream_safety.py": [
        "test_unconfirmed_tail_held_until_grv_passes",
        "test_phantom_version_discarded_on_epoch_roll",
        "test_frontier_never_advances_past_unconfirmed_tip",
        "test_rewind_replays_span"],
}


@pytest.mark.parametrize("file,test", reference_cases(CASES))
def test_scenario_matches_reference(file, test, monkeypatch):
    hold_to_reference(file, test, monkeypatch)


# the reference's two-region layout (tests/test_regions.py): primary dc1
# with a satellite log in sat1, remote dc2
DCIDS = ["dc1", "sat1", "dc2", "dc1", "dc2", "dc2"]
REGIONS = [{"id": "dc1", "priority": 1, "satellite": "sat1",
            "satellite_logs": 1},
           {"id": "dc2", "priority": 0}]


def test_two_region_spec_recruits_its_log_routers():
    """A two-region spec on the port's simulated cluster on the CPU: the
    recovery recruits one log router per remote storage tag, each in
    dc2, and each router's frontier moves past its recruitment while its
    remote replica pops it."""
    from foundationdb_tpu_torch.core.cluster_controller import \
        ClusterConfigSpec
    from foundationdb_tpu_torch.core.log_router import LogRouter
    from foundationdb_tpu_torch.runtime.knobs import Knobs
    from foundationdb_tpu_torch.runtime.simloop import run_simulation
    from foundationdb_tpu_torch.sim import SimulatedCluster

    async def main():
        sim = SimulatedCluster(
            Knobs(), n_machines=6, dcids=DCIDS,
            spec=ClusterConfigSpec(min_workers=6, logs=2, replication=1,
                                   regions=[dict(r) for r in REGIONS]),
            device=torch.device("cpu"))
        await sim.start()
        state = await sim.wait_epoch(1)
        db = await sim.database()
        for i in range(10):
            await db.set(b"r%02d" % i, b"v%02d" % i)
        await asyncio.sleep(2.0)
        routers = [(m.index, obj) for m in sim.machines
                   if m.host is not None
                   for role, obj in m.host.worker.roles.values()
                   if role == "log_router"]
        remote = sorted(s["tag"] for s in state["storage"]
                        if s["dcid"] == "dc2")
        out = (sorted(r[0] for r in state["log_cfg"][-1]["routers"]),
               remote, [DCIDS[i] for i, _ in routers],
               [type(r) is LogRouter for _, r in routers],
               [r.metrics() for _, r in routers],
               await db.get(b"r09"))
        await sim.stop()
        return out

    tags, remote, dcs, typed, metrics, last = run_simulation(main(), seed=3)
    assert tags == remote and len(tags) >= 1
    assert dcs == ["dc2"] * len(tags) and all(typed)
    assert all(m["end"] > 1 and max(m["pops"].values()) > 1
               for m in metrics), metrics
    assert last == b"v09"


# --------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_region_failover_on_the_card_matches_reference(monkeypatch):
    """The primary region's loss with the port's resolvers on the card:
    what the scenario showed, with the client's refresh gathered
    (``torch_parity.gathered``), equals the reference's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    f, t = "test_regions.py", "test_primary_region_loss_no_acked_data_lost"
    ref = run_reference_test(f, t, REF, monkeypatch)
    card = run_reference_test(f, t, PORT, monkeypatch,
                              device=torch.device("cuda"), majority=False)
    assert_same(ref, card)
