"""The reference's fault, replication and data-movement tests run
against the port: every test of tests/test_disk_faults.py,
test_regressions.py, test_replication.py,
test_change_coordinators_sim.py, test_change_coordinators.py,
test_live_move.py and test_engine_migration.py, with its own assertions
and fixtures, on both packages (``torch_parity.hold_case``), one case
for each of its ``parametrize`` cases.  The port's clusters, resolvers
and storage servers run on ``torch.device("cpu")`` (``patch_port``).

Besides the scenarios' own transcripts (every read, read version,
commit version and cluster state waited for) and every simulated
disk's bytes, the disk queues', shard maps', replica groups', rate
keepers' and coordinated states' results, the coordinator changes' and
elections' and the live moves' team drops are recorded (``RECORDED``)
and held equal between the two.  Nothing is
left out of the comparison.  ``test_disk_faults.py`` leaves the
reference's BUGGIFY on; ``buggify_off`` turns both packages' off around
each case.

Three scenarios recover a simulated cluster (``RECOVERS``): after a
recovery the port's controller retires the ended generation's
resolvers, an RPC that shifts the simulated network's draws (ROADMAP
C), so the port runs them twice, as it is with their assertions
and without the retire for the comparison.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (api_version_reset, buggify_off,  # noqa: E402,F401
                          hold_case, one_torch_thread,
                          reference_param_cases)

CASES = {
    "test_disk_faults.py": [
        "test_torn_kill_never_touches_synced_bytes",
        "test_disarmed_profile_is_all_or_nothing_drop",
        "test_io_error_and_stall_injection",
        "test_disk_queue_mid_file_corruption_raises_loudly",
        "test_disk_queue_torn_tail_still_discards_silently",
        "test_disk_queue_truncated_header_page_raises_loudly",
        "test_disk_queue_short_fresh_file_still_reinits",
        "test_disk_queue_read_frames_raises_on_corrupt_live_frame",
        "test_disk_queue_survives_torn_header_write",
        "test_engine_recovers_committed_state_through_torn_kill",
        "test_chaos_durable_cluster_with_hostile_disks",
        "test_gray_failure_detection_and_avoidance",
    ],
    "test_regressions.py": [
        "test_bad_versionstamp_fails_alone_without_wedging_cluster",
        "test_limited_range_read_with_large_buffered_clear",
        "test_watch_fails_on_reset_instead_of_hanging",
        "test_tlogs_only_retain_hosted_tags",
        "test_shard_map_boundary_range",
        "test_shard_map_keyspace_end_threaded",
        "test_unrepairable_state_batch_fail_stops_proxy",
        "test_pure_user_batch_repairs_without_fail_stop",
        "test_fat_txn_sidecar_floor_tracks_txn_life_window",
    ],
    "test_replication.py": [
        "test_double_replication_reads_and_consistency",
        "test_load_balance_fails_over",
        "test_load_balance_nonretryable_propagates",
        "test_ratekeeper_throttles_on_queue",
        "test_ratekeeper_full_rate_when_healthy",
        "test_replicated_durable_restart",
    ],
    "test_change_coordinators_sim.py": [
        "test_change_quorum_live_cluster",
        "test_change_quorum_mover_dies_after_intent",
        "test_change_quorum_overlapping_set",
        "test_change_quorum_with_machine_kill_mid_change",
    ],
    "test_change_coordinators.py": [
        "test_change_moves_state_and_retires_old",
        "test_old_quorum_value_readers_learn_the_move",
        "test_change_crash_after_copy_before_retire",
        "test_completion_skips_copy_when_forward_visible",
        "test_partial_retire_cannot_split_brain",
    ],
    "test_live_move.py": [
        "test_write_team_drops_on_flip",
        "test_write_team_drops_none_on_start",
        "test_write_team_drops_merges_adjacent",
        "test_normalize_layout_rolls_back_in_flight",
        "test_normalize_layout_rolls_forward_flip",
        "test_storage_drop_fences_reads",
        "test_live_split_without_recovery",
        "test_live_split_multi_proxy_multi_resolver",
        "test_state_txn_user_read_conflict_rejected",
        "test_recovery_mid_move_rolls_back",
        "test_source_engine_gc_after_live_split",
        "test_live_move_of_system_keyspace_shard",
    ],
    "test_engine_migration.py": [
        "test_live_engine_migration_memory_to_btree",
    ],
}

RECORDED = {
    "test_disk_faults.py": {"storage.disk_queue.DiskQueue": None},
    "test_regressions.py": {"core.shard_map.ShardMap": None},
    "test_replication.py": {"core.load_balance.ReplicaGroup": None,
                            "core.ratekeeper.Ratekeeper": None},
    "test_change_coordinators.py": {
        "core.coordination.CoordinatedState": None,
        "core.coordination": ("change_coordinators",
                              "complete_coordinator_move", "elect_leader")},
    "test_live_move.py": {"core.shard_map": ("write_team_drops",)},
}
RECOVERS = {"test_change_quorum_mover_dies_after_intent",
            "test_change_quorum_with_machine_kill_mid_change",
            "test_chaos_durable_cluster_with_hostile_disks"}


@pytest.mark.parametrize("file,test,args", reference_param_cases(CASES))
def test_reference_sim_faults(file, test, args, monkeypatch,
                              tmp_path_factory):
    hold_case(file, test, args, monkeypatch, tmp_path_factory,
              recorded=RECORDED.get(file), recovers=test in RECOVERS)
