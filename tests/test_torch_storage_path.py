"""The reference's storage-path tests run against the port: every test
of tests/test_versioned_map.py, test_key_runs.py, test_mvcc_window.py,
test_lsm_leveled.py, test_mutation_batch.py, test_slotted_blob.py,
test_change_feed.py, test_durable_tlog.py and test_log_system.py, with
its own assertions and fixtures (its ``autouse`` ones too), on both
packages (``torch_parity.hold_case``), one case for each of its
``parametrize`` cases; a case of a test the reference marks ``slow``
is marked ``slow`` too.

Besides the scenarios' own transcripts (every read, read version and
commit version of a transaction) and every simulated disk's bytes,
each package's storage structures are recorded (``RECORDED``) and held
equal between the two: the MVCC windows' answers and state changes,
the key runs' and key index's batched searches and merges, the lsm
engine's reads, the mutation batches', slotted blobs', change feeds'
and log systems' results.  One field is left out of the comparison
(``LEFT_OUT``): ``merge_ms`` in the key index's and the MVCC window's
stats, the host's clock timing a merge.

Four scenarios recover a simulated cluster (``RECOVERS``): after a
recovery the port's controller retires the ended generation's
resolvers, an RPC that shifts the simulated network's draws (ROADMAP
C), so the port runs them twice, as it is with their assertions
and without the retire for the comparison.  One scenario
(``WALL_CLOCK``) runs an in-process cluster on a real event loop, whose
versions come from the host's clock (two runs of the reference differ
too): it is held to the same transactions' calls in the same order and
the same files on each simulated disk.
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
    "test_versioned_map.py": [
        "test_versioned_map_matches_brute_force",
        "test_apply_batch_matches_sequential",
        "test_apply_batch_clear_sees_fresh_keys",
        "test_index_range_bounds_across_runs",
        "test_apply_batch_vectorized_clear_bounds",
        "test_apply_batch_scales_near_linearly",
        "test_rollback_purges_stale_state",
    ],
    "test_key_runs.py": [
        "test_key_run_matches_list_reference",
        "test_key_run_empty_and_duplicate_edges",
        "test_packed_key_index_columnar_equals_list_mode",
        "test_packed_key_index_columnar_base_is_key_run",
        "test_lsm_sparse_index_parity_after_reopen",
        "test_lsm_packed_index_gen_tracks_run_set_only",
        "test_ring_spill_peek_pop_round_trip",
        "test_ring_spill_rollback_and_torn_frames",
        "test_ring_spill_failed_push_leaves_state_intact",
        "test_ring_pop_failure_leaves_bookkeeping_retryable",
        "test_throttled_engine_spills_and_recovers_bit_identical",
    ],
    "test_mvcc_window.py": [
        "test_columnar_vs_legacy_randomized",
        "test_direct_seal_zero_copy_and_budgets",
        "test_drop_before_retires_whole_segments",
        "test_rollback_truncates_tip_and_suffix_segments",
        "test_rollback_below_drop_floor_serves_new_generation",
        "test_dead_marker_survives_reset_and_retires",
        "test_storage_server_ab_with_atomics_and_clears",
        "test_durable_reopen_replays_into_columnar_window",
        "test_factory_and_stats_surfaces",
    ],
    "test_lsm_leveled.py": [
        "test_leveled_vs_monolithic_equivalence_randomized",
        "test_tombstones_crossing_levels_and_bottom_drop",
        "test_crash_mid_compaction_recovers",
        "test_orphan_run_files_swept_at_open",
        "test_pre_leveled_manifest_opens_serves_and_compacts",
        "test_reopened_store_with_inherited_debt_compacts_without_commit",
    ],
    "test_mutation_batch.py": [
        "test_empty_batch",
        "test_zero_length_values_and_keys",
        "test_clear_range_ends",
        "test_versionstamp_and_private_ops_not_simple",
        "test_large_blob_roundtrip",
        "test_random_roundtrip_and_accessors",
        "test_select_slices",
        "test_select_duplicates_are_not_identity",
        "test_builder_indices",
        "test_version_gate_fences_711_peer",
        "test_packed_apply_equivalence",
        "test_packed_apply_respects_armed_watches",
        "test_durability_ring_slices_and_rollback",
        "test_tlog_recovers_old_format_frames",
        "test_kv_store_recovers_old_and_new_wal_frames",
    ],
    "test_slotted_blob.py": [
        "test_round_trip_and_alternation",
        "test_torn_slot_loses_to_intact_one",
        "test_both_slots_torn_reports_none_with_evidence",
        "test_failed_save_retries_same_slot",
        "test_pre_helper_slot_format_is_not_misparsed",
        "test_coordinator_recovers_pre_helper_slot",
    ],
    "test_change_feed.py": [
        "test_store_capture_clips_to_range_and_reads_in_order",
        "test_store_zero_copy_identity_slice",
        "test_store_spill_and_recovery_roundtrip",
        "test_select_numpy_matches_naive",
        "test_version_gate_fences_712_peer",
        "test_feed_wire_structs_roundtrip",
        "test_proxy_routes_feed_markers_to_owning_tags",
        "test_proxy_feed_pop_follows_range_split",
        "test_client_cannot_forge_private_markers",
        "test_proxy_routes_whole_db_feed_to_all_tags",
        "test_proxy_clamps_forged_feed_range_to_user_keyspace",
        "test_whole_db_capture_excludes_system_writes",
        "test_whole_db_feed_end_to_end_with_system_traffic",
        "test_storage_captures_resolved_atomics",
        "test_storage_rejoin_rolls_back_unacked_feed_entries",
        "test_stream_fences_and_errors",
        "test_cursor_lifecycle_end_to_end",
        "test_sim_completeness_under_buggify_attrition_bit_identical",
        "test_sim_duplicate_free_resume_after_storage_kill",
        "test_sim_feed_handoff_across_live_split",
        "test_feed_stream_spans_reach_trace_file",
        "test_capture_clips_clears_to_shard",
        "test_bad_pop_blob_rejected_and_survived",
        "test_spill_is_durability_not_memory_pressure",
    ],
    "test_durable_tlog.py": [
        "test_full_cluster_reboot_recovers_acked_commits",
        "test_reboot_tlog_adoption_preserves_undurable_suffix",
    ],
    "test_log_system.py": [
        "test_push_replicates_each_tag",
        "test_cursor_fails_over_to_live_replica",
        "test_all_replicas_dead_is_data_loss",
        "test_locked_log_rejects_push_and_reports_tip",
        "test_generation_rollover_with_clamp",
        "test_cluster_survives_replica_mark_dead",
    ],
}

# each MVCC window's answers and state changes (not its point reads,
# get and get2, which the scenarios call in loops of 10^5 and hold to a
# model themselves)
_WINDOW = ("index_stats", "keys", "get2_batch", "get_latest", "range_read",
           "range_rows", "apply_batch", "apply_packed", "forget_before",
           "drop_before", "rollback_after")
VERSIONED_MAP = {"storage.versioned_map.LegacyVersionedMap": _WINDOW,
                 "storage.versioned_map.ColumnarVersionedMap": _WINDOW}

RECORDED = {
    "test_versioned_map.py": VERSIONED_MAP,
    "test_key_runs.py": {
        "storage.key_runs.KeyRun": ("batch_bisect", "batch_find",
                                     "merge_newest_wins", "merge_sorted"),
        "storage.key_index.PackedKeyIndex": ("changed_since", "stats"),
        "storage.packed_ops.DurabilityRing": None},
    "test_mvcc_window.py": VERSIONED_MAP,
    "test_lsm_leveled.py": {
        "storage.lsm.LSMKVStore": ("get", "get_batch", "range_runs")},
    "test_mutation_batch.py": {"core.data.MutationBatch": None},
    "test_slotted_blob.py": {"rpc.wire.SlottedBlob": None},
    "test_change_feed.py": {"core.change_feed.ChangeFeedStore": None},
    "test_log_system.py": {"core.log_system.LogSystem": None,
                           "core.log_system.LogCursor": None},
}
RECOVERS = {"test_sim_completeness_under_buggify_attrition_bit_identical",
            "test_sim_duplicate_free_resume_after_storage_kill",
            "test_full_cluster_reboot_recovers_acked_commits",
            "test_reboot_tlog_adoption_preserves_undurable_suffix"}
WALL_CLOCK = {"test_throttled_engine_spills_and_recovers_bit_identical"}
LEFT_OUT = {"merge_ms"}


@pytest.mark.parametrize("file,test,args", reference_param_cases(CASES))
def test_reference_storage_path(file, test, args, monkeypatch,
                                tmp_path_factory):
    hold_case(file, test, args, monkeypatch, tmp_path_factory,
              recorded=RECORDED.get(file), recovers=test in RECOVERS,
              wall_clock=test in WALL_CLOCK, left_out=LEFT_OUT)
