"""The reference's control-path and client tests run against the port:
every test of tests/test_shard_load.py, test_ratekeeper_v2.py,
test_locality.py, test_txn_options.py, test_metrics_plane.py,
test_runtime.py, test_profiler.py, test_trace_log.py,
test_abort_parity.py and test_directory.py, with its own assertions and
fixtures, on both packages (``torch_parity.hold_case``).

Besides the scenarios' own transcripts (every read, read version and
commit version of a transaction), each package's shard heat, rate
keeper, locality, metrics registry, histogram and counter, error-code,
abort-parity workload and report, and directory results are recorded (``RECORDED``) and held equal between
the two.  Three files read a host clock, and what they time is held by
the reference's own assertions only, not recorded: the events' ``Time``
of test_trace_log.py's logs (``clock=time.time``), test_profiler.py's
stall durations and its TransactionTrace ``*Ms`` stage times
(``time.monotonic``, a real event loop), and
test_metrics_plane.py::test_rate_meter_wall_clock_outside_loop's rates.

``test_trace_batch_probes_sampled_txns`` (``WALL_CLOCK``) runs an
in-process cluster on a real event loop, whose versions come from the
host's clock: it is held to the same transactions' calls in the same
order.  test_runtime.py's ``test_knobs`` reads the default conflict
backend, ``numpy`` in the reference and ``cuda`` in the port, and sets
the reference's device kind ``tpu``, the port's ``cuda`` (``EDITS``;
ROADMAP C, divergences by design).
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
    "test_shard_load.py": [
        "test_decaying_rate_converges_and_decays",
        "test_decaying_rate_warmup_is_biased_low",
        "test_reservoir_weighted_midpoint",
        "test_reservoir_single_hot_key_returns_none",
        "test_reservoir_stays_bounded",
        "test_weighted_split_key_respects_bounds",
        "test_tracker_ranks_hot_over_cold",
        "test_tracker_reservoir_tracks_workload_shift",
        "test_tracker_packed_batch_accounting",
        "test_replica_spread_policies_equivalent_results",
        "test_rotate_spreads_across_team",
        "test_rotate_failover_skips_penalized_replica",
        "test_degraded_replicas_rank_last_under_every_policy",
        "test_least_policy_is_deterministic",
        "test_heat_arms_tag_throttle_before_global_falloff",
        "test_heat_blind_tick_holds_clamp",
        "test_heat_never_arms_without_dominant_tag",
        "test_heat_below_wedge_horizon_does_not_arm",
        "test_heat_split_under_sustained_skew",
    ],
    "test_ratekeeper_v2.py": [
        "test_hot_tag_throttled_cold_unaffected",
        "test_cold_admit_not_blocked_by_draining_hot_tag",
        "test_idle_tag_demand_decays",
        "test_no_dominant_tag_falls_back_to_global_throttle",
        "test_priority_lanes",
        "test_grv_proxy_routes_lanes_and_tags",
        "test_transaction_carries_priority_and_tag",
    ],
    "test_locality.py": [
        "test_addresses_and_boundaries_match_cluster_state",
        "test_status_json_special_key",
    ],
    "test_txn_options.py": [
        "test_retry_limit_bounds_on_error",
        "test_max_retry_delay_caps_backoff",
        "test_timeout_bounds_the_retry_loop",
        "test_timeout_bounds_blocking_reads",
        "test_timeout_zero_means_unbounded",
    ],
    "test_metrics_plane.py": [
        "test_histogram_bucket_edges",
        "test_histogram_percentile_edges",
        "test_histogram_clear_on_log",
        "test_counter_collection_rates_across_emits",
        "test_registry_emission_order_and_gauges",
        "test_registry_emission_deterministic_under_sim_clock",
        "test_registry_emitter_runs_on_virtual_cadence",
        "test_rate_meter_uses_virtual_time_under_sim",
        "test_rate_meter_wall_clock_outside_loop",
        "test_stall_metrics_surface_empty_without_profiler",
        "test_stall_metrics_surface_with_profiler",
        "test_cluster_registers_every_role_kind",
    ],
    "test_runtime.py": [
        "test_rng_deterministic",
        "test_rng_ranges",
        "test_errors",
        "test_knobs",
        "test_sim_virtual_time",
        "test_sim_determinism",
        "test_sim_quiescence_detected",
        "test_timeout_error",
        "test_promise_stream_and_actor_collection",
        "test_trace_events",
        "test_buggify_deterministic",
    ],
    "test_profiler.py": [
        "test_injected_stall_is_caught_and_attributed",
        "test_profiler_noop_under_simulation",
        "test_trace_batch_probes_sampled_txns",
        "test_trace_batch_sampling_rate",
    ],
    "test_trace_log.py": [
        "test_roll_at_byte_boundary",
        "test_roll_sequence_continues_across_restart",
        "test_every_event_shape_is_json_serializable",
        "test_trace_batch_live_table_is_bounded",
    ],
    "test_abort_parity.py": [
        "test_range_heavy_abort_parity_gate",
        "test_fat_txn_exact_routing_matches_cpp",
        "test_fat_txn_never_misses_pre_sidecar_slim_write",
        "test_hybrid_slim_sees_fat_writes",
    ],
    "test_directory.py": [
        "test_subspace_pack_unpack_range",
        "test_directory_create_open_list_remove",
        "test_directory_move_and_layer_check",
        "test_directory_partition_moves_as_unit",
        "test_hca_unique_under_contention",
        "test_directory_path_crossing_partition_routes_inside",
    ],
}

RECORDED = {
    "test_shard_load.py": {
        "core.shard_load.DecayingRate": None,
        "core.shard_load.HeatReservoir": None,
        "core.shard_load.ShardHeatTracker": None,
        "core.shard_load": ("weighted_split_key",)},
    "test_ratekeeper_v2.py": {"core.ratekeeper.Ratekeeper": None},
    "test_locality.py": {"client.locality": ("get_addresses_for_key",
                                             "get_boundary_keys")},
    "test_metrics_plane.py": {"runtime.metrics.MetricsRegistry": None,
                              "runtime.trace.Histogram": None,
                              "runtime.trace.CounterCollection": None},
    "test_runtime.py": {"runtime.errors": ("error_from_code",)},
    "test_abort_parity.py": {
        "bench.abort_parity": ("run_parity",),
        "bench.abort_parity.RangeHeavyWorkload": None},
    "test_directory.py": {"client.directory.DirectoryLayer": None},
}
WALL_CLOCK = {"test_trace_batch_probes_sampled_txns"}
EDITS = {"test_runtime.py": (
    ('"tpu"', '"cuda"'),
    ('== "numpy"  # original', '== "cuda"  # original'))}


@pytest.mark.parametrize("file,test,args", reference_param_cases(CASES))
def test_reference_control_path(file, test, args, monkeypatch,
                                tmp_path_factory):
    hold_case(file, test, args, monkeypatch, tmp_path_factory,
              recorded=RECORDED.get(file), wall_clock=test in WALL_CLOCK,
              port_edits=EDITS.get(file, ()))
