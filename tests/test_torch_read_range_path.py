"""The reference's read-path and range-path tests run against the port:
every test of tests/test_read_path.py and test_range_path.py, with its
own assertions, on both packages (``torch_parity.hold_to_reference``),
one case for each of its ``parametrize`` cases.  These are the paths
the perf smoke's ``read`` and ``scan`` stages time.

The port's clusters and storage servers run on ``torch.device("cpu")``
(``patch_port``), where the read mirror's plain version answers.
Besides the scenarios' own transcripts (every read, range read, read
and commit version), each package's storage-server answers (point,
batched, range, packed range and key-selector reads) and its engines'
batched reads are recorded and held equal between the two.
"""

from __future__ import annotations

import inspect
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          buggify_off, hold_to_reference, one_torch_thread,
                          reference_param_cases, run_reference_test)

CASES = {
    "test_read_path.py": [
        "test_get_values_wire_roundtrip",
        "test_version_gate_fences_713_peer",
        "test_get2_batch_matches_scalar",
        "test_engine_get_batch_matches_scalar",
        "test_storage_get_values_matches_scalar",
        "test_storage_get_values_engine_fallthrough",
        "test_storage_get_values_per_key_fences",
        "test_get_values_fails_over_lagged_and_compacted_replicas",
        "test_get_multi_matches_get_loop",
        "test_concurrent_gets_coalesce_and_match",
        "test_get_multi_spans_shard_boundaries",
        "test_capture_interval_pass_matches_per_feed_scan",
        "test_snapshot_stream_adaptive_chunk"],
    "test_range_path.py": [
        "test_get_range_wire_roundtrip",
        "test_packed_rows_surface",
        "test_version_gate_fences_714_peer",
        "test_engine_range_runs_match_range",
        "test_vmap_range_rows_matches_range_read",
        "test_storage_packed_matches_legacy_engineless",
        "test_storage_packed_matches_legacy_engine",
        "test_storage_packed_status_codes",
        "test_replica_group_fails_over_refused_packed_chunks",
        "test_get_range_packed_knob_equivalence",
        "test_get_range_packed_columns_api",
        "test_scan_across_live_dd_split",
        "test_kvr_bytes_identical_columns_vs_tuples",
        "test_paged_snapshot_columns_matches_rows",
        "test_expire_data_before",
        "test_expire_on_live_agent_survives_next_flush",
        "test_expire_then_restore_still_byte_identical",
        "test_get_key_wire_roundtrip_and_716_fence",
        "test_get_key_selector_equivalence_randomized",
        "test_get_key_replica_failover_on_refusal",
        "test_get_key_storage_counts_and_fences"],
}

# what the scenarios read; not the versions, which the in-process
# cluster's sequencer takes from the wall clock (the reference's two runs
# of one scenario differ there too), nor the backup classes' results,
# which are versions
RECORDED = {
    "client.transaction.Transaction": ("get", "get_range", "get_multi",
                                       "get_key"),
    "backup.agent.BackupAgent": (),
    "backup.container.BackupContainer": (),
    "core.storage_server.StorageServer": ("get_value", "get_values",
                                          "get_key_values",
                                          "get_key_values_packed",
                                          "get_key"),
}


# scenarios that clear rows their storage server's engine holds and read
# them before the clear is durable: the reference serves the rows (ROADMAP
# C), the port does not.  Each package passes the scenario's own
# assertions; the port without its repair (``torch_parity.unmasked``) is
# held to the reference's transcript
STALE_READS = {"test_storage_get_values_engine_fallthrough",
               "test_storage_packed_matches_legacy_engine"}

# two backup scenarios on the in-process cluster: their container's file
# names carry the wall-clock versions and the backup's uid is random, so
# two runs of either package differ there.  Each package passes the
# scenario's own assertions, and the two make the same calls in the
# same order
WALL_CLOCK = {"test_expire_on_live_agent_survives_next_flush",
              "test_expire_then_restore_still_byte_identical"}


@pytest.mark.parametrize("file,test,args", reference_param_cases(CASES))
def test_reference_read_range_path(file, test, args, monkeypatch,
                                   tmp_path_factory):
    def fixtures(mod):
        """The case's parameters and the pytest fixtures it asks for:
        each run its own MonkeyPatch and directory."""
        kw = dict(args)
        wanted = inspect.signature(getattr(mod, test)).parameters
        if "monkeypatch" in wanted:
            kw["monkeypatch"] = monkeypatch
        if "tmp_path" in wanted:
            kw["tmp_path"] = tmp_path_factory.mktemp("case")
        return kw
    if test not in WALL_CLOCK:
        assert hold_to_reference(file, test, monkeypatch, args=fixtures,
                                 recorded=RECORDED,
                                 stale_reads=test in STALE_READS) is not None
        return
    ref, port = (run_reference_test(file, test, p, monkeypatch,
                                    args=fixtures, recorded=RECORDED)
                 for p in (REF, PORT))
    assert [e[0] for e in ref["transcript"]] == \
        [e[0] for e in port["transcript"]]
    assert [sorted(d) != [] for d in ref["disks"]] == \
        [sorted(d) != [] for d in port["disks"]]
