"""The reference's resolver-path tests run against the port: every
test of tests/test_async_resolver.py, test_conflict_cpp.py and
test_keycode.py, with its own assertions, on both packages
(``torch_parity.hold_to_reference``), one case for each of its
``parametrize`` cases.

The reference's ``tpu`` kind is the port's ``cuda`` kind, and the
port's resolvers run on ``torch.device("cpu")`` (the kernels' plain
versions, ``patch_port``).  Besides the scenarios' own transcripts, each
package's resolver replies, conflict-set verdicts and key encodings are
recorded (``recorded``) and held equal between the two, tolerance 0:
they are integers and bytes.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (buggify_off, hold_to_reference,  # noqa: E402,F401
                          one_torch_thread, reference_param_cases)

CASES = {
    "test_async_resolver.py": [
        "test_tpu_backend_parity_on_real_loop",
        "test_event_loop_live_during_resolve",
        "test_batches_pipeline_submit_before_prior_finish",
        "test_resolver_fail_stops_after_sync_failure",
        "test_fused_group_parity_and_pipelining",
        "test_fused_fail_stop_poisons_queue",
        "test_split_phase_under_simulation"],
    "test_conflict_cpp.py": [
        "test_cpp_oracle_exact_parity",
        "test_cpp_numpy_parity_short_keys",
        "test_cpp_empty_batch_and_no_ranges",
        "test_cpp_set_oldest_compaction"],
    "test_keycode.py": [
        "test_encode_exact_order_short_keys",
        "test_encode_monotone_long_keys",
        "test_possibly_lt_conservative",
        "test_encode_key_matches_batch_encode",
        "test_sentinel_above_everything"],
}

# the reference's device kind is the port's cuda kind
EDITS = {"test_async_resolver.py": (('"tpu"', '"cuda"'),)}

RECORDED = {
    "test_async_resolver.py": {"core.resolver.Resolver": ("resolve",)},
    "test_conflict_cpp.py": {
        "ops.conflict_cpp.CppConflictSet": ("resolve_batch",
                                            "set_oldest_version"),
        "ops.oracle.OracleConflictSet": ("resolve_batch",),
        "ops.conflict_np.NumpyConflictSet": ("resolve_encoded",)},
    "test_keycode.py": {"ops.keycode": ("encode_keys", "encode_key",
                                        "possibly_lt")},
}


@pytest.mark.parametrize("file,test,args", reference_param_cases(CASES))
def test_reference_resolver_path(file, test, args, monkeypatch):
    shown = hold_to_reference(file, test, monkeypatch, args=args,
                              port_edits=EDITS.get(file, ()),
                              recorded=RECORDED[file])
    assert shown["transcript"], "the scenario recorded nothing"
