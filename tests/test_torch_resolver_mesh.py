"""The reference's routed resolver mesh tests (tests/test_resolver_mesh.py)
run against the port, every one with its own assertions, on both
packages (``torch_parity.hold_to_reference``), one case for each of its
``parametrize`` cases: the boundary-rebalance math, the empty-clip fast
path, routed == broadcast (== merged) verdict parity across seeds and
partition counts, and the heat-driven boundary move through a recovery
of the simulated cluster (the port's resolvers and roles on
``torch.device("cpu")``).

Each resolver reply is recorded beside the scenario's transcript and the
two packages' held equal, tolerance 0.  The heat rebalance recovers, so
the port runs it twice: as it is, with the test's assertions, and
without the resolver retire for the comparison (``hold_to_reference``'s
``recovers``).
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (buggify_off, hold_to_reference,  # noqa: E402,F401
                          one_torch_thread, reference_param_cases)

FILE = "test_resolver_mesh.py"
CASES = {FILE: [
    "test_rebalance_balanced_mesh_is_left_alone",
    "test_rebalance_moves_single_boundary_into_hot_half",
    "test_rebalance_preserves_partition_count",
    "test_rebalance_thin_or_single_key_signal_declines",
    "test_empty_clip_fast_path_skips_backend",
    "test_fast_path_disabled_with_routing_off",
    "test_routed_mesh_verdict_parity_coherent",
    "test_routed_mesh_verdict_parity_straddling",
    "test_routed_mesh_parity_three_way_split",
    "test_heat_rebalance_moves_resolver_boundary"]}
RECOVERS = {"test_heat_rebalance_moves_resolver_boundary"}
RECORDED = {"core.resolver.Resolver": ("resolve",),
            "core.shard_load": ("rebalance_resolver_boundaries",)}


@pytest.mark.parametrize("file,test,args", reference_param_cases(CASES))
def test_reference_resolver_mesh(file, test, args, monkeypatch):
    hold_to_reference(file, test, monkeypatch, args=args,
                      recovers=test in RECOVERS, recorded=RECORDED)
