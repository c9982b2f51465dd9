"""The result's line: exactly the contract's keys, in its order, and no
line at all without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from kvbench import harness, spec

from kvbench_small import REPO, cells, small_root  # noqa: F401

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", cells())
def test_result_keys(small_root, cell, traced):
    bench = spec.load(small_root)
    c = spec.cell(bench, cell)
    run = harness.run(bench, c, 7, 0.3, traced, torch.device("cpu"), 0.0,
                      root=small_root)
    res = json.loads(json.dumps(run.result))
    assert list(res) == KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert set(res["checks"]) == set(harness.LIMITS)
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    want = spec.metrics(bench, cell, "per_layer" if traced else "end_to_end")
    assert set(res["metrics"]) <= {m["name"] for m in want}
    if not traced:      # every end-to-end metric is read on the CPU too
        assert set(res["metrics"]) == {m["name"] for m in want}
    units = {m["name"]: m["unit"] for m in want}
    for name, m in res["metrics"].items():
        assert m == {"value": m["value"], "unit": units[name]}
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["device"]) == dev | ({"busy_s", "window_s"}
                                        if traced else set())
    if traced:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    """Without a CUDA card the run exits non-zero and prints nothing on
    standard output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "-m", "kvbench", "--workload", cells()[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
