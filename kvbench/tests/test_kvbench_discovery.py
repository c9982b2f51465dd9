"""A cell, a traffic mix, a configuration and a metric added as new
files and new entries are found by name, with no edit to a file that
is there."""

from __future__ import annotations

import json

import torch

from kvbench import harness, spec

from kvbench_small import small_root  # noqa: F401


def test_new_files_are_found(small_root):
    root = small_root
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "kvbench/configs/mako5050-z099.json").read_text())
    cfg["name"] = "mako-narrow"
    cfg["schema"]["n_keys"] = 500
    (root / "kvbench/configs/mako-narrow.json").write_text(json.dumps(cfg))
    (root / "kvbench/traffic/burst-k2.json").write_text(json.dumps(
        {"stream_batches": 8, "group_batches": 2,
         "inflight_groups": 3, "warm_passes": 1, "trace_groups": 2}))
    (root / "kvbench/metrics/groups_in_window.py").write_text(
        "def read(run):\n    return len(run.groups)\n")
    bench["configs"].append({"name": "mako-narrow", "source": "a test",
                             "file": "kvbench/configs/mako-narrow.json",
                             "reduced": ["n_keys"], "why": "a test"})
    bench["workloads"].append({"name": "mako-narrow.burst",
                               "config": "mako-narrow",
                               "traffic": "burst-k2", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "groups_in_window", "unit": "groups",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["mako-narrow.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = spec.load(root)
    run = harness.run(bench, spec.cell(bench, "mako-narrow.burst"), 1, 0.3,
                      False, torch.device("cpu"), 0.0, root=root)
    assert run.result["correct"] is True
    assert run.stream.n_batches == 8 and run.mix["group_batches"] == 2
    got = run.result["metrics"]["groups_in_window"]
    assert got == {"value": float(len(run.groups)), "unit": "groups"}
    # the metric names only the new cell
    assert "groups_in_window" not in {
        m["name"] for m in spec.metrics(bench, "mako5050-z099.grouped",
                                        "end_to_end")}
