"""The perf smoke's simulated stages on the port, held to the
reference's: ``observe`` (the metrics plane), ``scrub`` (the
consistency scrubber) and ``layers`` (the client layer stack), each a
seeded recruited cluster in virtual time.

Each test runs both packages' ``*_seconds`` from fresh process state
(``torch_parity.stage_stats``), the port's simulated cluster with
``device=torch.device("cpu")``.  Held equal: every stat the simulation
yields (event counts, cadences, the lag rollup, scrub passes and the
key-exact catch, hit rates, checker passes, frontiers) and what
``metrics_tool`` reconstructs from the recorded events (the lag series,
the recovery audit, the scrub and layers reports).  The observe and
scrub stages end with a wall-clock overhead A/B; its ceiling is lifted
for both packages here (the stages' gates beneath it stand), and no
test asserts a wall-clock number.  The tests run one after another in
one process, so each also shows that its stage gives the same stats
after another stage.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          buggify_off, held_equal, one_torch_thread,
                          port_stage_stats, stage_stats)

INF = float("inf")


def both(stage, mp, keys, **kw):
    """The reference's stage and the port's (``port_stage_stats``), with
    their ``keys`` held equal; returns what was held."""
    ref = stage_stats(REF, stage, mp, **kw)
    return held_equal(ref, port_stage_stats(ref, stage, mp, keys, **kw),
                      keys)


def test_observe_stage_matches_reference(monkeypatch):
    got = both("observe_seconds", monkeypatch,
               ("sim_metrics_events", "cadence_mean_s", "cluster_lag",
                "lag_series_tags", "recovery_steps", "recorded"),
               constants={"OBSERVE_OVERHEAD_CEIL": INF},
               record=(("tools.metrics_tool", "lag_series"),
                       ("tools.metrics_tool", "recovery_report")))
    assert [f for f, _ in got["recorded"]] == ["lag_series",
                                               "recovery_report"]


def test_scrub_stage_matches_reference(monkeypatch):
    got = both("scrub_seconds", monkeypatch,
               ("clean_pass_pages", "clean_pass_version", "passes_to_detect",
                "mismatch_events", "status_scrub", "recorded"),
               constants={"SCRUB_OVERHEAD_CEIL": INF},
               record=(("tools.metrics_tool", "scrub_report"),))
    assert got["mismatch_events"] == 1


LAYERS_KEYS = ("reads", "writes", "hit_rate", "clean_rows_checked",
               "passes", "status_frontier", "status_lag",
               "progress_samples", "recorded")


def test_layers_stage_matches_reference(monkeypatch):
    """The layer checker's scans read rows that the simulation cleared
    before the clears were durable: the reference serves them (ROADMAP
    C), the port does not, so its checker reads fewer rows.  The port
    as it is passes the stage's gates.  Its client refresh returning on
    a majority of coordinators moves the simulator's schedule (ROADMAP
    C3), so the comparisons run it gathered (``torch_parity.gathered``):
    every other stat and ``metrics_tool``'s report are equal (less the
    progress series, whose checker samples count those rows); without
    the stale-read repair too (``torch_parity.unmasked``) every stat
    is."""
    rec = (("tools.metrics_tool", "layers_report"),)
    ref = stage_stats(REF, "layers_seconds", monkeypatch, record=rec)
    stage_stats(PORT, "layers_seconds", monkeypatch, record=rec)
    port = stage_stats(PORT, "layers_seconds", monkeypatch, record=rec,
                       majority=False)
    for st in (ref, port):
        # the report less its progress series, whose checker samples
        # count the rows read
        st["report"] = {k: v for k, v in st["recorded"][0][1].items()
                        if k != "series"}
    held_equal(ref, port, [k for k in LAYERS_KEYS if k not in
                           ("clean_rows_checked", "recorded")] + ["report"])
    assert 0 < port["clean_rows_checked"] < ref["clean_rows_checked"]
    unmasked = stage_stats(PORT, "layers_seconds", monkeypatch, mask=False,
                           majority=False, record=rec)
    got = held_equal(ref, unmasked, LAYERS_KEYS)
    assert got["hit_rate"] >= 0.8
