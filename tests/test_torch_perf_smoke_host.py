"""The perf smoke's host stages on the port, held to the reference's:
``apply``, ``pipeline``, ``feed``, ``heat``, ``backup``, ``scan`` and
``recover``; and the two modules' constants and ``--stage`` choices.

Each test runs both packages' ``*_seconds`` at the reference's sizes
(``torch_parity.stage_stats``): the reference's on the CPU, the port's
with ``device=torch.device("cpu")``.  Their resolvers run the exact C++
set as the reference's do.  The stats that do not depend on the clock
are held equal: committed and applied counts, the apply path's index
metrics, the heat tracker's ranking and armed budget, the restore's and
the recovery's keyspace digests (``keyspace_digest``, recorded on both
sides), row and run counts.  No test asserts a wall-clock floor, ratio
or budget.
"""

from __future__ import annotations

import argparse
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          buggify_off, held_equal, one_torch_thread,
                          perf_smoke, port_stage_stats, stage_stats)

DIGESTS = (("backup.container", "keyspace_digest"),)


def test_apply_stage_matches_reference(monkeypatch):
    ref, port = (stage_stats(p, "storage_apply_seconds", monkeypatch)
                 for p in (REF, PORT))
    held_equal(ref, port, ("mutations_applied", "apply_batches",
                           "apply_batch_size_mean", "apply_batch_size_max",
                           "index_keys", "index_merges", "mvcc_segments",
                           "mvcc_resident_bytes", "version", "bytes_input",
                           "logical_bytes"))


def test_pipeline_stage_matches_reference(monkeypatch):
    ref, port = (stage_stats(p, "commit_pipeline_seconds", monkeypatch)
                 for p in (REF, PORT))
    got = held_equal(ref, port, ("committed", "mutations_applied"))
    assert got == {"committed": 400, "mutations_applied": 800}


def test_feed_stage_matches_reference(monkeypatch):
    ref, port = (stage_stats(p, "feed_tail_seconds", monkeypatch)
                 for p in (REF, PORT))
    got = held_equal(ref, port, ("committed", "mutations_seen"))
    assert got == {"committed": 300, "mutations_seen": 600}


def test_heat_stage_matches_reference(monkeypatch):
    """The shards in the tracker's order (the hot one first), the armed
    tag budget and the throttle's activations."""
    ref, port = (stage_stats(p, "heat_path_seconds", monkeypatch)
                 for p in (REF, PORT))
    for s in (ref, port):
        s["ranked_tags"] = [t for t, _ in s["heat_rank"]]
    held_equal(ref, port, ("ranked_tags", "armed_budget_tps",
                           "heat_throttle_activations"))


def test_backup_stage_matches_reference(monkeypatch):
    """The restored and the source keyspace's digests (recorded as the
    stage computes them), rows and snapshot rows."""
    ref, port = (stage_stats(p, "backup_restore_seconds", monkeypatch,
                             record=DIGESTS) for p in (REF, PORT))
    got = held_equal(ref, port, ("rows", "snapshot_rows", "verified",
                                 "recorded"))
    assert len(got["recorded"]) == 2 and got["verified"]


def test_scan_stage_matches_reference(monkeypatch):
    keys = ("rows", "engine_runs", "chunk")
    ref = stage_stats(REF, "scan_path_seconds", monkeypatch)
    port = port_stage_stats(ref, "scan_path_seconds", monkeypatch, keys)
    got = held_equal(ref, port, keys)
    assert min(got["engine_runs"]) >= 3


def test_recover_stage_matches_reference(monkeypatch):
    """The recovered and the acknowledged keyspace's digests after the
    torn-disk kill, and the rows; each side tore files."""
    ref, port = (stage_stats(p, "recover_path_seconds", monkeypatch,
                             record=DIGESTS) for p in (REF, PORT))
    got = held_equal(ref, port, ("rows", "verified", "recorded"))
    assert len(got["recorded"]) == 2
    assert ref["torn_files"] > 0 and port["torn_files"] > 0


def test_constants_match_reference():
    """Every UPPER_CASE constant of the reference's perf smoke, at its
    value, in the port's; the port adds only ``STAGES``."""
    ref, port = perf_smoke(REF), perf_smoke(PORT)
    names = {n for n in vars(ref) if n.isupper()}
    assert len(names) == 98
    assert {n: getattr(ref, n) for n in names} == \
        {n: getattr(port, n) for n in names}
    assert {n for n in vars(port) if n.isupper()} - names == {"STAGES"}


class _Parsed(Exception):
    pass


def _options(main, monkeypatch, argv) -> dict:
    """``main``'s command-line options: {flag: (choices, default)}."""
    def parse(self, args=None, namespace=None):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    monkeypatch.setattr(sys, "argv", ["perf_smoke"])
    with pytest.raises(_Parsed) as e:
        main(*argv)
    parser = e.value.args[0]
    return {a.option_strings[-1]: (a.choices, a.default)
            for a in parser._actions if a.option_strings
            and a.dest != "help"}


def test_stage_choices_match_reference(monkeypatch):
    """``main``'s ``--stage`` choices and every other flag with its
    default as the reference's; the port adds ``--device``."""
    ref = _options(perf_smoke(REF).main, monkeypatch, ())
    port = _options(perf_smoke(PORT).main, monkeypatch, ([],))
    assert port.pop("--device") == (("cuda", "cpu"), "cuda")
    assert list(ref["--stage"][0]) == list(port["--stage"][0])
    assert ref["--stage"][1] == port["--stage"][1] == "all"
    assert ref == port
    assert tuple(perf_smoke(PORT).STAGES) + ("all",) == \
        tuple(ref["--stage"][0])
