"""The perf smoke's storage-structure stages on the port, held to the
reference's: ``bigkeys`` (the columnar key index and a storage server
over it), ``mvcc`` (the columnar MVCC window) and ``compact`` (leveled
against monolithic lsm compaction).

Each test runs both packages' ``*_seconds`` from the same seeds
(``torch_parity.stage_stats``), the port's with
``device=torch.device("cpu")``; each stage asserts its own byte-identity
gates (columnar against list or legacy twin, leveled against
monolithic) in situ.  The stats that do not depend on the clock or on
the process's memory are held equal.  No test asserts a wall-clock or
RSS floor, ratio or budget.

Cut for the suite's time, the same in both packages' runs, through
the stages' own parameters:
- ``bigkeys`` at 200000 keys (the reference's 2000000, ``BIG_KEYS``);
- ``mvcc`` at 200000 keys (``MVCC_KEYS`` 2000000);
- ``compact`` at 800 commits (``COMPACT_COMMITS`` 3200).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import (PORT, REF, api_version_reset,  # noqa: E402,F401
                          buggify_off, held_equal, one_torch_thread,
                          stage_stats)


def test_bigkeys_stage_matches_reference(monkeypatch):
    ref, port = (stage_stats(p, "bigkeys_seconds", monkeypatch,
                             n_keys=200_000) for p in (REF, PORT))
    held_equal(ref, port, ("keys", "index_base_bytes"))


def test_mvcc_stage_matches_reference(monkeypatch):
    """The window's segments, seals, folds and resident bytes a key."""
    ref, port = (stage_stats(p, "mvcc_seconds", monkeypatch,
                             n_keys=200_000) for p in (REF, PORT))
    got = held_equal(ref, port, ("keys", "segments", "seals", "folds",
                                 "resident_bytes_per_key"))
    assert got["seals"] > 0


def test_compact_stage_matches_reference(monkeypatch):
    """Both disciplines' write amplification, the leveled compactor's
    compactions and level shape."""
    ref, port = (stage_stats(p, "compact_seconds", monkeypatch,
                             n_commits=800) for p in (REF, PORT))
    got = held_equal(ref, port, ("commits", "keys_per_commit",
                                 "leveled_write_amp", "monolithic_write_amp",
                                 "write_amp_ratio", "leveled_compactions",
                                 "leveled_levels"))
    assert got["leveled_compactions"] > 0
