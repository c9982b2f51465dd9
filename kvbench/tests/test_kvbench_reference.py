"""The plain reference: against a brute-force check over byte strings,
and against the port's plain path on a small stream of each mix."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from kvbench import harness, reference, spec, stream

from kvbench_small import (REPO, cells, shrink, small_root,  # noqa: F401
                           whole_passes)


def brute_force(s: stream.Stream, mvcc_window: int) -> np.ndarray:
    """FoundationDB's ConflictBatch, txn by txn, on the keys as bytes."""
    history = []        # (begin, end, version) of committed writes
    out = np.zeros(s.snapshots.shape, dtype=np.int8)
    for j in range(s.n_batches):
        blob, offs, nr, nw, snaps = s.wire(j)
        ks = [blob[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
        oldest = max(0, int(s.versions[j - 1]) - mvcc_window) if j else 0
        batch_writes = []
        e = 0
        for t in range(s.txns):
            rr = [(ks[e + 2 * i], ks[e + 2 * i + 1]) for i in range(nr[t])]
            e += 2 * nr[t]
            wr = [(ks[e + 2 * i], ks[e + 2 * i + 1]) for i in range(nw[t])]
            e += 2 * nw[t]
            snap = int(snaps[t])
            if rr and snap < oldest:
                out[j, t] = reference.TOO_OLD
                continue
            hit = any(b < we and wb < e_ for b, e_ in rr
                      for wb, we, v in history if v > snap) or any(
                b < we and wb < e_ for b, e_ in rr for wb, we in batch_writes)
            if hit:
                out[j, t] = reference.CONFLICT
                continue
            batch_writes.extend(wr)
        history.extend((b, e_, int(s.versions[j])) for b, e_ in batch_writes)
    return out


@pytest.mark.parametrize("config,lag,window", [
    ("mako5050-z099", 5000, 5_000_000),
    ("tpcc-neworder-w100", 5000, 5_000_000),
    # snapshots far behind and a short MVCC window: TOO_OLD verdicts
    ("mako5050-z099", 9000, 6000),
])
def test_reference_matches_brute_force(config, lag, window):
    cfg = shrink(spec.config(spec.load(REPO), config, REPO))
    cfg["schema"].update(n_keys=200) if config.startswith("mako") \
        else cfg["schema"].update(warehouses=1, items=50)
    cfg["batches"]["snapshot_lag_versions"] = lag
    s = stream.build(cfg, {"stream_batches": 12}, 11)
    want = brute_force(s, window)
    got = reference.resolve_stream(s, window)
    assert np.array_equal(got, want)
    assert (want == reference.CONFLICT).any() and (want == 0).any()
    if window < 10_000:
        assert (want == reference.TOO_OLD).any()


@pytest.mark.usefixtures("whole_passes")
@pytest.mark.parametrize("cell", cells())
def test_reference_agrees_with_the_ports_plain_path(small_root, cell):
    """A small run of each cell on the CPU (the kernels' plain versions):
    every verdict the window returned equals the reference's."""
    bench = spec.load(small_root)
    run = harness.run(bench, spec.cell(bench, cell), 3, 0.5, False,
                      torch.device("cpu"), 0.0, root=small_root)
    assert run.result["correct"] is True
    assert run.checks["batches_compared"] >= 8
    assert all(run.checks[k] == 0 for k in harness.LIMITS)


@pytest.mark.usefixtures("whole_passes")
@pytest.mark.parametrize("slabs,holds", [(12, True), (11, False)])
def test_the_ring_holds_the_mvcc_window(small_root, slabs, holds):
    """The configurations size the ring to mvcc_window_versions /
    versions_per_batch slabs, so the too-old floor its evictions raise
    is FoundationDB's edge: with snapshots lagging past the window, the
    port's plain path says TOO_OLD exactly where the reference does.  A
    ring one slab short says it inside the window, and is not correct."""
    root = small_root
    path = root / "kvbench/configs/mako5050-z099.json"
    cfg = json.loads(path.read_text())
    B = cfg["batches"]["txns"]
    cfg["batches"].update(versions_per_batch=100, start_version=0,
                          snapshot_lag_versions=1800)
    cfg["mvcc_window_versions"] = 1200
    slab = B * cfg["knobs"]["RESOLVER_RANGES_PER_TXN"]
    cfg["knobs"].update(CONFLICT_RING_CAPACITY=slabs * slab,
                        CONFLICT_WINDOW_SLOTS=4 * slab)
    path.write_text(json.dumps(cfg))
    (root / "kvbench/traffic/grouped-k256.json").write_text(json.dumps(
        {"stream_batches": 32, "group_batches": 4, "inflight_groups": 2,
         "warm_passes": 1, "trace_groups": 2}))
    bench = spec.load(root)
    run = harness.run(bench, spec.cell(bench, "mako5050-z099.grouped"), 13,
                      0.5, False, torch.device("cpu"), 0.0, root=root)
    assert (run.ref == reference.TOO_OLD).any()
    assert (run.ref[12:] == reference.COMMITTED).any()
    assert run.result["correct"] is holds
    if not holds:
        assert run.checks["false_conflicts"] + run.checks["wrong_codes"] > 0
