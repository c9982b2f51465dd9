"""K3 (``csrc/hist_check.cu``): a batch's reads against the history.

Bytes a launch needs, from the batch's real ranges: its read rows
(begins; ends too for interval ranges), the snapshots, the hit flags
written, and the committed write ranges on the side of the history the
kernel scans.  The kernel takes the window (the newest W slots, W / S
batches' slabs, with the edge slot's version and the floor) when every
snapshot is at or above the edge slot's version or below the floor,
else the whole ring of C slots; a committed range is its begin lanes
(ends too for intervals) and its version.  The side is worked out here
from the stream: a pass starts on a fresh ring (C slots at version -1,
floor 0) and each batch appends S slots at its commit version."""

from __future__ import annotations

import numpy as np

from .. import roofline


def window_side(run, j: int, s: dict) -> bool:
    S, C, W = s["S"], s["C"], s["W"]
    if W <= 0:
        return False
    v = run.stream.versions
    appended = j * S
    edge = int(v[j - 1 - W // S]) if W < appended else -1
    evicted = appended - C
    floor = int(v[(evicted - 1) // S]) if evicted > 0 else 0
    snap = run.stream.snapshots[j]
    live = snap >= 0
    return bool(np.all(~live | (snap < floor) | (snap >= edge)))


def bytes_of(run, j: int) -> int:
    s = roofline.shape(run)
    B, L = s["B"], s["L"]
    sides = 1 if s["points"] else 2
    nr = int(run.stream.nr[j].sum())
    rows = 4 * L * nr * sides + 8 * B + 4 * B
    slot = 4 * L * sides + 8
    held = roofline.committed_writes(run)
    if window_side(run, j, s):
        first = max(0, j - s["W"] // s["S"])
        return rows + int(held[j] - held[first]) * slot + 16
    first = max(0, j - s["C"] // s["S"])
    return rows + int(held[j] - held[first]) * slot


def read(run):
    return roofline.share(run, "hist_check_kernel", bytes_of)
