"""K1 (``csrc/commit_chain.cu``): a batch's whole verdict step.

Bytes a launch needs, from the batch's real ranges: the read begins
(ends too for interval ranges) and the write begins and ends read, with
the history hits, snapshots and floor; the verdicts and committed flags
written, and the slab of the committed write ranges (begin and end
lanes, and in the fused loop their versions)."""

from __future__ import annotations

from .. import roofline


def bytes_of(run, j: int) -> int:
    s = roofline.shape(run)
    B, L = s["B"], s["L"]
    row = 4 * L
    nr = int(run.stream.nr[j].sum())
    nw = int(run.stream.nw[j].sum())
    kept = int(run.stream.nw[j][run.ref[j] == 0].sum())
    reads = row * nr * (1 if s["points"] else 2) + 2 * row * nw
    flags = 4 * B + 8 * B + 8
    out = 2 * B + kept * (2 * row + (8 if s["fused"] else 0))
    return reads + flags + out


def read(run):
    return roofline.share(run, "commit_chain_kernel", bytes_of)
