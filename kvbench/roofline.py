"""A kernel's share of its roofline over the traced slice: the least time
the card could take for the bytes the launches need (each input byte
read once, each output byte written once, at the published bandwidth)
over the kernel's device time in the trace's steady window.  The conflict kernels do
int32 compares, for which the data sheet gives no rate, so the bound is
the bytes'.

The shapes of a launch follow the configuration: B txns of R ranges,
L = KEY_ENCODE_BYTES / 4 + 1 lanes a key, a slab of S = B * R history
slots a batch, the ring of C slots and its window of W (the conflict
set's, as it rounded them).  The bytes count the ranges a batch really
holds (its ``nr`` and ``nw``), not the R slots a txn is padded to, and
the history as the write ranges committed into it."""

from __future__ import annotations

import numpy as np

from . import peaks


def shape(run) -> dict:
    k = run.config["knobs"]
    B, R = k["RESOLVER_BATCH_TXNS"], k["RESOLVER_RANGES_PER_TXN"]
    C, W = run.ring["capacity"], run.ring["window"]
    K = run.mix["group_batches"]
    return {"B": B, "R": R, "L": k["KEY_ENCODE_BYTES"] // 4 + 1, "S": B * R,
            "C": C, "W": W, "K": K, "points": run.stream.points,
            # the fused loop's hot buffer, else a chain of single steps
            "fused": 0 < W < C and K * B * R <= C}


def traced_batches(run) -> list[int]:
    """The place in the pass of every batch of the traced slice, in the
    order the card ran them."""
    G = run.mix["group_batches"]
    return [g.pos * G + k for g in run.trace.groups for k in range(G)]


def committed_writes(run) -> np.ndarray:
    """[N + 1]: the write ranges the reference committed in the pass's
    batches before each batch (the history a batch's reads can meet)."""
    out = getattr(run, "_committed_writes", None)
    if out is None:
        nw = np.where(run.ref == 0, run.stream.nw, 0).sum(axis=1)
        out = np.zeros(nw.size + 1, dtype=np.int64)
        np.cumsum(nw, out=out[1:])
        run._committed_writes = out
    return out


def share(run, kernel: str, bytes_of) -> float | None:
    """100 x (sum of least times) / (sum of device times) over the
    launches of ``kernel`` wholly inside the slice's steady window; None
    when the trace has no launch of it, or not one a batch."""
    if run.trace is None or run.ref is None:
        return None
    bw = peaks.hbm_bytes_per_s(run.device_name)
    mine = [(t, inside) for name, t, inside in run.trace.launches
            if name.startswith(kernel)]
    batches = traced_batches(run)
    if bw is None or not mine or len(mine) != len(batches):
        return None
    least = sum(bytes_of(run, j) for j, (_, inside) in zip(batches, mine)
                if inside) / bw
    spent = sum(t for t, inside in mine if inside)
    return 100.0 * least / spent if spent > 0 else None
