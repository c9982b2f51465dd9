"""The general generator: a configuration and a traffic mix, with a seed,
make the stream of commit batches a run replays.

The configuration names its transaction generator (``schema.kind``,
``kvbench/schemas/<kind>.py``) and the batch structure: ``txns`` a
batch, ``versions_per_batch`` between commit versions, read snapshots
lagging 0 to ``snapshot_lag_versions`` behind the previous batch's
version.  The mix sets how many batches the stream holds
(``stream_batches``); the run replays it, each pass over a fresh
conflict history.  The same seed gives the same stream.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from . import keys, spec


@dataclasses.dataclass
class Stream:
    """N batches of B txns, as the proxy serializes them.

    ``mat``/``lens`` hold every range endpoint in wire order (per txn:
    its read ranges' begin, end, then its write ranges'), ``blob`` and
    ``offs`` the same bytes back to back."""
    versions: np.ndarray        # [N] int64 commit versions
    snapshots: np.ndarray       # [N, B] int64
    nr: np.ndarray              # [N, B] int32 read ranges a txn
    nw: np.ndarray              # [N, B] int32 write ranges a txn
    mat: np.ndarray             # [E, width] uint8 endpoints, zero-padded
    lens: np.ndarray            # [E] int64
    blob: np.ndarray            # uint8, every endpoint's bytes
    offs: np.ndarray            # [E + 1] int64 byte offsets into blob
    batch_ep: np.ndarray        # [N + 1] first endpoint of each batch
    points: bool                # every range is [k, k + 00)

    @property
    def n_batches(self) -> int:
        return self.versions.size

    @property
    def txns(self) -> int:
        return self.snapshots.shape[1]

    def wire(self, j: int) -> tuple:
        """Batch j as (blob bytes, offsets [nkeys+1], nr, nw, snapshots):
        the fields of the port's ``WireBatch`` before its count."""
        e0, e1 = self.batch_ep[j], self.batch_ep[j + 1]
        b0, b1 = self.offs[e0], self.offs[e1]
        return (self.blob[b0:b1].tobytes(), self.offs[e0:e1 + 1] - b0,
                self.nr[j].copy(), self.nw[j].copy(),
                self.snapshots[j].copy())


def seed64(seed: int) -> int:
    """Any whole number as a non-negative seed for numpy's PCG64."""
    return seed % (1 << 64)


def build(config: dict, mix: dict, seed: int, root: Path = spec.ROOT) -> Stream:
    shape = config["batches"]
    B = shape["txns"]
    N = mix["stream_batches"]
    seed = seed64(seed)
    gen = spec.module("schemas", config["schema"]["kind"], root)
    txns = gen.generate(config["schema"], N * B, seed)
    vpb = shape["versions_per_batch"]
    versions = shape["start_version"] + vpb * np.arange(1, N + 1,
                                                        dtype=np.int64)
    lags = np.random.Generator(np.random.PCG64(seed ^ 0xBEEF)).integers(
        0, shape["snapshot_lag_versions"], size=N * B).reshape(N, B)
    snapshots = np.maximum(0, versions[:, None] - vpb - lags)
    nr = txns["nr"].reshape(N, B)
    nw = txns["nw"].reshape(N, B)
    per_batch = 2 * (nr.astype(np.int64) + nw).sum(axis=1)
    batch_ep = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(per_batch, out=batch_ep[1:])
    mat, lens = txns["keys"]
    blob, offs = keys.flatten(mat, lens)
    return Stream(versions, snapshots, nr, nw, mat, lens, blob, offs,
                  batch_ep, bool(txns["points"]))
