"""Device gather path for point-read serving.

``get_values``' missing-key pass — the sorted keys the MVCC window does
not resolve — is exactly a batched sorted-probe over the storage
engine's key space, and ``PackedKeyIndex`` already keeps that key space
as two sorted runs with keycode-u64 prefixes (storage/key_index.py).
This module mirrors the BASE run's prefixes as a device tensor and
answers a whole batch with ONE launch of the hand kernel
``prefix_search`` (csrc/prefix_search.cu: the left and right
``searchsorted`` bounds of every probe), the same pack-keys-into-lanes
discipline the resolver kernels use.  The host then only refines inside
the (usually single-element) equal-prefix band and gathers values for
the keys that exist — no per-key descent over the big run.

Prefixes are the reference's u64 values with the sign bit flipped and
held as int64 (``map_prefixes``): that keeps their order under a signed
compare, as the conflict lanes' XOR does, and torch has no u64
``searchsorted``.

The mirror lives on the server's device: the CUDA card unless the
caller passes ``torch.device("cpu")``, where the kernel's plain version
(two ``torch.searchsorted`` calls) answers.  On the card a build or
launch failure raises; a lookup never falls back to the host.

Freshness contract: the mirror is stamped with the index ``gen`` counter
(bumped whenever the base run mutates: merges, discards).  A batch
arriving with a stale mirror is served by the ENGINE path — identical
results, tested — and triggers a re-upload so the next batch is fresh;
the pending overlay (keys inserted since the last merge) is always
probed host-side, so the mirror only ever needs to track merges, not
every insert.  The re-upload happens inline on that first stale batch:
its host half is the index's own cached ``_prefixes()`` array — the
same once-per-merge encode the numpy bound path already pays.  Batches
below ``STORAGE_DEVICE_READ_MIN_BATCH`` skip the device entirely (a lone
probe's dispatch overhead beats any gather win — the same threshold
reasoning as PackedKeyIndex.ranges_keys).

Results are BYTE-IDENTICAL to ``engine.get_batch`` by construction: the
device only locates candidate bands; membership is decided by the same
bisect refinement the host index uses, and values come from the same
engine storage.

Two engine shapes share the mirror.  ``membership`` mode
(MemoryKVStore): the mirrored run is the engine's full key index — the
device locates the key's band, the host decides membership and gathers
the value.  ``blocks`` mode (LSMKVStore): the mirrored run is the
engine's MERGED SPARSE INDEX (every sorted run's block first-keys in one
sorted KeyRun, ``lsm.LsmSparseIndex``) — the one device search locates
the candidate data block in EVERY run at once (the prefix-max table
turns the merged position into per-run block indices), and the host
finishes with ``engine.get_batch_located`` (memtable first, block
decode + bisect, newest-run-wins).
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from ..ops import kernels
from ..ops.conflict_torch import default_device
from ..ops.keycode import encode_prefix_u64
from ..runtime.knobs import Knobs

_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
_SIGN64 = np.uint64(1 << 63)


def map_prefixes(pfx: np.ndarray) -> np.ndarray:
    """u64 prefixes -> the order-preserving int64 the device compares."""
    return (np.asarray(pfx, dtype=np.uint64) ^ _SIGN64).view(np.int64)


def _upload(pfx: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(map_prefixes(pfx)).to(device)


class DeviceKeyDirectory:
    """Device mirror of one PackedKeyIndex base run's prefixes."""

    def __init__(self, index, device: torch.device) -> None:
        self._index = index
        self._device = device
        self._pfx_dev: torch.Tensor | None = None
        self._gen = -1          # index.gen the mirror was built at
        self.uploads = 0
        self.uploaded_keys = 0

    @property
    def fresh(self) -> bool:
        return self._pfx_dev is not None and self._gen == self._index.gen

    def refresh(self) -> None:
        """Re-upload the base run's prefixes (called on merge/discard
        staleness, not per batch).  Runs inline: the prefix array is the
        index's shared once-per-merge cache."""
        pfx = self._index.base_prefixes()
        self._gen = self._index.gen
        self._pfx_dev = _upload(pfx, self._device)
        self.uploads += 1
        self.uploaded_keys += int(pfx.shape[0])

    def lookup(self, keys: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
        """One kernel launch for the whole batch: (lo, hi) candidate
        bands over the base run per key.  Caller must hold ``fresh``.
        Probes go up as they are, unpadded: the kernel takes any n."""
        probes = _upload(encode_prefix_u64(keys), self._device)
        out = torch.empty((2, len(keys)), dtype=torch.int64,
                          device=self._device)
        kernels.prefix_search(self._pfx_dev, probes, out[0], out[1])
        lo, hi = out.cpu().numpy()
        return lo, hi


class ShardedDeviceDirectory:
    """Sharded mirror: the base run's prefixes split by key range into
    ``n_shards`` prefix tensors, all on the server's one device (the
    reference spreads them over its chips; here every shard shares the
    card).

    Duck-types ``DeviceKeyDirectory`` (fresh/refresh/lookup + upload
    counters) so ``DeviceReadServer`` treats either as the mirror.  Two
    things the monolithic mirror cannot do:

    - **Partial refresh.**  Shard boundaries are PREFIX values, so after
      a base mutation the per-shard slices are recomputed by one
      searchsorted over the new prefix array, and only the shards whose
      key range intersects the index's ``changed_since`` spans
      re-upload — a localized merge re-ships 1/S of the mirror instead
      of all of it.  An unaccounted gen gap (change log trimmed) falls
      back to a full re-split.
    - **Cross-shard batched gathers.**  A batch's probes route host-side
      by the boundary table (one searchsorted), go up to the device in
      one copy grouped by shard, every touched shard's kernel launch
      writes its slice of one [2, n] output, and one copy brings the
      bands back; the host adds each shard's base offset.

    Boundary invariant: every shard starts at the FIRST element of an
    equal-prefix run (searchsorted-left of the boundary prefix), so a
    probe routed to shard s resolves the same global band the monolithic
    searchsorted would — elements before the shard are strictly below
    its bound, elements after are at or above the next bound.
    """

    def __init__(self, index, n_shards: int, device: torch.device) -> None:
        self._index = index
        self.n_shards = max(2, int(n_shards))
        self._device = device
        self._gen = -1
        self._bounds: np.ndarray | None = None   # [S] lower prefix bound
        self._offsets: np.ndarray | None = None  # [S+1] base-run offsets
        self._shard_dev: list = [None] * self.n_shards
        self.uploads = 0            # refresh() calls (twin-compatible)
        self.uploaded_keys = 0      # prefixes actually re-shipped
        self.shard_refreshes = 0    # per-shard uploads (S per full split)
        self.full_splits = 0        # refreshes that re-split everything
        self.gathers = 0            # per-shard kernel launches

    @property
    def fresh(self) -> bool:
        return self._bounds is not None and self._gen == self._index.gen

    def _put(self, seg: np.ndarray, s: int) -> None:
        self._shard_dev[s] = _upload(seg, self._device)
        self.shard_refreshes += 1
        self.uploaded_keys += int(seg.shape[0])

    def _split_all(self, pfx: np.ndarray) -> None:
        """Full re-split: equal-share cuts snapped left to equal-prefix
        run starts, every shard re-uploaded."""
        n = int(pfx.shape[0])
        S = self.n_shards
        cuts = [min(n, round(n * s / S)) for s in range(S)]
        offs = [0] * (S + 1)
        offs[S] = n
        bounds = np.zeros(S, dtype=np.uint64)
        for s in range(1, S):
            c = cuts[s]
            b = pfx[c] if c < n else _U64_MAX
            offs[s] = int(np.searchsorted(pfx, b, side="left"))
            bounds[s] = b
        self._offsets = np.asarray(offs, dtype=np.int64)
        self._bounds = bounds
        for s in range(S):
            self._put(pfx[offs[s]:offs[s + 1]], s)
        self.full_splits += 1

    def refresh(self) -> None:
        """Rebuild freshness after a base mutation.  Partial when the
        index's change log accounts for every gen bump since the last
        upload: offsets recompute against the fixed prefix boundaries
        and only intersecting shards re-ship.  An index that keeps no
        change log (the lsm engine's merged sparse directory) re-splits
        in full."""
        pfx = self._index.base_prefixes()
        changed = getattr(self._index, "changed_since", None)
        spans = changed(self._gen) \
            if changed is not None and self._bounds is not None else None
        self.uploads += 1
        self._gen = self._index.gen
        if spans is None:
            self._split_all(pfx)
            return
        n = int(pfx.shape[0])
        S = self.n_shards
        offs = np.empty(S + 1, dtype=np.int64)
        offs[:S] = np.searchsorted(pfx, self._bounds, side="left")
        offs[0] = 0
        offs[S] = n
        self._offsets = offs
        if not spans:
            return
        span_p = encode_prefix_u64([k for lo_hi in spans for k in lo_hi])
        for s in range(S):
            lo_b = self._bounds[s]
            hi_b = self._bounds[s + 1] if s + 1 < S else _U64_MAX
            touched = any(
                not (span_p[2 * i + 1] < lo_b
                     or (s + 1 < S and span_p[2 * i] >= hi_b))
                for i in range(len(spans)))
            if touched:
                self._put(pfx[int(offs[s]):int(offs[s + 1])], s)

    def lookup(self, keys: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
        """Global (lo, hi) candidate bands for the whole batch: probes
        route to shards host-side, one launch per touched shard into its
        slice of one [2, n] output, and the host joins with shard
        offsets."""
        probes = encode_prefix_u64(keys)
        n = len(probes)
        sid = np.clip(
            np.searchsorted(self._bounds, probes, side="right") - 1,
            0, self.n_shards - 1)
        order = np.argsort(sid, kind="stable")
        counts = np.bincount(sid, minlength=self.n_shards)
        starts = np.concatenate([[0], np.cumsum(counts)])
        q = _upload(probes[order], self._device)
        out = torch.empty((2, n), dtype=torch.int64, device=self._device)
        for s in np.flatnonzero(counts):
            a, b = int(starts[s]), int(starts[s + 1])
            kernels.prefix_search(self._shard_dev[int(s)], q[a:b],
                                  out[0, a:b], out[1, a:b])
            self.gathers += 1
        bands = out.cpu().numpy() + self._offsets[sid[order]]
        los = np.empty(n, dtype=np.int64)
        his = np.empty(n, dtype=np.int64)
        los[order], his[order] = bands
        return los, his


class DeviceReadServer:
    """Per-storage-server device read path over the engine's key index.

    ``get_batch(keys)`` returns the same list ``engine.get_batch`` would,
    or None to tell the caller to take the engine path (below threshold,
    stale mirror, engine without a packed index).

    ``device`` is where the mirror lives: the CUDA card by default (the
    constructor raises without one), ``torch.device("cpu")`` for the
    kernel's plain version.  It is resolved only when the mirror is
    armed (an engine with a packed index and the knob on).

    ``version_fn`` (the hosting server's applied-version tip) turns the
    boolean stale/fresh flip into a staleness GAUGE: metrics report how
    many versions the mirror's last refresh trails the engine tip, so a
    mirror quietly serving off an old upload shows up as a rising
    number, not a flag nobody polls."""

    def __init__(self, engine, knobs: Knobs, device=None,
                 version_fn=None) -> None:
        self.engine = engine
        self.knobs = knobs
        self.min_batch = max(1, knobs.STORAGE_DEVICE_READ_MIN_BATCH)
        index = getattr(engine, "packed_index", None)
        # how the host finishes a device-located batch: "membership"
        # (full key index + engine.get) or "blocks" (merged sparse
        # directory + engine.get_batch_located) — see module docstring
        self._mode = getattr(index, "device_mode", "membership")
        self._dir = None
        self._sharded = False
        if index is not None and knobs.STORAGE_DEVICE_READ_SERVE:
            dev = default_device(device)
            shards = int(getattr(knobs, "STORAGE_DEVICE_READ_SHARDS", 0))
            if shards >= 2:
                self._dir = ShardedDeviceDirectory(index, shards, dev)
                self._sharded = True
            else:
                self._dir = DeviceKeyDirectory(index, dev)
        # --- observability (storage metrics → status rollup) ---
        self.version_fn = version_fn
        self.last_refresh_version = 0
        self.served_batches = 0
        self.served_keys = 0
        self.fallbacks = 0      # batches routed to the engine path

    @property
    def active(self) -> bool:
        return self._dir is not None

    def _refresh(self) -> None:
        self._dir.refresh()
        if self.version_fn is not None:
            self.last_refresh_version = self.version_fn()

    def get_batch(self, keys: list[bytes]):
        if self._dir is None or len(keys) < self.min_batch:
            if self._dir is not None:
                self.fallbacks += 1
            return None
        index = self._dir._index
        if not self._dir.fresh:
            if self._sharded:
                # sharded mirror: a stale shard refreshes PARTIALLY
                # (only the shards the mutation's key span touched
                # re-ship) and THIS batch still serves off the device
                self._refresh()
            else:
                # stale mirror: serve THIS batch off the engine, refresh
                # so the next one rides the device (refresh on merge,
                # not per batch — steady-state reads never pay an upload)
                self.fallbacks += 1
                self._refresh()
                return None
        base = index.base_run()
        if not len(base):
            # nothing mirrored yet (empty index / no sorted runs):
            # the engine path answers without a device dispatch
            self.fallbacks += 1
            return None
        los, his = self._dir.lookup(keys)
        if self._mode == "blocks":
            # merged sparse directory: the band refines to the exact
            # bisect_right position, whose prefix-max row names the
            # candidate block in every run; the engine finishes host-side
            pos = [base.bisect_right(k, int(lo), int(hi))
                   for k, lo, hi in zip(keys, los, his)]
            out = self.engine.get_batch_located(keys, pos)
        else:
            pending = index.pending_run()
            get = self.engine.get
            out = []
            for k, lo, hi in zip(keys, los, his):
                lo, hi = int(lo), int(hi)
                present = False
                if lo < hi:
                    i = bisect.bisect_left(base, k, lo, hi)
                    present = i < hi and base[i] == k
                if not present and pending:
                    j = bisect.bisect_left(pending, k)
                    present = j < len(pending) and pending[j] == k
                out.append(get(k) if present else None)
        self.served_batches += 1
        self.served_keys += len(keys)
        return out

    def staleness_versions(self) -> int:
        """Versions the mirror's last refresh trails the engine tip —
        0 while fresh (a fresh mirror plus host-probed pending overlay
        serves current data regardless of when it last uploaded)."""
        if self._dir is None or self.version_fn is None \
                or self._dir.fresh:
            return 0
        return max(0, int(self.version_fn()) - self.last_refresh_version)

    def metrics(self) -> dict:
        d = self._dir
        out = {
            "device_read_active": int(self.active),
            "device_read_batches": self.served_batches,
            "device_read_keys": self.served_keys,
            "device_read_fallbacks": self.fallbacks,
            "device_read_uploads": d.uploads if d is not None else 0,
            "device_read_uploaded_keys":
                d.uploaded_keys if d is not None else 0,
            "device_read_staleness_versions": self.staleness_versions(),
        }
        if self._sharded:
            out["device_read_shards"] = d.n_shards
            out["device_read_shard_refreshes"] = d.shard_refreshes
            out["device_read_full_splits"] = d.full_splits
            out["device_read_gathers"] = d.gathers
        return out
