"""Key-range-partitioned conflict detection: the multi-resolver step.

The reference scales conflict detection with multiple Resolver roles, each
owning a key-range partition; every CommitProxy broadcasts its batch to all
resolvers and ANDs the verdicts (REF:fdbserver/Resolver.actor.cpp,
REF:fdbserver/CommitProxyServer.actor.cpp).  The JAX package lays the
partitions on the devices of a mesh axis; on one card they become the
leading dimension of the state:

- partition s holds its own history ring (``hb[s]``, ``he[s]``,
  ``hver[s]``, ``floor[s]``), each laid out as the single-resolver ring
  of ops/conflict_torch.py;
- the batch is shared by every partition;
- each partition masks *write* ranges to its key range (reads need no
  mask: a ring only ever holds writes inside its own partition, so
  foreign reads simply match nothing) and runs the same ``resolve_core``
  as the single resolver: kernel K3, kernel K1, and kernel K2 appending
  the batch's slab into that partition's slice of the new state;
- the per-partition verdicts combine by a max over the partition
  dimension — TOO_OLD(2) > CONFLICT(1) > COMMITTED(0) gives the
  reference's verdict precedence for free.

The write mask and the combine are torch ops: one ``torch.where`` over
the broadcast ``[S, B, R, L]`` writes and one ``amax``, the elementwise
work the reference leaves to XLA.

Fidelity note: like the reference's multi-resolver mode, each partition
decides commits from its *local* view, so a transaction aborted by one
partition may still have its writes recorded by another ("phantom"
conflict ranges).  That is conservative (false conflicts only) and is
exactly the documented behavior of FDB multi-resolver clusters.

Lanes are int32 holding the reference's u32 lanes XOR 0x80000000
(``conflict_torch.map_lanes``); ``sharded_state_from_numpy`` /
``sharded_state_to_numpy`` carry the reference's state in and out.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import keycode
from ..ops.conflict_torch import (ConflictState, default_device, map_lanes,
                                  resolve_core, unmap_lanes)
from ..ops.kernels import SENTINEL_MAPPED, _possibly_lt
from ..ops.keycode import DEFAULT_WIDTH


class ShardedConflictState(NamedTuple):
    """ConflictState tensors with a leading partition dimension, plus the
    partition boundary table.  Per-partition layout matches the single
    resolver's canonical oldest-first ring (ops/conflict_torch.py)."""
    hb: torch.Tensor       # [S, L, C] int32 mapped
    he: torch.Tensor       # [S, L, C] int32 mapped
    hver: torch.Tensor     # [S, C] int64
    floor: torch.Tensor    # [S] int64
    part_lo: torch.Tensor  # [S, L] int32 mapped, partition begin keys
    part_hi: torch.Tensor  # [S, L] int32 mapped, partition end keys


def make_partition_boundaries(n_shards: int, width: int = DEFAULT_WIDTH,
                              split_keys: list[bytes] | None = None
                              ) -> np.ndarray:
    """[S+1, L] u32 boundary table: partition i owns [b[i], b[i+1]).

    Default split: even slices of the first-byte space — data distribution
    will supply real split keys once shard statistics exist (the analog of
    ResolverMoveKeys in the reference).
    """
    L = keycode.nlanes(width)
    out = np.zeros((n_shards + 1, L), dtype=np.uint32)
    if split_keys is not None:
        if len(split_keys) != n_shards - 1:
            raise ValueError(f"{n_shards} partitions need {n_shards - 1} "
                             f"split keys, got {len(split_keys)}")
        for i, k in enumerate(split_keys):
            out[i + 1] = keycode.encode_key(k, width)
    else:
        for i in range(1, n_shards):
            first = (i * 256) // n_shards
            out[i] = keycode.encode_key(bytes([first]), width)
    out[0] = 0                      # "" — below every key
    out[n_shards] = 0xFFFFFFFF      # sentinel — above every key
    return out


def _bounds(bounds: np.ndarray, dev: torch.device):
    t = torch.from_numpy(map_lanes(bounds).copy()).to(dev)
    return t[:-1].contiguous(), t[1:].contiguous()


def init_sharded_state(n_partitions: int, capacity_per_shard: int,
                       width: int = DEFAULT_WIDTH, oldest_version: int = 0,
                       split_keys: list[bytes] | None = None,
                       device=None) -> ShardedConflictState:
    """S empty rings of ``capacity_per_shard`` slots on ``device`` (the
    CUDA card by default)."""
    dev = default_device(device)
    S, C = n_partitions, capacity_per_shard
    L = keycode.nlanes(width)
    lo, hi = _bounds(make_partition_boundaries(S, width, split_keys), dev)
    return ShardedConflictState(
        hb=torch.full((S, L, C), SENTINEL_MAPPED, dtype=torch.int32,
                      device=dev),
        he=torch.full((S, L, C), SENTINEL_MAPPED, dtype=torch.int32,
                      device=dev),
        hver=torch.full((S, C), -1, dtype=torch.int64, device=dev),
        floor=torch.full((S,), oldest_version, dtype=torch.int64,
                         device=dev),
        part_lo=lo, part_hi=hi)


def sharded_state_from_numpy(hb, he, hver, floor, part_lo, part_hi,
                             device) -> ShardedConflictState:
    """The reference's ShardedConflictState gathered to numpy ([S, L, C]
    u32 planes, [S, C] versions, [S] floors, [S, L] u32 bounds) -> the
    port's mapped state on ``device``."""
    dev = torch.device(device)

    def lanes(a):
        return torch.from_numpy(map_lanes(a).copy()).to(dev)

    def i64(a):
        return torch.from_numpy(np.asarray(a, np.int64).copy()).to(dev)

    return ShardedConflictState(lanes(hb), lanes(he), i64(hver), i64(floor),
                                lanes(part_lo), lanes(part_hi))


def sharded_state_to_numpy(state: ShardedConflictState):
    """-> (hb, he, hver, floor, part_lo, part_hi) in the reference's
    layout and dtypes (u32 lanes, int64 versions and floors)."""
    return (unmap_lanes(state.hb.cpu().numpy()),
            unmap_lanes(state.he.cpu().numpy()),
            state.hver.cpu().numpy().copy(), state.floor.cpu().numpy().copy(),
            unmap_lanes(state.part_lo.cpu().numpy()),
            unmap_lanes(state.part_hi.cpu().numpy()))


def _mask_writes_to_partitions(wb, we, lo, hi, width: int):
    """[S, B, R, L] writes: partition s keeps the write ranges that
    overlap its [lo[s], hi[s]) and sees sentinels elsewhere."""
    overlap = (_possibly_lt(wb[None], hi[:, None, None, :], width)
               & _possibly_lt(lo[:, None, None, :], we[None], width))
    keep = overlap[..., None]
    return (torch.where(keep, wb[None], SENTINEL_MAPPED),
            torch.where(keep, we[None], SENTINEL_MAPPED))


def make_sharded_resolve_step(n_partitions: int, width: int = DEFAULT_WIDTH,
                              window: int = 0, device=None):
    """The multi-resolver step for ``n_partitions`` partitions on
    ``device`` (the CUDA card by default).

    step(state, rb, re, wb, we, snap, commit_version) -> (state',
    verdicts [B] int8), with rb/re/wb/we [B, R, L] (the reference's u32
    encoded rows, numpy), snap [B] int64 and an int commit version.  ``window`` enables each partition's exact fast path
    (CONFLICT_WINDOW_SLOTS), same semantics as the single resolver.
    Every partition is four kernel launches (K3, K1, and K2 for each of
    its two planes), so a step is 4S.
    """
    dev = default_device(device)
    S = n_partitions

    def step(state: ShardedConflictState, rb, re, wb, we, snap,
             commit_version):
        if state.hb.shape[0] != S:
            raise ValueError(f"state has {state.hb.shape[0]} partitions, "
                             f"the step {S}")
        rb, re, wb, we = (torch.from_numpy(map_lanes(x).copy()).to(dev)
                          for x in (rb, re, wb, we))
        snap = torch.from_numpy(np.asarray(snap, np.int64).copy()).to(dev)
        cv = int(commit_version)
        wbm, wem = _mask_writes_to_partitions(wb, we, state.part_lo,
                                              state.part_hi, width)
        # kernel K2 appends each partition's slab straight into its slice
        # of the new [S, L, C] planes: one copy of every ring a step.  A
        # padding batch (commit_version < 0) leaves every ring as it is
        hb2, he2 = (state.hb, state.he) if cv < 0 else (
            torch.empty_like(state.hb), torch.empty_like(state.he))
        hvers, floors, verdicts = [], [], []
        for s in range(S):
            st = ConflictState(state.hb[s], state.he[s], state.hver[s],
                               state.floor[s])
            st2, v = resolve_core(st, rb, re, wbm[s], wem[s], snap, cv,
                                  width=width, window=window,
                                  ring_inplace=True, spares=[hb2[s], he2[s]])
            hvers.append(st2.hver)
            floors.append(st2.floor)
            verdicts.append(v)
        new = ShardedConflictState(hb2, he2, torch.stack(hvers),
                                   torch.stack(floors), state.part_lo,
                                   state.part_hi)
        return new, torch.stack(verdicts).amax(dim=0)

    return step
