"""The resolver's conflict-detection core on PyTorch and the H100.

Port of foundationdb_tpu/ops/conflict_jax.py.  Same semantics slab for
slab, so the verdicts AND the ring state are bit-identical to the JAX
reference and to the numpy twin (ops/conflict_np.py):

- **Canonical oldest-first ring.**  History is ``hb/he: [L, C]`` lane
  planes plus ``hver: [C]`` slot versions; appending a batch's slab of S
  records shifts the ring left by S and writes the slab at the tail.
  Evicted slots raise the too-old ``floor`` to their max version.
- **Lanes are int32.**  PyTorch has no unsigned compare or shift for
  uint32, so a lane holds the reference's u32 value XOR 0x80000000
  (``map_lanes``): that keeps the order, so signed ``<`` here is the
  reference's unsigned ``<``.  The sentinel 0xFFFFFFFF maps to
  0x7FFFFFFF and the truncation marker ``width+1`` maps the same way.
  Versions and the floor stay int64.
- **Hot/cold fused groups.**  ``resolve_many_core`` runs K batches per
  dispatch against a small hot staging buffer seeded with the ring's
  newest ``window`` slots and appends the real slabs to the cold ring
  once at the end.  The reference's ``lax.scan`` is a Python loop over
  the K batches on one CUDA stream: every offset, pad flag and real
  batch count comes from host data (the commit versions), so the loop
  slices at host-known offsets and never syncs the card.
- **Two launches a batch.**  Kernel K3 (``hist_check``) checks a
  batch's reads against the history and makes the reference's
  ``lax.cond(fast_ok, window, full)`` choice inside the launch, from the
  snapshots, the batch's floor and the window's edge version on the
  device.  Kernel K1 (``commit_chain``) then builds the intra-batch
  matrix, runs the in-order chain, writes the verdicts and the batch's
  slab into the hot buffer.  Nothing else runs on the card per batch.
- **Hand kernels** (ops/kernels.py): those two, and the ring append
  behind RESOLVER_RING_INPLACE (into a spare plane of a ping-pong
  pair).  The group's set-up and final append and the verdict bit-pack
  are torch ops, once per group.
- **The endpoint dictionary** (CONFLICT_DICT_SLOTS): the card keeps
  every recently seen range endpoint's lane row in ``dct [D, L]``
  (int32, already mapped; slot 0 is the padding sentinel), and the host
  ships 4-byte slot ids plus rows for endpoints not yet resident.  A
  group's updates are scattered (``index_copy_``) and its ids gathered
  (``index_select``) into contiguous ``[K, B, R, L]`` rows before
  ``resolve_many_core``: a handful of torch ops per group, after which
  every batch is still the same two launches.  The reference keeps the
  dictionary as ``[L, D]`` u32; ``dict_to_numpy`` converts.

Every handle a submit returns supports ``np.asarray``: the device→host
copy starts at dispatch into pinned memory and ``__array__`` waits on
its CUDA event.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import kernels, keycode
from .batch import COMMITTED, TOO_OLD, EncodedBatch
from .kernels import (SENTINEL_MAPPED, _pack_bits32, commit_chain,
                      hist_check, mapped)
from .keycode import DEFAULT_WIDTH

SENTINEL_LANE = 0xFFFFFFFF
_SIGN = np.uint32(0x80000000)
_SIGN32 = -(1 << 31)        # the same bit on an int32 tensor
_INT64_MIN = -(1 << 63)


def map_lanes(a: np.ndarray) -> np.ndarray:
    """u32 lanes -> the order-preserving int32 lanes the port computes on."""
    return (np.asarray(a, dtype=np.uint32) ^ _SIGN).view(np.int32)


def unmap_lanes(a: np.ndarray) -> np.ndarray:
    """int32 lanes -> the reference's u32 lanes."""
    return np.asarray(a, dtype=np.int32).view(np.uint32) ^ _SIGN


def default_device(device=None) -> torch.device:
    """``None`` means the CUDA card.  Without one, raise: the CPU runs
    only when the caller asks for ``torch.device("cpu")``."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device=torch.device('cpu') to run "
                "the plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ConflictState(NamedTuple):
    """Device-resident conflict history, canonical oldest-first ring."""
    hb: torch.Tensor     # [L, C] int32 mapped — range begin lanes
    he: torch.Tensor     # [L, C] int32 mapped — range end lanes
    hver: torch.Tensor   # [C] int64 — slot versions, -1 = never written
    floor: torch.Tensor  # [] int64 — too-old boundary


def init_state(capacity: int, width: int = DEFAULT_WIDTH,
               oldest_version: int = 0,
               device: torch.device | None = None) -> ConflictState:
    L = keycode.nlanes(width)
    return ConflictState(
        hb=torch.full((L, capacity), SENTINEL_MAPPED, dtype=torch.int32,
                      device=device),
        he=torch.full((L, capacity), SENTINEL_MAPPED, dtype=torch.int32,
                      device=device),
        hver=torch.full((capacity,), -1, dtype=torch.int64, device=device),
        floor=torch.tensor(oldest_version, dtype=torch.int64, device=device),
    )


def state_from_numpy(hb: np.ndarray, he: np.ndarray, hver: np.ndarray,
                     floor, device) -> ConflictState:
    """The reference's ConflictState as numpy ([L, C] u32 planes, [C]
    int64 versions, scalar floor) -> the port's mapped state on
    ``device``."""
    dev = torch.device(device)
    return ConflictState(
        hb=torch.from_numpy(map_lanes(hb).copy()).to(dev),
        he=torch.from_numpy(map_lanes(he).copy()).to(dev),
        hver=torch.from_numpy(np.asarray(hver, np.int64).copy()).to(dev),
        floor=torch.tensor(int(floor), dtype=torch.int64, device=dev))


def state_to_numpy(state: ConflictState):
    """-> (hb u32 [L, C], he u32 [L, C], hver int64 [C], floor int), the
    reference's layout and dtypes."""
    return (unmap_lanes(state.hb.cpu().numpy()),
            unmap_lanes(state.he.cpu().numpy()),
            state.hver.cpu().numpy().copy(), int(state.floor))


# --------------------------------------------------------------------------
# single-batch core


def _append(plane, slab, ring_inplace: bool, spares, idx: int):
    """[plane[:, S:] | slab].  With ``ring_inplace`` kernel K2 writes it
    into the spare plane ``spares[idx]`` and the old plane becomes the
    spare, so the previous state's planes are recycled."""
    if not ring_inplace:
        return torch.cat([plane[:, slab.shape[1]:], slab], dim=1)
    out = spares[idx] if spares is not None else None
    if out is None or out.shape != plane.shape or out.device != plane.device:
        out = torch.empty_like(plane)
    kernels.ring_append(plane, slab, out)
    if spares is not None:
        spares[idx] = plane
    return out


def resolve_core(state: ConflictState, read_begin, read_end, write_begin,
                 write_end, snap, commit_version: int, *,
                 width: int = DEFAULT_WIDTH, window: int = 0,
                 points: bool = False, ring_inplace: bool = False,
                 spares: list | None = None):
    """One resolve step: (state, batch) -> (state', verdicts [B] int8).

    ``commit_version < 0`` marks a padding batch: verdicts are computed
    but the ring is left untouched.  ``window`` > 0 enables the exact
    fast path (only the newest ``window`` slots can hold a conflict
    unless a snapshot predates the slot just outside the window), chosen
    on the device by kernel K3's predicate."""
    C = state.hver.shape[0]
    B, R, L = read_begin.shape
    S_ = B * R
    if S_ > C:
        raise ValueError(f"slab {S_} exceeds ring capacity {C}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")

    # 1. reads vs the device history ring -> [B]; with a window, kernel
    # K3 makes the reference's window/full-ring choice itself
    hit = torch.zeros(B, dtype=torch.int32, device=snap.device)
    ring = (state.hb, state.he, state.hver)
    if window and window < C:
        hist_check(read_begin, read_end, snap, width, points, hit, [ring],
                   window=(state.hb[:, C - window:], state.he[:, C - window:],
                           state.hver[C - window:]),
                   edge=state.hver[C - window - 1:C - window],
                   floor=state.floor.reshape(1))
    else:
        hist_check(read_begin, read_end, snap, width, points, hit, [ring])

    # 2-3. intra-batch overlap + in-order commit chain + the slab (K1)
    verdicts = torch.empty(B, dtype=torch.int8, device=snap.device)
    committed = torch.empty(B, dtype=torch.bool, device=snap.device)
    if commit_version < 0:
        commit_chain(read_begin, read_end, write_begin, write_end, hit, snap,
                     state.floor.reshape(1), width, points, verdicts,
                     committed)
        return state, verdicts
    slab_b = torch.empty((L, S_), dtype=torch.int32, device=snap.device)
    slab_e = torch.empty_like(slab_b)
    commit_chain(read_begin, read_end, write_begin, write_end, hit, snap,
                 state.floor.reshape(1), width, points, verdicts, committed,
                 slab=(slab_b, slab_e, None))

    # 4. append the batch's slab; evicting the S_ oldest slots raises
    # the too-old floor to their max version
    hb2 = _append(state.hb, slab_b, ring_inplace, spares, 0)
    he2 = _append(state.he, slab_e, ring_inplace, spares, 1)
    slab_v = torch.full((S_,), commit_version, dtype=torch.int64,
                        device=state.hver.device)
    hv2 = torch.cat([state.hver[S_:], slab_v])
    floor2 = torch.maximum(state.floor, state.hver[:S_].max())
    return ConflictState(hb2, he2, hv2, floor2), verdicts


def resolve_many_core(state: ConflictState, read_begin, read_end,
                      write_begin, write_end, snap,
                      commit_versions: list[int], *,
                      width: int = DEFAULT_WIDTH, window: int = 0,
                      points: bool = False, ring_inplace: bool = False,
                      spares: list | None = None):
    """K fused batches: inputs [K,B,R,L] / [K,B] on the device, commit
    versions on the host (< 0 marks a trailing padding batch).

    Identical to K chained single-batch steps, including at eviction
    edges: batch k's too-old floor is the start floor maxed with every
    cold slot its predecessors' appends evicted (one strided slice +
    cummax, since slots are appended in version order).  Padding
    batches write sentinel slabs into the hot buffer but are dropped at
    the final append, so the cold ring advances by exactly the real
    slabs."""
    K, B, R, L = read_begin.shape
    S_ = B * R
    T = K * S_
    C = state.hver.shape[0]
    if window <= 0 or window >= C or T > C:
        # compat path (tiny rings / windowless): chain the single core
        out = []
        for k in range(K):
            state, v = resolve_core(
                state, read_begin[k], read_end[k], write_begin[k],
                write_end[k], snap[k], commit_versions[k], width=width,
                window=window, points=points, ring_inplace=ring_inplace,
                spares=spares)
            out.append(v)
        return state, torch.stack(out)

    W = window
    dev = state.hver.device
    start_floor = state.floor
    if K > 1:
        edges = torch.cummax(state.hver[S_ - 1:T - 1:S_], dim=0).values
    else:
        edges = torch.zeros((0,), dtype=torch.int64, device=dev)
    floors = torch.maximum(start_floor, torch.cat(
        [torch.full((1,), _INT64_MIN, dtype=torch.int64, device=dev),
         edges]))
    # hot staging buffer: [edge slot | cold's W newest | K slabs]
    fill = torch.full((L, T), SENTINEL_MAPPED, dtype=torch.int32, device=dev)
    hotb = torch.cat([state.hb[:, C - W - 1:], fill], dim=1)
    hote = torch.cat([state.he[:, C - W - 1:], fill], dim=1)
    hotv = torch.cat([state.hver[C - W - 1:],
                      torch.full((T,), -1, dtype=torch.int64, device=dev)])
    hits = torch.zeros((K, B), dtype=torch.int32, device=dev)
    verdicts = torch.empty((K, B), dtype=torch.int8, device=dev)
    committed = torch.empty((K, B), dtype=torch.bool, device=dev)
    full = ((state.hb, state.he, state.hver), (hotb, hote, hotv))

    def views(k):
        """Batch k's arguments of K3 and K1.  Its window is
        hot[1+off : 1+off+W] and its edge hot[off]; its full side is the
        cold ring + the whole hot buffer (rows not yet written hold
        sentinel intervals, which overlap nothing); its slab goes to
        hot[1+W+off : 1+W+off+S_]."""
        off = k * S_
        win = slice(off + 1, off + 1 + W)
        dst = slice(off + 1 + W, off + 1 + W + S_)
        rows = dict(rb=read_begin[k], re=read_end[k], snap=snap[k],
                    width=width, points=points, hit=hits[k])
        return (dict(rows, full=full,
                     window=(hotb[:, win], hote[:, win], hotv[win]),
                     edge=hotv[off:off + 1], floor=floors[k:k + 1]),
                dict(rows, wb=write_begin[k], we=write_end[k],
                     floor=floors[k:k + 1], verdicts=verdicts[k],
                     committed=committed[k],
                     slab=(hotb[:, dst], hote[:, dst], hotv[dst])))

    # each batch is two launches, K3 then K1, and no other device op
    launches = kernels.GroupLaunches(views, K)
    lastv = None        # until a real batch has run: the cold ring's newest
    for k in range(K):
        if commit_versions[k] >= 0:
            lastv = commit_versions[k]
        # pad slabs carry the last real version: version density keeps
        # the window edge test sound
        launches.run(k, -1 if lastv is None else lastv,
                     state.hver[C - 1:] if lastv is None else None)

    # bulk append of the REAL slabs only (real batches precede pads)
    n_real = sum(1 for cv in commit_versions if cv >= 0)
    shift = n_real * S_
    hot_sb = hotb[:, 1 + W:]
    hot_se = hote[:, 1 + W:]
    if ring_inplace and n_real == K:
        hb2 = _append(state.hb, hot_sb, True, spares, 0)
        he2 = _append(state.he, hot_se, True, spares, 1)
    else:
        # a partially padded group: the host-side dynamic slice
        hb2 = torch.cat([state.hb[:, shift:], hot_sb[:, :shift]], dim=1)
        he2 = torch.cat([state.he[:, shift:], hot_se[:, :shift]], dim=1)
    hv2 = torch.cat([state.hver[shift:], hotv[1 + W:1 + W + shift]])
    # evicted = the n_real*S_ oldest cold slots
    evict_mask = torch.arange(T, device=dev) < shift
    floor2 = torch.maximum(start_floor, torch.where(
        evict_mask, state.hver[:T], -1).max())
    return ConflictState(hb2, he2, hv2, floor2), verdicts


def resolve_many_packed(state: ConflictState, lanes, snaps,
                        commit_versions: list[int], *, shape,
                        width: int = DEFAULT_WIDTH, window: int = 0,
                        points: bool = False, ring_inplace: bool = False,
                        spares: list | None = None):
    """resolve_many_core on one lane buffer: ``lanes`` [4*K*B*R*L] int32
    = rb | re | wb | we (mapped), ``snaps`` [K*B] int64."""
    K, B, R, L = shape
    n = K * B * R * L
    rb = lanes[0:n].view(K, B, R, L)
    re = lanes[n:2 * n].view(K, B, R, L)
    wb = lanes[2 * n:3 * n].view(K, B, R, L)
    we = lanes[3 * n:4 * n].view(K, B, R, L)
    return resolve_many_core(state, rb, re, wb, we, snaps.view(K, B),
                             commit_versions, width=width, window=window,
                             points=points, ring_inplace=ring_inplace,
                             spares=spares)


# --------------------------------------------------------------------------
# the endpoint dictionary (transfer compression)


def _point_end(x: torch.Tensor, width: int) -> torch.Tensor:
    """Mapped lane rows of k+'\\0' derived from k's: identical data lanes
    (the appended NUL is already the zero padding), length lane + 1
    clamped to the truncation marker; sentinels stay sentinels."""
    ll = x[..., -1]
    newll = torch.where(ll == SENTINEL_MAPPED, ll,
                        ll.clamp(max=mapped(width + 1) - 1) + 1)
    return torch.cat([x[..., :-1], newll[..., None]], dim=-1)


def dict_update_step(dct: torch.Tensor, upd_slots: torch.Tensor,
                     upd_lanes: torch.Tensor) -> torch.Tensor:
    """``dct[upd_slots[u]] = upd_lanes[:, u]``, in place.  ``upd_slots``
    [U] int32 slot ids, ``upd_lanes`` [L, U] int32 holding the reference's
    u32 lane bits (mapped here, once per update).  Padding updates all
    write sentinel lanes to slot 0, so which duplicate lands does not
    matter; real slots are unique within a group."""
    dct.index_copy_(0, upd_slots.long(), (upd_lanes ^ _SIGN32).t())
    return dct


def _dict_rows(dct: torch.Tensor, ids: torch.Tensor, shape, width: int,
               compact: bool):
    """(rb, re, wb, we) [K, B, R, L] gathered from the dictionary by one
    ``index_select``: ``ids`` = rb | re | wb | we slot ids, or with
    ``compact`` rb | wb, the end rows derived by ``_point_end``."""
    K, B, R, L = shape
    nseg = 2 if compact else 4
    rows = dct.index_select(0, ids[:nseg * K * B * R]).view(nseg, K, B, R, L)
    if compact:
        ends = _point_end(rows, width)
        return rows[0], ends[0], rows[1], ends[1]
    return rows[0], rows[1], rows[2], rows[3]


def resolve_many_ids(state: ConflictState, dct: torch.Tensor, ids, upd_slots,
                     upd_lanes, snaps, commit_versions: list[int], *, shape,
                     width: int = DEFAULT_WIDTH, window: int = 0,
                     compact: bool = False, points: bool = False,
                     ring_inplace: bool = False, spares: list | None = None):
    """resolve_many_core on dictionary-compressed inputs; returns (state,
    dct, verdicts) with ``dct`` updated in place.

    ``ids`` [4*K*B*R] int32 = rb | re | wb | we slot ids (or with
    ``compact`` — an all-point group — [2*K*B*R] = rb | wb); updates
    apply before the gathers, and the host never evicts a slot the
    group references, so the rows are bit-identical to the lanes path's.
    ``snaps`` [K*B] int64; commit versions on the host."""
    if upd_slots.numel():
        dict_update_step(dct, upd_slots, upd_lanes)
    rb, re, wb, we = _dict_rows(dct, ids, shape, width, compact)
    K, B = shape[:2]
    st, verdicts = resolve_many_core(
        state, rb, re, wb, we, snaps.view(K, B), commit_versions,
        width=width, window=window, points=points,
        ring_inplace=ring_inplace, spares=spares)
    return st, dct, verdicts


def fused_offsets(shape, compact: bool) -> tuple[int, int, int]:
    """(off_pi, npi, off_upd) of the fused buffer (see resolve_many_fused)."""
    K, B, R = shape[:3]
    nids = (2 if compact else 4) * K * B * R
    off_pi = (nids + 1) // 2 * 2
    npi = 2 * (K * B + K)
    return off_pi, npi, off_pi + npi


def resolve_many_fused(state: ConflictState, dct: torch.Tensor,
                       fused: torch.Tensor, commit_versions: list[int], *,
                       shape, width: int = DEFAULT_WIDTH, window: int = 0,
                       compact: bool = False, U: int = 0,
                       points: bool = False, ring_inplace: bool = False,
                       spares: list | None = None):
    """resolve_many_ids on ONE int32 buffer, the layout the native group
    encoder writes (native/keycodec.cpp kc_encode_group_fused):

        [0, nids)                  ids; nids = (compact?2:4)*K*B*R
        [off_pi, off_pi+npi)       snapshots [K*B] + versions [K] as
                                   little-endian u32 pairs
        [off_upd, ...)             upd_slots [U] | upd_lanes [L, U]

    ``U`` is the bucketed update count (0 skips the scatter: a warm
    dictionary).  The versions also ride in the buffer; the loop takes
    the host's ``commit_versions``, which the caller checks equal."""
    K, B, R, L = shape
    off_pi, _, off_upd = fused_offsets(shape, compact)
    if U:
        dict_update_step(dct, fused[off_upd:off_upd + U],
                         fused[off_upd + U:off_upd + U + L * U].view(L, U))
    snaps = fused[off_pi:off_pi + 2 * K * B].view(torch.int64).view(K, B)
    rb, re, wb, we = _dict_rows(dct, fused, shape, width, compact)
    st, verdicts = resolve_many_core(
        state, rb, re, wb, we, snaps, commit_versions, width=width,
        window=window, points=points, ring_inplace=ring_inplace,
        spares=spares)
    return st, dct, verdicts


def dict_from_numpy(dct: np.ndarray, device) -> torch.Tensor:
    """The reference's dictionary ([L, D] u32) -> the port's [D, L] mapped."""
    rows = np.ascontiguousarray(np.asarray(dct, dtype=np.uint32).T)
    return torch.from_numpy(map_lanes(rows)).to(torch.device(device))


def dict_to_numpy(dct: torch.Tensor) -> np.ndarray:
    """The port's [D, L] mapped dictionary -> the reference's [L, D] u32."""
    return np.ascontiguousarray(unmap_lanes(dct.cpu().numpy()).T)


def set_oldest_step(state: ConflictState, v: int) -> ConflictState:
    """setOldestVersion analog: only the too-old floor moves (a device op
    on the same stream, no sync)."""
    return state._replace(floor=state.floor.clamp(min=v))


# --------------------------------------------------------------------------
# verdict readback


class _Readback:
    """A device→host copy started at dispatch.  On a CUDA tensor it goes
    into pinned memory behind a CUDA event, which ``np.asarray`` (the
    backend's sync, on its worker thread) waits on."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor) -> None:
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t
            self.event = None

    def __array__(self, dtype=None, copy=None):
        if self.event is not None:
            self.event.synchronize()
        a = self.host.numpy()
        return a if dtype is None else a.astype(dtype)


def pack_verdicts_step(verdicts: torch.Tensor, *, K: int, B: int):
    """[K, B] int8 verdicts -> (summary [ceil(K/32)] int32 with bit k set
    iff batch k holds any non-COMMITTED verdict, planes [2*K*nw] int32 =
    the abort plane (verdict != COMMITTED) then the TOO_OLD plane)."""
    nonc = verdicts != COMMITTED
    told = verdicts == TOO_OLD
    planes = torch.cat([_pack_bits32(nonc).reshape(-1),
                        _pack_bits32(told).reshape(-1)])
    summary = _pack_bits32(nonc.any(dim=1)[None, :]).reshape(-1)
    return summary, planes


class PackedVerdicts:
    """Handle on a device-reduced verdict transfer (pack_verdicts_step).

    ``np.asarray`` syncs the summary word(s), returns all-COMMITTED when
    no bit is set, and only then reads and unpacks the bit planes.
    ``synced_bytes`` records what the sync read: the summary always, the
    planes only when read."""

    __slots__ = ("summary", "planes", "K", "B", "synced_bytes")

    def __init__(self, summary: _Readback, planes: _Readback, K: int, B: int):
        self.summary = summary
        self.planes = planes
        self.K = K
        self.B = B
        self.synced_bytes = 0

    @staticmethod
    def unpack(summary: np.ndarray, planes: np.ndarray,
               K: int, B: int) -> np.ndarray:
        nw = (B + 31) // 32
        shifts = np.arange(32, dtype=np.uint32)

        def bits(words):
            m = ((words[:, :, None] >> shifts) & np.uint32(1))
            return m.reshape(K, nw * 32)[:, :B].astype(np.int8)

        conf = bits(planes[:K * nw].reshape(K, nw))
        told = bits(planes[K * nw:].reshape(K, nw))
        return conf + told

    def to_numpy(self) -> np.ndarray:
        s = np.asarray(self.summary).view(np.uint32)
        self.synced_bytes = s.nbytes
        if not s.any():
            return np.zeros((self.K, self.B), np.int8)
        p = np.asarray(self.planes).view(np.uint32)
        self.synced_bytes += p.nbytes
        return self.unpack(s, p, self.K, self.B)

    def __array__(self, dtype=None, copy=None):
        a = self.to_numpy()
        return a if dtype is None else a.astype(dtype)


# group sizes for resolve_many; a group of k batches is padded up to the
# next bucket with padding batches (commit_version=-1, sentinel slabs)
GROUP_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# update-count buckets of the dictionary path: the ids path ships at
# most the last (more goes through apply_dict_updates); the fused
# buffer's update block is padded to one of FUSED_UPD_BUCKETS, 0 for a
# warm dictionary, so its layout is the reference's
UPD_BUCKETS = (1024, 4096, 16384, 32768)
FUSED_UPD_BUCKETS = (0, 256, 1024, 4096, 16384, 32768)


def _np_point_end(x: np.ndarray, width: int) -> np.ndarray:
    """Lane rows of k+'\\0' derived from k's (u32 host lanes)."""
    ll = x[..., -1]
    sent = ll == np.uint32(0xFFFFFFFF)
    newll = np.where(sent, ll, np.minimum(ll + 1, np.uint32(width + 1)))
    return np.concatenate([x[..., :-1], newll[..., None]], axis=-1)


def _eb_is_point(eb: EncodedBatch, width: int) -> bool:
    """True iff every range in the batch is a point [k, k+nul) — the
    gate for the equality-rule history check."""
    return bool(
        np.array_equal(eb.read_end, _np_point_end(eb.read_begin, width))
        and np.array_equal(eb.write_end, _np_point_end(eb.write_begin, width)))


_FIELDS = ("read_begin", "read_end", "write_begin", "write_end")


class StagingRing:
    """``n`` host buffers handed out in turn for uploads that run while
    the host goes on encoding.

    With ``pinned`` the buffers are page-locked, so a ``non_blocking``
    copy to the card is truly asynchronous: ``upload`` records a CUDA
    event after the copy that reads a buffer, and ``take`` waits on that
    event before it hands the buffer out again, so the encoder never
    rewrites bytes the card is still reading.  Unpinned (the CPU), the
    copy is done before ``upload`` returns."""

    def __init__(self, n: int = 8, pinned: bool = False) -> None:
        self.n = n
        self.pinned = pinned
        self._bufs: list[torch.Tensor] = []
        self._events: list = []
        self._i = 0

    def take(self, words: int) -> np.ndarray:
        """The next buffer of at least ``words`` u32 words, free to write."""
        if not self._bufs or self._bufs[0].numel() < words:
            self._bufs = [torch.zeros(words, dtype=torch.int32,
                                      pin_memory=self.pinned)
                          for _ in range(self.n)]
            # int64 views of the buffer's even offsets need 8-byte
            # alignment; the allocators give far more
            assert all(b.data_ptr() % 8 == 0 for b in self._bufs)
            self._events = [None] * self.n
        self._i = (self._i + 1) % self.n
        ev = self._events[self._i]
        if ev is not None:
            ev.synchronize()
            self._events[self._i] = None
        return self._bufs[self._i].numpy().view(np.uint32)

    def upload(self, arr: np.ndarray, device: torch.device) -> torch.Tensor:
        """``arr`` (a prefix of a buffer from ``take``, or any u32 array)
        as an int32 tensor on ``device``."""
        src = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))
        if device.type != "cuda":
            return src.clone()
        owner = next((i for i, b in enumerate(self._bufs)
                      if b.data_ptr() == arr.ctypes.data), None)
        if owner is None:
            return src.to(device)       # pageable: staged before return
        out = self._bufs[owner][:arr.size].to(device, non_blocking=True)
        assert out.data_ptr() % 8 == 0
        ev = torch.cuda.Event()
        ev.record()
        self._events[owner] = ev
        return out


class TorchConflictSet:
    """Drop-in peer of NumpyConflictSet backed by the hand kernels.

    Keeps state on ``device`` (the CUDA card unless the caller passes
    ``torch.device("cpu")``, where the kernels' plain versions run).  The
    ring is allocated on the first batch, when the slab size B*R is
    known; ``capacity`` is rounded up to a whole number of slabs."""

    def __init__(self, capacity: int, width: int = DEFAULT_WIDTH,
                 oldest_version: int = 0, device=None, window: int = 4096,
                 dict_slots: int = 0, ring_inplace: bool = False,
                 pack_verdicts: bool = False):
        self.device = default_device(device)
        self.capacity = capacity
        self.width = width
        self.window = window
        self.dict_slots = dict_slots
        self.ring_inplace = ring_inplace
        self.pack = pack_verdicts
        self.state: ConflictState | None = None
        self._dct: torch.Tensor | None = None   # [D, L] lane dictionary
        # the fused path's host buffers: pinned, and fenced by the copy
        # that last read them, on a CUDA device
        self.staging = StagingRing(pinned=self.device.type == "cuda")
        self.h2d_bytes = 0          # host-to-device bytes of every upload
        self._init_floor = oldest_version
        self._slab: int | None = None
        self._spares: list = [None, None]   # ping-pong planes (hb, he)
        # True while every record in the ring is a point range: gates the
        # equality-rule check; a range-bearing dispatch clears it until
        # the next ring reset
        self._ring_all_point = True

    def _set_slab(self, slab: int) -> None:
        self._slab = slab
        if not (0 < self.window < self.capacity):
            self.window = 0

    def _ensure_state(self, B: int, R: int) -> None:
        if self.state is not None:
            if self._slab is None:
                if self.capacity % (B * R):
                    raise ValueError(f"carried ring of {self.capacity} "
                                     f"slots is not whole slabs of {B * R}")
                self._set_slab(B * R)
            elif self._slab != B * R:
                raise ValueError(
                    f"batch shape changed: slab {B * R} != {self._slab}")
            return
        slab = B * R
        self.capacity = ((self.capacity + slab - 1) // slab) * slab
        self._set_slab(slab)
        self.state = init_state(self.capacity, self.width, self._init_floor,
                                self.device)

    def _ensure_dict(self) -> torch.Tensor:
        if self._dct is None:
            if not self.dict_slots:
                raise RuntimeError("dictionary disabled")
            self._dct = torch.full(
                (self.dict_slots, keycode.nlanes(self.width)),
                SENTINEL_MAPPED, dtype=torch.int32, device=self.device)
        return self._dct

    def load_dict(self, dct: np.ndarray) -> None:
        """Install a carried dictionary (the reference's [L, D] u32)."""
        self._dct = dict_from_numpy(dct, self.device)
        self.dict_slots = self._dct.shape[0]

    def dict_to_numpy(self) -> np.ndarray:
        """The dictionary in the reference's layout, [L, D] u32."""
        return dict_to_numpy(self._ensure_dict())

    def load_state(self, hb: np.ndarray, he: np.ndarray, hver: np.ndarray,
                   floor, ring_all_point: bool = False) -> None:
        """Install a carried ring (the reference's numpy layout, see
        state_from_numpy).  ``ring_all_point`` may stay False: the
        interval check is exact on any ring."""
        self.state = state_from_numpy(hb, he, hver, floor, self.device)
        self.capacity = int(np.asarray(hver).shape[0])
        self._slab = None
        self._spares = [None, None]
        self._ring_all_point = ring_all_point

    def reset_ring(self, oldest_version: int = 0) -> None:
        """Clear the conflict history ring but KEEP the lane dictionary:
        it is pure transfer compression (verdicts never depend on it), so
        a restarted window or a bench's next pass need not re-ship every
        endpoint."""
        if self.state is None:
            self._init_floor = oldest_version
            return
        self.state = init_state(self.capacity, self.width, oldest_version,
                                self.device)
        self._spares = [None, None]
        self._ring_all_point = True

    def set_oldest_version(self, v: int) -> None:
        if self.state is None:
            self._init_floor = max(self._init_floor, v)
        else:
            self.state = set_oldest_step(self.state, v)

    @property
    def oldest_version(self) -> int:
        if self.state is None:
            return self._init_floor
        return int(self.state.floor)

    def _host(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(n, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _put(self, arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """``arr`` (u32 viewed as int32, or int64) on the device, copied
        through a fresh host buffer, so the caller may rewrite ``arr`` at
        once: the encoder clears its update buffers for the next group
        while this copy may still be in flight (a pinned block goes back
        to the caching host allocator only after the copy has read it)."""
        h = self._host(arr.size, dtype)
        hn = h.numpy()
        hn[:] = np.asarray(arr).reshape(-1).view(hn.dtype)
        self.h2d_bytes += hn.nbytes
        return h.to(self.device, non_blocking=self.device.type == "cuda")

    def _upload(self, ebs: list[EncodedBatch], K: int):
        """The group's lanes (mapped) and snapshots in two host buffers,
        pinned for a CUDA device, copied without blocking the host."""
        B, R, L = ebs[0].read_begin.shape
        n = K * B * R * L
        kn = len(ebs) * B * R * L
        lanes = self._host(4 * n, torch.int32)
        u = lanes.numpy().view(np.uint32)
        u[:] = SENTINEL_LANE
        for f, field in enumerate(_FIELDS):
            dst = u[f * n:f * n + kn].reshape(len(ebs), B, R, L)
            for i, e in enumerate(ebs):
                dst[i] = getattr(e, field)
        u ^= _SIGN
        snaps = self._host(K * B, torch.int64)
        s = snaps.numpy()
        s[:] = -1
        for i, e in enumerate(ebs):
            s[i * B:(i + 1) * B] = e.read_snapshot
        nb = self.device.type == "cuda"
        self.h2d_bytes += 4 * lanes.numel() + 8 * snaps.numel()
        return (lanes.to(self.device, non_blocking=nb),
                snaps.to(self.device, non_blocking=nb))

    def _finish_submit(self, verdicts: torch.Tensor, K: int, B: int):
        """Group-dispatch epilogue: under RESOLVER_VERDICT_BITMASK the
        [K, B] verdicts are reduced on the device to the summary+planes
        pair and only those read back; the copies start now either way."""
        if self.pack:
            summary, planes = pack_verdicts_step(verdicts, K=K, B=B)
            return PackedVerdicts(_Readback(summary), _Readback(planes), K, B)
        return _Readback(verdicts)

    def resolve_encoded_submit(self, eb: EncodedBatch,
                               commit_version: int) -> _Readback:
        """Dispatch one resolve and return the (not yet synced) verdict
        handle; ``self.state`` is already the post-batch state."""
        B, R, L = eb.read_begin.shape
        self._ensure_state(B, R)
        use_points = self._ring_all_point = \
            self._ring_all_point and _eb_is_point(eb, self.width)
        lanes, snaps = self._upload([eb], 1)
        n = B * R * L
        self.state, verdicts = resolve_core(
            self.state, lanes[0:n].view(B, R, L), lanes[n:2 * n].view(B, R, L),
            lanes[2 * n:3 * n].view(B, R, L), lanes[3 * n:].view(B, R, L),
            snaps, commit_version, width=self.width, window=self.window,
            points=use_points, ring_inplace=self.ring_inplace,
            spares=self._spares)
        return _Readback(verdicts)

    def resolve_group_submit(self, ebs: list[EncodedBatch],
                             commit_versions: list[int],
                             k_pad: int | None = None):
        """Fuse a group of batches into one dispatch; returns the
        (unsynced) [K, B] verdict handle, rows past len(ebs) padding.
        ``k_pad`` overrides the bucket."""
        if len(ebs) != len(commit_versions) or not ebs:
            raise ValueError("one commit version per batch, at least one")
        B, R, L = ebs[0].read_begin.shape
        self._ensure_state(B, R)
        k = len(ebs)
        if k_pad is not None and k_pad >= k:
            K = k_pad
        else:
            K = next(b for b in GROUP_BUCKETS if b >= k) \
                if k <= GROUP_BUCKETS[-1] \
                else ((k + GROUP_BUCKETS[-1] - 1) // GROUP_BUCKETS[-1]) \
                * GROUP_BUCKETS[-1]
        use_points = self._ring_all_point = self._ring_all_point \
            and all(_eb_is_point(e, self.width) for e in ebs)
        lanes, snaps = self._upload(ebs, K)
        cvs = list(commit_versions) + [-1] * (K - k)
        self.state, verdicts = resolve_many_packed(
            self.state, lanes, snaps, cvs, shape=(K, B, R, L),
            width=self.width, window=self.window, points=use_points,
            ring_inplace=self.ring_inplace, spares=self._spares)
        return self._finish_submit(verdicts, K, B)

    def _dict_gate(self, compact: bool) -> bool:
        """The equality-rule gate of a dictionary dispatch: ``compact``
        proves the GROUP all-point (the native encoder's byte-level
        test); the rule also needs an all-point RING."""
        use_points = compact and self._ring_all_point
        self._ring_all_point = self._ring_all_point and compact
        return use_points

    def resolve_group_submit_dict(self, ibs: list, commit_versions: list[int],
                                  upd_slots: np.ndarray,
                                  upd_lanes: np.ndarray, n_upd: int):
        """Dictionary-compressed group dispatch from per-batch IdBatches;
        see resolve_group_submit_ids for the packed fast path."""
        if len(ibs) != len(commit_versions) or not ibs:
            raise ValueError("one commit version per batch, at least one")
        B, R = ibs[0].read_begin.shape
        k = len(ibs)
        K = next(b for b in GROUP_BUCKETS if b >= k)
        n = K * B * R
        ids = np.zeros(4 * n, dtype=np.uint32)      # 0 = sentinel slot
        for f, field in enumerate(_FIELDS):
            dst = ids[f * n:f * n + k * B * R].reshape(k, B, R)
            for i, e in enumerate(ibs):
                dst[i] = getattr(e, field)
        snaps = np.full((K, B), -1, dtype=np.int64)
        for i, e in enumerate(ibs):
            snaps[i] = e.read_snapshot
        # slot ids carry no pointness proof, so the interval rule runs
        # and the ring's all-point flag clears (compact=False)
        return self.resolve_group_submit_ids(ids, snaps, (K, B, R),
                                             commit_versions, upd_slots,
                                             upd_lanes, n_upd)

    def resolve_group_submit_ids(self, ids: np.ndarray, snaps: np.ndarray,
                                 shape: tuple, commit_versions: list[int],
                                 upd_slots: np.ndarray,
                                 upd_lanes: np.ndarray, n_upd: int,
                                 compact: bool = False):
        """Dictionary-compressed group dispatch: u32 ids + lane updates
        instead of full lane arrays, four uploads.  Same [K, B] verdict
        contract as ``resolve_group_submit`` and bit-identical verdicts
        and ring state.  ``ids`` is the packed [4*K*B*R] buffer (0 =
        sentinel), ``snaps`` [K, B] with -1 padding."""
        K, B, R = shape
        self._ensure_state(B, R)
        dct = self._ensure_dict()
        L = keycode.nlanes(self.width)
        if n_upd > UPD_BUCKETS[-1]:
            raise ValueError(f"{n_upd} updates exceed {UPD_BUCKETS[-1]}")
        cvs = list(commit_versions) + [-1] * (K - len(commit_versions))
        use_points = self._dict_gate(compact)
        self.state, self._dct, verdicts = resolve_many_ids(
            self.state, dct, self._put(ids, torch.int32),
            self._put(upd_slots[:n_upd], torch.int32),
            self._put(upd_lanes[:, :n_upd], torch.int32).view(L, n_upd),
            self._put(snaps, torch.int64), cvs, shape=(K, B, R, L),
            width=self.width, window=self.window, compact=compact,
            points=use_points, ring_inplace=self.ring_inplace,
            spares=self._spares)
        return self._finish_submit(verdicts, K, B)

    def resolve_group_submit_fused(self, fused: np.ndarray, shape: tuple,
                                   compact: bool, U: int,
                                   commit_versions: list[int]):
        """Single-upload group dispatch: ``fused`` is the complete layout
        written by the native group encoder plus the update block (see
        resolve_many_fused), in a buffer of ``self.staging`` (any u32
        array works, copied before this returns).  ``commit_versions``
        must equal the buffer's copy of them."""
        K, B, R = shape
        self._ensure_state(B, R)
        dct = self._ensure_dict()
        L = keycode.nlanes(self.width)
        cvs = list(commit_versions) + [-1] * (K - len(commit_versions))
        off_pi, npi, _ = fused_offsets(shape, compact)
        if not np.array_equal(
                fused[off_pi + 2 * K * B:off_pi + npi].view(np.int64), cvs):
            raise ValueError("commit versions differ from the fused buffer's")
        use_points = self._dict_gate(compact)
        dev = self.staging.upload(fused, self.device)
        self.h2d_bytes += fused.nbytes
        self.state, self._dct, verdicts = resolve_many_fused(
            self.state, dct, dev, cvs, shape=(K, B, R, L), width=self.width,
            window=self.window, compact=compact, U=U, points=use_points,
            ring_inplace=self.ring_inplace, spares=self._spares)
        return self._finish_submit(verdicts, K, B)

    def apply_dict_updates(self, upd_slots: np.ndarray,
                           upd_lanes: np.ndarray, n_upd: int) -> None:
        """Ship updates without a resolve — used when a group falls back
        to the lanes path after its encoder already inserted endpoints
        (the device mirror must not go stale).  Chunked, so any update
        count is accepted."""
        if not self.dict_slots or n_upd == 0:
            return
        dct = self._ensure_dict()
        cap = UPD_BUCKETS[-1]
        for start in range(0, n_upd, cap):
            m = min(n_upd - start, cap)
            dict_update_step(
                dct, self._put(upd_slots[start:start + m], torch.int32),
                self._put(upd_lanes[:, start:start + m], torch.int32)
                .view(upd_lanes.shape[0], m))

    def resolve_encoded(self, eb: EncodedBatch,
                        commit_version: int) -> np.ndarray:
        return np.asarray(self.resolve_encoded_submit(eb, commit_version))
