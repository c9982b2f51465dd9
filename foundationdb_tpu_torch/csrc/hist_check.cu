// K3 — the history check of one resolve batch, for sm_90a.
//
// Replaces: foundationdb_tpu/ops/conflict_jax.py::_hist_check_T and
// ::_point_hist_check_T, which XLA compiles on the TPU, together with the
// lax.cond(fast_ok, window, full ring) around them in resolve_core and in
// the scan body of resolve_many_core.  One launch does the whole choice.
//
// Computes, for every txn b of the batch,
//   hit[b] = 1 if ANY read r of b and slot s of the side taken have
//              rule(read r of b, slot s) && hver[s] > snap[b]
// where rule is, for the interval path,
//   possibly_lt(rb[b,r], he[:,s]) && possibly_lt(hb[:,s], re[b,r])
// and for the all-point path the equality rule (lanes.cuh).  rb, re
// [B, R, L] int32 mapped lanes; each segment is hb, he [L, n] with a row
// stride (a window or hot-buffer view is taken as it lies) and hver [n]
// int64; snap [B] int64; hit [B] int32 holds 0 or 1 (zeroed by the
// caller) and only ever gets 1 written.
//
// The side: segment 0 is the window (n = 0: there is none, and segments
// 1 and 2, the full side, are checked).  With a window, every block
// decides the reference's predicate itself,
//   fast_ok = all(snap < 0 | snap < *floor | snap >= *edge)   (B values),
// and walks the window when it holds, else the cold ring (segment 1) and
// the hot buffer (segment 2).  The untaken side costs nothing and the
// host computes nothing per batch.
//
// Bound on this card: the bytes of the side walked (a slot is 8 bytes of
// version plus 4 * L or 8 * L of lanes) plus the read rows, against
// R * (pairs of a txn and a slot newer than its snapshot) lane operations;
// at the operating point (B = 64, R = 8, L = 9, an 8192-slot window) both
// are about a tenth of a microsecond, so the launch and the few dependent
// memory round trips are what a launch costs.
// Design (each step measured on the H100 with the earlier version slower):
// - Work is (tile of 128 slots, group of 8 txns): a block of 128 threads,
//   one slot each, tests its tiles against one group's txns; a grid of
//   ceil(B/8) x min(tiles, 128) blocks walks the tiles of the side taken
//   (64 tiles for the window).  Giving each block whole tiles against all
//   B txns left the work of the newest tiles, the only ones newer than
//   mako's snapshots, to a few threads (1024 compares in a row; 0.086 ms
//   on the window).  A tile's lanes are read once per group (B/8 times),
//   from L2 after the first.
// - A block first copies its group's read rows into shared memory with
//   asynchronous copies (cp.async), in flight while it decides fast_ok;
//   it returns at once if it has no tile on the side taken.  The rows'
//   live counts, the group's least snapshot and, under the point rule,
//   each read's 32-bit hash of its data lanes follow.
// - Per tile, a thread loads its slot's version and copies its slot's
//   lanes into its own column of shared memory (cp.async: one memory
//   round trip for all lanes; a load-then-store loop waited one trip per
//   lane).  A warp whose 32 slots are all at or below the group's least
//   snapshot skips the tile; a txn whose snapshot is at or above the
//   warp's newest slot is skipped by the whole warp.  In mako only the
//   newest few batches' slots of the window are newer than a snapshot.
// - Under the point rule a compare is a register test of the slot's hash
//   against the txn's read hashes (in registers, 8 at a time); only equal
//   hashes go on to the full rule, so no divergent lane loop runs unless
//   keys match.  The interval rule walks the lanes (possibly_lt).  Rows
//   past a txn's last live row are never compared.
// - No block barrier per txn: a thread keeps its hits for the group as a
//   bit mask, the warp ORs it with __reduce_or_sync, and lane 0 writes a 1
//   for each set bit (hits are rare; the store is idempotent, so no
//   atomic is needed).
// - The ring is read with 4- and 8-byte accesses, coalesced across a
//   warp: the hot buffer's views start at column 1 + k*B*R with an odd
//   row stride, so the layout allows no 16-byte access there.  Fetching
//   the next tile into a second buffer while comparing one measured no
//   faster, and is not done.

#include <cuda_runtime.h>

#include "lanes.cuh"

// One history segment (kernels.py's ``Seg``): outside the anonymous
// namespace, so the C entry point that takes it keeps external linkage.
struct Seg {
  const int* hb;
  const int* he;
  long long stride;
  const long long* hver;
  long long n;
};

struct Segs {
  Seg s[3];          // [0] the window (n = 0: none); [1], [2] the full side
};

namespace {

constexpr int kTile = 128;                 // slots per tile = threads
constexpr int kTxns = 8;                   // txns of a block's group
constexpr int kTileBlocks = 128;           // blocks of one group, at most
constexpr long long kNoVersion = -0x7fffffffffffffffLL - 1;   // INT64_MIN

__host__ __device__ __forceinline__ long long tiles(long long n) {
  return (n + kTile - 1) / kTile;
}

template <bool kPoints>
__global__ void __launch_bounds__(kTile) hist_check_kernel(
    const int* __restrict__ rb, const int* __restrict__ re,
    const long long* __restrict__ snap, int B, int R, int L, int w, int w1,
    int sentinel, Segs segs, const long long* __restrict__ edge,
    const long long* __restrict__ floor_, int* __restrict__ hit) {
  // a tile's lanes, then the group's rows
  extern __shared__ int smem[];
  int* s_cb = smem;                                // [L][kTile]
  int* s_ce = s_cb + L * kTile;                    // [L][kTile] (interval)
  int* s_rb = s_ce + (kPoints ? 0 : L * kTile);    // [kTxns * R * L]
  int* s_re = s_rb + kTxns * R * L;                // (interval)
  __shared__ long long s_snap[kTxns];
  __shared__ int s_live[kTxns];
  __shared__ unsigned s_rh[kTxns * fdbt::kMaxRows];   // points: read hashes
  __shared__ long long s_min;
  const int tid = threadIdx.x, lane = tid & 31;

  // 1. the block's txn group: its rows by asynchronous copies, in flight
  // while the block decides the reference's lax.cond
  const int groups = (B + kTxns - 1) / kTxns;
  const int b0 = (int)(blockIdx.x % groups) * kTxns;
  const int nb = min(kTxns, B - b0);
  for (int x = tid; x < nb * R * L; x += kTile) {
    fdbt::copy_async(s_rb + x, rb + b0 * R * L + x);
    if (!kPoints) fdbt::copy_async(s_re + x, re + b0 * R * L + x);
  }
  if (tid < nb) s_snap[tid] = snap[b0 + tid];
  bool fast = false;
  if (segs.s[0].n > 0) {
    const long long e = *edge, f = *floor_;
    int ok = 1;
    for (int b = tid; b < B; b += kTile) {
      const long long sn = snap[b];
      ok &= (sn < 0) | (sn < f) | (sn >= e);
    }
    fast = __syncthreads_and(ok) != 0;
  }
  const Seg none = {nullptr, nullptr, 0, nullptr, 0};
  const Seg a = fast ? segs.s[0] : segs.s[1];
  const Seg c = fast ? none : segs.s[2];
  const long long ta = tiles(a.n), nt = ta + tiles(c.n);
  const long long t0 = blockIdx.x / groups, tstep = gridDim.x / groups;
  fdbt::copy_wait();
  if (t0 >= nt) return;                  // block-uniform: no tile of its own

  // a tile's version for this thread (returned) and its slot's lanes into
  // the thread's own column, by asynchronous copies; the first tile's
  // fetch overlaps the set-up below
  auto fetch = [&](long long t) -> long long {
    const bool in_a = t < ta;
    const Seg& g = in_a ? a : c;
    const long long slot = (in_a ? t : t - ta) * kTile + tid;
    if (slot >= g.n) return kNoVersion;
    for (int l = 0; l < L; ++l) {
      fdbt::copy_async(s_cb + l * kTile + tid, g.hb + l * g.stride + slot);
      if (!kPoints)
        fdbt::copy_async(s_ce + l * kTile + tid, g.he + l * g.stride + slot);
    }
    return g.hver[slot];
  };
  long long v = fetch(t0);
  __syncthreads();
  if (tid < nb)
    s_live[tid] = fdbt::live_rows(s_rb + tid * R * L, L, 1, R, L, sentinel,
                                  kPoints);
  if (kPoints)
    for (int x = tid; x < nb * R; x += kTile)
      s_rh[x] = fdbt::point_hash(s_rb + x * L, 1, L, sentinel, 0u);
  if (tid == 0) {
    long long m = s_snap[0];
    for (int i = 1; i < nb; ++i) m = s_snap[i] < m ? s_snap[i] : m;
    s_min = m;
  }
  __syncthreads();

  // 2. the side's tiles, this group's txns
  const int* cb = s_cb + tid;
  const int* ce = s_ce + tid;
  for (long long t = t0; t < nt; t += tstep) {
    if (t != t0) v = fetch(t);
    fdbt::copy_wait();
    long long vmax = v;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const long long o = __shfl_xor_sync(0xffffffffu, vmax, d);
      vmax = o > vmax ? o : vmax;
    }
    if (vmax <= s_min) continue;            // warp-uniform: no txn can hit
    // points: the slot's hash (past the end: as unwritten)
    const unsigned hs = kPoints && v != kNoVersion
                            ? fdbt::point_hash(cb, kTile, L, sentinel, 1u)
                            : 1u;
    unsigned mask = 0u;
    for (int i = 0; i < nb; ++i) {
      const long long sn = s_snap[i];
      if (vmax <= sn) continue;             // warp-uniform: nothing newer
      if (v <= sn) continue;
      const int nr = s_live[i];
      const int* txb = s_rb + i * R * L;
      const int* txe = s_re + i * R * L;
      bool mine = false;
      if (kPoints) {
        // the txn's read hashes in registers, 8 at a time (padding 0, a
        // dead read, matches no slot); only equal hashes go on
        for (int r0 = 0; r0 < nr && !mine; r0 += 8) {
          unsigned mm = 0u;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            mm |= (r0 + k < nr && s_rh[i * R + r0 + k] == hs ? 1u : 0u) << k;
          while (mm && !mine) {
            const int k = __ffs(mm) - 1;
            mine = fdbt::point_rule(txb + (r0 + k) * L, 1, cb, kTile, L, w,
                                    w1, sentinel);
            mm &= mm - 1;
          }
        }
      } else {
        for (int r = 0; r < nr && !mine; ++r)
          mine = fdbt::possibly_lt(txb + r * L, 1, ce, kTile, L, w1) &&
                 fdbt::possibly_lt(cb, kTile, txe + r * L, 1, L, w1);
      }
      mask |= (unsigned)mine << i;
    }
    mask = __reduce_or_sync(0xffffffffu, mask);
    if (lane == 0) {
      while (mask) {
        const int i = __ffs(mask) - 1;
        hit[b0 + i] = 1;
        mask &= mask - 1;
      }
    }
  }
}

template <bool kPoints>
int launch(const void* rb, const void* re, const void* snap, int B, int R,
           int L, int w, int w1, int sentinel, const Segs& segs,
           const void* edge, const void* floor_, void* hit,
           cudaStream_t stream) {
  const size_t smem = (size_t)(kPoints ? 1 : 2) *
                      ((size_t)L * kTile + (size_t)kTxns * R * L) * sizeof(int);
  if (smem > 48 * 1024) {
    // once per kernel, for every size (a CUDA runtime call on every
    // launch cost host time in the resolver's loop)
    static bool opted = false;
    if (!opted) {
      const cudaError_t e = cudaFuncSetAttribute(
          hist_check_kernel<kPoints>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, fdbt::kSmemMax);
      if (e != cudaSuccess) return (int)e;
      opted = true;
    }
  }
  const long long groups = (B + kTxns - 1) / kTxns;
  long long full = tiles(segs.s[1].n) + tiles(segs.s[2].n);
  long long blocks = tiles(segs.s[0].n);
  if (full > blocks) blocks = full;
  if (blocks > kTileBlocks) blocks = kTileBlocks;
  blocks *= groups;
  if (blocks == 0) return 0;
  hist_check_kernel<kPoints><<<(unsigned)blocks, kTile, smem, stream>>>(
      (const int*)rb, (const int*)re, (const long long*)snap, B, R, L, w, w1,
      sentinel, segs, (const long long*)edge, (const long long*)floor_,
      (int*)hit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fdbt_hist_check(const void* rb, const void* re,
                               const void* snap, int B, int R, int L, int w,
                               int w1, int sentinel, int points,
                               const Seg* segs, const void* edge,
                               const void* floor_, void* hit, void* stream) {
  if (B <= 0) return 0;
  Segs s;
  for (int i = 0; i < 3; ++i) s.s[i] = segs[i];
  cudaStream_t st = (cudaStream_t)stream;
  if (points)
    return launch<true>(rb, re, snap, B, R, L, w, w1, sentinel, s, edge,
                        floor_, hit, st);
  return launch<false>(rb, re, snap, B, R, L, w, w1, sentinel, s, edge,
                       floor_, hit, st);
}
