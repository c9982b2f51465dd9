// K3 — the history check of one resolve batch, for sm_90a.
//
// Replaces: foundationdb_tpu/ops/conflict_jax.py::_hist_check_T and
// ::_point_hist_check_T, which XLA compiles on the TPU under the
// lax.cond(fast_ok, window, full ring) of resolve_core / resolve_many_core.
//
// Computes, for every txn b of the batch,
//   hit[b] |= ANY over reads r and history slots s of
//             rule(read r of b, slot s) && hver[s] > snap[b]
// where rule is, for the interval path,
//   possibly_lt(rb[b,r], he[:,s]) && possibly_lt(hb[:,s], re[b,r])
// (lexicographic < over the L lanes, or all lanes equal and both length
// lanes the truncation marker width+1), and for the all-point path
//   hb[0:L-1, s] == rb[b, r, 0:L-1] && _point_pair_rule(length lanes).
// Lanes are int32 holding the u32 key lanes XOR 0x80000000, so signed <
// is the reference's unsigned <.  rb, re [B, R, L]; hb, he [L, N] with a
// row stride (a window or hot-buffer view is taken as it lies); hver [N]
// and snap [B] int64; hit [B] int32, zeroed by the caller and OR-ed into.
//
// Predicate: when pred is not null, every block returns at once unless
// *pred == expected.  The caller launches the window check with
// (fast_ok, 1) and the full-ring check with (fast_ok, 0) into the same
// hit, so the reference's lax.cond stays on the device: no host sync per
// batch, and the branch not taken costs one near-empty launch.
//
// Bound on this card: operations.  Every (read, slot) pair needs at least
// a version compare and a lane compare: B * R * N pairs, 4.2 M for the
// 8192-slot window and 67 M for the full 1 << 17 ring at B = 64, R = 8,
// against 80 bytes a slot of ring (0.66 MB and 10.5 MB).
// Design: one block per (ring tile of 128 slots, chunk of 8 txns).  The
// tile's lanes are staged in shared memory, one column per thread (no
// bank conflicts), so a thread owns one slot; the chunk's read rows are
// staged beside it and read by all threads at once (broadcast).  A thread
// skips the lanes as soon as its slot is older than the snapshot or the
// first lane decides the order.  One __syncthreads_or per txn reduces the
// block and one atomicOr per txn and block writes the result.  The ring
// is read once per txn chunk (8 times at B = 64), from L2 after the first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;   // history slots per block (= threads)
constexpr int kTxns = 8;     // txns per block

// possibly_lt(a, b) with a a row of L lanes and b a shared-memory column
// (stride kTile), or the reverse when a_is_col.
__device__ __forceinline__ bool plt_row_col(const int* a, const int* b, int L,
                                            int w1) {
  for (int l = 0; l < L; ++l) {
    const int x = a[l], y = b[l * kTile];
    if (x < y) return true;
    if (x != y) return false;
  }
  return a[L - 1] == w1 && b[(L - 1) * kTile] == w1;
}

__device__ __forceinline__ bool plt_col_row(const int* a, const int* b, int L,
                                            int w1) {
  for (int l = 0; l < L; ++l) {
    const int x = a[l * kTile], y = b[l];
    if (x < y) return true;
    if (x != y) return false;
  }
  return a[(L - 1) * kTile] == w1 && b[L - 1] == w1;
}

template <bool kPoints>
__global__ void hist_check_kernel(
    const int* __restrict__ rb, const int* __restrict__ re,
    const int* __restrict__ hb, const int* __restrict__ he, long long hstride,
    const long long* __restrict__ hver, long long N,
    const long long* __restrict__ snap, int B, int R, int L, int w, int w1,
    int sentinel, const int* __restrict__ pred, int expected,
    int* __restrict__ hit) {
  if (pred != nullptr && *pred != expected) return;
  extern __shared__ int smem[];
  int* s_hb = smem;                          // [L][kTile]
  int* s_he = s_hb + L * kTile;              // [L][kTile] (interval path)
  int* s_rb = s_he + (kPoints ? 0 : L * kTile);   // [kTxns * R * L]
  int* s_re = s_rb + kTxns * R * L;          // [kTxns * R * L] (interval)

  const int tid = threadIdx.x;
  const long long slot = blockIdx.x * (long long)kTile + tid;
  const int b0 = blockIdx.y * kTxns;
  const int nb = min(kTxns, B - b0);
  const bool live = slot < N;
  long long v = 0;
  if (live) {
    v = hver[slot];
    for (int l = 0; l < L; ++l) {
      s_hb[l * kTile + tid] = hb[l * hstride + slot];
      if (!kPoints) s_he[l * kTile + tid] = he[l * hstride + slot];
    }
  }
  const int rows = nb * R * L;
  const long long base = (long long)b0 * R * L;
  for (int i = tid; i < rows; i += kTile) {
    s_rb[i] = rb[base + i];
    if (!kPoints) s_re[i] = re[base + i];
  }
  __syncthreads();

  const int* col_b = s_hb + tid;
  const int* col_e = s_he + tid;
  for (int t = 0; t < nb; ++t) {
    const int b = b0 + t;
    int mine = 0;
    if (live && v > snap[b]) {
      for (int r = 0; r < R && !mine; ++r) {
        const int* ab = s_rb + (t * R + r) * L;
        if (kPoints) {
          bool eq = true;
          for (int l = 0; l < L - 1 && eq; ++l) eq = ab[l] == col_b[l * kTile];
          const int la = ab[L - 1], lb = col_b[(L - 1) * kTile];
          const bool valid = la != sentinel && lb != sentinel;
          const bool edge = (la == w && lb == w1) || (la == w1 && lb == w);
          mine = eq && valid && (la == lb || edge);
        } else {
          const int* ae = s_re + (t * R + r) * L;
          mine = plt_row_col(ab, col_e, L, w1) && plt_col_row(col_b, ae, L, w1);
        }
      }
    }
    if (__syncthreads_or(mine) && tid == 0) atomicOr(hit + b, 1);
  }
}

}  // namespace

extern "C" int fdbt_hist_check(const void* rb, const void* re, const void* hb,
                               const void* he, long long hstride,
                               const void* hver, long long N, const void* snap,
                               int B, int R, int L, int w, int w1, int sentinel,
                               int points, const void* pred, int expected,
                               void* hit, void* stream) {
  if (N <= 0 || B <= 0) return 0;
  const size_t ring = (size_t)(points ? 1 : 2) * L * kTile;
  const size_t reads = (size_t)(points ? 1 : 2) * kTxns * R * L;
  const size_t smem = sizeof(int) * (ring + reads);
  dim3 grid((unsigned)((N + kTile - 1) / kTile), (unsigned)((B + kTxns - 1) / kTxns));
  cudaStream_t s = (cudaStream_t)stream;
  if (points) {
    hist_check_kernel<true><<<grid, kTile, smem, s>>>(
        (const int*)rb, (const int*)re, (const int*)hb, (const int*)he,
        hstride, (const long long*)hver, N, (const long long*)snap, B, R, L,
        w, w1, sentinel, (const int*)pred, expected, (int*)hit);
  } else {
    hist_check_kernel<false><<<grid, kTile, smem, s>>>(
        (const int*)rb, (const int*)re, (const int*)hb, (const int*)he,
        hstride, (const long long*)hver, N, (const long long*)snap, B, R, L,
        w, w1, sentinel, (const int*)pred, expected, (int*)hit);
  }
  return (int)cudaGetLastError();
}
