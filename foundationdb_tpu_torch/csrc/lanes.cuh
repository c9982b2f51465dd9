// The key-lane rules shared by K1 (commit_chain.cu) and K3 (hist_check.cu).
//
// A key is L int32 lanes holding the reference's u32 lanes XOR 0x80000000,
// so signed < is the reference's unsigned <; the last lane is the length
// lane (the truncation marker w1 = width + 1 when the key was cut).  Each
// rule reads its two operands with a lane stride of its own: 1 for a row
// of a batch's [B, R, L] ranges, the plane's row stride for a column of a
// history slab [L, N].

#pragma once

#include <cuda_pipeline.h>

namespace fdbt {

// The most ranges of a txn a kernel takes (a bit mask over them).
constexpr int kMaxRows = 32;

// The dynamic shared memory a block may opt into on sm_90 (227 KB).
constexpr int kSmemMax = 232448;

// One 4-byte copy from global to shared memory that does not wait
// (cp.async): a thread issues all its copies, then copy_wait() once, so
// their memory round trips overlap.  The data is the thread's own until a
// barrier.
__device__ __forceinline__ void copy_async(int* dst, const int* src) {
  __pipeline_memcpy_async(dst, src, sizeof(int));
}

__device__ __forceinline__ void copy_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// possibly_lt(a, b): lexicographic a < b over the L lanes, or all lanes
// equal and both length lanes the truncation marker.
__device__ __forceinline__ bool possibly_lt(const int* a, long long sa,
                                            const int* b, long long sb, int L,
                                            int w1) {
  for (int l = 0; l < L; ++l) {
    const int x = a[l * sa], y = b[l * sb];
    if (x < y) return true;
    if (x != y) return false;
  }
  return a[(L - 1) * sa] == w1 && b[(L - 1) * sb] == w1;
}

// The all-point rule (the reference's _point_pair_rule): equal data lanes,
// and equal length lanes or one exactly w and the other w1; sentinels
// never conflict.
__device__ __forceinline__ bool point_rule(const int* a, long long sa,
                                           const int* b, long long sb, int L,
                                           int w, int w1, int sentinel) {
  for (int l = 0; l < L - 1; ++l)
    if (a[l * sa] != b[l * sb]) return false;
  const int la = a[(L - 1) * sa], lb = b[(L - 1) * sb];
  if (la == sentinel || lb == sentinel) return false;
  return la == lb || (la == w && lb == w1) || (la == w1 && lb == w);
}

// A range row that overlaps nothing under either rule: for the point rule
// a sentinel length lane; for the interval rule an all-sentinel begin
// (nothing is greater than it, and its length lane is not w1).  Lanes at
// stride s.
__device__ __forceinline__ bool dead_row(const int* begin, long long s,
                                         int L, int sentinel, bool points) {
  if (points) return begin[(L - 1) * s] == sentinel;
  for (int l = 0; l < L; ++l)
    if (begin[l * s] != sentinel) return false;
  return true;
}

// A point key's data lanes (lane stride s) folded into 32 bits with bit 1
// set: equal keys, equal hashes.  A key with a sentinel length lane (a
// dead row or an unwritten slot) hashes to `dead` instead (0 or 1), so
// it never matches a live one, and a caller gives the two sides
// different `dead` values.  Only equal hashes go on to point_rule.
__device__ __forceinline__ unsigned point_hash(const int* key, long long s,
                                               int L, int sentinel,
                                               unsigned dead) {
  if (key[(L - 1) * s] == sentinel) return dead;
  unsigned h = 0x9E3779B9u;
  for (int l = 0; l < L - 1; ++l) {
    h = (h ^ (unsigned)key[l * s]) * 0x85EBCA6Bu;
    h ^= h >> 13;
  }
  return h | 2u;
}

// Rows past the last live one of a txn's R rows are skipped: the count
// of rows up to it, for rows at stride rs with lanes at stride s.
__device__ __forceinline__ int live_rows(const int* rows, long long rs,
                                         long long s, int R, int L,
                                         int sentinel, bool points) {
  int n = 0;
  for (int r = 0; r < R; ++r)
    if (!dead_row(rows + r * rs, s, L, sentinel, points)) n = r + 1;
  return n;
}

}  // namespace fdbt
