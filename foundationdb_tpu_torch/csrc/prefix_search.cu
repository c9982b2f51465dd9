// B8 — the storage read mirror's searchsorted pair over key prefixes, for
// sm_90a.
//
// Replaces: foundationdb_tpu/device/read_serve.py, the jitted
// jnp.searchsorted(pfx, probes, side="left") / side="right" pair of
// DeviceKeyDirectory.lookup (:113-115) and ShardedDeviceDirectory.lookup
// (:262-264), XLA-compiled on the TPU (no Pallas kernel there).
//
// Computes, for n probes q and N sorted prefixes pfx,
//   lo[i] = #{j : pfx[j] <  q[i]}   (searchsorted left)
//   hi[i] = #{j : pfx[j] <= q[i]}   (searchsorted right)
// All values are int64 holding the reference's u64 key prefixes (the first
// 8 key bytes, big-endian) with the sign bit flipped, so a signed compare
// here is the reference's unsigned one.
//
// Bound on this card: latency, not bytes.  A probe reads and writes 24
// bytes, but its left bound is ceil(log2 N) + 1 dependent loads, each a
// device-memory round trip once the search leaves the levels that stay in
// cache; at N = 2^24 that is 25 loads in a chain, against 0.01 us of bytes
// for 512 probes.
// Design: one thread per probe, all probes in flight at once.  The left
// bound is a branchless binary search with a fixed count of halving steps
// (ceil(log2 N)) and one last compare, so the threads of a warp step in
// lockstep whatever their data.  The right bound starts from the left one:
// the band of prefixes equal to the probe is empty or one wide for most
// keys, which one load settles; a wider band (keys that share their first
// 8 bytes) gallops 1, 2, 4, ... slots and then bisects inside the last
// step, so it costs the log of the band's width, not of N.  Loads go
// through the read-only data cache.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void prefix_search(const long long* __restrict__ pfx, long long N,
                              const long long* __restrict__ q, long long n,
                              long long* __restrict__ lo_out,
                              long long* __restrict__ hi_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long x = q[i];
  // left bound: the answer stays in [base, base + len]
  long long lo = 0;
  if (N > 0) {
    long long base = 0, len = N;
    while (len > 1) {
      const long long half = len >> 1;
      base = __ldg(pfx + base + half) < x ? base + half : base;
      len -= half;
    }
    lo = base + (__ldg(pfx + base) < x ? 1 : 0);
  }
  // right bound: the first slot at or after lo holding more than x
  long long hi = lo;
  if (lo < N && __ldg(pfx + lo) <= x) {
    long long b = lo, step = 1;           // pfx[b] <= x
    while (b + step < N && __ldg(pfx + b + step) <= x) {
      b += step;
      step <<= 1;
    }
    const long long e = b + step < N ? b + step : N;  // pfx[e] > x or e == N
    long long base = b + 1, len = e - base;           // answer in [base, e]
    if (len == 0) {
      hi = e;
    } else {
      while (len > 1) {
        const long long half = len >> 1;
        base = __ldg(pfx + base + half) <= x ? base + half : base;
        len -= half;
      }
      hi = base + (__ldg(pfx + base) <= x ? 1 : 0);
    }
  }
  lo_out[i] = lo;
  hi_out[i] = hi;
}

}  // namespace

extern "C" int fdbt_prefix_search(const void* pfx, long long N,
                                  const void* q, long long n, void* lo,
                                  void* hi, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  prefix_search<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)pfx, N, (const long long*)q, n, (long long*)lo,
      (long long*)hi);
  return (int)cudaGetLastError();
}
