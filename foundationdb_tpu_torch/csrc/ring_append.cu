// K2 — the conflict ring append of one lane plane, for sm_90a.
//
// Replaces: foundationdb_tpu/ops/conflict_jax.py::_ring_append_call, the
// Pallas shift-left-by-S + tail write with the operand aliased to the
// output (RESOLVER_RING_INPLACE).
//
// Computes out = [buf[:, S:] | slab] for buf, out [L, C] int32 and slab
// [L, S] int32 with row stride slab_stride.  On the resolver path the
// slab is a view into the hot staging buffer, taken as it lies: it starts
// one edge slot plus the window into each row, so neither its address nor
// its row stride need be a multiple of four slots.
//
// Bound on this card: bytes.  2 * L * C * 4 bytes move (read the kept
// part and the slab once, write the plane once), 9.4 MB at L = 9 and
// C = 1 << 17: 2.8 us at 3.35 TB/s.  There is no arithmetic to speak of.
// Design: an in-place left shift races across thread blocks (a block may
// overwrite slots another block has not read yet), so the caller keeps a
// ping-pong pair of planes and this kernel writes the other one: a
// straight copy, one grid row per lane.  Accesses are 4-byte, so a warp's
// loads and stores stay coalesced whatever the slab's alignment; each
// thread issues kPer independent loads before its stores, which keeps as
// many bytes in flight as one 16-byte access would.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;

__global__ void ring_append(const int* __restrict__ buf,
                            const int* __restrict__ slab,
                            int* __restrict__ out, long long C, long long S,
                            long long slab_stride) {
  const long long keep = C - S;
  const int* src = buf + blockIdx.y * C;
  const int* sl = slab + blockIdx.y * slab_stride;
  int* dst = out + blockIdx.y * C;
  const long long tile = (long long)kThreads * kPer;
  for (long long base = blockIdx.x * tile; base < C;
       base += (long long)gridDim.x * tile) {
    int v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long c = base + j * kThreads + threadIdx.x;
      if (c < C) v[j] = c < keep ? src[c + S] : sl[c - keep];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long c = base + j * kThreads + threadIdx.x;
      if (c < C) dst[c] = v[j];
    }
  }
}

}  // namespace

extern "C" int fdbt_ring_append(const void* buf, const void* slab, void* out,
                                int L, long long C, long long S,
                                long long slab_stride, void* stream) {
  long long blocks = (C + kThreads * kPer - 1) / (kThreads * kPer);
  if (blocks > 4096) blocks = 4096;
  dim3 grid((unsigned)blocks, (unsigned)L);
  ring_append<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)buf, (const int*)slab, (int*)out, C, S, slab_stride);
  return (int)cudaGetLastError();
}
