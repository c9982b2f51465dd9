// K1 — the in-order commit chain of one resolve batch, for sm_90a.
//
// Replaces: foundationdb_tpu/ops/conflict_jax.py::_chain_kernel_call, the
// Pallas SMEM scalar loop that _batch_verdicts runs on every batch.
//
// Computes, for i = 0..B-1 in order, with committed-bitmask words cw[nw]:
//   hit    = OR_w (cw[w] & packed[i, w])
//   conf   = flags[i, 0] != 0 || hit != 0
//   commit = flags[i, 1] != 0 && !conf      ->  set bit i of cw
//   out[i] = conf
// packed [B, nw] int32 (bit j of row i: txn j's writes overlap txn i's
// reads), flags [B, 2] int32 (history conflict, valid & !too_old),
// out [B] int32.  nw = ceil(B / 32) <= 32.
//
// Bound on this card: B dependent steps.  Each step needs the previous
// step's cw, so the work is a chain of B short ALU + warp-vote latencies
// (tens of cycles each); the bytes (B * (nw + 3) * 4) are negligible.
// Design: one warp.  The rows are staged into shared memory once, lane w
// keeps word cw[w] in a register, and one __any_sync per step ORs the
// words' hits, so a step is a shared load, an AND, a vote and a select.
// Nothing is gained from more warps: the chain is sequential by nature.

#include <cuda_runtime.h>

namespace {

__global__ void commit_chain_kernel(const int* __restrict__ packed,
                                    const int* __restrict__ flags,
                                    int* __restrict__ out, int B, int nw) {
  extern __shared__ int smem[];
  int* s_packed = smem;            // [B * nw]
  int* s_flags = smem + B * nw;    // [B * 2]
  const int lane = threadIdx.x;
  for (int i = lane; i < B * nw; i += 32) s_packed[i] = packed[i];
  for (int i = lane; i < 2 * B; i += 32) s_flags[i] = flags[i];
  __syncwarp();
  unsigned cw = 0u;                // committed word `lane` (lane < nw)
  for (int i = 0; i < B; ++i) {
    unsigned h = lane < nw ? (cw & (unsigned)s_packed[i * nw + lane]) : 0u;
    const bool hit = __any_sync(0xffffffffu, h != 0u);
    const bool conf = s_flags[2 * i] != 0 || hit;
    const bool commit = s_flags[2 * i + 1] != 0 && !conf;
    if (commit && lane == (i >> 5)) cw |= 1u << (i & 31);
    if (lane == 0) out[i] = conf ? 1 : 0;
  }
}

}  // namespace

extern "C" int fdbt_commit_chain(const void* packed, const void* flags,
                                 void* out, int B, int nw, void* stream) {
  const size_t smem = sizeof(int) * ((size_t)B * nw + 2 * (size_t)B);
  commit_chain_kernel<<<1, 32, smem, (cudaStream_t)stream>>>(
      (const int*)packed, (const int*)flags, (int*)out, B, nw);
  return (int)cudaGetLastError();
}
