// K1 — the verdict step of one resolve batch, for sm_90a.
//
// Replaces: foundationdb_tpu/ops/conflict_jax.py::_chain_kernel_call, the
// Pallas SMEM scalar loop of the in-order commit chain, together with the
// XLA-compiled work around it in _batch_verdicts (the intra-batch overlap
// matrix, its bit pack, the verdict codes) and _slab_from_writes plus the
// hot-buffer updates of the scan body in resolve_many_core.
//
// Computes, for one batch of B txns with R ranges of L lanes each:
//   too_old = snap < *floor, valid = snap >= 0, ok = valid && !too_old;
//   M[i][j] = reads of i overlap writes of j (point or interval rule,
//             lanes.cuh), i != j;
//   for i = 0..B-1 in order:
//     conf[i]   = hit[i] != 0 || any committed j with M[i][j]
//     committed[i] = ok[i] && !conf[i]
//   verdicts = !valid ? COMMITTED 0 : too_old ? TOO_OLD 2 :
//              conf ? CONFLICT 1 : COMMITTED 0   (int8)
// and, when slab_b is not null, writes the slab of the batch: column
// b * R + r of slab_b / slab_e [L, B * R] (row stride slab_stride) holds
// write r of txn b if b committed and the row is not a sentinel, else
// the sentinel; slab_v [B * R] (when not null) gets the batch's version,
// *version_src when that is not null, else version.
//
// Bound on this card: latency.  The chain is B dependent steps (an AND,
// a compare and two selects in registers; chip_smoke.py measures the
// step); the bytes (the batch's rows in, the slab out: ~110 KB at B = 64,
// R = 8, L = 9) take 0.03 us at 3.35 TB/s, and the pair tests, at the
// one or two lanes most of them need, about as little at the card's
// int32 rate.
// Design: one block of 512 threads per batch, one launch (each step below
// measured on the H100 against a slower first version):
// - The batch's rows go into shared memory first by asynchronous copies
//   (cp.async), all in flight at once, while the flags are read: the
//   write rows row-major for the point rule, transposed ([R*L][B], lane j
//   of a warp reading txn j at address j) for the interval rule.  Reading
//   them from global memory, 288 bytes apart between lanes, took 0.14 ms.
// - Only the strictly lower triangle of M is built: the chain at step i
//   reads only bits j < i of the committed words.  Rows that are not ok
//   or already hit the history, and columns that cannot commit (not ok),
//   are skipped too, since their entries cannot change a result.  Rows
//   past a txn's last live read or write are never compared.
// - 16 warps build the matrix a word at a time: lane j holds column
//   32c + j; for the point rule it keeps txn j's write hashes (a 32-bit
//   hash of a row's data lanes, lanes.cuh) in registers, 8 at a time, and
//   tests them against each row's read hashes (a broadcast load), so only
//   equal hashes reach the full rule and no divergent lane loop runs
//   unless keys match; __ballot_sync packs each row's word.  The interval
//   rule walks the lanes (possibly_lt), and stays the slow case.
// - One warp runs the chain a word of 32 txns at a time: the committed
//   words below are final, so the lanes OR their txns' hits against them
//   in parallel; the word's 32 rows are gathered into registers by
//   shuffle, off the dependent path, and the 32 steps are register ALU
//   work (a vote per step took 50-85 ns a step).
// - All threads then write the verdicts, the committed flags and the
//   slab, a column per thread, coalesced along the slab's rows.
// Shared memory: the staged rows (3BRL words for points, 4BRL for
// intervals), B * ceil(B/32) + 2B + ceil(B/32) words, 2BR hashes
// (points) and B flag bytes: 60 KB / 75 KB at B = 64, R = 8, L = 9; the
// wrapper refuses a batch that does not fit in 227 KB.

#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

enum : unsigned char { kValid = 1, kTooOld = 2, kHist = 4, kConf = 8 };

template <bool kPoints>
__global__ void __launch_bounds__(kThreads) commit_chain_kernel(
    const int* __restrict__ rb, const int* __restrict__ re,
    const int* __restrict__ wb, const int* __restrict__ we,
    const int* __restrict__ hit, const long long* __restrict__ snap,
    const long long* __restrict__ floor_, int B, int R, int L, int w, int w1,
    int sentinel, signed char* __restrict__ verdicts,
    unsigned char* __restrict__ committed, int* __restrict__ slab_b,
    int* __restrict__ slab_e, long long slab_stride,
    long long* __restrict__ slab_v, long long version,
    const long long* __restrict__ version_src) {
  // shared: read begins [B*R*L] | write begins and ends [B*R*L] each,
  // row-major for points, transposed [R*L][B] for intervals | read ends
  // (intervals) | packed matrix [B*nw] | live reads, live writes [B] |
  // committed words [nw] | read and write hashes [B*R] each (points) |
  // flags [B] (bytes)
  extern __shared__ int smem[];
  const int nw = (B + 31) >> 5;
  const int RL = R * L, n = B * RL;
  int* s_rb = smem;
  int* s_wb = s_rb + n;
  int* s_we = s_wb + n;
  int* s_re = s_we + n;
  unsigned* s_packed = (unsigned*)(s_re + (kPoints ? 0 : n));
  int* s_rlive = (int*)(s_packed + B * nw);
  int* s_wlive = s_rlive + B;
  unsigned* s_cw = (unsigned*)(s_wlive + B);
  unsigned* s_rh = s_cw + nw;
  unsigned* s_wh = s_rh + (kPoints ? B * R : 0);
  unsigned char* s_flag = (unsigned char*)(s_wh + (kPoints ? B * R : 0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // write lane l of row q of txn j, and the strides of a write row
  const long long wrs = kPoints ? L : (long long)L * B, wls = kPoints ? 1 : B;
  auto wat = [&](int j, int q, int l) {
    return kPoints ? j * RL + q * L + l : (q * L + l) * B + j;
  };

  // 1. the batch's rows, by asynchronous copies (all in flight at once),
  // then per-txn flags, live-row counts and (points) row hashes
  for (int x = tid; x < n; x += kThreads) {
    const int j = x / RL, ql = x - j * RL;
    const int d = kPoints ? x : ql * B + j;
    fdbt::copy_async(s_rb + x, rb + x);
    fdbt::copy_async(s_wb + d, wb + x);
    fdbt::copy_async(s_we + d, we + x);
    if (!kPoints) fdbt::copy_async(s_re + x, re + x);
  }
  const long long f = *floor_;
  for (int b = tid; b < B; b += kThreads) {
    const long long sn = snap[b];
    s_flag[b] = (sn >= 0 ? kValid : 0) | (sn < f ? kTooOld : 0) |
                (hit[b] != 0 ? kHist : 0);
  }
  fdbt::copy_wait();
  __syncthreads();
  for (int b = tid; b < B; b += kThreads) {
    s_rlive[b] = fdbt::live_rows(s_rb + b * RL, L, 1, R, L, sentinel,
                                 kPoints);
    s_wlive[b] = fdbt::live_rows(s_wb + wat(b, 0, 0), wrs, wls, R, L,
                                 sentinel, kPoints);
  }
  if (kPoints) {
    for (int x = tid; x < B * R; x += kThreads) {
      s_rh[x] = fdbt::point_hash(s_rb + x * L, 1, L, sentinel, 0u);
      s_wh[(x % R) * B + x / R] =
          fdbt::point_hash(s_wb + x * L, 1, L, sentinel, 1u);
    }
  }
  __syncthreads();

  // 2. the overlap matrix, strictly lower triangle, packed by ballot:
  // row i needs the words that hold some j < i, and only if it can commit.
  // Word c of every row is built with lane j = 32c + lane holding txn
  // j's write hashes in registers (points), 8 at a time, so a compare is
  // a register test against a broadcast read hash.
  for (int x = tid; x < B * nw; x += kThreads) s_packed[x] = 0u;
  __syncthreads();
  for (int c = 0; c < nw; ++c) {
    const int j = c * 32 + lane;
    const bool col = j < B && (s_flag[j] & (kValid | kTooOld)) == kValid;
    const int nwj = col ? s_wlive[j] : 0;
    for (int q0 = 0; q0 < (kPoints ? R : 1); q0 += 8) {
      unsigned wh[8];
      if (kPoints) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          wh[k] = q0 + k < nwj ? s_wh[(q0 + k) * B + j] : 1u;
      }
      for (int i = warp; i < B; i += kWarps) {
        const unsigned char fi = s_flag[i];
        // warp-uniform: the row cannot commit, or word c holds no j < i
        if ((fi & (kValid | kTooOld | kHist)) != kValid || i <= c * 32)
          continue;
        const int nri = s_rlive[i];
        bool m = false;
        if (j < i && nwj > 0) {
          if (kPoints) {
            for (int r = 0; r < nri && !m; ++r) {
              const unsigned h = s_rh[i * R + r];
              unsigned mm = 0u;
#pragma unroll
              for (int k = 0; k < 8; ++k) mm |= (wh[k] == h ? 1u : 0u) << k;
              while (mm && !m) {
                const int k = __ffs(mm) - 1;
                m = fdbt::point_rule(s_rb + i * RL + r * L, 1,
                                     s_wb + wat(j, q0 + k, 0), 1, L, w, w1,
                                     sentinel);
                mm &= mm - 1;
              }
            }
          } else {
            for (int r = 0; r < nri && !m; ++r) {
              const int* ab = s_rb + i * RL + r * L;
              const int* ae = s_re + i * RL + r * L;
              for (int q = 0; q < nwj && !m; ++q)
                m = fdbt::possibly_lt(ab, 1, s_we + wat(j, q, 0), B, L,
                                      w1) &&
                    fdbt::possibly_lt(s_wb + wat(j, q, 0), B, ae, 1, L, w1);
            }
          }
        }
        const unsigned word = __ballot_sync(0xffffffffu, m);
        if (lane == 0) s_packed[i * nw + c] |= word;
      }
    }
  }
  __syncthreads();

  // 3. the in-order chain, one warp, a word of 32 txns at a time.  The
  // committed words below the current one are final, so each lane first
  // ORs its txn's hits against them; then the 32 steps within the word
  // run in registers, every lane the same, each taking its row's word
  // from the lane that holds it.
  if (warp == 0) {
    for (int c = 0; c < nw; ++c) {
      const int i = c * 32 + lane;
      const unsigned char fi = i < B ? s_flag[i] : 0;
      unsigned pre = 0u;
      for (int v = 0; v < c && i < B; ++v)
        pre |= s_cw[v] & s_packed[i * nw + v];
      const unsigned early = __ballot_sync(
          0xffffffffu, i < B && (pre != 0u || (fi & kHist)));
      const unsigned okm = __ballot_sync(
          0xffffffffu, (fi & (kValid | kTooOld)) == kValid);
      const unsigned pc = i < B ? s_packed[i * nw + c] : 0u;
      unsigned pk[32];               // the word's rows, off the chain
#pragma unroll
      for (int k = 0; k < 32; ++k) pk[k] = __shfl_sync(0xffffffffu, pc, k);
      unsigned cur = 0u, confm = 0u;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const unsigned bit = 1u << k;
        const unsigned conf =
            (early & bit) | ((cur & pk[k]) != 0u ? bit : 0u);
        confm |= conf;
        cur |= okm & bit & ~conf;
      }
      if (lane == 0) s_cw[c] = cur;
      if ((confm >> lane) & 1u) s_flag[i] = fi | kConf;
      __syncwarp();
    }
  }
  __syncthreads();

  // 4. verdicts, committed flags, the slab
  for (int b = tid; b < B; b += kThreads) {
    const unsigned char fb = s_flag[b];
    verdicts[b] = !(fb & kValid) ? 0 : (fb & kTooOld) ? 2 : (fb & kConf) ? 1 : 0;
    committed[b] = (fb & (kValid | kTooOld | kConf)) == kValid;
  }
  if (slab_b == nullptr) return;
  const int S = B * R;
  for (int col = tid; col < S; col += kThreads) {
    const int j = col / R, q = col - j * R;
    const bool ins = (s_flag[j] & (kValid | kTooOld | kConf)) == kValid &&
                     s_wb[wat(j, q, L - 1)] != sentinel;
    for (int l = 0; l < L; ++l) {
      slab_b[l * slab_stride + col] = ins ? s_wb[wat(j, q, l)] : sentinel;
      slab_e[l * slab_stride + col] = ins ? s_we[wat(j, q, l)] : sentinel;
    }
  }
  if (slab_v != nullptr) {
    const long long v = version_src != nullptr ? *version_src : version;
    for (int col = tid; col < S; col += kThreads) slab_v[col] = v;
  }
}

}  // namespace

extern "C" int fdbt_commit_chain(
    const void* rb, const void* re, const void* wb, const void* we,
    const void* hit, const void* snap, const void* floor_, int B, int R,
    int L, int w, int w1, int sentinel, int points, void* verdicts,
    void* committed, void* slab_b, void* slab_e, long long slab_stride,
    void* slab_v, long long version, const void* version_src, void* stream) {
  if (B <= 0) return 0;
  const int nw = (B + 31) / 32;
  const size_t n = (size_t)B * R * L;
  const size_t smem =
      sizeof(int) * ((points ? 3 : 4) * n + (size_t)B * nw + 2 * (size_t)B +
                     nw + (points ? 2 * (size_t)B * R : 0)) +
      (size_t)B;
  if (smem > 48 * 1024) {
    // once per kernel, for every size (a CUDA runtime call on every
    // launch cost host time in the resolver's loop)
    static bool opted[2] = {false, false};
    if (!opted[points]) {
      const cudaError_t e = cudaFuncSetAttribute(
          points ? commit_chain_kernel<true> : commit_chain_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, fdbt::kSmemMax);
      if (e != cudaSuccess) return (int)e;
      opted[points] = true;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (points)
    commit_chain_kernel<true><<<1, kThreads, smem, s>>>(
        (const int*)rb, (const int*)re, (const int*)wb, (const int*)we,
        (const int*)hit, (const long long*)snap, (const long long*)floor_, B,
        R, L, w, w1, sentinel, (signed char*)verdicts,
        (unsigned char*)committed, (int*)slab_b, (int*)slab_e, slab_stride,
        (long long*)slab_v, version, (const long long*)version_src);
  else
    commit_chain_kernel<false><<<1, kThreads, smem, s>>>(
        (const int*)rb, (const int*)re, (const int*)wb, (const int*)we,
        (const int*)hit, (const long long*)snap, (const long long*)floor_, B,
        R, L, w, w1, sentinel, (signed char*)verdicts,
        (unsigned char*)committed, (int*)slab_b, (int*)slab_e, slab_stride,
        (long long*)slab_v, version, (const long long*)version_src);
  return (int)cudaGetLastError();
}
