// K1 — exact-f32 1-NN over the whole reference cloud, in two modes that
// share one scan, so that they cannot drift apart:
//
// - payload mode (aicp_nn_payload), the ICP matcher: the squared distance
//   and the winner's payload row (point, normal, padding). Replaces
//   aicp_mapping_tpu/ops/knn.py:_nn_payload_split_kernel (wrapper
//   nn_payload_pallas_split).
// - index mode (aicp_nn_argmin): the squared distance and the winner's
//   index — ops.nn_argmin and the ICP monitor's Hausdorff distance.
//   Replaces aicp_mapping_tpu/ops/knn.py:_nn_kernel (wrapper
//   nn_argmin_pallas).
//
// The TPU kernels' bf16 3-way split, packed distance/column keys and
// one-hot matmul payload selection exist to feed the MXU, and so does their
// expanded distance |q|^2 - 2 q.r + |r|^2. On Hopper the distance is plain
// FP32 arithmetic on the CUDA cores, in difference form, exact to f32
// rounding (nn_dist below: dx*dx + dy*dy + dz*dz with the contraction nvcc
// gave it in the one-thread-per-query K1, pinned by intrinsics, so that the
// loop's shape cannot change its rounding; the distances are bit for bit
// those of that K1). No tensor cores: the expanded
// distance, the only form a matrix unit computes, picks another neighbour
// than the exact one for ~1% of lidar queries (ROADMAP Q3). The lowest
// index wins an exact tie, as torch.argmin does.
//
// Bound on the H100: FP32 issue rate — M * N distance evaluations of ~9
// instructions each (3 sub, mul, 2 fma, compare, 2 selects) on 132 SMs
// x 128 lanes (8192 x 8192 on the frame path, 1024 x 8192 in its coarse
// ICP iterations, 65,536 x 65,536 in the pair-registration CLI's Hausdorff
// check). Device memory traffic is small: each block reads its slice once.
//
// Design: two launches from one entry point.
// 1. The scan. A block of 128 threads holds 512 queries, 4 per thread
//    (register blocking: one shared-memory read of a reference feeds 4
//    independent compare chains), and scans one slice of the reference;
//    the grid is (query blocks) x (splits), cut by ops/knn.py:
//    nn_split_plan so that the coarse phase's 1,024 queries fill the card
//    too. The slice streams through shared memory in chunks of 256 float4
//    (x, y, z, 0; a masked reference at +inf), double-buffered: the next
//    chunk is loaded into registers while the current one is scanned (the
//    mask is applied on the way, so the copy goes through registers, not
//    cp.async). Each block writes, per query, its slice's first minimum as
//    a 64-bit key (common.cuh:nn_key).
// 2. The merge (common.cuh:merge_kernel): the least key over the splits,
//    then the distance and the winner's payload row or index.
#include "common.cuh"

namespace aicp {
namespace {

// References staged per pass: 4 KB a stage, two stages.
constexpr int kChunk = 256;

// Queries per thread (ops/knn.py:nn_split_plan gives this number).
constexpr int kQueries = 4;

// |q - r|^2, rounded as nvcc contracted dx*dx + dy*dy + dz*dz + w in the
// first K1: fma(dz, dz, fma(dx, dx, dy*dy)). The "+ w"
// is left out: it adds +0 for a valid reference, which changes no distance
// (every one is >= +0), and a masked one is staged at +inf instead of
// carrying kBig, so its distance is +inf (see load_chunk).
__device__ __forceinline__ float nn_dist(float qx, float qy, float qz,
                                         float4 v) {
  const float dx = __fsub_rn(qx, v.x);
  const float dy = __fsub_rn(qy, v.y);
  const float dz = __fsub_rn(qz, v.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

// References j of the chunk at `base` that thread t stages: t, t + 128.
// A masked reference, and a slot past the slice's end, is staged at
// (+inf, +inf, +inf): its distance is +inf and never replaces a first
// minimum, so the scan may run over whole groups of 4.
__device__ __forceinline__ void load_chunk(float4 (&next)[kChunk / kThreads],
                                           const float* r,
                                           const unsigned char* rmask,
                                           int base, int end) {
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int u = 0; u < kChunk / kThreads; ++u) {
    const int j = base + threadIdx.x + u * kThreads;
    next[u] = j < end && rmask[j]
                  ? make_float4(r[3 * j], r[3 * j + 1], r[3 * j + 2], 0.f)
                  : make_float4(inf, inf, inf, 0.f);
  }
}

template <int kQ>
__global__ void __launch_bounds__(kThreads, 4)
nn_scan_kernel(const float* __restrict__ q, int m,
               const float* __restrict__ r,
               const unsigned char* __restrict__ rmask, int n, int split_len,
               unsigned long long* __restrict__ keys) {
  __shared__ float4 tile[2][kChunk];
  const int first = blockIdx.x * (kThreads * kQ) + threadIdx.x;
  const int begin = blockIdx.y * split_len;
  const int end = min(n, begin + split_len);
  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int best_j[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = first + k * kThreads;
    qx[k] = i < m ? q[3 * i] : 0.f;
    qy[k] = i < m ? q[3 * i + 1] : 0.f;
    qz[k] = i < m ? q[3 * i + 2] : 0.f;
    // An all-masked slice leaves (+inf, its first index), and the merge
    // turns +inf into kBig: an all-masked reference gives kBig and index 0,
    // as argmin does.
    best[k] = __int_as_float(0x7f800000);
    best_j[k] = begin;
  }

  float4 next[kChunk / kThreads];
  load_chunk(next, r, rmask, begin, end);
  for (int base = begin, c = 0; base < end; base += kChunk, ++c) {
    // The stage written here was last read in iteration c - 2; every thread
    // has passed iteration c - 1's barrier since.
    float4* st = tile[c & 1];
#pragma unroll
    for (int u = 0; u < kChunk / kThreads; ++u)
      st[threadIdx.x + u * kThreads] = next[u];
    __syncthreads();
    if (base + kChunk < end) load_chunk(next, r, rmask, base + kChunk, end);
    const int len = min(kChunk, end - base);
#pragma unroll 2
    for (int t = 0; t < len; t += 4) {
      const float4 v[4] = {st[t], st[t + 1], st[t + 2], st[t + 3]};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = base + t + u;
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          const float d = nn_dist(qx[k], qy[k], qz[k], v[u]);
          if (d < best[k]) {
            best[k] = d;
            best_j[k] = j;
          }
        }
      }
    }
  }
  unsigned long long* out = keys + static_cast<size_t>(blockIdx.y) * m;
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = first + k * kThreads;
    if (i < m) out[i] = nn_key(best[k], best_j[k]);
  }
}

template <bool kPayload>
int launch(const float* q, const unsigned char* qmask, int m, const float* r,
           const unsigned char* rmask, int n, const float* pay, int p,
           int queries_per_thread, int splits, int split_len, void* keys_,
           float* dist_out, float* pay_out, long long* idx_out,
           void* stream_) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  auto* keys = static_cast<unsigned long long*>(keys_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (queries_per_thread != kQueries)
    return static_cast<int>(cudaErrorInvalidValue);
  const int block_q = kThreads * kQueries;
  const dim3 grid((m + block_q - 1) / block_q, splits);
  nn_scan_kernel<kQueries><<<grid, kThreads, 0, stream>>>(q, m, r, rmask, n,
                                                          split_len, keys);
  const int status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;
  return launch_merge<kPayload, false>(keys, splits, m, qmask, pay, p,
                                       dist_out, pay_out, idx_out, stream);
}

}  // namespace
}  // namespace aicp

// Both modes: queries (m, 3) f32, qmask (m,) bool, refs (n, 3) f32, rmask
// (n,) bool, n >= 1; the split plan (ops/knn.py:nn_split_plan):
// queries_per_thread 4, splits * split_len >= n with split_len % 4 == 0
// and no empty split; keys (splits, m) 64-bit scratch.

// Payload mode: payload (n, p) f32 -> dist_out (m,) f32, payload_out
// (m, p) f32.
extern "C" int aicp_nn_payload(const float* q, const unsigned char* qmask,
                               int m, const float* r,
                               const unsigned char* rmask, int n,
                               const float* pay, int p,
                               int queries_per_thread, int splits,
                               int split_len, void* keys, float* dist_out,
                               float* pay_out, void* stream) {
  return aicp::launch<true>(q, qmask, m, r, rmask, n, pay, p,
                            queries_per_thread, splits, split_len, keys,
                            dist_out, pay_out, nullptr, stream);
}

// Index mode: -> dist_out (m,) f32, idx_out (m,) int64.
extern "C" int aicp_nn_argmin(const float* q, const unsigned char* qmask,
                              int m, const float* r,
                              const unsigned char* rmask, int n,
                              int queries_per_thread, int splits,
                              int split_len, void* keys, float* dist_out,
                              long long* idx_out, void* stream) {
  return aicp::launch<false>(q, qmask, m, r, rmask, n, nullptr, 0,
                             queries_per_thread, splits, split_len, keys,
                             dist_out, nullptr, idx_out, stream);
}
