// K1 — exact-f32 1-NN over the whole reference cloud, in two modes that
// share one kernel template, so that they cannot drift apart:
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
// FP32 arithmetic on the CUDA cores, so this kernel computes it in
// difference form, exact to f32 rounding (common.cuh:sq_dist, the formula
// of the plain PyTorch twin ops/knn.py:nn_argmin), with no packed key;
// references are compared with a strict `<` in index order, so the lowest
// index wins an exact tie, as torch.argmin does. The payload row is copied
// from global memory once, after the scan.
//
// Bound on the H100: FP32 issue rate — M * N distance evaluations of 8
// FP32 operations each (8192 x 8192 on the frame path, 65,536 x 65,536 in
// the pair-registration CLI's Hausdorff check); the reference is read once
// per block through shared memory, so device-memory traffic is small.
// Design: one thread per query, the reference streamed through shared
// memory in tiles of 1024 float4 (x, y, z, 0 or kBig), read by all threads
// of a block as broadcasts. Occupancy is low at M = 8192 (64 blocks of 128
// threads); splitting the reference across blocks is later perf work.
#include "common.cuh"

namespace aicp {
namespace {

template <bool kPayload>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ q,
          const unsigned char* __restrict__ qmask, int m,
          const float* __restrict__ r,
          const unsigned char* __restrict__ rmask, int n,
          const float* __restrict__ pay, int p,
          float* __restrict__ dist_out, float* __restrict__ pay_out,
          long long* __restrict__ idx_out) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < m;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }

  // Any reference, even a masked one (kBig), replaces the initial +inf, so
  // an all-masked reference yields index 0 exactly as argmin does.
  float best = __int_as_float(0x7f800000);
  int best_j = 0;
  for (int base = 0; base < n; base += kTile) {
    const int len = min(kTile, n - base);
    stage_refs(tile, r, rmask, base, len);
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < len; ++t) {
      const float4 v = tile[t];
      const float d = sq_dist(qx, qy, qz, v);
      if (d < best) {
        best = d;
        best_j = base + t;
      }
    }
    __syncthreads();
  }
  if (!active) return;
  const bool valid = qmask[i] != 0;
  dist_out[i] = valid ? best : kBig;
  if constexpr (kPayload) {
    const float* src = pay + static_cast<size_t>(best_j) * p;
    float* dst = pay_out + static_cast<size_t>(i) * p;
    for (int c = 0; c < p; ++c) dst[c] = valid ? src[c] : 0.f;
  } else {
    idx_out[i] = valid ? best_j : 0;
  }
}

template <bool kPayload>
int launch(const float* q, const unsigned char* qmask, int m, const float* r,
           const unsigned char* rmask, int n, const float* pay, int p,
           float* dist_out, float* pay_out, long long* idx_out,
           void* stream) {
  if (m > 0) {
    const int blocks = (m + kThreads - 1) / kThreads;
    nn_kernel<kPayload><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        q, qmask, m, r, rmask, n, pay, p, dist_out, pay_out, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aicp

// queries (m, 3) f32, qmask (m,) bool, refs (n, 3) f32, rmask (n,) bool,
// payload (n, p) f32 -> dist_out (m,) f32, payload_out (m, p) f32. n >= 1.
extern "C" int aicp_nn_payload(const float* q, const unsigned char* qmask,
                               int m, const float* r,
                               const unsigned char* rmask, int n,
                               const float* pay, int p, float* dist_out,
                               float* pay_out, void* stream) {
  return aicp::launch<true>(q, qmask, m, r, rmask, n, pay, p, dist_out,
                            pay_out, nullptr, stream);
}

// queries (m, 3) f32, qmask (m,) bool, refs (n, 3) f32, rmask (n,) bool
// -> dist_out (m,) f32, idx_out (m,) int64. n >= 1.
extern "C" int aicp_nn_argmin(const float* q, const unsigned char* qmask,
                              int m, const float* r,
                              const unsigned char* rmask, int n,
                              float* dist_out, long long* idx_out,
                              void* stream) {
  return aicp::launch<false>(q, qmask, m, r, rmask, n, nullptr, 0, dist_out,
                             nullptr, idx_out, stream);
}
