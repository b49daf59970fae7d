// Shared constants and pieces of the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>

namespace aicp {

// The JAX package's "no match / masked" sentinel (ops/knn.py _BIG_F): large
// enough that any real squared distance beats it, small enough that adding
// a lidar-scale |q|^2 to it stays finite (and rounds back to it exactly).
constexpr float kBig = 3.4e38f;

// Threads per block. Every scan (K1, K2, K3, K5) gives each thread 1, 2 or
// 4 queries (register blocking) and cuts the reference window of a block's
// queries into slices scanned by blocks of their own (the split plans
// beside the wrappers, ops/knn.py:nn_split_plan, ops/banded_nn.py:
// banded_split_plan and ops/normals.py:moments_split_plan, mirror this
// number).
constexpr int kThreads = 128;

// |q - r|^2 in difference form, each operation rounded on its own, in the
// order of the plain twins (ops/knn.py:sq_dists): ((dx*dx + dy*dy) + dz*dz)
// with dx = qx - x. The intrinsics keep nvcc from contracting it into FMAs,
// so K2, K3 and K5 compute their twins' distances bit for bit (a radius
// test at the boundary, a tie, decides alike). The TPU kernels (and the XLA
// fallbacks) expand |q|^2 - 2 q.r + |r|^2 to use the matrix unit; at 60 m
// lidar coordinates that expansion carries ~1e-3 m^2 of rounding noise,
// enough that two implementations disagree on ~1% of nearest neighbours
// and on radius-boundary neighbours.
__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float x, float y, float z) {
  const float dx = __fsub_rn(qx, x);
  const float dy = __fsub_rn(qy, y);
  const float dz = __fsub_rn(qz, z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Asynchronous copies from device to shared memory (cp.async): K5 copies
// 16-byte pieces, K2 and K3 4-byte words (their points may lie at any
// 4-byte offset). A thread closes its copies into a group with
// cp_async_commit and waits for all of its groups with cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// --- The split 1-NN scans (K1, K5) -------------------------------------
//
// A scan block leaves, for each of its queries, the first minimum of its
// slice as one 64-bit key: the distance's bits above the reference index.
// Every distance is >= +0, so its bits order as unsigned integers; an
// equal distance then goes to the lower index, so the least key over the
// slices is the first minimum of the whole window, whatever the order in
// which the slices are taken. A K5 slice without a valid reference leaves
// (kBig, -1), above every real key.
namespace {

__device__ __forceinline__ unsigned long long nn_key(float d, int j) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned>(j);
}

// The merge pass of both scans: `lanes` threads per query (a power of two
// up to 32) take the least key over the `splits` slices, then write the
// distance and the winner's payload row or index.
// - K1 (kBanded false): a masked query gets kBig and a zero row or index 0;
//   otherwise the winner stands. K1 stages masked references at +inf, so
//   an all-masked reference leaves (+inf, 0): kBig and index 0, as argmin
//   over kBig-filled distances gives.
// - K5 (kBanded true): index -1 (no valid reference in the window) gives
//   kBig, a zero row or -1.
template <bool kPayload, bool kBanded>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const unsigned long long* __restrict__ keys, int splits, int m,
             int lanes, const unsigned char* __restrict__ qmask,
             const float* __restrict__ pay, int p,
             float* __restrict__ dist_out, float* __restrict__ pay_out,
             long long* __restrict__ idx_out) {
  const int i = blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  unsigned long long key = ~0ull;
  if (i < m) {
    for (int s = lane; s < splits; s += lanes)
      key = min(key, keys[static_cast<size_t>(s) * m + i]);
  }
  for (int o = lanes / 2; o > 0; o >>= 1)
    key = min(key, __shfl_xor_sync(0xffffffffu, key, o));
  if (i >= m) return;
  float d = __uint_as_float(static_cast<unsigned>(key >> 32));
  const int j = static_cast<int>(static_cast<unsigned>(key));
  bool found;
  long long idx;
  if constexpr (kBanded) {
    found = j >= 0;
    idx = j;
  } else {
    found = qmask[i] != 0;
    idx = found ? j : 0;
    if (!found || isinf(d)) d = kBig;
  }
  if constexpr (kPayload) {
    float* dst = pay_out + static_cast<size_t>(i) * p;
    const float* src = pay + static_cast<size_t>(found ? j : 0) * p;
    for (int c = lane; c < p; c += lanes) dst[c] = found ? src[c] : 0.f;
  } else {
    if (lane == 0) idx_out[i] = idx;
  }
  if (lane == 0) dist_out[i] = d;
}

// Launch the merge after a scan on `stream`; returns the launch status.
template <bool kPayload, bool kBanded>
int launch_merge(const unsigned long long* keys, int splits, int m,
                 const unsigned char* qmask, const float* pay, int p,
                 float* dist_out, float* pay_out, long long* idx_out,
                 cudaStream_t stream) {
  int lanes = 1;
  while (lanes < splits && lanes < 32) lanes <<= 1;
  const int per_block = kThreads / lanes;
  merge_kernel<kPayload, kBanded>
      <<<(m + per_block - 1) / per_block, kThreads, 0, stream>>>(
          keys, splits, m, lanes, qmask, pay, p, dist_out, pay_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aicp
