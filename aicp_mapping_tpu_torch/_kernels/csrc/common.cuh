// Shared constants and pieces of the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>

namespace aicp {

// The JAX package's "no match / masked" sentinel (ops/knn.py _BIG_F): large
// enough that any real squared distance beats it, small enough that adding
// a lidar-scale |q|^2 to it stays finite (and rounds back to it exactly).
constexpr float kBig = 3.4e38f;

// Threads per block. The moment kernels (K2, K3) give each thread one
// query; the 1-NN scans (K1, K5) give each thread 1, 2 or 4 queries
// (register blocking) and cut the reference window of a block's queries
// into slices scanned by blocks of their own (the split plans beside the
// wrappers, ops/knn.py:nn_split_plan and ops/banded_nn.py:
// banded_split_plan, mirror this number).
constexpr int kThreads = 128;

// Reference points staged in shared memory per pass by K2 and K3, as
// float4 (x, y, z, 0 or kBig): 16 KB.
constexpr int kTile = 1024;

// Stage references [base, base + len) of (n, 3) `r` into `tile`. A valid
// reference becomes (x, y, z, 0), a masked one (0, 0, 0, kBig), so that
// sq_dist() of a masked reference is |q|^2 + kBig, which rounds to exactly
// kBig: it never beats a real reference and never passes a radius test.
__device__ __forceinline__ void stage_refs(float4* tile, const float* r,
                                           const unsigned char* rmask,
                                           int base, int len) {
  for (int t = threadIdx.x; t < len; t += blockDim.x) {
    const int j = base + t;
    tile[t] = rmask[j] ? make_float4(r[3 * j], r[3 * j + 1], r[3 * j + 2], 0.f)
                       : make_float4(0.f, 0.f, 0.f, kBig);
  }
}

// Squared distance in difference form, exact to f32 rounding. The TPU
// kernels (and the XLA fallbacks) expand |q|^2 - 2 q.r + |r|^2 to use the
// matrix unit; at 60 m lidar coordinates that expansion carries ~1e-3 m^2
// of rounding noise, enough that two implementations disagree on ~1% of
// nearest neighbours and on radius-boundary neighbours.
__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 v) {
  const float dx = qx - v.x, dy = qy - v.y, dz = qz - v.z;
  return dx * dx + dy * dy + dz * dz + v.w;
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
