// Shared constants of the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>

namespace aicp {

// The JAX package's "no match / masked" sentinel (ops/knn.py _BIG_F): large
// enough that any real squared distance beats it, small enough that adding
// a lidar-scale |q|^2 to it stays finite (and rounds back to it exactly).
constexpr float kBig = 3.4e38f;

// Threads per block for the one-thread-per-query kernels.
constexpr int kThreads = 128;

// Reference points staged in shared memory per pass, as float4
// (x, y, z, 0 or kBig): 16 KB.
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

}  // namespace aicp
