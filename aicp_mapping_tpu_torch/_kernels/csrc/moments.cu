// K2 and K3 — radius-neighbourhood moments for the hough prefilter.
//
// K2 replaces aicp_mapping_tpu/ops/normals.py:_banded_moments_split_kernel
// (wrapper sorted_radius_moments_split): on a Morton-sorted cloud, the
// queries of each tile of `tile_m` points scan only the `band` reference
// blocks of `tile_n` points that start at the tile's window start. The
// window starts are computed by the caller (ops/banded_nn.py:
// banded_window_starts) with the contract's tile_m = 512, tile_n = 1024,
// band = min(8, n / 1024): those numbers decide which neighbours count, so
// they are part of the semantics, not a tiling choice.
//
// K3 replaces aicp_mapping_tpu/ops/normals.py:_radius_moments_kernel
// (wrapper _radius_moments_pallas): the same sums with the window set to
// the whole cloud, for any n.
//
// Each query accumulates [Sx Sy Sz Sxx Syy Szz Sxy Sxz Syz cnt] over the
// valid references with |q - r|^2 <= r^2, the squared distance in the
// difference form of the plain PyTorch twins in ops/normals.py (see
// common.cuh:sq_dist for why not the expansion). The TPU kernels build the
// 0/1 weight tile in VMEM and contract it with a bf16-split feature matrix
// on the MXU; here the features are formed on the fly in f32 registers
// from coordinates read once from shared memory, so no split is needed.
//
// Bound on the H100: FP32 issue rate — n * window distance tests (16384 x
// 8192 for K2 in the main path, 4096^2 .. 8192^2 for K3), each ~7
// FP32 operations; neighbours are rare (~1% of the window), so the
// accumulation branch costs little. Design: one thread per query; a block
// of 128 threads lies inside one query tile (tile_m % 128 == 0), so it
// shares one window, staged through shared memory in 1024-point passes.
#include "common.cuh"

namespace aicp {
namespace {

__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ ps,
               const unsigned char* __restrict__ ms, int n,
               const int* __restrict__ starts, int tile_m, int tile_n,
               int window, float rad2, float* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int first = blockIdx.x * kThreads;
  const int i = first + threadIdx.x;
  const int begin = starts ? starts[first / tile_m] * tile_n : 0;
  const int end = min(begin + window, n);
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < n) {
    qx = ps[3 * i];
    qy = ps[3 * i + 1];
    qz = ps[3 * i + 2];
  }

  float s[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) s[k] = 0.f;
  for (int base = begin; base < end; base += kTile) {
    const int len = min(kTile, end - base);
    stage_refs(tile, ps, ms, base, len);
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < len; ++t) {
      const float4 v = tile[t];
      const float d = sq_dist(qx, qy, qz, v);
      if (d <= rad2) {
        s[0] += v.x;
        s[1] += v.y;
        s[2] += v.z;
        s[3] += v.x * v.x;
        s[4] += v.y * v.y;
        s[5] += v.z * v.z;
        s[6] += v.x * v.y;
        s[7] += v.x * v.z;
        s[8] += v.y * v.z;
        s[9] += 1.f;
      }
    }
    __syncthreads();
  }
  if (i >= n) return;
  float* o = out + static_cast<size_t>(i) * 10;
#pragma unroll
  for (int k = 0; k < 10; ++k) o[k] = s[k];
}

int launch(const float* ps, const unsigned char* ms, int n, const int* starts,
           int tile_m, int tile_n, int window, float rad2, float* out,
           void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    moments_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ps, ms, n, starts, tile_m, tile_n, window, rad2, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aicp

// K2. ps (n, 3) f32 Morton-sorted, ms (n,) bool, starts (n / tile_m,) int32
// window starts in reference blocks -> out (n, 10) f32.
// Requires n % tile_m == 0, n % tile_n == 0, tile_m % 128 == 0.
extern "C" int aicp_banded_moments(const float* ps, const unsigned char* ms,
                                   int n, const int* starts, int tile_m,
                                   int tile_n, int band, float rad2,
                                   float* out, void* stream) {
  return aicp::launch(ps, ms, n, starts, tile_m, tile_n, band * tile_n, rad2,
                      out, stream);
}

// K3. points (n, 3) f32, mask (n,) bool -> out (n, 10) f32, any n.
extern "C" int aicp_radius_moments(const float* ps, const unsigned char* ms,
                                   int n, float rad2, float* out,
                                   void* stream) {
  return aicp::launch(ps, ms, n, nullptr, 1, 0, n, rad2, out, stream);
}
