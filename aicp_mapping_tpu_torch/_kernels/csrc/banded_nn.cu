// K5 — Morton-banded 1-NN: the map-scale ICP matcher and the banded NN API,
// in two modes that share one kernel template, so that they cannot drift
// apart:
//
// - payload mode (aicp_banded_nn_payload_stream): the squared distance and
//   the winner's payload row. Replaces every banded payload kernel of
//   aicp_mapping_tpu/ops/banded_nn.py: the bf16 split kernels
//   _banded_payload_split_kernel (wrapper nn_payload_banded_resident_split,
//   reference resident in VMEM up to 64 blocks) and
//   _banded_payload_split_stream_kernel (nn_payload_banded_stream_split,
//   above 64 blocks), and the f32 ones _banded_payload_kernel
//   (nn_payload_banded_sorted, scalar-prefetched window) and
//   _banded_payload_kernel_v2 (nn_payload_banded_resident, reference in
//   block layout). Residency in VMEM and scalar prefetch are the TPU's
//   concern; here one kernel serves any band and layout.
// - index mode (aicp_banded_nn_argmin): the squared distance and the sorted
//   index of the winner, -1 when the window holds no valid reference.
//   Replaces _banded_kernel (wrapper nn_argmin_banded_prepared).
// Both clouds are Morton-sorted by the caller (ops/banded_nn.py); the queries
// of each tile of `tile_m` scan only the `band` reference blocks of `tile_n`
// points that start at the tile's window start (banded_window_starts), and
// return the squared distance to the nearest valid reference in the window
// and that reference's payload row.
//
// The TPU kernels feed the MXU: bf16 3-way split coordinates, an expanded
// distance |q|^2 - 2 q.r + |r|^2, packed distance/column keys and a one-hot
// payload matmul. Here the distance is exact f32 in difference form on the
// CUDA cores, every operation rounded on its own (no FMA contraction), so K5
// and the plain PyTorch twin (ops/banded_nn.py:nn_payload_banded) compute
// bit-identical distances. References are compared with a strict `<` in
// sorted order from +BIG, so the lowest sorted index wins a tie and a masked
// reference (penalty +BIG, which |q - r|^2 + BIG rounds back to) never wins:
// a query with no valid reference in its window gets +BIG and a zero payload.
// The winner's payload row is copied from global memory once, after the scan.
//
// Bound on the H100: FP32 issue rate — M * band * tile_n distance
// evaluations (8192 x 16 x 1024 and 8192 x 32 x 1024 in the fine ICP phase
// against 65,536- and 131,072-point crops), ~9 FP32 operations each; the
// window is read once per block through shared memory. Design: one thread
// per query; a block of 128 threads lies inside one query tile
// (tile_m % 128 == 0), so it shares one window. The window's 1024-point
// chunks are double-buffered through two shared-memory stages with
// cp.async: chunk c + 1 is in flight while chunk c is scanned — the Hopper
// counterpart of the TPU streaming kernel's two-slot manual DMA. It takes a
// band as wide as the whole reference (the coarse ICP phase does). The
// overlap pays on the H100: loading each chunk before scanning it took
// ~25% longer at every band from 8 to 128 blocks.
// Occupancy is low (M / 128 blocks: 64 at M = 8192, 8 at M = 1024); splitting
// the window across blocks with a second reduction pass is later perf work.
#include "common.cuh"

namespace aicp {
namespace {

// |q - r|^2 + pen, each operation rounded on its own, in the order of the
// plain twin: ((dx*dx + dy*dy) + dz*dz) + pen.
__device__ __forceinline__ float banded_dist(float qx, float qy, float qz,
                                             float x, float y, float z,
                                             float pen) {
  const float dx = __fsub_rn(qx, x);
  const float dy = __fsub_rn(qy, y);
  const float dz = __fsub_rn(qz, z);
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz)),
                   pen);
}

// The window [begin, end) of the block's query tile, clipped to [0, n).
__device__ __forceinline__ int window_begin(const int* starts, int first,
                                            int tile_m, int tile_n, int width,
                                            int n) {
  return max(0, min(starts[first / tile_m] * tile_n, n - width));
}

// The epilogue: the distance, and the winner's payload row (a zero row for
// no winner) or its sorted index (-1 for none).
template <bool kPayload>
__device__ __forceinline__ void write_result(int i, int m, float best,
                                             int best_j, const float* pay,
                                             int p, float* dist_out,
                                             float* pay_out,
                                             long long* idx_out) {
  if (i >= m) return;
  dist_out[i] = best;
  if constexpr (kPayload) {
    float* dst = pay_out + static_cast<size_t>(i) * p;
    if (best_j < 0) {
      for (int c = 0; c < p; ++c) dst[c] = 0.f;
      return;
    }
    const float* src = pay + static_cast<size_t>(best_j) * p;
    for (int c = 0; c < p; ++c) dst[c] = src[c];
  } else {
    idx_out[i] = best_j;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start the copies of references [base, base + len) into one stage — the
// coordinates (3 * len floats) and the penalties (len floats) as 16-byte
// pieces — and close them as one cp.async group. base % 4 == 0 and
// len % 4 == 0 keep every piece 16-byte aligned in both memories.
__device__ __forceinline__ void issue_chunk(float* sxyz, float* spen,
                                            const float* rs, const float* rpen,
                                            int base, int len) {
  const float4* gx = reinterpret_cast<const float4*>(
      rs + 3 * static_cast<size_t>(base));
  float4* sx = reinterpret_cast<float4*>(sxyz);
  for (int t = threadIdx.x; t < 3 * len / 4; t += blockDim.x)
    cp_async16(sx + t, gx + t);
  const float4* gp = reinterpret_cast<const float4*>(rpen + base);
  float4* sp = reinterpret_cast<float4*>(spen);
  for (int t = threadIdx.x; t < len / 4; t += blockDim.x)
    cp_async16(sp + t, gp + t);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool kPayload>
__global__ void __launch_bounds__(kThreads)
banded_stream_kernel(const float* __restrict__ q, int m,
                     const float* __restrict__ rs,
                     const float* __restrict__ rpen, int n,
                     const float* __restrict__ pay, int p,
                     const int* __restrict__ starts, int tile_m, int tile_n,
                     int band, float* __restrict__ dist_out,
                     float* __restrict__ pay_out,
                     long long* __restrict__ idx_out) {
  // two stages of one 1024-point chunk each: 2 x (12 KB + 4 KB)
  __shared__ __align__(16) float sxyz[2][3 * kTile];
  __shared__ __align__(16) float spen[2][kTile];
  const int first = blockIdx.x * kThreads;
  const int i = first + threadIdx.x;
  const int width = band * tile_n;
  const int begin = window_begin(starts, first, tile_m, tile_n, width, n);
  const int end = begin + width;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < m) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }

  float best = kBig;
  int best_j = -1;
  const int n_chunks = (width + kTile - 1) / kTile;
  issue_chunk(sxyz[0], spen[0], rs, rpen, begin, min(kTile, width));
  for (int c = 0; c < n_chunks; ++c) {
    const int base = begin + c * kTile;
    const int len = min(kTile, end - base);
    const int stage = c & 1;
    if (c + 1 < n_chunks) {
      // The other stage was last read in iteration c - 1, whose closing
      // __syncthreads() every thread has passed: safe to overwrite.
      const int next = base + kTile;
      issue_chunk(sxyz[stage ^ 1], spen[stage ^ 1], rs, rpen, next,
                  min(kTile, end - next));
      cp_async_wait<1>();  // this thread's copies of chunk c have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... and every other thread's
    const float* x = sxyz[stage];
    const float* w = spen[stage];
#pragma unroll 8
    for (int t = 0; t < len; ++t) {
      const float d =
          banded_dist(qx, qy, qz, x[3 * t], x[3 * t + 1], x[3 * t + 2], w[t]);
      if (d < best) {
        best = d;
        best_j = base + t;
      }
    }
    __syncthreads();  // stage read by all before it is refilled
  }
  write_result<kPayload>(i, m, best, best_j, pay, p, dist_out, pay_out,
                         idx_out);
}

template <bool kPayload>
int launch(const float* q, int m, const float* rs, const float* rpen, int n,
           const float* pay, int p, const int* starts, int tile_m,
           int tile_n, int band, float* dist_out, float* pay_out,
           long long* idx_out, void* stream) {
  if (m > 0) {
    const int blocks = (m + kThreads - 1) / kThreads;
    banded_stream_kernel<kPayload><<<blocks, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        q, m, rs, rpen, n, pay, p, starts, tile_m, tile_n, band, dist_out,
        pay_out, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aicp

// K5, both modes: q (m, 3) f32 sorted queries, rs (n, 3) f32 sorted
// references, rpen (n,) f32 0 or +BIG, starts (m / tile_m,) int32 window
// starts in blocks of tile_n. Requires m % tile_m == 0, tile_m % 128 == 0,
// n % tile_n == 0, tile_n % 4 == 0, 1 <= band <= n / tile_n, and rs, rpen
// 16-byte aligned (cp.async copies 16-byte pieces).

// Payload mode: pay (n, p) f32 sorted payload -> dist_out (m,), pay_out
// (m, p).
extern "C" int aicp_banded_nn_payload_stream(
    const float* q, int m, const float* rs, const float* rpen, int n,
    const float* pay, int p, const int* starts, int tile_m, int tile_n,
    int band, float* dist_out, float* pay_out, void* stream) {
  return aicp::launch<true>(q, m, rs, rpen, n, pay, p, starts, tile_m, tile_n,
                            band, dist_out, pay_out, nullptr, stream);
}

// Index mode: -> dist_out (m,), idx_out (m,) int64 sorted index, -1 where
// the window holds no valid reference.
extern "C" int aicp_banded_nn_argmin(const float* q, int m, const float* rs,
                                     const float* rpen, int n,
                                     const int* starts, int tile_m,
                                     int tile_n, int band, float* dist_out,
                                     long long* idx_out, void* stream) {
  return aicp::launch<false>(q, m, rs, rpen, n, nullptr, 0, starts, tile_m,
                             tile_n, band, dist_out, nullptr, idx_out,
                             stream);
}
