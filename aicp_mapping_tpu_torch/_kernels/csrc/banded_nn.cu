// K5 — Morton-banded 1-NN: the map-scale ICP matcher and the banded NN API,
// in two modes that share one scan, so that they cannot drift apart:
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
// bit-identical distances. No tensor cores: the expanded distance, the only
// form a matrix unit computes, would break that identity (and picks another
// neighbour than the exact one for ~1% of lidar queries, ROADMAP Q3).
// References are compared with a strict `<` in sorted order from +BIG, so
// the lowest sorted index wins a tie and a masked reference (penalty +BIG,
// which |q - r|^2 + BIG rounds back to) never wins: a query with no valid
// reference in its window gets +BIG and a zero payload (index -1).
//
// Bound on the H100: FP32 issue rate — M * band * tile_n distance
// evaluations of ~11 instructions each (3 sub, 3 mul, 2 add, compare, 2
// selects) on 132 SMs x 128 lanes: 8192 x 16 x 1024 and 8192 x 32 x 1024 in
// the fine ICP phase against 65,536- and 131,072-point crops, 1024 x 64 x
// 1024 and 1024 x 128 x 1024 in the coarse phase, whose band is the whole
// crop. Device memory traffic is small: each block reads its slice once.
//
// Design: two launches from one entry point.
// 1. The scan. A block of 128 threads holds 128 * Q queries, Q = 4 (2, 1)
//    per thread where the query tile allows (register blocking: one
//    shared-memory read of a reference feeds Q independent compare
//    chains), inside one query tile, so they share one window; the window
//    is cut into `splits` contiguous slices of `split_len` references (a
//    multiple of 4, so every slice starts 16-byte aligned), one block each:
//    the grid is (query blocks) x (splits), cut by ops/banded_nn.py:
//    banded_split_plan so that the coarse phase's 1,024 queries fill the
//    card too. The slice streams through two shared-memory stages of 256
//    references with cp.async (coordinates and penalties as 16-byte
//    pieces; once a chunk has landed, a masked reference's x becomes +inf):
//    chunk c + 1 is in flight while chunk c is scanned — the Hopper
//    counterpart of the TPU streaming kernel's two-slot manual DMA.
//    Each block writes, per query, its slice's first minimum as a 64-bit
//    key (common.cuh:nn_key), (kBig, -1) for none.
// 2. The merge (common.cuh:merge_kernel): the least key over the splits,
//    then the distance and the winner's payload row or sorted index.
#include "common.cuh"

namespace aicp {
namespace {

// References per shared-memory stage: 3 KB of coordinates and 1 KB of
// penalties; two stages.
constexpr int kChunk = 256;

// The distance is common.cuh:sq_dist, the twin's rounding. The twin adds
// the penalty last ("+ pen"); the kernel leaves that out: it adds +0 for a
// valid reference, which changes no distance (every one is >= +0), and a
// masked one has its x set to +inf in shared memory instead, so its
// distance is +inf, which never beats the initial kBig, as kBig itself
// never does in the twin.

// The window [begin, begin + width) of the query tile holding query
// `first`, clipped to [0, n).
__device__ __forceinline__ int window_begin(const int* starts, int first,
                                            int tile_m, int tile_n, int width,
                                            int n) {
  return max(0, min(starts[first / tile_m] * tile_n, n - width));
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
  for (int t = threadIdx.x; t < 3 * len / 4; t += kThreads)
    cp_async16(sx + t, gx + t);
  const float4* gp = reinterpret_cast<const float4*>(rpen + base);
  float4* sp = reinterpret_cast<float4*>(spen);
  for (int t = threadIdx.x; t < len / 4; t += kThreads)
    cp_async16(sp + t, gp + t);
  cp_async_commit();
}

template <int kQ>
__global__ void __launch_bounds__(kThreads, 4)
banded_scan_kernel(const float* __restrict__ q, int m,
                   const float* __restrict__ rs,
                   const float* __restrict__ rpen, int n,
                   const int* __restrict__ starts, int tile_m, int tile_n,
                   int band, int split_len,
                   unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) float sxyz[2][3 * kChunk];
  __shared__ __align__(16) float spen[2][kChunk];
  const int block_first = blockIdx.x * (kThreads * kQ);
  const int first = block_first + threadIdx.x;
  const int width = band * tile_n;
  const int window = window_begin(starts, block_first, tile_m, tile_n, width,
                                  n);
  const int begin = window + blockIdx.y * split_len;
  const int end = min(window + width, begin + split_len);
  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int best_j[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = first + k * kThreads;
    qx[k] = i < m ? q[3 * i] : 0.f;
    qy[k] = i < m ? q[3 * i + 1] : 0.f;
    qz[k] = i < m ? q[3 * i + 2] : 0.f;
    best[k] = kBig;
    best_j[k] = -1;
  }

  issue_chunk(sxyz[0], spen[0], rs, rpen, begin, min(kChunk, end - begin));
  for (int base = begin, c = 0; base < end; base += kChunk, ++c) {
    const int stage = c & 1;
    const int len = min(kChunk, end - base);  // a multiple of 4
    cp_async_wait_all();  // this thread's copies of chunk c have landed
    // ... and every other thread's; and every thread is done with chunk
    // c - 1, so its stage may be refilled
    __syncthreads();
    if (base + kChunk < end)
      issue_chunk(sxyz[stage ^ 1], spen[stage ^ 1], rs, rpen, base + kChunk,
                  min(kChunk, end - base - kChunk));
    for (int t = threadIdx.x; t < len; t += kThreads)
      if (spen[stage][t] != 0.f)
        sxyz[stage][3 * t] = __int_as_float(0x7f800000);
    __syncthreads();  // the masked references' x is +inf for every thread
    const float4* x4 = reinterpret_cast<const float4*>(sxyz[stage]);
#pragma unroll 2
    for (int t = 0; t < len; t += 4) {
      // references t .. t + 3: 12 coordinates
      const float4 a = x4[3 * t / 4], b = x4[3 * t / 4 + 1],
                   e = x4[3 * t / 4 + 2];
      const float rx[4] = {a.x, a.w, b.z, e.y};
      const float ry[4] = {a.y, b.x, b.w, e.z};
      const float rz[4] = {a.z, b.y, e.x, e.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = base + t + u;
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          const float d = sq_dist(qx[k], qy[k], qz[k], rx[u], ry[u], rz[u]);
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
int launch(const float* q, int m, const float* rs, const float* rpen, int n,
           const float* pay, int p, const int* starts, int tile_m,
           int tile_n, int band, int queries_per_thread, int splits,
           int split_len, void* keys_, float* dist_out, float* pay_out,
           long long* idx_out, void* stream_) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  auto* keys = static_cast<unsigned long long*>(keys_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const dim3 grid(m / (kThreads * queries_per_thread), splits);
  switch (queries_per_thread) {
    case 1:
      banded_scan_kernel<1><<<grid, kThreads, 0, stream>>>(
          q, m, rs, rpen, n, starts, tile_m, tile_n, band, split_len, keys);
      break;
    case 2:
      banded_scan_kernel<2><<<grid, kThreads, 0, stream>>>(
          q, m, rs, rpen, n, starts, tile_m, tile_n, band, split_len, keys);
      break;
    case 4:
      banded_scan_kernel<4><<<grid, kThreads, 0, stream>>>(
          q, m, rs, rpen, n, starts, tile_m, tile_n, band, split_len, keys);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;
  return launch_merge<kPayload, true>(keys, splits, m, nullptr, pay, p,
                                      dist_out, pay_out, idx_out, stream);
}

}  // namespace
}  // namespace aicp

// K5, both modes: q (m, 3) f32 sorted queries, rs (n, 3) f32 sorted
// references, rpen (n,) f32 0 or +BIG, starts (m / tile_m,) int32 window
// starts in blocks of tile_n. Requires m % tile_m == 0, n % tile_n == 0,
// tile_n % 4 == 0, 1 <= band <= n / tile_n, and rs, rpen 16-byte aligned
// (cp.async copies 16-byte pieces); the split plan (ops/banded_nn.py:
// banded_split_plan): queries_per_thread 1, 2 or 4 with tile_m % (128 *
// queries_per_thread) == 0, splits * split_len >= band * tile_n with
// split_len % 4 == 0 and no empty split; keys (splits, m) 64-bit scratch.

// Payload mode: pay (n, p) f32 sorted payload -> dist_out (m,), pay_out
// (m, p).
extern "C" int aicp_banded_nn_payload_stream(
    const float* q, int m, const float* rs, const float* rpen, int n,
    const float* pay, int p, const int* starts, int tile_m, int tile_n,
    int band, int queries_per_thread, int splits, int split_len, void* keys,
    float* dist_out, float* pay_out, void* stream) {
  return aicp::launch<true>(q, m, rs, rpen, n, pay, p, starts, tile_m, tile_n,
                            band, queries_per_thread, splits, split_len, keys,
                            dist_out, pay_out, nullptr, stream);
}

// Index mode: -> dist_out (m,), idx_out (m,) int64 sorted index, -1 where
// the window holds no valid reference.
extern "C" int aicp_banded_nn_argmin(const float* q, int m, const float* rs,
                                     const float* rpen, int n,
                                     const int* starts, int tile_m,
                                     int tile_n, int band,
                                     int queries_per_thread, int splits,
                                     int split_len, void* keys,
                                     float* dist_out, long long* idx_out,
                                     void* stream) {
  return aicp::launch<false>(q, m, rs, rpen, n, nullptr, 0, starts, tile_m,
                             tile_n, band, queries_per_thread, splits,
                             split_len, keys, dist_out, nullptr, idx_out,
                             stream);
}
