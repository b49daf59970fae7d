// K2 and K3 — radius-neighbourhood moments for the hough prefilter.
//
// K2 replaces aicp_mapping_tpu/ops/normals.py:_banded_moments_split_kernel
// (wrapper sorted_radius_moments_split) and _banded_moments_kernel
// (sorted_radius_moments): on a Morton-sorted cloud, the queries of each
// tile of `tile_m` points scan only the `band` reference blocks of `tile_n`
// points that start at the tile's window start, by the rule of
// ops/banded_nn.py:banded_window_starts, with the contract's tile_m = 512,
// tile_n = 1024, band = min(8, n / 1024): those numbers decide which
// neighbours count, so they are part of the semantics, not a tiling
// choice. Each block finds its tile's window start itself (window_start
// below), in place of a dozen small launches of the plain rule.
//
// K3 replaces aicp_mapping_tpu/ops/normals.py:_radius_moments_kernel
// (wrapper _radius_moments_pallas): the same sums with the window set to
// the whole cloud, for any n.
//
// Each query gets [Sx Sy Sz Sxx Syy Szz Sxy Sxz Syz cnt] over the valid
// references with |q - r|^2 <= r^2, the distance rounded as the plain twins
// round it (common.cuh:sq_dist), so the neighbour counts are the twins'.
// The TPU kernels build the 0/1 weight tile in VMEM and contract it with a
// bf16-split feature matrix on the MXU; here the features of a neighbour
// are formed on the fly from coordinates read once from shared memory.
// They are summed in f64, where the products of f32 coordinates are exact,
// and rounded to f32 once, at the end: the twin sums the same features in
// f64 (ops/normals.py:_window_moments), so the two differ only where
// another f64 summation order moves the sum across an f32 rounding
// boundary.
//
// Bound on the H100: the FP32 issue rate — n * window distance tests
// (16,384 x 8,192 for K2 in the main path, 262,144 x 8,192 at a map load,
// 4,096^2 .. 8,192^2 for K3), each ~9 instructions (3 sub, 3 mul, 2 add,
// compare) on 132 SMs x 128 lanes. Neighbours are rare (0.3-1.2% of the
// window at 0.4 m), so the f64 sums, which issue at half the FP32 rate,
// cost little as long as they stay off the path of the radius tests: a
// branch per pair, even one rarely taken, kept a first version of this
// scan at 3-4x its issue-rate floor. Device memory traffic is small: each
// block reads its share of the window once.
//
// Design: two launches from one entry point, as in the 1-NN scans.
// 1. The scan. A block of 128 threads holds 128 * Q queries, Q = 4 (2, 1)
//    per thread where the query tile allows (register blocking: one
//    shared-memory read of a reference feeds Q independent tests; query k
//    of thread t is t + 128 k, so a warp holds Q runs of 32 consecutive,
//    nearby queries), inside one query tile, so they share one window. The
//    window is dealt to `splits` blocks in pieces of 16 references,
//    round-robin: the grid is (query blocks) x (splits), one wave of the
//    card, from ops/normals.py:moments_split_plan, so that 4,096 queries
//    fill the card too and no block gets more than its share of the
//    neighbours. A block streams its pieces through two shared-memory
//    stages of 256 references with cp.async (4-byte words); the mask bytes
//    of the next stage are read into registers meanwhile, and once a stage
//    has landed a masked reference's x (and a slot past the window) becomes
//    +inf, so its distance is +inf or NaN and fails the test, and the valid
//    references' coordinates are copied to an f64 stage for the sums. For
//    each reference a thread tests its Q queries; the warp votes once
//    whether any of its queries is a neighbour, and only then, once per run
//    of 32 queries that one is a neighbour in, adds the reference to those
//    queries' f64 sums (branches the warp takes as one, the sums
//    branch-free). Each block writes its 10 partial sums per query to a
//    scratch buffer.
// 2. The merge: each of the n * 10 sums is the blocks' partial sums added
//    in block order, then rounded to f32 — the same result on every run,
//    with no atomics.
#include "common.cuh"

namespace aicp {
namespace {

// References per shared-memory stage: 3 KB of f32 coordinates and 6 KB of
// f64 ones; two stages.
constexpr int kChunk = 256;
// The window is dealt to the blocks of a query block in pieces of this
// many references, round-robin: piece g to block g % splits. Neighbours
// sit in a narrow part of a Morton-sorted window, and contiguous slices
// left a few blocks with many times the mean's share of neighbour sums.
constexpr int kPiece = 16;
constexpr int kPieces = kChunk / kPiece;  // pieces per stage
// Stage slots per thread (the mask bytes it reads and applies).
constexpr int kSlots = kChunk / kThreads;
// The Morton code of an invalid point (ops/banded_nn.py:SENTINEL).
constexpr long long kSentinel = 2147483647LL;

// The first i in [0, n) with codes[i] >= key (n if none) in the sorted
// codes: torch.searchsorted(codes, key). One warp, 32 probes a round.
__device__ __forceinline__ int lower_bound(const long long* codes, int n,
                                          long long key) {
  const int lane = threadIdx.x % 32;
  int a = 0, b = n;  // the answer lies in [a, b]
  while (a < b) {
    const int probe = a + static_cast<int>(
        static_cast<long long>(b - a) * (lane + 1) / 33);
    // the probes ascend with the lane, so the lanes below key are a prefix
    const int k = __popc(__ballot_sync(0xffffffffu, codes[probe] < key));
    const int below = __shfl_sync(0xffffffffu, probe, max(k - 1, 0));
    const int above = __shfl_sync(0xffffffffu, probe, min(k, 31));
    a = k == 0 ? a : below + 1;
    b = k == 32 ? b : above;
  }
  return a;
}

// The window start, in blocks of tile_n, of query tile `tile` of the
// sorted cloud against itself, as ops/banded_nn.py:banded_window_starts
// computes it: the tile's least code and its greatest valid one (or the
// least, if the tile holds no valid point) bracketed in the codes, the
// midpoint's block less band / 2, clipped into [0, n / tile_n - band].
// Called by every thread of the block.
__device__ int window_start(const long long* __restrict__ codes, int n,
                            int tile, int tile_m, int tile_n, int band) {
  __shared__ long long lo_hi[2][kThreads / 32];
  __shared__ int pos[2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  long long lo = kSentinel, hi = -1;
  for (int i = threadIdx.x; i < tile_m; i += kThreads) {
    const long long v = codes[static_cast<size_t>(tile) * tile_m + i];
    lo = min(lo, v);
    if (v != kSentinel) hi = max(hi, v);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    lo_hi[0][warp] = lo;
    lo_hi[1][warp] = hi;
  }
  __syncthreads();
  for (int w = 0; w < kThreads / 32; ++w) {
    lo = min(lo, lo_hi[0][w]);
    hi = max(hi, lo_hi[1][w]);
  }
  hi = max(hi, lo);
  // warp 0 the first code >= lo, warp 1 the first code > hi
  if (warp < 2) {
    const int at = lower_bound(codes, n, warp == 0 ? lo : hi + 1);
    if (lane == 0) pos[warp] = at;
  }
  __syncthreads();
  const int center = (pos[0] + pos[1]) / (2 * tile_n);
  return max(0, min(center - band / 2, max(n / tile_n - band, 0)));
}

// The pieces of one block: piece q of the block (q = 0, 1, ...) is piece
// `first + q * splits` of the window [begin, end), which holds `pieces`.
struct Pieces {
  int begin, end, pieces, first, splits;
  // the reference in slot t of the stage that holds the block's pieces
  // q0 .., or -1 past the window
  __device__ __forceinline__ int ref(int q0, int t) const {
    const int g = first + (q0 + t / kPiece) * splits;
    const int j = begin + g * kPiece + t % kPiece;
    return g < pieces && j < end ? j : -1;
  }
};

// Start the copies of the coordinates of the references of one stage (the
// block's pieces q0 .., `len` slots), word by word, and close them as one
// cp.async group.
__device__ __forceinline__ void issue_chunk(float* sxyz, const float* ps,
                                            const Pieces& w, int q0,
                                            int len) {
  for (int v = threadIdx.x; v < 3 * len; v += kThreads) {
    const int j = w.ref(q0, v / 3);
    if (j >= 0) cp_async4(sxyz + v, ps + 3 * static_cast<size_t>(j) + v % 3);
  }
  cp_async_commit();
}

// Whether each of this thread's slots of the stage holds a valid
// reference (a slot past the window or past `len` does not).
__device__ __forceinline__ void load_mask(bool (&live)[kSlots],
                                          const unsigned char* ms,
                                          const Pieces& w, int q0, int len) {
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const int t = threadIdx.x + u * kThreads;
    const int j = t < len ? w.ref(q0, t) : -1;
    live[u] = j >= 0 && ms[j] != 0;
  }
}

// Add a reference's features to a query's sums if it is a neighbour
// (`near`), branch-free: otherwise every term is +0 or -0, which leaves a
// sum as it was (no sum is ever -0). A product of two f32 values is exact
// in f64, so whether nvcc contracts `s += a * x` into an FMA changes no
// bit.
__device__ __forceinline__ void accumulate(double (&s)[9], int& cnt,
                                           bool near, double x, double y,
                                           double z) {
  const double a = near ? x : 0.0, b = near ? y : 0.0, c = near ? z : 0.0;
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += a * x;
  s[4] += b * y;
  s[5] += c * z;
  s[6] += a * y;
  s[7] += a * z;
  s[8] += b * z;
  cnt += near;
}

template <int kQ>
__global__ void __launch_bounds__(kThreads, 4)
moments_scan_kernel(const float* __restrict__ ps,
                    const unsigned char* __restrict__ ms, int n,
                    const long long* __restrict__ codes, int tile_m,
                    int tile_n, int band, int width, float rad2,
                    double* __restrict__ part) {
  __shared__ __align__(16) float sxyz[2][3 * kChunk];
  __shared__ double sd[2][3 * kChunk];
  const int block_first = blockIdx.x * (kThreads * kQ);
  // query k of a thread is first + k * kThreads: a warp holds kQ runs of
  // 32 consecutive (Morton-sorted: nearby) queries
  const int first = block_first + threadIdx.x;
  const int window =
      codes ? window_start(codes, n, block_first / tile_m, tile_m, tile_n,
                           band) * tile_n
            : 0;
  const int splits = gridDim.y;
  const int pieces = (width + kPiece - 1) / kPiece;
  const Pieces w{window, min(window + width, n), pieces,
                 static_cast<int>(blockIdx.y), splits};
  // this block's pieces, and the stage slots they fill at stage q0
  const int mine = (pieces - w.first + splits - 1) / splits;
  auto slots = [&](int q0) { return min(kPieces, mine - q0) * kPiece; };
  float qx[kQ], qy[kQ], qz[kQ];
  double s[kQ][9];
  int cnt[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = first + k * kThreads;
    qx[k] = i < n ? ps[3 * i] : 0.f;
    qy[k] = i < n ? ps[3 * i + 1] : 0.f;
    qz[k] = i < n ? ps[3 * i + 2] : 0.f;
#pragma unroll
    for (int c = 0; c < 9; ++c) s[k][c] = 0.0;
    cnt[k] = 0;
  }

  bool next_live[kSlots];
  issue_chunk(sxyz[0], ps, w, 0, slots(0));
  load_mask(next_live, ms, w, 0, slots(0));
  for (int q0 = 0, c = 0; q0 < mine; q0 += kPieces, ++c) {
    const int stage = c & 1;
    const int len = slots(q0);  // a multiple of kPiece
    bool live[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) live[u] = next_live[u];
    cp_async_wait_all();  // this thread's copies of stage c have landed
    // ... and every other thread's; and every thread is done with stage
    // c - 1, so its buffer may be refilled
    __syncthreads();
    if (q0 + kPieces < mine) {
      issue_chunk(sxyz[stage ^ 1], ps, w, q0 + kPieces, slots(q0 + kPieces));
      load_mask(next_live, ms, w, q0 + kPieces, slots(q0 + kPieces));
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int t = threadIdx.x + u * kThreads;
      if (live[u]) {
#pragma unroll
        for (int v = 0; v < 3; ++v)
          sd[stage][3 * t + v] = sxyz[stage][3 * t + v];
      } else if (t < len) {
        sxyz[stage][3 * t] = __int_as_float(0x7f800000);
      }
    }
    __syncthreads();  // masked x at +inf, valid coordinates in f64

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
        float d[kQ];
        bool hit = false;
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          d[k] = sq_dist(qx[k], qy[k], qz[k], rx[u], ry[u], rz[u]);
          hit |= d[k] <= rad2;
        }
        // Every thread of the block runs the same trip counts, so the warp
        // is converged: it votes once per reference, and only where one of
        // its queries is a neighbour, once per run of 32 queries, taking
        // the f64 sums together (branches the warp takes as one).
        if (__any_sync(0xffffffffu, hit)) {
          const double* r = sd[stage] + 3 * (t + u);
          const double x = r[0], y = r[1], z = r[2];
#pragma unroll
          for (int k = 0; k < kQ; ++k) {
            const bool near = d[k] <= rad2;
            if (__any_sync(0xffffffffu, near))
              accumulate(s[k], cnt[k], near, x, y, z);
          }
        }
      }
    }
  }
  // partial sums (splits, n, 10): row i of block blockIdx.y
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = first + k * kThreads;
    if (i >= n) continue;
    double* o = part + (static_cast<size_t>(blockIdx.y) * n + i) * 10;
#pragma unroll
    for (int c = 0; c < 9; ++c) o[c] = s[k][c];
    o[9] = cnt[k];
  }
}

// out[t] = the blocks' partial sums of value t (of n * 10), added in block
// order and rounded to f32 once.
__global__ void __launch_bounds__(kThreads)
moments_merge_kernel(const double* __restrict__ part, int splits, int total,
                     float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  double sum = part[t];
  for (int s = 1; s < splits; ++s)
    sum += part[static_cast<size_t>(s) * total + t];
  out[t] = __double2float_rn(sum);
}

int launch(const float* ps, const unsigned char* ms, int n,
           const long long* codes, int tile_m, int tile_n, int band,
           int width, float rad2, int queries_per_thread, int splits,
           void* part_, float* out, void* stream_) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto* part = static_cast<double*>(part_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const int block_q = kThreads * queries_per_thread;
  const dim3 grid((n + block_q - 1) / block_q, splits);
  switch (queries_per_thread) {
    case 1:
      moments_scan_kernel<1><<<grid, kThreads, 0, stream>>>(
          ps, ms, n, codes, tile_m, tile_n, band, width, rad2, part);
      break;
    case 2:
      moments_scan_kernel<2><<<grid, kThreads, 0, stream>>>(
          ps, ms, n, codes, tile_m, tile_n, band, width, rad2, part);
      break;
    case 4:
      moments_scan_kernel<4><<<grid, kThreads, 0, stream>>>(
          ps, ms, n, codes, tile_m, tile_n, band, width, rad2, part);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  int status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;
  const int total = n * 10;
  moments_merge_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(part, splits, total, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aicp

// Both kernels: the split plan (ops/normals.py:moments_split_plan):
// queries_per_thread 1, 2 or 4, splits blocks per query block, each with
// at least one piece of the window; part (splits, n, 10) f64 scratch; out
// (n, 10) f32.

// K2. ps (n, 3) f32 Morton-sorted, ms (n,) bool, codes (n,) int64 their
// Morton codes, ascending, SENTINEL for an invalid point. Requires n %
// tile_m == 0, n % tile_n == 0, 1 <= band <= n / tile_n and tile_m % (128
// * queries_per_thread) == 0 (a block lies inside one tile).
extern "C" int aicp_banded_moments(const float* ps, const unsigned char* ms,
                                   int n, const void* codes, int tile_m,
                                   int tile_n, int band, float rad2,
                                   int queries_per_thread, int splits,
                                   void* part, float* out, void* stream) {
  return aicp::launch(ps, ms, n, static_cast<const long long*>(codes),
                      tile_m, tile_n, band, band * tile_n, rad2,
                      queries_per_thread, splits, part, out, stream);
}

// K3. points (n, 3) f32, mask (n,) bool, any n; the window is the whole
// cloud.
extern "C" int aicp_radius_moments(const float* ps, const unsigned char* ms,
                                   int n, float rad2, int queries_per_thread,
                                   int splits, void* part, float* out,
                                   void* stream) {
  return aicp::launch(ps, ms, n, nullptr, 1, 0, 0, n, rad2,
                      queries_per_thread, splits, part, out, stream);
}
