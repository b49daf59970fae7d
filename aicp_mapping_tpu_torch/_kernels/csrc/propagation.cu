// Label propagation — min-label propagation over region growing's
// smoothness graph, the whole loop in one launch.
//
// Replaces no TPU kernel: the JAX package runs this loop as a
// jax.lax.while_loop that XLA fuses on the device
// (aicp_mapping_tpu/ops/segmentation.py:label_propagation_clusters). The
// port ran it as an eager PyTorch loop, ~37 launches a round and a
// blocking read of the convergence flag at its end, so a cloud of 4,096
// points (alignability, twice a frame) cost ~35 host round trips. Here
// every round, its pointer jumps and the convergence test run inside one
// block; the host waits for nothing.
//
// Semantics, the eager loop's bit for bit (ops/segmentation.py:
// propagate_labels, the plain twin): labels start at i for a valid point
// and n for the rest; each round pulls the least label of the pullable
// neighbours (the caller's pull_ok: the smoothness test stays in PyTorch),
// takes `jumps` pointer jumps L <- min(L, L[L]), each reading only the
// previous jump's labels, sets invalid points to n, and stops when no label
// changed or after `max_iters` rounds. These are Jacobi rounds over double
// buffers with a block-wide barrier between phases: an in-place
// (Gauss-Seidel) update reaches the same fixpoint but other labels under
// the round cap.
//
// Bound on the H100: latency, not throughput. A round at 4,096 points is
// ~60,000 dependent shared-memory reads (the pull's neighbour and label,
// then six jumps of two) spread over one SM's 32 warps, and 8 barriers;
// the card's other SMs idle. That is the price of a loop with a data-
// dependent stop that never leaves the device; one block keeps every
// barrier a __syncthreads.
//
// Design: one block of 1,024 threads, thread t owning points t, t + 1024,
// ... A preamble compacts each point's pullable neighbours to the front of
// its column of a neighbour list ([slot][point], so that a warp reads
// consecutive entries) and keeps their count and the point's validity in
// one byte. The labels live in three buffers: the round's labels, and a
// pair that the pull and the jumps write in turns. Where they fit, labels
// and list sit in shared memory as 16-bit indices; the mode is chosen from
// n and k alone (ops/segmentation.py:propagation_plan mirrors `layout`):
// - kAllShared: labels, bytes and list in shared memory (n * (2k + 7)
//   bytes: 4,096 points with k = 15, ~152 KB; up to 6,282 points);
// - kListGlobal: labels and bytes in shared memory, the 16-bit list in
//   device memory, where it stays in L2 (n <= 33,205: the region-growing
//   prefilter's 8,192-32,768 points);
// - kAllGlobal: 32-bit labels and list, all in device memory.
// The rounds run are added to a device counter with one atomicAdd; the
// host reads it only when asked (propagation_rounds).
#include <cstdint>

#include "common.cuh"

namespace aicp {
namespace {

constexpr int kPropThreads = 1024;
// Shared memory one block may opt into on sm_90 (the H100 and H200).
constexpr int kSmemLimit = 232448;
// Bit 7 of a point's byte: the point is valid; bits 0-6: its pullable
// neighbours (so k <= 127).
constexpr unsigned char kValid = 0x80;
constexpr int kMaxK = 127;

enum Mode { kAllShared = 0, kListGlobal = 1, kAllGlobal = 2 };

constexpr size_t align16(size_t b) { return (b + 15) & ~size_t{15}; }

// Bytes of each piece of a mode's storage: the three label buffers, the
// bytes, the list. Where each lies follows from the mode.
struct Layout {
  size_t labels, meta, list, smem, scratch;
};

Layout layout(int mode, int n, int k) {
  const size_t w = mode == kAllGlobal ? 4 : 2;
  Layout l{align16(3 * w * n), align16(static_cast<size_t>(n)),
           align16(w * n * k), 0, 0};
  if (mode == kAllShared) l.smem = l.labels + l.meta + l.list;
  if (mode == kListGlobal) {
    l.smem = l.labels + l.meta;
    l.scratch = l.list;
  }
  if (mode == kAllGlobal) l.scratch = l.labels + l.meta + l.list;
  return l;
}

template <typename L>
__global__ void __launch_bounds__(kPropThreads)
propagation_kernel(const long long* __restrict__ idx, int ld, int k,
                   const unsigned char* __restrict__ pull_ok,
                   const unsigned char* __restrict__ mask, int n,
                   int max_iters, int jumps, int mode, Layout lay,
                   unsigned char* scratch, long long* __restrict__ out,
                   unsigned long long* rounds_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = mode == kAllGlobal ? scratch : smem;
  L* cur = reinterpret_cast<L*>(base);
  L* nxt = cur + n;
  L* spare = cur + 2 * n;
  unsigned char* meta = base + lay.labels;
  L* list = reinterpret_cast<L*>(
      mode == kListGlobal ? scratch : base + lay.labels + lay.meta);
  const L none = static_cast<L>(n);

  for (int i = threadIdx.x; i < n; i += kPropThreads) {
    int c = 0;
    for (int j = 0; j < k; ++j) {
      if (pull_ok[static_cast<size_t>(i) * k + j]) {
        list[static_cast<size_t>(c) * n + i] =
            static_cast<L>(idx[static_cast<size_t>(i) * ld + j]);
        ++c;
      }
    }
    const bool valid = mask[i] != 0;
    meta[i] = static_cast<unsigned char>((valid ? kValid : 0) | c);
    cur[i] = valid ? static_cast<L>(i) : none;
  }
  __syncthreads();

  int rounds = 0;
  for (int r = 0; r < max_iters; ++r) {
    // the pull: the least of the point's label and its pullable
    // neighbours' labels
    for (int i = threadIdx.x; i < n; i += kPropThreads) {
      L v = cur[i];
      const int c = meta[i] & ~kValid;
      for (int j = 0; j < c; ++j) {
        const L w = cur[list[static_cast<size_t>(j) * n + i]];
        v = w < v ? w : v;
      }
      nxt[i] = v;
    }
    __syncthreads();
    // pointer jumps, each from the previous jump's labels
    for (int s = 0; s < jumps; ++s) {
      for (int i = threadIdx.x; i < n; i += kPropThreads) {
        const L v = nxt[i];
        L u = none;
        if (v < none) {
          const L w = nxt[v];
          u = w < v ? w : v;
        }
        spare[i] = u;
      }
      __syncthreads();
      L* t = nxt;
      nxt = spare;
      spare = t;
    }
    // invalid points back to n; did any label change?
    int changed = 0;
    for (int i = threadIdx.x; i < n; i += kPropThreads) {
      L v = nxt[i];
      if (!(meta[i] & kValid)) {
        v = none;
        nxt[i] = v;
      }
      changed |= v != cur[i];
    }
    ++rounds;
    changed = __syncthreads_or(changed);
    L* t = cur;
    cur = nxt;
    nxt = spare;
    spare = t;
    if (!changed) break;
  }

  for (int i = threadIdx.x; i < n; i += kPropThreads)
    out[i] = (meta[i] & kValid) ? static_cast<long long>(cur[i]) : -1ll;
  if (threadIdx.x == 0) atomicAdd(rounds_total,
                                  static_cast<unsigned long long>(rounds));
}

template <typename L>
int launch(const long long* idx, int ld, int k, const unsigned char* pull_ok,
           const unsigned char* mask, int n, int max_iters, int jumps,
           int mode, const Layout& lay, unsigned char* scratch,
           long long* out, unsigned long long* rounds_total,
           cudaStream_t stream) {
  // the same value on every call, so that threads launching at once
  // cannot lower it under each other
  cudaError_t status = cudaFuncSetAttribute(
      propagation_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (status != cudaSuccess) return static_cast<int>(status);
  propagation_kernel<L><<<1, kPropThreads, lay.smem, stream>>>(
      idx, ld, k, pull_ok, mask, n, max_iters, jumps, mode, lay, scratch,
      out, rounds_total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace aicp

// idx: (n, >= k) int64 neighbour indices, rows `ld` apart (the first k
// columns are read); pull_ok (n, k) bool; mask (n,) bool; mode from
// ops/segmentation.py:propagation_plan, scratch its bytes of device memory;
// out (n,) int64, the labels, -1 where the mask is false; rounds_total a
// device int64 that the rounds run are added to.
extern "C" int aicp_label_propagation(const void* idx, int ld, int k,
                                      const unsigned char* pull_ok,
                                      const unsigned char* mask, int n,
                                      int max_iters, int jumps, int mode,
                                      void* scratch, void* out,
                                      void* rounds_total, void* stream) {
  using namespace aicp;
  if (n < 0 || k < 0 || k > kMaxK || ld < k || max_iters < 0 || jumps < 0 ||
      mode < kAllShared || mode > kAllGlobal ||
      (mode != kAllGlobal && n > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(mode, n, k);
  if (lay.smem > static_cast<size_t>(kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ix = static_cast<const long long*>(idx);
  auto* sc = static_cast<unsigned char*>(scratch);
  auto* o = static_cast<long long*>(out);
  auto* rt = static_cast<unsigned long long*>(rounds_total);
  const auto st = static_cast<cudaStream_t>(stream);
  if (mode == kAllGlobal)
    return launch<int32_t>(ix, ld, k, pull_ok, mask, n, max_iters, jumps,
                           mode, lay, sc, o, rt, st);
  return launch<uint16_t>(ix, ld, k, pull_ok, mask, n, max_iters, jumps,
                          mode, lay, sc, o, rt, st);
}
