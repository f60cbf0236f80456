// Deterministic consensus reduction: y[j] = sum of vals over the slots of
// asset j, in a fixed order.
//
// Replaces the y accumulation of the Pallas fused kernels (cfmm_routing_tpu/
// ops/iteration_pallas.py, _fused_kernel / _fused_delta_kernel: radix-128
// one-hot products into a resident y block, summed in grid order) and the
// classic path's scatter-add (solver/admm.py _reduce_edges).  On the card a
// sum taken with atomics changes its order from run to run; this kernel
// fixes it, so two runs give bitwise-equal iterates, as the reference does.
//
// Set-up (ops/segment.py slot_order, once per bucket or group): the real
// slots (mask > 0) of the flattened slot planes, stably sorted by asset id
// (`order`, int32), and the per-asset CSR offsets into that order (`seg`,
// int32, n + 1 entries).
//
// Bound: bytes, and in practice latency: each real slot's value and index
// are read once (~10 bytes), so a 100k bucket's sum is a fraction of a
// microsecond of memory traffic, and what costs is the chain of dependent
// loads (order -> vals) and the card's occupancy.  One warp per asset (the
// first design) left most SMs empty (256 warps at 100k) and walked ~18
// dependent gathers per lane; an asset in every pool serialised on one warp.
//
// Design: the sorted order is cut into fixed global chunks of C positions.
//   Pass 1, one warp per chunk (so the grid grows with the slot count,
//   whatever the asset skew): the chunk's positions belong to a run of
//   consecutive assets; the warp finds the first by binary search in seg
//   and sums each asset's piece of the chunk, lane l adding the piece's
//   positions l, l + 32, ... in order from zero, then a fixed shuffle tree
//   (offsets 16, 8, 4, 2, 1).  An asset whose run lies inside the chunk is
//   written to y at once; a piece of an asset that crosses the chunk's
//   start goes to head[g], one that crosses its end to tail[g].
//   Pass 2, one thread per output: an asset spanning chunks g0 < g1 adds
//   its pieces in chunk order, tail[g0] + head[g0 + 1] + ... + head[g1];
//   empty assets and the padding entries j in [n, n_out) are written 0.
// Reads of `order` are coalesced along the warp and every position is
// touched once.  The sums stay in the working type.  C = 64 (CHUNK in
// ops/segment.py, which the plain version repeats), chosen on an H100 from
// C = 32, 64, 128 and 256 timed side by side (PERF.md): at the 100k
// network's largest bucket (147,456 slots) that is 2,304 warps of two loads
// per lane.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // C, the positions per chunk

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const T* __restrict__ vals, const int* __restrict__ order,
             const int* __restrict__ seg, int n, int n_real,
             T* __restrict__ y, T* __restrict__ head, T* __restrict__ tail) {
  const int g = (int)((blockIdx.x * (size_t)kThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  const int lo = g * kChunk;
  if (lo >= n_real) return;  // g is uniform across the warp
  const int hi = min(lo + kChunk, n_real);
  int a = 0, b = n - 1;  // the last asset with seg[j] <= lo: non-empty
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (seg[mid] <= lo) a = mid; else b = mid - 1;
  }
  int j = a;
  while (true) {
    const int sj = seg[j], ej = seg[j + 1];
    const int e = min(ej, hi);
    T acc = T(0);
    for (int r = max(sj, lo) + lane; r < e; r += 32) acc = acc + vals[order[r]];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = acc + __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      if (sj >= lo && ej <= hi) {
        y[j] = acc;
      } else {
        if (sj < lo) head[g] = acc;
        if (ej > hi) tail[g] = acc;
      }
    }
    if (ej >= hi) break;
    do { ++j; } while (seg[j + 1] == seg[j]);  // the next non-empty asset
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const int* __restrict__ seg, int n, int n_out,
               const T* __restrict__ head, const T* __restrict__ tail,
               T* __restrict__ y) {
  const int j = (int)(blockIdx.x * (size_t)kThreads + threadIdx.x);
  if (j >= n_out) return;
  if (j >= n) {
    y[j] = T(0);
    return;
  }
  const int s = seg[j], e = seg[j + 1];
  if (s == e) {
    y[j] = T(0);
    return;
  }
  const int g0 = s / kChunk, g1 = (e - 1) / kChunk;
  if (g0 == g1) return;  // the chunk's warp wrote it
  T acc = tail[g0];
  for (int g = g0 + 1; g <= g1; ++g) acc = acc + head[g];
  y[j] = acc;
}

template <typename T>
int launch(int n, int n_out, int n_real, const void* vals, const void* order,
           const void* seg, void* y, void* scratch, cudaStream_t st) {
  const int chunks = (n_real + kChunk - 1) / kChunk;
  T* head = (T*)scratch;
  T* tail = head + chunks;
  if (chunks > 0) {
    const dim3 grid((unsigned)(((size_t)chunks * 32 + kThreads - 1) / kThreads));
    chunk_kernel<T><<<grid, kThreads, 0, st>>>(
        (const T*)vals, (const int*)order, (const int*)seg, n, n_real, (T*)y,
        head, tail);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid2((unsigned)((n_out + kThreads - 1) / kThreads));
  combine_kernel<T><<<grid2, kThreads, 0, st>>>(
      (const int*)seg, n, n_out, head, tail, (T*)y);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float, 1 double.  vals: the flattened slot planes; order: its
// n_real int32 sorted real-slot indices; seg: int32 (n + 1,) offsets into
// order (seg[n] == n_real); y: (n_out,) output, n_out >= n >= 1; scratch:
// 2 * ceil(n_real / 64) values of the working type.  Two kernels on
// `stream`.  Returns the launches' cudaError_t.
extern "C" int cfmm_segment_sum(int dtype, int n, int n_out, int n_real,
                                const void* vals, const void* order,
                                const void* seg, void* y, void* scratch,
                                void* stream) {
  if (n_out <= 0) return 0;
  if (n < 1 || n_out < n || n_real < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(n, n_out, n_real, vals, order, seg, y, scratch, st);
    case 1:
      return launch<double>(n, n_out, n_real, vals, order, seg, y, scratch, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
