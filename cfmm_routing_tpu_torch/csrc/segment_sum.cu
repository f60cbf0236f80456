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
// Set-up (solver/admm.py _bucket_device_arrays, once per bucket): the real
// slots (mask > 0) of the slot-major (K, m) plane, flattened, stably sorted
// by asset id (`order`, int32), and the per-asset CSR offsets into that
// order (`seg`, int32, n + 1 entries).
//
// One warp per asset.  Lane l adds the asset's sorted slots l, l + 32,
// l + 64, ... in that order, starting from zero; then a fixed shuffle tree
// (offsets 16, 8, 4, 2, 1) combines the lanes and lane 0 writes y[j].
// Entries j in [n, n_out) are written as zero (the padded price layout).
// The sum stays in the working type.
//
// Bound: bytes.  Each real slot's value and its index are read once; the
// reads through `order` are gathers, so the kernel runs below the card's
// streaming rate.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ vals, const int* __restrict__ order,
                   const int* __restrict__ seg, int n, int n_out,
                   T* __restrict__ y) {
  const int j = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= n_out) return;  // j is uniform across the warp
  T acc = T(0);
  if (j < n) {
    const int end = seg[j + 1];
    for (int r = seg[j] + lane; r < end; r += 32) acc = acc + vals[order[r]];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = acc + __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[j] = acc;
}

}  // namespace

// dtype: 0 float, 1 double.  vals: the flattened (K, m) plane; order:
// int32 sorted slot indices into it; seg: int32 (n + 1,) offsets into
// order; y: (n_out,) output, n_out >= n.  Returns the launch's cudaError_t.
extern "C" int cfmm_segment_sum(int dtype, int n, int n_out, const void* vals,
                                const void* order, const void* seg, void* y,
                                void* stream) {
  if (n_out <= 0) return 0;
  const dim3 grid((unsigned)(((size_t)n_out * 32 + kThreads - 1) / kThreads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      segment_sum_kernel<float><<<grid, kThreads, 0, st>>>(
          (const float*)vals, (const int*)order, (const int*)seg, n, n_out,
          (float*)y);
      break;
    case 1:
      segment_sum_kernel<double><<<grid, kThreads, 0, st>>>(
          (const double*)vals, (const int*)order, (const int*)seg, n, n_out,
          (double*)y);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
