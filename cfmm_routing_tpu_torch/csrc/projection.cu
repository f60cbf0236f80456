// Standalone batched projection kernels: project_gm and project_cs.
//
// Replace the Pallas kernels project_gm_pallas / project_cs_pallas
// (cfmm_routing_tpu/ops/projection_pallas.py, _gm_kernel and _cs_kernel
// behind the pallas_call in _pallas_project).  The math lives in
// projection.cuh; this file is the grid over pools and the C interface
// that ops/projection_cuda.py binds with ctypes.
//
// Bound: compute (see projection.cuh).  One thread per pool, 128 threads a
// block; the 73,728-pool bucket of the 100k-pool network is 576 blocks.
#include "projection.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int K, int KIND>
__global__ void __launch_bounds__(kThreads)
project_kernel(const T* __restrict__ p, const T* __restrict__ q,
               const T* __restrict__ R, const T* __restrict__ w,
               const T* __restrict__ s, const T* __restrict__ mask,
               const T* __restrict__ gamma, const T* __restrict__ logk0,
               const T* __restrict__ k0, T* __restrict__ D,
               T* __restrict__ L, int m, int n_bisect, int n_total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  T pp[K], qq[K], RR[K], ww[K], ss[K], mm[K], DD[K], LL[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const size_t e = (size_t)c * m + i;
    pp[c] = p[e];
    qq[c] = q[e];
    RR[c] = R[e];
    ww[c] = w[e];
    ss[c] = KIND == cfmm::KIND_CS ? T(0) : s[e];
    mm[c] = mask[e];
  }
  const T lk = KIND == cfmm::KIND_CS ? T(0) : logk0[i];
  cfmm::project_pool<T, K, KIND>(pp, qq, RR, ww, ss, mm, gamma[i], lk, k0[i],
                                 n_bisect, n_total, DD, LL);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const size_t e = (size_t)c * m + i;
    D[e] = DD[c];
    L[e] = LL[c];
  }
}

}  // namespace

// kind: 0 geo-mean, 1 geo-mean with reserve floor, 2 constant sum.
// dtype: 0 float, 1 double.  Pointers are device pointers of contiguous
// (K, m) planes and (m,) vectors; s and logk0 may be null for kind 2.
// Returns the launch's cudaError_t (0 on success).
extern "C" int cfmm_project(int dtype, int kind, int K, int m, const void* p,
                            const void* q, const void* R, const void* w,
                            const void* s, const void* mask, const void* gamma,
                            const void* logk0, const void* k0, void* D,
                            void* L, int n_bisect, int n_polish,
                            void* stream) {
  if (m <= 0) return 0;
  const dim3 grid((m + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CFMM_LAUNCH_PROJECT(TT, KK, KD)                                       \
  project_kernel<TT, KK, KD><<<grid, kThreads, 0, st>>>(                      \
      (const TT*)p, (const TT*)q, (const TT*)R, (const TT*)w, (const TT*)s,   \
      (const TT*)mask, (const TT*)gamma, (const TT*)logk0, (const TT*)k0,     \
      (TT*)D, (TT*)L, m, n_bisect, n_bisect + n_polish)
  CFMM_DISPATCH(dtype, K, kind, CFMM_LAUNCH_PROJECT)
#undef CFMM_LAUNCH_PROJECT
  return (int)cudaGetLastError();
}
