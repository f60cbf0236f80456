// Standalone batched delta projections: project_gm_delta and
// project_cs_delta, the projection of the refinement stage's classic
// iteration (DeltaAdmmSolver._iterate) and of the residual-harvest step
// that closes every fused delta chunk.
//
// The JAX package runs these as plain jnp functions
// (cfmm_routing_tpu/ops/projection_delta.py: project_gm_delta,
// project_cs_delta), which XLA compiles into one program; eagerly, the
// plain PyTorch version issues some 2,500 small launches per bucket on the
// card.  The math lives in projection_delta.cuh (shared with the fused
// kernel); this file is the grid over pools and the C interface that
// ops/projection_cuda.py binds with ctypes.
//
// Bound: compute (see projection_delta.cuh).  One thread per pool, 128
// threads a block.
#include "projection_delta.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int KC, int KIND>
__global__ void __launch_bounds__(kThreads)
project_delta_kernel(const T* __restrict__ p, const T* __restrict__ q,
                     const T* __restrict__ X0, const T* __restrict__ w,
                     const T* __restrict__ sS, const T* __restrict__ aD,
                     const T* __restrict__ aL, const T* __restrict__ mask,
                     const T* __restrict__ gamma, const T* __restrict__ nsig,
                     T* __restrict__ A, T* __restrict__ B, int K, int m,
                     int n_bisect, int n_total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  auto load = [&](int c) {
    const size_t e = (size_t)c * m + i;
    cfmm::DeltaIn<T> in;
    in.p = p[e];
    in.q = q[e];
    in.X0 = X0[e];
    in.w = w[e];
    in.sS = KIND == cfmm::KIND_CS ? T(0) : sS[e];
    in.aD = aD[e];
    in.aL = aL[e];
    in.mask = mask[e];
    return in;
  };
  auto store = [&](int c, T a, T b) {
    const size_t e = (size_t)c * m + i;
    A[e] = a;
    B[e] = b;
  };
  cfmm::project_pool_delta<T, KC, KIND>(load, K, gamma[i], nsig[i], n_bisect,
                                        n_total, store);
}

}  // namespace

// kind: 0 geo-mean, 1 geo-mean with reserve floor, 2 constant sum (its
// reserve floor always applies).  dtype: 0 float, 1 double.  Pointers are
// device pointers of contiguous (K, m) planes and (m,) vectors; sS may be
// null for kind 2.  Returns the launch's cudaError_t (0 on success).
extern "C" int cfmm_project_delta(int dtype, int kind, int K, int m,
                                  const void* p, const void* q, const void* X0,
                                  const void* w, const void* sS, const void* aD,
                                  const void* aL, const void* mask,
                                  const void* gamma, const void* nsig, void* A,
                                  void* B, int n_bisect, int n_polish,
                                  void* stream) {
  if (m <= 0) return 0;
  const dim3 grid((m + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CFMM_LAUNCH_PROJECT_DELTA(TT, KK, KD)                                 \
  project_delta_kernel<TT, KK, KD><<<grid, kThreads, 0, st>>>(                \
      (const TT*)p, (const TT*)q, (const TT*)X0, (const TT*)w, (const TT*)sS, \
      (const TT*)aD, (const TT*)aL, (const TT*)mask, (const TT*)gamma,        \
      (const TT*)nsig, (TT*)A, (TT*)B, K, m, n_bisect, n_bisect + n_polish)
  CFMM_DISPATCH(dtype, K, kind, CFMM_LAUNCH_PROJECT_DELTA)
#undef CFMM_LAUNCH_PROJECT_DELTA
  return (int)cudaGetLastError();
}
