// Fused ADMM half-iteration for one bucket: gather, projection, relaxation
// and the consensus reduction in one pass over the bucket's slot planes.
//
// Replaces the Pallas kernel fused_step (cfmm_routing_tpu/ops/
// iteration_pallas.py, _fused_kernel, unfolded).  Per pool:
//
//   ve  = v[asset] * mask                 (v = wdef - nu, zero-padded)
//   p   = sD + ve,  q = sL - ve,   (D, L) = Proj_T(p, q)
//   sD' = a D + (1-a) sD,   sL' = a L + (1-a) sL
//   y[asset] += a (L - D) + (1-a) (sL - sD)
//
// The TPU kernel routed the gather and the reduction through radix-128
// one-hot matrix products on the MXU.  Here the price vector is copied
// into shared memory once per block and read by index, and each block
// reduces into a shared-memory copy of y with shared atomics, then adds
// its nonzero entries to the global y with one atomic per asset.  Both
// sums stay in the working type (no TF32, no bf16); the atomic order makes
// y repeatable only to roundoff, not bitwise.
//
// Bound: compute — the projection's root-find (projection.cuh) dominates;
// the pass reads 7 slot planes and writes 4.
#include "projection.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int K, int KIND>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const T* __restrict__ sD, const T* __restrict__ sL,
             const int* __restrict__ asset, const T* __restrict__ R,
             const T* __restrict__ w, const T* __restrict__ s,
             const T* __restrict__ mask, const T* __restrict__ gamma,
             const T* __restrict__ logk0, const T* __restrict__ k0,
             const T* __restrict__ v, int n_pad, T alpha, T beta,
             T* __restrict__ sDn, T* __restrict__ sLn, T* __restrict__ Dout,
             T* __restrict__ Lout, T* __restrict__ y, int m, int n_bisect,
             int n_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v_sh = reinterpret_cast<T*>(smem_raw);
  T* y_sh = v_sh + n_pad;
  for (int j = threadIdx.x; j < n_pad; j += blockDim.x) {
    v_sh[j] = v[j];
    y_sh[j] = T(0);
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) {
    T sd[K], sl[K], pp[K], qq[K], RR[K], ww[K], ss[K], mm[K], DD[K], LL[K];
    int aa[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const size_t e = (size_t)c * m + i;
      sd[c] = sD[e];
      sl[c] = sL[e];
      aa[c] = asset[e];
      RR[c] = R[e];
      ww[c] = w[e];
      ss[c] = s[e];
      mm[c] = mask[e];
      const T ve = v_sh[aa[c]] * mm[c];
      pp[c] = sd[c] + ve;
      qq[c] = sl[c] - ve;
    }
    cfmm::project_pool<T, K, KIND>(pp, qq, RR, ww, ss, mm, gamma[i], logk0[i],
                                   k0[i], n_bisect, n_total, DD, LL);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const size_t e = (size_t)c * m + i;
      sDn[e] = alpha * DD[c] + beta * sd[c];
      sLn[e] = alpha * LL[c] + beta * sl[c];
      Dout[e] = DD[c];
      Lout[e] = LL[c];
      atomicAdd(&y_sh[aa[c]], alpha * (LL[c] - DD[c]) + beta * (sl[c] - sd[c]));
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_pad; j += blockDim.x) {
    const T yj = y_sh[j];
    if (yj != T(0)) atomicAdd(&y[j], yj);
  }
}

}  // namespace

// One fused half-iteration over a bucket.  kind/dtype as in cfmm_project.
// asset: int32 (K, m) ids in [0, n_pad); v: (n_pad,) price vector; y must be
// zeroed by the caller (the kernel accumulates into it).  alpha and beta =
// 1 - alpha are passed separately so the card and the plain version use
// the same rounded coefficients.  Returns the launch's cudaError_t.
extern "C" int cfmm_fused_step(int dtype, int kind, int K, int m, int n_pad,
                               double alpha, double beta, const void* sD,
                               const void* sL, const void* asset,
                               const void* R, const void* w, const void* s,
                               const void* mask, const void* gamma,
                               const void* logk0, const void* k0,
                               const void* v, void* sDn, void* sLn, void* D,
                               void* L, void* y, int n_bisect, int n_polish,
                               void* stream) {
  if (m <= 0) return 0;
  const dim3 grid((m + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define CFMM_LAUNCH_FUSED(TT, KK, KD)                                          \
  {                                                                            \
    const size_t smem = 2 * (size_t)n_pad * sizeof(TT);                        \
    if (smem > 48 * 1024) {                                                    \
      err = cudaFuncSetAttribute(fused_kernel<TT, KK, KD>,                     \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                                 (int)smem);                                   \
      if (err != cudaSuccess) return (int)err;                                 \
    }                                                                          \
    fused_kernel<TT, KK, KD><<<grid, kThreads, smem, st>>>(                    \
        (const TT*)sD, (const TT*)sL, (const int*)asset, (const TT*)R,         \
        (const TT*)w, (const TT*)s, (const TT*)mask, (const TT*)gamma,         \
        (const TT*)logk0, (const TT*)k0, (const TT*)v, n_pad, (TT)alpha,       \
        (TT)beta, (TT*)sDn, (TT*)sLn, (TT*)D, (TT*)L, (TT*)y, m, n_bisect,     \
        n_bisect + n_polish);                                                  \
  }
  CFMM_DISPATCH(dtype, K, kind, CFMM_LAUNCH_FUSED)
#undef CFMM_LAUNCH_FUSED
  return (int)cudaGetLastError();
}
