// Fused ADMM half-iteration of the refinement stage for one bucket: gather,
// projection onto the SHIFTED trading sets and relaxation in one pass.
//
// Replaces the Pallas kernel fused_step_delta (cfmm_routing_tpu/ops/
// iteration_pallas.py, _fused_delta_kernel), unfolded and folded.  Per pool:
//
//   ve  = v[asset] * mask,  off = ve - nu0e    (v = wdef - dnu, zero-padded;
//                                               nu0e the pre-broadcast,
//                                               pre-masked base dual)
//   p   = sD + off,  q = sL - off,   (A, B) = Proj_S(p, q)   (projection_delta.cuh)
//   sD' = a A + (1-a) sD,   sL' = a B + (1-a) sL
//   val = a (B - A) + (1-a) (sL - sD)   -> reduced per asset by segment_sum.cu
//
// As in fused_step.cu, the price vector is copied into shared memory once
// per block and read by index; no one-hot exchange and no atomics.  nu0e
// may be null (the bucket has no base-dual plane): it then reads as zero.
// Folded buckets (fold_m > 0) stage only the block's own scenario point's
// prices, as in fused_step.cu.
//
// Bound: compute — 80 flops per slot per root-find step (the Pallas cost
// model without its one-hot exchange) against 14 planes of bytes; the
// design keeps every mu-free term out of the loop (projection_delta.cuh).
#include "projection_delta.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int KC, int KIND>
__global__ void __launch_bounds__(kThreads)
fused_delta_kernel(const T* __restrict__ sD, const T* __restrict__ sL,
                   const int* __restrict__ asset, const T* __restrict__ X0,
                   const T* __restrict__ w, const T* __restrict__ sS,
                   const T* __restrict__ aD, const T* __restrict__ aL,
                   const T* __restrict__ mask, const T* __restrict__ nu0e,
                   const T* __restrict__ gamma, const T* __restrict__ nsig,
                   const T* __restrict__ v, int n_pad, T alpha, T beta,
                   T* __restrict__ sDn, T* __restrict__ sLn,
                   T* __restrict__ Aout, T* __restrict__ Bout,
                   T* __restrict__ val, int K, int m, int n_bisect,
                   int n_total, int fold_m, int fold_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v_sh = reinterpret_cast<T*>(smem_raw);
  const int base = fold_m > 0 ? (int)(blockIdx.x * kThreads / fold_m) * fold_n : 0;
  const int n_sh = fold_m > 0 ? fold_n : n_pad;
  for (int j = threadIdx.x; j < n_sh; j += blockDim.x) v_sh[j] = v[base + j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  auto load = [&](int c) {
    const size_t e = (size_t)c * m + i;
    cfmm::DeltaIn<T> in;
    in.mask = mask[e];
    const int id = asset[e] - base;
    const T ve = (id >= 0 && id < n_sh ? v_sh[id] : T(0)) * in.mask;
    const T off = ve - (nu0e != nullptr ? nu0e[e] : T(0));
    in.p = sD[e] + off;
    in.q = sL[e] - off;
    in.X0 = X0[e];
    in.w = w[e];
    in.sS = sS[e];
    in.aD = aD[e];
    in.aL = aL[e];
    return in;
  };
  auto store = [&](int c, T A, T B) {
    const size_t e = (size_t)c * m + i;
    const T sd = sD[e];
    const T sl = sL[e];
    sDn[e] = alpha * A + beta * sd;
    sLn[e] = alpha * B + beta * sl;
    Aout[e] = A;
    Bout[e] = B;
    val[e] = alpha * (B - A) + beta * (sl - sd);
  };
  cfmm::project_pool_delta<T, KC, KIND>(load, K, gamma[i], nsig[i], n_bisect,
                                        n_total, store);
}

}  // namespace

// One fused delta half-iteration over a bucket.  kind: 0 geo-mean, 1
// geo-mean with reserve floor, 2 constant sum (its reserve floor always
// applies); dtype: 0 float, 1 double.  Planes are contiguous (K, m), gamma
// and nsig (m,), v (n_pad,), asset int32 ids in [0, n_pad); nu0e may be
// null.  fold_m / fold_n as in cfmm_fused_step (0 / 0 unfolded).  Returns
// the launch's cudaError_t.
extern "C" int cfmm_fused_step_delta(
    int dtype, int kind, int K, int m, int n_pad, int fold_m, int fold_n,
    double alpha, double beta,
    const void* sD, const void* sL, const void* asset, const void* X0,
    const void* w, const void* sS, const void* aD, const void* aL,
    const void* mask, const void* nu0e, const void* gamma, const void* nsig,
    const void* v, void* sDn, void* sLn, void* A, void* B, void* val,
    int n_bisect, int n_polish, void* stream) {
  if (m <= 0) return 0;
  if (fold_m > 0 && (fold_m % kThreads != 0 || m % fold_m != 0 ||
                     (size_t)(m / fold_m) * fold_n > (size_t)n_pad))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  const int n_sh = fold_m > 0 ? fold_n : n_pad;
#define CFMM_LAUNCH_DELTA(TT, KK, KD)                                          \
  {                                                                            \
    const size_t smem = (size_t)n_sh * sizeof(TT);                             \
    if (smem > 48 * 1024) {                                                    \
      err = cudaFuncSetAttribute(fused_delta_kernel<TT, KK, KD>,               \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                                 (int)smem);                                   \
      if (err != cudaSuccess) return (int)err;                                 \
    }                                                                          \
    fused_delta_kernel<TT, KK, KD><<<grid, kThreads, smem, st>>>(              \
        (const TT*)sD, (const TT*)sL, (const int*)asset, (const TT*)X0,        \
        (const TT*)w, (const TT*)sS, (const TT*)aD, (const TT*)aL,             \
        (const TT*)mask, (const TT*)nu0e, (const TT*)gamma, (const TT*)nsig,   \
        (const TT*)v, n_pad, (TT)alpha, (TT)beta, (TT*)sDn, (TT*)sLn, (TT*)A,  \
        (TT*)B, (TT*)val, K, m, n_bisect, n_bisect + n_polish, fold_m,         \
        fold_n);                                                               \
  }
  CFMM_DISPATCH(dtype, K, kind, CFMM_LAUNCH_DELTA)
#undef CFMM_LAUNCH_DELTA
  return (int)cudaGetLastError();
}
