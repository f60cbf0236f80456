// Fused ADMM half-iteration for one bucket: gather, projection and
// relaxation in one pass over the bucket's slot planes.
//
// Replaces the Pallas kernel fused_step (cfmm_routing_tpu/ops/
// iteration_pallas.py, _fused_kernel), unfolded and folded.  Per pool:
//
//   ve  = v[asset] * mask                 (v = wdef - nu, zero-padded)
//   p   = sD + ve,  q = sL - ve,   (D, L) = Proj_T(p, q)
//   sD' = a D + (1-a) sD,   sL' = a L + (1-a) sL
//   val = a (L - D) + (1-a) (sL - sD)     (the slot's consensus term)
//
// The TPU kernel routed the gather and the reduction through radix-128
// one-hot matrix products on the MXU.  Here the price vector is copied
// into shared memory once per block and read by index, and each slot's
// consensus term is written to a (K, m) plane that the segment-sum kernel
// (segment_sum.cu) reduces per asset in a fixed order, so y is bitwise
// repeatable.  Both stay in the working type (no TF32, no bf16).
//
// Folded (fold_m > 0): the bucket holds T scenario points one after another
// on the pool axis, fold_m pools each (a multiple of the block size, so no
// block straddles two points), and point t's asset ids are offset by
// t * fold_n.  A block copies only its own point's fold_n prices into
// shared memory and reads them at id - t * fold_n, so shared memory is
// fold_n values whatever T is.  An id outside the block's point (a padding
// slot) reads 0 before the mask; the folded ids and the segment sum keep
// the points apart.
//
// Bound: compute — the projection's root-find (projection.cuh) dominates;
// the pass reads 7 slot planes and writes 5.
#include "projection.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int KC, int KIND>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const T* __restrict__ sD, const T* __restrict__ sL,
             const int* __restrict__ asset, const T* __restrict__ R,
             const T* __restrict__ w, const T* __restrict__ s,
             const T* __restrict__ mask, const T* __restrict__ gamma,
             const T* __restrict__ logk0, const T* __restrict__ k0,
             const T* __restrict__ v, int n_pad, T alpha, T beta,
             T* __restrict__ sDn, T* __restrict__ sLn, T* __restrict__ Dout,
             T* __restrict__ Lout, T* __restrict__ val, int K, int m,
             int n_bisect, int n_total, int fold_m, int fold_n) {
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
    cfmm::SlotIn<T> in;
    in.mask = mask[e];
    const int id = asset[e] - base;
    const T ve = (id >= 0 && id < n_sh ? v_sh[id] : T(0)) * in.mask;
    in.p = sD[e] + ve;
    in.q = sL[e] - ve;
    in.R = R[e];
    in.w = w[e];
    in.s = s[e];
    return in;
  };
  auto store = [&](int c, T D, T L) {
    const size_t e = (size_t)c * m + i;
    const T sd = sD[e];
    const T sl = sL[e];
    sDn[e] = alpha * D + beta * sd;
    sLn[e] = alpha * L + beta * sl;
    Dout[e] = D;
    Lout[e] = L;
    val[e] = alpha * (L - D) + beta * (sl - sd);
  };
  cfmm::project_pool<T, KC, KIND>(load, K, gamma[i], logk0[i], k0[i],
                                  n_bisect, n_total, store);
}

}  // namespace

// One fused half-iteration over a bucket.  kind/dtype as in cfmm_project.
// asset: int32 (K, m) ids in [0, n_pad); v: (n_pad,) price vector; val:
// the (K, m) plane of consensus terms for cfmm_segment_sum.  alpha and
// beta = 1 - alpha are passed separately so the card and the plain version
// use the same rounded coefficients.  fold_m / fold_n: pools and prices per
// scenario point of a folded bucket (fold_m a multiple of 128 dividing m,
// (m / fold_m) * fold_n <= n_pad), or 0 / 0 unfolded.  Returns the launch's
// cudaError_t.
extern "C" int cfmm_fused_step(int dtype, int kind, int K, int m, int n_pad,
                               int fold_m, int fold_n,
                               double alpha, double beta, const void* sD,
                               const void* sL, const void* asset,
                               const void* R, const void* w, const void* s,
                               const void* mask, const void* gamma,
                               const void* logk0, const void* k0,
                               const void* v, void* sDn, void* sLn, void* D,
                               void* L, void* val, int n_bisect, int n_polish,
                               void* stream) {
  if (m <= 0) return 0;
  if (fold_m > 0 && (fold_m % kThreads != 0 || m % fold_m != 0 ||
                     (size_t)(m / fold_m) * fold_n > (size_t)n_pad))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  const int n_sh = fold_m > 0 ? fold_n : n_pad;
#define CFMM_LAUNCH_FUSED(TT, KK, KD)                                          \
  {                                                                            \
    const size_t smem = (size_t)n_sh * sizeof(TT);                             \
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
        (TT)beta, (TT*)sDn, (TT*)sLn, (TT*)D, (TT*)L, (TT*)val, K, m,          \
        n_bisect, n_bisect + n_polish, fold_m, fold_n);                        \
  }
  CFMM_DISPATCH(dtype, K, kind, CFMM_LAUNCH_FUSED)
#undef CFMM_LAUNCH_FUSED
  return (int)cudaGetLastError();
}
