// Fused ADMM half-iteration: gather, projection and relaxation in one pass
// over the slot planes.
//
// Replaces the Pallas kernel fused_step (cfmm_routing_tpu/ops/
// iteration_pallas.py:260, _fused_kernel, pallas_call :350), unfolded and
// folded, and fused_step_merged (:837, _merged_kernel).  Per pool:
//
//   ve  = v[asset] * mask                 (v = wdef - nu, zero-padded)
//   p   = sD + ve,  q = sL - ve,   (D, L) = Proj_T(p, q)
//   sD' = a D + (1-a) sD,   sL' = a L + (1-a) sL
//   val = a (L - D) + (1-a) (sL - sD)     (the slot's consensus term)
//
// The TPU kernel routed the gather and the reduction through radix-128
// one-hot matrix products on the MXU.  Here the price vector is copied
// into shared memory once per block and read by index, and each slot's
// consensus term is written to a plane that the segment-sum kernel
// (segment_sum.cu) reduces per asset in a fixed order, so y is bitwise
// repeatable.  Both stay in the working type (no TF32, no bf16).
//
// Bound on an H100: operations and latency (60 flops per slot per
// root-find step in the Pallas cost model, against 12 planes of bytes).
// The first design, one thread per pool with the pool's K prepared slots
// in registers (15 values each) and one launch per bucket, put less than
// one block on each SM for four of the 100k network's five buckets and ran
// them one after another.  cfmm_fused_step is therefore grouped:
//
// * Lanes per slot (projection.cuh, project_slot): LANES = the power of two
//   >= K consecutive lanes own one pool, one slot each; h(mu)'s slot terms
//   are gathered with __shfl_sync in slot order and every lane runs the
//   same fixed-trip root-find, so the planes are bitwise equal to the plain
//   version's.  K > 32 keeps one thread per pool (project_pool, run-time K).
// * One launch per K-group: a by-value (__grid_constant__) table of bucket
//   descriptors (planes, m, kind, fold_m / fold_n, first block), built on
//   the host from arrays of pointers; a block finds its bucket from
//   blockIdx.x and switches on its kind, uniform within the block.  Each
//   bucket writes its consensus terms into its slice of the group's
//   buffer, which one segment sum reduces over the group's slot order.
//   The 100k network's five buckets take two launches and two segment
//   sums (K = 2, K = 4), folded or not.
//
// Folded (fold_m > 0): the bucket holds T scenario points one after another
// on the pool axis, fold_m pools each (a multiple of 128, so no block
// straddles two points), and point t's asset ids are offset by t * fold_n.
// A block copies only its own point's fold_n prices into shared memory and
// reads them at id - t * fold_n, so shared memory is fold_n values whatever
// T is.  An id outside the block's point (a padding slot) reads 0 before
// the mask; the folded ids and the segment sum keep the points apart.
//
// Merged (cfmm_fused_step_merged): one launch covers every bucket of one
// channel count K concatenated on the pool axis, one thread per pool; an
// int32 class per 128-pool block (0 gm, 1 floored gm, 2 cs), built on the
// host from the bucket boundaries, selects the block's projection.  The
// TPU kernel's scalar-prefetched tile table, 8-row tile rule and one-hot
// exchange have no counterpart here.
#include "projection.cuh"

namespace {

constexpr int kThreads = 128;

constexpr int kMaxBuckets = 8;
constexpr int kPtrs = 15;  // pointers per bucket in the C interface
constexpr int kDims = 4;   // ints per bucket: m, kind, fold_m, fold_n

template <typename T> struct Bucket {
  const T* sD;
  const T* sL;
  const int* asset;
  const T* R;
  const T* w;
  const T* s;
  const T* mask;
  const T* gamma;
  const T* logk0;
  const T* k0;
  T* sDn;
  T* sLn;
  T* D;
  T* L;
  T* val;
  int m, kind, fold_m, fold_n, first_block;
};

template <typename T> struct Table {
  Bucket<T> b[kMaxBuckets];
  int n;
};

// Slot e's raw inputs with the projection input built in place; sd / sl
// return the state the relaxation needs.
template <typename T>
__device__ __forceinline__ cfmm::SlotIn<T> load_slot(const Bucket<T>& d,
                                                     const T* v_sh, int base,
                                                     int n_sh, size_t e,
                                                     T& sd, T& sl) {
  cfmm::SlotIn<T> in;
  in.mask = d.mask[e];
  const int id = d.asset[e] - base;
  const T ve = (id >= 0 && id < n_sh ? v_sh[id] : T(0)) * in.mask;
  sd = d.sD[e];
  sl = d.sL[e];
  in.p = sd + ve;
  in.q = sl - ve;
  in.R = d.R[e];
  in.w = d.w[e];
  in.s = d.s[e];
  return in;
}

template <typename T>
__device__ __forceinline__ void store_slot(const Bucket<T>& d, size_t e,
                                           T alpha, T beta, T sd, T sl, T D,
                                           T L) {
  d.sDn[e] = alpha * D + beta * sd;
  d.sLn[e] = alpha * L + beta * sl;
  d.D[e] = D;
  d.L[e] = L;
  d.val[e] = alpha * (L - D) + beta * (sl - sd);
}

// The block's pools, from pool `first` of bucket d.
template <typename T, int LANES, int KIND>
__device__ __forceinline__ void run_block(const Bucket<T>& d, const T* v_sh,
                                          int base, int n_sh, int first,
                                          T alpha, T beta, int K,
                                          int n_bisect, int n_total) {
  if constexpr (LANES == 0) {  // K > 32: one thread per pool
    const int i = first + (int)threadIdx.x;
    if (i >= d.m) return;
    auto load = [&](int c) {
      T sd, sl;
      return load_slot(d, v_sh, base, n_sh, (size_t)c * d.m + i, sd, sl);
    };
    auto store = [&](int c, T D, T L) {
      const size_t e = (size_t)c * d.m + i;
      store_slot(d, e, alpha, beta, d.sD[e], d.sL[e], D, L);
    };
    cfmm::project_pool<T, 0, KIND>(load, K, d.gamma[i], d.logk0[i], d.k0[i],
                                   n_bisect, n_total, store);
  } else {
    const int i = first + (int)threadIdx.x / LANES;
    const int c = (int)threadIdx.x % LANES;
    const bool pool = i < d.m;
    const bool live = pool && c < K;
    const size_t e = (size_t)c * d.m + i;
    cfmm::SlotIn<T> in = cfmm::idle_in<T>();
    T sd = T(0), sl = T(0);
    if (live) in = load_slot(d, v_sh, base, n_sh, e, sd, sl);
    const T g = pool ? d.gamma[i] : T(1);
    const T logk0 = pool ? d.logk0[i] : T(0);
    const T k0 = pool ? d.k0[i] : T(1);
    T D, L;
    cfmm::project_slot<T, LANES, KIND>(in, K, g, logk0, k0, n_bisect, n_total,
                                       D, L);
    if (live) store_slot(d, e, alpha, beta, sd, sl, D, L);
  }
}

template <typename T, int LANES>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const __grid_constant__ Table<T> tab, const T* __restrict__ v,
               int n_pad, T alpha, T beta, int K, int n_bisect, int n_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v_sh = reinterpret_cast<T*>(smem_raw);
  constexpr int kPools = LANES > 0 ? kThreads / LANES : kThreads;
  const Bucket<T>& d = tab.b[cfmm::block_bucket(tab)];
  const int first = ((int)blockIdx.x - d.first_block) * kPools;
  const int base = d.fold_m > 0 ? first / d.fold_m * d.fold_n : 0;
  const int n_sh = d.fold_m > 0 ? d.fold_n : n_pad;
  for (int j = threadIdx.x; j < n_sh; j += kThreads) v_sh[j] = v[base + j];
  __syncthreads();
  switch (d.kind) {
    case cfmm::KIND_GM:
      run_block<T, LANES, cfmm::KIND_GM>(d, v_sh, base, n_sh, first, alpha,
                                         beta, K, n_bisect, n_total);
      break;
    case cfmm::KIND_GM_FLOOR:
      run_block<T, LANES, cfmm::KIND_GM_FLOOR>(d, v_sh, base, n_sh, first,
                                               alpha, beta, K, n_bisect,
                                               n_total);
      break;
    default:
      run_block<T, LANES, cfmm::KIND_CS>(d, v_sh, base, n_sh, first, alpha,
                                         beta, K, n_bisect, n_total);
      break;
  }
}

template <typename T, int LANES>
int launch_grouped(int K, int nb, int n_pad, double alpha, double beta,
                   const int* dims, const void* const* ptrs, const void* v,
                   int n_bisect, int n_total, cudaStream_t st) {
  constexpr int kPools = LANES > 0 ? kThreads / LANES : kThreads;
  static cfmm::SmemGuard smem_guard;
  Table<T> tab = {};
  tab.n = nb;
  int blocks = 0;
  int n_sh = 0;
  for (int j = 0; j < nb; ++j) {
    Bucket<T>& b = tab.b[j];
    const void* const* p = ptrs + (size_t)kPtrs * j;
    b.sD = (const T*)p[0];
    b.sL = (const T*)p[1];
    b.asset = (const int*)p[2];
    b.R = (const T*)p[3];
    b.w = (const T*)p[4];
    b.s = (const T*)p[5];
    b.mask = (const T*)p[6];
    b.gamma = (const T*)p[7];
    b.logk0 = (const T*)p[8];
    b.k0 = (const T*)p[9];
    b.sDn = (T*)p[10];
    b.sLn = (T*)p[11];
    b.D = (T*)p[12];
    b.L = (T*)p[13];
    b.val = (T*)p[14];
    const int* dm = dims + kDims * j;
    b.m = dm[0];
    b.kind = dm[1];
    b.fold_m = dm[2];
    b.fold_n = dm[3];
    if (b.m < 0 || b.kind < 0 || b.kind > 2) return (int)cudaErrorInvalidValue;
    if (b.fold_m > 0 &&
        (b.fold_m % kThreads != 0 || b.m % b.fold_m != 0 ||
         (size_t)(b.m / b.fold_m) * b.fold_n > (size_t)n_pad))
      return (int)cudaErrorInvalidValue;
    b.first_block = blocks;
    blocks += (b.m + kPools - 1) / kPools;
    const int n_b = b.fold_m > 0 ? b.fold_n : n_pad;
    if (n_b > n_sh) n_sh = n_b;
  }
  if (blocks == 0) return 0;
  const size_t smem = (size_t)n_sh * sizeof(T);
  const cudaError_t err = smem_guard.allow(grouped_kernel<T, LANES>, smem);
  if (err != cudaSuccess) return (int)err;
  grouped_kernel<T, LANES><<<blocks, kThreads, smem, st>>>(
      tab, (const T*)v, n_pad, (T)alpha, (T)beta, K, n_bisect, n_total);
  return (int)cudaGetLastError();
}

// The merged step's pool i (one thread per pool, the pool's K prepared
// slots in registers for K in {2, 4, 8, 16}).
template <typename T, int KC, int KIND>
__device__ __forceinline__ void fused_pool(
    int i, const T* __restrict__ sD, const T* __restrict__ sL,
    const int* __restrict__ asset, const T* __restrict__ R,
    const T* __restrict__ w, const T* __restrict__ s,
    const T* __restrict__ mask, const T* __restrict__ gamma,
    const T* __restrict__ logk0, const T* __restrict__ k0, const T* v_sh,
    T alpha, T beta, T* __restrict__ sDn, T* __restrict__ sLn,
    T* __restrict__ Dout, T* __restrict__ Lout, T* __restrict__ val, int K,
    int m, int n_pad, int n_bisect, int n_total) {
  auto load = [&](int c) {
    const size_t e = (size_t)c * m + i;
    cfmm::SlotIn<T> in;
    in.mask = mask[e];
    const int id = asset[e];
    const T ve = (id >= 0 && id < n_pad ? v_sh[id] : T(0)) * in.mask;
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

// The merged step: block b projects with the kind cls[b] (2 and any other
// value: constant sum; the solver builds the table from the bucket kinds).
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
merged_kernel(const int* __restrict__ cls, const T* __restrict__ sD,
              const T* __restrict__ sL, const int* __restrict__ asset,
              const T* __restrict__ R, const T* __restrict__ w,
              const T* __restrict__ s, const T* __restrict__ mask,
              const T* __restrict__ gamma, const T* __restrict__ logk0,
              const T* __restrict__ k0, const T* __restrict__ v, int n_pad,
              T alpha, T beta, T* __restrict__ sDn, T* __restrict__ sLn,
              T* __restrict__ Dout, T* __restrict__ Lout, T* __restrict__ val,
              int K, int m, int n_bisect, int n_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v_sh = reinterpret_cast<T*>(smem_raw);
  for (int j = threadIdx.x; j < n_pad; j += blockDim.x) v_sh[j] = v[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
#define CFMM_MERGED_POOL(KD)                                                   \
  fused_pool<T, KC, KD>(i, sD, sL, asset, R, w, s, mask, gamma, logk0, k0,     \
                        v_sh, alpha, beta, sDn, sLn, Dout, Lout, val, K, m,     \
                        n_pad, n_bisect, n_total)
  switch (cls[blockIdx.x]) {
    case cfmm::KIND_GM: CFMM_MERGED_POOL(cfmm::KIND_GM); break;
    case cfmm::KIND_GM_FLOOR: CFMM_MERGED_POOL(cfmm::KIND_GM_FLOOR); break;
    default: CFMM_MERGED_POOL(cfmm::KIND_CS); break;
  }
#undef CFMM_MERGED_POOL
}

}  // namespace

// One fused half-iteration over nb <= 8 buckets of K slots each, in one
// launch.  dims: nb x (m, kind, fold_m, fold_n) ints (kind 0 geo-mean, 1
// geo-mean with reserve floor, 2 constant sum; fold_m / fold_n: pools and
// prices per scenario point of a folded bucket, fold_m a multiple of 128
// dividing m and (m / fold_m) * fold_n <= n_pad, or 0 / 0 unfolded).
// ptrs: nb x 15 device pointers (sD sL asset R w s mask gamma logk0 k0,
// then the outputs sDn sLn D L val), planes contiguous (K, m), gamma,
// logk0 and k0 (m,), asset int32 ids in [0, n_pad).  v: (n_pad,) price
// vector.  alpha and beta = 1 - alpha are passed separately so the card
// and the plain version use the same rounded coefficients.  dtype: 0
// float, 1 double.  Returns the launch's cudaError_t.
extern "C" int cfmm_fused_step(int dtype, int K, int nb, int n_pad,
                               double alpha, double beta, const int* dims,
                               const void* const* ptrs, const void* v,
                               int n_bisect, int n_polish, void* stream) {
  if (nb < 1 || nb > kMaxBuckets) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_total = n_bisect + n_polish;
#define CFMM_LAUNCH_GROUPED(TT, LL)                                        \
  launch_grouped<TT, LL>(K, nb, n_pad, alpha, beta, dims, ptrs, v,        \
                         n_bisect, n_total, st)
  CFMM_DISPATCH_LANES(dtype, K, CFMM_LAUNCH_GROUPED)
#undef CFMM_LAUNCH_GROUPED
}

// One merged fused half-iteration over a K-group of m pools (m a multiple
// of 128): cls holds one int32 class per 128-pool block (0 gm, 1 floored gm,
// 2 cs); the other arguments as in cfmm_fused_step, unfolded.  Returns the
// launch's cudaError_t.
extern "C" int cfmm_fused_step_merged(int dtype, int K, int m, int n_pad,
                                      double alpha, double beta,
                                      const void* cls, const void* sD,
                                      const void* sL, const void* asset,
                                      const void* R, const void* w,
                                      const void* s, const void* mask,
                                      const void* gamma, const void* logk0,
                                      const void* k0, const void* v,
                                      void* sDn, void* sLn, void* D, void* L,
                                      void* val, int n_bisect, int n_polish,
                                      void* stream) {
  if (m <= 0) return 0;
  if (m % kThreads != 0 || K < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(m / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define CFMM_LAUNCH_MERGED(TT, KK)                                             \
  {                                                                            \
    static cfmm::SmemGuard smem_guard;                                         \
    const size_t smem = (size_t)n_pad * sizeof(TT);                            \
    err = smem_guard.allow(merged_kernel<TT, KK>, smem);                       \
    if (err != cudaSuccess) return (int)err;                                   \
    merged_kernel<TT, KK><<<grid, kThreads, smem, st>>>(                       \
        (const int*)cls, (const TT*)sD, (const TT*)sL, (const int*)asset,      \
        (const TT*)R, (const TT*)w, (const TT*)s, (const TT*)mask,             \
        (const TT*)gamma, (const TT*)logk0, (const TT*)k0, (const TT*)v,       \
        n_pad, (TT)alpha, (TT)beta, (TT*)sDn, (TT*)sLn, (TT*)D, (TT*)L,        \
        (TT*)val, K, m, n_bisect, n_bisect + n_polish);                        \
  }
#define CFMM_MERGED_K(TT)                                                      \
  switch (K) {                                                                 \
    case 2: CFMM_LAUNCH_MERGED(TT, 2); break;                                  \
    case 4: CFMM_LAUNCH_MERGED(TT, 4); break;                                  \
    case 8: CFMM_LAUNCH_MERGED(TT, 8); break;                                  \
    case 16: CFMM_LAUNCH_MERGED(TT, 16); break;                                \
    default: CFMM_LAUNCH_MERGED(TT, 0); break;                                 \
  }
  switch (dtype) {
    case 0: CFMM_MERGED_K(float); break;
    case 1: CFMM_MERGED_K(double); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CFMM_MERGED_K
#undef CFMM_LAUNCH_MERGED
  return (int)cudaGetLastError();
}
