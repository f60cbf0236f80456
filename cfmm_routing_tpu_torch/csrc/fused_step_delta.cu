// Fused ADMM half-iteration of the refinement stage over a GROUP of buckets
// with the same slot count K: gather, projection onto the SHIFTED trading
// sets and relaxation in one pass, one launch for the whole group.
//
// Replaces the Pallas kernel fused_step_delta (cfmm_routing_tpu/ops/
// iteration_pallas.py:602, _fused_delta_kernel, pallas_call :694), unfolded
// and folded.  Per pool:
//
//   ve  = v[asset] * mask,  off = ve - nu0e    (v = wdef - dnu, zero-padded;
//                                               nu0e the pre-broadcast,
//                                               pre-masked base dual)
//   p   = sD + off,  q = sL - off,   (A, B) = Proj_S(p, q)   (projection_delta.cuh)
//   sD' = a A + (1-a) sD,   sL' = a B + (1-a) sL
//   val = a (B - A) + (1-a) (sL - sD)   -> reduced per asset by segment_sum.cu
//
// Bound on an H100: operations and latency (80 flops per slot per
// root-find step in the Pallas cost model, against 14 planes of bytes; the
// bytes bound is about a tenth of it).  No matrix product, so no tensor
// cores; every input is read once, so no TMA staging.  What the design does:
//
// * Lanes per slot (projection_delta.cuh): LANES = the power of two >= K
//   consecutive lanes own one pool, one slot each, so the 100k network's
//   233,472 slots fill ~233k threads, not ~100k, and a thread keeps one
//   slot in registers.  A block of 128 threads covers 128 / LANES pools.
// * One launch per K-group: the kernel takes a by-value table of bucket
//   descriptors (planes, m, kind, fold_m / fold_n, first block) as its
//   parameter, built on the host from arrays of pointers: nothing is
//   uploaded per call.  A block finds its bucket from blockIdx.x and
//   switches on its kind, uniform within the block.  The 100k network's
//   five buckets take two launches (K = 2, K = 4) instead of five, and each
//   fills the card.
// * The sum order: each bucket writes its consensus terms into its slice of
//   the group's buffer; segment_sum.cu reduces the buffer over the group's
//   own slot order (built once per solver).  The projection adds the slot
//   terms in the plain loop's order, so the planes are bitwise equal to
//   the plain version's.
//
// As before the price vector is copied into shared memory once per block
// and read by index; no one-hot exchange and no atomics.  nu0e may be null
// (the bucket has no base-dual plane): it then reads as zero.  A folded
// bucket (fold_m > 0 pools per scenario point, a multiple of 128) stages
// only the block's own point's fold_n prices.
#include "projection_delta.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBuckets = 8;
constexpr int kPtrs = 17;  // pointers per bucket in the C interface
constexpr int kDims = 4;   // ints per bucket: m, kind, fold_m, fold_n

template <typename T> struct Bucket {
  const T* sD;
  const T* sL;
  const int* asset;
  const T* X0;
  const T* w;
  const T* sS;
  const T* aD;
  const T* aL;
  const T* mask;
  const T* nu0e;
  const T* gamma;
  const T* nsig;
  T* sDn;
  T* sLn;
  T* A;
  T* B;
  T* val;
  int m, kind, fold_m, fold_n, first_block;
};

template <typename T> struct Table {
  Bucket<T> b[kMaxBuckets];
  int n;
};

// Slot e's raw inputs, with the projection input built in place; sd / sl
// return the state the relaxation needs.
template <typename T>
__device__ __forceinline__ cfmm::DeltaIn<T> load_slot(const Bucket<T>& d,
                                                      const T* v_sh, int base,
                                                      int n_sh, size_t e,
                                                      T& sd, T& sl) {
  cfmm::DeltaIn<T> in;
  in.mask = d.mask[e];
  const int id = d.asset[e] - base;
  const T ve = (id >= 0 && id < n_sh ? v_sh[id] : T(0)) * in.mask;
  const T off = ve - (d.nu0e != nullptr ? d.nu0e[e] : T(0));
  sd = d.sD[e];
  sl = d.sL[e];
  in.p = sd + off;
  in.q = sl - off;
  in.X0 = d.X0[e];
  in.w = d.w[e];
  in.sS = d.sS[e];
  in.aD = d.aD[e];
  in.aL = d.aL[e];
  return in;
}

template <typename T>
__device__ __forceinline__ void store_slot(const Bucket<T>& d, size_t e,
                                           T alpha, T beta, T sd, T sl, T A,
                                           T B) {
  d.sDn[e] = alpha * A + beta * sd;
  d.sLn[e] = alpha * B + beta * sl;
  d.A[e] = A;
  d.B[e] = B;
  d.val[e] = alpha * (B - A) + beta * (sl - sd);
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
    auto store = [&](int c, T A, T B) {
      const size_t e = (size_t)c * d.m + i;
      store_slot(d, e, alpha, beta, d.sD[e], d.sL[e], A, B);
    };
    cfmm::project_pool_delta<T, KIND>(load, K, d.gamma[i], d.nsig[i],
                                      n_bisect, n_total, store);
  } else {
    const int i = first + (int)threadIdx.x / LANES;
    const int c = (int)threadIdx.x % LANES;
    const bool pool = i < d.m;
    const bool live = pool && c < K;
    const size_t e = (size_t)c * d.m + i;
    cfmm::DeltaIn<T> in = cfmm::idle_slot<T>();
    T sd = T(0), sl = T(0);
    if (live) in = load_slot(d, v_sh, base, n_sh, e, sd, sl);
    const T g = pool ? d.gamma[i] : T(1);
    const T nsig = pool ? d.nsig[i] : T(0);
    T A, B;
    cfmm::project_slot_delta<T, LANES, KIND>(in, K, g, nsig, n_bisect,
                                             n_total, A, B);
    if (live) store_slot(d, e, alpha, beta, sd, sl, A, B);
  }
}

template <typename T, int LANES>
__global__ void __launch_bounds__(kThreads)
fused_delta_kernel(const __grid_constant__ Table<T> tab,
                   const T* __restrict__ v, int n_pad, T alpha, T beta, int K,
                   int n_bisect, int n_total) {
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
int launch(int K, int nb, int n_pad, double alpha, double beta,
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
    b.X0 = (const T*)p[3];
    b.w = (const T*)p[4];
    b.sS = (const T*)p[5];
    b.aD = (const T*)p[6];
    b.aL = (const T*)p[7];
    b.mask = (const T*)p[8];
    b.nu0e = (const T*)p[9];
    b.gamma = (const T*)p[10];
    b.nsig = (const T*)p[11];
    b.sDn = (T*)p[12];
    b.sLn = (T*)p[13];
    b.A = (T*)p[14];
    b.B = (T*)p[15];
    b.val = (T*)p[16];
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
  const cudaError_t err = smem_guard.allow(fused_delta_kernel<T, LANES>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_delta_kernel<T, LANES><<<blocks, kThreads, smem, st>>>(
      tab, (const T*)v, n_pad, (T)alpha, (T)beta, K, n_bisect, n_total);
  return (int)cudaGetLastError();
}

}  // namespace

// One fused delta half-iteration over nb <= 8 buckets of K slots each, in
// one launch.  dims: nb x (m, kind, fold_m, fold_n) ints (kind 0 geo-mean,
// 1 geo-mean with reserve floor, 2 constant sum, whose floor always
// applies; fold_m / fold_n 0 / 0 unfolded).  ptrs: nb x 17 device
// pointers (sD sL asset X0 w sS aD aL mask nu0e gamma nsig, then the
// outputs sDn sLn A B val), planes contiguous (K, m), gamma and nsig (m,),
// asset int32 ids in [0, n_pad); nu0e may be null.  v: (n_pad,).  dtype:
// 0 float, 1 double.  Returns the launch's cudaError_t (0 on success).
extern "C" int cfmm_fused_step_delta(int dtype, int K, int nb, int n_pad,
                                     double alpha, double beta,
                                     const int* dims, const void* const* ptrs,
                                     const void* v, int n_bisect,
                                     int n_polish, void* stream) {
  if (nb < 1 || nb > kMaxBuckets) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_total = n_bisect + n_polish;
#define CFMM_LAUNCH_DELTA(TT, LL)                                          \
  launch<TT, LL>(K, nb, n_pad, alpha, beta, dims, ptrs, v, n_bisect,      \
                 n_total, st)
  CFMM_DISPATCH_LANES(dtype, K, CFMM_LAUNCH_DELTA)
#undef CFMM_LAUNCH_DELTA
}
