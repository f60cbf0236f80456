// The classic ADMM iteration's stats-free form (AdmmSolver._iterate with
// with_stats=False and a linear objective), as the hand-written launches of
// a replayed block: one step kernel per K-group around the grouped
// projection, the group's segment sum (segment_sum.cu, unchanged), and one
// consensus kernel over the n assets.
//
// The classic iteration has no Pallas kernel: the JAX package runs it as
// one XLA program.  The port ran it as torch glue around the projection and
// segment-sum kernels, ~116 launches an iteration at 100k pools, most of
// them a few microseconds of elementwise work on a (K, m) plane or an
// n-vector; their gaps and their graph nodes, not the projection, set the
// iteration's time.  Here a block of iterations is, per iteration, one
// classic_step_kernel launch and one segment sum per K-group and one
// consensus_kernel launch.
//
// State.  An iteration's z update, z' = h +- (nu - mu)_e, is deferred into
// the next step's prologue, so no pass over the planes runs between
// iterations: a step reads the previous step's relaxed planes h and the
// O(n) vector dm = nu - mu that the consensus kernel wrote.  The block's
// first step reads the z it is given instead (h + 0 would not keep the
// sign of a zero), and after its last step classic_z_kernel materialises z
// once per K-group.  Per slot e of asset a, with xe = x[a] * mask for an
// (n,) vector x:
//
//   zD = hD + dme,  zL = hL - dme         (deferred steps; z as given first)
//   p  = zD - nue,  q = zL + nue,   (D, L) = Proj_T(p, q)
//   hD' = alpha D + beta zD,  hL' = alpha L + beta zL   (beta = 1 - alpha)
//   val = hL' - hD'                       (the slot's consensus term)
//
// and per asset j, with y the groups' segment sums added in group order:
//
//   s   = y - (2 d) nu,   psi = clip(s + ((1 / rho) 2 d') c, lo, hi)
//   mu  = (psi - s) / (2 d')   (d' = max(d, 1); psi = mu = 0 where d = 0)
//   dm  = nu - mu
//
// Every operation rounds as the torch op it replaces (same operands, same
// order, no FMA contraction: --fmad=false; NaN-propagating max and min as
// torch.maximum / torch.minimum; 2 / rho as torch computes a scalar over a
// tensor, a reciprocal times 2), so a block is bitwise equal to the glue it
// replaces.  val goes straight into the group's segment-sum input, the
// buckets' planes one after another in the group's name order.
//
// Bound: the projection's (operations and latency; projection.cuh).  A
// slot reads 7 values and writes 3 (the projection alone: 6 and 2), where
// the glue made ~18 passes over each bucket's planes.  nu and dm are staged
// in shared memory when they fit in 48 KB, else read from global memory.
//
// The C interface is bound with ctypes by ops/iteration_cuda.py.
#include "projection.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBuckets = 8;
constexpr int kMaxGroups = 32;
constexpr int kPtrs = 13;  // pointers per bucket in the C interface
constexpr int kDims = 2;   // ints per bucket: m, kind
constexpr size_t kSmem = 48 * 1024;

template <typename T> struct Bucket {
  const T* aD;  // z (the block's first step) or the previous step's h
  const T* aL;
  const int* asset;
  const T* R;
  const T* w;
  const T* s;
  const T* mask;
  const T* gamma;
  const T* logk0;
  const T* k0;
  T* hD;
  T* hL;
  T* val;
  int m, kind, first_block;
};

template <typename T> struct Table {
  Bucket<T> b[kMaxBuckets];
  int n;
};

// NaN-propagating max and min, as torch.maximum / torch.minimum.
__device__ __forceinline__ float fmx(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmx(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fmn(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmn(double a, double b) { return fmin(a, b); }
template <typename T> __device__ __forceinline__ T nan_max(T a, T b) {
  return a != a ? a : (b != b ? b : fmx(a, b));
}
template <typename T> __device__ __forceinline__ T nan_min(T a, T b) {
  return a != a ? a : (b != b ? b : fmn(a, b));
}

// Slot e's z (the deferred update applied) and its projection input.
template <typename T, int KIND, bool DEFER>
__device__ __forceinline__ cfmm::SlotIn<T> load_slot(const Bucket<T>& d,
                                                     const T* nu, const T* dm,
                                                     size_t e, T& zd, T& zl) {
  cfmm::SlotIn<T> in;
  in.mask = d.mask[e];
  const int id = d.asset[e];
  zd = d.aD[e];
  zl = d.aL[e];
  if (DEFER) {
    const T dme = dm[id] * in.mask;
    zd = zd + dme;
    zl = zl - dme;
  }
  const T nue = nu[id] * in.mask;
  in.p = zd - nue;
  in.q = zl + nue;
  in.R = d.R[e];
  in.w = d.w[e];
  in.s = KIND == cfmm::KIND_CS ? T(0) : d.s[e];
  return in;
}

template <typename T>
__device__ __forceinline__ void store_slot(const Bucket<T>& d, size_t e,
                                           T alpha, T beta, T zd, T zl, T D,
                                           T L) {
  const T hd = alpha * D + beta * zd;
  const T hl = alpha * L + beta * zl;
  d.hD[e] = hd;
  d.hL[e] = hl;
  d.val[e] = hl - hd;
}

// The block's pools, from pool `first` of bucket d.
template <typename T, int LANES, int KIND, bool DEFER>
__device__ __forceinline__ void run_block(const Bucket<T>& d, const T* nu,
                                          const T* dm, int first, T alpha,
                                          T beta, int K, int n_bisect,
                                          int n_total) {
  if constexpr (LANES == 0) {  // K > 32: one thread per pool
    const int i = first + (int)threadIdx.x;
    if (i >= d.m) return;
    auto load = [&](int c) {
      T zd, zl;
      return load_slot<T, KIND, DEFER>(d, nu, dm, (size_t)c * d.m + i, zd, zl);
    };
    auto store = [&](int c, T D, T L) {
      const size_t e = (size_t)c * d.m + i;
      T zd, zl;
      load_slot<T, KIND, DEFER>(d, nu, dm, e, zd, zl);
      store_slot(d, e, alpha, beta, zd, zl, D, L);
    };
    const T lk = KIND == cfmm::KIND_CS ? T(0) : d.logk0[i];
    cfmm::project_pool<T, KIND>(load, K, d.gamma[i], lk, d.k0[i], n_bisect,
                                n_total, store);
  } else {
    const int i = first + (int)threadIdx.x / LANES;
    const int c = (int)threadIdx.x % LANES;
    const bool pool = i < d.m;
    const bool live = pool && c < K;
    const size_t e = (size_t)c * d.m + i;
    cfmm::SlotIn<T> in = cfmm::idle_in<T>();
    T zd = T(0), zl = T(0);
    if (live) in = load_slot<T, KIND, DEFER>(d, nu, dm, e, zd, zl);
    const T g = pool ? d.gamma[i] : T(1);
    const T lk = pool && KIND != cfmm::KIND_CS ? d.logk0[i] : T(0);
    const T k0 = pool ? d.k0[i] : T(1);
    T D, L;
    cfmm::project_slot<T, LANES, KIND>(in, K, g, lk, k0, n_bisect, n_total, D,
                                       L);
    if (live) store_slot(d, e, alpha, beta, zd, zl, D, L);
  }
}

template <typename T, int LANES, bool DEFER>
__global__ void __launch_bounds__(kThreads)
classic_step_kernel(const __grid_constant__ Table<T> tab,
                    const T* __restrict__ nu, const T* __restrict__ dm, int n,
                    int n_sh, T alpha, T beta, int K, int n_bisect,
                    int n_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const T* nu_v = nu;
  const T* dm_v = dm;
  if (n_sh > 0) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      sh[j] = nu[j];
      if (DEFER) sh[n + j] = dm[j];
    }
    __syncthreads();
    nu_v = sh;
    dm_v = sh + n;
  }
  constexpr int kPools = LANES > 0 ? kThreads / LANES : kThreads;
  const Bucket<T>& d = tab.b[cfmm::block_bucket(tab)];
  const int first = ((int)blockIdx.x - d.first_block) * kPools;
  switch (d.kind) {
    case cfmm::KIND_GM:
      run_block<T, LANES, cfmm::KIND_GM, DEFER>(d, nu_v, dm_v, first, alpha,
                                                beta, K, n_bisect, n_total);
      break;
    case cfmm::KIND_GM_FLOOR:
      run_block<T, LANES, cfmm::KIND_GM_FLOOR, DEFER>(
          d, nu_v, dm_v, first, alpha, beta, K, n_bisect, n_total);
      break;
    default:
      run_block<T, LANES, cfmm::KIND_CS, DEFER>(d, nu_v, dm_v, first, alpha,
                                                beta, K, n_bisect, n_total);
      break;
  }
}

template <typename T, int LANES>
int launch_step(int K, int nb, int n, bool defer, double alpha, double beta,
                const int* dims, const void* const* ptrs, const void* nu,
                const void* dm, int n_bisect, int n_total, cudaStream_t st) {
  constexpr int kPools = LANES > 0 ? kThreads / LANES : kThreads;
  Table<T> tab = {};
  tab.n = nb;
  int blocks = 0;
  for (int j = 0; j < nb; ++j) {
    Bucket<T>& b = tab.b[j];
    const void* const* p = ptrs + (size_t)kPtrs * j;
    b.aD = (const T*)p[0];
    b.aL = (const T*)p[1];
    b.asset = (const int*)p[2];
    b.R = (const T*)p[3];
    b.w = (const T*)p[4];
    b.s = (const T*)p[5];
    b.mask = (const T*)p[6];
    b.gamma = (const T*)p[7];
    b.logk0 = (const T*)p[8];
    b.k0 = (const T*)p[9];
    b.hD = (T*)p[10];
    b.hL = (T*)p[11];
    b.val = (T*)p[12];
    b.m = dims[kDims * j];
    b.kind = dims[kDims * j + 1];
    if (b.m < 0 || b.kind < 0 || b.kind > 2) return (int)cudaErrorInvalidValue;
    if (b.kind != cfmm::KIND_CS && (b.s == nullptr || b.logk0 == nullptr))
      return (int)cudaErrorInvalidValue;
    b.first_block = blocks;
    blocks += (b.m + kPools - 1) / kPools;
  }
  if (blocks == 0) return 0;
  const size_t smem = (size_t)n * (defer ? 2 : 1) * sizeof(T);
  const int n_sh = smem <= kSmem ? n : 0;
  const size_t bytes = n_sh > 0 ? smem : 0;
  if (defer)
    classic_step_kernel<T, LANES, true><<<blocks, kThreads, bytes, st>>>(
        tab, (const T*)nu, (const T*)dm, n, n_sh, (T)alpha, (T)beta, K,
        n_bisect, n_total);
  else
    classic_step_kernel<T, LANES, false><<<blocks, kThreads, bytes, st>>>(
        tab, (const T*)nu, (const T*)dm, n, n_sh, (T)alpha, (T)beta, K,
        n_bisect, n_total);
  return (int)cudaGetLastError();
}

// ---- the block's epilogue: z = h +- dm_e, once per K-group --------------

template <typename T> struct ZBucket {
  const T* hD;
  const T* hL;
  const int* asset;
  const T* mask;
  T* zD;
  T* zL;
  int size, first_block;  // size: K * m slots
};

template <typename T> struct ZTable {
  ZBucket<T> b[kMaxBuckets];
  int n;
};

constexpr int kZThreads = 256;
constexpr int kZPtrs = 6;  // pointers per bucket in the C interface

template <typename T>
__global__ void __launch_bounds__(kZThreads)
classic_z_kernel(const __grid_constant__ ZTable<T> tab,
                 const T* __restrict__ dm) {
  const ZBucket<T>& d = tab.b[cfmm::block_bucket(tab)];
  const int e = ((int)blockIdx.x - d.first_block) * kZThreads + threadIdx.x;
  if (e >= d.size) return;
  const T dme = dm[d.asset[e]] * d.mask[e];
  d.zD[e] = d.hD[e] + dme;
  d.zL[e] = d.hL[e] - dme;
}

template <typename T>
int launch_z(int K, int nb, const int* dims, const void* const* ptrs,
             const void* dm, cudaStream_t st) {
  ZTable<T> tab = {};
  tab.n = nb;
  int blocks = 0;
  for (int j = 0; j < nb; ++j) {
    ZBucket<T>& b = tab.b[j];
    const void* const* p = ptrs + (size_t)kZPtrs * j;
    b.hD = (const T*)p[0];
    b.hL = (const T*)p[1];
    b.asset = (const int*)p[2];
    b.mask = (const T*)p[3];
    b.zD = (T*)p[4];
    b.zL = (T*)p[5];
    if (dims[j] < 0) return (int)cudaErrorInvalidValue;
    b.size = K * dims[j];
    b.first_block = blocks;
    blocks += (b.size + kZThreads - 1) / kZThreads;
  }
  if (blocks == 0) return 0;
  classic_z_kernel<T><<<blocks, kZThreads, 0, st>>>(tab, (const T*)dm);
  return (int)cudaGetLastError();
}

// ---- the consensus: y summed over the groups, the linear prox, mu, dm ----

template <typename T> struct YTable {
  const T* y[kMaxGroups];
  int n;
};

constexpr int kCThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCThreads)
consensus_kernel(const __grid_constant__ YTable<T> ys, int n,
                 const T* __restrict__ degree, const T* __restrict__ nu,
                 const T* __restrict__ c, const T* __restrict__ lo,
                 const T* __restrict__ hi, const T* __restrict__ rho,
                 T* __restrict__ mu_out, T* __restrict__ dm_out) {
  const int j = blockIdx.x * kCThreads + threadIdx.x;
  if (j >= n) return;
  T y = ys.y[0][j];
  for (int g = 1; g < ys.n; ++g) y = y + ys.y[g][j];
  const T d = degree[j];
  const T v = nu[j];
  const T s = y - (T(2) * d) * v;
  const T ds = nan_max(d, T(1));
  const T two_over_rho = (T(1) / rho[0]) * T(2);
  T psi = s + (two_over_rho * ds) * c[j];
  psi = nan_min(nan_max(psi, lo[j]), hi[j]);
  const bool touched = d > T(0);
  psi = touched ? psi : T(0);
  T mu = (psi - s) / (T(2) * ds);
  mu = touched ? mu : T(0);
  mu_out[j] = mu;
  dm_out[j] = v - mu;
}

template <typename T>
int launch_consensus(int ng, int n, const void* const* ys,
                     const void* const* vecs, cudaStream_t st) {
  YTable<T> tab = {};
  tab.n = ng;
  for (int g = 0; g < ng; ++g) tab.y[g] = (const T*)ys[g];
  if (n <= 0) return 0;
  consensus_kernel<T><<<(n + kCThreads - 1) / kCThreads, kCThreads, 0, st>>>(
      tab, n, (const T*)vecs[0], (const T*)vecs[1], (const T*)vecs[2],
      (const T*)vecs[3], (const T*)vecs[4], (const T*)vecs[5], (T*)vecs[6],
      (T*)vecs[7]);
  return (int)cudaGetLastError();
}

}  // namespace

// One stats-free classic step over nb <= 8 buckets of K slots each, in one
// launch.  dims: nb x (m, kind) ints (kind 0 geo-mean, 1 geo-mean with
// reserve floor, 2 constant sum).  ptrs: nb x 13 device pointers (aD aL
// asset R w s mask gamma logk0 k0, then the outputs hD hL val) of
// contiguous (K, m) planes and (m,) vectors; aD / aL are z when defer is 0
// and the previous step's h when it is 1; s and logk0 may be null for kind
// 2; asset int32 ids in [0, n); val points at the bucket's slice of the
// group's consensus-term buffer.  nu (and dm when defer is 1): (n,)
// vectors.  alpha and beta = 1 - alpha are passed separately, each exact in
// the working type.  dtype: 0 float, 1 double.  The arguments up to ptrs
// and the last three are cfmm_project's.  Returns the launch's
// cudaError_t.
extern "C" int cfmm_classic_step(int dtype, int K, int nb, const int* dims,
                                 const void* const* ptrs, int n, int defer,
                                 double alpha, double beta, const void* nu,
                                 const void* dm, int n_bisect, int n_polish,
                                 void* stream) {
  if (nb < 1 || nb > kMaxBuckets || n < 1 || (defer && dm == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_total = n_bisect + n_polish;
#define CFMM_LAUNCH_STEP(TT, LL)                                           \
  launch_step<TT, LL>(K, nb, n, defer != 0, alpha, beta, dims, ptrs, nu,  \
                      dm, n_bisect, n_total, st)
  CFMM_DISPATCH_LANES(dtype, K, CFMM_LAUNCH_STEP)
#undef CFMM_LAUNCH_STEP
}

// z = h +- dm_e for nb <= 8 buckets of K slots each, in one launch.  dims:
// nb pool counts m.  ptrs: nb x 6 device pointers (hD hL asset mask, then
// the outputs zD zL), contiguous (K, m) planes.  dm: the (n,) vector.
// Returns the launch's cudaError_t.
extern "C" int cfmm_classic_z(int dtype, int K, int nb, const int* dims,
                              const void* const* ptrs, const void* dm,
                              void* stream) {
  if (K < 0 || nb < 1 || nb > kMaxBuckets) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_z<float>(K, nb, dims, ptrs, dm, st);
    case 1: return launch_z<double>(K, nb, dims, ptrs, dm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The consensus of one classic step over n assets.  ys: ng <= 32 device
// pointers, the K-groups' (n,) segment sums in group order.  vecs: 8
// device pointers (degree nu c lo hi, rho a single value, then the outputs
// mu dm), (n,) vectors.  Returns the launch's cudaError_t.
extern "C" int cfmm_consensus(int dtype, int ng, int n, const void* const* ys,
                              const void* const* vecs, void* stream) {
  if (ng < 1 || ng > kMaxGroups) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_consensus<float>(ng, n, ys, vecs, st);
    case 1: return launch_consensus<double>(ng, n, ys, vecs, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
