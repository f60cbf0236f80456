// Standalone batched projection over a GROUP of buckets with the same slot
// count K, one launch: project_gm and project_cs, the projection of the
// classic ADMM iteration (AdmmSolver._iterate) and of ChunkedDriver's final
// pass.
//
// Replaces the Pallas kernels project_gm_pallas / project_cs_pallas
// (cfmm_routing_tpu/ops/projection_pallas.py:303, :319; _gm_kernel and
// _cs_kernel behind the pallas_call in _pallas_project, :285).  The math
// lives in projection.cuh.
//
// Bound on an H100: operations and latency (60 flops per slot per root-find
// step in the Pallas cost model, against 10-11 values per slot read or
// written once).  A thread that owned a pool would evaluate h(mu) ~30
// times walking its K slots one after another, a dependent chain that,
// more than the pool count, sets the time; a launch per bucket would pay
// each small bucket's latency tail in sequence.  The design, as in
// projection_delta.cu:
//
// * Lanes per slot (projection.cuh, project_slot): the power of two >= K
//   consecutive lanes own one pool, one slot each; h(mu)'s slot terms are
//   gathered with __shfl_sync in slot order and every lane runs the same
//   fixed-trip root-find, so the trades are bitwise equal to the plain
//   version's.  A block of 128 threads covers 128 / LANES pools.  K > 32
//   keeps one thread per pool (project_pool, run-time K).
// * One launch per K-group: a by-value (__grid_constant__) table of bucket
//   descriptors (the planes, m, kind, first block), built on the host from
//   arrays of pointers, so nothing is uploaded per call; a block finds its
//   bucket from blockIdx.x and switches on its kind, uniform within the
//   block.  At 100k pools a classic iteration projects in two launches
//   (K = 2: cs2f gm2 gm2f; K = 4: cs4f gm4) instead of five.
//
// The C interface is bound with ctypes by ops/projection_cuda.py.
#include "projection.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBuckets = 8;
constexpr int kPtrs = 11;  // pointers per bucket in the C interface
constexpr int kDims = 2;   // ints per bucket: m, kind

template <typename T> struct Bucket {
  const T* p;
  const T* q;
  const T* R;
  const T* w;
  const T* s;
  const T* mask;
  const T* gamma;
  const T* logk0;
  const T* k0;
  T* D;
  T* L;
  int m, kind, first_block;
};

template <typename T> struct Table {
  Bucket<T> b[kMaxBuckets];
  int n;
};

template <typename T, int KIND>
__device__ __forceinline__ cfmm::SlotIn<T> load_slot(const Bucket<T>& d,
                                                     size_t e) {
  cfmm::SlotIn<T> in;
  in.p = d.p[e];
  in.q = d.q[e];
  in.R = d.R[e];
  in.w = d.w[e];
  in.s = KIND == cfmm::KIND_CS ? T(0) : d.s[e];
  in.mask = d.mask[e];
  return in;
}

// The block's pools, from pool `first` of bucket d.
template <typename T, int LANES, int KIND>
__device__ __forceinline__ void run_block(const Bucket<T>& d, int first, int K,
                                          int n_bisect, int n_total) {
  if constexpr (LANES == 0) {  // K > 32: one thread per pool
    const int i = first + (int)threadIdx.x;
    if (i >= d.m) return;
    auto load = [&](int c) { return load_slot<T, KIND>(d, (size_t)c * d.m + i); };
    auto store = [&](int c, T D, T L) {
      const size_t e = (size_t)c * d.m + i;
      d.D[e] = D;
      d.L[e] = L;
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
    const cfmm::SlotIn<T> in =
        live ? load_slot<T, KIND>(d, e) : cfmm::idle_in<T>();
    const T g = pool ? d.gamma[i] : T(1);
    const T lk = pool && KIND != cfmm::KIND_CS ? d.logk0[i] : T(0);
    const T k0 = pool ? d.k0[i] : T(1);
    T D, L;
    cfmm::project_slot<T, LANES, KIND>(in, K, g, lk, k0, n_bisect, n_total, D,
                                       L);
    if (live) {
      d.D[e] = D;
      d.L[e] = L;
    }
  }
}

template <typename T, int LANES>
__global__ void __launch_bounds__(kThreads)
project_kernel(const __grid_constant__ Table<T> tab, int K, int n_bisect,
               int n_total) {
  constexpr int kPools = LANES > 0 ? kThreads / LANES : kThreads;
  const Bucket<T>& d = tab.b[cfmm::block_bucket(tab)];
  const int first = ((int)blockIdx.x - d.first_block) * kPools;
  switch (d.kind) {
    case cfmm::KIND_GM:
      run_block<T, LANES, cfmm::KIND_GM>(d, first, K, n_bisect, n_total);
      break;
    case cfmm::KIND_GM_FLOOR:
      run_block<T, LANES, cfmm::KIND_GM_FLOOR>(d, first, K, n_bisect,
                                               n_total);
      break;
    default:
      run_block<T, LANES, cfmm::KIND_CS>(d, first, K, n_bisect, n_total);
      break;
  }
}

template <typename T, int LANES>
int launch(int K, int nb, const int* dims, const void* const* ptrs,
           int n_bisect, int n_total, cudaStream_t st) {
  constexpr int kPools = LANES > 0 ? kThreads / LANES : kThreads;
  Table<T> tab = {};
  tab.n = nb;
  int blocks = 0;
  for (int j = 0; j < nb; ++j) {
    Bucket<T>& b = tab.b[j];
    const void* const* p = ptrs + (size_t)kPtrs * j;
    b.p = (const T*)p[0];
    b.q = (const T*)p[1];
    b.R = (const T*)p[2];
    b.w = (const T*)p[3];
    b.s = (const T*)p[4];
    b.mask = (const T*)p[5];
    b.gamma = (const T*)p[6];
    b.logk0 = (const T*)p[7];
    b.k0 = (const T*)p[8];
    b.D = (T*)p[9];
    b.L = (T*)p[10];
    b.m = dims[kDims * j];
    b.kind = dims[kDims * j + 1];
    if (b.m < 0 || b.kind < 0 || b.kind > 2) return (int)cudaErrorInvalidValue;
    if (b.kind != cfmm::KIND_CS && (b.s == nullptr || b.logk0 == nullptr))
      return (int)cudaErrorInvalidValue;
    b.first_block = blocks;
    blocks += (b.m + kPools - 1) / kPools;
  }
  if (blocks == 0) return 0;
  project_kernel<T, LANES><<<blocks, kThreads, 0, st>>>(tab, K, n_bisect,
                                                         n_total);
  return (int)cudaGetLastError();
}

}  // namespace

// The projection of nb <= 8 buckets of K slots each, in one launch.  dims:
// nb x (m, kind) ints (kind 0 geo-mean, 1 geo-mean with reserve floor, 2
// constant sum, whose reserve floor always applies).  ptrs: nb x 11 device
// pointers (p q R w s mask gamma logk0 k0, then the outputs D L) of
// contiguous (K, m) planes and (m,) vectors; s and logk0 may be null for
// kind 2.  dtype: 0 float, 1 double.  Returns the launch's cudaError_t (0
// on success).
extern "C" int cfmm_project(int dtype, int K, int nb, const int* dims,
                            const void* const* ptrs, int n_bisect,
                            int n_polish, void* stream) {
  if (nb < 1 || nb > kMaxBuckets) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_total = n_bisect + n_polish;
#define CFMM_LAUNCH_PROJECT(TT, LL) \
  launch<TT, LL>(K, nb, dims, ptrs, n_bisect, n_total, st)
  CFMM_DISPATCH_LANES(dtype, K, CFMM_LAUNCH_PROJECT)
#undef CFMM_LAUNCH_PROJECT
}
