// Standalone batched delta projections over a GROUP of buckets with the
// same slot count K, one launch: project_gm_delta and project_cs_delta, the
// projection of the refinement stage's classic iteration
// (DeltaAdmmSolver._iterate) and of the residual-harvest step that closes
// every fused delta chunk.
//
// The JAX package runs these as plain jnp functions
// (cfmm_routing_tpu/ops/projection_delta.py:188 project_gm_delta, :237
// project_cs_delta), which XLA compiles into one program; the math is the
// delta projection of the Pallas kernel fused_step_delta
// (ops/iteration_pallas.py:602).  Eagerly, the plain PyTorch version issues
// some 2,500 small launches per bucket on the card.
//
// Bound on an H100: operations and latency, as projection_delta.cuh sets
// out (80 flops per slot per root-find step against 10 planes of bytes).
// No matrix product for tensor cores, nothing to stage with TMA.  The
// design:
//
// * Lanes per slot (projection_delta.cuh): the power of two >= K lanes own
//   one pool, one slot each; a block of 128 threads covers 128 / LANES
//   pools.
// * One launch per K-group: a by-value table of bucket descriptors (the
//   planes, m, kind, first block) is the kernel's parameter, built on the
//   host from arrays of pointers, so nothing is uploaded per call; a block
//   finds its bucket from blockIdx.x and switches on its kind, uniform
//   within the block.  At 100k pools a classic delta iteration projects in
//   two launches (K = 2: cs2f gm2 gm2f; K = 4: cs4f gm4) instead of five.
// * The slot terms of h(mu) are added in the plain loop's order, so the
//   trades are bitwise equal to the plain version's.
//
// The C interface is bound with ctypes by ops/projection_cuda.py.
#include "projection_delta.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBuckets = 8;
constexpr int kPtrs = 12;  // pointers per bucket in the C interface
constexpr int kDims = 2;   // ints per bucket: m, kind

template <typename T> struct Bucket {
  const T* p;
  const T* q;
  const T* X0;
  const T* w;
  const T* sS;
  const T* aD;
  const T* aL;
  const T* mask;
  const T* gamma;
  const T* nsig;
  T* A;
  T* B;
  int m, kind, first_block;
};

template <typename T> struct Table {
  Bucket<T> b[kMaxBuckets];
  int n;
};

template <typename T, int KIND>
__device__ __forceinline__ cfmm::DeltaIn<T> load_slot(const Bucket<T>& d,
                                                      size_t e) {
  cfmm::DeltaIn<T> in;
  in.p = d.p[e];
  in.q = d.q[e];
  in.X0 = d.X0[e];
  in.w = d.w[e];
  in.sS = KIND == cfmm::KIND_CS ? T(0) : d.sS[e];
  in.aD = d.aD[e];
  in.aL = d.aL[e];
  in.mask = d.mask[e];
  return in;
}

template <typename T, int LANES, int KIND>
__device__ __forceinline__ void run_block(const Bucket<T>& d, int first, int K,
                                          int n_bisect, int n_total) {
  if constexpr (LANES == 0) {  // K > 32: one thread per pool
    const int i = first + (int)threadIdx.x;
    if (i >= d.m) return;
    auto load = [&](int c) { return load_slot<T, KIND>(d, (size_t)c * d.m + i); };
    auto store = [&](int c, T A, T B) {
      const size_t e = (size_t)c * d.m + i;
      d.A[e] = A;
      d.B[e] = B;
    };
    cfmm::project_pool_delta<T, KIND>(load, K, d.gamma[i], d.nsig[i],
                                      n_bisect, n_total, store);
  } else {
    const int i = first + (int)threadIdx.x / LANES;
    const int c = (int)threadIdx.x % LANES;
    const bool pool = i < d.m;
    const bool live = pool && c < K;
    const size_t e = (size_t)c * d.m + i;
    const cfmm::DeltaIn<T> in =
        live ? load_slot<T, KIND>(d, e) : cfmm::idle_slot<T>();
    const T g = pool ? d.gamma[i] : T(1);
    const T nsig = pool ? d.nsig[i] : T(0);
    T A, B;
    cfmm::project_slot_delta<T, LANES, KIND>(in, K, g, nsig, n_bisect,
                                             n_total, A, B);
    if (live) {
      d.A[e] = A;
      d.B[e] = B;
    }
  }
}

template <typename T, int LANES>
__global__ void __launch_bounds__(kThreads)
project_delta_kernel(const __grid_constant__ Table<T> tab, int K,
                     int n_bisect, int n_total) {
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
    b.X0 = (const T*)p[2];
    b.w = (const T*)p[3];
    b.sS = (const T*)p[4];
    b.aD = (const T*)p[5];
    b.aL = (const T*)p[6];
    b.mask = (const T*)p[7];
    b.gamma = (const T*)p[8];
    b.nsig = (const T*)p[9];
    b.A = (T*)p[10];
    b.B = (T*)p[11];
    b.m = dims[kDims * j];
    b.kind = dims[kDims * j + 1];
    if (b.m < 0 || b.kind < 0 || b.kind > 2) return (int)cudaErrorInvalidValue;
    if (b.kind != cfmm::KIND_CS && b.sS == nullptr)
      return (int)cudaErrorInvalidValue;
    b.first_block = blocks;
    blocks += (b.m + kPools - 1) / kPools;
  }
  if (blocks == 0) return 0;
  project_delta_kernel<T, LANES><<<blocks, kThreads, 0, st>>>(
      tab, K, n_bisect, n_total);
  return (int)cudaGetLastError();
}

}  // namespace

// The delta projection of nb <= 8 buckets of K slots each, in one launch.
// dims: nb x (m, kind) ints (kind 0 geo-mean, 1 geo-mean with reserve
// floor, 2 constant sum, whose reserve floor always applies).  ptrs: nb x
// 12 device pointers (p q X0 w sS aD aL mask gamma nsig, then the outputs
// A B) of contiguous (K, m) planes and (m,) vectors; sS may be null for
// kind 2.  dtype: 0 float, 1 double.  Returns the launch's cudaError_t
// (0 on success).
extern "C" int cfmm_project_delta(int dtype, int K, int nb, const int* dims,
                                  const void* const* ptrs, int n_bisect,
                                  int n_polish, void* stream) {
  if (nb < 1 || nb > kMaxBuckets) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_total = n_bisect + n_polish;
#define CFMM_LAUNCH_PROJECT_DELTA(TT, LL) \
  launch<TT, LL>(K, nb, dims, ptrs, n_bisect, n_total, st)
  CFMM_DISPATCH_LANES(dtype, K, CFMM_LAUNCH_PROJECT_DELTA)
#undef CFMM_LAUNCH_PROJECT_DELTA
}
