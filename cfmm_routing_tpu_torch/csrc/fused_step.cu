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
//   descriptors (planes, m, kind, fold_m / fold_n, plane stride ld, first
//   block), built on the host from arrays of pointers; a block finds its
//   bucket from blockIdx.x and switches on its kind, uniform within the
//   block.  Each bucket writes its consensus terms into its slice of the
//   group's buffer, which one segment sum reduces over the group's slot
//   order.  The 100k network's five buckets take two launches and two
//   segment sums (K = 2, K = 4), folded or not.
//
// Folded (fold_m > 0): the bucket holds T scenario points one after another
// on the pool axis, fold_m pools each (a multiple of 128, so no block
// straddles two points), and point t's asset ids are offset by t * fold_n.
// A block copies only its own point's fold_n prices into shared memory and
// reads them at id - t * fold_n, so shared memory is fold_n values whatever
// T is.  An id outside the block's point (a padding slot) reads 0 before
// the mask; the folded ids and the segment sum keep the points apart.
//
// Merged (cfmm_fused_step_merged): every bucket of one channel count K laid
// end to end on one pool axis, (K, M) planes.  The launch is the grouped
// kernel over one descriptor per class span (a run of pools of one kind,
// starting at a multiple of 128 pools): the span's pointers are the merged
// planes advanced by its first pool, its m the span's pool count and its
// plane stride ld = M, so slot (c, i) of the span is element c * M + i of
// the merged plane.  Its outputs go into the group's own (K, M) planes,
// which the group's segment sum reduces.  The TPU kernel's scalar-prefetched
// tile table and 8-row tile rule have no counterpart here; the class of each
// pool is read on the host, once per group.
#include "projection.cuh"

namespace {

constexpr int kThreads = 128;

constexpr int kMaxBuckets = 8;
constexpr int kPtrs = 15;  // pointers per bucket in the C interface
constexpr int kDims = 5;   // ints per bucket: m, kind, fold_m, fold_n, ld

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
  int m, kind, fold_m, fold_n, ld, first_block;  // slot (c, i): c * ld + i
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
      return load_slot(d, v_sh, base, n_sh, (size_t)c * d.ld + i, sd, sl);
    };
    auto store = [&](int c, T D, T L) {
      const size_t e = (size_t)c * d.ld + i;
      store_slot(d, e, alpha, beta, d.sD[e], d.sL[e], D, L);
    };
    cfmm::project_pool<T, KIND>(load, K, d.gamma[i], d.logk0[i], d.k0[i],
                                n_bisect, n_total, store);
  } else {
    const int i = first + (int)threadIdx.x / LANES;
    const int c = (int)threadIdx.x % LANES;
    const bool pool = i < d.m;
    const bool live = pool && c < K;
    const size_t e = (size_t)c * d.ld + i;
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

// Point descriptor b at 15 device pointers (sD sL asset R w s mask gamma
// logk0 k0, then the outputs sDn sLn D L val), each advanced by off
// elements.
template <typename T>
void set_pointers(Bucket<T>& b, const void* const* p, size_t off) {
  b.sD = (const T*)p[0] + off;
  b.sL = (const T*)p[1] + off;
  b.asset = (const int*)p[2] + off;
  b.R = (const T*)p[3] + off;
  b.w = (const T*)p[4] + off;
  b.s = (const T*)p[5] + off;
  b.mask = (const T*)p[6] + off;
  b.gamma = (const T*)p[7] + off;
  b.logk0 = (const T*)p[8] + off;
  b.k0 = (const T*)p[9] + off;
  b.sDn = (T*)p[10] + off;
  b.sLn = (T*)p[11] + off;
  b.D = (T*)p[12] + off;
  b.L = (T*)p[13] + off;
  b.val = (T*)p[14] + off;
}

// Check the table's descriptors, number their blocks and launch.
template <typename T, int LANES>
int launch_table(Table<T>& tab, int K, int n_pad, double alpha, double beta,
                 const void* v, int n_bisect, int n_total, cudaStream_t st) {
  constexpr int kPools = LANES > 0 ? kThreads / LANES : kThreads;
  static cfmm::SmemGuard smem_guard;
  int blocks = 0;
  int n_sh = 0;
  for (int j = 0; j < tab.n; ++j) {
    Bucket<T>& b = tab.b[j];
    if (b.m < 0 || b.ld < b.m || b.kind < 0 || b.kind > 2)
      return (int)cudaErrorInvalidValue;
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

template <typename T, int LANES>
int launch_grouped(int K, int nb, int n_pad, double alpha, double beta,
                   const int* dims, const void* const* ptrs, const void* v,
                   int n_bisect, int n_total, cudaStream_t st) {
  Table<T> tab = {};
  tab.n = nb;
  for (int j = 0; j < nb; ++j) {
    Bucket<T>& b = tab.b[j];
    set_pointers(b, ptrs + (size_t)kPtrs * j, 0);
    const int* dm = dims + kDims * j;
    b.m = dm[0];
    b.kind = dm[1];
    b.fold_m = dm[2];
    b.fold_n = dm[3];
    b.ld = dm[4];
  }
  return launch_table<T, LANES>(tab, K, n_pad, alpha, beta, v, n_bisect,
                                n_total, st);
}

// One descriptor per class span of a merged group of M pools: the spans
// must tile [0, M) in order, each starting at a multiple of 128 pools.
template <typename T, int LANES>
int launch_merged(int K, int M, int ns, int n_pad, double alpha, double beta,
                  const int* spans, const void* const* ptrs, const void* v,
                  int n_bisect, int n_total, cudaStream_t st) {
  Table<T> tab = {};
  tab.n = ns;
  int next = 0;
  for (int j = 0; j < ns; ++j) {
    const int start = spans[3 * j], stop = spans[3 * j + 1];
    if (start != next || start % kThreads != 0 || stop <= start || stop > M)
      return (int)cudaErrorInvalidValue;
    Bucket<T>& b = tab.b[j];
    set_pointers(b, ptrs, (size_t)start);
    b.m = stop - start;
    b.kind = spans[3 * j + 2];
    b.ld = M;
    next = stop;
  }
  if (next != M) return (int)cudaErrorInvalidValue;
  return launch_table<T, LANES>(tab, K, n_pad, alpha, beta, v, n_bisect,
                                n_total, st);
}

}  // namespace

// One fused half-iteration over nb <= 8 buckets of K slots each, in one
// launch.  dims: nb x (m, kind, fold_m, fold_n, ld) ints (kind 0 geo-mean,
// 1 geo-mean with reserve floor, 2 constant sum; fold_m / fold_n: pools and
// prices per scenario point of a folded bucket, fold_m a multiple of 128
// dividing m and (m / fold_m) * fold_n <= n_pad, or 0 / 0 unfolded; ld >= m
// the plane stride, m for a bucket's own planes).  ptrs: nb x 15 device
// pointers (sD sL asset R w s mask gamma logk0 k0, then the outputs sDn sLn
// D L val), planes (K, ld) of which the first m columns are the bucket's,
// gamma, logk0 and k0 (m,), asset int32 ids in [0, n_pad).  v: (n_pad,)
// price vector.  alpha and beta = 1 - alpha are passed separately so the
// card and the plain version use the same rounded coefficients.  dtype: 0
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

// One merged fused half-iteration over a K-group of M pools, in one launch
// of the grouped kernel.  spans: ns <= 8 x (start, stop, kind) ints, the
// group's runs of one kind in order, tiling [0, M), each start a multiple
// of 128.  ptrs: the 15 pointers of cfmm_fused_step for the whole group,
// planes (K, M), gamma, logk0 and k0 (M,).  The other arguments as in
// cfmm_fused_step, unfolded.  Returns the launch's cudaError_t.
extern "C" int cfmm_fused_step_merged(int dtype, int K, int M, int ns,
                                      int n_pad, double alpha, double beta,
                                      const int* spans,
                                      const void* const* ptrs, const void* v,
                                      int n_bisect, int n_polish,
                                      void* stream) {
  if (ns < 1 || ns > kMaxBuckets) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_total = n_bisect + n_polish;
#define CFMM_LAUNCH_MERGED(TT, LL)                                         \
  launch_merged<TT, LL>(K, M, ns, n_pad, alpha, beta, spans, ptrs, v,     \
                        n_bisect, n_total, st)
  CFMM_DISPATCH_LANES(dtype, K, CFMM_LAUNCH_MERGED)
#undef CFMM_LAUNCH_MERGED
}
