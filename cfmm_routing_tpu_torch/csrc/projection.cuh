// Shared device projection onto CFMM trading sets: one thread per pool
// (project_pool) or lanes per slot (project_slot).
//
// Replaces the projection math of the JAX package's Pallas kernels
// (cfmm_routing_tpu/ops/projection_pallas.py: _inner_gm, _solve_theta_linear,
// the gm and cs brackets, _eval_gm_channels / _eval_cs_channels and
// _root_find_body).  The same header serves the standalone projection
// kernel (projection.cu) and the fused ADMM step (fused_step.cu); the
// delta projection of the refinement stage (projection_delta.cuh) reuses
// its root-find and helpers.
//
// Layout: every bucket is slot-major (K, m).  Two forms:
//   * project_slot (the lanes-per-slot section below), which the grouped
//     kernels run (the standalone projection and the fused step, K <= 32):
//     LANES lanes own one pool, one slot each, and gather h(mu)'s slot
//     terms by shuffles in slot order, so a thread keeps one prepared slot
//     (15 values) instead of K;
//   * project_pool: a thread owns one pool, so loads of one slot plane are
//     coalesced across the warp; the grouped kernels run it above K = 32
//     (K given at run time).  Every evaluation of h(mu) walks the pool's
//     slots again, reading them from global memory (L1/L2-resident after
//     the first pass) and recomputing their mu-free terms.  A kernel hands
//     project_pool a loader load(c) -> SlotIn (the slot's raw inputs) and a
//     store(c, D, L) callback, so the fused step can gather its input and
//     write its outputs in place.
//
// Bound: compute.  Each pool evaluates h(mu) n_bisect + n_polish + 2 times;
// every evaluation costs per slot a square root, a logarithm (geo-mean) or a
// handful of selects (constant sum), against 10-11 values read and written
// once per slot.  The design therefore hoists everything that does not
// depend on mu out of the root-find: the clip breakpoints G(b1), G(b2), each
// clip region's quadratic coefficients and the reserve-floor multiplier are
// computed once per slot, and one evaluation is a region select, one sqrt,
// at most one division and one log per slot.
//
// Numerics follow the plain PyTorch version (ops/projection.py) in both
// float and double: the tiny constants are FLT_MIN / DBL_MIN and the log
// clamp is 1e-30 / 1e-300.  IEEE sqrt, division and log (no fast math).
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace cfmm {

enum Kind { KIND_GM = 0, KIND_GM_FLOOR = 1, KIND_CS = 2 };

// Dynamic shared memory above 48 KB must be allowed per kernel and per
// device.  A launcher keeps one SmemGuard per kernel, which sets the
// attribute once per device and size, so a launch captured in a CUDA graph
// makes no call but the launch (cudaGetDevice only reads the host thread's
// current device).
struct SmemGuard {
  static constexpr int kDevices = 64;
  size_t allowed[kDevices] = {};
  template <typename F>
  cudaError_t allow(F* kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
    if (smem <= allowed[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) allowed[dev] = smem;
    return err;
  }
};

template <typename T> struct Lim;
template <> struct Lim<float> {
  __device__ static __forceinline__ float tiny() { return FLT_MIN; }
  __device__ static __forceinline__ float log_floor() { return 1e-30f; }
};
template <> struct Lim<double> {
  __device__ static __forceinline__ double tiny() { return DBL_MIN; }
  __device__ static __forceinline__ double log_floor() { return 1e-300; }
};

__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double dlog1p(double x) { return log1p(x); }
__device__ __forceinline__ float dexpm1(float x) { return expm1f(x); }
__device__ __forceinline__ double dexpm1(double x) { return expm1(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

template <typename T> __device__ __forceinline__ T relu(T x) {
  return x > T(0) ? x : T(0);
}
template <typename T> __device__ __forceinline__ T tmin(T a, T b) {
  return b < a ? b : a;
}
template <typename T> __device__ __forceinline__ T tmax(T a, T b) {
  return b > a ? b : a;
}
template <typename T> __device__ __forceinline__ T tabs(T a) {
  return a < T(0) ? -a : a;
}

// Positive root of xi^2 - a*xi - c = 0 (c >= 0), cancellation-safe.
template <typename T>
__device__ __forceinline__ T stable_quad_root(T a, T c) {
  const T sq = dsqrt(a * a + T(4) * c);
  return a > T(0) ? T(0.5) * (a + sq)
                  : (T(2) * c) / tmax(sq - a, Lim<T>::tiny());
}

// The raw inputs of one slot.  s is unused for constant-sum pools.
template <typename T> struct SlotIn {
  T p, q, R, w, s, mask;
};

// xi(theta) = Rp + gamma*relu(p + gamma*theta) - relu(q - theta)
template <typename T>
__device__ __forceinline__ T xi_of_theta(T p, T q, T Rp, T g, T th) {
  return Rp + g * relu(p + g * th) - relu(q - th);
}

// Quadratic coefficients of the clip region that contains rep.
template <typename T>
__device__ __forceinline__ void clip_coeffs(T p, T q, T Rp, T g, T rep, T& a,
                                            T& bb) {
  const bool dclip = (p + g * rep) < T(0);
  const bool lclip = (q - rep) < T(0);
  a = dclip ? (lclip ? Rp : Rp - q) : (lclip ? Rp + g * p : Rp + g * p - q);
  bb = dclip ? (lclip ? T(0) : T(1)) : (lclip ? g * g : T(1) + g * g);
}

// Smallest theta with xi(theta) == target (piecewise linear).
template <typename T>
__device__ __forceinline__ T solve_theta_linear(T p, T q, T Rp, T g, T target) {
  const T g2 = g * g;
  const T th1 = relu(-p / g);
  const T th2 = relu(q);
  const T b1 = tmin(th1, th2);
  const T b2 = tmax(th1, th2);
  const bool in_r1 = xi_of_theta(p, q, Rp, g, b1) >= target;
  const bool in_r2 = !in_r1 && xi_of_theta(p, q, Rp, g, b2) >= target;
  const T rep = in_r1 ? T(0.5) * b1 : (in_r2 ? T(0.5) * (b1 + b2) : b2 + T(1));
  const bool dclip = (p + g * rep) < T(0);
  const bool lclip = (q - rep) < T(0);
  const T thA = (target - Rp - g * p + q) / (T(1) + g2);
  const T thB = (target - Rp - g * p) / g2;
  const T thC = target - Rp + q;
  const T thD = T(0.5) * (th1 + th2);
  const T th = dclip ? (lclip ? thD : thC) : (lclip ? thB : thA);
  return relu(th);
}

// One geo-mean slot with everything that does not depend on mu.
template <typename T> struct GmSlot {
  T p, q, w, s, mask;
  T G1, G2, xi0, thf;
  T a0, a1, a2, c0, c1, c2;
};

template <typename T>
__device__ __forceinline__ GmSlot<T> gm_prep(const SlotIn<T>& in, T g,
                                             bool floor) {
  GmSlot<T> sl;
  const T p = in.p, q = in.q;
  const T Rp = in.R + in.s;
  sl.p = p; sl.q = q; sl.w = in.w; sl.s = in.s; sl.mask = in.mask;
  const T th1 = relu(-p / g);
  const T th2 = relu(q);
  const T b1 = tmin(th1, th2);
  const T b2 = tmax(th1, th2);
  sl.G1 = b1 * xi_of_theta(p, q, Rp, g, b1);
  sl.G2 = b2 * xi_of_theta(p, q, Rp, g, b2);
  sl.xi0 = xi_of_theta(p, q, Rp, g, T(0));
  clip_coeffs(p, q, Rp, g, T(0.5) * b1, sl.a0, sl.c0);
  clip_coeffs(p, q, Rp, g, T(0.5) * (b1 + b2), sl.a1, sl.c1);
  clip_coeffs(p, q, Rp, g, b2 + T(1), sl.a2, sl.c2);
  sl.thf = floor ? solve_theta_linear(p, q, Rp, g, in.s) : T(0);
  return sl;
}

// Closed-form solve of xi = xi(theta), theta = t / xi.
template <typename T>
__device__ __forceinline__ T inner_gm(const GmSlot<T>& sl, T t) {
  const bool in_r1 = (sl.G1 - t) >= T(0);
  const bool in_r2 = !in_r1 && (sl.G2 - t) >= T(0);
  const T a = in_r1 ? sl.a0 : (in_r2 ? sl.a1 : sl.a2);
  const T bb = in_r1 ? sl.c0 : (in_r2 ? sl.c1 : sl.c2);
  const T xi = stable_quad_root(a, bb * t);
  return t > Lim<T>::tiny() ? xi : sl.xi0;
}

// One constant-sum slot; thf drives the post-trade reserve to 0.
template <typename T> struct CsSlot {
  T p, q, R, w, mask, thf;
};

template <typename T>
__device__ __forceinline__ CsSlot<T> cs_prep(const SlotIn<T>& in, T g) {
  CsSlot<T> sl;
  sl.p = in.p; sl.q = in.q; sl.R = in.R; sl.w = in.w; sl.mask = in.mask;
  sl.thf = solve_theta_linear(in.p, in.q, in.R, g, T(0));
  return sl;
}

template <typename T>
__device__ __forceinline__ void cs_dl(const CsSlot<T>& sl, T g, T mu, T& D,
                                      T& L) {
  T theta = mu * sl.w;
  const T D0 = relu(sl.p + g * theta);
  const T L0 = relu(sl.q - theta);
  if (sl.R + g * D0 - L0 < T(0)) theta = tmax(sl.thf, theta);
  D = relu(sl.p + g * theta) * sl.mask;
  L = relu(sl.q - theta) * sl.mask;
}

// Fixed-trip bisection + regula-falsi on monotone h(mu) = target; returns
// mu on the feasible side (h >= target).
template <typename T, class H>
__device__ __forceinline__ T root_find(const H& h_of_mu, T mu_hi, T target,
                                       int n_bisect, int n_total) {
  const T h0 = h_of_mu(T(0));
  const bool feasible0 = h0 >= target;
  T lo = T(0);
  T hi = feasible0 ? T(0) : mu_hi;
  T hlo = h0;
  T hhi = h_of_mu(hi);
  for (int i = 0; i < n_total; ++i) {
    T frac = T(0.5);
    if (i >= n_bisect) {
      const T denom = hhi - hlo;
      const T falsi =
          tabs(denom) > Lim<T>::tiny() ? (target - hlo) / denom : T(0.5);
      frac = tmin(tmax(falsi, T(0.05)), T(0.95));
    }
    const T mid = lo + frac * (hi - lo);
    const T hm = h_of_mu(mid);
    if (hm < target) {
      lo = mid;
      hlo = hm;
    } else {
      hi = mid;
      hhi = hm;
    }
  }
  return feasible0 ? T(0) : hi;
}

// Project one pool's K slots (p, q) onto its trading set.  load(c) returns
// slot c's SlotIn, and is called again at every evaluation of h(mu);
// store(c, D, L) receives the projected trades.
template <typename T, int KIND, class Load, class Store>
__device__ __forceinline__ void project_pool(const Load& load, int K, T g,
                                             T logk0, T k0, int n_bisect,
                                             int n_total, const Store& store) {
  if constexpr (KIND == KIND_CS) {
    T mu_hi = T(0);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const SlotIn<T> in = load(c);
      const T w_safe = in.mask > T(0) ? in.w : T(1);
      const T cand = relu(in.q) * in.mask / w_safe;
      mu_hi = c == 0 ? cand : tmax(mu_hi, cand);
    }
    mu_hi = mu_hi + T(1);
    auto get = [&](int c) { return cs_prep(load(c), g); };
    auto h_of_mu = [&](T mu) {
      T h = T(0);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const CsSlot<T> sl = get(c);
        T D, L;
        cs_dl(sl, g, mu, D, L);
        const T x = tmax(sl.R + g * D - L, T(0)) * sl.mask;
        h = h + sl.w * x;
      }
      return h;
    };
    const T mu = root_find(h_of_mu, mu_hi, k0, n_bisect, n_total);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      T D, L;
      cs_dl(get(c), g, mu, D, L);
      store(c, D, L);
    }
  } else {
    constexpr bool FLOOR = KIND == KIND_GM_FLOOR;
    T mu_hi = T(0);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const SlotIn<T> in = load(c);
      const T Rp = in.R + in.s;
      const T qp = relu(in.q) + T(1e-3);
      const T need_t = tmax(T(2) * qp * (Rp + g * relu(in.p)),
                            T(4) * qp * qp * g * g);
      const T w_safe = in.mask > T(0) ? in.w : T(1);
      const T cand = in.mask > T(0)
                         ? need_t / (w_safe * tmax(k0, Lim<T>::tiny()))
                         : T(0);
      mu_hi = c == 0 ? cand : tmax(mu_hi, cand);
    }
    mu_hi = T(4) * mu_hi + T(1);
    auto get = [&](int c) { return gm_prep(load(c), g, FLOOR); };
    auto h_of_mu = [&](T mu) {
      T h = T(0);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const GmSlot<T> sl = get(c);
        const T t = mu * sl.w * k0;
        T xi = inner_gm(sl, t);
        if (FLOOR && xi < sl.s) xi = sl.s;
        h = h + sl.w * dlog(tmax(xi, Lim<T>::log_floor()));
      }
      return h;
    };
    const T mu = root_find(h_of_mu, mu_hi, logk0, n_bisect, n_total);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const GmSlot<T> sl = get(c);
      const T t = mu * sl.w * k0;
      const T xi = inner_gm(sl, t);
      T theta = t / tmax(xi, Lim<T>::tiny());
      if (FLOOR && xi < sl.s) theta = tmax(sl.thf, theta);
      store(c, relu(sl.p + g * theta) * sl.mask, relu(sl.q - theta) * sl.mask);
    }
  }
}

// ---- lanes per slot ---------------------------------------------------------
// LANES consecutive lanes of a warp own one pool, lane c slot c (LANES the
// power of two >= K, up to 32).  Each lane prepares and keeps only its own
// slot; every evaluation of h(mu) computes the lane's slot term and the
// pool's lanes gather the terms with __shfl_sync in slot order, so the sum
// rounds as the plain loop's; every lane then runs the identical fixed-trip
// root-find.  Idle lanes (slot >= K) and pools past a bucket's end run the
// same steps on an inert slot and store nothing: every lane reaches every
// shuffle.

constexpr unsigned kFullWarp = 0xffffffffu;

// The lanes of one pool are LANES consecutive lanes; lane c holds slot c.
// lanes_sum: ((0 + x_0) + x_1) + ... + x_{K-1} over the pool's lanes, the
// plain loop's order; every lane of the pool gets the same value.  K is
// uniform across the warp, so the early exit keeps the shuffles converged.
template <typename T, int LANES>
__device__ __forceinline__ T lanes_sum(T x, int K) {
  if constexpr (LANES == 1) {
    return T(0) + x;
  } else {
    T h = T(0);
#pragma unroll
    for (int c = 0; c < LANES; ++c) {
      if (c >= K) break;
      h = h + __shfl_sync(kFullWarp, x, c, LANES);
    }
    return h;
  }
}

// max over the pool's K lanes, folded in slot order as the plain loop does.
template <typename T, int LANES>
__device__ __forceinline__ T lanes_max(T x, int K) {
  if constexpr (LANES == 1) {
    return x;
  } else {
    T r = __shfl_sync(kFullWarp, x, 0, LANES);
#pragma unroll
    for (int c = 1; c < LANES; ++c) {
      if (c >= K) break;
      r = tmax(r, __shfl_sync(kFullWarp, x, c, LANES));
    }
    return r;
  }
}

// Lanes per pool for K slots: the power of two >= K up to 32, 0 for the
// one-thread-per-pool form (K > 32).
inline int lanes_for(int K) {
  int l = 1;
  while (l < K && l < 64) l <<= 1;
  return l > 32 ? 0 : l;
}

// The bucket of this block in a grouped launch: the last descriptor whose
// first block is <= blockIdx.x (block-uniform).
template <class Table>
__device__ __forceinline__ int block_bucket(const Table& tab) {
  int b = 0;
  while (b + 1 < tab.n && (int)blockIdx.x >= tab.b[b + 1].first_block) ++b;
  return b;
}

// The inert slot of an idle lane of the base projection.
template <typename T> __device__ __forceinline__ SlotIn<T> idle_in() {
  SlotIn<T> in;
  in.p = T(0); in.q = T(0); in.R = T(1); in.w = T(0); in.s = T(0);
  in.mask = T(0);
  return in;
}

// The cooperative projection of one pool of K slots spread over LANES lanes
// (K <= LANES): this lane's slot `in`, the pool's gamma, log k0 and k0.
// Every lane of the warp must call it; (D, L) are this lane's slot's
// trades.  The same values as project_pool, in the same order.
template <typename T, int LANES, int KIND>
__device__ __forceinline__ void project_slot(const SlotIn<T>& in, int K, T g,
                                             T logk0, T k0, int n_bisect,
                                             int n_total, T& D, T& L) {
  if constexpr (KIND == KIND_CS) {
    const CsSlot<T> sl = cs_prep(in, g);
    const T w_safe = in.mask > T(0) ? in.w : T(1);
    const T mu_hi =
        lanes_max<T, LANES>(relu(in.q) * in.mask / w_safe, K) + T(1);
    auto h_of_mu = [&](T mu) {
      T Dm, Lm;
      cs_dl(sl, g, mu, Dm, Lm);
      const T x = tmax(sl.R + g * Dm - Lm, T(0)) * sl.mask;
      return lanes_sum<T, LANES>(sl.w * x, K);
    };
    const T mu = root_find(h_of_mu, mu_hi, k0, n_bisect, n_total);
    cs_dl(sl, g, mu, D, L);
  } else {
    constexpr bool FLOOR = KIND == KIND_GM_FLOOR;
    const GmSlot<T> sl = gm_prep(in, g, FLOOR);
    const T Rp = in.R + in.s;
    const T qp = relu(in.q) + T(1e-3);
    const T need_t = tmax(T(2) * qp * (Rp + g * relu(in.p)),
                          T(4) * qp * qp * g * g);
    const T w_safe = in.mask > T(0) ? in.w : T(1);
    const T cand = in.mask > T(0)
                       ? need_t / (w_safe * tmax(k0, Lim<T>::tiny()))
                       : T(0);
    const T mu_hi = T(4) * lanes_max<T, LANES>(cand, K) + T(1);
    auto h_of_mu = [&](T mu) {
      const T t = mu * sl.w * k0;
      T xi = inner_gm(sl, t);
      if (FLOOR && xi < sl.s) xi = sl.s;
      return lanes_sum<T, LANES>(sl.w * dlog(tmax(xi, Lim<T>::log_floor())),
                                 K);
    };
    const T mu = root_find(h_of_mu, mu_hi, logk0, n_bisect, n_total);
    const T t = mu * sl.w * k0;
    const T xi = inner_gm(sl, t);
    T theta = t / tmax(xi, Lim<T>::tiny());
    if (FLOOR && xi < sl.s) theta = tmax(sl.thf, theta);
    D = relu(sl.p + g * theta) * sl.mask;
    L = relu(sl.q - theta) * sl.mask;
  }
}

}  // namespace cfmm

// Call CALL(T, LANES) with the dtype's type and lanes_for(K); each CALL
// returns.  Unknown dtypes and K < 1 give cudaErrorInvalidValue.
#define CFMM_LANES_OF(T, K, CALL)                                          \
  if ((K) < 1) return (int)cudaErrorInvalidValue;                         \
  switch (cfmm::lanes_for(K)) {                                           \
    case 1: return CALL(T, 1);                                            \
    case 2: return CALL(T, 2);                                            \
    case 4: return CALL(T, 4);                                            \
    case 8: return CALL(T, 8);                                            \
    case 16: return CALL(T, 16);                                          \
    case 32: return CALL(T, 32);                                          \
    default: return CALL(T, 0);                                           \
  }

#define CFMM_DISPATCH_LANES(dtype, K, CALL)                                \
  switch (dtype) {                                                        \
    case 0: CFMM_LANES_OF(float, K, CALL)                                 \
    case 1: CFMM_LANES_OF(double, K, CALL)                                \
    default: return (int)cudaErrorInvalidValue;                           \
  }
