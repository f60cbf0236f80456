// Shared device projection onto CFMM trading sets, one thread per pool.
//
// Replaces the projection math of the JAX package's Pallas kernels
// (cfmm_routing_tpu/ops/projection_pallas.py: _inner_gm, _solve_theta_linear,
// the gm and cs brackets, _eval_gm_channels / _eval_cs_channels and
// _root_find_body).  The same header serves the standalone projection
// kernels (projection.cu) and the fused ADMM step (fused_step.cu).
//
// Layout: every bucket is slot-major (K, m); a thread owns one pool and keeps
// its K slots in registers, so loads of one slot plane are coalesced across
// the warp.  K is a template parameter (2, 4 or 8 after pad_pow2).
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
__device__ __forceinline__ void gm_prep(GmSlot<T>& sl, T p, T q, T R, T w, T s,
                                        T mask, T g, bool floor) {
  const T Rp = R + s;
  sl.p = p; sl.q = q; sl.w = w; sl.s = s; sl.mask = mask;
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
  sl.thf = floor ? solve_theta_linear(p, q, Rp, g, s) : T(0);
}

// Closed-form solve of xi = xi(theta), theta = t / xi.
template <typename T>
__device__ __forceinline__ T inner_gm(const GmSlot<T>& sl, T t) {
  const bool in_r1 = (sl.G1 - t) >= T(0);
  const bool in_r2 = !in_r1 && (sl.G2 - t) >= T(0);
  const T a = in_r1 ? sl.a0 : (in_r2 ? sl.a1 : sl.a2);
  const T bb = in_r1 ? sl.c0 : (in_r2 ? sl.c1 : sl.c2);
  const T c = bb * t;
  const T sq = dsqrt(a * a + T(4) * c);
  const T xi = a > T(0) ? T(0.5) * (a + sq)
                        : (T(2) * c) / tmax(sq - a, Lim<T>::tiny());
  return t > Lim<T>::tiny() ? xi : sl.xi0;
}

template <typename T, int K, bool FLOOR>
__device__ __forceinline__ T gm_h(const GmSlot<T> (&sl)[K], T k0, T mu) {
  T h = T(0);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const T t = mu * sl[c].w * k0;
    T xi = inner_gm(sl[c], t);
    if (FLOOR && xi < sl[c].s) xi = sl[c].s;
    h = h + sl[c].w * dlog(tmax(xi, Lim<T>::log_floor()));
  }
  return h;
}

// One constant-sum slot; thf drives the post-trade reserve to 0.
template <typename T> struct CsSlot {
  T p, q, R, w, mask, thf;
};

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

template <typename T, int K>
__device__ __forceinline__ T cs_h(const CsSlot<T> (&sl)[K], T g, T mu) {
  T h = T(0);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    T D, L;
    cs_dl(sl[c], g, mu, D, L);
    const T x = tmax(sl[c].R + g * D - L, T(0)) * sl[c].mask;
    h = h + sl[c].w * x;
  }
  return h;
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
      const T abs_denom = denom < T(0) ? -denom : denom;
      const T falsi =
          abs_denom > Lim<T>::tiny() ? (target - hlo) / denom : T(0.5);
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

// Project one pool's (p, q) onto its trading set.  s and logk0 are unused
// for constant-sum pools.
template <typename T, int K, int KIND>
__device__ __forceinline__ void project_pool(
    const T (&p)[K], const T (&q)[K], const T (&R)[K], const T (&w)[K],
    const T (&s)[K], const T (&mask)[K], T g, T logk0, T k0, int n_bisect,
    int n_total, T (&D)[K], T (&L)[K]) {
  if (KIND == KIND_CS) {
    CsSlot<T> sl[K];
    T mu_hi = T(0);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      sl[c].p = p[c]; sl[c].q = q[c]; sl[c].R = R[c]; sl[c].w = w[c];
      sl[c].mask = mask[c];
      sl[c].thf = solve_theta_linear(p[c], q[c], R[c], g, T(0));
      const T w_safe = mask[c] > T(0) ? w[c] : T(1);
      const T cand = relu(q[c]) * mask[c] / w_safe;
      mu_hi = c == 0 ? cand : tmax(mu_hi, cand);
    }
    mu_hi = mu_hi + T(1);
    auto h_of_mu = [&](T mu) { return cs_h<T, K>(sl, g, mu); };
    const T mu = root_find(h_of_mu, mu_hi, k0, n_bisect, n_total);
#pragma unroll
    for (int c = 0; c < K; ++c) cs_dl(sl[c], g, mu, D[c], L[c]);
  } else {
    constexpr bool FLOOR = KIND == KIND_GM_FLOOR;
    GmSlot<T> sl[K];
    T mu_hi = T(0);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      gm_prep(sl[c], p[c], q[c], R[c], w[c], s[c], mask[c], g, FLOOR);
      const T Rp = R[c] + s[c];
      const T qp = relu(q[c]) + T(1e-3);
      const T need_t = tmax(T(2) * qp * (Rp + g * relu(p[c])),
                            T(4) * qp * qp * g * g);
      const T w_safe = mask[c] > T(0) ? w[c] : T(1);
      const T cand = mask[c] > T(0)
                         ? need_t / (w_safe * tmax(k0, Lim<T>::tiny()))
                         : T(0);
      mu_hi = c == 0 ? cand : tmax(mu_hi, cand);
    }
    mu_hi = T(4) * mu_hi + T(1);
    auto h_of_mu = [&](T mu) { return gm_h<T, K, FLOOR>(sl, k0, mu); };
    const T mu = root_find(h_of_mu, mu_hi, logk0, n_bisect, n_total);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const T t = mu * sl[c].w * k0;
      const T xi = inner_gm(sl[c], t);
      T theta = t / tmax(xi, Lim<T>::tiny());
      if (FLOOR && xi < sl[c].s) theta = tmax(sl[c].thf, theta);
      D[c] = relu(sl[c].p + g * theta) * sl[c].mask;
      L[c] = relu(sl[c].q - theta) * sl[c].mask;
    }
  }
}

}  // namespace cfmm

// Dispatch a templated launch over (dtype, K, kind); sets `err` to
// cudaErrorInvalidValue for combinations that are not instantiated.
#define CFMM_DISPATCH_KIND(T, KK, kind, LAUNCH)                              \
  switch (kind) {                                                            \
    case cfmm::KIND_GM: LAUNCH(T, KK, cfmm::KIND_GM); break;                  \
    case cfmm::KIND_GM_FLOOR: LAUNCH(T, KK, cfmm::KIND_GM_FLOOR); break;      \
    case cfmm::KIND_CS: LAUNCH(T, KK, cfmm::KIND_CS); break;                  \
    default: return (int)cudaErrorInvalidValue;                              \
  }

#define CFMM_DISPATCH_K(T, K, kind, LAUNCH)                                  \
  switch (K) {                                                               \
    case 2: CFMM_DISPATCH_KIND(T, 2, kind, LAUNCH); break;                    \
    case 4: CFMM_DISPATCH_KIND(T, 4, kind, LAUNCH); break;                    \
    case 8: CFMM_DISPATCH_KIND(T, 8, kind, LAUNCH); break;                    \
    default: return (int)cudaErrorInvalidValue;                              \
  }

#define CFMM_DISPATCH(dtype, K, kind, LAUNCH)                                \
  switch (dtype) {                                                           \
    case 0: CFMM_DISPATCH_K(float, K, kind, LAUNCH); break;                   \
    case 1: CFMM_DISPATCH_K(double, K, kind, LAUNCH); break;                  \
    default: return (int)cudaErrorInvalidValue;                              \
  }
