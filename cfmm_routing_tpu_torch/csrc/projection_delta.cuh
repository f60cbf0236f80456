// Device projection onto SHIFTED trading sets (the refinement stage), one
// thread per pool.
//
// Replaces the delta projection math of the Pallas kernel fused_step_delta
// (cfmm_routing_tpu/ops/iteration_pallas.py: _eval_gm_delta_channels,
// _eval_cs_delta_channels, _gm_delta_bracket_ch, _cs_delta_bracket_ch, over
// ops/projection_delta.py's _inner_gm_delta and _solve_theta_linear_delta).
// The plain version is ops/projection_delta.py of this package.
//
// Around a base point (D0, L0) the trades are D = D0 + eps*a, L = L0 + eps*b
// and the set reads
//
//   a >= aD,  b >= aL,  sum_j w_j log1p(v_j / X0_j) >= nsig   (geo-mean)
//   a >= aD,  b >= aL,  sum_j w_j v_j >= nsig,  X0 + v >= 0     (const sum)
//
// with v = gamma*a - b.  The KKT maps are a = max(p + gamma*theta, aD),
// b = max(q - theta, aL) with theta = mu * w / xi (geo-mean, xi = X0 + v) or
// mu * w (constant sum); the four-region closed form of projection.cuh
// carries over with the lower bounds in place of the orthant.  v is always
// rebuilt from theta (never as xi - X0, which would cancel), and the
// constraint uses a real log1p: the refinement's precision lives in those
// O(eps)-relative terms.
//
// Layout, instantiations (KC in {2, 4, 8, 16} in registers, KC == 0 for
// any K), the hoisting of every mu-free term out of the root-find and the
// fixed-trip root-find itself are those of projection.cuh.
#pragma once

#include "projection.cuh"

namespace cfmm {

// The raw inputs of one delta slot.
template <typename T> struct DeltaIn {
  T p, q, X0, w, sS, aD, aL, mask;
};

template <typename T>
__device__ __forceinline__ T v_of_theta(T p, T q, T g, T th, T aD, T aL) {
  return g * tmax(p + g * th, aD) - tmax(q - th, aL);
}

// Smallest theta with X0 + v(theta) == target (piecewise linear).
template <typename T>
__device__ __forceinline__ T solve_theta_linear_delta(T p, T q, T X0, T g,
                                                      T target, T aD, T aL) {
  const T g2 = g * g;
  const T th1 = relu((aD - p) / g);
  const T th2 = relu(q - aL);
  const T b1 = tmin(th1, th2);
  const T b2 = tmax(th1, th2);
  const bool in_r1 = X0 + v_of_theta(p, q, g, b1, aD, aL) >= target;
  const bool in_r2 = !in_r1 && X0 + v_of_theta(p, q, g, b2, aD, aL) >= target;
  const T rep = in_r1 ? T(0.5) * b1 : (in_r2 ? T(0.5) * (b1 + b2) : b2 + T(1));
  const bool aclip = (p + g * rep) < aD;
  const bool bclip = (q - rep) < aL;
  const T thA = (target - X0 - g * p + q) / (T(1) + g2);
  const T thB = (target - X0 - g * p + aL) / g2;
  const T thC = target - X0 - g * aD + q;
  const T thD = T(0.5) * (th1 + th2);
  const T th = aclip ? (bclip ? thD : thC) : (bclip ? thB : thA);
  return relu(th);
}

// One geo-mean delta slot with everything that does not depend on mu.
template <typename T> struct GmDeltaSlot {
  T p, q, X0, w, sS, aD, aL, mask;
  T G1, G2, xi0, thf;
  T k0, k1, k2, c0, c1, c2;  // per-region quadratic coefficients
};

template <typename T>
__device__ __forceinline__ void delta_coeffs(T p, T q, T X0, T g, T aD, T aL,
                                             T rep, T& coef, T& bb) {
  const bool aclip = (p + g * rep) < aD;
  const bool bclip = (q - rep) < aL;
  coef = aclip ? (bclip ? X0 + g * aD - aL : X0 + g * aD - q)
               : (bclip ? X0 + g * p - aL : X0 + g * p - q);
  bb = aclip ? (bclip ? T(0) : T(1)) : (bclip ? g * g : T(1) + g * g);
}

template <typename T>
__device__ __forceinline__ GmDeltaSlot<T> gm_delta_prep(const DeltaIn<T>& in,
                                                        T g, bool floor) {
  GmDeltaSlot<T> sl;
  const T p = in.p, q = in.q, X0 = in.X0, aD = in.aD, aL = in.aL;
  sl.p = p; sl.q = q; sl.X0 = X0; sl.w = in.w; sl.sS = in.sS;
  sl.aD = aD; sl.aL = aL; sl.mask = in.mask;
  const T th1 = relu((aD - p) / g);
  const T th2 = relu(q - aL);
  const T b1 = tmin(th1, th2);
  const T b2 = tmax(th1, th2);
  sl.G1 = b1 * (X0 + v_of_theta(p, q, g, b1, aD, aL));
  sl.G2 = b2 * (X0 + v_of_theta(p, q, g, b2, aD, aL));
  sl.xi0 = X0 + v_of_theta(p, q, g, T(0), aD, aL);
  delta_coeffs(p, q, X0, g, aD, aL, T(0.5) * b1, sl.k0, sl.c0);
  delta_coeffs(p, q, X0, g, aD, aL, T(0.5) * (b1 + b2), sl.k1, sl.c1);
  delta_coeffs(p, q, X0, g, aD, aL, b2 + T(1), sl.k2, sl.c2);
  sl.thf = floor ? solve_theta_linear_delta(p, q, X0, g, in.sS, aD, aL) : T(0);
  return sl;
}

// theta at multiplier mu: the closed-form solve of xi = X0 + v(t / xi),
// t = mu * w, then the reserve-floor clamp.  t <= tiny gives theta = 0.
template <typename T, bool FLOOR>
__device__ __forceinline__ T gm_delta_theta(const GmDeltaSlot<T>& sl, T mu) {
  const T t = mu * sl.w;
  const bool in_r1 = (sl.G1 - t) >= T(0);
  const bool in_r2 = !in_r1 && (sl.G2 - t) >= T(0);
  const T coef = in_r1 ? sl.k0 : (in_r2 ? sl.k1 : sl.k2);
  const T bb = in_r1 ? sl.c0 : (in_r2 ? sl.c1 : sl.c2);
  T xi = stable_quad_root(coef, bb * t);
  T theta = t / tmax(xi, Lim<T>::tiny());
  const bool live = t > Lim<T>::tiny();
  xi = live ? xi : sl.xi0;
  theta = live ? theta : T(0);
  if (FLOOR && xi < sl.sS) theta = tmax(sl.thf, theta);
  return theta;
}

// One constant-sum delta slot; thf drives X0 + v to 0.
template <typename T> struct CsDeltaSlot {
  T p, q, X0, w, aD, aL, mask, thf;
};

template <typename T>
__device__ __forceinline__ CsDeltaSlot<T> cs_delta_prep(const DeltaIn<T>& in,
                                                        T g) {
  CsDeltaSlot<T> sl;
  sl.p = in.p; sl.q = in.q; sl.X0 = in.X0; sl.w = in.w;
  sl.aD = in.aD; sl.aL = in.aL; sl.mask = in.mask;
  sl.thf = solve_theta_linear_delta(in.p, in.q, in.X0, g, T(0), in.aD, in.aL);
  return sl;
}

template <typename T>
__device__ __forceinline__ T cs_delta_theta(const CsDeltaSlot<T>& sl, T g,
                                            T mu) {
  T theta = mu * sl.w;
  const T a = tmax(sl.p + g * theta, sl.aD);
  const T b = tmax(sl.q - theta, sl.aL);
  if (sl.X0 + g * a - b < T(0)) theta = tmax(sl.thf, theta);
  return theta;
}

// Project one pool onto its shifted set.  load(c) returns slot c's DeltaIn;
// store(c, a, b) receives the (masked) scaled delta trades.  nsig is the
// pool's constraint level (the log-domain slack for geo-mean pools, the
// scaled linear slack for constant-sum pools).
template <typename T, int KC, int KIND, class Load, class Store>
__device__ __forceinline__ void project_pool_delta(const Load& load, int k,
                                                   T g, T nsig, int n_bisect,
                                                   int n_total,
                                                   const Store& store) {
  const int K = KC > 0 ? KC : k;
  const T margin = T(1e-3);
  if constexpr (KIND == KIND_CS) {
    SlotCache<CsDeltaSlot<T>, KC> cache;
    T mu_hi = T(0);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const DeltaIn<T> in = load(c);
      if constexpr (KC > 0) cache.reg[c] = cs_delta_prep(in, g);
      const T w_safe = in.mask > T(0) ? in.w : T(1);
      const T vreq = relu(nsig) / w_safe + margin;
      const T th_v = (vreq + in.aL - g * in.p) / (g * g);
      const T th_req = relu(tmax(in.q - in.aL, th_v)) + margin;
      const T cand = in.mask > T(0) ? th_req / w_safe : T(0);
      mu_hi = c == 0 ? cand : tmax(mu_hi, cand);
    }
    mu_hi = mu_hi + T(1);
    auto get = [&](int c) -> CsDeltaSlot<T> {
      if constexpr (KC > 0) return cache.reg[c];
      else return cs_delta_prep(load(c), g);
    };
    auto h_of_mu = [&](T mu) {
      T h = T(0);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const CsDeltaSlot<T> sl = get(c);
        if (sl.mask > T(0)) {
          const T theta = cs_delta_theta(sl, g, mu);
          const T v = g * tmax(sl.p + g * theta, sl.aD) - tmax(sl.q - theta, sl.aL);
          h = h + sl.w * v;
        } else {
          h = h + T(0);
        }
      }
      return h;
    };
    const T mu = root_find(h_of_mu, mu_hi, nsig, n_bisect, n_total);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const CsDeltaSlot<T> sl = get(c);
      const T theta = cs_delta_theta(sl, g, mu);
      const bool real = sl.mask > T(0);
      store(c, real ? tmax(sl.p + g * theta, sl.aD) : T(0),
            real ? tmax(sl.q - theta, sl.aL) : T(0));
    }
  } else {
    constexpr bool FLOOR = KIND == KIND_GM_FLOOR;
    SlotCache<GmDeltaSlot<T>, KC> cache;
    const T vfac = dexpm1(relu(nsig));
    T mu_hi = T(0);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const DeltaIn<T> in = load(c);
      if constexpr (KC > 0) cache.reg[c] = gm_delta_prep(in, g, FLOOR);
      const T vreq = in.X0 * vfac + margin;
      const T th_v = (vreq + in.aL - g * in.p) / (g * g);
      const T th_req = relu(tmax(in.q - in.aL, th_v)) + margin;
      const T a_at = tmax(in.p + g * th_req, in.aD);
      const T M = in.X0 + g * tabs(a_at) + tabs(in.aL) + T(1);
      const T t_req = T(2) * th_req * M;
      const T w_safe = in.mask > T(0) ? in.w : T(1);
      const T cand = in.mask > T(0) ? t_req / w_safe : T(0);
      mu_hi = c == 0 ? cand : tmax(mu_hi, cand);
    }
    mu_hi = mu_hi + T(1);
    auto get = [&](int c) -> GmDeltaSlot<T> {
      if constexpr (KC > 0) return cache.reg[c];
      else return gm_delta_prep(load(c), g, FLOOR);
    };
    auto h_of_mu = [&](T mu) {
      T h = T(0);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const GmDeltaSlot<T> sl = get(c);
        if (sl.mask > T(0)) {
          const T theta = gm_delta_theta<T, FLOOR>(sl, mu);
          const T v = g * tmax(sl.p + g * theta, sl.aD) - tmax(sl.q - theta, sl.aL);
          const T u = v / sl.X0;
          h = h + sl.w * dlog1p(tmax(u, T(-0.999999)));
        } else {
          h = h + T(0);
        }
      }
      return h;
    };
    const T mu = root_find(h_of_mu, mu_hi, nsig, n_bisect, n_total);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const GmDeltaSlot<T> sl = get(c);
      const T theta = gm_delta_theta<T, FLOOR>(sl, mu);
      const bool real = sl.mask > T(0);
      store(c, real ? tmax(sl.p + g * theta, sl.aD) : T(0),
            real ? tmax(sl.q - theta, sl.aL) : T(0));
    }
  }
}

}  // namespace cfmm
