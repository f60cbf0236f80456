// Device projection onto SHIFTED trading sets (the refinement stage).
//
// Replaces the delta projection math of the Pallas kernel fused_step_delta
// (cfmm_routing_tpu/ops/iteration_pallas.py: _eval_gm_delta_channels,
// _eval_cs_delta_channels, _gm_delta_bracket_ch, _cs_delta_bracket_ch, over
// ops/projection_delta.py's _inner_gm_delta and _solve_theta_linear_delta)
// and the refinement's standalone project_gm_delta / project_cs_delta
// (ops/projection_delta.py there, plain jnp).  The plain version is
// ops/projection_delta.py of this package.
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
// What bounds it on an H100: operations and latency, not bytes.  Each pool
// evaluates h(mu) n_bisect + n_polish + 2 times (56 at (48, 6)), a chain of
// dependent steps; per geo-mean slot one evaluation is a region select, a
// sqrt, two IEEE divisions and a log1p.  The bytes bound is about a tenth
// of the operations bound.  There is no matrix product, so tensor cores
// (wgmma) have nothing to do, and each slot's inputs are read once, so TMA
// staging would only add a shared-memory round trip: what the card needs is
// enough resident warps to hide the chain, and every SM busy.
//
// Design: LANES PER SLOT (project_slot_delta).  LANES consecutive lanes of
// a warp own one pool, LANES the power of two >= K (up to 32); lane c
// prepares slot c's mu-free terms (GmDeltaSlot / CsDeltaSlot, hoisted out
// of the root-find) and holds only that slot.  Each evaluation of h(mu)
// computes the lane's slot term, and the pool's lanes gather the terms in
// slot order with __shfl_sync, h = ((0 + h_0) + h_1) + ..., exactly as the
// plain loop adds them; mu_hi is the max over the slots taken the same way.
// Every lane then runs the identical fixed-trip root-find bookkeeping, so
// the planes are bitwise equal to the plain version's.  Idle lanes (slot
// >= K) and pools past the bucket's end run the same steps on an inert
// slot and store nothing: every lane reaches every shuffle.  A pool of
// K = 2 thus fills two threads instead of one, and a thread keeps one
// slot's 18 values in registers instead of K of them.
//
// Pools with K > 32 (in no shipped network) take the one-thread-per-pool
// form (project_pool_delta), which walks the slots from memory in every
// evaluation and prepares them again: the same values, in the same order.
//
// The kernels over this header (projection_delta.cu, fused_step_delta.cu)
// launch once per group of buckets with the same K: a by-value table of
// per-bucket descriptors, one bucket per block, and a block-uniform switch
// on the bucket's kind.
//
// Numerics: --fmad=false, IEEE division and sqrt, a true log1p / expm1,
// the fixed (48, 6) trip counts of ProjectionConfig.
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

// The mu_hi candidate of one slot (0 for a padding slot).
template <typename T>
__device__ __forceinline__ T cs_delta_cand(const DeltaIn<T>& in, T g, T nsig) {
  const T margin = T(1e-3);
  const T w_safe = in.mask > T(0) ? in.w : T(1);
  const T vreq = relu(nsig) / w_safe + margin;
  const T th_v = (vreq + in.aL - g * in.p) / (g * g);
  const T th_req = relu(tmax(in.q - in.aL, th_v)) + margin;
  return in.mask > T(0) ? th_req / w_safe : T(0);
}

template <typename T>
__device__ __forceinline__ T gm_delta_cand(const DeltaIn<T>& in, T g, T vfac) {
  const T margin = T(1e-3);
  const T vreq = in.X0 * vfac + margin;
  const T th_v = (vreq + in.aL - g * in.p) / (g * g);
  const T th_req = relu(tmax(in.q - in.aL, th_v)) + margin;
  const T a_at = tmax(in.p + g * th_req, in.aD);
  const T M = in.X0 + g * tabs(a_at) + tabs(in.aL) + T(1);
  const T t_req = T(2) * th_req * M;
  const T w_safe = in.mask > T(0) ? in.w : T(1);
  return in.mask > T(0) ? t_req / w_safe : T(0);
}

// One slot's term of h(mu) (0 for a padding slot).
template <typename T>
__device__ __forceinline__ T cs_delta_term(const CsDeltaSlot<T>& sl, T g,
                                           T mu) {
  if (!(sl.mask > T(0))) return T(0);
  const T theta = cs_delta_theta(sl, g, mu);
  const T v = g * tmax(sl.p + g * theta, sl.aD) - tmax(sl.q - theta, sl.aL);
  return sl.w * v;
}

template <typename T, bool FLOOR>
__device__ __forceinline__ T gm_delta_term(const GmDeltaSlot<T>& sl, T g,
                                           T mu) {
  if (!(sl.mask > T(0))) return T(0);
  const T theta = gm_delta_theta<T, FLOOR>(sl, mu);
  const T v = g * tmax(sl.p + g * theta, sl.aD) - tmax(sl.q - theta, sl.aL);
  const T u = v / sl.X0;
  return sl.w * dlog1p(tmax(u, T(-0.999999)));
}

// One slot's (masked) scaled delta trades at the root.
template <typename T, class Slot>
__device__ __forceinline__ void delta_trades(const Slot& sl, T g, T theta,
                                             T& A, T& B) {
  const bool real = sl.mask > T(0);
  A = real ? tmax(sl.p + g * theta, sl.aD) : T(0);
  B = real ? tmax(sl.q - theta, sl.aL) : T(0);
}

// Project one pool onto its shifted set, one thread for all its slots (the
// form for K > 32).  load(c) returns slot c's DeltaIn; store(c, a, b)
// receives the (masked) scaled delta trades.  nsig is the pool's
// constraint level (the log-domain slack for geo-mean pools, the scaled
// linear slack for constant-sum pools).
template <typename T, int KIND, class Load, class Store>
__device__ __forceinline__ void project_pool_delta(const Load& load, int K,
                                                   T g, T nsig, int n_bisect,
                                                   int n_total,
                                                   const Store& store) {
  if constexpr (KIND == KIND_CS) {
    T mu_hi = T(0);
    for (int c = 0; c < K; ++c) {
      const T cand = cs_delta_cand(load(c), g, nsig);
      mu_hi = c == 0 ? cand : tmax(mu_hi, cand);
    }
    mu_hi = mu_hi + T(1);
    auto h_of_mu = [&](T mu) {
      T h = T(0);
      for (int c = 0; c < K; ++c)
        h = h + cs_delta_term(cs_delta_prep(load(c), g), g, mu);
      return h;
    };
    const T mu = root_find(h_of_mu, mu_hi, nsig, n_bisect, n_total);
    for (int c = 0; c < K; ++c) {
      const CsDeltaSlot<T> sl = cs_delta_prep(load(c), g);
      T A, B;
      delta_trades(sl, g, cs_delta_theta(sl, g, mu), A, B);
      store(c, A, B);
    }
  } else {
    constexpr bool FLOOR = KIND == KIND_GM_FLOOR;
    const T vfac = dexpm1(relu(nsig));
    T mu_hi = T(0);
    for (int c = 0; c < K; ++c) {
      const T cand = gm_delta_cand(load(c), g, vfac);
      mu_hi = c == 0 ? cand : tmax(mu_hi, cand);
    }
    mu_hi = mu_hi + T(1);
    auto h_of_mu = [&](T mu) {
      T h = T(0);
      for (int c = 0; c < K; ++c)
        h = h + gm_delta_term<T, FLOOR>(gm_delta_prep(load(c), g, FLOOR), g, mu);
      return h;
    };
    const T mu = root_find(h_of_mu, mu_hi, nsig, n_bisect, n_total);
    for (int c = 0; c < K; ++c) {
      const GmDeltaSlot<T> sl = gm_delta_prep(load(c), g, FLOOR);
      T A, B;
      delta_trades(sl, g, gm_delta_theta<T, FLOOR>(sl, mu), A, B);
      store(c, A, B);
    }
  }
}

// ---- lanes per slot (the helpers are in projection.cuh) --------------------

// The inert slot of an idle lane (slot >= K, or a pool past the end).
template <typename T> __device__ __forceinline__ DeltaIn<T> idle_slot() {
  DeltaIn<T> in;
  in.p = T(0); in.q = T(0); in.X0 = T(1); in.w = T(1); in.sS = T(0);
  in.aD = T(0); in.aL = T(0); in.mask = T(0);
  return in;
}

// The cooperative projection: this lane's slot `in` of a pool of K slots
// spread over LANES lanes (K <= LANES).  Every lane of the warp must call
// it; (A, B) are this lane's slot's trades.
template <typename T, int LANES, int KIND>
__device__ __forceinline__ void project_slot_delta(const DeltaIn<T>& in, int K,
                                                   T g, T nsig, int n_bisect,
                                                   int n_total, T& A, T& B) {
  if constexpr (KIND == KIND_CS) {
    const CsDeltaSlot<T> sl = cs_delta_prep(in, g);
    const T mu_hi = lanes_max<T, LANES>(cs_delta_cand(in, g, nsig), K) + T(1);
    auto h_of_mu = [&](T mu) {
      return lanes_sum<T, LANES>(cs_delta_term(sl, g, mu), K);
    };
    const T mu = root_find(h_of_mu, mu_hi, nsig, n_bisect, n_total);
    delta_trades(sl, g, cs_delta_theta(sl, g, mu), A, B);
  } else {
    constexpr bool FLOOR = KIND == KIND_GM_FLOOR;
    const GmDeltaSlot<T> sl = gm_delta_prep(in, g, FLOOR);
    const T vfac = dexpm1(relu(nsig));
    const T mu_hi = lanes_max<T, LANES>(gm_delta_cand(in, g, vfac), K) + T(1);
    auto h_of_mu = [&](T mu) {
      return lanes_sum<T, LANES>(gm_delta_term<T, FLOOR>(sl, g, mu), K);
    };
    const T mu = root_find(h_of_mu, mu_hi, nsig, n_bisect, n_total);
    delta_trades(sl, g, gm_delta_theta<T, FLOOR>(sl, mu), A, B);
  }
}

}  // namespace cfmm
