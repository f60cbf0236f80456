// Native problem packer: flat pool table -> padded bucket arrays.
//
// One pass over the flat slot arrays of a PoolTable fills one bucket's
// padded (m, K) arrays, where the numpy packer fills them column by
// column.  Built on demand with g++ into the
// package's build directory (see native/__init__.py) and called through
// ctypes, with a plain C interface.  The same source as the JAX package's
// packer, so both packages compile a table to the same bits.
//
// Contract (must match solver/compiler.py:compile_spec exactly):
//   * bucket rows r < m_real take pool rows[r]; rows >= m_real are inert
//     padding pools (mask 0, asset 0, gamma 1, gm k0 = 1, cs k0 = 0);
//   * padding slots j >= width are masked with asset 0 (consensus reads
//     and writes are masked in the solver, solver/admm.py);
//   * gm weights are normalized to sum 1 per pool; cs weights are the RAW
//     linear coefficients q_j (phi = sum q_j x_j; 1.0 for uniform pools);
//   * logk0 = sum_j w_j log(R_j + s_j) for gm; k0 = sum_j q_j R_j for cs.

#include <cmath>
#include <cstdint>

extern "C" {

void fill_bucket(
    int64_t m, int64_t m_real, int32_t K, int32_t is_gm,
    const int32_t* rows,         // (m_real,) pool ids for this bucket
    const int32_t* width,        // (n_pools,)
    const int64_t* offset,       // (n_pools,) slot offset per pool
    const int32_t* assets,       // flat slots
    const double* reserves,      // flat slots
    const double* weights,       // flat slots (raw, unnormalized)
    const double* shifts,        // flat slots
    const double* fees,          // (n_pools,)
    double* R, double* W, double* S, double* G,   // (m,K) x3, (m,)
    double* mask, int32_t* asset_out,             // (m,K)
    double* degree,                               // (n_assets,) accumulated
    double* logk0, double* k0)                    // (m,)
{
    for (int64_t r = 0; r < m; ++r) {
        double lk = 0.0, ks = 0.0;
        if (r < m_real) {
            const int32_t pid = rows[r];
            const int32_t k = width[pid];
            const int64_t o = offset[pid];
            G[r] = fees[pid];
            double wsum = 0.0;
            if (is_gm) {
                for (int32_t j = 0; j < k; ++j) wsum += weights[o + j];
                if (wsum <= 0.0) wsum = 1.0;
            }
            for (int32_t j = 0; j < K; ++j) {
                const int64_t idx = r * K + j;
                if (j < k) {
                    const double Rv = reserves[o + j];
                    const double Sv = shifts[o + j];
                    const double Wv = is_gm ? weights[o + j] / wsum
                                            : weights[o + j];
                    R[idx] = Rv; W[idx] = Wv; S[idx] = Sv; mask[idx] = 1.0;
                    asset_out[idx] = assets[o + j];
                    degree[assets[o + j]] += 1.0;
                    if (is_gm) lk += Wv * std::log(Rv + Sv);
                    else ks += Rv * Wv;
                } else {
                    R[idx] = 0.0; W[idx] = 0.0; S[idx] = 0.0;
                    mask[idx] = 0.0; asset_out[idx] = 0;
                }
            }
        } else {
            G[r] = 1.0;
            for (int32_t j = 0; j < K; ++j) {
                const int64_t idx = r * K + j;
                R[idx] = 0.0; W[idx] = 0.0; S[idx] = 0.0;
                mask[idx] = 0.0; asset_out[idx] = 0;
            }
        }
        if (is_gm) { logk0[r] = lk; k0[r] = std::exp(lk); }
        else       { logk0[r] = 0.0; k0[r] = ks; }
    }
}

// Bucket-key computation: K = max(2, next_pow2(width)), key packs
// (kind, K, floor).  Returns keys so Python can group with one np.unique.
void bucket_keys(
    int64_t n_pools, const int32_t* width, const uint8_t* kind,
    const uint8_t* floor_flag, int32_t* keys)
{
    for (int64_t i = 0; i < n_pools; ++i) {
        int32_t K = 2;
        while (K < width[i]) K <<= 1;
        keys[i] = (static_cast<int32_t>(kind[i]) << 24) | (K << 1) |
                  static_cast<int32_t>(floor_flag[i]);
    }
}

}  // extern "C"
