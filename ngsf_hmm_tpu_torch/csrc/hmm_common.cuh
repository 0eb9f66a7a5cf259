// Shared device code of the HMM chain kernels (gl layout).
//
// Layout: the chain of S sites is cut into nb blocks of bs sites; global
// site s = j * bs + r. One thread owns one (block j, individual n) lane,
// lane = j * N + n, and walks its block's bs sites in a loop with the 2x2
// carry in registers. The genotype-likelihood channels gl0 / gl2 are
// slabs [bs, nb, N] (site-in-block major), so that at a fixed r the
// threads of a warp read neighbouring addresses; per-site freq / dist
// are [bs, nb] and reach the N threads of a block through the cache.
//
// Pads (sites past S in the last block) carry freq = 2 (sentinel:
// emission exactly 1) and dist = 0 (identity transition): exact no-ops.
//
// Everything here is compiled with -fmad=false: the grad kernel's primal
// rows must equal the transfer kernel's output bit for bit, and both get
// their primal from the functions below.
#pragma once
#include <cuda_runtime.h>

#define NGSF_TINY 1e-30f
#define NGSF_LN2 0.6931471805599453f
#define NGSF_HET_FLOOR 1e-15f
#define NGSF_UNROLL 4

struct SiteK {   // per (site, lane): emissions and the decay x = exp(-a d)
    float e0, e1, x, onem, d;
};

// In-kernel emission prologue: e_k = sum_g gl_g P(g | f, F = k) with the
// state-0 HWE and state-1 full-IBD priors; gl1 = 1 - gl0 - gl2. The
// sentinel f > 1 marks a pad cell: every prior coefficient 0 and the
// indicator 1, so e == 1 exactly whatever the gl bytes are.
__device__ __forceinline__ SiteK site_load(float g0, float g2, float f,
                                           float d, float a) {
    const bool pad = f > 1.0f;
    const float one_m = 1.0f - f;
    const float pq = one_m * f;
    const float i0 = pad ? 1.0f : 0.0f;
    const float pr0 = pad ? 0.0f : one_m * one_m;
    const float pq2 = pad ? 0.0f : 2.0f * pq;
    const float pr2 = pad ? 0.0f : f * f;
    const float s10 = pad ? 0.0f : (one_m * one_m + pq);
    const float het = pad ? 0.0f : NGSF_HET_FLOOR;
    const float s12 = pad ? 0.0f : (f * f + pq);
    const float g1 = 1.0f - g0 - g2;
    SiteK k;
    k.e0 = i0 + g0 * pr0 + g1 * pq2 + g2 * pr2;
    k.e1 = i0 + g0 * s10 + g1 * het + g2 * s12;
    k.x = expf(-a * d);
    k.onem = 1.0f - k.x;
    k.d = d;
    return k;
}

// The site's 2x2 matrix M = T(d) . diag(e0, e1), row-major (from, to).
__device__ __forceinline__ void site_matrix(const SiteK& k, float F,
                                            float& m00, float& m01,
                                            float& m10, float& m11) {
    const float t00 = k.onem * (1.0f - F) + k.x;
    const float t01 = k.onem * F;
    const float t10 = k.onem * (1.0f - F);
    const float t11 = k.onem * F + k.x;
    m00 = t00 * k.e0;
    m01 = t01 * k.e1;
    m10 = t10 * k.e0;
    m11 = t11 * k.e1;
}

// Exact power-of-two rescale: scale = 2^-e with e = floor(log2(mx)) read
// from mx's exponent field; multiplying by it is exact and the exponents
// add up as integers.
__device__ __forceinline__ float pow2_scale(float mx, int& ex) {
    const int exb = __float_as_int(mx) >> 23;  // biased exponent (mx > 0)
    ex += exb - 127;
    return __int_as_float((254 - exb) << 23);
}

__device__ __forceinline__ float max4(float a, float b, float c, float d) {
    return fmaxf(fmaxf(a, b), fmaxf(c, d));
}

// Loads one chunk of NGSF_UNROLL sites of a lane; sites at or past bs get
// the pad values, so the chunk's tail is a no-op.
__device__ __forceinline__ void chunk_load(
    const float* __restrict__ g0, const float* __restrict__ g2,
    const float* __restrict__ fc, const float* __restrict__ dc,
    int r0, int bs, int nb, int j, long long lane, long long lanes,
    float* a0, float* a2, float* ff, float* dd) {
#pragma unroll
    for (int u = 0; u < NGSF_UNROLL; ++u) {
        const int r = r0 + u;
        if (r < bs) {
            const long long o = (long long)r * lanes + lane;
            a0[u] = __ldg(g0 + o);
            a2[u] = __ldg(g2 + o);
            ff[u] = __ldg(fc + (long long)r * nb + j);
            dd[u] = __ldg(dc + (long long)r * nb + j);
        } else {
            a0[u] = a2[u] = 1.0f / 3.0f;
            ff[u] = 2.0f;
            dd[u] = 0.0f;
        }
    }
}
