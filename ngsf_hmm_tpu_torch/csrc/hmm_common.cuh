// Shared device code of the HMM chain kernels.
//
// Layout: the chain of S sites is cut into nb blocks of bs sites; global
// site s = j * bs + r. One thread owns one (block j, column n) lane,
// lane = j * N + n, and walks its block's bs sites in a loop with the 2x2
// carry in registers. The streamed channels are slabs [bs, nb, N]
// (site-in-block major), so that at a fixed r the threads of a warp read
// neighbouring addresses; per-site values are [bs, nb] compacts and reach
// the N threads of a block through the cache.
//
// Two emission sources feed the same stream kernels (each kernel is a
// template over the source, instantiated once for each):
//   GlSource  (v2, "gl layout"): gl0 / gl2 slabs + the per-site freq
//             compact; the emissions are built in-kernel. Pads carry
//             freq = 2 (sentinel: emission exactly 1). A template over
//             the slabs' storage type: float, or __nv_bfloat16 upcast at
//             load (gl_load.cuh), so each kernel has a float32 and a
//             bfloat16 gl export.
//   EmSource  (v1, "emission layout"): precomputed linear emission slabs
//             e0 / e1 (columns = individuals, or replicate x individual
//             when replicates are flattened). Pads carry e = 1.
// Both read the per-site distance compact; pads carry dist = 0 (identity
// transition), so pad sites are exact no-ops.
//
// Everything here is compiled with -fmad=false: the grad kernel's primal
// rows must equal the transfer kernel's output bit for bit, and both get
// their primal from the functions below.
#pragma once
#include <cuda_runtime.h>

#include "gl_load.cuh"

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
// indicator 1, so e == 1 exactly whatever the gl bytes are. The prior
// coefficients depend on the site only (site_prior); a kernel may compute
// them once per (site, block) and hand them to its lanes, which then get
// the same bits as site_load.
struct Prior {
    float i0, pr0, pq2, pr2, s10, het, s12;
};

__device__ __forceinline__ Prior site_prior(float f) {
    const bool pad = f > 1.0f;
    const float one_m = 1.0f - f;
    const float pq = one_m * f;
    Prior q;
    q.i0 = pad ? 1.0f : 0.0f;
    q.pr0 = pad ? 0.0f : one_m * one_m;
    q.pq2 = pad ? 0.0f : 2.0f * pq;
    q.pr2 = pad ? 0.0f : f * f;
    q.s10 = pad ? 0.0f : (one_m * one_m + pq);
    q.het = pad ? 0.0f : NGSF_HET_FLOOR;
    q.s12 = pad ? 0.0f : (f * f + pq);
    return q;
}

__device__ __forceinline__ SiteK site_emit(float g0, float g2,
                                           const Prior& q, float d,
                                           float a) {
    const float g1 = 1.0f - g0 - g2;
    SiteK k;
    k.e0 = q.i0 + g0 * q.pr0 + g1 * q.pq2 + g2 * q.pr2;
    k.e1 = q.i0 + g0 * q.s10 + g1 * q.het + g2 * q.s12;
    k.x = expf(-a * d);
    k.onem = 1.0f - k.x;
    k.d = d;
    return k;
}

__device__ __forceinline__ SiteK site_load(float g0, float g2, float f,
                                           float d, float a) {
    return site_emit(g0, g2, site_prior(f), d, a);
}

// Emission-slab site: precomputed linear emissions, the same decay.
__device__ __forceinline__ SiteK site_em(float e0, float e1, float d,
                                         float a) {
    SiteK k;
    k.e0 = e0;
    k.e1 = e1;
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

// v2 source: emissions from (gl0, gl2, freq) through site_load; T is the
// slabs' storage type (float or __nv_bfloat16).
template <class T>
struct GlSource {
    using Elem = T;
    const T* a;       // gl0 slab [bs, nb, N]
    const T* b;       // gl2 slab [bs, nb, N]
    const float* fc;  // freq compact [bs, nb], pad 2.0
    const float* dc;  // dist compact [bs, nb], pad 0
    static constexpr bool kFreq = true;
    static constexpr float kPad = 1.0f / 3.0f;  // pad gl (any value works)
    __device__ __forceinline__ SiteK site(float g0, float g2, float f,
                                          float d, float al) const {
        return site_load(g0, g2, f, d, al);
    }
};

// v1 source: precomputed linear emissions; a pad cell holds e = 1.
struct EmSource {
    using Elem = float;
    const float* a;   // e0 slab [bs, nb, L]
    const float* b;   // e1 slab [bs, nb, L]
    const float* fc;  // unused
    const float* dc;  // dist compact [bs, nb], pad 0
    static constexpr bool kFreq = false;
    static constexpr float kPad = 1.0f;
    __device__ __forceinline__ SiteK site(float e0, float e1, float,
                                          float d, float al) const {
        return site_em(e0, e1, d, al);
    }
};

// Loads one chunk of NGSF_UNROLL sites of a lane; sites at or past bs get
// the pad values, so the chunk's tail is a no-op.
template <class Src>
__device__ __forceinline__ void chunk_load(
    const Src& src, int r0, int bs, int nb, int j, long long lane,
    long long lanes, float* a0, float* a2, float* ff, float* dd) {
#pragma unroll
    for (int u = 0; u < NGSF_UNROLL; ++u) {
        const int r = r0 + u;
        if (r < bs) {
            const long long o = (long long)r * lanes + lane;
            a0[u] = ld_gl(src.a + o);
            a2[u] = ld_gl(src.b + o);
            ff[u] = Src::kFreq ? __ldg(src.fc + (long long)r * nb + j) : 0.0f;
            dd[u] = __ldg(src.dc + (long long)r * nb + j);
        } else {
            a0[u] = a2[u] = Src::kPad;
            ff[u] = 2.0f;
            dd[u] = 0.0f;
        }
    }
}
