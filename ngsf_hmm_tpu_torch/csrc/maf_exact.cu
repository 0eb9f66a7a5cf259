// The exact damped est_maf fixed point: per site, passes until the freq
// moves by no more than EPSILON or ITER_MAX + 1 passes are done
// (gen_func.cpp:974-1009, with the never-reset num / den accumulators).
// Replaces ngsf_hmm_tpu/ops/maf_pallas.py:_run. It serves runs with fewer
// than 32 individuals, which have no macro schedule.
// Bound by operations: up to 101 passes of about 21 float operations a
// cell against 12 bytes a cell read once. One warp per site with the
// cells in registers; each site stops at its own convergence.
// Reads the gl0 / gl2 slabs with gl1 = 1 - gl0 - gl2 and the posterior
// slab; snap != 0 applies check_interv's snap (within EPSILON of {0, 1}
// -> exactly {0, 1}, gen_func.cpp:55-70) to the posterior as it is read.
#include "maf_common.cuh"

struct ExactCell {
    float g0, g1, g2, F, two_m_F, tn1;
    bool het;
};

__device__ __forceinline__ ExactCell exact_cell(float g0, float g2, float F,
                                                int snap) {
    if (snap) {
        F = F < NGSF_MAF_EPSILON ? 0.0f : F;
        F = F > 1.0f - NGSF_MAF_EPSILON ? 1.0f : F;
    }
    ExactCell c;
    c.g0 = g0;
    c.g1 = 1.0f - g0 - g2;
    c.g2 = g2;
    c.F = F;
    c.two_m_F = 2.0f - F;
    c.tn1 = 2.0f - 2.0f * F;
    c.het = F == 1.0f;
    return c;
}

__device__ __forceinline__ void exact_terms(const ExactCell& c, float f,
                                            float& cn, float& cd) {
    const float pq = (1.0f - f) * f;
    const float a = pq * c.F;
    const float pr0 = (1.0f - f) * (1.0f - f) + a;
    const float pr1 = c.het ? 1e-15f : pq * c.tn1;
    const float pr2 = f * f + a;
    const float n0 = c.g0 * pr0;
    const float n1 = c.g1 * pr1;
    const float n2 = c.g2 * pr2;
    const float inv = 1.0f / (n0 + n1 + n2);
    const float pp1 = n1 * inv;
    const float pp2 = n2 * inv;
    cn += pp1 + pp2 * c.two_m_F;
    cd += pp1 * c.F;
}

template <int CPL>
__global__ void k_maf_exact(const float* __restrict__ g0,
                            const float* __restrict__ g2,
                            const float* __restrict__ p,
                            float* __restrict__ out,  // [sites]
                            long long sites, int N, int snap) {
    NGSF_MAF_WARP_SITE()
    g0 += site * N;
    g2 += site * N;
    p += site * N;
    ExactCell cell[CPL > 0 ? CPL : 1];
    float t = 0.0f;
    if (CPL > 0) {
#pragma unroll
        for (int c = 0; c < (CPL > 0 ? CPL : 1); ++c) {
            const int n = lane + 32 * c;
            if (n < N) {
                cell[c] = exact_cell(__ldg(g0 + n), __ldg(g2 + n),
                                     __ldg(p + n), snap);
                t += cell[c].two_m_F;
            } else {  // no such individual: skipped below
                cell[c] = exact_cell(1.0f, 0.0f, 0.0f, 0);
            }
        }
    } else {
        for (int n = lane; n < N; n += 32)
            t += exact_cell(0.0f, 0.0f, __ldg(p + n), snap).two_m_F;
    }
    const float T = warp_sum(t);

    float freq = 0.01f, num = 0.0f, den = 0.0f, active = 1.0f;
    for (int k = 0; active != 0.0f; ++k) {
        float a = 0.0f, b = 0.0f;
        if (CPL > 0) {
#pragma unroll
            for (int c = 0; c < (CPL > 0 ? CPL : 1); ++c)
                if (lane + 32 * c < N) exact_terms(cell[c], freq, a, b);
        } else {
            for (int n = lane; n < N; n += 32)
                exact_terms(exact_cell(__ldg(g0 + n), __ldg(g2 + n),
                                       __ldg(p + n), snap),
                            freq, a, b);
        }
        maf_advance(freq, num, den, active, warp_sum(a), T + warp_sum(b),
                    k + 1 <= NGSF_MAF_ITER_MAX);
    }
    if (lane == 0) out[site] = freq;
}

extern "C" int ngsf_maf_exact(const float* g0, const float* g2,
                              const float* p, float* out, long long sites,
                              int N, int snap, void* stream) {
#define CALL(C)                                                          \
    k_maf_exact<C><<<NGSF_MAF_GRID(sites), 32 * NGSF_MAF_WARPS, 0,       \
                     (cudaStream_t)stream>>>(g0, g2, p, out, sites, N,   \
                                             snap);
    NGSF_MAF_DISPATCH(N, CALL)
#undef CALL
    return (int)cudaGetLastError();
}
