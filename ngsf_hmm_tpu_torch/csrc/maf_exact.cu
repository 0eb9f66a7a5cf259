// The exact damped est_maf fixed point: per site, passes until the freq
// moves by no more than EPSILON or ITER_MAX + 1 passes are done
// (gen_func.cpp:974-1009, with the never-reset num / den accumulators).
// Replaces ngsf_hmm_tpu/ops/maf_pallas.py:_run. It serves runs with fewer
// than 32 individuals, which have no macro schedule.
//
// Bound by instruction issue: the three slabs are read once (12 bytes a
// cell), but on realistic likelihoods nearly every site runs all
// ITER_MAX + 1 passes, each about 16 float operations a cell. The design
// is kernel A's (maf_state_grad.cu), so a pass costs few instructions at
// small N:
//   * G lanes a site (1, 2, 4, 8, 16 or 32, chosen from N by
//     ops/maf_kernels.py:exact_geometry), 32 / G sites a warp, C cells a
//     lane with their planes in registers (C == 0: recomputed from cache
//     at every pass, for large N); N = 20: G = 4, C = 5, 8 sites a warp,
//     no empty slot, and each sum a two-step butterfly on the segment;
//   * each cell in the Horner planes and FMA form of maf_common.cuh
//     (maf_den, maf_cell_fma without its derivative terms); the reciprocal
//     exact, its range tested once a pass for all of a lane's cells
//     (rcp_fast); maf_advance keeps its true division, which the exit test
//     needs;
//   * a warp leaves its pass loop when all its sites are inactive; an
//     inactive site's pass is a no-op, so the result does not depend on
//     the geometry.
// Reads the gl0 / gl2 slabs with gl1 = 1 - gl0 - gl2 and the posterior
// slab; snap != 0 applies check_interv's snap (maf_snap) to the posterior
// as it is read, before its planes are formed. The sums run in another
// order than the plain version's torch.sum, and fused: chip_smoke.py
// holds the kernel to it at MAF_RTOL.
#include "maf_common.cuh"

template <int G, int C>
__global__ void __launch_bounds__(32 * NGSF_MAF_WARPS)
    k_maf_exact(const float* __restrict__ g0, const float* __restrict__ g2,
                const float* __restrict__ p,
                float* __restrict__ out,  // [sites]
                long long sites, int N, int snap) {
    constexpr int SPW = 32 / G;  // sites a warp
    const int lane = threadIdx.x & 31;
    const int sub = lane / G, gl = lane % G;
    const long long first =
        ((long long)blockIdx.x * NGSF_MAF_WARPS + (threadIdx.x >> 5)) * SPW;
    if (first >= sites) return;  // the whole warp
    const long long site = first + sub;
    const bool valid = site < sites;
    MafSeg<G, C, float> s;
    s.load(g0, g2, p, valid ? site : first, valid, N, gl, snap != 0);

    float freq = 0.01f, num = 0.0f, den = 0.0f;
    float active = valid ? 1.0f : 0.0f;
    for (int k = 0; __any_sync(0xffffffffu, active != 0.0f); ++k) {
        float a, b, da, db;
        s.template sums<false>(freq, a, b, da, db);
        maf_advance(freq, num, den, active, seg_sum<G>(a),
                    s.T2mF + seg_sum<G>(b), k + 1 <= NGSF_MAF_ITER_MAX);
    }
    if (valid && gl == 0) out[site] = freq;
}

// The (G, C) pairs ops/maf_kernels.py:exact_geometry can choose.
extern "C" int ngsf_maf_exact(const float* g0, const float* g2,
                              const float* p, float* out, long long sites,
                              int N, int snap, int G, int C, void* stream) {
#define GC(g, c)                                                          \
    if (G == g && C == c) {                                               \
        k_maf_exact<g, c><<<maf_seg_grid<g>(sites), 32 * NGSF_MAF_WARPS, 0, \
                            (cudaStream_t)stream>>>(g0, g2, p, out, sites,  \
                                                    N, snap);               \
        return (int)cudaGetLastError();                                   \
    }
    GC(1, 1) GC(1, 2) GC(1, 3) GC(1, 4) GC(1, 5) GC(1, 6) GC(1, 7) GC(1, 8)
    GC(2, 5) GC(2, 6) GC(2, 7) GC(2, 8)
    GC(4, 5) GC(4, 6) GC(4, 7) GC(4, 8)
    GC(8, 5) GC(8, 6) GC(8, 7) GC(8, 8)
    GC(16, 5) GC(16, 6) GC(16, 7) GC(16, 8)
    GC(32, 5) GC(32, 6) GC(32, 7) GC(32, 8) GC(32, 0)
#undef GC
    return (int)cudaErrorInvalidValue;
}
