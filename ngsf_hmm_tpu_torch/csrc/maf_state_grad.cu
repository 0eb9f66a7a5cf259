// Kernel A of the freq M-step: K0 real damped est_maf passes per site
// (each a reduction over the site's individuals), then the sums and their
// freq-derivatives at the freq reached.
// Replaces ngsf_hmm_tpu/ops/maf_pallas.py:_run_state_grad_slab. Two
// exports: ngsf_maf_state_grad on float32 gl slabs, ngsf_maf_state_grad_bf16
// on bfloat16 ones (upcast at load).
//
// Bound by instruction issue, not bytes (chip_smoke.py's probes, PERF.md
// section 7): the three slabs are read once, but every cell is evaluated
// K0 + 1 times. The design cuts the instructions a pass:
//   * G lanes a site (8, 16 or 32, chosen from N by
//     ops/maf_kernels.py:state_grad_geometry), 32 / G sites a warp, C cells
//     a lane with their planes in registers (C == 0: recomputed from cache
//     at every evaluation, for large N), so the lane slots fill (N = 100:
//     G = 16, C = 7, 100 of 112) and each sum is a log2(G)-step butterfly
//     on the segment, shared by the warp's sites (MafSeg, maf_common.cuh);
//   * each cell in the FMA form (maf_cell_fma); the reciprocal stays exact,
//     its range tested once a pass for all of a lane's cells (rcp_fast);
//   * a warp leaves its pass loop when all its sites are inactive; an
//     inactive site's pass is a no-op, as in the plain version.
// The sums over individuals run in another order than the plain version's
// torch.sum, and fused: chip_smoke.py holds the kernel to it at MAF_RTOL.
#include "maf_common.cuh"

template <int G, int C, class T>
__global__ void __launch_bounds__(32 * NGSF_MAF_WARPS)
    k_maf_state_grad(const T* __restrict__ g0, const T* __restrict__ g2,
                     const float* __restrict__ p,
                     float* __restrict__ out,  // [8, sites]
                     long long sites, int N, int K0) {
    constexpr int SPW = 32 / G;  // sites a warp
    const int lane = threadIdx.x & 31;
    const int sub = lane / G, gl = lane % G;
    const long long first =
        ((long long)blockIdx.x * NGSF_MAF_WARPS + (threadIdx.x >> 5)) * SPW;
    if (first >= sites) return;  // the whole warp
    const long long site = first + sub;
    const bool valid = site < sites;
    MafSeg<G, C, T> s;
    s.load(g0, g2, p, valid ? site : first, valid, N, gl, false);

    float freq = 0.01f, num = 0.0f, den = 0.0f;
    float active = valid ? 1.0f : 0.0f;
    float a, b, da, db;
    for (int k = 0; k < K0; ++k) {
        if (!__any_sync(0xffffffffu, active != 0.0f)) break;
        s.template sums<false>(freq, a, b, da, db);
        maf_advance(freq, num, den, active, seg_sum<G>(a),
                    s.T2mF + seg_sum<G>(b), k + 1 <= NGSF_MAF_ITER_MAX);
    }
    s.template sums<true>(freq, a, b, da, db);
    const float cn = seg_sum<G>(a), cd = s.T2mF + seg_sum<G>(b);
    const float dcn = seg_sum<G>(da), dcd = seg_sum<G>(db);
    const float row[8] = {freq, num, den, active, cn, cd, dcn, dcd};
    float v = row[0];
#pragma unroll
    for (int k = 1; k < 8; ++k) v = gl == k ? row[k] : v;
    if (valid && gl < 8) out[(long long)gl * sites + site] = v;
}

template <int G, int C, class T>
static void launch_gc(const T* g0, const T* g2, const float* p, float* out,
                      long long sites, int N, int K0, cudaStream_t stream) {
    k_maf_state_grad<G, C, T><<<maf_seg_grid<G>(sites), 32 * NGSF_MAF_WARPS,
                                0, stream>>>(g0, g2, p, out, sites, N, K0);
}

// The (G, C) pairs ops/maf_kernels.py:state_grad_geometry can choose.
template <class T>
static int launch(const T* g0, const T* g2, const float* p, float* out,
                  long long sites, int N, int K0, int G, int C,
                  void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
#define GC(g, c)                                                        \
    if (G == g && C == c) {                                             \
        launch_gc<g, c, T>(g0, g2, p, out, sites, N, K0, s);            \
        return (int)cudaGetLastError();                                 \
    }
    GC(8, 1) GC(8, 2) GC(8, 3) GC(8, 4) GC(8, 5) GC(8, 6) GC(8, 7) GC(8, 8)
    GC(16, 5) GC(16, 6) GC(16, 7) GC(16, 8)
    GC(32, 5) GC(32, 6) GC(32, 7) GC(32, 8) GC(32, 0)
#undef GC
    return (int)cudaErrorInvalidValue;
}

extern "C" int ngsf_maf_state_grad(const float* g0, const float* g2,
                                   const float* p, float* out,
                                   long long sites, int N, int K0, int G,
                                   int C, void* stream) {
    return launch(g0, g2, p, out, sites, N, K0, G, C, stream);
}

extern "C" int ngsf_maf_state_grad_bf16(const __nv_bfloat16* g0,
                                        const __nv_bfloat16* g2,
                                        const float* p, float* out,
                                        long long sites, int N, int K0,
                                        int G, int C, void* stream) {
    return launch(g0, g2, p, out, sites, N, K0, G, C, stream);
}
