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
//     on the segment, shared by the warp's sites;
//   * each cell in the FMA form (maf_cell_fma); the reciprocal stays exact,
//     its range tested once a pass for all of a lane's cells (rcp_fast);
//   * a warp leaves its pass loop when all its sites are inactive; an
//     inactive site's pass is a no-op, as in the plain version.
// The sums over individuals run in another order than the plain version's
// torch.sum, and fused: chip_smoke.py holds the kernel to it at MAF_RTOL.
#include <type_traits>

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
    const long long base = (valid ? site : first) * N;
    const T* s0 = g0 + base;
    const T* s2 = g2 + base;
    const float* sp = p + base;

    MafPlanes q[C > 0 ? C : 1];
    float t = 0.0f;
    if (C > 0) {
#pragma unroll
        for (int c = 0; c < (C > 0 ? C : 1); ++c) {
            const int n = gl + G * c;
            if (valid && n < N) {
                const float F = __ldg(sp + n);
                q[c] = maf_planes(ld_gl(s0 + n), ld_gl(s2 + n), F);
                t += 2.0f - F;
            } else {
                q[c] = maf_planes_none();
            }
        }
    } else if (valid) {
        for (int n = gl; n < N; n += G) t += 2.0f - __ldg(sp + n);
    }
    const float T2mF = seg_sum<G>(t);

    // the lane's partial sums at freq f
    auto sums = [&](auto grad, float f, float& a, float& b, float& da,
                    float& db) {
        constexpr bool GRAD = decltype(grad)::value;
        const float g = __fmaf_rn(-f, f, f);
        a = b = da = db = 0.0f;
        if (C > 0) {
            constexpr int CC = C > 0 ? C : 1;
            float dn[CC], lo, hi;
#pragma unroll
            for (int c = 0; c < CC; ++c) {
                dn[c] = maf_den(q[c], f);
                lo = c ? fminf(lo, dn[c]) : dn[c];
                hi = c ? fmaxf(hi, dn[c]) : dn[c];
            }
            if (__all_sync(0xffffffffu, lo >= NGSF_RCP_FAST_LO &&
                                            hi < NGSF_RCP_FAST_HI)) {
#pragma unroll
                for (int c = 0; c < CC; ++c)
                    maf_cell_fma<GRAD>(q[c], f, g, rcp_fast(dn[c]), a, b,
                                       da, db);
                return;
            }
#pragma unroll
            for (int c = 0; c < CC; ++c)
                maf_cell_fma<GRAD>(q[c], f, g, 1.0f / dn[c], a, b, da, db);
        } else if (valid) {
            for (int n = gl; n < N; n += G) {
                const MafPlanes pl = maf_planes(ld_gl(s0 + n),
                                                ld_gl(s2 + n), __ldg(sp + n));
                maf_cell_fma<GRAD>(pl, f, g, 1.0f / maf_den(pl, f), a, b, da,
                                   db);
            }
        }
    };

    float freq = 0.01f, num = 0.0f, den = 0.0f;
    float active = valid ? 1.0f : 0.0f;
    float a, b, da, db;
    for (int k = 0; k < K0; ++k) {
        if (!__any_sync(0xffffffffu, active != 0.0f)) break;
        sums(std::false_type{}, freq, a, b, da, db);
        maf_advance(freq, num, den, active, seg_sum<G>(a),
                    T2mF + seg_sum<G>(b), k + 1 <= NGSF_MAF_ITER_MAX);
    }
    sums(std::true_type{}, freq, a, b, da, db);
    const float cn = seg_sum<G>(a), cd = T2mF + seg_sum<G>(b);
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
    const long long warps = (sites + 32 / G - 1) / (32 / G);
    k_maf_state_grad<G, C, T>
        <<<(unsigned)((warps + NGSF_MAF_WARPS - 1) / NGSF_MAF_WARPS),
           32 * NGSF_MAF_WARPS, 0, stream>>>(g0, g2, p, out, sites, N, K0);
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
