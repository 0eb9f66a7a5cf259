// The macro-stepped est_maf fixed point of the row layout, in one launch:
// per site, K0 real damped passes, then for each macro round one
// evaluation of the sums and their freq-derivatives (cn, cd, dcn, dcd) at
// the round's entry freq f0 and M_r virtual passes on the linearised
// model cn(f) = cn0 + dcn (f - f0), cd(f) = cd0 + dcd (f - f0)
// (ops/maf.py module docstring; gen_func.cpp:974-1009).
// Replaces ngsf_hmm_tpu/ops/maf_pallas.py:_run_macro, which runs the same
// schedule on [N, 1024]-site tiles with the windows inside the kernel.
//
// g0, g2 and the posterior are read once (12 bytes a cell) against about
// 24 + 16 K0 + 31 R float operations a cell (R gradient rounds) plus 16 a
// window step a site: bound by operations, and on the card by
// instruction issue in the passes and gradient rounds and by the
// dependent chain of the window steps (a true division each). The design:
//   * the real passes and the gradient rounds are kernel A's
//     (maf_state_grad.cu): G lanes a site and C cells a lane from
//     ops/maf_kernels.py:state_grad_geometry (MafSeg, maf_common.cuh),
//     fused cells, the reciprocal's range tested once a pass, the sums a
//     butterfly on the segment; a warp skips its passes and gradient
//     evaluations once all its sites are inactive; at most 80 registers,
//     so that an SM holds 3 blocks, as it holds kernel A's;
//   * the windows, scalar work of one site each, run once a site, not on
//     every lane of its segment: after the real passes the segments'
//     first lanes hand (freq, num, den, active) to shared memory, and
//     thread t < 8 * 32 / G of the block (in warp 0) carries the state of
//     the block's site t through every window; each round the segments
//     write their (cn, cd, dcn, dcd) there and read back the freq and
//     the active flag. A block holds 8, 16 or 32 sites, so one warp
//     serves its windows. A window step of an active site drops the
//     multiplies by the active flag (maf_advance_active, the same bits);
//   * the block leaves the schedule when none of its sites is active
//     (__syncthreads_or); an inactive site advances as a no-op, so this
//     equals the plain version's rounds and the TPU kernel's exit per
//     tile.
// A block's warps wait while its windows run; the other blocks of the SM
// issue meanwhile. Windows run by each segment's first lane, by one warp
// for every 1, 2 or 4 warps, and blocks of 12 or 24 warps were slower on
// the card.
// The sums run in another order than the plain version's torch.sum, and
// fused: chip_smoke.py holds the kernel to it at MAF_RTOL, as kernel A.
// Layout: g0 / g2 / p are [sites, N] rows (site s at row s); freq [sites].
//
// The same template also replaces ngsf_hmm_tpu/ops/maf_pallas.py
// :_run_macro_slab, the same schedule on the gl slabs: the port's slabs
// [bs, nb, N] are already rows of N cells (row r * nb + j is site
// j * bs + r), so that kernel is this one on the [bs * nb, N] view of the
// slabs. What it adds is its input type: the gl slabs may be stored in
// bfloat16 (upcast at load, gl_load.cuh). Two exports:
//   ngsf_maf_macro       float32 g0 / g2 (the rows of the LD path, or the
//                        float32 gl slabs)
//   ngsf_maf_macro_bf16  bfloat16 g0 / g2 slabs (8 bytes a cell in all)
#include "maf_common.cuh"

#define NGSF_MAF_MAX_ROUNDS 8

struct MafRounds {
    int n;
    int m[NGSF_MAF_MAX_ROUNDS];
};

template <int G, int C, class T>
__global__ void __launch_bounds__(32 * NGSF_MAF_WARPS, 3)
    k_maf_macro(const T* __restrict__ g0, const T* __restrict__ g2,
                const float* __restrict__ p,
                float* __restrict__ out,  // [sites]
                long long sites, int N, int K0, MafRounds rounds) {
    constexpr int SPW = 32 / G;                  // sites a warp
    constexpr int SPB = SPW * NGSF_MAF_WARPS;    // sites a block, <= 32
    __shared__ float st[4][SPB];  // freq, num, den, active
    __shared__ float gr[4][SPB];  // cn, cd, dcn, dcd
    const int t = threadIdx.x, lane = t & 31;
    const int sub = lane / G, gl = lane % G;
    const int slot = (t >> 5) * SPW + sub;  // the site's slot in the block
    const long long first = (long long)blockIdx.x * SPB;
    const long long site = first + slot;
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

    // thread t < SPB (the carrier of slot t) takes (freq, num, den,
    // active) from here
    if (gl == 0) {
        st[0][slot] = freq;
        st[1][slot] = num;
        st[2][slot] = den;
        st[3][slot] = active;
    }
    const bool carrier = t < SPB;
    int go = __syncthreads_or(active != 0.0f);
    float wf = 0.0f, wn = 0.0f, wd = 0.0f, wa = 0.0f;
    if (carrier) {
        wf = st[0][t];
        wn = st[1][t];
        wd = st[2][t];
        wa = st[3][t];
    }
    int passes = K0;
    for (int r = 0; r < rounds.n && go; ++r) {
        const int M = rounds.m[r];
        if (__any_sync(0xffffffffu, active != 0.0f)) {
            s.template sums<true>(freq, a, b, da, db);
            const float cn = seg_sum<G>(a), cd = s.T2mF + seg_sum<G>(b);
            const float dcn = seg_sum<G>(da), dcd = seg_sum<G>(db);
            if (gl == 0) {
                gr[0][slot] = cn;
                gr[1][slot] = cd;
                gr[2][slot] = dcn;
                gr[3][slot] = dcd;
            }
        }
        __syncthreads();
        if (carrier && wa != 0.0f) {  // the window of an active site
            const float cn0 = gr[0][t], cd0 = gr[1][t], dcn = gr[2][t],
                        dcd = gr[3][t];
            const float f0 = wf;
            bool on = true;
            for (int k = 0; k < M && on; ++k) {
                const float df = wf - f0;
                on = maf_advance_active(wf, wn, wd, cn0 + dcn * df,
                                        cd0 + dcd * df,
                                        passes + k + 1 <= NGSF_MAF_ITER_MAX);
            }
            wa = on ? 1.0f : 0.0f;
            st[0][t] = wf;
            st[3][t] = wa;
        }
        passes += M;
        go = __syncthreads_or(carrier && wa != 0.0f);
        freq = st[0][slot];
        active = st[3][slot];
    }
    if (carrier && first + t < sites) out[first + t] = wf;
}

template <class T>
static int launch(const T* g0, const T* g2, const float* p, float* out,
                  long long sites, int N, int K0, const int* ms,
                  int n_rounds, int G, int C, void* stream) {
    if (n_rounds < 0 || n_rounds > NGSF_MAF_MAX_ROUNDS)
        return (int)cudaErrorInvalidValue;
    MafRounds rounds;
    rounds.n = n_rounds;
    for (int r = 0; r < NGSF_MAF_MAX_ROUNDS; ++r)
        rounds.m[r] = r < n_rounds ? ms[r] : 0;
    const cudaStream_t s = (cudaStream_t)stream;
    // the (G, C) pairs ops/maf_kernels.py:state_grad_geometry can choose
#define GC(g, c)                                                         \
    if (G == g && C == c) {                                              \
        k_maf_macro<g, c, T><<<maf_seg_grid<g>(sites),                   \
                               32 * NGSF_MAF_WARPS, 0, s>>>(             \
            g0, g2, p, out, sites, N, K0, rounds);                       \
        return (int)cudaGetLastError();                                  \
    }
    GC(8, 1) GC(8, 2) GC(8, 3) GC(8, 4) GC(8, 5) GC(8, 6) GC(8, 7) GC(8, 8)
    GC(16, 5) GC(16, 6) GC(16, 7) GC(16, 8)
    GC(32, 5) GC(32, 6) GC(32, 7) GC(32, 8) GC(32, 0)
#undef GC
    return (int)cudaErrorInvalidValue;
}

extern "C" int ngsf_maf_macro(const float* g0, const float* g2,
                              const float* p, float* out, long long sites,
                              int N, int K0, const int* ms, int n_rounds,
                              int G, int C, void* stream) {
    return launch(g0, g2, p, out, sites, N, K0, ms, n_rounds, G, C, stream);
}

extern "C" int ngsf_maf_macro_bf16(const __nv_bfloat16* g0,
                                   const __nv_bfloat16* g2, const float* p,
                                   float* out, long long sites, int N, int K0,
                                   const int* ms, int n_rounds, int G, int C,
                                   void* stream) {
    return launch(g0, g2, p, out, sites, N, K0, ms, n_rounds, G, C, stream);
}
