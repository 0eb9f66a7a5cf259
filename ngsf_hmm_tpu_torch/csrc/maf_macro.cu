// The macro-stepped est_maf fixed point of the row layout, in one launch:
// per site, K0 real damped passes, then for each macro round one
// evaluation of the sums and their freq-derivatives (cn, cd, dcn, dcd) at
// the round's entry freq f0 and M_r virtual passes on the linearised
// model cn(f) = cn0 + dcn (f - f0), cd(f) = cd0 + dcd (f - f0)
// (ops/maf.py module docstring; gen_func.cpp:974-1009).
// Replaces ngsf_hmm_tpu/ops/maf_pallas.py:_run_macro, which runs the same
// schedule on [N, 1024]-site tiles with the windows inside the kernel.
// Bound about equally by bytes and by operations: g0, g2 and the posterior
// are read once (12 bytes a cell) against about 24 + 16 K0 + 31 R float
// operations a cell (R gradient rounds) plus 16 a window step a site; at
// 100 individuals (K0 = 8, R = 3) the operations lead by a few percent.
// The window steps, which every lane of the warp computes for its one
// site, cost issue slots that the split slab route (maf_state_grad,
// maf_window with a thread a site, maf_sums_grad) does not spend: that
// route is faster on the same data (PERF.md). One warp per site
// (maf_common.cuh): the cells' planes stay in registers for N <= 128 and
// are recomputed from cache above; the per-site state (freq, num, den,
// active, passes) lives in registers through the whole schedule, so the
// windows cost no launches and no bytes. A site that goes inactive leaves
// the schedule (an inactive site advances as a no-op, so this equals the
// TPU kernel's exit per tile).
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

template <int CPL, class T>
__global__ void k_maf_macro(const T* __restrict__ g0,
                            const T* __restrict__ g2,
                            const float* __restrict__ p,
                            float* __restrict__ out,  // [sites]
                            long long sites, int N, int K0,
                            MafRounds rounds) {
    NGSF_MAF_WARP_SITE()
    MafSite<CPL, T> s;
    s.load(g0, g2, p, site, N, lane);
    float freq = 0.01f, num = 0.0f, den = 0.0f, active = 1.0f;
    float cn, cd, dcn = 0.0f, dcd = 0.0f;
    for (int k = 0; k < K0 && active != 0.0f; ++k) {
        s.template sums<false>(freq, cn, cd, dcn, dcd);
        maf_advance(freq, num, den, active, cn, cd,
                    k + 1 <= NGSF_MAF_ITER_MAX);
    }
    int passes = K0;
    for (int r = 0; r < rounds.n && active != 0.0f; ++r) {
        const int M = rounds.m[r];
        s.template sums<true>(freq, cn, cd, dcn, dcd);
        const float f0 = freq;
        for (int k = 0; k < M && active != 0.0f; ++k) {
            const float df = freq - f0;
            maf_advance(freq, num, den, active, cn + dcn * df,
                        cd + dcd * df, passes + k + 1 <= NGSF_MAF_ITER_MAX);
        }
        passes += M;
    }
    if (lane == 0) out[site] = freq;
}

template <class T>
static int launch(const T* g0, const T* g2, const float* p, float* out,
                  long long sites, int N, int K0, const int* ms,
                  int n_rounds, void* stream) {
    if (n_rounds < 0 || n_rounds > NGSF_MAF_MAX_ROUNDS)
        return (int)cudaErrorInvalidValue;
    MafRounds rounds;
    rounds.n = n_rounds;
    for (int r = 0; r < NGSF_MAF_MAX_ROUNDS; ++r)
        rounds.m[r] = r < n_rounds ? ms[r] : 0;
#define CALL(C)                                                            \
    k_maf_macro<C, T><<<NGSF_MAF_GRID(sites), 32 * NGSF_MAF_WARPS, 0,      \
                        (cudaStream_t)stream>>>(g0, g2, p, out, sites, N,  \
                                                K0, rounds);
    NGSF_MAF_DISPATCH(N, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

extern "C" int ngsf_maf_macro(const float* g0, const float* g2,
                              const float* p, float* out, long long sites,
                              int N, int K0, const int* ms, int n_rounds,
                              void* stream) {
    return launch(g0, g2, p, out, sites, N, K0, ms, n_rounds, stream);
}

extern "C" int ngsf_maf_macro_bf16(const __nv_bfloat16* g0,
                                   const __nv_bfloat16* g2, const float* p,
                                   float* out, long long sites, int N, int K0,
                                   const int* ms, int n_rounds,
                                   void* stream) {
    return launch(g0, g2, p, out, sites, N, K0, ms, n_rounds, stream);
}
