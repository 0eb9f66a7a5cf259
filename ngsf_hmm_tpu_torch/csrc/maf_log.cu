// The exact damped est_maf fixed point in log space (gen_func.cpp:974-1009),
// the freq M-step of the scan tier: ngsf_hmm_tpu/ops/maf.py:est_maf with
// linear=False, macro=False (called at ngsf_hmm_tpu/models/em.py:572, and
// at init for --freq e). The JAX package runs it as one masked
// lax.while_loop over all sites; it has no TPU kernel, so this one is
// port-only. Per site and pass, for each individual i:
//   prior = calc_hwe(freq, F_i) in log space (log, -inf -> -BIG, the het
//   -BIG where F_i == 1; ops/hwe.py), pp = exp(post_prob(gl_i, prior))
//   (logsum3 normalisation), cn += pp1 + pp2 (2 - F_i), cd += pp1 F_i;
// then num += cn, den += T_w + cd (never reset; T_w = sum (2 - F_i)
// hoisted out of the passes), freq = num / den, from the cold start 0.01,
// until the post-increment test |prev - freq| > EPSILON && passes <=
// ITER_MAX fails.
//
// Bound by float64 operations: nearly every site runs all ITER_MAX + 1
// passes on realistic data, and a cell's pass is transcendentals, whose
// SASS (about 70 instructions an exp, 93 a log) the schedulers issue at
// about one instruction a cycle. What the design does about it:
//   * a site gets a segment of G lanes and a warp 32 / G sites, G chosen
//     from N (ops/maf.py:maf_log_geometry) so that nearly every lane slot
//     holds an individual; the sums are a butterfly of log2(G) steps;
//   * a site's cells (g0, g1, g2, F) are read from device memory once,
//     into shared memory, laid out so that a warp's 32 reads of one cell
//     round are 32 consecutive words (no bank conflict);
//   * the prior's three logs depend on the site's freq and the cell's F
//     alone, and the snapped posterior F is exactly 0 or 1 on most cells:
//     those five logs (F = 0: three; F = 1: two, the het being -BIG) are
//     taken once a site and pass, one a lane of the segment, and only the
//     other cells take their own three. The load puts those cells first
//     in the site's shared row, so a warp runs the three-log branch for
//     as many rounds as its fullest segment needs, not for every round;
//   * logsum3 takes two exps, not three (log_common.cuh).
// Every value of a cell is the old kernel's, bit for bit; the sums over a
// site's individuals are taken in another order (each lane's cells, then
// the butterfly), which the plain version's torch.sum does not share.
// Sites of a warp stop at different passes: a finished segment idles
// until the warp's last site stops (chip_smoke.py prints passes run
// against passes needed). Past MAF_LOG_SMEM_MAX bytes a warp (N in the
// thousands) the cells are read from device memory every pass instead
// (CELLS = false; one site a warp).
// F = p[site * ldp + i] (ldp: the row stride, so a replicate's columns of
// a flattened posterior are read in place); miss != 0 drops individuals
// whose three gl are EPSILON-equal (miss_data). Templated on the float
// type; float64 on the scan tier, float32 for --freq e on the fused tier.
#include "log_common.cuh"

#define ML_EPSILON 1e-5
#define ML_ITER_MAX 100
#define ML_BIG 1e15
#define ML_FULL 0xffffffffu

__device__ __forceinline__ float ml_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double ml_abs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T ml_floor(T lg) {
    return lg == (T)-INFINITY ? (T)-ML_BIG : lg;
}

template <typename T>
__device__ __forceinline__ T ml_flog(T h) {
    return ml_floor(lc_log(h));
}

// Sum over aligned segments of G lanes; every lane of a segment gets the
// same bits (each step adds the same two values, in either order).
template <int G, typename T>
__device__ __forceinline__ T seg_sum(T v) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(ML_FULL, v, o);
    return v;
}

template <typename T>
__device__ __forceinline__ bool ml_missing(T g0, T g1, T g2) {
    const T eps = (T)ML_EPSILON;
    return ml_abs(g0 - g1) < eps && ml_abs(g1 - g2) < eps;
}

// calc_hwe's pieces at the site's freq f (one pass): h0 = A + pq F, h1 =
// tpq - tpq F, h2 = B + pq F, in the old kernel's operation order.
template <typename T>
struct MlPass {
    T A, B, pq, tpq;
    __device__ __forceinline__ explicit MlPass(T f) {
        const T om = (T)1 - f;
        A = om * om;
        pq = om * f;
        tpq = (T)2 * pq;
        B = f * f;
    }
};

// One cell's contribution (cn, cd) at this pass. L5: the site's five
// snapped-prior logs, taken where F is 0 or 1; own: F is neither, take
// the cell's own three logs instead.
template <typename T>
__device__ __forceinline__ void ml_cell(const MlPass<T>& h, const T* L5,
                                        T g0, T g1, T g2, T F, bool own,
                                        int miss, T& cn, T& cd) {
    T l0, l1, l2;
    if (own) {
        const T pqF = h.pq * F;
        l0 = ml_flog(h.A + pqF);
        l1 = ml_flog(h.tpq - h.tpq * F);
        l2 = ml_flog(h.B + pqF);
    } else {
        const bool one = F == (T)1;
        l0 = one ? L5[3] : L5[0];
        l1 = one ? (T)-ML_BIG : L5[1];
        l2 = one ? L5[4] : L5[2];
    }
    // post_prob: the posteriors of the three genotypes
    const T a0 = g0 + l0, a1 = g1 + l1, a2 = g2 + l2;
    const T norm = log_sum3(a0, a1, a2);
    const T pp1 = lc_exp(a1 - norm), pp2 = lc_exp(a2 - norm);
    T vn = pp1 + pp2 * ((T)2 - F), vd = pp1 * F;
    if (miss && ml_missing(g0, g1, g2)) {  // w = 0: w * v as the old form
        vn = (T)0 * vn;
        vd = (T)0 * vd;
    }
    cn += vn;
    cd += vd;
}

// The site's five snapped-prior logs at this pass (F = 0: l0, l1, l2; F =
// 1: l0, l2), one a lane of the segment (s: the lane's index in it, base:
// the segment's first lane), shared with the segment by shuffles.
template <int G, typename T>
__device__ __forceinline__ void ml_site_logs(const MlPass<T>& h, int s,
                                             int base, T* L5) {
    constexpr int R = (5 + G - 1) / G;
    T mine[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int k = s + G * r;
        const T v = k == 0   ? h.A + h.pq * (T)0
                    : k == 1 ? h.tpq - h.tpq * (T)0
                    : k == 2 ? h.B + h.pq * (T)0
                    : k == 3 ? h.A + h.pq * (T)1
                             : h.B + h.pq * (T)1;
        mine[r] = ml_flog(v);
    }
#pragma unroll
    for (int k = 0; k < 5; ++k)
        L5[k] = __shfl_sync(ML_FULL, mine[k / G], base + k % G);
}

// CELLS: a site's cells in shared memory, snapped-prior cells last (the
// dynamic shared memory holds, per warp, 4 planes x G * C cells x 32 / G
// sites: plane a, cell j of the warp's site q at (a * G * C + j) * 32 / G
// + q). !CELLS: G == 32, one site a warp, cells read from device memory
// every pass.
template <typename T, int G, bool CELLS>
__global__ void k_maf_log(const T* __restrict__ gl,  // [S, N, 3] log
                          const T* __restrict__ p,   // [S, ldp] (F)
                          T* __restrict__ out,       // [S]
                          long long S, int N, long long ldp, int miss,
                          int C) {
    extern __shared__ __align__(16) unsigned char ml_smem[];
    constexpr int SPW = 32 / G;  // sites a warp
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int q = lane / G, s = lane % G, base = q * G;
    const long long site =
        ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * SPW + q;
    const bool valid = site < S;
    const T* g = gl + (valid ? site : 0) * N * 3;
    const T* f = p + (valid ? site : 0) * ldp;
    const int NP = G * C;  // a site's cell slots
    T* cells = reinterpret_cast<T*>(ml_smem) + (size_t)warp * 4 * NP * SPW;
    auto at = [&](int a, int j) -> T& { return cells[(a * NP + j) * SPW + q]; };
    const unsigned seg_mask = (G == 32 ? ML_FULL : ((1u << G) - 1u)) << base;
    const unsigned below = (1u << lane) - 1u;

    // T_w, and (CELLS) the site's cells into shared memory: the cells
    // whose F is neither 0 nor 1 from the front, the others from the back
    T tw = 0;
    int own = 0;  // cells that take their own prior logs (CELLS)
    int snapped = 0;
    for (int k = 0; k < C; ++k) {
        const int i = s + G * k;
        const bool in = valid && i < N;
        T g0 = 0, g1 = 0, g2 = 0, F = 0;
        if (in) {
            g0 = g[3 * i];
            g1 = g[3 * i + 1];
            g2 = g[3 * i + 2];
            F = f[i];
            const T w = miss && ml_missing(g0, g1, g2) ? (T)0 : (T)1;
            tw += w * ((T)2 - F);
        }
        if (CELLS) {
            const bool mine = in && !(F == (T)0 || F == (T)1);
            const unsigned ob = __ballot_sync(ML_FULL, mine) & seg_mask;
            const unsigned sb = __ballot_sync(ML_FULL, in && !mine) & seg_mask;
            if (in) {
                const int j = mine ? own + __popc(ob & below)
                                   : N - 1 - (snapped + __popc(sb & below));
                at(0, j) = g0;
                at(1, j) = g1;
                at(2, j) = g2;
                at(3, j) = F;
            }
            own += __popc(ob);
            snapped += __popc(sb);
        }
    }
    if (CELLS) __syncwarp();
    const T T_w = seg_sum<G>(tw);

    T freq = (T)0.01, num = 0, den = 0;
    bool active = valid;
    for (int passes = 1; __any_sync(ML_FULL, active); ++passes) {
        const MlPass<T> h(freq);
        T L5[5];
        ml_site_logs<G>(h, s, base, L5);
        T cn = 0, cd = 0;
#pragma unroll 2
        for (int k = 0; k < C; ++k) {
            const int j = s + G * k;
            if (j >= N) continue;
            if (CELLS) {
                ml_cell(h, L5, at(0, j), at(1, j), at(2, j), at(3, j),
                        active && j < own, miss, cn, cd);
            } else {
                const T F = f[j];
                ml_cell(h, L5, g[3 * j], g[3 * j + 1], g[3 * j + 2], F,
                        active && !(F == (T)0 || F == (T)1), miss, cn, cd);
            }
        }
        cn = seg_sum<G>(cn);
        cd = seg_sum<G>(cd);
        if (active) {
            const T prev = freq;
            num = num + cn;
            den = den + (T_w + cd);
            freq = num / den;
            active = ml_abs(prev - freq) > (T)ML_EPSILON &&
                     passes <= ML_ITER_MAX;
        }
    }
    if (valid && s == 0) out[site] = freq;
}

template <typename T, int G, bool CELLS>
static int launch_g(const T* gl, const T* p, T* out, long long S, int N,
                    long long ldp, int miss, int warps, int smem,
                    cudaStream_t st) {
    auto kern = k_maf_log<T, G, CELLS>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long per_block = (long long)warps * (32 / G);
    const long long blocks = (S + per_block - 1) / per_block;
    const int C = (N + G - 1) / G;
    kern<<<(unsigned)blocks, 32 * warps, smem, st>>>(gl, p, out, S, N, ldp,
                                                      miss, C);
    return (int)cudaGetLastError();
}

// G: lanes a site (maf_log_geometry); warps: warps a CTA; smem: dynamic
// shared memory a CTA, 0 for the cells read from device memory (G = 32).
template <typename T>
static int launch(const T* gl, const T* p, T* out, long long S, int N,
                  long long ldp, int miss, int G, int warps, int smem,
                  void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (smem == 0)
        return G == 32 ? launch_g<T, 32, false>(gl, p, out, S, N, ldp, miss,
                                                warps, 0, st)
                       : (int)cudaErrorInvalidValue;
#define ML_CASE(g)                                                      \
    case g:                                                             \
        return launch_g<T, g, true>(gl, p, out, S, N, ldp, miss, warps, \
                                    smem, st);
    switch (G) {
        ML_CASE(1)
        ML_CASE(2)
        ML_CASE(4)
        ML_CASE(8)
        ML_CASE(16)
        ML_CASE(32)
    }
#undef ML_CASE
    return (int)cudaErrorInvalidValue;
}

extern "C" int ngsf_maf_log_f64(const double* gl, const double* p,
                                double* out, long long S, int N,
                                long long ldp, int miss, int G, int warps,
                                int smem, void* stream) {
    return launch<double>(gl, p, out, S, N, ldp, miss, G, warps, smem,
                          stream);
}

extern "C" int ngsf_maf_log_f32(const float* gl, const float* p, float* out,
                                long long S, int N, long long ldp, int miss,
                                int G, int warps, int smem, void* stream) {
    return launch<float>(gl, p, out, S, N, ldp, miss, G, warps, smem,
                         stream);
}
