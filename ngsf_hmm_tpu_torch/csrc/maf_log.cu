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
// One warp a site, its 32 lanes over the individuals, the sums a warp
// butterfly, so each pass reads a site's gl rows and posteriors once
// (coalesced; from L1 after the first pass). Bound by float64 operations:
// nearly every site runs all ITER_MAX + 1 passes on realistic
// likelihoods, each 4 logs and 6 exps an individual.
// F = p[site * ldp + i] (ldp: the row stride, so a replicate's columns of
// a flattened posterior are read in place); miss != 0 drops individuals
// whose three gl are EPSILON-equal (miss_data). Templated on the float
// type; float64 on the scan tier, float32 for --freq e on the fused tier.
#include <cuda_runtime.h>
#include <math.h>

#define ML_WARPS 8
#define ML_EPSILON 1e-5
#define ML_ITER_MAX 100
#define ML_BIG 1e15

__device__ __forceinline__ float ml_log(float x) { return logf(x); }
__device__ __forceinline__ double ml_log(double x) { return log(x); }
__device__ __forceinline__ float ml_exp(float x) { return expf(x); }
__device__ __forceinline__ double ml_exp(double x) { return exp(x); }
__device__ __forceinline__ float ml_max(float a, float b) {
    return fmaxf(a, b);
}
__device__ __forceinline__ double ml_max(double a, double b) {
    return fmax(a, b);
}
__device__ __forceinline__ float ml_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double ml_abs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T ml_logsum3(T a, T b, T c) {
    const T m = ml_max(ml_max(a, b), c);
    if (m == (T)-INFINITY) return (T)-INFINITY;
    return ml_log((ml_exp(a - m) + ml_exp(b - m)) + ml_exp(c - m)) + m;
}

template <typename T>
__device__ __forceinline__ T ml_floor(T lg) {
    return lg == (T)-INFINITY ? (T)-ML_BIG : lg;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * ML_WARPS)
    k_maf_log(const T* __restrict__ gl,  // [S, N, 3] log
              const T* __restrict__ p,   // [S, ldp] (F of each individual)
              T* __restrict__ out,       // [S]
              long long S, int N, long long ldp, int miss) {
    const long long site =
        (long long)blockIdx.x * ML_WARPS + (threadIdx.x >> 5);
    if (site >= S) return;  // the whole warp
    const int lane = threadIdx.x & 31;
    const T* g = gl + site * N * 3;
    const T* f = p + site * ldp;
    const T eps = (T)ML_EPSILON;

    T tw = 0;
    for (int i = lane; i < N; i += 32) {
        const T w = miss && ml_abs(g[3 * i] - g[3 * i + 1]) < eps &&
                            ml_abs(g[3 * i + 1] - g[3 * i + 2]) < eps
                        ? (T)0
                        : (T)1;
        tw += w * ((T)2 - f[i]);
    }
    const T T_w = warp_sum(tw);

    T freq = (T)0.01, num = 0, den = 0;
    for (int passes = 1;; ++passes) {
        T cn = 0, cd = 0;
        const T pq = ((T)1 - freq) * freq;
        for (int i = lane; i < N; i += 32) {
            const T F = f[i];
            const T g0 = g[3 * i], g1 = g[3 * i + 1], g2 = g[3 * i + 2];
            const T w =
                miss && ml_abs(g0 - g1) < eps && ml_abs(g1 - g2) < eps
                    ? (T)0
                    : (T)1;
            // calc_hwe(freq, F) in log space
            const T h0 = ((T)1 - freq) * ((T)1 - freq) + pq * F;
            const T h1 = (T)2 * pq - (T)2 * pq * F;
            const T h2 = freq * freq + pq * F;
            const T l0 = ml_floor(ml_log(h0));
            const T l1 = F == (T)1 ? (T)-ML_BIG : ml_floor(ml_log(h1));
            const T l2 = ml_floor(ml_log(h2));
            // post_prob: the posteriors of the three genotypes
            const T a0 = g0 + l0, a1 = g1 + l1, a2 = g2 + l2;
            const T norm = ml_logsum3(a0, a1, a2);
            const T pp1 = ml_exp(a1 - norm), pp2 = ml_exp(a2 - norm);
            cn += w * (pp1 + pp2 * ((T)2 - F));
            cd += w * (pp1 * F);
        }
        cn = warp_sum(cn);
        cd = warp_sum(cd);
        const T prev = freq;
        num = num + cn;
        den = den + (T_w + cd);
        freq = num / den;
        if (!(ml_abs(prev - freq) > eps && passes <= ML_ITER_MAX)) break;
    }
    if (lane == 0) out[site] = freq;
}

template <typename T>
static int launch(const T* gl, const T* p, T* out, long long S, int N,
                  long long ldp, int miss, void* stream) {
    const long long blocks = (S + ML_WARPS - 1) / ML_WARPS;
    k_maf_log<T><<<(unsigned)blocks, 32 * ML_WARPS, 0,
                   (cudaStream_t)stream>>>(gl, p, out, S, N, ldp, miss);
    return (int)cudaGetLastError();
}

extern "C" int ngsf_maf_log_f64(const double* gl, const double* p,
                                double* out, long long S, int N,
                                long long ldp, int miss, void* stream) {
    return launch<double>(gl, p, out, S, N, ldp, miss, stream);
}

extern "C" int ngsf_maf_log_f32(const float* gl, const float* p, float* out,
                                long long S, int N, long long ldp, int miss,
                                void* stream) {
    return launch<float>(gl, p, out, S, N, ldp, miss, stream);
}
