// The float64 log-space chain of the scan tier (--dtype float64 --kernel
// scan, numerics "log"), in three kernels. Port-only: the JAX package runs
// this tier as lax.scans over the sites (ngsf_hmm_tpu/models/hmm.py:
// forward :51, forward_loglik :72, loglik_value_and_grad :94, backward
// :158, posteriors :192), which have no TPU kernel. One thread a site
// chain would keep N threads busy (100 at the main shape), so the S sites
// are cut into nb blocks of bs (models/hmm.py:log_geometry, about 84,000
// (block, column) lanes), and the chain runs in the log semiring, where a
// pad or zero-distance site is the identity:
//   1. log_block_transfer: each (block, column) lane forms the block's
//      2x2 log product, row k the forward recursion started from the unit
//      vector e_k, in the JAX forward step's order;
//   2. log_combine: one thread a column walks the nb products forward
//      from log q (each block's entry vector, ll_f) and another backward
//      from 0 (each block's exit vector; through block 0 it is the JAX
//      backward's sentinel step, so ll_b folds in site 0's emission and
//      then log q, as the Fw/Bw check of EM.cpp:166-170 wants);
//   3. log_sweep: each lane reruns its block forward from its entry and
//      backward from its exit. Without grad it writes p_ibd = exp(fw1 +
//      bw1 - ll_f) (the forward pass parks fw1 in p); with grad it parks
//      fw in its scratch and sums the Fisher-identity terms of
//      dL/dF and dL/dalpha over its block (site 0's lane also the
//      initial-distribution term), one partial sum a (block, column).
// Bound by float64 operations: a site step takes one exp for the decay,
// four logs for the transitions and two (forward, backward) or four (the
// product's two rows) logsum2, each an exp and a log (log_common.cuh: the
// maximum term's exp(0) is 1 and not computed); the bytes are 16 a site
// and column for the emissions, read once by (1) and twice by (3). In
// SASS the CUDA exp and log are about 70 and 93 instructions, so the
// kernels issue about one instruction a cycle of their schedulers and
// their cost is the instructions a site. What the design does about it:
//   * the sweep's forward pass parks each site's four log transitions in
//     a scratch ([S, 4, C]; with grad [S, 6, C], the forward values
//     beside them), and its backward pass reads them there instead of
//     taking the decay's exp and four logs again: a quarter of the
//     sweep's instructions, for 64 bytes a site and column more traffic.
//     The scratch is 32 bytes a site and column more than the
//     recomputing instance needs ([S, 2, C] with grad, none without), so
//     models/hmm.py:log_sweep parks only while it fits in a share of the
//     card's free memory (LOG_PARK_SHARE) and else runs that instance;
//   * grad and posterior modes are two instances of one template, the
//     block's first site (its forward vector is the entry vector, no step
//     after it) and site 0's initial-distribution term peeled out of the
//     loops;
//   * the lane kernels' launch bounds ask for LC_CTAS CTAs an SM (the
//     grad sweep's registers without a spill) and log_geometry gives one
//     wave of them, so the serial walk of (2) is nb = 844 steps at 100
//     columns, not 1,352.
// Columns are independent, so R flattened replicates (R * N columns)
// give each replicate the result it has alone at the same geometry.
#include "log_common.cuh"

// LC_THREADS threads a CTA; the launch bounds ask for LC_CTAS of them on an
// SM (a register cap), and models/hmm.py:log_geometry gives at most
// 132 * LC_CTAS * LC_THREADS lanes, one wave (both -D flags from
// utils/cuda_lib.py: LOG_CHAIN_THREADS, LOG_CHAIN_CTAS).
#if !defined(LC_THREADS) || !defined(LC_CTAS)
#error "build with -DLC_THREADS and -DLC_CTAS (utils/cuda_lib.py)"
#endif

__global__ void __launch_bounds__(LC_THREADS, LC_CTAS)
    k_log_block_transfer(const double* __restrict__ e,  // [S, C, 2]
                         const double* __restrict__ dist,
                         const double* __restrict__ F,
                         const double* __restrict__ alpha,
                         double* __restrict__ A,  // [nb, C, 2, 2]
                         int S, int C, int bs, int nb) {
    const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (lane >= (long long)nb * C) return;
    const int c = (int)(lane % C), b = (int)(lane / C);
    const double Fc = F[c], ac = alpha[c];
    const double2* e2 = reinterpret_cast<const double2*>(e);
    const int s0 = b * bs, s1 = min(S, s0 + bs);
    double r00 = 0.0, r01 = -INFINITY, r10 = -INFINITY, r11 = 0.0;
    for (int s = s0; s < s1; ++s) {
        const LogTrans t = log_trans(Fc, log_decay(ac, dist[s]));
        const double2 es = e2[(long long)s * C + c];
        const double n00 = log_sum2(r00 + t.t00, r01 + t.t10) + es.x;
        const double n01 = log_sum2(r00 + t.t01, r01 + t.t11) + es.y;
        const double n10 = log_sum2(r10 + t.t00, r11 + t.t10) + es.x;
        const double n11 = log_sum2(r10 + t.t01, r11 + t.t11) + es.y;
        r00 = n00;
        r01 = n01;
        r10 = n10;
        r11 = n11;
    }
    double* out = A + lane * 4;
    out[0] = r00;
    out[1] = r01;
    out[2] = r10;
    out[3] = r11;
}

__global__ void __launch_bounds__(64)
    k_log_combine(const double* __restrict__ A,  // [nb, C, 2, 2]
                  const double* __restrict__ F,
                  double* __restrict__ fw_in,   // [nb, C, 2]
                  double* __restrict__ bw_out,  // [nb, C, 2]
                  double* __restrict__ ll_f, double* __restrict__ ll_b,
                  int C, int nb) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= 2 * C) return;
    const int c = t % C;
    const double lq0 = log(1.0 - F[c]), lq1 = log(F[c]);
    if (t < C) {  // forward from log q
        double v0 = lq0, v1 = lq1;
        for (int b = 0; b < nb; ++b) {
            const long long i = (long long)b * C + c;
            fw_in[2 * i] = v0;
            fw_in[2 * i + 1] = v1;
            const double* a = A + 4 * i;
            const double n0 = log_sum2(v0 + a[0], v1 + a[2]);
            const double n1 = log_sum2(v0 + a[1], v1 + a[3]);
            v0 = n0;
            v1 = n1;
        }
        ll_f[c] = log_sum2(v0, v1);
    } else {  // backward from 0
        double w0 = 0.0, w1 = 0.0;
        for (int b = nb - 1; b >= 0; --b) {
            const long long i = (long long)b * C + c;
            bw_out[2 * i] = w0;
            bw_out[2 * i + 1] = w1;
            const double* a = A + 4 * i;
            const double n0 = log_sum2(a[0] + w0, a[1] + w1);
            const double n1 = log_sum2(a[2] + w0, a[3] + w1);
            w0 = n0;
            w1 = n1;
        }
        ll_b[c] = log_sum2(w0 + lq0, w1 + lq1);
    }
}

// One backward step of the 2-vector (w0, w1) through site s's
// transitions t and emissions es.
__device__ __forceinline__ void log_back(const LogTrans& t, double2 es,
                                         double& w0, double& w1) {
    const double n0 = log_sum2(t.t00 + es.x + w0, t.t01 + es.y + w1);
    const double n1 = log_sum2(t.t10 + es.x + w0, t.t11 + es.y + w1);
    w0 = n0;
    w1 = n1;
}

// The Fisher-identity terms of one site (grad mode): fp the forward vector
// before the site, (w0, w1) the backward vector after it; adds to gF and
// ga, returns b = es + w - L for the initial-distribution term.
__device__ __forceinline__ double2 log_grad_site(double2 fp, double2 es,
                                                 double w0, double w1,
                                                 double L, double x,
                                                 double d, double Fc,
                                                 double& gF, double& ga) {
    const double b0 = es.x + w0 - L, b1 = es.y + w1 - L;
    const double u00 = exp(fp.x + b0), u01 = exp(fp.x + b1);
    const double u10 = exp(fp.y + b0), u11 = exp(fp.y + b1);
    const double one_m = 1.0 - x;
    const double dx = isinf(d) ? 0.0 : d * x;
    gF += one_m * (-u00 + u01 - u10 + u11);
    ga += dx * (Fc * (u01 - u00) + (1.0 - Fc) * (u10 - u11));
    return make_double2(b0, b1);
}

// GRAD false: p = exp(fw1 + bw1 - L) (the forward pass parks fw1 in p);
// GRAD true: the block's Fisher-identity sums. The forward pass parks in
// the scratch planes ws [S, NP, C] each site's forward vector (GRAD) and,
// PARK, its four log transitions, which the backward pass then reads in
// place of computing them again: they are the same values, so the bits
// are the plain version's either way. The block's first site is peeled
// out of the backward loop (its forward vector is the entry vector; no
// step after it is needed), and so is site 0's initial-distribution term.
template <bool GRAD, bool PARK>
__global__ void __launch_bounds__(LC_THREADS, LC_CTAS)
    k_log_sweep(const double* __restrict__ e,  // [S, C, 2]
                const double* __restrict__ dist,
                const double* __restrict__ F,
                const double* __restrict__ alpha,
                const double* __restrict__ fw_in,   // [nb, C, 2]
                const double* __restrict__ bw_out,  // [nb, C, 2]
                const double* __restrict__ ll_f,    // [C]
                double* __restrict__ p,             // [S, C] (no grad)
                double* __restrict__ ws,            // [S, NP, C]
                double* __restrict__ gpart,         // [nb, C, 2] (grad)
                int S, int C, int bs, int nb) {
    // planes: [t00, t01, t10, t11,] [fw0, fw1]
    constexpr int NT = PARK ? 4 : 0, NP = NT + (GRAD ? 2 : 0);
    const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (lane >= (long long)nb * C) return;
    const int c = (int)(lane % C), b = (int)(lane / C);
    const double Fc = F[c], ac = alpha[c], L = ll_f[c];
    const double2* e2 = reinterpret_cast<const double2*>(e);
    const int s0 = b * bs, s1 = min(S, s0 + bs);
    auto plane = [&](int s, int k) -> double& {
        return ws[((long long)s * NP + k) * C + c];
    };

    // forward from the block's entry vector
    const double f0 = fw_in[2 * lane], f1 = fw_in[2 * lane + 1];
    double v0 = f0, v1 = f1;
    for (int s = s0; s < s1; ++s) {
        const LogTrans t = log_trans(Fc, log_decay(ac, dist[s]));
        const double2 es = e2[(long long)s * C + c];
        const double n0 = log_sum2(v0 + t.t00, v1 + t.t10) + es.x;
        const double n1 = log_sum2(v0 + t.t01, v1 + t.t11) + es.y;
        v0 = n0;
        v1 = n1;
        if (PARK) {
            plane(s, 0) = t.t00;
            plane(s, 1) = t.t01;
            plane(s, 2) = t.t10;
            plane(s, 3) = t.t11;
        }
        if (GRAD) {
            plane(s, NT) = v0;
            plane(s, NT + 1) = v1;
        } else {
            p[(long long)s * C + c] = v1;
        }
    }
    auto trans = [&](int s) -> LogTrans {
        if (PARK)
            return LogTrans{plane(s, 0), plane(s, 1), plane(s, 2),
                            plane(s, 3)};
        return log_trans(Fc, log_decay(ac, dist[s]));
    };

    // backward from the block's exit vector
    double w0 = bw_out[2 * lane], w1 = bw_out[2 * lane + 1];
    if (!GRAD) {
        for (int s = s1 - 1; s > s0; --s) {
            const long long i = (long long)s * C + c;
            p[i] = exp(p[i] + w1 - L);
            log_back(trans(s), e2[i], w0, w1);
        }
        const long long i = (long long)s0 * C + c;
        p[i] = exp(p[i] + w1 - L);
        return;
    }
    double gF = 0.0, ga = 0.0;
    for (int s = s1 - 1; s > s0; --s) {
        const double d = dist[s];
        const double x = log_decay(ac, d);
        const long long i = (long long)s * C + c;
        const double2 es = e2[i];
        log_grad_site(make_double2(plane(s - 1, NT), plane(s - 1, NT + 1)),
                      es, w0, w1, L, x, d, Fc, gF, ga);
        log_back(PARK ? trans(s) : log_trans(Fc, x), es, w0, w1);
    }
    const double d = dist[s0];
    const double x = log_decay(ac, d);
    const double2 bb = log_grad_site(make_double2(f0, f1),
                                     e2[(long long)s0 * C + c], w0, w1, L,
                                     x, d, Fc, gF, ga);
    if (s0 == 0) {  // the initial distribution's term
        const double eb0 = exp(bb.x), eb1 = exp(bb.y);
        const double one_m = 1.0 - x;
        const double T00 = one_m * (1.0 - Fc) + x, T01 = one_m * Fc;
        const double T10 = one_m * (1.0 - Fc), T11 = one_m * Fc + x;
        const double q0 = T00 * eb0 + T01 * eb1;
        const double q1 = T10 * eb0 + T11 * eb1;
        gF += q1 - q0;
    }
    gpart[2 * lane] = gF;
    gpart[2 * lane + 1] = ga;
}

static int lanes_grid(long long lanes) {
    return (int)((lanes + LC_THREADS - 1) / LC_THREADS);
}

extern "C" int ngsf_log_block_transfer(const double* e, const double* dist,
                                       const double* F, const double* alpha,
                                       double* A, int S, int C, int bs,
                                       int nb, void* stream) {
    k_log_block_transfer<<<lanes_grid((long long)nb * C), LC_THREADS, 0,
                           (cudaStream_t)stream>>>(e, dist, F, alpha, A, S,
                                                   C, bs, nb);
    return (int)cudaGetLastError();
}

extern "C" int ngsf_log_combine(const double* A, const double* F,
                                double* fw_in, double* bw_out, double* ll_f,
                                double* ll_b, int C, int nb, void* stream) {
    k_log_combine<<<(2 * C + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
        A, F, fw_in, bw_out, ll_f, ll_b, C, nb);
    return (int)cudaGetLastError();
}

// ws: the scratch planes, [S, 6, C] with grad and park, [S, 4, C] park
// alone, [S, 2, C] grad alone, none (null) else
extern "C" int ngsf_log_sweep(const double* e, const double* dist,
                              const double* F, const double* alpha,
                              const double* fw_in, const double* bw_out,
                              const double* ll_f, double* p, double* ws,
                              double* gpart, int S, int C, int bs, int nb,
                              int grad, int park, void* stream) {
    const int grid = lanes_grid((long long)nb * C);
    const cudaStream_t st = (cudaStream_t)stream;
    auto kernel = grad ? (park ? k_log_sweep<true, true>
                               : k_log_sweep<true, false>)
                       : (park ? k_log_sweep<false, true>
                               : k_log_sweep<false, false>);
    kernel<<<grid, LC_THREADS, 0, st>>>(e, dist, F, alpha, fw_in, bw_out,
                                        ll_f, p, ws, gpart, S, C, bs, nb);
    return (int)cudaGetLastError();
}
