// The log-space chain of the scan tier (--kernel scan, numerics "log"), in
// three kernels, each in float64 and in float32 (--dtype float64, the
// default, or float32: the state's type). Port-only: the JAX package runs
// this tier as lax.scans over the sites (ngsf_hmm_tpu/models/hmm.py:
// forward :51, forward_loglik :72, loglik_value_and_grad :94, backward
// :158, posteriors :192), which have no TPU kernel. One thread a site
// chain would keep N threads busy (100 at the main shape), so the S sites
// are cut into nb blocks of bs (models/hmm.py:log_geometry, about 84,000
// (block, column) lanes), and the chain runs in the log semiring, where a
// pad or zero-distance site is the identity:
//   1. log_block_transfer: each (block, column) lane forms the block's
//      2x2 log product, row k the forward recursion started from the unit
//      vector e_k: in linear arithmetic, each entry with its own binary
//      exponent, each site's larger log emission summed into a lane
//      offset, four logs at the block's end (log_common.cuh: Lx);
//   2. log_combine: in two levels, chunks of about sqrt(nb) blocks: their
//      products, then one thread a column walks the chunk products forward
//      from log q (each chunk's entry vector, ll_f) and another backward
//      from 0 (each chunk's exit vector; through block 0 it is the JAX
//      backward's sentinel step, so ll_b folds in site 0's emission and
//      then log q, as the Fw/Bw check of EM.cpp:166-170 wants), then each
//      chunk's blocks again from its entry and exit vectors. The walks,
//      their vectors and the log-likelihoods are float64 in both
//      instances (the float32 one reads float32 products): walked in
//      float32 at 10^6 sites, ll_f and ll_b would lie about 0.06 nats
//      apart (an ulp at 8e5), past the Fw/Bw check's 0.001, as the fused
//      tier's combine keeps its log offsets in float64 for the same
//      reason;
//   3. log_sweep: each lane reruns its block forward from its entry and
//      backward from its exit. Without grad it writes p_ibd = exp(fw1 +
//      bw1 - ll_f) (the forward pass parks fw1 in p); with grad it parks
//      fw in its scratch and sums the Fisher-identity terms of
//      dL/dF and dL/dalpha over its block (site 0's lane also the
//      initial-distribution term), one partial sum a (block, column).
//      The float32 instance first takes each lane's vectors relative to
//      the log-likelihood, in float64: entry fw_in + s - ll_f and exit
//      bw_out - s (s the exit's larger entry), so its float32 chain and
//      its posteriors see values of a block's size, not of the whole
//      chain's (10^5-10^6 nats), and subtract 0 for ll_f; the float32
//      tier's blocks are at most 128 sites (models/hmm.py:
//      LOG_F32_MAX_BS), a few hundred nats.
// What bounds each, and what the design does about it:
//   * (1) and (3) are bound by float operations. In the log semiring a
//     site step takes one exp for the decay, four logs for the transitions
//     and two (forward, backward) or four (the product's two rows)
//     logsum2, each an exp and a log; in SASS the CUDA exp and log are
//     about 70 and 93 instructions, and the kernels issue about one
//     instruction a cycle of their schedulers. (1) therefore leaves the
//     log semiring: its step is 8 products, 4 sums and 4 scalings by
//     powers of two with integer exponents (exact), and two exps (the
//     decay and the smaller emission's factor; the larger one's is 1).
//     The next site's exps do not depend on the chain, so the loop body
//     steps the chain and forms the next site in one trip. Every site
//     takes the one form that keeps a subnormal transition and an
//     emission gap past exp's range exact: an inline fast form beside
//     it cost 12 registers (6 CTAs an SM in place of 8) and was slower;
//   * the sweep's forward pass parks each site's four log transitions in
//     a scratch ([S, 4, C]; with grad [S, 6, C], the forward values
//     beside them), and its backward pass reads them there instead of
//     taking the decay's exp and four logs again: a quarter of the
//     sweep's instructions, for 64 bytes a site and column more traffic.
//     The scratch is 32 bytes a site and column more than the
//     recomputing instance needs ([S, 2, C] with grad, none without), so
//     models/hmm.py:log_sweep parks only while it fits in a share of the
//     card's free memory (LOG_PARK_SHARE) and else runs that instance;
//     in float32, whose expf and logf cost less than the scratch's
//     traffic, it always runs the recomputing one;
//   * grad and posterior modes are two instances of one template, the
//     block's first site (its forward vector is the entry vector, no step
//     after it) and site 0's initial-distribution term peeled out of the
//     loops;
//   * (2) is bound by the latency of its serial walk (its bytes, the nb
//     products and vectors, take microseconds): one thread a column
//     walking all nb = 844 products took about 1.5 us a step; the two
//     levels cut the depth to about 3 sqrt(nb) steps;
//   * the lane kernels' launch bounds ask for LC_CTAS CTAs an SM (the
//     grad sweep's registers without a spill) and log_geometry gives one
//     wave of them.
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

// a site's two log emissions, loaded as one 16-byte (float64) or 8-byte
// (float32) pair
template <typename T>
struct Pair;
template <>
struct Pair<double> {
    using V = double2;
};
template <>
struct Pair<float> {
    using V = float2;
};

// One (block, column) lane: the block's 2x2 product in linear arithmetic
// with an exponent an entry (log_common.cuh: Lx), row k from the unit
// vector e_k, the four logs at the end. The loop body first steps the
// chain through the current site, then forms the next site (its decay's
// exp, its emission's exp, the transitions' mantissas and exponents),
// which does not depend on the chain, so the two interleave.
template <typename T>
__global__ void __launch_bounds__(LC_THREADS, LC_CTAS)
    k_log_block_transfer(const T* __restrict__ e,  // [S, C, 2]
                         const T* __restrict__ dist,
                         const T* __restrict__ F,
                         const T* __restrict__ alpha,
                         T* __restrict__ A,  // [nb, C, 2, 2]
                         int S, int C, int bs, int nb) {
    using V = typename Pair<T>::V;
    const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (lane >= (long long)nb * C) return;
    const int c = (int)(lane % C), b = (int)(lane / C);
    const T Fc = F[c], ac = alpha[c], q0 = (T)1 - Fc;
    const int s0 = b * bs, n = min(S, s0 + bs) - s0;
    const V* ep = reinterpret_cast<const V*>(e) + (long long)s0 * C + c;
    const T* dp = dist + s0;
    auto site = [&](int i) -> LxSite<T> {  // site s0 + i
        const V es = ep[(long long)i * C];
        return lx_site(Fc, q0, log_decay(ac, dp[i]), es.x, es.y);
    };
    Lx<T> r00 = {(T)1, 0}, r01 = {(T)0, LX_EZERO};
    Lx<T> r10 = {(T)0, LX_EZERO}, r11 = {(T)1, 0};
    T off = 0;
    LxSite<T> cur = site(0);
    for (int i = 0; i < n; ++i) {
        const Lx<T> n00 = lx_entry(r00, r01, cur.t00, cur.t10, cur.w0,
                                   cur.j0);
        const Lx<T> n01 = lx_entry(r00, r01, cur.t01, cur.t11, cur.w1,
                                   cur.j1);
        const Lx<T> n10 = lx_entry(r10, r11, cur.t00, cur.t10, cur.w0,
                                   cur.j0);
        const Lx<T> n11 = lx_entry(r10, r11, cur.t01, cur.t11, cur.w1,
                                   cur.j1);
        off += cur.off;
        r00 = n00;
        r01 = n01;
        r10 = n10;
        r11 = n11;
        cur = site(min(i + 1, n - 1));  // past the end: unused
    }
    constexpr T LN2 = LxK<T>::LN2;
    V* out = reinterpret_cast<V*>(A) + 2 * lane;
    out[0] = {lc_log(r00.m) + (T)r00.e * LN2 + off,
              lc_log(r01.m) + (T)r01.e * LN2 + off};
    out[1] = {lc_log(r10.m) + (T)r10.e * LN2 + off,
              lc_log(r11.m) + (T)r11.e * LN2 + off};
}

// log_combine: a 2x2 log product (row-major) and its steps, in float64
struct L4 {
    double a00, a01, a10, a11;
};

__device__ __forceinline__ L4 lc_load(const double* __restrict__ A,
                                      long long i) {
    const double2* p = reinterpret_cast<const double2*>(A) + 2 * i;
    const double2 u = __ldg(p), v = __ldg(p + 1);
    return {u.x, u.y, v.x, v.y};
}

// the float32 products, widened exactly
__device__ __forceinline__ L4 lc_load(const float* __restrict__ A,
                                      long long i) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(A) + i);
    return {(double)u.x, (double)u.y, (double)u.z, (double)u.w};
}

// the row vector v times a
__device__ __forceinline__ double2 lc_vm(double2 v, const L4& a) {
    return make_double2(log_sum2(v.x + a.a00, v.y + a.a10),
                        log_sum2(v.x + a.a01, v.y + a.a11));
}

// a times the column vector w
__device__ __forceinline__ double2 lc_mv(const L4& a, double2 w) {
    return make_double2(log_sum2(a.a00 + w.x, a.a01 + w.y),
                        log_sum2(a.a10 + w.x, a.a11 + w.y));
}

#ifndef LCB_MAXC
#error "build with -DLCB_MAXC (utils/cuda_lib.py LOG_COMBINE_MAX_CHUNKS)"
#endif

// Two levels (csrc/combine_blocks.cu's design in the log semiring): the
// nb products in nc chunks of L blocks. A CTA holds TN columns x nc chunks
// x 2 directions, one thread each (threadIdx x, y, z):
//   1. the direction-0 thread of (column, chunk) forms the chunk's product;
//   2. the chunk-0 threads walk the nc chunk products, direction 0 forward
//      from log q (each chunk's entry vector, ll_f), direction 1 backward
//      from 0 (each chunk's exit vector, ll_b after the sentinel step);
//   3. each thread reruns its chunk's blocks from the chunk's entry
//      (direction 0, writing fw_in) or exit vector (1, bw_out).
// Serial depth L + nc + L steps in place of nb; the next block's product is
// loaded before the current step. T: the products' type (the tier's); F,
// the walks and every output are float64.
template <typename T>
__global__ void __launch_bounds__(2 * LCB_MAXC)
    k_log_combine(const T* __restrict__ A,  // [nb, C, 2, 2]
                  const double* __restrict__ F,
                  double* __restrict__ fw_in,   // [nb, C, 2]
                  double* __restrict__ bw_out,  // [nb, C, 2]
                  double* __restrict__ ll_f, double* __restrict__ ll_b,
                  int C, int nb, int L) {
    __shared__ L4 sP[LCB_MAXC];        // the chunk products
    __shared__ double2 sV[LCB_MAXC];   // each chunk's entry vector
    __shared__ double2 sW[LCB_MAXC];   // each chunk's exit vector
    const int x = threadIdx.x, k = threadIdx.y, dir = threadIdx.z;
    const int TN = blockDim.x, nc = blockDim.y;
    const int c0 = blockIdx.x * TN + x;
    const bool live = c0 < C;
    const int c = live ? c0 : C - 1;  // lanes past C store nothing
    const int i = k * TN + x;
    const int j0 = k * L, j1 = min(j0 + L, nb);
    auto at = [&](int j) { return (long long)j * C + c; };

    if (dir == 0) {  // ---- 1. the chunk's product
        L4 p = lc_load(A, at(j0));
        L4 a = lc_load(A, at(min(j0 + 1, j1 - 1)));
        for (int j = j0 + 1; j < j1; ++j) {
            const L4 nxt = lc_load(A, at(min(j + 1, j1 - 1)));
            const double2 r0 = lc_vm(make_double2(p.a00, p.a01), a);
            const double2 r1 = lc_vm(make_double2(p.a10, p.a11), a);
            p = {r0.x, r0.y, r1.x, r1.y};
            a = nxt;
        }
        sP[i] = p;
    }
    __syncthreads();

    if (k == 0) {  // ---- 2. the walks over the chunks
        const double lq0 = log(1.0 - F[c]), lq1 = log(F[c]);
        if (dir == 0) {
            double2 v = make_double2(lq0, lq1);
            for (int q = 0; q < nc; ++q) {
                sV[q * TN + x] = v;
                v = lc_vm(v, sP[q * TN + x]);
            }
            if (live) ll_f[c] = log_sum2(v.x, v.y);
        } else {
            double2 w = make_double2(0.0, 0.0);
            for (int q = nc - 1; q >= 0; --q) {
                sW[q * TN + x] = w;
                w = lc_mv(sP[q * TN + x], w);
            }
            if (live) ll_b[c] = log_sum2(w.x + lq0, w.y + lq1);
        }
    }
    __syncthreads();

    // ---- 3. the chunk's blocks again
    double2* out = reinterpret_cast<double2*>(dir == 0 ? fw_in : bw_out);
    if (dir == 0) {
        double2 v = sV[i];
        L4 a = lc_load(A, at(j0));
        for (int j = j0; j < j1; ++j) {
            if (live) out[at(j)] = v;
            if (j + 1 == j1) break;
            const L4 nxt = lc_load(A, at(j + 1));
            v = lc_vm(v, a);
            a = nxt;
        }
    } else {
        double2 w = sW[i];
        L4 a = lc_load(A, at(j1 - 1));
        for (int j = j1 - 1; j >= j0; --j) {
            if (live) out[at(j)] = w;
            if (j == j0) break;
            const L4 nxt = lc_load(A, at(j - 1));
            w = lc_mv(a, w);
            a = nxt;
        }
    }
}

// One backward step of the 2-vector (w0, w1) through site s's
// transitions t and emissions es.
template <typename T, typename V>
__device__ __forceinline__ void log_back(const LogTrans<T>& t, V es, T& w0,
                                         T& w1) {
    const T n0 = log_sum2(t.t00 + es.x + w0, t.t01 + es.y + w1);
    const T n1 = log_sum2(t.t10 + es.x + w0, t.t11 + es.y + w1);
    w0 = n0;
    w1 = n1;
}

// The Fisher-identity terms of one site (grad mode): (fp0, fp1) the
// forward vector before the site, (w0, w1) the backward vector after it;
// adds to gF and ga, sets (b0, b1) = es + w - L for the
// initial-distribution term.
template <typename T, typename V>
__device__ __forceinline__ void log_grad_site(T fp0, T fp1, V es, T w0,
                                              T w1, T L, T x, T d, T Fc,
                                              T& gF, T& ga, T& b0, T& b1) {
    b0 = es.x + w0 - L;
    b1 = es.y + w1 - L;
    const T u00 = lc_exp(fp0 + b0), u01 = lc_exp(fp0 + b1);
    const T u10 = lc_exp(fp1 + b0), u11 = lc_exp(fp1 + b1);
    const T one_m = (T)1 - x;
    const T dx = isinf(d) ? (T)0 : d * x;
    gF += one_m * (-u00 + u01 - u10 + u11);
    ga += dx * (Fc * (u01 - u00) + ((T)1 - Fc) * (u10 - u11));
}

// GRAD false: p = exp(fw1 + bw1 - L) (the forward pass parks fw1 in p);
// GRAD true: the block's Fisher-identity sums. The forward pass parks in
// the scratch planes ws [S, NP, C] each site's forward vector (GRAD) and,
// PARK, its four log transitions, which the backward pass then reads in
// place of computing them again: they are the same values, so the bits
// are the plain version's either way. The block's first site is peeled
// out of the backward loop (its forward vector is the entry vector; no
// step after it is needed), and so is site 0's initial-distribution term.
// The entry and exit vectors and ll_f come from log_combine in float64:
// float64 lanes take them as they are; float32 lanes take them relative
// to ll_f (the header) and L = 0, and site 0's initial-distribution term
// adds block 0's s - ll_f back to es + bw - L.
template <typename T, bool GRAD, bool PARK>
__global__ void __launch_bounds__(LC_THREADS, LC_CTAS)
    k_log_sweep(const T* __restrict__ e,  // [S, C, 2]
                const T* __restrict__ dist,
                const T* __restrict__ F,
                const T* __restrict__ alpha,
                const double* __restrict__ fw_in,   // [nb, C, 2]
                const double* __restrict__ bw_out,  // [nb, C, 2]
                const double* __restrict__ ll_f,    // [C]
                T* __restrict__ p,                  // [S, C] (no grad)
                T* __restrict__ ws,                 // [S, NP, C]
                T* __restrict__ gpart,              // [nb, C, 2] (grad)
                int S, int C, int bs, int nb) {
    using V = typename Pair<T>::V;
    // planes: [t00, t01, t10, t11,] [fw0, fw1]
    constexpr int NT = PARK ? 4 : 0, NP = NT + (GRAD ? 2 : 0);
    const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (lane >= (long long)nb * C) return;
    const int c = (int)(lane % C), b = (int)(lane / C);
    const T Fc = F[c], ac = alpha[c];
    const V* e2 = reinterpret_cast<const V*>(e);
    const int s0 = b * bs, s1 = min(S, s0 + bs);
    auto plane = [&](int s, int k) -> T& {
        return ws[((long long)s * NP + k) * C + c];
    };

    // the block's entry and exit vectors
    T f0, f1, w0, w1, L;
    T c0 = 0;  // float32: s - ll_f, for site 0's initial-distribution term
    if constexpr (sizeof(T) == sizeof(double)) {
        f0 = fw_in[2 * lane];
        f1 = fw_in[2 * lane + 1];
        w0 = bw_out[2 * lane];
        w1 = bw_out[2 * lane + 1];
        L = ll_f[c];
    } else {
        const double x0 = bw_out[2 * lane], x1 = bw_out[2 * lane + 1];
        const double m = x0 >= x1 ? x0 : x1;
        const double s = isinf(m) ? 0.0 : m, Ld = ll_f[c];
        f0 = (T)((fw_in[2 * lane] + s) - Ld);
        f1 = (T)((fw_in[2 * lane + 1] + s) - Ld);
        w0 = (T)(x0 - s);
        w1 = (T)(x1 - s);
        L = 0;
        c0 = (T)(s - Ld);
    }

    // forward from the block's entry vector
    T v0 = f0, v1 = f1;
    for (int s = s0; s < s1; ++s) {
        const LogTrans<T> t = log_trans(Fc, log_decay(ac, dist[s]));
        const V es = e2[(long long)s * C + c];
        const T n0 = log_sum2(v0 + t.t00, v1 + t.t10) + es.x;
        const T n1 = log_sum2(v0 + t.t01, v1 + t.t11) + es.y;
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
    auto trans = [&](int s) -> LogTrans<T> {
        if (PARK)
            return LogTrans<T>{plane(s, 0), plane(s, 1), plane(s, 2),
                               plane(s, 3)};
        return log_trans(Fc, log_decay(ac, dist[s]));
    };

    // backward from the block's exit vector
    if (!GRAD) {
        for (int s = s1 - 1; s > s0; --s) {
            const long long i = (long long)s * C + c;
            p[i] = lc_exp(p[i] + w1 - L);
            log_back(trans(s), e2[i], w0, w1);
        }
        const long long i = (long long)s0 * C + c;
        p[i] = lc_exp(p[i] + w1 - L);
        return;
    }
    T gF = 0, ga = 0, b0, b1;
    for (int s = s1 - 1; s > s0; --s) {
        const T d = dist[s];
        const T x = log_decay(ac, d);
        const long long i = (long long)s * C + c;
        const V es = e2[i];
        log_grad_site(plane(s - 1, NT), plane(s - 1, NT + 1), es, w0, w1, L,
                      x, d, Fc, gF, ga, b0, b1);
        log_back(PARK ? trans(s) : log_trans(Fc, x), es, w0, w1);
    }
    const T d = dist[s0];
    const T x = log_decay(ac, d);
    log_grad_site(f0, f1, e2[(long long)s0 * C + c], w0, w1, L, x, d, Fc,
                  gF, ga, b0, b1);
    if (s0 == 0) {  // the initial distribution's term
        if constexpr (sizeof(T) != sizeof(double)) {
            b0 += c0;
            b1 += c0;
        }
        const T eb0 = lc_exp(b0), eb1 = lc_exp(b1);
        const T one_m = (T)1 - x;
        const T T00 = one_m * ((T)1 - Fc) + x, T01 = one_m * Fc;
        const T T10 = one_m * ((T)1 - Fc), T11 = one_m * Fc + x;
        const T q0 = T00 * eb0 + T01 * eb1;
        const T q1 = T10 * eb0 + T11 * eb1;
        gF += q1 - q0;
    }
    gpart[2 * lane] = gF;
    gpart[2 * lane + 1] = ga;
}

static int lanes_grid(long long lanes) {
    return (int)((lanes + LC_THREADS - 1) / LC_THREADS);
}

template <typename T>
static int block_transfer(const T* e, const T* dist, const T* F,
                          const T* alpha, T* A, int S, int C, int bs, int nb,
                          void* stream) {
    k_log_block_transfer<T><<<lanes_grid((long long)nb * C), LC_THREADS, 0,
                              (cudaStream_t)stream>>>(e, dist, F, alpha, A,
                                                      S, C, bs, nb);
    return (int)cudaGetLastError();
}

extern "C" int ngsf_log_block_transfer(const double* e, const double* dist,
                                       const double* F, const double* alpha,
                                       double* A, int S, int C, int bs,
                                       int nb, void* stream) {
    return block_transfer(e, dist, F, alpha, A, S, C, bs, nb, stream);
}

extern "C" int ngsf_log_block_transfer_f32(const float* e, const float* dist,
                                           const float* F, const float* alpha,
                                           float* A, int S, int C, int bs,
                                           int nb, void* stream) {
    return block_transfer(e, dist, F, alpha, A, S, C, bs, nb, stream);
}

// L: blocks a chunk; tn: columns a CTA (models/hmm.py:
// log_combine_launch); tn * chunks past LCB_MAXC is refused
template <typename T>
static int combine(const T* A, const double* F, double* fw_in,
                   double* bw_out, double* ll_f, double* ll_b, int C, int nb,
                   int L, int tn, void* stream) {
    if (L < 1 || nb < 1 || C < 1 || tn < 1) return (int)cudaErrorInvalidValue;
    const int nc = (nb + L - 1) / L;
    if ((long long)tn * nc > LCB_MAXC) return (int)cudaErrorInvalidValue;
    k_log_combine<T><<<(C + tn - 1) / tn, dim3(tn, nc, 2), 0,
                       (cudaStream_t)stream>>>(A, F, fw_in, bw_out, ll_f,
                                               ll_b, C, nb, L);
    return (int)cudaGetLastError();
}

extern "C" int ngsf_log_combine(const double* A, const double* F,
                                double* fw_in, double* bw_out, double* ll_f,
                                double* ll_b, int C, int nb, int L, int tn,
                                void* stream) {
    return combine(A, F, fw_in, bw_out, ll_f, ll_b, C, nb, L, tn, stream);
}

extern "C" int ngsf_log_combine_f32(const float* A, const double* F,
                                    double* fw_in, double* bw_out,
                                    double* ll_f, double* ll_b, int C, int nb,
                                    int L, int tn, void* stream) {
    return combine(A, F, fw_in, bw_out, ll_f, ll_b, C, nb, L, tn, stream);
}

// ws: the scratch planes, [S, 6, C] with grad and park, [S, 4, C] park
// alone, [S, 2, C] grad alone, none (null) else
template <typename T>
static int sweep(const T* e, const T* dist, const T* F, const T* alpha,
                 const double* fw_in, const double* bw_out,
                 const double* ll_f, T* p, T* ws, T* gpart, int S, int C,
                 int bs, int nb, int grad, int park, void* stream) {
    const int grid = lanes_grid((long long)nb * C);
    const cudaStream_t st = (cudaStream_t)stream;
    auto kernel = grad ? (park ? k_log_sweep<T, true, true>
                               : k_log_sweep<T, true, false>)
                       : (park ? k_log_sweep<T, false, true>
                               : k_log_sweep<T, false, false>);
    kernel<<<grid, LC_THREADS, 0, st>>>(e, dist, F, alpha, fw_in, bw_out,
                                        ll_f, p, ws, gpart, S, C, bs, nb);
    return (int)cudaGetLastError();
}

extern "C" int ngsf_log_sweep(const double* e, const double* dist,
                              const double* F, const double* alpha,
                              const double* fw_in, const double* bw_out,
                              const double* ll_f, double* p, double* ws,
                              double* gpart, int S, int C, int bs, int nb,
                              int grad, int park, void* stream) {
    return sweep(e, dist, F, alpha, fw_in, bw_out, ll_f, p, ws, gpart, S, C,
                 bs, nb, grad, park, stream);
}

extern "C" int ngsf_log_sweep_f32(const float* e, const float* dist,
                                  const float* F, const float* alpha,
                                  const double* fw_in, const double* bw_out,
                                  const double* ll_f, float* p, float* ws,
                                  float* gpart, int S, int C, int bs, int nb,
                                  int grad, int park, void* stream) {
    return sweep(e, dist, F, alpha, fw_in, bw_out, ll_f, p, ws, gpart, S, C,
                 bs, nb, grad, park, stream);
}
